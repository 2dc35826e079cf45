"""``spmm_roofline``: the ternary projections' share of their roofline, in %:
the sum over the traced slice's projections of each one's bound (the larger
of ``2·M·nnz + M·N`` over the bf16 peak and X + 2-bit W + Y + bias bytes over
the memory rate), counted from the model's shapes whichever kernel does the
work, over the device seconds of the kernels that
``counts/kernels/*.json`` lists as ``ternary_projections``."""

from perfbench.counts.ops import kernel_group


def read(ctx):
    if ctx.trace is None or not ctx.slice_work.get("spmm"):
        return None
    secs = ctx.trace.seconds_matching(kernel_group("ternary_projections"))
    if secs <= 0:
        return None
    return 100.0 * sum(i.bound_s(ctx.peaks) for i in ctx.slice_work["spmm"]) / secs
