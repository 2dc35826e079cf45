"""``expert_roofline``: the routed experts' share of their roofline, in %:
the sum over the traced slice's expert items (each layer's experts, up and
down, at the rows the router sent them in the slice) of each one's bound
(the larger of ``2·m_e·nnz_e + m_e·N`` over the bf16 peak and X rows, the
expert's 2-bit W, Y and bias bytes over the memory rate) over the device
seconds of the kernels that ``counts/kernels/*.json`` lists as
``routed_experts``. Nothing where the slice recorded no routing or no such
kernel ran."""

from perfbench.counts.ops import kernel_group


def read(ctx):
    if ctx.trace is None or not ctx.slice_work.get("experts"):
        return None
    secs = ctx.trace.seconds_matching(kernel_group("routed_experts"))
    if secs <= 0:
        return None
    return 100.0 * sum(i.bound_s(ctx.peaks) for i in ctx.slice_work["experts"]) / secs
