"""``flash_roofline``: the flash prefill's share of its roofline, in %: the
sum over the traced slice's causal prefill attentions of each one's bound
(the larger of ``4·B·H·hd·T(T+1)/2`` over the bf16 peak and Q, K, V and O
bytes over the memory rate) over the device seconds of the kernels that
``counts/kernels/*.json`` lists as ``flash_prefill``."""

from perfbench.counts.ops import kernel_group


def read(ctx):
    if ctx.trace is None or not ctx.slice_work.get("flash"):
        return None
    secs = ctx.trace.seconds_matching(kernel_group("flash_prefill"))
    if secs <= 0:
        return None
    return 100.0 * sum(i.bound_s(ctx.peaks) for i in ctx.slice_work["flash"]) / secs
