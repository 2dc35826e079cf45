"""``itl_p95_ms``: the 95th percentile of the gaps between consecutive decode
steps' completions in one batch, in ms, from a CUDA event recorded after each
step's argmax. Host-paced steps set it, so it is a per-layer reading."""

from perfbench.lib import stats


def read(ctx):
    gaps = ctx.window.get("itl_s")
    return stats.percentile(gaps, 95) * 1e3 if gaps else None
