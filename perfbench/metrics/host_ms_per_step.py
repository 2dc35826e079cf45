"""``host_ms_per_step``: the median host time of one decode-step call, in ms,
read by the host clock around each ``lm_decode_step`` call of the window
with no synchronise (the time the host spends issuing a step; where the
card is behind, the wait of a full launch queue shows in it too)."""

from perfbench.lib import stats


def read(ctx):
    steps = ctx.window.get("step_host_s")
    return stats.median(steps) * 1e3 if steps else None
