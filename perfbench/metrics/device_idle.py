"""``device_idle``: the share of the traced window in which no operation ran
on the card, in %: 1 − (union of the device's kernel, copy and set intervals)
/ (the window's length), from the profiler's trace of a steady slice."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
