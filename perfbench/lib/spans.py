"""The program's spans in a traced slice, tied to the card's work by launch
correlation.

The port opens named spans at its layer boundaries (``record_function``
ranges while a profiler records: ``smmb_tpu_torch/utils/spans.py``); in the
Chrome trace they are ``user_annotation`` events on the host thread that
issues the work, nested as the calls nest. Every device operation (kernel,
copy, set) carries ``args.correlation``, the id of the runtime or driver
call that issued it, so an operation belongs to the spans around its launch
call, whatever the host and device clocks read.

``reduce(events, w0, w1)`` works over the events of the traced window
``[w0, w1]`` (µs, host clock) and returns ``{"rows": {name: row}, "skew_us":
s}``. A row holds, for one span name:

- ``count``: the spans of that name that start in the window;
- ``host_s``: their summed host seconds;
- ``launches``: the launch calls (runtime or driver events whose name holds
  ``Launch``, ``Memcpy`` or ``Memset``; a call made inside another such call
  counts once) inside a span of that name, and ``launches_self`` those whose
  innermost span it is;
- ``device_s``, ``ops``: the device seconds (clipped to the window, as
  ``trace.summarize`` clips them) and the count of the operations whose
  launch call lies inside a span of that name, and ``device_s_self``,
  ``ops_self`` those whose innermost span it is;
- ``idle_s``: the device's idle gaps in the window charged to the innermost
  span around the launch call of the operation that ends the gap: what the
  host was doing while the card waited.

What no span holds goes to the row ``OUTSIDE``: operations whose launch call
lies outside every span or is not in the trace, launch calls outside every
span, and the idle tail from the last operation to the window's end. So the
self device seconds of all rows sum to the window's device seconds.
``skew_us`` is the largest amount by which an operation starts before the
launch call that issued it on the host clock (0 when none does): evidence
that the device clock disagrees with the host's.

``trace.summarize`` does not call ``reduce``: a ``--trace 1`` run of
``run.py`` reports no figure of the spans, and its per-layer metrics read
none. ``traced(traffic)`` takes a cell's traced slice as such a run takes
it, and reduces the spans of that slice beside the summary
(``scripts/torch_span_overhead.py``).
"""

from __future__ import annotations

OUTSIDE = "outside"
SPAN_CAT = "user_annotation"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH_WORDS = ("Launch", "Memcpy", "Memset")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
FIELDS = ("count", "host_s", "launches", "launches_self", "device_s", "device_s_self",
          "ops", "ops_self", "idle_s")


def _complete(events, cats):
    return [e for e in events if e.get("ph") == "X" and "dur" in e and e.get("cat") in cats]


def _stacks(spans: list, times: list) -> list:
    """For each of ``times``, the names of the spans around it, outermost
    first; ``spans`` is [(start, end, name)] sorted by start, then longest
    first, nested as one thread's calls nest."""
    out = [()] * len(times)
    stack = []  # [(end, name)]
    i = 0
    for j in sorted(range(len(times)), key=times.__getitem__):
        t = times[j]
        while i < len(spans) and spans[i][0] <= t:
            a, b, name = spans[i]
            while stack and stack[-1][0] < a:
                stack.pop()
            stack.append((b, name))
            i += 1
        while stack and stack[-1][0] < t:
            stack.pop()
        out[j] = tuple(name for _, name in stack)
    return out


def reduce(events: list, w0: float, w1: float) -> dict:
    """The spans' rows and ``skew_us`` of a Chrome trace's window [w0, w1]
    (see the module's docstring)."""
    from perfbench.lib.trace import SLICE

    rows: dict = {}

    def row(name):
        r = rows.get(name)
        if r is None:
            r = rows[name] = dict.fromkeys(FIELDS, 0)
        return r

    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                    for e in _complete(events, (SPAN_CAT,))
                    if w0 <= float(e["ts"]) <= w1 and e["name"] != SLICE
                    and not e["name"].startswith("ProfilerStep")),
                   key=lambda s: (s[0], s[0] - s[1]))
    for a, b, name in spans:
        r = row(name)
        r["count"] += 1
        r["host_s"] += (b - a) * 1e-6
    row(OUTSIDE)

    api = _complete(events, LAUNCH_CATS)
    by_corr = {e["args"]["correlation"]: float(e["ts"]) for e in api
               if "correlation" in e.get("args", {})}
    calls, last = [], {}
    for e in sorted(api, key=lambda e: (float(e["ts"]), -float(e["dur"]))):
        a = float(e["ts"])
        b = a + float(e["dur"])
        if not (w0 <= a <= w1 and any(w in e["name"] for w in LAUNCH_WORDS)):
            continue
        if b <= last.get(e.get("tid"), -1.0):  # made inside a counted call
            continue
        last[e.get("tid")] = b
        calls.append(a)

    ops = []  # (start, end, launch time or None), clipped to the window
    skew = 0.0
    for e in _complete(events, DEVICE_CATS):
        a0 = float(e["ts"])
        a, b = max(a0, w0), min(a0 + float(e["dur"]), w1)
        if b <= a:
            continue
        at = by_corr.get(e.get("args", {}).get("correlation"))
        if at is not None:
            skew = max(skew, at - a0)
        ops.append((a, b, at))
    ops.sort(key=lambda o: o[0])

    launched = [o[2] for o in ops if o[2] is not None]
    stacks = iter(_stacks(spans, calls + launched))
    for _ in calls:
        stack = next(stacks)
        row(stack[-1] if stack else OUTSIDE)["launches_self"] += 1
        for name in set(stack) or (OUTSIDE,):
            row(name)["launches"] += 1
    innermost = []
    for a, b, at in ops:
        stack = next(stacks) if at is not None else ()
        secs = (b - a) * 1e-6
        inner = stack[-1] if stack else OUTSIDE
        innermost.append(inner)
        r = row(inner)
        r["device_s_self"] += secs
        r["ops_self"] += 1
        for name in set(stack) or (OUTSIDE,):
            row(name)["device_s"] += secs
            row(name)["ops"] += 1

    # idle gaps: each ends where the next operation starts (charged to that
    # operation's innermost span), or at the window's end
    end = w0
    for (a, b, _), inner in zip(ops, innermost):
        if a > end:
            row(inner)["idle_s"] += (a - end) * 1e-6
        end = max(end, b)
    if w1 > end:
        row(OUTSIDE)["idle_s"] += (w1 - end) * 1e-6
    return {"rows": rows, "skew_us": skew}


def window(events: list) -> tuple[float, float]:
    """The traced window [w0, w1] (µs, host clock): the ``perfbench.slice``
    range, read as ``trace.summarize`` reads it."""
    from perfbench.lib.trace import SLICE

    for e in events:
        if e.get("ph") == "X" and e.get("name") == SLICE and e.get("cat") == SPAN_CAT:
            w0 = float(e["ts"])
            return w0, w0 + float(e["dur"])
    raise RuntimeError(f"the trace holds no {SLICE} range")


def traced(traffic):
    """``traffic.trace()`` and the spans reduction of the slice it traced:
    ``(summary, slice_work, reduced)``. ``trace.summarize`` is wrapped for
    this call alone, in this process alone, to see the events before
    ``trace.profile_slice`` deletes them; the summary is the one it makes."""
    from perfbench.lib import trace

    kept = []
    summarize = trace.summarize

    def keep(events):
        kept.append(reduce(events, *window(events)))
        return summarize(events)

    trace.summarize = keep
    try:
        summary, work = traffic.trace()
    finally:
        trace.summarize = summarize
    return summary, work, kept[-1]
