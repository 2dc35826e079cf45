"""Device time from a ``torch.profiler`` trace of a short slice of traffic.

The session logic is copied from the port's ``bench/trace.py``: a late
profiler session on an H100 loses its first kernel events, so each session
opens with a warm-up step whose events are discarded, and leaves ``EDGE_S``
idle at each edge of the measured step. The measured step runs inside a
``perfbench.slice`` range; its span on the host clock, which ends after a
synchronise, is the traced window. The trace is written as Chrome JSON under
``$TMPDIR`` (a unique name), read back and deleted.

Reduction: the union of the device's operations (kernels, copies, sets)
inside the window is ``busy_s``; per kernel name, the summed device seconds
and the number of launches; and the idle gaps of the device, each named by
the innermost host operation under way at its middle.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time

import torch

EDGE_S = 0.02
SLICE = "perfbench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
NAME_CHARS = 160  # a kernel's name is cut to this many characters in the breakdown


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: dict  # name -> [device seconds, launches] inside the window
    gaps: list  # [(host activity, seconds)] of the device's idle gaps, longest first

    def seconds_matching(self, patterns) -> float:
        """Device seconds of the kernels whose name holds any of ``patterns``."""
        return sum(s for name, (s, _) in self.kernels.items()
                   if any(p in name for p in patterns))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:top]
        return {"device_ops": [[name[:NAME_CHARS], s] for name, (s, _) in ops],
                "idle_gaps": [[name[:NAME_CHARS], s] for name, s in self.gaps[:top]]}


def profile_slice(warm, work, dev: torch.device) -> TraceSummary:
    """Trace ``work()`` after a discarded warm-up step that runs ``warm()``."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        warm()
        sync()
        prof.step()
        time.sleep(EDGE_S)
        with record_function(SLICE):
            work()
            sync()
        time.sleep(EDGE_S)
        prof.step()
    fd, path = tempfile.mkstemp(prefix="perfbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return summarize(events)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: list) -> TraceSummary:
    """Reduce a Chrome trace's events (times in µs) to a ``TraceSummary``."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == SLICE
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise RuntimeError(f"the trace holds no {SLICE} range")
    w0 = float(spans[0]["ts"])
    w1 = w0 + float(spans[0]["dur"])
    kernels: dict = {}
    busy = []
    host = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            busy.append((a, b))
            row = kernels.setdefault(e["name"], [0.0, 0])
            row[0] += (b - a) * 1e-6
            row[1] += 1
        elif cat in HOST_CATS and e.get("name") != SLICE \
                and not e.get("name", "").startswith("ProfilerStep"):
            host.append((a, b, e["name"]))
    merged = _union(busy)
    busy_us = sum(b - a for a, b in merged)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:10]:
        mid = 0.5 * (a + b)
        under = [h for h in host if h[0] <= mid <= h[1]]
        name = min(under, key=lambda h: h[1] - h[0])[2] if under else "host: Python, no operator"
        named.append((name, (b - a) * 1e-6))
    return TraceSummary(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
                        kernels=kernels, gaps=named)
