"""Device-time measurement on the CUDA card (counterpart of
smmb_tpu/bench/measure.py: ``measure`` of its lines 34-92,
``measure_device`` of 164-271).

Protocol, mirroring the reference's adaptive warm-up: warm-up calls (kernel
build, allocator, caches), then a calibration that doubles the calls per
batch until one batch costs at least ``MIN_BATCH_S``, then ``reps`` timed
batches. Each batch is timed between two CUDA events on the current stream,
with ``torch.cuda.synchronize()`` fences around it, so the time is the
card's time for the batch (launch gaps included when the host is slower
than the card). Reports mean, min and std seconds per call.

``measure_device`` cancels the host's launch cost instead: R calls captured
in one CUDA graph and 2R in another, each replayed ``reps`` times between
CUDA events; the fixed cost of a replay is median(2·t_R − t_2R), as in
JAX's protocol, and what is left over R or 2R is the per-call device time
(the kernels and the gaps between them inside a graph).

Neither has a CPU path: a measurement without a card raises.
``measure_host`` is the host's wall clock per call, for runs of a harness
on CPU tensors (the scaling bench's CPU worlds); its numbers are host
times, never device times.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

DEFAULT_REPS = 10
MIN_BATCH_S = 0.02
WARMUP_CALLS = 2
HOST_CALLS = 2  # calls a batch of the benches' host-timed CPU runs


@dataclasses.dataclass(frozen=True)
class Measurement:
    mean_s: float
    min_s: float
    std_s: float
    calls_per_batch: int
    reps: int


def measure(fn, *args, reps: int = DEFAULT_REPS, calls: int | None = None) -> Measurement:
    """Per-call device time of ``fn(*args)`` on the current CUDA device.

    ``calls`` fixes the calls per timed batch (the counterpart of JAX's
    ``iters``, the length of its device loop); None calibrates it.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("measure() times the CUDA card and there is none")

    def run_batch(ncalls: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(ncalls):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3

    for _ in range(WARMUP_CALLS):
        fn(*args)
    torch.cuda.synchronize()

    if calls is not None and calls < 1:
        raise ValueError(f"calls={calls} must be at least 1")
    n = 1
    while calls is None:
        t = run_batch(n)
        if t >= MIN_BATCH_S or n >= 1 << 20:
            calls = n
        n = max(n * 2, int(n * MIN_BATCH_S / max(t, 1e-9)) + 1)

    times = np.array([run_batch(calls) / calls for _ in range(reps)])
    return Measurement(
        mean_s=float(times.mean()),
        min_s=float(times.min()),
        std_s=float(times.std()),
        calls_per_batch=calls,
        reps=reps,
    )


def _graph(fn, calls):
    """A CUDA graph of ``calls`` calls, call i given by ``calls[i]`` (the
    arguments, from which ``fn`` is called), warmed up on a side stream first
    as capture asks."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in calls[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in calls:
            fn(*args)
    torch.cuda.synchronize()
    return graph


def _replay_s(graph) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3


def measure_device(fn, *args, iters: int | None = None, reps: int = DEFAULT_REPS,
                   min_batch_s: float = MIN_BATCH_S, rotate_argnums: tuple = (),
                   rotate_min_mb: float = 512.0) -> Measurement:
    """Per-call device time of ``fn(*args)`` with the launch cost cancelled.

    1. calibrate: grow R, the calls in one graph, from 16 (at least
       doubling, toward the target) until one replay takes at least
       ``min_batch_s``, at most 2**14 calls (``iters`` fixes R instead);
    2. replay the R-call and the 2R-call graphs ``reps`` times each; the
       fixed cost of a replay is median(2·t_R − t_2R);
    3. ``min_s`` is the least of the corrected per-call times, ``mean_s``
       their median.

    ``rotate_argnums``: positional tensor arguments that a real caller
    streams from device memory; they are copied until the copies hold
    ``rotate_min_mb`` MB (10× the H100's 50 MB L2 by default), and call i
    of a graph reads copy i % copies, so a small operand is not measured
    from the L2. ``fn`` must not synchronize with the host (a graph cannot
    capture that).
    """
    if not torch.cuda.is_available():
        raise RuntimeError("measure_device() times the CUDA card and there is none")
    copies = [args]
    if rotate_argnums:
        nbytes = sum(args[a].numel() * args[a].element_size() for a in rotate_argnums)
        n = max(2, math.ceil(rotate_min_mb * 1e6 / nbytes))
        copies = [tuple(a.clone() if i in rotate_argnums and c else a
                        for i, a in enumerate(args)) for c in range(n)]

    def graph_of(r):
        return _graph(fn, [copies[i % len(copies)] for i in range(r)])

    fn(*args)  # builds the kernels, warms the allocator
    torch.cuda.synchronize()
    r = iters
    if r is None:
        r = 16
        while True:
            graph = graph_of(r)
            t = min(_replay_s(graph), _replay_s(graph))
            if t >= min_batch_s or r >= 1 << 14:
                break
            r = min(max(2 * r, int(r * min_batch_s / max(t, 1e-9)) + 1), 1 << 14)
    if r < 1:
        raise ValueError(f"iters={r} must be at least 1")
    short, long = graph_of(r), graph_of(2 * r)
    for graph in (short, long):  # a first replay settles each
        _replay_s(graph)
    t_short, t_long = [], []
    for _ in range(reps):
        t_short.append(_replay_s(short))
        t_long.append(_replay_s(long))
    t_short, t_long = np.array(t_short), np.array(t_long)
    overhead = max(0.0, float(np.median(2 * t_short - t_long)))
    per_call = np.concatenate([(t_short - overhead) / r, (t_long - overhead) / (2 * r)])
    per_call = per_call[per_call > 0]
    if len(per_call) == 0:
        per_call = np.array([t_long.min() / (2 * r)])
    return Measurement(
        mean_s=max(float(np.median(per_call)), 1e-9),
        min_s=max(float(np.min(per_call)), 1e-9),
        std_s=float(np.std(per_call)),
        calls_per_batch=r,
        reps=reps,
    )


def measure_host(fn, *args, calls: int, reps: int = DEFAULT_REPS) -> Measurement:
    """Per-call host wall-clock time of ``fn(*args)`` on CPU tensors:
    ``WARMUP_CALLS`` calls, then ``reps`` batches of ``calls`` calls timed
    by ``time.perf_counter``. The call count is fixed, not calibrated, so
    ranks that exchange collectives in ``fn`` issue the same number."""
    if calls < 1:
        raise ValueError(f"calls={calls} must be at least 1")
    for _ in range(WARMUP_CALLS):
        fn(*args)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(*args)
        times.append((time.perf_counter() - t0) / calls)
    times = np.array(times)
    return Measurement(mean_s=float(times.mean()), min_s=float(times.min()),
                       std_s=float(times.std()), calls_per_batch=calls, reps=reps)
