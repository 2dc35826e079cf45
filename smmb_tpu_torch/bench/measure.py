"""Device-time measurement on the CUDA card (counterpart of
smmb_tpu/bench/measure.py:34-92).

Protocol, mirroring the reference's adaptive warm-up: warm-up calls (kernel
build, allocator, caches), then a calibration that doubles the calls per
batch until one batch costs at least ``MIN_BATCH_S``, then ``reps`` timed
batches. Each batch is timed between two CUDA events on the current stream,
with ``torch.cuda.synchronize()`` fences around it, so the time is the
card's time for the batch (launch gaps included when the host is slower
than the card). Reports mean, min and std seconds per call. There is no CPU
path: a measurement without a card raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

DEFAULT_REPS = 10
MIN_BATCH_S = 0.02
WARMUP_CALLS = 2


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
