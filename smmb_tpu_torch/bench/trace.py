"""Where the device time goes in the packed MLP forward (counterpart of
smmb_tpu/bench/trace.py): ``torch.profiler`` over a short steady window.

Reports, per forward: the device time and launch count of each kernel by
name, their sum, the forward's time between CUDA events (bench/measure.py)
and the device's busy share (kernel time over forward time; the rest is the
card waiting on the host). Profiling adds host time, so the forward is
timed without the profiler.

CLI: python -m smmb_tpu_torch.bench.trace [--depth 4] [--dim 4096] [--batch 256]
"""

from __future__ import annotations

import json

import torch

from smmb_tpu_torch.bench.measure import measure
from smmb_tpu_torch.bench.mlp_bench import build_mlp
from smmb_tpu_torch.models.mlp import mlp_forward


def kernel_breakdown(fn, *args, n_calls: int = 10) -> list[dict]:
    """[{name, us, launches}] of each device kernel per call of ``fn(*args)``,
    by device time (the CPU-side operators that launched them are left out,
    so no time is counted twice)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_calls):
            fn(*args)
        torch.cuda.synchronize()
    rows = [
        {"name": evt.key, "us": evt.self_device_time_total / n_calls,
         "launches": evt.count / n_calls}
        for evt in prof.key_averages()
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0
    ]
    return sorted(rows, key=lambda r: -r["us"])


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--dim", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args(argv)
    cfg, packed, x, _ = build_mlp(args.depth, args.dim, args.batch, 10)

    def forward(x):
        return mlp_forward(packed, x, cfg, compute_dtype=torch.bfloat16)

    t = measure(forward, x, reps=5)
    rows = kernel_breakdown(forward, x)
    for r in rows:
        print(json.dumps(r))
    kernel_us = sum(r["us"] for r in rows)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "depth": args.depth, "dim": args.dim, "batch": args.batch,
        "forward_us": t.min_s * 1e6, "kernel_us": kernel_us,
        "busy_share": kernel_us / (t.min_s * 1e6),
    }))


if __name__ == "__main__":
    main()
