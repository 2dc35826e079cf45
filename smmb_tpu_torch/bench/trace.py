"""Where the device time goes (counterpart of smmb_tpu/bench/trace.py):
``torch.profiler`` over a short steady window, for the packed MLP forward,
with ``--lm`` one decode step of the ternary LM, or with ``--showcase``
every row of the reference showcase.

Reports, per call: the device time and launch count of each kernel by
name, their sum, the call's time between CUDA events (bench/measure.py)
and the device's busy share (kernel time over call time; the rest is the
card waiting on the host). Profiling adds host time, so the call is timed
without the profiler.

CLI: python -m smmb_tpu_torch.bench.trace [--depth 4] [--dim 4096] [--batch 256]
     python -m smmb_tpu_torch.bench.trace --lm [lm flags of bench/lm_bench.py]
     python -m smmb_tpu_torch.bench.trace --showcase
The ``--lm`` step is ``lm_decode_step`` at position ``prompt_len`` of a
prefilled bf16 cache, at the configuration of ``python -m smmb_tpu_torch lm``;
with ``--flash`` its cache reads are the flash-decode kernel B4.
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


def lm_decode_step_fn(args):
    """A call that runs one bf16 ``lm_decode_step`` at position
    ``prompt_len`` of caches filled by ``lm_prefill`` (every call restarts
    there), for the LM of ``python -m smmb_tpu_torch lm`` with ``args``
    (``args.flash``: the prefill through B9, the step's cache reads B4)."""
    from smmb_tpu_torch.bench.lm_bench import build_lm, config_from_args
    from smmb_tpu_torch.models.lm import lm_decode_step, lm_init_cache, lm_prefill

    cfg = config_from_args(args)
    packed, prompt = build_lm(cfg, args.batch, args.prompt_len)
    kw = dict(compute_dtype=torch.bfloat16, use_flash=args.flash)
    cache = lm_init_cache(cfg, args.batch, dtype=torch.bfloat16, device=prompt.device)
    logits, filled = lm_prefill(packed, prompt, cache, cfg, **kw)
    tok = torch.argmax(logits, dim=-1)

    def step():
        return lm_decode_step(packed, tok, [dict(c) for c in filled], cfg, **kw)[0]

    return step


def report(fn, label: dict, *args) -> dict:
    """Print the kernel rows and the summary line of ``fn(*args)``."""
    t = measure(fn, *args, reps=5)
    rows = kernel_breakdown(fn, *args)
    for r in rows:
        print(json.dumps(r))
    kernel_us = sum(r["us"] for r in rows)
    summary = {
        "device": torch.cuda.get_device_name(0), **label,
        "call_us": t.min_s * 1e6, "kernel_us": kernel_us,
        "launches": sum(r["launches"] for r in rows),
        "busy_share": kernel_us / (t.min_s * 1e6),
    }
    print(json.dumps(summary))
    return summary


def showcase_breakdown(cases=None, seed: int = 0) -> list[dict]:
    """One line per showcase row (the inputs of ``run_case`` at ``seed``):
    its call time between CUDA events, the device time and launches of its
    kernels, the busy share and the kernel that takes the most time."""
    from smmb_tpu_torch.bench.sweep import SHOWCASE_CASES, _kernels_for_case
    from smmb_tpu_torch.utils import rng

    out = []
    for m, k, n in cases or SHOWCASE_CASES:
        gen = rng.make_generator(seed, "cuda")
        x = rng.rand_dense(gen, (m, k))
        w = rng.rand_ternary(gen, (k, n), non_zero=2)
        b = rng.rand_dense(gen, (n,))
        rows, _ = _kernels_for_case(x, w.cpu().numpy(), b, True)
        for name, fn, args, _, _ in rows:
            call_us = measure(fn, *args, reps=3).min_s * 1e6
            kernels = kernel_breakdown(fn, *args)
            kernel_us = sum(r["us"] for r in kernels)
            line = {"case": f"{m}x{k}x{n}", "row": name, "call_us": call_us,
                    "kernel_us": kernel_us,
                    "launches": sum(r["launches"] for r in kernels),
                    "busy_share": kernel_us / call_us,
                    "top": kernels[0]["name"][:60] if kernels else None}
            print(json.dumps(line), flush=True)
            out.append(line)
    return out


def main(argv=None):
    from smmb_tpu_torch.bench.lm_bench import parser

    ap = parser()
    ap.description = __doc__
    ap.add_argument("--lm", action="store_true", help="one LM decode step")
    ap.add_argument("--showcase", action="store_true", help="every showcase row")
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--dim", type=int, default=4096)
    ap.set_defaults(batch=None)  # 1 for --lm, 256 for the MLP
    args = ap.parse_args(argv)
    if args.showcase:
        showcase_breakdown()
        return
    if args.batch is None:
        args.batch = 1 if args.lm else 256
    if args.lm:
        report(lm_decode_step_fn(args), {
            "call": "lm_decode_step", "layers": args.layers, "d_model": args.d_model,
            "d_ff": args.d_ff, "vocab": args.vocab, "batch": args.batch,
            "pos": args.prompt_len, "flash": args.flash})
        return
    cfg, packed, x, _ = build_mlp(args.depth, args.dim, args.batch, 10)

    def forward(x):
        return mlp_forward(packed, x, cfg, compute_dtype=torch.bfloat16)

    report(forward, {"call": "mlp_forward", "depth": args.depth, "dim": args.dim,
                     "batch": args.batch}, x)


if __name__ == "__main__":
    main()
