"""Where the device time goes (counterpart of smmb_tpu/bench/trace.py):
``torch.profiler`` over a short steady window, for the packed MLP forward,
with ``--lm`` one decode step of the ternary LM, or with ``--showcase``
every row of the reference showcase.

``capture_trace`` writes a Chrome trace of a few calls of any function
(open it in Perfetto or chrome://tracing), and ``annotate`` names a region
in it, as JAX's ``capture_trace`` and ``annotate`` do for the XLA profiler.

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
with ``--flash`` its cache reads are the flash-decode kernel B4, with
``--kv-quant`` the cache is int8 (B7 writes it, B8 reads it under ``--flash``).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

import torch

from smmb_tpu_torch.bench.measure import measure
from smmb_tpu_torch.bench.mlp_bench import build_mlp
from smmb_tpu_torch.models.mlp import mlp_forward


# calls of a profiler session's warm-up step, one entry a session: a
# session whose counts show lost events is run again with a longer warm-up
WARM_CALLS = (10, 50, 250)
EDGE_S = 0.02  # idle seconds at each edge of the measured step


TRACE_DIR = os.path.join(tempfile.gettempdir(), "smmb_torch_trace")


def _session(fn, args, warm: int, n_calls: int, card: bool):
    """A profiler session of ``fn(*args)``: a warm-up step of ``warm`` calls
    whose events are discarded, then a step of ``n_calls`` calls with
    ``EDGE_S`` idle at each edge (CPU activity, and CUDA activity on a
    card). Returns the profiler, which holds the second step's events."""
    from torch.profiler import ProfilerActivity, profile, schedule

    def sync():
        if card:
            torch.cuda.synchronize()

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(warm):
            fn(*args)
        sync()
        prof.step()
        time.sleep(EDGE_S)
        for _ in range(n_calls):
            fn(*args)
        sync()
        time.sleep(EDGE_S)
        prof.step()
    return prof


def _kernel_events(prof) -> list:
    """The device kernels of a session's measured step (the schedule's step
    annotation spans the step on the device too, and is left out)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")]


def capture_trace(fn, *args, trace_dir: str = TRACE_DIR, n_calls: int = 3) -> str:
    """Run ``fn(*args)`` once, then ``n_calls`` times under ``torch.profiler``
    (CPU activity, and CUDA activity when an argument is on a card), and
    write those calls as a Chrome trace into ``trace_dir``; returns
    ``trace_dir``. The session opens with a warm-up step, discarded, as
    ``kernel_breakdown``'s do: on a card a session that follows others
    loses its first kernel events, so one whose calls show no kernel is run
    again with the next, longer warm-up (the last is written whatever it
    holds)."""
    os.makedirs(trace_dir, exist_ok=True)
    card = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
    fn(*args)  # kernel builds and the allocator's first requests, outside the trace
    if card:
        torch.cuda.synchronize()
    for warm in WARM_CALLS:
        prof = _session(fn, args, warm, n_calls, card)
        if not card or _kernel_events(prof):
            break
    prof.export_chrome_trace(os.path.join(trace_dir,
                                          f"trace_{os.getpid()}_{time.time_ns()}.json"))
    return trace_dir


@contextlib.contextmanager
def annotate(name: str):
    """A named region (``with annotate("decode"): ...``): a
    ``record_function`` range in a profiler trace and, with a card, an NVTX
    range."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


def kernel_breakdown(fn, *args, n_calls: int = 10) -> list[dict]:
    """[{name, us, launches}] of each device kernel per call of ``fn(*args)``,
    by device time (the CPU-side operators that launched them are left out,
    so no time is counted twice).

    In a session that follows others in the same process the profiler loses
    kernel events (seen on an H100) in two ways: the first kernels recorded
    after the session starts, more of them the more sessions came before;
    and kernels whose device timestamps fall outside the measured step,
    when the device clock reads some hundred µs off the host's. So each
    session opens with a warm-up step of ``WARM_CALLS`` calls whose events
    are discarded, and leaves ``EDGE_S`` idle at each edge of the measured
    step (``_session``). ``fn`` must make the same launches on every call:
    a session in which some kernel's events are not a whole number a call
    lost events, and is run again with the next, longer warm-up; after the
    last this raises."""
    fn(*args)
    torch.cuda.synchronize()
    for warm in WARM_CALLS:
        events = _kernel_events(_session(fn, args, warm, n_calls, True))
        if events and all(e.count % n_calls == 0 for e in events):
            break
    else:
        raise RuntimeError(f"the profiler lost kernel events in {len(WARM_CALLS)} sessions: "
                           f"{[(e.key, e.count) for e in events]} for {n_calls} calls")
    rows = [{"name": e.key, "us": e.self_device_time_total / n_calls,
             "launches": e.count // n_calls} for e in events]
    return sorted(rows, key=lambda r: -r["us"])


def lm_decode_step_fn(args):
    """A call that runs one bf16 ``lm_decode_step`` at position
    ``prompt_len`` of caches filled by ``lm_prefill`` (every call restarts
    there), for the LM of ``python -m smmb_tpu_torch lm`` with ``args``
    (``args.flash``: the prefill through B9, the step's cache reads B4;
    ``args.kv_quant``: int8 caches)."""
    from smmb_tpu_torch.bench.lm_bench import build_lm, config_from_args
    from smmb_tpu_torch.models.lm import lm_decode_step, lm_init_cache, lm_prefill

    cfg = config_from_args(args)
    packed, prompt = build_lm(cfg, args.batch, args.prompt_len)
    kw = dict(compute_dtype=torch.bfloat16, use_flash=args.flash)
    cache = lm_init_cache(cfg, args.batch, dtype=torch.bfloat16,
                          quantized=args.kv_quant, device=prompt.device)
    logits, filled = lm_prefill(packed, prompt, cache, cfg, **kw)
    tok = torch.argmax(logits, dim=-1)

    def step():
        return lm_decode_step(packed, tok, [dict(c) for c in filled], cfg, **kw)[0]

    return step


def report(fn, label: dict, *args) -> dict:
    """Print the kernel rows and the summary line of ``fn(*args)``; returns
    the summary with the rows under ``kernels``."""
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
    return {**summary, "kernels": rows}


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
            "pos": args.prompt_len, "flash": args.flash, "kv_quant": args.kv_quant})
        return
    cfg, packed, x, _ = build_mlp(args.depth, args.dim, args.batch, 10)

    def forward(x):
        return mlp_forward(packed, x, cfg, compute_dtype=torch.bfloat16)

    report(forward, {"call": "mlp_forward", "depth": args.depth, "dim": args.dim,
                     "batch": args.batch}, x)


if __name__ == "__main__":
    main()
