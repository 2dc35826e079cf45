"""The benchmark of smmb_tpu_torch, the PyTorch/CUDA port, on an NVIDIA card.

One command runs one cell of ``BENCHMARK.json`` once:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It builds the cell's system from the seed (weights and inputs made on the
card), warms every shape the traffic uses, measures for ``--seconds``,
checks what the timed path produced against the plain reference under
``perfbench/reference/``, and prints one JSON line as the last line of its
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones, read
from a profiled slice after the window), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number with its limit,
which also end standard error.

Without a card, or with fewer than the cell asks for, it exits with code 3
and no result; if JAX or the JAX package is loaded once the window has
closed, with code 4. Build and kernel caches stay in fixed directories
inside the checkout (``perfbench/.cache``, ``smmb_tpu_torch/_build``).
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

PKG = Path(__file__).resolve().parent
if str(PKG.parent) not in sys.path:
    sys.path.insert(0, str(PKG.parent))

from perfbench.lib import env  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "smmb_tpu")
HOST_THREADS = 4


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def prepare_torch(chips: int, allow_cpu: bool):
    """torch with the run's settings, and the device (exits without one)."""
    import torch

    from perfbench.lib import device

    torch.set_num_threads(HOST_THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = device.require(chips, allow_cpu)
    if dev.type == "cuda":
        from smmb_tpu_torch.kernels import _build

        _build.build_all()
    return dev


def main(argv=None, *, allow_cpu: bool = False, manifest: Path | None = None,
         data_root: Path | None = None, t0: float | None = None) -> int:
    args = parser().parse_args(argv)
    t0 = _T0 if t0 is None else t0
    env.prepare(PKG)
    from perfbench.counts.ops import peaks_for
    from perfbench.lib import checks, device, spec

    cell = spec.load_cell(args.workload, manifest, data_root)
    dev = prepare_torch(cell.entry["chips"], allow_cpu)
    if args.trace and dev.type != "cuda":
        raise SystemExit("--trace 1 reads the card's trace: it needs a card")
    traffic = spec.traffic_module(cell).Traffic(cell, args.seed, dev)
    device.sync(dev)
    device.reset_peak(dev)
    # the set-up's objects are never freed before the end: keep the
    # collector's pauses inside the window short by not scanning them
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    win = traffic.window(args.seconds)
    summary = slice_work = None
    if args.trace:
        summary, slice_work = traffic.trace()
    dev_info = device.info(dev, cell.entry["chips"])
    ok, compared = checks.verdict(traffic.check(), cell.workload["check"]["limits"])
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: modules of JAX or the JAX package are loaded: {bad}", file=sys.stderr)
        return 4
    metrics = {}
    if not args.trace:
        for m in cell.end_to_end():
            value = setup_s if m["name"] == "setup_s" else win["e2e"].get(m["name"])
            if value is None:
                raise SystemExit(f"{cell.name}: the traffic reports no {m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        ctx = types.SimpleNamespace(cell=cell, window=win["layer"], trace=summary,
                                    slice_work=slice_work, peaks=peaks_for(dev_info["kind"]))
        for m in cell.per_layer():
            value = spec.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
    result = {"correct": ok, "attempted": win["attempted"], "failed": win["failed"],
              "metrics": metrics, "device": dev_info}
    if args.trace:
        result["breakdown"] = summary.breakdown()
    result["checks"] = compared
    card = device.power_limit()
    print(f"perfbench: {cell.name} seed {args.seed} on {card or dev_info['kind']}; "
          f"setup {setup_s:.3f} s, window {win['layer']['seconds']:.3f} s", file=sys.stderr)
    for name, c in compared.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
