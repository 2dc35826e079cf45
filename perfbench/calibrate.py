"""Readings that a cell's correctness limits are set from; not run by the
benchmark.

For each seed, in one process: build the cell's system, run its traffic for
a short window at the cell's own sizes and load, and print the numbers its
check compares, as one JSON line. ``--control-seeds`` does the same with the
cell's control (its workload's ``check.control``): the program's own path
one precision below the configuration's (``program_int8``: W2A8), or the
reference rounded to that precision in the program's place
(``reference_float8_e4m3fn``), which has to come out beyond the limits.

    python3 perfbench/calibrate.py --workload <cell> --seconds <s> \\
        --seeds 1 2 3 ... [--control-seeds 7 8 9]

A limit sits above the largest sound reading (over a dozen seeds or more)
and below the smallest control reading, with more room above the first.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent
if str(PKG.parent) not in sys.path:
    sys.path.insert(0, str(PKG.parent))

from perfbench import run  # noqa: E402
from perfbench.lib import env  # noqa: E402


def readings(cell, seed: int, dev, seconds: float, control: str | None) -> dict:
    import torch

    from perfbench.lib import device, spec

    t0 = time.perf_counter()
    traffic = spec.traffic_module(cell).Traffic(cell, seed, dev, control=control)
    setup = time.perf_counter() - t0
    win = traffic.window(seconds)
    numbers = traffic.check()
    del traffic
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    device.sync(dev)
    return {"seed": seed, "control": control, "setup_s": setup, "attempted": win["attempted"],
            "e2e": win["e2e"], "numbers": numbers}


def main(argv=None, *, allow_cpu: bool = False, manifest=None, data_root=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    env.prepare(PKG)
    from perfbench.lib import spec

    cell = spec.load_cell(args.workload, manifest, data_root)
    dev = run.prepare_torch(cell.entry["chips"], allow_cpu)
    out = []
    control = cell.workload["check"]["control"]
    for seeds, ctl in ((args.seeds, None), (args.control_seeds, control)):
        for seed in seeds:
            row = readings(cell, seed, dev, args.seconds, ctl)
            print(json.dumps(row), flush=True)
            out.append(row)
    return out


if __name__ == "__main__":
    main()
