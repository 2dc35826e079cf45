"""The cost of the port's spans (smmb_tpu_torch/utils/spans.py) on the card's
host, and the per-span split of a benchmark cell's traced slice.

    python3 scripts/torch_span_overhead.py --workload <cell> [--seed N] [--pairs 2]

1. The off path every run pays: ns of one ``with span(...)`` with no
   profiler recording, less an empty loop's, by ``timeit``.
2. The cell's traced slice (``perfbench``'s ``Traffic.trace``, as a
   ``--trace 1`` run takes it after its window), in pairs: spans on, then
   the gate forced off in this process alone (``spans._recording``). Each
   slice's window (host clock, to its closing synchronise) a unit of work
   (a decode step, a request, an MLP forward) and its device idle share.
3. The spans reduction (``perfbench/lib/spans.py``, which a ``--trace 1``
   run of ``perfbench/run.py`` does not make) of the last slice with spans
   on, as JSON under
   ``chiprun_out/spans/<cell>.json``: each span's count, host, launch,
   device and idle figures, ``skew_us``, and the self device seconds of all
   rows against the window's operations.

The last line of standard output is a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import timeit
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def off_ns(n: int = 200_000) -> float:
    from smmb_tpu_torch.utils.spans import LM_HEAD, span

    def spanned():
        with span(LM_HEAD):
            pass

    def empty():
        pass

    best = [min(timeit.repeat(fn, number=n, repeat=5)) / n * 1e9 for fn in (spanned, empty)]
    return best[0] - best[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2147483659)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "spans"))
    args = ap.parse_args(argv)

    from perfbench import run
    from perfbench.lib import env, spec
    from perfbench.lib import spans as reduce_spans

    env.prepare(run.PKG)
    cell = spec.load_cell(args.workload)
    dev = run.prepare_torch(cell.entry["chips"], allow_cpu=False)
    from smmb_tpu_torch.utils import spans

    ns = off_ns()
    traffic = spec.traffic_module(cell).Traffic(cell, args.seed, dev)
    units = cell.workload["trace"]["units"]
    gate = spans._recording
    slices = {"on": [], "off": []}
    summary = reduced = None
    for _ in range(args.pairs):
        for mode in ("on", "off"):
            spans._recording = gate if mode == "on" else (lambda: False)
            s, _, r = reduce_spans.traced(traffic)
            slices[mode].append({"host_ms_per_unit": s.window_s / units * 1e3,
                                 "idle_pct": 100.0 * (1 - s.busy_s / s.window_s)})
            if mode == "on":
                summary, reduced = s, r
    spans._recording = gate
    rows = reduced["rows"]
    window_ops = sum(sec for sec, _ in summary.kernels.values())
    charged = sum(r["device_s_self"] for r in rows.values())
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{cell.name}.json").write_text(json.dumps(
        {"units": units, "rows": rows, "skew_us": reduced["skew_us"],
         "window_s": summary.window_s, "busy_s": summary.busy_s,
         "window_ops_s": window_ops, "charged_self_s": charged,
         "gaps": summary.gaps[:10]}, indent=1))
    for name, r in sorted(rows.items(), key=lambda kv: -kv[1]["device_s"]):
        print(f"{name:24s} n/unit {r['count'] / units:8.2f}  host ms/unit "
              f"{r['host_s'] / units * 1e3:9.3f}  launches/unit {r['launches'] / units:8.1f} "
              f"(self {r['launches_self'] / units:7.1f})  device ms/unit "
              f"{r['device_s'] / units * 1e3:9.3f} (self {r['device_s_self'] / units * 1e3:8.3f})"
              f"  idle ms/unit {r['idle_s'] / units * 1e3:8.3f}")
    med = {m: statistics.median(x["host_ms_per_unit"] for x in v) for m, v in slices.items()}
    print(json.dumps({"cell": cell.name, "seed": args.seed, "span_off_ns": ns,
                      "slices": slices, "median_host_ms_per_unit": med,
                      "skew_us": reduced["skew_us"],
                      "charged_over_window_ops": charged / window_ops if window_ops else None}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
