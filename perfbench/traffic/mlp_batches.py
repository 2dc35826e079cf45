"""Traffic kind ``mlp_batches``: one client that dispatches forward calls of
the packed MLP back to back, each on a batch of ``rows`` rows taken in turn
from a pool of ``pool`` seed-made input batches. Nothing waits between
calls: the host only reads the clock every ``check_every`` calls, and the
window closes with one synchronise.

Reports ``mlp_rows_per_s`` (every row of every call in the window over the
window's time). The check keeps, for each pool batch, the output of one
call of the window (its round drawn from the seed among the first
``keep_rounds``), and compares every row of those with the reference.
Its control is the program's own path at a lower precision
(``program_<dtype>``).

A traffic module's interface (all kinds): ``Traffic(cell, seed, dev,
control)`` builds the system and warms every shape it will use (``control``,
the calibration's, is the workload's ``check.control`` or None);
``window(seconds)`` runs the traffic and returns ``attempted``, ``failed``,
``e2e`` (end-to-end values by metric name) and ``layer`` (what per-layer
readers read); ``trace()`` runs a traced slice and returns the trace
summary with the slice's counted work; ``check()`` frees the program's
state and returns the compared numbers by name.
"""

from __future__ import annotations

import random
import time

from perfbench.counts import ternary_mlp as counts
from perfbench.lib import checks, device, spec, trace
from perfbench.lib.seeds import derive


class Traffic:
    def __init__(self, cell, seed: int, dev, control: str | None = None):
        p = cell.params
        self.cell, self.seed, self.dev = cell, seed, dev
        self.rows, self.pool_n = p["rows"], p["pool"]
        mod = spec.system_module(cell.config)
        self.sys = mod.System(cell.config, seed, dev)
        program_dtype, rounding = checks.control_parts(control)
        if rounding is not None:
            raise ValueError("mlp_batches takes a control on the program's own path")
        self.cd = device.DTYPES[program_dtype or p["compute_dtype"]]
        self.pool = self.sys.inputs(self.pool_n, self.rows)
        self.work = counts.forward(cell.config, self.sys.nnz, self.rows)
        for i in range(p["warm_calls"]):
            self.sys.forward(self.pool[i % self.pool_n], self.cd)
        device.sync(dev)
        rng = random.Random(derive(seed, "mlp-keep"))
        self.keep_at = {rng.randrange(p["keep_rounds"]) * self.pool_n + j: j
                        for j in range(self.pool_n)}
        self.kept = {}

    def window(self, seconds: float) -> dict:
        every = self.cell.params["check_every"]
        calls = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            for _ in range(every):
                y = self.sys.forward(self.pool[calls % self.pool_n], self.cd)
                if calls in self.keep_at:
                    self.kept[self.keep_at[calls]] = y
                calls += 1
        device.sync(self.dev)
        secs = time.perf_counter() - t0
        return {"attempted": calls, "failed": 0,
                "e2e": {"mlp_rows_per_s": calls * self.rows / secs},
                "layer": {"seconds": secs, "flops": calls * self.work["flops"]}}

    def trace(self):
        t = self.cell.workload["trace"]

        def run(n):
            def calls():
                for i in range(n):  # outputs dropped, as in the window
                    self.sys.forward(self.pool[i % self.pool_n], self.cd)
            return calls

        summary = trace.profile_slice(run(t["warm_units"]), run(t["units"]), self.dev)
        n = t["units"]
        return summary, {"spmm": self.work["spmm"] * n, "flash": []}

    def check(self) -> dict:
        self.sys.free()
        if not self.kept:
            return {"y_row_err": float("inf")}
        idx = sorted(self.kept)
        y = [self.kept[j] for j in idx]
        ref = [self.sys.reference_outputs(self.pool[j]) for j in idx]
        return {"y_row_err": max(checks.worst_row_error(a, b) for a, b in zip(y, ref))}
