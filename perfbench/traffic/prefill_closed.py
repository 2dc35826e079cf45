"""Traffic kind ``prefill_closed``: one closed-loop client of the LM's prompt
pass. Each request is ``batch`` prompts of one length; the lengths come in
cycles that hold each of ``lengths`` once, in an order drawn from the seed
for each cycle, so every window holds the same mix. Tokens are uniform over
the vocabulary. A request allocates its cache (``cache_len`` long), runs
``lm_prefill`` and takes the argmax of the last position's logits; its time
to first token runs from its start to that token on the host. The next
request starts when the previous one has ended.

Reports ``prefill_tokens_per_s`` (all prompt tokens over the window's
time) and ``ttft_p95_ms`` / ``ttft_p90_ms`` over all requests. The check
draws ``per_length`` finished requests of each length from the seed and
compares each prompt's first token and last-position logits with the
reference's. Its control (``reference_<dtype>``) puts the reference,
rounded to that dtype, in the program's place for the same prompts. See
``mlp_batches.py`` for a traffic module's interface.
"""

from __future__ import annotations

import random
import time

import torch

from perfbench.counts import ternary_lm as counts
from perfbench.lib import checks, device, spec, stats, trace
from perfbench.lib.seeds import derive


class Traffic:
    def __init__(self, cell, seed: int, dev, control: str | None = None):
        p = cell.params
        self.cell, self.seed, self.dev = cell, seed, dev
        self.batch, self.lengths = p["batch"], list(p["lengths"])
        mod = spec.system_module(cell.config)
        self.sys = mod.System(cell.config, seed, dev, p["cache_len"])
        program_dtype, self.rounding = checks.control_parts(control)
        self.cd = device.DTYPES[program_dtype or p["compute_dtype"]]
        self.flash = p["use_flash"]
        for j, length in enumerate(self.lengths * p["warm_rounds"]):
            self._request(f"warm{j}", 0, length)
        device.sync(dev)
        self.reqs = []

    def _length(self, i: int) -> int:
        n = len(self.lengths)
        order = random.Random(derive(self.seed, "prefill-order", i // n)).sample(self.lengths, n)
        return order[i % n]

    def _request(self, tag: str, i: int, length: int):
        """One request: returns (prompts, first tokens on the host, the last
        position's logits, seconds to the first token)."""
        prompts = self.sys.prompts(tag, i, self.batch, length)
        t0 = time.perf_counter()
        cache = self.sys.new_cache(self.batch)
        logits, cache = self.sys.prefill(prompts, cache, self.cd, self.flash)
        first = torch.argmax(logits, dim=-1).cpu()
        ttft = time.perf_counter() - t0
        return prompts, first, logits.clone(), ttft

    def window(self, seconds: float) -> dict:
        tokens = 0
        flops = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            i = len(self.reqs)
            length = self._length(i)
            prompts, first, logits, ttft = self._request("prefill", i, length)
            self.reqs.append({"len": length, "prompts": prompts, "first": first,
                              "logits": logits, "ttft": ttft})
            tokens += self.batch * length
            flops += counts.prefill_request(self.cell.config, self.sys.nnz, self.batch,
                                            length)["flops"]
        device.sync(self.dev)
        secs = time.perf_counter() - t0
        ttfts = [r["ttft"] for r in self.reqs]
        return {"attempted": len(self.reqs), "failed": 0,
                "e2e": {"prefill_tokens_per_s": tokens / secs,
                        "ttft_p95_ms": stats.percentile(ttfts, 95) * 1e3,
                        "ttft_p90_ms": stats.percentile(ttfts, 90) * 1e3},
                "layer": {"seconds": secs, "flops": flops}}

    def trace(self):
        t = self.cell.workload["trace"]
        lens = [self.lengths[j % len(self.lengths)] for j in range(t["units"])]
        warm = [min(self.lengths)] * t["warm_units"]

        def run(tag, ls):
            return lambda: [self._request(tag, j, n) for j, n in enumerate(ls)]

        summary = trace.profile_slice(run("trace-warm", warm), run("trace", lens), self.dev)
        work = [counts.prefill_request(self.cell.config, self.sys.nnz, self.batch, n)
                for n in lens]
        return summary, {"spmm": [i for w in work for i in w["spmm"]],
                         "flash": [i for w in work for i in w["flash"]]}

    def check(self) -> dict:
        self.sys.free()
        rng = random.Random(derive(self.seed, "prefill-check"))
        groups, served, logits = [], [], []
        for length in self.lengths:
            done = [r for r in self.reqs if r["len"] == length]
            if not done:
                return {"first_token_gap": float("inf"), "logit_row_err": float("inf")}
            pick = rng.sample(done, min(self.cell.workload["check"]["per_length"], len(done)))
            groups.append({"tokens": torch.cat([r["prompts"] for r in pick]),
                           "positions": [length - 1]})
            served.append(torch.cat([r["first"] for r in pick]))
            logits.append(torch.cat([r["logits"] for r in pick]))
        self.reqs = None
        ref = [r[:, 0] for r in self.sys.reference_logits(groups)]
        if self.rounding is not None:  # the control: the reference in the program's place
            logits = [r[:, 0] for r in self.sys.reference_logits(groups, self.rounding)]
            served = [lg.argmax(dim=-1) for lg in logits]
        return {"first_token_gap": max(checks.widest_token_gap(r, s)
                                       for r, s in zip(ref, served)),
                "logit_row_err": max(checks.worst_row_error(y, r)
                                     for y, r in zip(logits, ref))}
