"""Traffic kind ``decode_static``: offline batch generation. Static batches
of ``batch`` prompts of ``prompt_len`` tokens (uniform over the
vocabulary); each batch allocates its cache (``cache_len`` long), runs
``lm_prefill``, then ``decode_steps`` greedy ``lm_decode_step`` calls, the
argmax kept on the card, before the next batch starts. Each batch yields
``decode_steps + 1`` tokens a row (the prefill's and each step's). The
window closes at the first step boundary past its length, mid-batch if so;
where no batch has ended by then, the last one runs on to its end (at most
``LATE_S`` past the close) for the check alone.

Reports ``gen_tokens_per_s`` (every output token over the window's time,
the prefills of new batches included). For the per-layer readers: the host
seconds of each ``lm_decode_step`` call (host clock around the call, no
synchronise) and the gaps between consecutive steps' completions on the
device (a CUDA event recorded after each step's argmax). The check: each
batch marks ``rows`` rows and ``steps`` steps drawn from the seed and keeps
those rows' logits at those steps; after the window ``sequences`` marked
rows of finished batches, drawn from the seed, are run through the
reference over prompt and served tokens, and every served token's gap and
every kept logit row is compared. Its control (``reference_<dtype>``)
reads, at each position of the same prompts and served tokens, the token
the reference rounded to that dtype puts first, and its logits. See
``mlp_batches.py`` for a traffic module's interface.
"""

from __future__ import annotations

import random
import time

import torch

from perfbench.counts import ternary_lm as counts
from perfbench.lib import checks, device, spec, trace
from perfbench.lib.seeds import derive

LATE_S = 60.0  # how long past the window's close the last batch may run on


class Traffic:
    def __init__(self, cell, seed: int, dev, control: str | None = None):
        p = cell.params
        self.cell, self.seed, self.dev = cell, seed, dev
        self.batch, self.plen, self.steps = p["batch"], p["prompt_len"], p["decode_steps"]
        if self.plen + self.steps > p["cache_len"]:
            raise ValueError("prompt_len + decode_steps exceeds cache_len")
        mod = spec.system_module(cell.config)
        self.sys = mod.System(cell.config, seed, dev, p["cache_len"])
        program_dtype, self.rounding = checks.control_parts(control)
        self.cd = device.DTYPES[program_dtype or p["compute_dtype"]]
        self.flash = p["use_flash"]
        state = self._start("warm", 0)
        for _ in range(p["warm_steps"]):
            state = self._step(state)
        device.sync(dev)
        self.batches = []

    def _start(self, tag: str, i: int) -> dict:
        prompts = self.sys.prompts(tag, i, self.batch, self.plen)
        cache = self.sys.new_cache(self.batch)
        logits, cache = self.sys.prefill(prompts, cache, self.cd, self.flash)
        tok = torch.argmax(logits, dim=-1)
        return {"prompts": prompts, "cache": cache, "tok": tok, "toks": [tok],
                "logits": logits, "step": 0}

    def _step(self, st: dict) -> dict:
        logits, st["cache"] = self.sys.decode(st["tok"], st["cache"], self.cd, self.flash)
        st["tok"] = torch.argmax(logits, dim=-1)
        st["toks"].append(st["tok"])
        st["logits"] = logits
        st["step"] += 1
        return st

    def window(self, seconds: float) -> dict:
        chk = self.cell.workload["check"]
        cfg, nnz = self.cell.config, self.sys.nnz
        host, gaps = [], []
        tokens = flops = 0
        cuda = self.dev.type == "cuda"
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            i = len(self.batches)
            rng = random.Random(derive(self.seed, "decode-mark", i))
            rows = sorted(rng.sample(range(self.batch), chk["rows"]))
            steps = set(rng.sample(range(self.steps + 1), chk["steps"]))
            sel = torch.tensor(rows, device=self.dev)
            st = self._start("decode", i)
            kept = {0: st["logits"][sel].clone()} if 0 in steps else {}
            st["logits"] = None  # a view of the prefill's logits at every position
            tokens += self.batch
            flops += counts.prefill_request(cfg, nnz, self.batch, self.plen)["flops"]
            events = []
            while st["step"] < self.steps and time.perf_counter() < deadline:
                a = time.perf_counter()
                logits, st["cache"] = self.sys.decode(st["tok"], st["cache"], self.cd, self.flash)
                host.append(time.perf_counter() - a)
                st["tok"] = torch.argmax(logits, dim=-1)
                st["toks"].append(st["tok"])
                st["step"] += 1
                if cuda:
                    events.append(torch.cuda.Event(enable_timing=True))
                    events[-1].record()
                if st["step"] in steps:
                    kept[st["step"]] = logits[sel].clone()
                tokens += self.batch
                flops += counts.decode_step(cfg, nnz, self.batch,
                                            self.plen + st["step"] - 1)["flops"]
            self.batches.append({"prompts": st["prompts"], "toks": st["toks"], "rows": rows,
                                 "kept": kept, "done": st["step"] == self.steps,
                                 "events": events})
        device.sync(self.dev)
        secs = time.perf_counter() - t0
        if self.batches and not any(b["done"] for b in self.batches):
            self._finish(st, steps, sel, time.perf_counter() + LATE_S)
        for b in self.batches:
            ev = b.pop("events")
            gaps += [ev[j].elapsed_time(ev[j + 1]) * 1e-3 for j in range(len(ev) - 1)]
        return {"attempted": self.batch * len(self.batches), "failed": 0,
                "e2e": {"gen_tokens_per_s": tokens / secs},
                "layer": {"seconds": secs, "flops": flops, "step_host_s": host,
                          "itl_s": gaps}}

    def _finish(self, st: dict, steps: set, sel, until: float) -> None:
        """After the window, run the last batch on to its end (no later than
        ``until``) when no batch ended inside the window: its answers are
        late, not wrong. Nothing here counts in the window's metrics."""
        b = self.batches[-1]
        while st["step"] < self.steps and time.perf_counter() < until:
            self._step(st)
            if st["step"] in steps:
                b["kept"][st["step"]] = st["logits"][sel].clone()
        b["done"] = st["step"] == self.steps

    def trace(self):
        t = self.cell.workload["trace"]
        st = {}

        def warm():
            st.update(self._start("trace", 0))
            for _ in range(t["warm_units"]):
                self._step(st)

        def work():
            for _ in range(t["units"]):
                self._step(st)

        summary = trace.profile_slice(warm, work, self.dev)
        first = self.plen + t["warm_units"]  # the first traced step's position
        cfg, nnz = self.cell.config, self.sys.nnz
        items = [i for s in range(t["units"])
                 for i in counts.decode_step(cfg, nnz, self.batch, first + s)["spmm"]]
        return summary, {"spmm": items, "flash": []}

    def check(self) -> dict:
        self.sys.free()
        chk = self.cell.workload["check"]
        marked = [(b, r) for b in self.batches if b["done"] for r in b["rows"]]
        if not marked:
            return {"token_gap": float("inf"), "logit_row_err": float("inf")}
        pick = random.Random(derive(self.seed, "decode-check")).sample(
            marked, min(chk["sequences"], len(marked)))
        seqs, served, ours, where = [], [], [], []
        for n, (b, r) in enumerate(pick):
            toks = torch.stack(b["toks"], dim=1)[r]  # (steps + 1,)
            seqs.append(torch.cat([b["prompts"][r], toks[:-1]]))
            served.append(toks)
            j = b["rows"].index(r)
            for s, lg in sorted(b["kept"].items()):
                ours.append(lg[j])
                where.append((n, s))
        self.batches = None
        group = [{"tokens": torch.stack(seqs),
                  "positions": list(range(self.plen - 1, self.plen + self.steps))}]
        ref = self.sys.reference_logits(group)[0]
        served = torch.stack(served)
        if self.rounding is not None:
            # the control: at each position of the same prompts and tokens,
            # the token the lower precision puts first, and its logits
            low = self.sys.reference_logits(group, self.rounding)[0]
            served = low.argmax(dim=-1)
            ours = [low[n, s] for n, s in where]
        gap = checks.widest_token_gap(ref.reshape(-1, ref.shape[-1]), served)
        err = checks.worst_row_error(torch.stack(ours), torch.stack([ref[n, s] for n, s in where]))
        return {"token_gap": gap, "logit_row_err": err}
