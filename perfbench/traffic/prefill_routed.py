"""Traffic kind ``prefill_routed``: ``prefill_closed``'s protocol for a routed
(MoE) LM. One closed-loop client; each request is ``batch`` prompts of one
length, the lengths in seed-drawn cycles, tokens uniform over the
vocabulary; a request allocates its cache, runs ``lm_prefill`` and takes
the argmax of the last position's logits. The same end-to-end metrics and
the same check as ``prefill_closed`` (which this module's ``Traffic``
extends); what differs is how the work is counted.

The work is counted by the system's own counts module (``System.counts``:
attention over each layer's window, each token through its experts). For
the traced slice, ``trace`` also hands the per-layer readers:

- ``experts``: each layer's experts at the rows the router sent them in the
  slice. For the traced requests alone the program is asked to keep each
  grouped call's ``offsets`` (``moe_forward.routed_offsets``, device
  tensors, read after the slice); a slice that records no offsets for each
  layer of each request raises, since the routed cell runs nothing else;
- ``spans``: ``perfbench/lib/spans.py``'s ``reduce`` of the slice, taken by
  wrapping ``trace.summarize`` for this call alone, as ``spans.traced`` does.
"""

from __future__ import annotations

import time

from perfbench.lib import device, spans, spec, stats, trace

_closed = spec.load_module(spec.PKG / "traffic" / "prefill_closed.py", "traffic_prefill_closed")


class Traffic(_closed.Traffic):
    def window(self, seconds: float) -> dict:
        counts = self.sys.counts
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

    def _routed_requests(self, lens: list) -> tuple:
        """A function running the traced requests with the program keeping
        its grouped calls' ``offsets``, and the list they go to."""
        from smmb_tpu_torch.models import moe

        kept = []

        def run():
            moe.moe_forward.routed_offsets = kept
            try:
                for j, n in enumerate(lens):
                    self._request("trace", j, n)
            finally:
                moe.moe_forward.routed_offsets = None

        return run, kept

    def trace(self):
        counts = self.sys.counts
        t = self.cell.workload["trace"]
        lens = [self.lengths[j % len(self.lengths)] for j in range(t["units"])]
        warm = [min(self.lengths)] * t["warm_units"]
        run, offsets = self._routed_requests(lens)
        reduced = []
        summarize = trace.summarize

        def keep(events):
            reduced.append(spans.reduce(events, *spans.window(events)))
            return summarize(events)

        trace.summarize = keep
        try:
            summary = trace.profile_slice(
                lambda: [self._request("trace-warm", j, n) for j, n in enumerate(warm)],
                run, self.dev)
        finally:
            trace.summarize = summarize
        layers = self.sys.lm.n_layers
        rows = [(o[1:] - o[:-1]).tolist() for o in offsets]
        if len(rows) != layers * len(lens):
            raise RuntimeError(f"the traced slice recorded {len(rows)} routed calls, not "
                               f"{layers} layers x {len(lens)} requests")
        work = [counts.prefill_request(self.cell.config, self.sys.nnz, self.batch, n,
                                       routed=rows[j * layers:(j + 1) * layers])
                for j, n in enumerate(lens)]
        return summary, {"spmm": [i for w in work for i in w["spmm"]],
                         "flash": [i for w in work for i in w["flash"]],
                         "experts": [i for w in work for i in w["experts"]],
                         "spans": reduced[-1] if reduced else None}
