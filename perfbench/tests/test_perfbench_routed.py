"""The routed LM's cell (``mellum2.code-prefill``) at its tiny copy on the
CPU: the faults it can have must make ``correct`` false; its counts against
hand counts; its two new readers on a slice made by hand."""

from __future__ import annotations

import dataclasses
import io
import json
import types
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from perfbench_tiny_cells import write_root
from perfbench_tiny_routed import tiny_routed_config

from perfbench import run
from perfbench.counts import ops
from perfbench.counts import ternary_moe_lm as counts
from perfbench.lib import spec
from smmb_tpu_torch.models import moe

CELL = "tiny.routed"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    base = tmp_path_factory.mktemp("tiny-routed")
    return base, write_root(base)


def _run(root, argv_extra=()):
    base, manifest = root
    with redirect_stdout(io.StringIO()) as out, redirect_stderr(io.StringIO()):
        rc = run.main(["--workload", CELL, "--seed", "2147483659", "--seconds", "1",
                       *argv_extra], allow_cpu=True, manifest=manifest, data_root=base)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_sound_run_is_correct(root):
    res = _run(root)
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"prefill_tokens_per_s", "ttft_p90_ms", "setup_s"}


def _expert_dropped(fn):
    """Expert 0's rows of every routed half come back as zeros."""
    def f(x, w, b, offsets, *a, **k):
        y = fn(x, w, b, offsets, *a, **k).clone()
        y[int(offsets[0]):int(offsets[1])] = 0
        return y
    return f


def test_dropped_expert_is_not_correct(root, monkeypatch):
    monkeypatch.setattr(moe, "grouped_spmm", _expert_dropped(moe.grouped_spmm))
    monkeypatch.setattr(moe, "grouped_spmm_plain", _expert_dropped(moe.grouped_spmm_plain))
    res = _run(root)
    assert res["correct"] is False, res["checks"]


def test_full_layer_run_windowed_is_not_correct(root, monkeypatch):
    """Every layer served at the sliding window, the full ones too."""
    base, manifest = root
    cls = spec.system_module(spec.load_cell(CELL, manifest, base).config).System
    init = cls.__init__

    def windowed(self, *a, **k):
        init(self, *a, **k)
        wins = tuple(w or 8 for w in self.lm.layer_windows)
        self.lm = dataclasses.replace(self.lm, layer_windows=wins)

    monkeypatch.setattr(cls, "__init__", windowed)
    res = _run(root)
    assert res["correct"] is False, res["checks"]


def test_attended_pairs_by_hand():
    # t = 5, window 3: positions attend 1, 2, 3, 3, 3 keys
    assert counts.attended_pairs(5, 3) == 12
    assert counts.attended_pairs(5, None) == 15 == counts.attended_pairs(5, 8)


def test_prefill_counts_by_hand():
    cfg = tiny_routed_config()
    dm = counts.dims(cfg)
    assert dm["windows"] == [8, 8, 8, None] and dm["head_dim"] == 32
    nnz = {"wq": 100, "wk": 40, "wv": 40, "wo": 100, "head": 500,
           "w_up": [[10] * 16] * 4, "w_down": [[20] * 16] * 4}
    routed = [[2] * 8 + [0] * 8] * 4  # 16 rows a layer: 2 tokens x top-4 x 2
    work = counts.prefill_request(cfg, nnz, 2, 2, routed=routed)
    # attention: 4 tokens (b 2, t 2); q 128 wide, k and v 64, o back to 64
    assert [i.ops for i in work["spmm"][:4]] == [2 * 4 * 100 + 4 * 4 * 128,
                                                 2 * 4 * 40 + 4 * 4 * 64,
                                                 2 * 4 * 40 + 4 * 4 * 64,
                                                 2 * 4 * 100 + 4 * 4 * 64]
    assert work["spmm"][4].ops == 2 * 2 * 500 + 2 * 512  # the head at 2 last positions
    # t = 2 under a window of 8: 3 pairs a head, 3 windowed layers and 1 full
    assert [i.ops for i in work["flash"]] == [3 * 4 * 2 * 4 * 32 * 3, 4 * 2 * 4 * 32 * 3]
    # experts: 8 hit a layer, 2 rows each, up (64 -> 32) and down (32 -> 64)
    ups = [i for i in work["experts"] if i.ops == 2 * 2 * 10 + 2 * 32]
    downs = [i for i in work["experts"] if i.ops == 2 * 2 * 20 + 2 * 64]
    assert len(ups) == len(downs) == 32 and len(work["experts"]) == 64
    assert ups[0].bytes == 2 * 64 * 2 + 64 * 32 // 4 + 2 * 32 * 2 + 4 * 32
    even = counts.prefill_request(cfg, nnz, 2, 2)
    assert sum(i.ops for i in even["experts"]) == sum(i.ops for i in work["experts"])


def test_expert_roofline_and_route_share_readers():
    peaks = ops.peaks_for("NVIDIA H100 80GB HBM3")
    item = ops.Item(989e12 * 1e-3, 1.0)  # bound: 1 ms of operations
    summary = types.SimpleNamespace(seconds_matching=lambda pats: 4e-3 * (
        "expert_spmm_grouped" in pats))
    ctx = types.SimpleNamespace(trace=summary, peaks=peaks,
                                slice_work={"experts": [item, item]})
    assert spec.metric_reader("expert_roofline.mellum")(ctx) == pytest.approx(50.0)
    ctx.slice_work = {"experts": []}
    assert spec.metric_reader("expert_roofline.mellum")(ctx) is None
    rows = {"lm.prefill": {"device_s": 2.0}, "moe.route": {"device_s": 0.1},
            "moe.dispatch": {"device_s": 0.2}, "moe.combine": {"device_s": 0.1},
            "kernel.B1g": {"device_s": 1.0}}
    ctx.slice_work = {"spans": {"rows": rows}}
    assert spec.metric_reader("route_share.mellum")(ctx) == pytest.approx(20.0)
    ctx.slice_work = {"spans": None}
    assert spec.metric_reader("route_share.mellum")(ctx) is None


def test_b1g_kernel_is_not_a_ternary_projection():
    assert "expert_spmm_grouped" in ops.kernel_group("routed_experts")
    assert not any(p in "expert_spmm_grouped" for p in ops.kernel_group("ternary_projections"))


def test_reference_windows_the_sliding_layers():
    """The reference's attention: a window of 3 keys against the full
    causal mask, on the same q, k, v."""
    from perfbench.reference.ternary_moe_lm import windowed_attention

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 7, 2, 4, generator=g) for _ in range(3))
    full = windowed_attention(q, k, v, None, q_block=3)
    win = windowed_attention(q, k, v, 3, q_block=3)
    assert torch.allclose(full[:, :3], win[:, :3])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / 2.0
    live = torch.ones(7, 7, dtype=torch.bool).tril() & ~torch.ones(7, 7, dtype=torch.bool).tril(-3)
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s.masked_fill(~live, -float("inf")), -1),
                        v).reshape(1, 7, 8)
    assert torch.allclose(win, want, atol=1e-6)


def _traffic(root):
    base, manifest = root
    cell = spec.load_cell(CELL, manifest, base)
    return spec.traffic_module(cell).Traffic(cell, 2147483659, torch.device("cpu"))


def test_trace_reads_the_routing_the_program_records(root, monkeypatch):
    """The traced slice's expert items come from the offsets the program
    keeps for it: one (E + 1,) tensor a layer a request, every token's
    top-k rows in each."""
    traffic = _traffic(root)
    routed = traffic._routed_requests
    seen = {}

    def keep(lens):
        run, kept = routed(lens)
        seen.update(lens=lens, kept=kept)
        return run, kept

    monkeypatch.setattr(traffic, "_routed_requests", keep)
    _, work = traffic.trace()
    assert moe.moe_forward.routed_offsets is None  # the program's hook is off again
    cfg = tiny_routed_config()
    layers, e, k = cfg["num_hidden_layers"], cfg["num_experts"], cfg["num_experts_per_tok"]
    kept = seen["kept"]
    assert len(kept) == layers * len(seen["lens"])
    for j, n in enumerate(seen["lens"]):
        for o in kept[j * layers:(j + 1) * layers]:
            assert o.shape == (e + 1,) and int(o[-1]) == traffic.batch * n * k
    hit = sum(int((o[1:] > o[:-1]).sum()) for o in kept)
    assert len(work["experts"]) == 2 * hit  # up and down for each expert hit


def test_trace_without_recorded_routing_raises(root, monkeypatch):
    """A program that keeps no offsets (its hook renamed, say) fails the
    traced run rather than leaving the expert metrics silently empty."""
    traffic = _traffic(root)
    grouped = moe._grouped_forward

    def unrecorded(*args, **kwargs):
        kept, moe.moe_forward.routed_offsets = moe.moe_forward.routed_offsets, None
        try:
            return grouped(*args, **kwargs)
        finally:
            moe.moe_forward.routed_offsets = kept

    monkeypatch.setattr(moe, "_grouped_forward", unrecorded)
    with pytest.raises(RuntimeError, match="routed calls"):
        traffic.trace()
