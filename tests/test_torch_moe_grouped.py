"""The grouped experts of MoE serving (``moe_forward(no_drop=True)`` in
bf16) against the per-expert slab path it replaced, and B1g's plain version
against B1's.

The grouped path moves each assignment's row to ``offsets[e] + slot`` of an
N·k-row buffer and runs the experts there; every row's arithmetic is the
slab path's, so the outputs agree bit for bit. On the CPU both run the
library's f32 product, which gives a row the same bits at any M ≥ 2 at these
widths (K ≤ 512), so the comparison is exact here as on the card. The f32
and W2A8 modes keep the slab path, on the CPU as on the card.
"""

import pytest
import torch

from smmb_tpu_torch.formats.packed import TernaryPacked
from smmb_tpu_torch.kernels.packed_spmm import (grouped_spmm, grouped_spmm_plain,
                                                 packed_spmm_plain)
from smmb_tpu_torch.models import moe as tm

torch.set_num_threads(2)


def _moe(e, k, d=48, f=64, seed=1):
    cfg = tm.TernaryMoEConfig(d_model=d, d_ff=f, n_experts=e, top_k=k)
    masters = tm.init_moe(torch.Generator().manual_seed(seed), cfg)
    return cfg, tm.pack_moe(masters, quantize=True)


def _slab(packed, x, cfg, compute_dtype):
    """Today's serving path: the (E, C, D) slabs at C = N rounded up to 8."""
    cap = tm._round8(x.shape[0])
    expert, slot, keep, weight = tm._assign(tm.router_logits(x, packed["router"]), cap,
                                            cfg.top_k)
    return tm._slab_forward(packed, x, cfg, expert, slot, keep, weight, cap, compute_dtype,
                            True)


@pytest.mark.parametrize("e,k", [(8, 1), (8, 2), (64, 8), (8, 8), (64, 1)],
                         ids=["e8-top1", "e8-top2", "e64-top8", "e8-top8", "e64-top1"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 13, 70])
def test_grouped_equals_slab_bitwise(e, k, x_dtype, n):
    """An f32 or a bf16 stream, served in bf16: two B1g calls, the slab
    path's output bit for bit."""
    cfg, packed = _moe(e, k)
    x = torch.randn(n, cfg.d_model, generator=torch.Generator().manual_seed(n + e))
    x = x.to(x_dtype)
    seen = tm.moe_forward.routed_offsets = []
    try:
        got = tm.moe_forward(packed, x, cfg, compute_dtype=torch.bfloat16, no_drop=True)
    finally:
        tm.moe_forward.routed_offsets = None
    want = _slab(packed, x, cfg, torch.bfloat16)
    assert len(seen) == 1 and int(seen[0][-1]) == n * k  # the grouped path ran
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)


def test_grouped_plain_route_equals_slab_plain():
    cfg, packed = _moe(16, 4)
    x = torch.randn(29, cfg.d_model, generator=torch.Generator().manual_seed(3))
    bf16 = torch.bfloat16
    got = tm.moe_forward(packed, x, cfg, compute_dtype=bf16, no_drop=True, use_kernel=False)
    cap = tm._round8(29)
    expert, slot, keep, weight = tm._assign(tm.router_logits(x, packed["router"]), cap, 4)
    want = tm._slab_forward(packed, x, cfg, expert, slot, keep, weight, cap, bf16, False)
    assert torch.equal(got, want)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.int8], ids=["f32", "int8"])
def test_other_modes_serve_on_the_slabs(compute_dtype, monkeypatch):
    """f32 and W2A8 serving keep the per-expert slab loop on the CPU, as on
    the card: B1g is never called and no offsets are recorded."""
    def refuse(*args, **kwargs):
        raise AssertionError("B1g called outside bf16")

    monkeypatch.setattr(tm, "grouped_spmm", refuse)
    monkeypatch.setattr(tm, "grouped_spmm_plain", refuse)
    monkeypatch.setattr(tm.moe_forward, "routed_offsets", [])
    cfg, packed = _moe(8, 2)
    x = torch.randn(11, cfg.d_model, generator=torch.Generator().manual_seed(6))
    got = tm.moe_forward(packed, x, cfg, compute_dtype=compute_dtype, no_drop=True)
    assert tm.moe_forward.routed_offsets == []
    assert torch.equal(got, _slab(packed, x, cfg, compute_dtype))


def test_grouped_layout_sorts_rows_by_expert():
    """Row ``offsets[e] + slot`` of each assignment: a permutation of the
    N·k rows, expert e's rows contiguous, in slot (rank-major) order; an
    expert with no rows has an empty segment."""
    cfg, packed = _moe(64, 8)
    x = torch.randn(5, cfg.d_model, generator=torch.Generator().manual_seed(4))
    expert, slot, _, _ = tm._assign(tm.router_logits(x, packed["router"]), 8, 8)
    row, offsets, token, row_expert = tm.grouped_layout(expert, slot, 64)
    assert sorted(row.reshape(-1).tolist()) == list(range(40))
    assert offsets[0] == 0 and offsets[-1] == 40
    counts = offsets[1:] - offsets[:-1]
    assert int((counts == 0).sum()) > 0  # 40 rows over 64 experts: some are empty
    assert torch.equal(row_expert, torch.repeat_interleave(torch.arange(64), counts))
    assert torch.equal(token[row], torch.arange(5)[:, None].expand(5, 8))


@pytest.mark.parametrize("x_dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)], ids=["f32", "bf16", "bf16-to-f32"])
@pytest.mark.parametrize("alpha", [None, 0.2], ids=["linear", "prelu"])
def test_b1g_plain_equals_b1_on_each_expert(x_dtype, out_dtype, alpha):
    """Each expert's rows of one B1g call are B1's plain bf16 call on those
    rows and that expert's plane (segments of 0 rows included; segments of
    two rows or more, since a 1-row product takes the library's vector
    path)."""
    _, packed = _moe(6, 2, d=96, f=80)
    sizes = [3, 0, 17, 2, 0, 9]
    offsets = torch.tensor([0] + sizes).cumsum(0)
    x = torch.randn(sum(sizes), 96, generator=torch.Generator().manual_seed(5)).to(x_dtype)
    y = grouped_spmm(x, packed["w_up"], packed["b_up"], offsets, alpha, out_dtype=out_dtype)
    assert y.shape == (sum(sizes), 80) and y.dtype == out_dtype
    for e, (lo, hi) in enumerate(zip(offsets[:-1].tolist(), offsets[1:].tolist())):
        if hi == lo:
            continue
        plane = TernaryPacked(data=packed["w_up"].data[e], rows=96, cols=80,
                              nnz=packed["w_up"].nnz)
        want = packed_spmm_plain(x[lo:hi].to(out_dtype), plane, packed["b_up"][e], alpha,
                                 compute_dtype=torch.bfloat16)
        assert torch.equal(y[lo:hi], want), e


def test_b1g_checks_its_arguments():
    _, packed = _moe(4, 1)
    x = torch.randn(6, 48)
    with pytest.raises(ValueError, match="offsets"):
        grouped_spmm(x, packed["w_up"], packed["b_up"], torch.tensor([0, 6]))
    with pytest.raises(ValueError, match="stacked planes"):
        grouped_spmm(x[:, :40], packed["w_up"], packed["b_up"],
                     torch.tensor([0, 1, 2, 3, 6]))
    for mode in (torch.float32, torch.int8):  # B1g's one mode is bf16, here as on the card
        with pytest.raises(TypeError, match="bfloat16"):
            grouped_spmm(x, packed["w_up"], packed["b_up"], torch.tensor([0, 1, 2, 3, 6]),
                         compute_dtype=mode)
        with pytest.raises(TypeError, match="bfloat16"):
            grouped_spmm_plain(x, packed["w_up"], packed["b_up"],
                               torch.tensor([0, 1, 2, 3, 6]), compute_dtype=mode)
