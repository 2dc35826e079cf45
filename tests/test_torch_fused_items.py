"""B5's and B6's one-launch design (smmb_tpu_torch.kernels.fused_mlp): the
work items the cooperative kernel walks, the workspaces the wrapper gives
it, the constants of csrc/fused_mlp.cu, and the routing gates that send the
model's calls to it.

The kernel runs only on the card (tests/test_torch_cuda.py holds it there);
these checks are of what surrounds it: the item lists are a function of the
shapes alone, cover every (eighth of K, column) of each product and every
(hidden tile, column) of the down product exactly once, and do not change
with M; the workspaces are exactly what the items write; the gates answer
as the formula they had before the kernel changed.
"""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from smmb_tpu_torch.kernels import fused_mlp as tfk
from smmb_tpu_torch.models import transformer as ttb

torch.set_num_threads(2)

# (h, kout, a): B6 (a None) and B5 (kout = D) at the LM's widths, the
# tests', a ragged B6 output and the widest rows the gates admit
SHAPES = [
    (4096, 1024, None), (4096, 1024, 1024), (1536, 512, 512), (2048, 512, None),
    (8192, 2048, 2048), (1024, 1000, None), (512, 6656, 6656), (1024, 3072, 512),
]


def _cover(n_cols, chunks):
    """How often each (eighth, column) is summed by the product chunks."""
    seen = np.zeros((tfk.WARPS, n_cols), np.int64)
    for c0, c1 in chunks:
        assert c1 - c0 == tfk.ITEM_COLS
        seen[:, c0:c1] += 1  # the block's 8 warps take the 8 eighths
    return seen


@pytest.mark.parametrize("h,kout,a", SHAPES)
def test_items_cover_every_sum_once(h, kout, a):
    items = tfk.work_items(h, kout, a)
    assert np.all(_cover(h, items["up"]) == 1)
    if a is None:
        assert items["wo"] == []
    else:
        assert np.all(_cover(kout, items["wo"]) == 1)
    down = np.zeros((h // tfk.HIDDEN_TILE, kout), np.int64)
    for t, c0, c1 in items["down"]:
        assert 0 < c1 - c0 <= tfk.DOWN_COLS
        down[t, c0:c1] += 1
    assert np.all(down == 1)
    total = np.zeros(kout, np.int64)
    for c0, c1 in items["sum"]:
        assert 0 < c1 - c0 <= tfk.SUM_COLS
        total[c0:c1] += 1
    assert np.all(total == 1)


@pytest.mark.parametrize("h,kout,a", SHAPES)
def test_items_are_fixed_by_the_shapes(h, kout, a):
    """M multiplies the row tile's list and the grid cap; the list itself is
    the same call after call, whatever M."""
    items = tfk.work_items(h, kout, a)
    assert tfk.work_items(h, kout, a) == items
    most = max(len(v) for v in items.values())
    for m in (1, 2, 8, 9, 32, 33):
        assert tfk.most_items(m, h, kout, a) == -(-m // tfk.item_rows(m)) * most
    assert [tfk.item_rows(m) for m in (1, 2, 32)] == [1, 8, 8]


@pytest.mark.parametrize("k", [512, 1024, 2048, 6656])
def test_eighths_split_k_in_whole_pieces(k):
    """The 8 warps' packed rows tile [0, K/4) in order, each a whole number
    of cp.async pieces, so no 4-row step of a piece straddles a group."""
    e = tfk.eighths(k)
    assert e[0][0] == 0 and e[-1][1] == k // 4
    assert all(p1 == q0 for (_, p1), (q0, _) in zip(e, e[1:]))
    assert all((p1 - p0) % tfk.PIECE_ROWS == 0 and p1 > p0 for p0, p1 in e)


@pytest.mark.parametrize("h,kout,a", SHAPES)
@pytest.mark.parametrize("m", [1, 5, 32])
def test_workspaces_are_what_the_items_write(m, h, kout, a):
    shapes = tfk.workspace_shapes(m, h, kout, a is not None)
    items = tfk.work_items(h, kout, a)
    up = np.zeros(shapes["up"], np.int64)
    for c0, c1 in items["up"]:
        up[:, c0:c1] += 1
    assert np.all(up == 1)
    ws = np.zeros(shapes["ws"], np.int64)
    for t, c0, c1 in items["down"]:
        ws[t, :, c0:c1] += 1
    assert np.all(ws == 1)
    if a is None:
        assert "resid" not in shapes
    else:
        resid = np.zeros(shapes["resid"], np.int64)
        for c0, c1 in items["wo"]:
            resid[:, c0:c1] += 1
        assert np.all(resid == 1)


@pytest.mark.parametrize("h,kout,a", SHAPES)
def test_one_workspace_buffer_holds_them_all_aligned(h, kout, a):
    """The wrapper allocates one f32 buffer for the call's workspaces: each
    starts 16-byte aligned (the kernel reads them 16 bytes at a time) and
    together they fill it."""
    for m in (1, 3, 32):
        shapes = tfk.workspace_shapes(m, h, kout, a is not None)
        buf, ptrs = tfk._workspace(m, h, kout, a is not None, torch.device("cpu"))
        assert buf.dtype == torch.float32
        assert buf.numel() == sum(int(np.prod(s)) for s in shapes.values())
        assert set(ptrs) == set(shapes)
        assert all((p - buf.data_ptr()) % 16 == 0 for p in ptrs.values())
        ends = sorted((p, p + 4 * int(np.prod(shapes[n]))) for n, p in ptrs.items())
        assert ends[0][0] == buf.data_ptr() and ends[-1][1] == buf.data_ptr() + 4 * buf.numel()
        assert all(e0[1] == e1[0] for e0, e1 in zip(ends, ends[1:]))


def test_kernel_constants_match_the_wrapper():
    src = (Path(tfk.__file__).parent / "csrc" / "fused_mlp.cu").read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src)[1]

    assert const("THREADS") == "256" and const("WARPS") == "THREADS / 32"
    assert 256 // 32 == tfk.WARPS
    # B3's and B7's 128-column tile went with their first kernels; a head
    # width is a multiple of 4 items, a K/V span a cluster of at most 8
    assert const("HEAD_COLS") == "4 * ITEM_COLS" and tfk.HEAD_COLS == 128
    assert int(const("MAX_CLUSTER")) == tfk.MAX_CLUSTER == 8
    assert const("HT") == "4 * HT_PACKED" and 4 * int(const("HT_PACKED")) == tfk.HIDDEN_TILE
    assert int(const("ITEM_COLS")) == tfk.ITEM_COLS
    assert int(const("PIECE_ROWS")) == tfk.PIECE_ROWS
    assert int(const("RING")) == tfk.RING
    assert const("DOWN_COLS") == "THREADS" and tfk.DOWN_COLS == 256
    # a sum item: the 8 warps a row each of a row tile, a lane a column
    assert int(const("SUM_COLS")) == tfk.SUM_COLS == 32 and tfk.ROWS_PER_BLOCK == tfk.WARPS
    assert const("PIECE_BYTES") == "PIECE_ROWS * ITEM_COLS"
    assert const("RING_BYTES") == "WARPS * RING * PIECE_BYTES"
    assert int(const("MAX_SMEM")) == tfk.MAX_SHARED_BYTES
    # a lane copies 16 bytes of a piece: two lanes a packed row
    assert tfk.PIECE_ROWS * tfk.ITEM_COLS == 32 * 16
    assert "sizeof(float) * (static_cast<size_t>(MT) * kmax + MT + WARPS * MT) + RING_BYTES" in src
    assert tfk.items_shared_bytes(1024) == 4 * (8 * 1024 + 8 + 64) + 8 * 4 * 512
    assert tfk.items_shared_bytes(1024, m=1) == 4 * (1024 + 1 + 8) + 8 * 4 * 512


def test_the_routes_limit_implies_the_blocks():
    """``fits_shared`` stays the routes' limit; every width it admits fits
    the one-launch block, at 8 rows and at 1 (B5 stages the larger of A and
    D)."""
    widths = range(512, 16385, 512)
    admitted = [k for k in widths if tfk.fits_shared(k)]
    assert admitted[-1] == 6656
    for k in admitted:
        assert tfk.fits_shared_items(k) and tfk.fits_shared_items(k, m=1)
    assert not tfk.fits_shared_items(7168)


def _parent_fits(k):
    # the route's formula: (8, max(K, 1024)) f32 rows, an (8, 128) tile and
    # the norm's 72 floats within a Hopper block's 232448 bytes
    return 4 * (max(8 * k, 8 * 8 * 128) + 8 * 128 + 8 + 64) <= 232448


def _slab(h, cap):
    return any(h % bh == 0 for bh in range(512, min(cap, h) + 1, 512))


def _plane(rows, cols):
    return SimpleNamespace(shape=(rows, cols))


WIDTHS = list(range(512, 8193, 512)) + [1000]
HIDDEN = [256, 512, 1536, 4096, 8192]


def test_tail_gate_answers_as_before():
    n = 0
    for a in WIDTHS:
        for dm in WIDTHS:
            for h in HIDDEN:
                packed = {"attn": {"wo": _plane(a, dm)}, "w_up": _plane(dm, h),
                          "w_down": _plane(h, dm)}
                for m in (1, 32, 33):
                    for cdt in (torch.float32, torch.bfloat16, torch.int8):
                        want = (m <= 32 and cdt != torch.int8 and a % 512 == 0
                                and _parent_fits(a) and dm % 512 == 0 and _parent_fits(dm)
                                and _slab(h, 2048))
                        assert ttb._tail_fusable(packed, m, cdt, True) == want, (a, dm, h, m)
                        n += want
                        if want:
                            assert tfk.fits_shared_items(max(a, dm), m)
                assert not ttb._tail_fusable(packed, 1, torch.bfloat16, False)
                lora = {**packed, "w_down_lora": (1, 2)}
                assert not ttb._tail_fusable(lora, 1, torch.bfloat16, True)
    assert n > 0


def test_mlp_gate_answers_as_before():
    n = 0
    for k in WIDTHS:
        for h in HIDDEN:
            for kout in (k, k + 512):
                packed = {"w_up": _plane(k, h), "w_down": _plane(h, kout)}
                for m in (1, 32, 33):
                    for cdt in (torch.float32, torch.bfloat16, torch.int8):
                        want = (m <= 32 and cdt != torch.int8 and k % 512 == 0
                                and _parent_fits(k) and _slab(h, 1024) and kout == k)
                        got = ttb._mlp_fusable(packed, torch.zeros(m, k), cdt, True)
                        assert got == want, (k, h, kout, m, cdt)
                        n += want
                        if want:
                            assert tfk.fits_shared_items(k, m)
    assert n > 0
