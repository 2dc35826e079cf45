"""B3's and B7's item body (smmb_tpu_torch.kernels.fused_mlp): the blocks
``qkv_items_kernel`` launches, B7's K/V span clusters, the shared memory of
a block against the routes' limits, and the constants of csrc/fused_mlp.cu.

The kernel runs only on the card (tests/test_torch_cuda.py holds it there);
these checks are of what surrounds it: the block lists are a function of
the shapes alone, cover every (eighth of K, column) of Wqkv exactly once,
never let an item straddle a K/V span, put each span in one cluster of
consecutive blocks, and lay the codes and scales out as the plain
quantize does.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from smmb_tpu_torch.formats.packed import pack_ternary
from smmb_tpu_torch.kernels import fused_mlp as tfk

torch.set_num_threads(2)

SRC = (Path(tfk.__file__).parent / "csrc" / "fused_mlp.cu").read_text()

# B3: (d, N) at the LM's widths, GQA, the tests' and the widest the gate admits
B3_SHAPES = [(1024, 3072), (1024, 1536), (512, 1536), (2048, 6144), (6656, 6656 + 2 * 1664)]
# B7: (d, KVH, hd): the LM's, GQA, heads of 2, 3, 4 and 5 clusters' worth of items
B7_SHAPES = [(1024, 8, 128), (1024, 2, 128), (1024, 4, 256), (512, 1, 384), (2048, 2, 512),
             (512, 2, 640), (5632, 8, 128)]


def _cover(n_cols, blocks):
    """How often each (eighth, column) is summed by the blocks' chunks."""
    seen = np.zeros((tfk.WARPS, n_cols), np.int64)
    for _, _, chunks in blocks:
        for c0, c1 in chunks:
            assert c1 - c0 == tfk.ITEM_COLS
            seen[:, c0:c1] += 1  # the block's 8 warps take the 8 eighths
    return seen


@pytest.mark.parametrize("d,n", B3_SHAPES)
def test_b3_blocks_cover_every_sum_once(d, n):
    blocks = tfk.qkv_blocks(d, n)
    assert len(blocks) == n // tfk.ITEM_COLS  # the .cu's grid: n / ITEM_COLS a row tile
    assert all(slot is None and rank == 0 and len(chunks) == 1 for slot, rank, chunks in blocks)
    assert [chunks[0][0] for _, _, chunks in blocks] == list(range(0, n, tfk.ITEM_COLS))
    assert np.all(_cover(n, blocks) == 1)


@pytest.mark.parametrize("d,kvh,hd", B7_SHAPES)
def test_b7_blocks_cover_every_sum_once(d, kvh, hd):
    n = d + 2 * kvh * hd
    blocks = tfk.qkv_blocks(d, n, kvh, hd)
    cs = tfk.span_cluster(hd)
    assert len(blocks) == d // tfk.ITEM_COLS + 2 * kvh * cs  # the .cu's grid
    assert np.all(_cover(n, blocks) == 1)
    # B7's q blocks are B3's over the first d columns, in the same order
    q = [b for b in blocks if b[0] is None]
    assert q == tfk.qkv_blocks(d, d)


@pytest.mark.parametrize("d,kvh,hd", B7_SHAPES)
def test_b7_spans_are_whole_clusters(d, kvh, hd):
    """A cluster is ``span_cluster(hd)`` consecutive blocks; the q blocks
    fill whole clusters, and each K/V cluster is one span: its blocks have
    the span's slot, ranks 0..c-1 in order, equal shares of its columns, and
    together every item of the span, none straddling its edge."""
    n = d + 2 * kvh * hd
    blocks = tfk.qkv_blocks(d, n, kvh, hd)
    cs = tfk.span_cluster(hd)
    assert cs <= tfk.MAX_CLUSTER and hd // tfk.ITEM_COLS % cs == 0
    assert len(blocks) % cs == 0 and (d // tfk.ITEM_COLS) % cs == 0
    for k in range(len(blocks) // cs):
        cluster = blocks[k * cs:(k + 1) * cs]
        slots = {slot for slot, _, _ in cluster}
        assert len(slots) == 1
        slot = slots.pop()
        if slot is None:
            continue
        assert [rank for _, rank, _ in cluster] == list(range(cs))
        span0 = d + (slot & 1) * kvh * hd + (slot >> 1) * hd
        cols = [c for _, _, chunks in cluster for c0, c1 in chunks for c in range(c0, c1)]
        assert cols == list(range(span0, span0 + hd))
        assert {len(chunks) for _, _, chunks in cluster} == {hd // cs // tfk.ITEM_COLS}
    assert sorted(b[0] for b in blocks if b[0] is not None) == sorted(
        s for s in range(2 * kvh) for _ in range(cs))


@pytest.mark.parametrize("d,kvh,hd", B7_SHAPES[:4])
def test_qkv_blocks_are_fixed_by_the_shapes(d, kvh, hd):
    """The lists take no M: the same call after call, and a row tile of M
    (1 row at M = 1, else 8) takes all of them."""
    n = d + 2 * kvh * hd
    assert tfk.qkv_blocks(d, n, kvh, hd) == tfk.qkv_blocks(d, n, kvh, hd)
    assert tfk.qkv_blocks(d, n) == tfk.qkv_blocks(d, n)
    assert [tfk.item_rows(m) for m in (1, 2, 5, 8, 9)] == [1, 8, 8, 8, 8]


@pytest.mark.parametrize("d,kvh,hd", [(1024, 8, 128), (1024, 4, 256), (512, 1, 384),
                                      (512, 2, 640)])
def test_b7_cluster_quantize_lays_out_the_plain_codes(d, kvh, hd):
    """The kernel's epilogue emulated block by block: each block's rows'
    absmax over its own columns, the maximum over its cluster, the scale
    and its codes written at slot·hd + rank·(hd/c) + column, the scale by
    rank 0 at slot. Bitwise ``quantize_heads`` on the same f32 y."""
    m = 3
    n = d + 2 * kvh * hd
    rs = np.random.default_rng(d + hd)
    y = torch.from_numpy(rs.standard_normal((m, n)).astype(np.float32))
    y[1, d:d + hd] = 0.0  # a zero span: scale 0, codes divided by 1
    codes = torch.full((m, 2 * kvh * hd), 99, dtype=torch.int8)
    scales = torch.full((m, 2 * kvh), -1.0)
    blocks = [b for b in tfk.qkv_blocks(d, n, kvh, hd) if b[0] is not None]
    cs = tfk.span_cluster(hd)
    own = hd // cs
    for k in range(0, len(blocks), cs):
        cluster = blocks[k:k + cs]
        cols = [[c for c0, c1 in chunks for c in range(c0, c1)] for _, _, chunks in cluster]
        amax = torch.stack([y[:, c].abs().amax(dim=1) for c in cols]).amax(dim=0)
        scale = amax / torch.full_like(amax, 127.0)
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        for (slot, rank, _), c in zip(cluster, cols):
            at = slot * hd + rank * own
            codes[:, at:at + own] = torch.round(y[:, c] / safe[:, None]).to(torch.int8)
            if rank == 0:
                scales[:, slot] = scale
    want_codes, want_scales = tfk.quantize_heads(y, d, kvh, hd)
    assert torch.equal(codes, want_codes) and torch.equal(scales, want_scales)


def test_the_routes_limits_imply_the_qkv_blocks():
    """``fits_shared`` and ``fits_shared_quant`` stay the routes' limits:
    every width they admit fits B3's and B7's block, at 1 row and at 8."""
    widths = range(512, 16385, 512)
    admitted = [d for d in widths if tfk.fits_shared(d)]
    assert admitted[-1] == 6656
    for d in admitted:
        for m in (1, 8):
            assert tfk.qkv_shared_bytes(d, m) <= tfk.MAX_SHARED_BYTES
    n_quant = 0
    for d in widths:
        for hd in range(128, 2049, 128):
            if tfk.fits_shared_quant(d, hd):
                n_quant += 1
                for m in (1, 8):
                    assert tfk.qkv_shared_bytes(d, m, hd) <= tfk.MAX_SHARED_BYTES, (d, hd, m)
    assert n_quant > 0 and tfk.fits_shared_quant(5632, 128)
    assert not tfk.fits_shared(7168)


def test_qkv_constants_match_the_source():
    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", SRC)[1]

    assert int(const("MAX_CLUSTER")) == tfk.MAX_CLUSTER == 8
    assert const("HEAD_COLS") == "4 * ITEM_COLS" and tfk.HEAD_COLS == 4 * tfk.ITEM_COLS
    assert ("return hd / ITEM_COLS % MAX_CLUSTER == 0 ? MAX_CLUSTER : MAX_CLUSTER / 2;"
            in SRC)
    assert [tfk.span_cluster(hd) for hd in (128, 256, 384, 512, 640, 1024)] == [4, 8, 4, 8, 4, 8]
    assert ("hd ? static_cast<size_t>(MT) * (hd / span_cluster(hd) + 1 + span_cluster(hd)) : 0;"
            in SRC)
    assert "return items_smem_bytes<MT>(d) + sizeof(float) * quant;" in SRC
    # the grid the launcher gives: the blocks of qkv_blocks a row tile
    assert ("cfg.gridDim = dim3(QUANT ? a.d / ITEM_COLS + 2 * a.kvh * cs : a.n / ITEM_COLS,"
            in SRC)
    assert tfk.qkv_shared_bytes(1024, 1) == tfk.items_shared_bytes(1024, 1)
    assert tfk.qkv_shared_bytes(1024, 8, 128) == tfk.items_shared_bytes(1024) + 4 * 8 * (32 + 1 + 4)
    assert tfk.qkv_shared_bytes(1024, 1, 512) == tfk.items_shared_bytes(1024, 1) + 4 * (64 + 1 + 8)
    # the first kernels and their helpers are gone
    for name in ("norm_qkv_kernel", "norm_qkv_quant_kernel", "block_dot", "packed_dot",
                 "load_word", "warp_sum", "quant_smem_bytes", "TILE_N"):
        assert not re.search(rf"\b{name}\b", SRC), name


def test_items_words_aligns_and_keeps_the_plane():
    """The wrapper's plane for the 16-byte copies: a misaligned view is
    copied to an aligned address, a width of 16-byte multiples (every B3
    and B7 N) is not padded, and the values are the plane's."""
    rs = np.random.default_rng(3)
    w = rs.choice(np.array([-1.0, 0.0, 1.0], np.float32), (1024, 3072 + 16))
    p = pack_ternary(w, device="cpu")
    view = p.data[:, 1:3073]
    assert view.data_ptr() % 16 != 0
    got = tfk._items_words(type(p)(data=view, rows=p.rows, cols=3072, nnz=-1),
                           torch.device("cpu"))
    assert got.data_ptr() % 16 == 0 and got.shape == view.shape and torch.equal(got, view)
    ragged = tfk._items_words(pack_ternary(w[:, :1000], device="cpu"), torch.device("cpu"))
    assert ragged.shape[1] == 1008 and bool((ragged[:, 1000:] == 0).all())
