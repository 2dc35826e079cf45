"""B2's tensor-core body (smmb_tpu_torch.kernels.bcsr_spmm): the exact split
of f32 X into three bf16 pieces, the product that split gives when summed as
the kernel sums it, the route and tile the wrapper picks, the constants of
csrc/bcsr_spmm.cu, and the roofline key of f32 X times a ternary W.

The kernel runs only on the card (tests/test_torch_cuda.py holds it there);
these checks are of its arithmetic and of what surrounds it. The emulated
product sums each block's hi pass and its mid + lo passes exactly (the
tensor core's truncation has nothing to cut in the hi pass of |x| ≥ 2^-9,
and the mid + lo pass is ~2^-8 of the sum), rounds each to f32 and adds it
into the running f32 sums, block by block in the prepared order, hi then
mid + lo, as the kernel does; it is held within TOL_DENSE (1e-4 absolute,
the showcase's row tolerance) of JAX's Pallas kernel in interpret mode at a
128×128-block shape of the showcase's kind (|Y| up to ~50 at K = 1024).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smmb_tpu.formats.bcsr import bcsr_from_dense as jbcsr_from_dense
from smmb_tpu.kernels import bcsr_spmm as jk
from smmb_tpu_torch.bench import roofline as troofline
from smmb_tpu_torch.formats.bcsr import bcsr_from_dense
from smmb_tpu_torch.kernels import bcsr_spmm as tk
from smmb_tpu_torch.utils.compare import TOL_DENSE, assert_close

torch.set_num_threads(2)
ALPHA = 0.2
CPU = "cpu"
SRC = (Path(tk.__file__).parent / "csrc" / "bcsr_spmm.cu").read_text()
WAVE = tk.NUM_SMS * 3 // 4  # 99 blocks: 3/4 of the card's 132 SMs


def _edges() -> np.ndarray:
    """Powers of two over the exact range, one ulp either side of each,
    their negatives, zero, and values at the stated lower end 2^-103."""
    p = np.ldexp(np.float32(1), np.arange(-103, 128)).astype(np.float32)
    up = np.nextafter(p, np.float32(np.inf))
    down = np.nextafter(p, np.float32(0))[1:]  # below 2^-103 leaves the range
    low = np.ldexp(np.float32(1) + np.arange(0, 64, dtype=np.float32) * 2.0 ** -23,
                   -103).astype(np.float32)
    ones = (np.float32(1) + np.arange(1, 1 << 12, dtype=np.float32) * 2.0 ** -23)
    v = np.concatenate([p, up, down, low, ones.astype(np.float32), [0.0]]).astype(np.float32)
    return np.concatenate([v, -v])


def _values(kind: str) -> np.ndarray:
    rs = np.random.default_rng(17)
    if kind == "uniform":
        return rs.uniform(-1, 1, 1 << 16).astype(np.float32)
    if kind == "normal":
        return (rs.standard_normal(1 << 16) * np.exp2(rs.integers(-80, 90, 1 << 16))
                ).astype(np.float32)
    return _edges()


@pytest.mark.parametrize("kind", ["uniform", "normal", "edges"])
def test_split_bf16x3_is_exact(kind):
    x = torch.from_numpy(_values(kind))
    hi, mid, lo = tk.split_bf16x3(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, x.to(torch.bfloat16))  # round to nearest even
    # exact: the f64 sum, and the f32 sum hi + mid first, are x (bitwise but
    # for the sign of zero: -0 splits into -0, +0, +0)
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, x.double())
    f32 = (hi.float() + mid.float()) + lo.float()
    nz = x != 0
    assert torch.equal(f32[nz].view(torch.int32), x[nz].view(torch.int32))
    assert bool((f32[~nz] == 0).all())
    # each piece is at most half an ulp of the piece before it
    nz = hi != 0
    assert bool((mid.double().abs() <= hi.double().abs() * 2.0 ** -8)[nz].all())


def _block_matrix(seed, k, n, r, c, keep, non_zero):
    rs = np.random.default_rng(seed)
    w = rs.choice([-1.0, 1.0], (k, n)) * (rs.integers(0, non_zero, (k, n)) == 0)
    mask = rs.uniform(size=(k // r, n // c)) < keep
    return (w * np.kron(mask, np.ones((r, c)))).astype(np.float32)


def _split_emulated(x, prep, b, alpha):
    """The mma body's f32 product: per stored block in prepared order, the
    hi pass and the mid + lo pass summed exactly, each rounded to f32 and
    added into the running f32 sums, hi then mid + lo; then the bias and
    PReLU rounded as the epilogue rounds them."""
    hi, mid, lo = (p.double().numpy() for p in tk.split_bf16x3(torch.from_numpy(x)))
    ml = mid + lo
    blocks = tk.decode_blocks(prep.values, torch.float64).numpy()
    rows, cols = prep.blk_row.numpy(), prep.blk_col.numpy()
    r, c = prep.r, prep.c
    acc = np.zeros((x.shape[0], prep.cols), np.float32)
    for blk in range(prep.k):
        ks = slice(rows[blk] * r, rows[blk] * r + r)
        cs = slice(cols[blk] * c, cols[blk] * c + c)
        acc[:, cs] = (acc[:, cs] + (hi[:, ks] @ blocks[blk]).astype(np.float32)
                      ) + (ml[:, ks] @ blocks[blk]).astype(np.float32)
    if b is not None:
        acc = acc + b
    if alpha is not None:  # a column with no block: the activated bias
        acc = np.where(acc > 0, acc, np.float32(alpha) * acc)
    return acc


@pytest.mark.parametrize("m,k,n,keep,non_zero", [
    (8, 1024, 256, 1.0, 2),  # the showcase's kind: every block stored, 1/2 nonzero
    (5, 1024, 512, 0.4, 10),  # the block-sparse workload's kind
])
def test_split_product_within_tol_of_pallas(m, k, n, keep, non_zero):
    w = _block_matrix(m + k + n, k, n, 128, 128, keep, non_zero)
    rs = np.random.default_rng(m + n)
    x = rs.uniform(-1, 1, (m, k)).astype(np.float32)
    b = rs.uniform(-1, 1, n).astype(np.float32)
    prep = tk.bcsr_prepare(bcsr_from_dense(w, 128, 128, device=CPU), device=CPU)
    jprep = jk.bcsr_prepare(jbcsr_from_dense(w, 128, 128))
    assert prep.k > 0 and tk.bcsr_route(prep.r, prep.c) == "mma"
    for alpha in (None, ALPHA):
        got = _split_emulated(x, prep, b, alpha)
        want = np.asarray(jk.bcsr_spmm_pallas(jnp.asarray(x), jprep, jnp.asarray(b), alpha))
        assert_close(got, want, TOL_DENSE, f"split product vs pallas alpha={alpha}")
        plain = tk.bcsr_spmm_kernel_plain(torch.from_numpy(x), prep, torch.from_numpy(b),
                                          alpha)
        assert_close(got, plain, TOL_DENSE, "split product vs plain")
    exact = x.astype(np.float64) @ w.astype(np.float64) + b
    assert np.abs(_split_emulated(x, prep, b, None) - exact).max() < TOL_DENSE / 4
    if keep == 1.0:
        assert np.abs(exact).max() > 10  # sums of the showcase's magnitude


# (r, c, route) at every block shape of chip_smoke.py's BCSR_SHAPES and of
# tests/test_torch_cuda.py's B2 cases
@pytest.mark.parametrize("r,c,route", [
    (8, 128, "cuda_core"), (4, 256, "cuda_core"), (128, 128, "mma"), (64, 128, "mma"),
    (256, 128, "mma"), (192, 256, "mma"), (16, 128, "cuda_core"), (32, 128, "cuda_core"),
])
def test_bcsr_route(r, c, route):
    assert tk.bcsr_route(r, c) == route
    if route == "mma":  # one k16 step takes 16 packed rows of one plane
        assert (r // 4) % 16 == 0


def test_bcsr_route_refuses_narrow_blocks():
    with pytest.raises(ValueError):
        tk.bcsr_route(128, 64)


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("m", [1, 16, 64, 256])
def test_bcsr_tile_divides_c_and_fills_a_wave(m, n):
    c = 128
    bm, bn = tk.bcsr_tile(m, n, c)
    assert (bm, bn) in tk.MMA_TILES and c % bn == 0
    assert bm == (16 if m <= 64 else 64)  # on the card 16 rows are fastest at M = 64
    rows = -(-m // bm)

    def blocks(width):
        return rows * (n // width)

    # 3/4 of a wave where some BN reaches it (the widest such), else the most blocks
    if blocks(32) >= WAVE:
        assert blocks(bn) >= WAVE
        assert all(blocks(w) < WAVE for w in (128, 64) if w > bn)
    else:
        assert bn == 32
    if (m, n) == (1, 4096):
        assert blocks(bn) >= WAVE  # where the CUDA-core body gave 32 blocks


def test_bcsr_tile_keeps_bn_inside_the_block():
    for c in (128, 256, 384):
        for m in (1, 40, 300):
            assert c % tk.bcsr_tile(m, 8 * c, c)[1] == 0


def test_bcsr_constants_match_the_source():
    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", SRC)[1])

    assert const("MMA_R") == tk.MMA_R == 64
    assert const("MMA_PK") == tk.CHUNK_ROWS == 32
    assert const("MMA_STAGES") == tk.RING >= 3
    assert const("MMA_KROWS") == 16
    assert const("BN") == tk.LANE  # the CUDA-core body's tile width
    tiles = tuple((int(a), int(b)) for a, b in re.findall(r"SMMB_TILE\((\d+), (\d+)\)\n", SRC))
    assert tiles == tk.MMA_TILES
    # the wrapper's tiles are the ones the source's static_asserts admit
    assert {bm for bm, _ in tiles} == {16, 64} and {bn for _, bn in tiles} == {32, 64, 128}
    assert "c % BN != 0" in SRC


def test_bcsr_shared_memory_fits_the_card():
    """The ring's bytes (csrc MmaTile::SMEM) fit the 227 KB a block can have."""
    def smem(bm, bn, xb):
        xrow = 4 * tk.CHUNK_ROWS * xb + (32 if xb == 4 else 16)
        return tk.RING * (bm * xrow + tk.CHUNK_ROWS * bn)

    for bm, bn in tk.MMA_TILES:
        assert smem(bm, bn, 4) <= 232448 and smem(bm, bn, 2) <= 232448
    assert smem(64, 128, 4) == 116736  # one block a SM at the f32 showcase tile
    assert "static constexpr int XROW = 4 * MMA_PK * XB + XPAD;" in SRC
    assert "static constexpr int XPAD = F32 ? 32 : 16;" in SRC
    assert "static constexpr int SMEM = MMA_STAGES * STAGE;" in SRC


def test_roofline_f32_ternary():
    spec = troofline.chip_spec("NVIDIA H100 80GB HBM3")
    # three bf16 passes over the headline's dense count: 8.6 GFLOP at 329.7 TFLOP/s
    t, by = troofline.roofline_bound(2.0 * 256 * 4096 * 4096, 12e6, spec, "f32_ternary")
    assert by == "operations" and t == pytest.approx(26.1e-6, rel=1e-2)
    assert spec.peak_ops("f32_ternary") == pytest.approx(spec.peak_ops("bf16") / 3)
    pcie = troofline.chip_spec("NVIDIA H100 PCIe")
    assert pcie.peak_ops("f32_ternary") == pytest.approx(252e12)
    assert spec.peak_ops("f32") == 67e12  # both operands f32: the CUDA cores' rate


def test_bcsr_tile_follows_the_cards_sm_count():
    """The wrapper passes the card's SM count: a smaller card reaches 3/4 of
    its wave with wider tiles."""
    assert tk.bcsr_tile(1, 4096, 128) == (16, 32)  # 128 blocks for 132 SMs
    assert tk.bcsr_tile(1, 4096, 128, sms=80) == (16, 64)  # 64 blocks reach 60
    assert tk.bcsr_tile(256, 4096, 128, sms=114) == (64, 128)  # an H100 PCIe


@pytest.mark.parametrize("tile", [(32, 128), (16, 256), (0, 0)])
def test_bcsr_launch_refuses_a_tile_the_route_has_not(tile):
    """A forced tile outside ``MMA_TILES`` is refused before anything is
    built or launched, and the CUDA-core route takes none."""
    w = (np.random.default_rng(3).integers(-1, 2, (256, 256))).astype(np.float32)
    x = torch.ones(2, 256)
    prep = tk.bcsr_prepare(bcsr_from_dense(w, 128, 128, device=CPU), device=CPU)
    with pytest.raises(ValueError, match="tile"):
        tk._launch(x, prep, None, None, tile)
    small = tk.bcsr_prepare(bcsr_from_dense(w, 8, 128, device=CPU), device=CPU)
    with pytest.raises(ValueError, match="tile"):
        tk._launch(x, small, None, None, (16, 128))


@pytest.mark.parametrize("name,key", [
    ("bcsr_kernel", "f32_ternary"), ("packed_kernel", "f32_ternary"),
    ("packed_kernel_prelu", "f32_ternary"), ("dense", "f32_ternary"),
    ("packed_kernel_bf16", "bf16"), ("packed_kernel_bf16_prelu", "bf16"),
    ("packed_kernel_w2a8", "int8"), ("packed_kernel_w2a8_prelu", "int8"),
])
def test_sweep_row_ceiling(name, key):
    """The showcase's roofline fraction takes each row's own rate: W2A8 rows
    run on the int8 tensor cores, f32 rows as three bf16 passes."""
    from smmb_tpu_torch.bench import sweep as tsweep

    assert tsweep.row_ceiling(name) == key
