"""Port parity: kernel B1, smmb_tpu_torch.kernels.packed_spmm, against the
Pallas kernel smmb_tpu.kernels.packed_spmm (interpret mode on the CPU, small
blocks as tests/test_kernels.py runs it) and against packed_spmm_jnp.

On the CPU the wrapper runs its plain version (packed_spmm_plain); the CUDA
kernel itself is held against that plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py).

Tolerances: f32 TOL_DENSE (1e-4 abs, the reference contract); bf16 0.2 abs
(as tests/test_kernels.py: W decodes exactly, the error is the cast of X);
W2A8 1e-5·max|Y| with the int8 codes of X equal, because the int32 sums are
exact and only the f32 epilogue rounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smmb_tpu.formats.packed import pack_ternary as jpack
from smmb_tpu.kernels import packed_spmm as jspmm
from smmb_tpu.ops.spmm import packed_spmm_jnp
from smmb_tpu_torch.formats.packed import pack_ternary
from smmb_tpu_torch.kernels.packed_spmm import (
    F32_K_CHUNK,
    F32_TILES,
    K_CHUNK,
    NUM_SMS,
    packed_spmm,
    pieces_aligned,
    quantize_rows,
    tile_for,
)
from smmb_tpu_torch.utils.compare import TOL_DENSE, assert_close

torch.set_num_threads(2)
ALPHA = 0.2


def _setup(seed, m, k, n, non_zero=2):
    rs = np.random.default_rng(seed)
    x = rs.uniform(-1, 1, (m, k)).astype(np.float32)
    p = 1.0 / (2 * non_zero)
    w = rs.choice(np.array([-1.0, 0.0, 1.0], np.float32), size=(k, n),
                  p=[p, 1 - 2 * p, p])
    b = rs.uniform(-1, 1, (n,)).astype(np.float32)
    return x, w, b


def _both(x, w, b):
    """(jax args, torch args) built from the same numpy arrays."""
    jargs = (jnp.asarray(x), jpack(w), None if b is None else jnp.asarray(b))
    targs = (torch.from_numpy(x), pack_ternary(w, device="cpu"),
             None if b is None else torch.from_numpy(b))
    return jargs, targs


@pytest.mark.parametrize(
    "m,k,n",
    [(1, 512, 1024), (16, 512, 512), (8, 1024, 640), (100, 512, 512)],
)
def test_f32_matches_pallas_and_jnp(m, k, n):
    x, w, b = _setup(11 + m, m, k, n)
    (jx, jp, jb), (tx, tp, tb) = _both(x, w, b)
    y = packed_spmm(tx, tp, tb, ALPHA)
    assert y.shape == (m, n) and y.dtype == torch.float32
    kernel = jspmm(jx, jp, jb, alpha=ALPHA, block_m=32, block_n=256)
    assert_close(y, kernel, TOL_DENSE, f"vs pallas {m}x{k}x{n}")
    oracle = packed_spmm_jnp(jx, jp, jb, alpha=ALPHA)
    assert_close(y, oracle, TOL_DENSE, f"vs jnp {m}x{k}x{n}")


def test_short_k():
    # K smaller than one packed group: zero padding must be harmless
    x, w, b = _setup(14, 4, 100, 256)
    (jx, jp, jb), (tx, tp, tb) = _both(x, w, b)
    assert_close(packed_spmm(tx, tp, tb), jspmm(jx, jp, jb, block_m=32, block_n=256),
                 TOL_DENSE, "short K")


def test_multi_group_k_with_block_k():
    x, w, b = _setup(15, 8, 2048, 256)
    (jx, jp, jb), (tx, tp, tb) = _both(x, w, b)
    want = jspmm(jx, jp, jb, block_m=32, block_n=256, block_k=512)
    assert_close(packed_spmm(tx, tp, tb, block_k=512), want, TOL_DENSE, "K=2048")


def test_no_bias():
    x, w, _ = _setup(13, 4, 512, 256)
    (jx, jp, _), (tx, tp, _) = _both(x, w, None)
    assert_close(packed_spmm(tx, tp), jspmm(jx, jp, block_m=32, block_n=256),
                 TOL_DENSE, "no bias")


def test_nd_input():
    x, w, b = _setup(18, 12, 512, 256)
    x3 = x.reshape(3, 4, 512)
    (jx, jp, jb), (tx, tp, tb) = _both(x3, w, b)
    y = packed_spmm(tx, tp, tb, ALPHA)
    assert y.shape == (3, 4, 256)
    assert_close(y, jspmm(jx, jp, jb, alpha=ALPHA, block_m=32, block_n=256),
                 TOL_DENSE, "3-D x")


@pytest.mark.parametrize("m,k,n", [(8, 512, 256), (5, 1024, 640)])
def test_bf16_mode(m, k, n):
    x, w, b = _setup(16 + m, m, k, n)
    (jx, jp, jb), (tx, tp, tb) = _both(x, w, b)
    y = packed_spmm(tx, tp, tb, ALPHA, compute_dtype=torch.bfloat16)
    want = jspmm(jx, jp, jb, alpha=ALPHA, compute_dtype=jnp.bfloat16,
                 block_m=32, block_n=256)
    assert_close(y, want, 0.2, "bf16 vs pallas")
    oracle = packed_spmm_jnp(jx, jp, jb, alpha=ALPHA, dtype=jnp.bfloat16)
    assert_close(y, oracle, 0.2, "bf16 vs jnp")
    # bf16 activations in, bf16 out
    yb = packed_spmm(tx.to(torch.bfloat16), tp, tb, compute_dtype=torch.bfloat16)
    assert yb.dtype == torch.bfloat16


def _jax_w2a8_codes(x):
    # smmb_tpu/kernels/packed_spmm.py:353-355
    scale = jnp.max(jnp.abs(x), axis=1, keepdims=True) / 127.0
    scale = jnp.maximum(scale, 1e-12)
    return jnp.clip(jnp.round(x / scale), -127, 127).astype(jnp.int8), scale


@pytest.mark.parametrize("m,k,n", [(64, 1024, 512), (5, 1024, 640), (3, 100, 128)])
def test_w2a8_mode(m, k, n):
    x, w, b = _setup(17 + m, m, k, n)
    x[0, :] = 0.0  # an all-zero row takes the 1e-12 scale floor
    (jx, jp, jb), (tx, tp, tb) = _both(x, w, b)
    codes, scale = quantize_rows(tx)
    jcodes, jscale = _jax_w2a8_codes(jx)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    for alpha in (None, ALPHA):
        y = packed_spmm(tx, tp, tb, alpha, compute_dtype=torch.int8)
        want = np.asarray(jspmm(jx, jp, jb, alpha=alpha, compute_dtype=jnp.int8,
                                block_m=32, block_n=256))
        assert_close(y, want, 1e-5 * float(np.abs(want).max()), "w2a8")


def test_decode_fold_is_the_same_function():
    x, w, b = _setup(23, 5, 1024, 640)
    tx, tp, tb = torch.from_numpy(x), pack_ternary(w, device="cpu"), torch.from_numpy(b)
    for cdt in (torch.float32, torch.bfloat16, torch.int8):
        assert torch.equal(
            packed_spmm(tx, tp, tb, ALPHA, compute_dtype=cdt, decode="fold"),
            packed_spmm(tx, tp, tb, ALPHA, compute_dtype=cdt, decode="shift"),
        )


@pytest.mark.parametrize(
    "kwargs", [{"decode": "scratch"}, {"decode": "cmp"}, {"block_k": 256}]
)
def test_rejects_what_the_hopper_kernel_does_not_take(kwargs):
    x, w, _ = _setup(1, 2, 512, 128)
    with pytest.raises(ValueError):
        packed_spmm(torch.from_numpy(x), pack_ternary(w, device="cpu"), **kwargs)


def test_rejects_k_mismatch():
    x, w, _ = _setup(2, 2, 512, 128)
    with pytest.raises(ValueError):
        packed_spmm(torch.from_numpy(x[:, :500]), pack_ternary(w, device="cpu"))


def test_rejects_other_devices():
    x, w, _ = _setup(3, 2, 512, 128)
    with pytest.raises(ValueError):
        packed_spmm(torch.from_numpy(x).to("meta"), pack_ternary(w, device="cpu"))


def test_cpu_call_does_not_count_a_launch():
    x, w, b = _setup(4, 4, 512, 128)
    before = packed_spmm.launches
    for cdt in (torch.float32, torch.bfloat16, torch.int8):
        packed_spmm(torch.from_numpy(x), pack_ternary(w, device="cpu"),
                    torch.from_numpy(b), ALPHA, compute_dtype=cdt)
    assert packed_spmm.launches == before


# N of the paths' B1 calls: the LM head (8192), its fused qkv (3072), d_ff
# (4096), d_model (1024), the spec draft (256), the tests' odd widths
PATH_NS = (129, 256, 640, 1024, 2048, 3072, 4096, 8192)


@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("n", PATH_NS)
def test_tile_for_every_m(cdt, n):
    """For M = 1..300 the tile is an allowed one, the grid fits the launch
    limits, and the K chunk is one constant: the K walk (and so each row's
    result) does not depend on M."""
    chunks = set()
    for m in range(1, 301):
        bm, bn, pk = tile_for(m, n, cdt)
        assert bm in (16, 64) and bn in (64, 128)
        assert -(-m // bm) <= 2 or bm == 64, "up to M = 32 two 16-row blocks at most"
        assert -(-m // bm) <= 65535 and -(-n // bn) <= 2 ** 31 - 1
        chunks.add(pk)
    assert chunks == {K_CHUNK}


def test_tile_for_fills_about_a_wave():
    # the headline (M=256, N=4096) and the LM head at M=1 (N=8192): 128 blocks
    for m, n, tile in ((256, 4096, (64, 128)), (1, 8192, (16, 64)), (5, 8192, (16, 64)),
                       (17, 3072, (16, 64)), (32, 3072, (16, 64)), (33, 1024, (64, 64)), (8192, 4096, (64, 128))):
        bm, bn, _ = tile_for(m, n)
        assert (bm, bn) == tile
    assert -(-256 // 64) * -(-4096 // 128) <= NUM_SMS
    # f32: its own four tiles, one K chunk for every M, 64x128 at the headline
    # and 16x64 (128 blocks) at the LM head
    f32 = {m: tile_for(m, 4096, torch.float32) for m in (1, 17, 256)}
    assert all(t[:2] in F32_TILES and t[2] == F32_K_CHUNK for t in f32.values())
    assert f32[256][:2] == (64, 128) and tile_for(1, 8192, torch.float32)[:2] == (16, 64)


@pytest.mark.parametrize("cdt,k,n,ptrs,want", [
    (torch.bfloat16, 4096, 4096, (0, 256), True),
    (torch.bfloat16, 100, 256, (0, 0), False),  # K not a multiple of 8
    (torch.bfloat16, 2048, 129, (0, 0), False),  # N not a multiple of 16
    (torch.bfloat16, 512, 640, (2, 0), False),  # X 2 bytes past a boundary
    (torch.int8, 1000, 640, (0, 0), False),  # K not a multiple of 16
    (torch.int8, 1024, 640, (0, 48), True),
    (torch.int8, 1024, 640, (0, 8), False),  # W 8 bytes past a boundary
    (torch.float32, 100, 256, (0, 0), True),  # f32: K a multiple of 4
    (torch.float32, 1000, 300, (0, 0), False),  # N not a multiple of 16
    (torch.float32, 1022, 640, (0, 0), False),  # K not a multiple of 4
    (torch.float32, 512, 640, (4, 0), False),  # X 4 bytes past a boundary
])
def test_pieces_aligned(cdt, k, n, ptrs, want):
    assert pieces_aligned(k, n, *ptrs, cdt) is want
