"""B1's f32 body stated in plain adds: ``packed_spmm_f32_chain`` against the
plain version and JAX's Pallas kernel, its rows against its M = 1 calls,
and the f32 tiles ``tile_for`` picks.

The CUDA kernel's f32 mode takes ``fmaf(x, w, acc)`` into one register an
output in one K order under every tile; with a ternary W each product is
exact, so the chain is the kernel's output bit for bit, which the card tests
(tests/test_torch_cuda.py) and chip_smoke.py hold on the H100. Here, on the
CPU, the chain itself is held: within 1e-4 of max(1, max|Y|) of
``packed_spmm_plain`` (f32 sums in another order), within JAX's f32
tolerance ``TOL_DENSE`` (1e-4 abs, as tests/test_kernels.py) of JAX's kernel
run in interpret mode, and its rows bitwise its M = 1 calls (the K walk does
not depend on M).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smmb_tpu.formats.packed import pack_ternary as jpack
from smmb_tpu.kernels import packed_spmm as jspmm
from smmb_tpu_torch.formats.packed import pack_ternary
from smmb_tpu_torch.kernels.packed_spmm import (
    F32_K_CHUNK,
    F32_TILES,
    NUM_SMS,
    packed_spmm_f32_chain,
    packed_spmm_plain,
    tile_for,
)
from smmb_tpu_torch.utils.compare import TOL_DENSE, assert_close

torch.set_num_threads(2)
ALPHA = 0.2


def _setup(seed, m, k, n, non_zero=2):
    rs = np.random.default_rng(seed)
    x = rs.uniform(-1, 1, (m, k)).astype(np.float32)
    p = 1.0 / (2 * non_zero)
    w = rs.choice(np.array([-1.0, 0.0, 1.0], np.float32), size=(k, n), p=[p, 1 - 2 * p, p])
    b = rs.uniform(-1, 1, (n,)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("m,k,n,bias,alpha", [
    (5, 100, 256, True, ALPHA), (17, 1000, 300, True, ALPHA), (8, 4096, 64, False, None),
    (3, 512, 129, True, None), (1, 1024, 96, False, ALPHA),
])
def test_chain_matches_plain(m, k, n, bias, alpha):
    x, w, b = _setup(60 + m, m, k, n, non_zero=10 if k == 4096 else 2)
    tx, tp = torch.from_numpy(x), pack_ternary(w, device="cpu")
    tb = torch.from_numpy(b) if bias else None
    y = packed_spmm_f32_chain(tx, tp, tb, alpha)
    ref = packed_spmm_plain(tx, tp, tb, alpha)
    assert y.shape == (m, n) and y.dtype == torch.float32
    assert_close(y, ref, 1e-4 * max(1.0, float(ref.abs().max())), f"chain {m}x{k}x{n}")


@pytest.mark.parametrize("m,k,n", [(4, 100, 256), (16, 512, 512), (9, 1000, 384)])
def test_chain_matches_jax(m, k, n):
    x, w, b = _setup(70 + m, m, k, n)
    y = packed_spmm_f32_chain(torch.from_numpy(x), pack_ternary(w, device="cpu"),
                              torch.from_numpy(b), ALPHA)
    ref = jspmm(jnp.asarray(x), jpack(w), jnp.asarray(b), alpha=ALPHA, block_m=32, block_n=256)
    assert_close(y, np.asarray(ref), TOL_DENSE, f"chain vs JAX {m}x{k}x{n}")


@pytest.mark.parametrize("k", [100, 1000, 4096])
def test_chain_rows_are_the_m1_rows(k):
    """Row r of the chain of an M-row X is bitwise its chain of row r alone,
    at ragged K (100, 1000: the plane runs end inside a chunk) and at K=4096."""
    x, w, b = _setup(80 + k, 6, k, 72, non_zero=10 if k == 4096 else 2)
    tx, tp, tb = torch.from_numpy(x), pack_ternary(w, device="cpu"), torch.from_numpy(b)
    y = packed_spmm_f32_chain(tx, tp, tb, ALPHA)
    ones = torch.cat([packed_spmm_f32_chain(tx[r:r + 1], tp, tb, ALPHA) for r in range(6)])
    assert torch.equal(y, ones)


@pytest.mark.parametrize("m,n,tile", [
    (256, 4096, (64, 128)),  # the headline: 128 blocks of the 8x8 micro-tile
    (64, 2048, (16, 64)),  # entry()'s first two layers: 128 blocks
    (64, 1024, (16, 64)),  # entry()'s last layer: 64 blocks, the most any tile gives
    (32, 1024, (16, 64)),  # the LM prefill's projections
    (1, 8192, (16, 64)),  # the LM head at M=1: BM 64 would leave 63 rows idle
    (5, 8192, (16, 64)),
    (128, 4096, (64, 64)),
    (256, 1024, (16, 128)),
    (8192, 4096, (64, 128)),
])
def test_f32_tile_for_picks(m, n, tile):
    bm, bn, pk = tile_for(m, n, torch.float32)
    assert (bm, bn) == tile and (bm, bn) in F32_TILES and pk == F32_K_CHUNK
    blocks = -(-m // bm) * -(-n // bn)
    most = max(-(-m // a) * -(-n // c) for a, c in F32_TILES)
    assert blocks >= NUM_SMS * 3 // 4 or blocks == most

