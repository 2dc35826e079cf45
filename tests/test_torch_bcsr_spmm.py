"""Port parity: kernel B2 (smmb_tpu_torch.kernels.bcsr_spmm) against
smmb_tpu.kernels.bcsr_spmm.

``bcsr_prepare`` must give JAX's bytes (block order, sentinels, 2-bit codes,
the per-column mask). On the CPU the wrapper runs its plain version, which
is held against JAX's Pallas kernel in interpret mode (as tests/
test_kernels.py runs it) at the twins of tests/test_kernels.py's BCSR cases.
Tolerances: f32 TOL_DENSE (1e-4; exact ±1 products summed in f32 in another
order); bf16 X 2**-7 of max(1, max|Y|) (both sum the same bf16 values in f32
and round the result to bf16 once, so they differ by at most one bf16 ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smmb_tpu.formats.bcsr import bcsr_from_dense as jbcsr_from_dense
from smmb_tpu.kernels import bcsr_spmm as jk
from smmb_tpu_torch import convert
from smmb_tpu_torch.formats.bcsr import bcsr_from_dense
from smmb_tpu_torch.kernels import bcsr_spmm as tk
from smmb_tpu_torch.ops import dense as tdense
from smmb_tpu_torch.utils.compare import TOL_DENSE, assert_close

torch.set_num_threads(2)
ALPHA = 0.2
CPU = "cpu"
PREPARED = ("blk_row", "blk_col", "values", "col_has_blocks")


def _block_sparse_matrix(seed, k, n, r, c, keep=0.3):
    """tests/test_kernels.py's generator: nonzeros only in a ``keep``
    fraction of the r×c blocks."""
    rs = np.random.RandomState(seed)
    w = np.zeros((k, n), np.float32)
    for bi in range(k // r):
        for bj in range(n // c):
            if rs.rand() < keep:
                w[bi * r:(bi + 1) * r, bj * c:(bj + 1) * c] = rs.choice(
                    [-1.0, 0.0, 1.0], size=(r, c), p=[0.25, 0.5, 0.25])
    return w


def _dense(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _prepared(w, r, c):
    return (tk.bcsr_prepare(bcsr_from_dense(w, r, c, device=CPU), device=CPU),
            jk.bcsr_prepare(jbcsr_from_dense(w, r, c)))


@pytest.mark.parametrize("k,n,r,c,keep", [
    (512, 512, 8, 128, 0.3), (512, 1024, 128, 128, 0.4), (256, 256, 8, 128, 0.0),
    (96, 256, 4, 256, 0.5), (64, 384, 16, 128, 1.0),
])
def test_bcsr_prepare_bytes_equal_jax(k, n, r, c, keep):
    w = _block_sparse_matrix(k + n, k, n, r, c, keep)
    p, j = _prepared(w, r, c)
    for f in PREPARED:
        got, want = getattr(p, f).numpy(), np.asarray(getattr(j, f))
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), f
    assert (p.rows, p.cols, p.r, p.c, p.k) == (j.rows, j.cols, j.r, j.c, j.k)
    assert p.weight_bytes() == j.weight_bytes()
    # col_start[j] .. col_start[j+1] is block column j's run
    blk_col, cs = p.blk_col.numpy(), p.col_start.numpy()
    assert cs[0] == 0 and cs[-1] == p.k and len(cs) == n // c + 1
    for col in range(n // c):
        assert (blk_col[cs[col]:cs[col + 1]] == col).all()
    # the codes decode back to the blocks in prepared order
    dense = tk.decode_blocks(p.values).numpy()
    for b in range(p.k):
        rr, cc = int(p.blk_row[b]), int(p.blk_col[b])
        np.testing.assert_array_equal(dense[b], w[rr * r:(rr + 1) * r, cc * c:(cc + 1) * c])
    q = convert.bcsr_prepared_from_jax(j, device=CPU)
    for f in PREPARED + ("col_start",):
        assert torch.equal(getattr(q, f), getattr(p, f)), f


def _jax_kernel(x, prep, b, alpha, **kw):
    return np.asarray(jk.bcsr_spmm_pallas(
        jnp.asarray(x), prep, None if b is None else jnp.asarray(b), alpha, **kw
    ).astype(jnp.float32))


@pytest.mark.parametrize("x_resident", [True, False])
def test_plain_equal_pallas_8x128_blocks(x_resident):
    w = _block_sparse_matrix(0, 512, 512, 8, 128)
    p, j = _prepared(w, 8, 128)
    assert p.k > 0
    x, b = _dense(31, (16, 512)), _dense(32, (512,))
    tx, tb = torch.from_numpy(x), torch.from_numpy(b)
    for alpha in (None, ALPHA):
        want = _jax_kernel(x, j, b, alpha, x_resident=x_resident)
        y = tk.bcsr_spmm_kernel(tx, p, tb, alpha, x_resident=x_resident)
        assert y.dtype == torch.float32
        assert_close(y, want, TOL_DENSE, f"B2 plain vs pallas alpha={alpha}")
        oracle = (tdense.gemm if alpha is None else
                  lambda *a: tdense.gemm_prelu(*a, ALPHA))(tx, torch.from_numpy(w), tb)
        assert_close(y, oracle, TOL_DENSE, "B2 plain vs dense oracle")
        assert torch.equal(y, tk.bcsr_spmm_kernel(tx, p, tb, alpha,
                                                  x_resident=not x_resident))


def test_plain_equal_pallas_128x128_blocks_unaligned_m():
    w = _block_sparse_matrix(1, 512, 1024, 128, 128, keep=0.4)
    p, j = _prepared(w, 128, 128)
    x = _dense(33, (100, 512))
    y = tk.bcsr_spmm_kernel(torch.from_numpy(x), p, None)
    assert y.shape == (100, 1024)
    assert_close(y, _jax_kernel(x, j, None, None), TOL_DENSE, "B2 128x128 M=100")


def test_plain_equal_pallas_m_beyond_block_m():
    w = _block_sparse_matrix(3, 256, 512, 8, 128)
    p, j = _prepared(w, 8, 128)
    x = _dense(34, (140, 256))
    y = tk.bcsr_spmm_kernel(torch.from_numpy(x), p, None, block_m=64)
    assert_close(y, _jax_kernel(x, j, None, None, block_m=64), TOL_DENSE, "B2 M>block_m")
    assert torch.equal(y, tk.bcsr_spmm_kernel(torch.from_numpy(x), p, None, block_m=256))


def test_plain_bf16_equal_pallas():
    w = _block_sparse_matrix(4, 512, 512, 8, 128)
    p, j = _prepared(w, 8, 128)
    x, b = _dense(35, (16, 512)), _dense(36, (512,))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y = tk.bcsr_spmm_kernel(xb, p, torch.from_numpy(b), ALPHA)
    assert y.dtype == torch.bfloat16
    want = np.asarray(jk.bcsr_spmm_pallas(jnp.asarray(x, jnp.bfloat16), j, jnp.asarray(b),
                                          ALPHA).astype(jnp.float32))
    assert_close(y.float(), want, 2.0 ** -7 * max(1.0, float(np.abs(want).max())),
                 "B2 bf16 plain vs pallas")


def test_empty_matrix_gives_activated_bias_without_launch():
    w = np.zeros((256, 256), np.float32)
    p, j = _prepared(w, 8, 128)
    b = np.arange(256, dtype=np.float32) - 128.0
    before = tk.bcsr_spmm_kernel.launches
    y = tk.bcsr_spmm_kernel(torch.ones(4, 256), p, torch.from_numpy(b), alpha=ALPHA)
    assert tk.bcsr_spmm_kernel.launches == before
    want = np.tile(np.where(b > 0, b, ALPHA * b), (4, 1))
    np.testing.assert_array_equal(y.numpy(), want)
    np.testing.assert_allclose(_jax_kernel(np.ones((4, 256), np.float32), j, b, ALPHA),
                               want, atol=1e-6)
    np.testing.assert_array_equal(tk.bcsr_spmm_kernel(torch.ones(2, 256), p).numpy(), 0.0)


def test_untouched_columns_get_activated_bias():
    # block column 1 holds no block: it passes the activated bias
    w = np.zeros((128, 256), np.float32)
    w[:8, :128] = _block_sparse_matrix(5, 8, 128, 8, 128, keep=1.0)
    p, _ = _prepared(w, 8, 128)
    x, b = _dense(37, (3, 128)), _dense(38, (256,))
    y = tk.bcsr_spmm_kernel(torch.from_numpy(x), p, torch.from_numpy(b), ALPHA).numpy()
    np.testing.assert_array_equal(y[:, 128:], np.tile(np.where(b > 0, b, ALPHA * b)[128:],
                                                      (3, 1)))
    ref = tdense.gemm_prelu(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                            ALPHA)
    assert_close(y, ref, TOL_DENSE)


@pytest.mark.parametrize("case", ["c_not_128", "k_mismatch", "r_not_4", "not_2d"])
def test_block_validation(case):
    if case == "r_not_4":
        with pytest.raises(ValueError):
            tk.bcsr_prepare(bcsr_from_dense(np.zeros((64, 128), np.float32), 2, 128,
                                            device=CPU), device=CPU)
        return
    shape, r, c = ((64, 64), 8, 8) if case == "c_not_128" else ((64, 128), 8, 128)
    p = tk.bcsr_prepare(bcsr_from_dense(np.zeros(shape, np.float32), r, c, device=CPU),
                        device=CPU)
    x = {"c_not_128": torch.ones(4, 64), "k_mismatch": torch.ones(4, 32),
         "not_2d": torch.ones(2, 4, 64)}[case]
    with pytest.raises(ValueError):
        tk.bcsr_spmm_kernel(x, p, None)
    if case != "not_2d":  # the JAX kernel raises on the same inputs
        jp = jk.bcsr_prepare(jbcsr_from_dense(np.zeros(shape, np.float32), r, c))
        with pytest.raises(ValueError):
            jk.bcsr_spmm_pallas(jnp.asarray(x.numpy()), jp, None)


def test_cpu_calls_count_no_launch():
    w = _block_sparse_matrix(6, 256, 256, 8, 128, keep=1.0)
    p, _ = _prepared(w, 8, 128)
    before = tk.bcsr_spmm_kernel.launches
    tk.bcsr_spmm_kernel(torch.from_numpy(_dense(39, (4, 256))), p)
    assert tk.bcsr_spmm_kernel.launches == before


def test_prepare_block_mask_workload():
    # the block-sparse workload's mask (smmb_tpu/bench/scaling.py), scaled:
    # one stored block per kept mask entry, in both packages
    mask = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(7), 0.3, (4, 4)))
    w = np.repeat(np.repeat(mask, 128, 0), 128, 1).astype(np.float32)
    p, j = _prepared(w, 128, 128)
    assert p.k == int(mask.sum()) == j.k
    assert p.values.numpy().tobytes() == np.asarray(j.values).tobytes()
