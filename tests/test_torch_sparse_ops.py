"""Port parity: the TCSC and BCSR ops of smmb_tpu_torch.ops.spmm against
smmb_tpu.ops.spmm at tests/test_ops.py's cases.

The same numpy x, W and b (made from a seed) go through the JAX op and its
port (on the CPU); outputs agree at TOL_DENSE (1e-4, the reference's dense
tolerance): both sum exact ±1 products of the same f32 values in f32, in
different orders, about 1e-7 relative per sum. The dense oracle is held to
the same tolerance, as the JAX tests hold it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smmb_tpu.formats.bcsr import bcsr_from_dense as jbcsr_from_dense
from smmb_tpu.formats.tcsc import tcsc_from_dense as jtcsc_from_dense
from smmb_tpu.formats.tcsc import tcsc_pad_columns as jtcsc_pad_columns
from smmb_tpu.ops import spmm as _jspmm
from smmb_tpu_torch.formats.bcsr import bcsr_from_dense
from smmb_tpu_torch.formats.tcsc import tcsc_from_dense, tcsc_pad_columns
from smmb_tpu_torch.ops import dense as tdense
from smmb_tpu_torch.ops import spmm as tspmm
from smmb_tpu_torch.utils.compare import TOL_DENSE, assert_close

torch.set_num_threads(2)
ALPHA = 0.2
CPU = "cpu"


class _Jitted:
    """smmb_tpu.ops.spmm's ops under jax.jit (one compile per shape, not
    one per eager primitive); ``alpha`` stays a static argument."""

    def __getattr__(self, name):
        fn = getattr(_jspmm, name)
        if name.endswith("_prelu"):
            return jax.jit(fn, static_argnums=3)
        return jax.jit(fn)


jspmm = _Jitted()

# (M, K, N, non_zero): tests/test_ops.py's CASES
CASES = [(1, 64, 128, 2), (16, 128, 64, 2), (8, 96, 80, 8), (4, 256, 256, 16)]


def _setup(seed, m, k, n, non_zero):
    rs = np.random.default_rng(seed)
    x = rs.uniform(-1, 1, (m, k)).astype(np.float32)
    p = 1.0 / (2 * non_zero)
    w = rs.choice(np.array([-1.0, 0.0, 1.0], np.float32), size=(k, n), p=[p, 1 - 2 * p, p])
    b = rs.uniform(-1, 1, (n,)).astype(np.float32)
    return x, w, b


def _both(x, b):
    return (jnp.asarray(x), None if b is None else jnp.asarray(b),
            torch.from_numpy(x), None if b is None else torch.from_numpy(b))


@pytest.mark.parametrize("m,k,n,nz", CASES)
def test_tcsc_spmm_equal_jax(m, k, n, nz):
    x, w, b = _setup(1 + m, m, k, n, nz)
    jx, jb, tx, tb = _both(x, b)
    jt, t = jtcsc_from_dense(w), tcsc_from_dense(w, device=CPU)
    ref = tdense.gemm(tx, torch.from_numpy(w), tb)
    y = tspmm.tcsc_spmm(tx, t, tb)
    assert_close(y, np.asarray(jspmm.tcsc_spmm(jx, jt, jb)), TOL_DENSE, "tcsc vs jax")
    assert_close(y, ref, TOL_DENSE, "tcsc vs oracle")
    yp = tspmm.tcsc_spmm_padded(tx, tcsc_pad_columns(t), tb)
    assert_close(yp, np.asarray(jspmm.tcsc_spmm_padded(jx, jtcsc_pad_columns(jt), jb)),
                 TOL_DENSE, "tcsc padded vs jax")
    assert_close(yp, ref, TOL_DENSE, "tcsc padded vs oracle")


@pytest.mark.parametrize("m,k,n,nz", CASES)
def test_tcsc_spmm_prelu_equal_jax(m, k, n, nz):
    x, w, b = _setup(2 + m, m, k, n, nz)
    jx, jb, tx, tb = _both(x, b)
    y = tspmm.tcsc_spmm_prelu(tx, tcsc_from_dense(w, device=CPU), tb, ALPHA)
    want = np.asarray(jspmm.tcsc_spmm_prelu(jx, jtcsc_from_dense(w), jb, ALPHA))
    assert_close(y, want, TOL_DENSE, "tcsc prelu vs jax")
    assert_close(y, tdense.gemm_prelu(tx, torch.from_numpy(w), tb, ALPHA), TOL_DENSE)
    # the fused op equals PReLU after the plain op (the reference's variants)
    sep = tdense.prelu(tspmm.tcsc_spmm(tx, tcsc_from_dense(w, device=CPU), tb), ALPHA)
    assert_close(y, sep, 1e-6, "prelu variants")


@pytest.mark.parametrize("m,k,n,nz,r,c", [
    (1, 64, 128, 2, 8, 8), (16, 128, 64, 2, 8, 8), (4, 64, 64, 16, 1, 8),
    (8, 96, 80, 8, 4, 4), (5, 256, 256, 2, 8, 128),
])
def test_bcsr_spmm_equal_jax(m, k, n, nz, r, c):
    x, w, b = _setup(4 + m, m, k, n, nz)
    jx, jb, tx, tb = _both(x, b)
    jm, tm = jbcsr_from_dense(w, r, c), bcsr_from_dense(w, r, c, device=CPU)
    y = tspmm.bcsr_spmm(tx, tm, tb)
    assert_close(y, np.asarray(jspmm.bcsr_spmm(jx, jm, jb)), TOL_DENSE, "bcsr vs jax")
    assert_close(y, tdense.gemm(tx, torch.from_numpy(w), tb), TOL_DENSE, "bcsr vs oracle")
    yp = tspmm.bcsr_spmm_prelu(tx, tm, tb, ALPHA)
    assert_close(yp, np.asarray(jspmm.bcsr_spmm_prelu(jx, jm, jb, ALPHA)), TOL_DENSE,
                 "bcsr prelu vs jax")


def test_bcsr_spmm_empty_matrix():
    x = np.ones((4, 16), np.float32)
    b = np.arange(8, dtype=np.float32)
    w = np.zeros((16, 8), np.float32)
    y = tspmm.bcsr_spmm(torch.from_numpy(x), bcsr_from_dense(w, 4, 4, device=CPU),
                        torch.from_numpy(b))
    want = np.asarray(jspmm.bcsr_spmm(jnp.asarray(x), jbcsr_from_dense(w, 4, 4),
                                      jnp.asarray(b)))
    np.testing.assert_array_equal(y.numpy(), want)
    np.testing.assert_array_equal(y.numpy(), np.tile(b, (4, 1)))


def test_tcsc_empty_plane():
    x, _, b = _setup(9, 3, 32, 16, 2)
    w = np.zeros((32, 16), np.float32)
    w[3, 4] = 1.0  # no -1 entry at all
    jx, jb, tx, tb = _both(x, b)
    y = tspmm.tcsc_spmm(tx, tcsc_from_dense(w, device=CPU), tb)
    assert_close(y, np.asarray(jspmm.tcsc_spmm(jx, jtcsc_from_dense(w), jb)), TOL_DENSE)


def test_no_bias_paths():
    x, w, _ = _setup(5, 4, 64, 32, 2)
    jx, _, tx, _ = _both(x, None)
    ref = tdense.gemm(tx, torch.from_numpy(w))
    pairs = [
        (tspmm.tcsc_spmm(tx, tcsc_from_dense(w, device=CPU)),
         jspmm.tcsc_spmm(jx, jtcsc_from_dense(w))),
        (tspmm.tcsc_spmm_padded(tx, tcsc_pad_columns(tcsc_from_dense(w, device=CPU))),
         jspmm.tcsc_spmm_padded(jx, jtcsc_pad_columns(jtcsc_from_dense(w)))),
        (tspmm.bcsr_spmm(tx, bcsr_from_dense(w, 8, 8, device=CPU)),
         jspmm.bcsr_spmm(jx, jbcsr_from_dense(w, 8, 8))),
    ]
    for got, want in pairs:
        assert_close(got, np.asarray(want), TOL_DENSE, "no bias vs jax")
        assert_close(got, ref, TOL_DENSE, "no bias vs oracle")
