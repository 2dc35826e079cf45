"""Port parity: the property and fuzz cases of tests/test_property.py
(adversarial ternary patterns through every format, random shapes, bf16
inputs) on smmb_tpu_torch's formats and ops, against smmb_tpu's on the same
numpy inputs.

The formats round-trip each pattern exactly, and the port's packed planes
are JAX's bytes. The SpMMs are held at JAX's ``TOL_DENSE`` against JAX's
dense ``gemm`` and against JAX's own op; the inputs of the fuzz come from
JAX's seed (``np.random.RandomState(0)`` for the shapes, ``PRNGKey(trial)``
for x and W). bf16 activations come out bf16 within JAX's 0.25 of
max(1, max|Y|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smmb_tpu.formats.bcsr import bcsr_from_dense as jbcsr_from_dense
from smmb_tpu.formats.bcsr import bcsr_to_dense as jbcsr_to_dense
from smmb_tpu.formats.packed import pack_ternary as jpack
from smmb_tpu.formats.tcsc import tcsc_from_dense as jtcsc_from_dense
from smmb_tpu.formats.tcsc import tcsc_pad_columns as jtcsc_pad_columns
from smmb_tpu.ops import gemm as jgemm
from smmb_tpu.ops import packed_spmm_jnp, tcsc_spmm_padded as jtcsc_spmm_padded
from smmb_tpu.utils import rng as jrng
from smmb_tpu_torch.formats.bcsr import bcsr_from_dense, bcsr_to_dense
from smmb_tpu_torch.formats.packed import pack_ternary, unpack_ternary
from smmb_tpu_torch.formats.tcsc import tcsc_from_dense, tcsc_pad_columns, tcsc_to_dense
from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
from smmb_tpu_torch.ops import packed_spmm_ref, tcsc_spmm, tcsc_spmm_padded
from smmb_tpu_torch.utils.compare import TOL_DENSE, assert_close

torch.set_num_threads(2)
CPU = "cpu"
PATTERNS = ["all_zero", "all_pos", "all_neg", "checkerboard", "single_neg",
            "dense_first_col", "dense_last_row"]


def _pattern(name, k, n):
    """tests/test_property.py's ``_patterns``, one by name."""
    w = np.zeros((k, n), np.float32)
    if name == "all_pos":
        w[:] = 1.0
    elif name == "all_neg":
        w[:] = -1.0
    elif name == "checkerboard":
        w = (np.indices((k, n)).sum(axis=0) % 2 * 2.0 - 1.0).astype(np.float32)
    elif name == "single_neg":
        w[k // 2, n // 2] = -1.0
    elif name == "dense_first_col":
        w[:, 0] = 1.0
    elif name == "dense_last_row":
        w[-1, :] = -1.0
    return w


@pytest.mark.parametrize("name", PATTERNS)
@pytest.mark.parametrize("k,n", [(64, 48), (512, 128)])
def test_format_roundtrips_on_patterns(k, n, name):
    w = _pattern(name, k, n)
    np.testing.assert_array_equal(tcsc_to_dense(tcsc_from_dense(w, device=CPU)).numpy(), w,
                                  err_msg=f"tcsc {name}")
    p = pack_ternary(w, device=CPU)
    np.testing.assert_array_equal(unpack_ternary(p).numpy(), w, err_msg=f"packed {name}")
    np.testing.assert_array_equal(p.data.numpy(), np.asarray(jpack(w).data),
                                  err_msg=f"packed bytes {name}")
    m = bcsr_from_dense(w, 8, 8, device=CPU)
    np.testing.assert_array_equal(bcsr_to_dense(m).numpy(), w, err_msg=f"bcsr {name}")
    jm = jbcsr_from_dense(w, 8, 8)
    assert m.k == jm.k, name
    np.testing.assert_array_equal(np.asarray(jbcsr_to_dense(jm)), w)


@pytest.mark.parametrize("name", PATTERNS)
def test_spmm_on_patterns(name):
    k, n = 64, 48
    x = np.array(jrng.rand_dense(jax.random.PRNGKey(0), (4, k)))
    w = _pattern(name, k, n)
    ref = np.asarray(jgemm(jnp.asarray(x), jnp.asarray(w)))
    tx = torch.from_numpy(x)
    t = tcsc_from_dense(w, device=CPU)
    p = pack_ternary(w, device=CPU)
    assert_close(tcsc_spmm(tx, t), ref, TOL_DENSE, f"tcsc_spmm {name}")
    padded = tcsc_spmm_padded(tx, tcsc_pad_columns(t))
    assert_close(padded, ref, TOL_DENSE, f"tcsc_padded {name}")
    jpadded = jtcsc_spmm_padded(jnp.asarray(x), jtcsc_pad_columns(jtcsc_from_dense(w)))
    assert_close(padded, jpadded, TOL_DENSE, f"tcsc_padded vs JAX {name}")
    assert_close(packed_spmm_ref(tx, p), ref, TOL_DENSE, f"packed {name}")
    assert_close(packed_spmm(tx, p), packed_spmm_jnp(jnp.asarray(x), jpack(w)), TOL_DENSE,
                 f"packed wrapper vs JAX {name}")


def _fuzz_cases():
    rs = np.random.RandomState(0)  # JAX's draw, in its order
    out = []
    for trial in range(10):
        m = int(rs.randint(1, 33))
        k = int(rs.randint(1, 300))
        n = int(rs.randint(1, 200))
        nz = int(rs.choice([1, 2, 8]))
        out.append((trial, m, k, n, nz))
    return out


@pytest.mark.parametrize("trial,m,k,n,nz", _fuzz_cases())
def test_random_shapes_fuzz(trial, m, k, n, nz):
    kx, kw = jax.random.split(jax.random.PRNGKey(trial))
    x = np.array(jrng.rand_dense(kx, (m, k)))
    w = np.asarray(jrng.rand_ternary(kw, (k, n), non_zero=nz))
    ref = np.asarray(jgemm(jnp.asarray(x), jnp.asarray(w)))
    tx = torch.from_numpy(x)
    assert_close(tcsc_spmm(tx, tcsc_from_dense(w, device=CPU)), ref, TOL_DENSE,
                 f"fuzz tcsc {m}x{k}x{n}")
    p = pack_ternary(w, device=CPU)
    assert_close(packed_spmm_ref(tx, p), ref, TOL_DENSE, f"fuzz packed {m}x{k}x{n}")
    assert_close(packed_spmm(tx, p), ref, TOL_DENSE, f"fuzz packed wrapper {m}x{k}x{n}")


@pytest.mark.parametrize("tile", [None, (16, 128), (64, 64)])
def test_bf16_inputs_flow_through(tile):
    # a user feeding bf16 activations end-to-end must get bf16 out
    kx, kw = jax.random.split(jax.random.PRNGKey(5))
    xj = jrng.rand_dense(kx, (8, 512)).astype(jnp.bfloat16)
    w = np.asarray(jrng.rand_ternary(kw, (512, 256)))
    x = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    kw_tile = {} if tile is None else dict(block_m=tile[0], block_n=tile[1])
    y = packed_spmm(x, pack_ternary(w, device=CPU), compute_dtype=torch.bfloat16, **kw_tile)
    assert y.dtype == torch.bfloat16
    ref = np.asarray(jgemm(xj.astype(jnp.float32), jnp.asarray(w)))
    err = float(np.abs(y.float().numpy() - ref).max())
    assert err < 0.25 * max(1.0, float(np.abs(ref).max()))
