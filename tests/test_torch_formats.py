"""Port parity: the TCSC, TCSCPadded, BCSR and legacy-threshold
constructors of smmb_tpu_torch.formats against smmb_tpu.formats.

Both packages build from the same numpy matrix (made from a seed) and must
give bitwise-equal int32 index arrays and float32 block values: these are
host scans with exact compares, so there is no tolerance. The port runs on
the CPU (``device="cpu"``).
"""

import jax
import numpy as np
import pytest
import torch

from smmb_tpu.formats import bcsr as jbcsr
from smmb_tpu.formats import legacy as jlegacy
from smmb_tpu.formats import tcsc as jtcsc
from smmb_tpu.utils import rng as jrng
from smmb_tpu_torch import convert
from smmb_tpu_torch.formats import bcsr as tbcsr
from smmb_tpu_torch.formats import legacy as tlegacy
from smmb_tpu_torch.formats import tcsc as ttcsc
from smmb_tpu_torch.formats.packed import unpack_ternary

torch.set_num_threads(2)
CPU = "cpu"


def _ternary(seed, shape, non_zero=2):
    rs = np.random.default_rng(seed)
    p = 1.0 / (2 * non_zero)
    return rs.choice(np.array([-1.0, 0.0, 1.0], np.float32), size=shape, p=[p, 1 - 2 * p, p])


def _equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


TCSC_ARRAYS = ("col_start_pos", "col_start_neg", "row_index_pos", "row_index_neg")
BCSR_ARRAYS = ("b_row_start", "b_col_idx", "b_values")


def _same_tcsc(t, j):
    for f in TCSC_ARRAYS:
        _equal(getattr(t, f), getattr(j, f))
    assert (t.rows, t.cols, t.n_pos, t.n_neg) == (j.rows, j.cols, j.n_pos, j.n_neg)


def _same_bcsr(m, j):
    for f in BCSR_ARRAYS:
        _equal(getattr(m, f), getattr(j, f))
    assert (m.rows, m.cols, m.r, m.c, m.br, m.bc, m.k) == (j.rows, j.cols, j.r, j.c,
                                                           j.br, j.bc, j.k)


# ---------------------------------------------------------------- TCSC


@pytest.mark.parametrize("shape,nz", [((64, 48), 2), ((100, 37), 8), ((8, 8), 1000)])
def test_tcsc_equal_jax_and_round_trip(shape, nz):
    w = _ternary(shape[0] + nz, shape, nz)
    t = ttcsc.tcsc_from_dense(w, device=CPU)
    _same_tcsc(t, jtcsc.tcsc_from_dense(w))
    _equal(ttcsc.tcsc_to_dense(t), w)
    assert t.n_pos == int((w == 1.0).sum()) and t.n_neg == int((w == -1.0).sum())
    assert t.index_bytes() == jtcsc.tcsc_from_dense(w).index_bytes()


def test_tcsc_known_pattern():
    w = np.zeros((4, 3), np.float32)
    w[0, 0], w[2, 0], w[1, 1], w[3, 1] = 1.0, -1.0, 1.0, 1.0
    t = ttcsc.tcsc_from_dense(w, device=CPU)
    _same_tcsc(t, jtcsc.tcsc_from_dense(w))
    _equal(t.col_start_pos, np.array([0, 1, 3, 3], np.int32))
    _equal(t.row_index_neg, np.array([2], np.int32))


def test_tcsc_ignores_non_unit_values():
    w = np.array([[0.5, -1.0], [1.0, 0.99]], np.float32)
    t = ttcsc.tcsc_from_dense(w, device=CPU)
    _same_tcsc(t, jtcsc.tcsc_from_dense(w))
    assert t.n_pos == 1 and t.n_neg == 1


@pytest.mark.parametrize("shape,multiple", [((32, 16), 8), ((40, 24), 4), ((8, 8), 8)])
def test_tcsc_padded_equal_jax(shape, multiple):
    w = _ternary(7, shape) if shape != (8, 8) else np.zeros(shape, np.float32)
    p = ttcsc.tcsc_pad_columns(ttcsc.tcsc_from_dense(w, device=CPU), multiple)
    j = jtcsc.tcsc_pad_columns(jtcsc.tcsc_from_dense(w), multiple)
    for f in ("idx_pos", "idx_neg", "cnt_pos", "cnt_neg"):
        _equal(getattr(p, f), getattr(j, f))
    assert (p.pad_pos, p.pad_neg) == (j.pad_pos, j.pad_neg) and p.pad_pos >= 1
    idx, cnt = p.idx_pos.numpy(), p.cnt_pos.numpy()
    for c in range(shape[1]):  # sentinel = rows past each column's count
        assert (idx[c, cnt[c]:] == shape[0]).all()


def test_tcsc_rejects_non_2d():
    with pytest.raises(ValueError):
        ttcsc.tcsc_from_dense(np.zeros(5, np.float32), device=CPU)


# ---------------------------------------------------------------- BCSR


@pytest.mark.parametrize("shape,r,c,nz", [
    ((4, 4), 2, 2, None), ((32, 64), 8, 8, 8), ((64, 256), 8, 128, 2),
    ((96, 80), 4, 4, 16), ((64, 64), 1, 8, 16),
])
def test_bcsr_equal_jax_and_round_trip(shape, r, c, nz):
    if nz is None:  # the reference's 4x4 structure test
        w = np.zeros(shape, np.float32)
        w[0, 0], w[3, 2] = 1.0, -1.0
    else:
        w = _ternary(r * c, shape, nz)
    m = tbcsr.bcsr_from_dense(w, r, c, device=CPU)
    j = jbcsr.bcsr_from_dense(w, r, c)
    _same_bcsr(m, j)
    _equal(tbcsr.bcsr_block_rows(m), jbcsr.bcsr_block_rows(j))
    _equal(tbcsr.bcsr_to_dense(m), w)
    assert m.nnz == j.nnz and m.value_bytes() == j.value_bytes()


def test_bcsr_zero_block_row():
    w = np.zeros((12, 8), np.float32)
    w[0, 0], w[9, 5] = 1.0, -1.0  # block row 1 (rows 4-7) all zero
    m = tbcsr.bcsr_from_dense(w, 4, 4, device=CPU)
    _same_bcsr(m, jbcsr.bcsr_from_dense(w, 4, 4))
    _equal(m.b_row_start, np.array([0, 1, 1, 2], np.int32))
    _equal(tbcsr.bcsr_block_rows(m), np.array([0, 2], np.int32))
    _equal(tbcsr.bcsr_to_dense(m), w)


def test_bcsr_empty_matrix_and_non_unit_values():
    m = tbcsr.bcsr_from_dense(np.zeros((16, 8), np.float32), 4, 4, device=CPU)
    assert m.k == 0 and tuple(m.b_values.shape) == (0, 4, 4)
    _same_bcsr(m, jbcsr.bcsr_from_dense(np.zeros((16, 8), np.float32), 4, 4))
    w = np.full((4, 4), 0.5, np.float32)  # no exact ±1: no block kept
    w[2, 2] = 2.0
    assert tbcsr.bcsr_from_dense(w, 2, 2, device=CPU).k == 0


@pytest.mark.parametrize("shape,r,c", [((10, 8), 4, 4), ((8, 10), 4, 4)])
def test_bcsr_shape_validation(shape, r, c):
    for build in (jbcsr.bcsr_from_dense,
                  lambda w, r, c: tbcsr.bcsr_from_dense(w, r, c, device=CPU)):
        with pytest.raises(ValueError):
            build(np.zeros(shape, np.float32), r, c)


def test_convert_from_jax_formats():
    w = _ternary(3, (64, 256))
    t = convert.tcsc_from_jax(jtcsc.tcsc_from_dense(w), device=CPU)
    _same_tcsc(t, jtcsc.tcsc_from_dense(w))
    m = convert.bcsr_from_jax(jbcsr.bcsr_from_dense(w, 8, 128), device=CPU)
    _same_bcsr(m, jbcsr.bcsr_from_dense(w, 8, 128))


# ------------------------------------------------- legacy threshold path


def test_threshold_construction_semantics():
    w = np.array([[5, -3, 0, 1], [-1, 2, -7, 0]], np.int32)
    expect = np.array([[1, -1, 0, 1], [-1, 1, -1, 0]], np.float32)
    _equal(tlegacy.ternarize_threshold(w), jlegacy.ternarize_threshold(w))
    _equal(tlegacy.ternarize_threshold(torch.from_numpy(w)), expect)
    _same_tcsc(tlegacy.tcsc_from_dense_threshold(w, device=CPU),
               jlegacy.tcsc_from_dense_threshold(w))
    _equal(unpack_ternary(tlegacy.pack_ternary_threshold(w, device=CPU)), expect)
    _same_bcsr(tlegacy.bcsr_from_dense_threshold(w, 1, 2, device=CPU),
               jlegacy.bcsr_from_dense_threshold(w, 1, 2))


def test_legacy_generator_threshold_round_trip():
    # the legacy generator's matrices are already ±1: both constructors agree
    w = np.asarray(jrng.ternary_uniform_windows(jax.random.PRNGKey(0), (64, 96), non_zero=4))
    a = ttcsc.tcsc_to_dense(ttcsc.tcsc_from_dense(w, device=CPU))
    b = ttcsc.tcsc_to_dense(tlegacy.tcsc_from_dense_threshold(w, device=CPU))
    assert torch.equal(a, b)
    _same_tcsc(tlegacy.tcsc_from_dense_threshold(w, device=CPU),
               jlegacy.tcsc_from_dense_threshold(w))
