"""Port parity: smmb_tpu_torch.runtime.native against smmb_tpu.runtime.native.

The port compiles its own copy of ``converters.cpp`` into
``smmb_tpu_torch/_build/``; its native constructors, and their numpy
fallbacks, must give the bytes of JAX's native and numpy constructors on the
same numpy matrices (the twins of tests/test_runtime.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from smmb_tpu.formats.bcsr import bcsr_from_dense as j_bcsr
from smmb_tpu.formats.packed import pack_ternary as j_pack
from smmb_tpu.formats.tcsc import tcsc_from_dense as j_tcsc
from smmb_tpu.runtime import native as jnative
from smmb_tpu_torch.runtime import native as tnative

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def mode(request, monkeypatch):
    """The port's native library, or its numpy fallback (``_lib`` None);
    JAX's native library must build either way."""
    if not (jnative.native_available() and tnative.native_available()):
        pytest.skip("g++ toolchain unavailable")
    if request.param == "numpy":
        monkeypatch.setattr(tnative, "_lib", lambda: None)
    return request.param


both_modes = pytest.mark.parametrize("mode", ["native", "numpy"], indirect=True)


def _ternary(seed, shape, non_zero=2):
    p = 1.0 / (2 * non_zero)
    rs = np.random.default_rng(seed)
    return rs.choice(np.array([-1.0, 0.0, 1.0], np.float32), size=shape, p=[p, 1 - 2 * p, p])


def _code(path: Path) -> list:
    """The source's lines with ``//`` comments and trailing blanks cut."""
    return [re.sub(r"\s*//.*$", "", line).rstrip() for line in path.read_text().splitlines()]


def test_converters_source_matches_jax():
    mine = ROOT / "smmb_tpu_torch" / "runtime" / "csrc" / "converters.cpp"
    jax_src = ROOT / "smmb_tpu" / "runtime" / "csrc" / "converters.cpp"
    assert tnative.SRC == mine.resolve()
    assert _code(mine) == _code(jax_src)


@both_modes
def test_library_builds_in_the_port(mode):
    lib = tnative.library_path()
    assert lib.parent == ROOT / "smmb_tpu_torch" / "_build"
    assert lib.exists() and tnative.native_available() == (mode == "native")
    assert jnative._SO != str(lib)


@both_modes
def test_native_tcsc_matches_jax(mode):
    w = _ternary(0, (1000, 257))
    a, b = j_tcsc(w), jnative.tcsc_from_dense_native(w)
    t = tnative.tcsc_from_dense_native(w, device="cpu")
    assert (t.n_pos, t.n_neg, t.rows, t.cols) == (b.n_pos, b.n_neg, 1000, 257)
    for name in ("col_start_pos", "col_start_neg", "row_index_pos", "row_index_neg"):
        got = getattr(t, name)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(a, name)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(b, name)))


@both_modes
def test_native_pack_matches_jax(mode):
    w = _ternary(1, (700, 130))
    a, b = j_pack(w), jnative.pack_ternary_native(w)
    t = tnative.pack_ternary_native(w, device="cpu")
    assert t.nnz == a.nnz == b.nnz and (t.rows, t.cols) == (700, 130)
    assert t.data.dtype == torch.int8
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(a.data))
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(b.data))


@both_modes
def test_native_bcsr_matches_jax(mode):
    w = _ternary(2, (64, 96), non_zero=16)
    a, b = j_bcsr(w, 8, 8), jnative.bcsr_from_dense_native(w, 8, 8)
    t = tnative.bcsr_from_dense_native(w, 8, 8, device="cpu")
    assert t.k == a.k == b.k
    for name in ("b_row_start", "b_col_idx", "b_values"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(a, name)))
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(b, name)))
    with pytest.raises(ValueError, match="not divisible"):
        tnative.bcsr_from_dense_native(w[:60], 8, 8, device="cpu")


@both_modes
def test_native_bcsr_zero_block_row(mode):
    w = np.zeros((12, 8), np.float32)
    w[0, 0] = 1.0
    w[9, 5] = -1.0
    m = tnative.bcsr_from_dense_native(w, 4, 4, device="cpu")
    np.testing.assert_array_equal(m.b_row_start.numpy(), [0, 1, 1, 2])
    np.testing.assert_array_equal(
        m.b_row_start.numpy(), np.asarray(jnative.bcsr_from_dense_native(w, 4, 4).b_row_start))
