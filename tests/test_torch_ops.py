"""Port parity: utils, dense oracles, the plain packed SpMM and the bench
helpers of smmb_tpu_torch against their smmb_tpu counterparts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smmb_tpu.bench import flops as jflops
from smmb_tpu.formats.packed import pack_ternary as jpack
from smmb_tpu.ops import dense as jdense
from smmb_tpu.ops.spmm import packed_spmm_jnp
from smmb_tpu.utils import compare as jcompare
from smmb_tpu.utils.shapes import round_up as jround_up
from smmb_tpu_torch.bench import flops as tflops
from smmb_tpu_torch.bench.measure import measure
from smmb_tpu_torch.bench import roofline as troofline
from smmb_tpu_torch.formats.packed import pack_ternary
from smmb_tpu_torch.ops import dense as tdense
from smmb_tpu_torch.ops.spmm import packed_spmm_ref
from smmb_tpu_torch.utils import compare as tcompare
from smmb_tpu_torch.utils import rng
from smmb_tpu_torch.utils.shapes import round_up

torch.set_num_threads(2)
ALPHA = 0.2


def _inputs(seed, m, k, n, non_zero=2):
    rs = np.random.default_rng(seed)
    x = rs.uniform(-1, 1, (m, k)).astype(np.float32)
    p = 1.0 / (2 * non_zero)
    w = rs.choice(np.array([-1.0, 0.0, 1.0], np.float32), size=(k, n),
                  p=[p, 1 - 2 * p, p])
    b = rs.uniform(-1, 1, (n,)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("x,m", [(0, 8), (1, 8), (8, 8), (9, 512), (513, 512)])
def test_round_up_equal_jax(x, m):
    assert round_up(x, m) == jround_up(x, m)


@pytest.mark.parametrize("tol", [jcompare.TOL_DENSE, jcompare.TOL_LEGACY])
def test_compare_equal_jax(tol):
    a = np.linspace(-1, 1, 50, dtype=np.float32)
    b = a.copy()
    b[17] += 3 * tol
    b[30] += 0.5 * tol
    assert (tcompare.TOL_DENSE, tcompare.TOL_LEGACY) == (
        jcompare.TOL_DENSE, jcompare.TOL_LEGACY)
    for lhs, rhs in ((a, a), (a, b), (a, b[:10])):
        want = jcompare.compare(lhs, rhs, tol)
        got = tcompare.compare(torch.from_numpy(lhs), rhs, tol)
        assert (got.ok, got.first_mismatch) == (want.ok, want.first_mismatch)
        assert got.max_abs_err == want.max_abs_err
    with pytest.raises(AssertionError, match="flat index 17"):
        tcompare.assert_close(a, b, tol, "x")


def test_rand_dense_distribution():
    gen = rng.make_generator(0, "cpu")
    x = rng.rand_dense(gen, (200, 100))
    assert x.dtype == torch.float32 and x.shape == (200, 100)
    assert float(x.min()) >= -1.0 and float(x.max()) < 1.0
    assert abs(float(x.mean())) < 0.02
    assert rng.rand_dense(gen, (4,), dtype=torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("non_zero", [2, 10])
def test_rand_ternary_distribution(non_zero):
    gen = rng.make_generator(1, "cpu")
    w = rng.rand_ternary(gen, (400, 250), non_zero=non_zero)
    vals, counts = np.unique(w.numpy(), return_counts=True)
    assert set(vals) <= {-1.0, 0.0, 1.0}
    density = 1.0 - counts[vals == 0.0][0] / w.numel()
    assert density == pytest.approx(1.0 / non_zero, abs=0.01)
    # same seed, same numbers
    again = rng.rand_ternary(rng.make_generator(1, "cpu"), (400, 250), non_zero)
    assert torch.equal(w, again)


def test_dense_oracles_equal_jax():
    x, w, b = _inputs(0, 16, 300, 64)
    y = np.asarray(jdense.gemm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    tcompare.assert_close(tdense.gemm(tx, tw, tb), y, tcompare.TOL_DENSE, "gemm")
    yp = np.asarray(jdense.gemm_prelu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), ALPHA))
    tcompare.assert_close(tdense.gemm_prelu(tx, tw, tb, ALPHA), yp,
                          tcompare.TOL_DENSE, "gemm_prelu")
    no_bias = np.asarray(jdense.gemm(jnp.asarray(x), jnp.asarray(w)))
    tcompare.assert_close(tdense.gemm(tx, tw), no_bias, tcompare.TOL_DENSE)
    v = np.array([-2.0, -0.0, 0.0, 3.0], np.float32)
    np.testing.assert_array_equal(
        tdense.prelu(torch.from_numpy(v), ALPHA).numpy(),
        np.asarray(jdense.prelu(jnp.asarray(v), ALPHA)),
    )


@pytest.mark.parametrize("m,k,n", [(8, 1024, 640), (5, 100, 256), (1, 512, 128)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_packed_spmm_ref_equal_jnp(m, k, n, dtype):
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    x, w, b = _inputs(m + k, m, k, n)
    jp = jpack(w)
    p = pack_ternary(w, device="cpu")
    tx, tb = torch.from_numpy(x), torch.from_numpy(b)
    for bias, alpha in ((b, ALPHA), (None, None), (b, None)):
        want = np.asarray(packed_spmm_jnp(
            jnp.asarray(x), jp, None if bias is None else jnp.asarray(bias),
            alpha, dtype=jdt))
        got = packed_spmm_ref(tx, p, None if bias is None else tb, alpha, dtype=tdt)
        assert got.dtype == torch.float32
        # bf16: both cast X identically and sum exactly-decoded W in f32
        tcompare.assert_close(got, want, tcompare.TOL_DENSE, f"ref {dtype}")


def test_packed_spmm_ref_nd_input():
    x, w, b = _inputs(3, 12, 512, 256)
    x3 = x.reshape(3, 4, 512)
    want = np.asarray(packed_spmm_jnp(jnp.asarray(x3), jpack(w), jnp.asarray(b), ALPHA))
    got = packed_spmm_ref(torch.from_numpy(x3), pack_ternary(w, device="cpu"),
                          torch.from_numpy(b), ALPHA)
    assert got.shape == (3, 4, 256)
    tcompare.assert_close(got, want, tcompare.TOL_DENSE, "3-D ref")


def test_packed_spmm_ref_keeps_x_dtype():
    x, w, _ = _inputs(4, 4, 512, 128)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y = packed_spmm_ref(xb, pack_ternary(w, device="cpu"), dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16


@pytest.mark.parametrize("m,n,k,nnz", [(256, 4096, 4096, 1677721), (1, 640, 100, 7)])
def test_flops_equal_jax(m, n, k, nnz):
    assert tflops.dense_flops(m, n, k) == jflops.dense_flops(m, n, k)
    assert tflops.sparse_flops(m, n, nnz) == jflops.sparse_flops(m, n, nnz)
    for kw in ({}, {"x_itemsize": 2, "y_itemsize": 2, "bias": False}):
        assert tflops.spmm_bytes(m, n, k, weight_bytes=nnz, **kw) == \
            jflops.spmm_bytes(m, n, k, weight_bytes=nnz, **kw)


@pytest.mark.parametrize(
    "name,want",
    [("NVIDIA H100 80GB HBM3", "NVIDIA H100 SXM"),
     ("NVIDIA H100 SXM5 80GB", "NVIDIA H100 SXM"),
     ("NVIDIA H100 PCIe", "NVIDIA H100 PCIe")],
)
def test_chip_spec_by_name(name, want):
    assert troofline.chip_spec(name).name == want


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB", "NVIDIA H100 NVL", "cpu"])
def test_chip_spec_unknown_raises(name):
    with pytest.raises(ValueError):
        troofline.chip_spec(name)


def test_roofline_bound():
    spec = troofline.chip_spec("NVIDIA H100 80GB HBM3")
    # headline bf16, dense count: 8.6 GFLOP at 989 TFLOP/s
    t, by = troofline.roofline_bound(2.0 * 256 * 4096 * 4096, 12e6, spec, "bf16")
    assert by == "operations" and t == pytest.approx(8.69e-6, rel=1e-2)
    t, by = troofline.roofline_bound(1e6, 12e6, spec, "int8")
    assert by == "bytes" and t == pytest.approx(12e6 / 3.35e12)
    # f32 parity mode is bounded by the CUDA-core f32 rate (no TF32)
    t, by = troofline.roofline_bound(2.0 * 256 * 4096 * 4096, 12e6, spec, "f32")
    assert by == "operations" and t == pytest.approx(128.2e-6, rel=1e-2)


def test_measure_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        measure(lambda: None)
