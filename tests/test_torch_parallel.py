"""Port parity: the sharded SpMMs, the ring-overlapped column SpMM, the
sharded BCSR and the sharded MLP (smmb_tpu_torch.parallel, models.mlp)
against JAX's (smmb_tpu.parallel, models.mlp) — the twins of
tests/test_parallel.py.

The inputs are numpy arrays made from seeds. JAX runs its functions on the
8-device virtual CPU mesh of tests/conftest.py; the port runs each case on
a gloo world of CPU ranks of the same data × model shape, all cases in one
8-rank world started once for the file (tests/torch_parallel_ranks.py holds
the rank bodies; the ranks import no JAX). Each rank's blocks are gathered
to the whole array JAX returns. Tolerances are JAX's: TOL_DENSE for the
SpMMs, max(TOL_DENSE, 2e-5·max|ref|) for the MLP. JAX's HLO test of the
ring (one collective-permute a ring step, no all-gather) has no HLO here:
its twin counts the port's ring rounds, all-gathers and B1 calls.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from smmb_tpu.formats.bcsr import bcsr_from_dense as j_bcsr_from_dense
from smmb_tpu.formats.packed import pack_ternary as j_pack
from smmb_tpu.kernels.bcsr_spmm import bcsr_prepare as j_bcsr_prepare
from smmb_tpu.models import mlp as jmlp
from smmb_tpu.parallel import make_mesh as j_mesh
from smmb_tpu.parallel import (
    shard_bcsr_columns,
    shard_packed_columns,
    shard_packed_rows,
    sharded_bcsr_spmm,
    sharded_spmm_column,
    sharded_spmm_row,
)
from smmb_tpu.parallel.overlap import sharded_spmm_column_overlapped
from smmb_tpu.utils.compare import TOL_DENSE, assert_close
from smmb_tpu_torch.convert import packed_mlp_from_jax
from smmb_tpu_torch.formats.bcsr import bcsr_from_dense
from smmb_tpu_torch.parallel.mesh import run_world

torch.set_num_threads(2)

ALPHA = 0.2


def _setup(seed, m, k, n):
    rs = np.random.default_rng(seed)
    x = rs.uniform(-1, 1, (m, k)).astype(np.float32)
    w = rs.choice(np.array([-1.0, 0.0, 1.0], np.float32), (k, n), p=[0.25, 0.5, 0.25])
    b = rs.uniform(-1, 1, (n,)).astype(np.float32)
    return x, w, b


def _bcsr_setup(seed, m, dim, empty_last_quarter=False):
    # column-dependent block density, so the shards' block counts differ
    rs = np.random.default_rng(seed)
    bgrid = (dim // 128, dim // 128)
    mask = rs.uniform(0, 1, bgrid) < np.linspace(0.9, 0.1, bgrid[1])[None, :]
    if empty_last_quarter:
        mask[:, 3 * bgrid[1] // 4:] = False
    tern = rs.choice(np.array([-1.0, 0.0, 1.0], np.float32), (dim, dim), p=[0.25, 0.5, 0.25])
    wd = (tern * np.repeat(np.repeat(mask, 128, 0), 128, 1)).astype(np.float32)
    x = rs.uniform(-1, 1, (m, dim)).astype(np.float32)
    b = rs.uniform(-1, 1, (dim,)).astype(np.float32)
    return x, wd, b


def _mlp(seed, dims, batch):
    cfg = jmlp.TernaryMLPConfig(layer_dims=dims)
    rs = np.random.default_rng(seed)
    params = {"w": [rs.choice(np.array([-1.0, 0.0, 1.0], np.float32), (a, b),
                              p=[0.25, 0.5, 0.25]) for a, b in zip(dims[:-1], dims[1:])],
              "b": [rs.uniform(-1, 1, (b,)).astype(np.float32) for b in dims[1:]]}
    jpacked = jmlp.pack_mlp({k: [jnp.asarray(a) for a in v] for k, v in params.items()})
    x = rs.uniform(-1, 1, (batch, dims[0])).astype(np.float32)
    return cfg, jpacked, x


INPUTS = {
    "column": _setup(21, 16, 512, 1024),
    "row": _setup(22, 8, 4096, 256),
    "no_bias": _setup(23, 4, 512, 1024),
    "overlap": _setup(24, 8, 2048, 512),
    "overlap_counts": _setup(26, 8, 2048, 512),
    "overlap_bad": _setup(25, 4, 1024, 512),
    "bcsr": _bcsr_setup(31, 16, 1024),
    "bcsr_empty": _bcsr_setup(32, 8, 1024, empty_last_quarter=True),
    "bcsr_bad": _bcsr_setup(33, 8, 1152),
}
MLP = _mlp(0, (512, 2048, 512, 1024), 16)
MLP_ODD = _mlp(1, (512, 1024, 512, 1024), 8)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    path = tmp_path_factory.mktemp("parallel")
    inp = {k: v for k, v in INPUTS.items() if not k.startswith("bcsr")}
    for k in ("bcsr", "bcsr_empty"):
        x, wd, b = INPUTS[k]
        inp[k] = (x, bcsr_from_dense(wd, 128, 128, device="cpu"), b)
    inp["bcsr_bad"] = bcsr_from_dense(INPUTS["bcsr_bad"][1], 128, 128, device="cpu")
    inp["mlp"] = packed_mlp_from_jax(MLP[1], device="cpu")
    inp["mlp_x"] = MLP[2]
    inp["mlp_odd"] = packed_mlp_from_jax(MLP_ODD[1], device="cpu")
    inp["mlp_odd_x"] = MLP_ODD[2]
    inp["alpha"] = ALPHA
    torch.save(inp, path / "inputs.pt")
    return run_world(ranks.suite_parallel, 8, backend="gloo", device="cpu",
                     args=(str(path),))[0]


def _jax_column(key, data, model, alpha=ALPHA, bias=True, fn=sharded_spmm_column):
    x, w, b = INPUTS[key]
    mesh = j_mesh(data, model)
    p = shard_packed_columns(j_pack(w), mesh)
    return np.asarray(fn(jnp.asarray(x), p, jnp.asarray(b) if bias else None, mesh=mesh,
                         alpha=alpha if bias else None))


def test_mesh_shapes(port):
    assert port["mesh_2x4"] == (2, 4, 4)


@pytest.mark.parametrize("data,model", [(1, 8), (2, 4), (8, 1)])
def test_sharded_column_parity(port, data, model):
    want = _jax_column("column", data, model)
    assert_close(port[f"column_{data}x{model}"], want, TOL_DENSE, f"column {data}x{model}")


@pytest.mark.parametrize("data,model", [(1, 8), (2, 4)])
def test_sharded_row_parity(port, data, model):
    x, w, b = INPUTS["row"]
    mesh = j_mesh(data, model)
    p = shard_packed_rows(j_pack(w), mesh)
    want = np.asarray(sharded_spmm_row(jnp.asarray(x), p, jnp.asarray(b), mesh=mesh,
                                       alpha=ALPHA))
    assert_close(port[f"row_{data}x{model}"], want, TOL_DENSE, f"row {data}x{model}")


def test_sharded_no_bias(port):
    want = _jax_column("no_bias", 1, 8, bias=False)
    assert_close(port["column_no_bias"], want, TOL_DENSE, "column no-bias")


def test_shard_validation(port):
    assert port["shard_validation"] is True  # 100 cols: not a multiple of 8*128


def _jax_mlp(cfg, jpacked, x, data, model):
    mesh = j_mesh(data, model)
    return np.asarray(jmlp.mlp_forward_sharded(jmlp.shard_mlp(jpacked, mesh),
                                               jnp.asarray(x), cfg, mesh=mesh))


def test_mlp_sharded_matches_single(port):
    cfg, jpacked, x = MLP
    want = _jax_mlp(cfg, jpacked, x, 2, 4)
    tol = max(TOL_DENSE, 2e-5 * float(np.abs(want).max()))
    assert_close(port["mlp_2x4"], want, tol, "sharded MLP")


def test_mlp_sharded_odd_depth(port):
    cfg, jpacked, x = MLP_ODD
    want = _jax_mlp(cfg, jpacked, x, 1, 2)
    tol = max(TOL_DENSE, 2e-5 * float(np.abs(want).max()))
    assert_close(port["mlp_odd_1x2"], want, tol, "odd-depth sharded MLP")


def _jax_overlap(key):
    x, w, b = INPUTS[key]
    mesh = j_mesh(1, 4)
    p = shard_packed_columns(j_pack(w), mesh)
    # JAX takes the whole x and slices its K chunks by the in_specs
    return np.asarray(sharded_spmm_column_overlapped(jnp.asarray(x), p, jnp.asarray(b),
                                                     mesh=mesh, alpha=ALPHA))


def test_overlapped_column_parity(port):
    assert_close(port["overlap_1x4"], _jax_overlap("overlap"), TOL_DENSE, "overlapped column")


def test_overlapped_column_validation(port):
    assert port["overlap_validation"] is True  # K=1024: 2 groups, not /4


def test_overlapped_column_ring_counts(port):
    """Stand-in for JAX's HLO check: a model-4 ring issues model − 1 = 3
    send/recv rounds and no all-gather, each rank calls B1 on each of the
    4 chunks, and the result is JAX's."""
    y, rounds, gathers, b1_calls = port["overlap_counts"]
    assert rounds == 3 and gathers == 0 and b1_calls == 4
    assert_close(y, _jax_overlap("overlap_counts"), TOL_DENSE, "overlapped column (counted)")


def _jax_bcsr(key, data, model, alpha=ALPHA):
    x, wd, b = INPUTS[key]
    mesh = j_mesh(data, model)
    shards = shard_bcsr_columns(j_bcsr_prepare(j_bcsr_from_dense(wd, 128, 128)), mesh)
    return np.asarray(sharded_bcsr_spmm(jnp.asarray(x), shards, jnp.asarray(b), mesh=mesh,
                                        alpha=alpha))


@pytest.mark.parametrize("data,model", [(1, 4), (2, 4)])
def test_bcsr_sharded_column_parity(port, data, model):
    _, wd, _ = INPUTS["bcsr"]
    # ragged for real: the shards' stored-block counts differ
    has = np.abs(wd).reshape(8, 128, 8, 128).sum(axis=(1, 3)) > 0
    counts = has.reshape(8, model, 8 // model).sum(axis=(0, 2))
    assert counts.max() > counts.min()
    assert_close(port[f"bcsr_{data}x{model}"], _jax_bcsr("bcsr", data, model), TOL_DENSE,
                 f"bcsr column {data}x{model}")


def test_bcsr_sharded_empty_shard(port):
    assert_close(port["bcsr_empty"], _jax_bcsr("bcsr_empty", 1, 4), TOL_DENSE,
                 "bcsr empty shard")
    assert_close(port["bcsr_empty_no_alpha"], _jax_bcsr("bcsr_empty", 1, 4, None),
                 TOL_DENSE, "bcsr empty shard no alpha")


def test_bcsr_sharded_validation(port):
    assert port["bcsr_validation"] is True  # 9 block columns over 8 shards
