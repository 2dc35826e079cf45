"""Port parity: the expert-parallel MoE layer (smmb_tpu_torch.parallel.ep_moe)
against JAX's (smmb_tpu.parallel.ep_moe) — the twins of tests/test_moe.py:96,
138, 197.

JAX's packed experts are carried into the port by convert.py; tokens are
numpy arrays from seeds. JAX runs on the virtual CPU mesh, the port on a
gloo world of CPU ranks of the same data × model shape, every case in one
8-rank world (tests/torch_parallel_ranks.py). Tolerance: JAX's 2e-4
absolute. With data = 1 a rank routes the same tokens as one rank does, and
the EP sum over the model line is the single-rank ``moe_forward``'s bit for
bit (at most two non-zero terms a token): held exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from smmb_tpu.models.moe import TernaryMoEConfig, init_moe, moe_forward, pack_moe
from smmb_tpu.parallel import make_mesh
from smmb_tpu.parallel.ep_moe import moe_forward_ep, shard_moe_ep
from smmb_tpu_torch.convert import packed_lm_from_jax
from smmb_tpu_torch.parallel.mesh import run_world

torch.set_num_threads(2)

CFG_KW = dict(d_model=128, d_ff=256, n_experts=4, capacity_factor=4.0)
CFG = TernaryMoEConfig(**CFG_KW)
TOP2_KW = dict(d_model=128, d_ff=256, n_experts=8, top_k=2)
TOP2 = TernaryMoEConfig(**TOP2_KW)
MOE = pack_moe(init_moe(jax.random.PRNGKey(11), CFG))
MOE_TOP2 = pack_moe(init_moe(jax.random.PRNGKey(42), TOP2))


def _x(seed, shape):
    return (np.random.default_rng(seed).uniform(-1, 1, shape) * 0.5).astype(np.float32)


X = _x(12, (32, 128))
X_TOP2 = _x(43, (32, 128))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    path = tmp_path_factory.mktemp("ep")
    torch.save({"moe": packed_lm_from_jax(MOE, device="cpu"),
                "moe_top2": packed_lm_from_jax(MOE_TOP2, device="cpu"),
                "x": X, "x_top2": X_TOP2, "cfg": CFG_KW, "cfg_top2": TOP2_KW},
               path / "inputs.pt")
    return run_world(ranks.suite_ep, 8, backend="gloo", device="cpu", args=(str(path),))[0]


def _jax_ep(packed, x, cfg, data, model):
    mesh = make_mesh(data, model, devices=jax.devices()[: data * model])
    return np.asarray(moe_forward_ep(shard_moe_ep(packed, mesh), jnp.asarray(x), cfg, mesh=mesh,
                                     use_kernel=False))


@pytest.mark.parametrize("data,model", [(1, 2), (1, 4), (2, 2)])
def test_moe_ep_matches_single(port, data, model):
    want = _jax_ep(MOE, X, CFG, data, model)
    np.testing.assert_allclose(port[f"ep_{data}x{model}"], want, atol=2e-4, rtol=0)
    single = np.asarray(moe_forward(MOE, jnp.asarray(X), CFG, use_kernel=False))
    np.testing.assert_allclose(port[f"ep_{data}x{model}"], single, atol=2e-4, rtol=0)


def test_moe_ep_rejects_uneven_experts(port):
    assert port["ep_uneven"] == "n_experts=4 % model=8 != 0"


def test_moe_top2_ep_matches_single(port):
    want = _jax_ep(MOE_TOP2, X_TOP2, TOP2, 2, 4)
    np.testing.assert_allclose(port["ep_top2_2x4"], want, atol=2e-4, rtol=0)


@pytest.mark.parametrize("case", ["ep_bitwise_top1", "ep_bitwise_top2"])
def test_moe_ep_bitwise_single_rank(port, case):
    """data = 1: the EP forward is the port's single-rank ``moe_forward``
    bit for bit (top-1 on 4 ranks, top-2 on 8)."""
    assert port[case] is True
