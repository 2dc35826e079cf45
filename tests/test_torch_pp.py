"""Port parity: the pipeline-parallel LM forward
(smmb_tpu_torch.parallel.pp_lm) against JAX's (smmb_tpu.parallel.pp_lm) —
the twins of tests/test_pp.py:37,48,59,66.

JAX's LM weights are carried into the port by convert.py; tokens are numpy
arrays from seeds. JAX runs on the virtual CPU mesh, the port on a gloo
world of CPU ranks of the same data × model shape, every case in one
4-rank world (tests/torch_parallel_ranks.py). Tolerance: JAX's
max(TOL_DENSE, 2e-5·max|ref|); the MoE LM under PP (tests/test_pp.py:66)
JAX's max(1e-4, 5e-5·max|ref|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from smmb_tpu.models.lm import TernaryLMConfig, init_lm, pack_lm
from smmb_tpu.parallel import make_mesh
from smmb_tpu.parallel.pp_lm import lm_forward_pp, shard_lm_pp
from smmb_tpu.utils.compare import TOL_DENSE, assert_close
from smmb_tpu_torch.convert import packed_lm_from_jax
from smmb_tpu_torch.parallel.mesh import run_world

torch.set_num_threads(2)

CFG_KW = dict(vocab=512, d_model=256, n_heads=4, d_ff=512, n_layers=2, max_len=32)
CFG = TernaryLMConfig(**CFG_KW)
LM = pack_lm(init_lm(jax.random.PRNGKey(61), CFG))
LM_K = pack_lm(init_lm(jax.random.PRNGKey(71), CFG))
TOKS = np.random.default_rng(62).integers(0, CFG.vocab, (4, 6)).astype(np.int32)
TOKS_K = np.random.default_rng(72).integers(0, CFG.vocab, (2, 2)).astype(np.int32)
MOE_KW = dict(vocab=64, d_model=128, n_heads=2, d_ff=128, n_layers=2, max_len=16,
              n_experts=4, top_k=2)
MOE_CFG = TernaryLMConfig(**MOE_KW)
LM_MOE = pack_lm(init_lm(jax.random.PRNGKey(70), MOE_CFG))
TOKS_MOE = np.random.default_rng(71).integers(0, MOE_CFG.vocab, (4, 8)).astype(np.int32)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    path = tmp_path_factory.mktemp("pp")
    torch.save({"lm": packed_lm_from_jax(LM, device="cpu"),
                "lm_k": packed_lm_from_jax(LM_K, device="cpu"),
                "lm_moe": packed_lm_from_jax(LM_MOE, device="cpu"),
                "toks": TOKS, "toks_k": TOKS_K, "toks_moe": TOKS_MOE, "cfg": CFG_KW,
                "moe_cfg": MOE_KW}, path / "inputs.pt")
    return run_world(ranks.suite_pp, 4, backend="gloo", device="cpu", args=(str(path),))[0]


def _assert_scaled(y, ref, what):
    tol = max(TOL_DENSE, 2e-5 * float(np.abs(np.asarray(ref)).max()))
    assert_close(y, ref, tol, what)


def _jax_pp(packed, toks, data, model, u, use_kernel, cfg=CFG, **kw):
    mesh = make_mesh(data, model, devices=jax.devices()[: data * model])
    return np.asarray(lm_forward_pp(shard_lm_pp(packed, mesh), jnp.asarray(toks), cfg,
                                    mesh=mesh, microbatches=u, use_kernel=use_kernel, **kw))


@pytest.mark.parametrize("data,model,u", [(1, 2, 2), (2, 2, 2), (1, 2, 4)])
def test_pp_matches_single(port, data, model, u):
    _assert_scaled(port[f"pp_{data}x{model}_u{u}"], _jax_pp(LM, TOKS, data, model, u, False),
                   f"pp {data}x{model} u={u}")


def test_pp_kernel_path(port):
    _assert_scaled(port["pp_kernel"], _jax_pp(LM_K, TOKS_K, 1, 2, 2, True), "pp kernel")


def test_pp_rejects_uneven_layers(port):
    assert port["pp_uneven"] is True  # n_layers=2 over 4 stages


def test_pp_moe_lm_matches_single(port):
    want = _jax_pp(LM_MOE, TOKS_MOE, 1, 2, 2, False, MOE_CFG,
                   precision=jax.lax.Precision.HIGHEST)
    tol = max(1e-4, 5e-5 * float(np.abs(want).max()))
    assert_close(port["pp_moe"], want, tol, "pp moe")
