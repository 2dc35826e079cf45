"""Port parity: the pipeline-parallel LM forward
(smmb_tpu_torch.parallel.pp_lm) against JAX's (smmb_tpu.parallel.pp_lm) —
the twins of tests/test_pp.py:37,48,59.

JAX's LM weights are carried into the port by convert.py; tokens are numpy
arrays from seeds. JAX runs on the virtual CPU mesh, the port on a gloo
world of CPU ranks of the same data × model shape, every case in one
4-rank world (tests/torch_parallel_ranks.py). Tolerance: JAX's
max(TOL_DENSE, 2e-5·max|ref|). The MoE LM under PP (tests/test_pp.py:66)
belongs to the next slice of the port.
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


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    path = tmp_path_factory.mktemp("pp")
    torch.save({"lm": packed_lm_from_jax(LM, device="cpu"),
                "lm_k": packed_lm_from_jax(LM_K, device="cpu"),
                "toks": TOKS, "toks_k": TOKS_K, "cfg": CFG_KW}, path / "inputs.pt")
    return run_world(ranks.suite_pp, 4, backend="gloo", device="cpu", args=(str(path),))[0]


def _assert_scaled(y, ref, what):
    tol = max(TOL_DENSE, 2e-5 * float(np.abs(np.asarray(ref)).max()))
    assert_close(y, ref, tol, what)


def _jax_pp(packed, toks, data, model, u, use_kernel):
    mesh = make_mesh(data, model, devices=jax.devices()[: data * model])
    return np.asarray(lm_forward_pp(shard_lm_pp(packed, mesh), jnp.asarray(toks), CFG,
                                    mesh=mesh, microbatches=u, use_kernel=use_kernel))


@pytest.mark.parametrize("data,model,u", [(1, 2, 2), (2, 2, 2), (1, 2, 4)])
def test_pp_matches_single(port, data, model, u):
    _assert_scaled(port[f"pp_{data}x{model}_u{u}"], _jax_pp(LM, TOKS, data, model, u, False),
                   f"pp {data}x{model} u={u}")


def test_pp_kernel_path(port):
    _assert_scaled(port["pp_kernel"], _jax_pp(LM_K, TOKS_K, 1, 2, 2, True), "pp kernel")


def test_pp_rejects_uneven_layers(port):
    assert port["pp_uneven"] is True  # n_layers=2 over 4 stages
