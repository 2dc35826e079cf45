"""Port parity: MoE blocks on the parallel paths — the TP-EP block
(smmb_tpu_torch.parallel.tp_moe), the MoE LM through ``generate_tp``, and
MoE blocks under sequence parallelism (parallel/sp_block.py) — against JAX's
(smmb_tpu.parallel.tp_moe, tp_transformer, sp_block): the twins of
tests/test_moe_lm.py:150, 160, 188, 209, 240, 264, 309, 331, 351; and the
collectives a call issues, counted by the port's mesh (``mesh.CALLS``).

JAX's packed trees are carried into the port by convert.py; inputs are
numpy arrays from seeds. JAX runs on the virtual CPU mesh, the port on a
gloo world of CPU ranks of the same data × model shape, every case in one
8-rank world (tests/torch_parallel_ranks.py). Tolerances, JAX's: blocks and
the SP LM within max(1e-4, 5e-5·max|ref|), the kernel path within
max(1e-3, 1e-4·max|ref|); tokens exactly. The TP-EP decode twin holds the
port's prefill and decode steps against JAX's jitted TP-EP forward at every
position (JAX's eager TP decode is slow on the CPU); the ``generate_tp``
twins hold tokens against JAX's jitted single-device ``generate`` and, with
``kv_quant``, against JAX's jitted ``generate_tp``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from smmb_tpu.models.lm import TernaryLMConfig, generate, init_lm, pack_lm
from smmb_tpu.models.moe import TernaryMoEConfig, init_moe, pack_moe
from smmb_tpu.models.moe_block import TernaryMoEBlockConfig, init_moe_block, pack_moe_block
from smmb_tpu.parallel import make_mesh
from smmb_tpu.parallel.sp_block import block_forward_sp, lm_forward_sp
from smmb_tpu.parallel.tp_moe import moe_block_forward_tp, shard_moe_block_tp
from smmb_tpu.parallel.tp_transformer import generate_tp, shard_lm_tp
from smmb_tpu_torch.convert import packed_lm_from_jax
from smmb_tpu_torch.parallel.mesh import run_world

torch.set_num_threads(2)
HI = jax.lax.Precision.HIGHEST

BLOCK_KW = {
    "sp": dict(d_model=512, n_heads=4, d_ff=512, n_experts=4, top_k=2, n_kv_heads=2,
               rope=True),
    "tpep": dict(d_model=1024, n_heads=4, d_ff=512, n_experts=4, top_k=2, n_kv_heads=2),
    "tpep_dec": dict(d_model=1024, n_heads=4, d_ff=512, n_experts=4, top_k=2, n_kv_heads=2,
                     rope=True),
    "tpep_k": dict(d_model=1024, n_heads=4, d_ff=512, n_experts=2),
    "lora": dict(d_model=1024, n_heads=4, d_ff=512, n_experts=2),
}
BLOCKS = {k: TernaryMoEBlockConfig(**v) for k, v in BLOCK_KW.items()}
LM_KW = {
    "sp": dict(vocab=128, d_model=512, n_heads=4, d_ff=512, n_layers=1, max_len=64,
               n_experts=4, top_k=2),
    "tp": dict(vocab=512, d_model=1024, n_heads=4, d_ff=512, n_layers=2, max_len=32,
               n_experts=2, top_k=1, n_kv_heads=2),
    "q": dict(vocab=512, d_model=1024, n_heads=4, d_ff=512, n_layers=1, max_len=32,
              n_experts=2, top_k=1),
}
LMS = {k: TernaryLMConfig(**v) for k, v in LM_KW.items()}
EP_KW = dict(d_model=128, d_ff=256, n_experts=4, top_k=2)


def _x(seed, shape, scale=0.1):
    return (np.random.default_rng(seed).uniform(-1, 1, shape) * scale).astype(np.float32)


def _toks(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _block(seed, key):
    return pack_moe_block(init_moe_block(jax.random.PRNGKey(seed), BLOCKS[key]))


def _lora_block():
    packed = _block(30, "lora")
    adapted = dict(packed)
    adapted["attn"] = dict(packed["attn"])
    adapted["attn"]["wq_lora"] = (jnp.zeros((1024, 2)), jnp.zeros((2, 1024)), jnp.float32(1.0))
    return adapted


J = {
    "sp_block": _block(15, "sp"),
    "tpep": _block(20, "tpep"),
    "tpep_k": _block(22, "tpep_k"),
    "tpep_dec": _block(40, "tpep_dec"),
    "lora_block": _lora_block(),
    "sp_lm": pack_lm(init_lm(jax.random.PRNGKey(17), LMS["sp"])),
    "lm_tp": pack_lm(init_lm(jax.random.PRNGKey(42), LMS["tp"])),
    "lm_q": pack_lm(init_lm(jax.random.PRNGKey(44), LMS["q"])),
    "ep_moe": pack_moe(init_moe(jax.random.PRNGKey(46), TernaryMoEConfig(**EP_KW))),
}
X = {
    "sp_x": _x(16, (2, 32, 512)),
    "sp_toks": _toks(18, (1, 32), LMS["sp"].vocab),
    "tpep_x": _x(21, (2, 6, 1024)),
    "tpep_k_x": _x(23, (1, 2, 1024)),
    "tpep_dec_x": _x(41, (2, 10, 1024)),
    "tp_toks": _toks(43, (2, 6), LMS["tp"].vocab),
    "q_toks": _toks(45, (2, 4), LMS["q"].vocab),
    "ep_x": _x(47, (32, 128), 0.5),
    "ring_q": _x(48, (1, 16, 2, 32), 0.5),
    "ring_k": _x(49, (1, 16, 2, 32), 0.5),
}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    path = tmp_path_factory.mktemp("moe_parallel")
    inp = {k: packed_lm_from_jax(v, device="cpu") for k, v in J.items()}
    inp.update(X)
    inp["block_cfgs"], inp["lm_cfgs"], inp["ep_cfg"] = BLOCK_KW, LM_KW, EP_KW
    torch.save(inp, path / "inputs.pt")
    return run_world(ranks.suite_moe_parallel, 8, backend="gloo", device="cpu",
                     args=(str(path),))[0]


def _mesh(data, model):
    return make_mesh(data, model, devices=jax.devices()[: data * model])


def _close(got, ref, rel=5e-5, floor=1e-4):
    ref = np.asarray(ref)
    tol = max(floor, rel * float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


def _jax_tpep(key, x_key, cfg, data, model, use_kernel=False):
    mesh = _mesh(data, model)
    kw = {} if use_kernel else {"precision": HI}
    return np.asarray(moe_block_forward_tp(shard_moe_block_tp(J[key], mesh),
                                           jnp.asarray(X[x_key]), cfg, mesh=mesh,
                                           use_kernel=use_kernel, **kw))


def test_moe_blocks_rejected_on_tp(port):
    assert "tensor-parallel" in port["tp_rejects_moe"]


def test_moe_block_sp_matches_single(port):
    want = np.asarray(block_forward_sp(J["sp_block"], jnp.asarray(X["sp_x"]), BLOCKS["sp"],
                                       mesh=_mesh(2, 4), use_kernel=False, precision=HI))
    _close(port["sp_block"], want)


def test_moe_lm_sp_forward_matches_single(port):
    want = np.asarray(lm_forward_sp(J["sp_lm"], jnp.asarray(X["sp_toks"]), LMS["sp"],
                                    mesh=_mesh(1, 8), use_kernel=False, precision=HI))
    _close(port["sp_lm"], want)


def test_moe_block_tp_ep_matches_single(port):
    _close(port["tpep"], _jax_tpep("tpep", "tpep_x", BLOCKS["tpep"], 2, 2))


def test_moe_block_tp_ep_kernel_path(port):
    _close(port["tpep_kernel"], _jax_tpep("tpep_k", "tpep_k_x", BLOCKS["tpep_k"], 1, 2, True),
           rel=1e-4, floor=1e-3)


def test_moe_block_tp_ep_decode_matches_forward(port):
    _close(port["tpep_decode"], _jax_tpep("tpep_dec", "tpep_dec_x", BLOCKS["tpep_dec"], 2, 2))


_jgenerate = jax.jit(lambda p, t: generate(p, t, LMS["tp"], steps=5, use_kernel=False))


def test_moe_lm_generate_tp_matches_single(port):
    want = np.asarray(_jgenerate(J["lm_tp"], jnp.asarray(X["tp_toks"])))
    np.testing.assert_array_equal(port["generate_tp"], want)


def test_moe_lm_generate_tp_kv_quant_runs(port):
    got = port["generate_tp_kv_quant"]
    assert got.shape == (2, 4)
    assert np.all((got >= 0) & (got < LMS["q"].vocab))
    mesh = _mesh(1, 2)
    want = np.asarray(generate_tp(shard_lm_tp(J["lm_q"], mesh), jnp.asarray(X["q_toks"]),
                                  LMS["q"], 4, mesh=mesh, use_kernel=False, kv_quant=True))
    np.testing.assert_array_equal(got, want)


def test_moe_lm_ragged_prompt_rejected_on_tp(port):
    assert port["tp_ragged_moe"] == "ragged prompt_mask is supported for dense TP blocks only"


def test_tp_ep_rejects_lora(port):
    shard_err, forward_err = port["tpep_lora"]
    assert "TP-EP" in shard_err and "TP-EP" in forward_err


def test_ep_issues_one_all_reduce(port):
    assert port["counts"]["ep"] == {"all_reduce model": 1}


def test_tp_ep_block_issues_two_all_reduces(port):
    assert port["counts"]["tpep_block"] == {"all_reduce model": 2}


@pytest.mark.parametrize("case,s", [("counts", 2), ("counts_ring_1x4", 4)])
def test_ring_issues_s_minus_one_shifts(port, case, s):
    got = port[case]["ring"] if case == "counts" else port[case]
    assert got == {"ring_shift model": s - 1}  # and no all_gather
