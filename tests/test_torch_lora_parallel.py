"""Port parity: LoRA adapters under tensor parallelism (smmb_tpu_torch.
parallel.tp_transformer carries ``*_lora`` entries with their bases' shards)
and the SP path's refusal of them, against JAX's — the twins of
tests/test_lora.py:106, 131, 165 — and RoPE through ``generate_tp``
(tests/test_rope.py:136).

JAX's packed LMs and adapters (``attach_lora``) are carried into the port
by convert.py; tokens are numpy arrays from seeds. JAX runs on the virtual
CPU mesh, the port on a gloo world of CPU ranks of the same data × model
shape, every case in one 4-rank world (tests/torch_parallel_ranks.py).
Tolerances, JAX's: the adapted TP forward within 2e-4·max(1, max|ref|) of
JAX's single-device adapted forward; tokens exactly against JAX's jitted
single-device ``generate``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from smmb_tpu.models.lm import TernaryLMConfig, generate, init_lm, lm_forward, pack_lm
from smmb_tpu.models.lora import attach_lora, init_lora_lm
from smmb_tpu_torch.convert import packed_lm_from_jax
from smmb_tpu_torch.parallel.mesh import run_world

torch.set_num_threads(2)

LM_KW = {
    "sp": dict(vocab=64, d_model=128, n_heads=2, d_ff=256, n_layers=2, max_len=32,
               n_kv_heads=1),
    "tp": dict(vocab=256, d_model=1024, n_heads=4, d_ff=1024, n_layers=2, max_len=32),
    "rope": dict(vocab=256, d_model=1024, n_heads=4, d_ff=1024, n_layers=1, max_len=32,
                 rope=True),
}
LMS = {k: TernaryLMConfig(**v) for k, v in LM_KW.items()}
ALL = ("wq", "wk", "wv", "wo", "w_up", "w_down")


def _adapted(seed, cfg, targets, wave, rank=4):
    packed = pack_lm(init_lm(jax.random.PRNGKey(seed), cfg))
    adapters = init_lora_lm(jax.random.PRNGKey(seed + 1), cfg, rank=rank, targets=targets)
    if wave is not None:  # non-zero B, so the adapters change the output
        adapters = jax.tree.map(
            lambda a: a + 0.05 * wave(jnp.arange(a.size, dtype=jnp.float32)).reshape(a.shape),
            adapters)
    return packed, attach_lora(packed, adapters)


SP_BASE, SP_MODEL = _adapted(9, LMS["sp"], ("wq", "wv"), None, rank=2)
FWD_BASE, FWD_MODEL = _adapted(30, LMS["tp"], ALL, jnp.sin)
_, GEN_MODEL = _adapted(33, LMS["tp"], ("wq", "wv", "wo", "w_down"), jnp.cos)
ROPE_LM = pack_lm(init_lm(jax.random.PRNGKey(95), LMS["rope"]))
X = {"fwd_toks": np.random.default_rng(32).integers(0, 256, (2, 8)).astype(np.int32),
     "gen_toks": np.random.default_rng(35).integers(0, 256, (2, 8)).astype(np.int32),
     "rope_toks": np.random.default_rng(96).integers(0, 256, (2, 8)).astype(np.int32)}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    path = tmp_path_factory.mktemp("lora_parallel")
    inp = {k: packed_lm_from_jax(v, device="cpu")
           for k, v in (("sp_model", SP_MODEL), ("fwd_model", FWD_MODEL),
                        ("gen_model", GEN_MODEL), ("rope_lm", ROPE_LM))}
    inp.update(X)
    inp["lm_cfgs"] = LM_KW
    torch.save(inp, path / "inputs.pt")
    return run_world(ranks.suite_lora_parallel, 4, backend="gloo", device="cpu",
                     args=(str(path),))[0]


def test_lora_rejected_on_sp_path(port):
    assert "sequence-parallel" in port["sp_rejects"]


def test_lora_tp_forward_matches_single(port):
    toks = jnp.asarray(X["fwd_toks"])
    ref = np.asarray(lm_forward(FWD_MODEL, toks, LMS["tp"], use_kernel=False))
    base = np.asarray(lm_forward(FWD_BASE, toks, LMS["tp"], use_kernel=False))
    assert np.max(np.abs(ref - base)) > 1e-3  # the adapters are live
    tol = 2e-4 * max(1.0, float(np.max(np.abs(ref))))
    assert np.max(np.abs(port["forward"] - ref)) < tol, np.max(np.abs(port["forward"] - ref))


def test_lora_tp_shards_follow_their_bases(port):
    """Column bases (wq, wk, wv, w_up): A whole, B's columns split; row
    bases (wo, w_down): A's rows split, B whole (rank 4, model = 2)."""
    assert port["shard_shapes"] == {
        "wq_lora": ((1024, 4), (4, 512)), "wk_lora": ((1024, 4), (4, 512)),
        "wv_lora": ((1024, 4), (4, 512)), "wo_lora": ((512, 4), (4, 1024)),
        "w_up_lora": ((1024, 4), (4, 512)), "w_down_lora": ((512, 4), (4, 1024))}


def _jgenerate(packed, toks, cfg):
    return np.asarray(jax.jit(lambda p, t: generate(p, t, cfg, steps=6, use_kernel=False))(
        packed, jnp.asarray(toks)))


def test_lora_tp_generate_matches_single(port):
    want = _jgenerate(GEN_MODEL, X["gen_toks"], LMS["tp"])
    np.testing.assert_array_equal(port["generate"], want)


def test_rope_tp_generate_matches_single(port):
    want = _jgenerate(ROPE_LM, X["rope_toks"], LMS["rope"])
    np.testing.assert_array_equal(port["rope_generate"], want)
