"""Port parity: sequence-parallel ring attention and the SP block and LM
(smmb_tpu_torch.parallel.ring_attention, sp_block) against JAX's
(smmb_tpu.parallel.ring_attention, sp_block) — the twins of
tests/test_ring.py (all of it), tests/test_rope.py:153 and
tests/test_window.py:154.

Inputs are numpy arrays from seeds and JAX's packed weights carried over by
convert.py. JAX runs on the virtual CPU mesh, the port on a gloo world of
CPU ranks of the same data × model shape, every case in one 8-rank world
(tests/torch_parallel_ranks.py); each rank holds its T/model chunk
(``local_seq``). Tolerances, JAX's: the ring 2e-5 absolute, the SP
attention layer max(2e-4, 2e-5·max|ref|), SP blocks and the SP LM
max(1e-4, 5e-5·max|ref|), the kernel path max(1e-3, 1e-4·max|ref|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from smmb_tpu.models.attention import (
    TernaryAttentionConfig,
    _attention_math,
    init_attention,
    pack_attention,
)
from smmb_tpu.models.lm import TernaryLMConfig, init_lm, pack_lm
from smmb_tpu.models.transformer import TernaryBlockConfig, init_block, pack_block
from smmb_tpu.parallel import make_mesh
from smmb_tpu.parallel.ring_attention import attention_forward_sp, ring_attention
from smmb_tpu.parallel.sp_block import block_forward_sp, lm_forward_sp
from smmb_tpu_torch.convert import packed_lm_from_jax
from smmb_tpu_torch.parallel.mesh import run_world

torch.set_num_threads(2)
HI = jax.lax.Precision.HIGHEST

ATTN_KW = {"attn_gqa": dict(d_model=256, n_heads=4, n_kv_heads=2),
           "attn": dict(d_model=256, n_heads=4)}
BLOCK_KW = {"block": dict(d_model=512, n_heads=4, d_ff=512, n_kv_heads=2),
            "block_rope": dict(d_model=512, n_heads=4, d_ff=512, rope=True),
            "block_window": dict(d_model=512, n_heads=4, d_ff=512, window=6, rope=True)}
LM_KW = {"lm": dict(vocab=128, d_model=512, n_heads=4, d_ff=512, n_layers=2, max_len=64,
                    n_kv_heads=2),
         "lm_k": dict(vocab=128, d_model=512, n_heads=4, d_ff=512, n_layers=1, max_len=32)}


def _x(seed, shape, scale):
    return (np.random.default_rng(seed).uniform(-1, 1, shape) * scale).astype(np.float32)


def _qkv(seed, b, t, h, kvh, hd):
    return [_x(seed + i, (b, t, n, hd), 0.5) for i, n in enumerate((h, kvh, kvh))]


J = {
    "attn_gqa": pack_attention(init_attention(jax.random.PRNGKey(31),
                                              TernaryAttentionConfig(**ATTN_KW["attn_gqa"]))),
    "attn": pack_attention(init_attention(jax.random.PRNGKey(21),
                                          TernaryAttentionConfig(**ATTN_KW["attn"]))),
    "block": pack_block(init_block(jax.random.PRNGKey(60),
                                   TernaryBlockConfig(**BLOCK_KW["block"]))),
    "block_rope": pack_block(init_block(jax.random.PRNGKey(97),
                                        TernaryBlockConfig(**BLOCK_KW["block_rope"]))),
    "block_window": pack_block(init_block(jax.random.PRNGKey(10),
                                          TernaryBlockConfig(**BLOCK_KW["block_window"]))),
    "lm": pack_lm(init_lm(jax.random.PRNGKey(64), TernaryLMConfig(**LM_KW["lm"]))),
    "lm_k": pack_lm(init_lm(jax.random.PRNGKey(66), TernaryLMConfig(**LM_KW["lm_k"]))),
}
X = {
    "qkv": _qkv(7, 2, 16, 2, 2, 32),
    "qkv_1": _qkv(9, 1, 8, 2, 2, 16),
    "qkv_gqa": _qkv(17, 2, 16, 8, 2, 16),
    "attn_gqa_x": _x(32, (2, 8, 256), 0.5),
    "attn_x": _x(22, (2, 8, 256), 0.5),
    "block_x": _x(61, (2, 32, 512), 0.1),
    "block_rope_x": _x(98, (2, 32, 512), 0.1),
    "block_window_x": _x(11, (2, 32, 512), 0.1),
    "ragged_x": _x(63, (1, 30, 512), 1.0),
    "lm_toks": np.random.default_rng(65).integers(0, 128, (2, 32)).astype(np.int32),
    "lm_k_toks": np.random.default_rng(67).integers(0, 128, (1, 16)).astype(np.int32),
}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    path = tmp_path_factory.mktemp("ring")
    inp = {k: packed_lm_from_jax(v, device="cpu") for k, v in J.items()}
    inp.update(X)
    inp["attn_cfgs"], inp["block_cfgs"], inp["lm_cfgs"] = ATTN_KW, BLOCK_KW, LM_KW
    torch.save(inp, path / "inputs.pt")
    return run_world(ranks.suite_ring, 8, backend="gloo", device="cpu", args=(str(path),))[0]


def _mesh(data, model):
    return make_mesh(data, model, devices=jax.devices()[: data * model])


def _close(got, ref, rel, floor):
    ref = np.asarray(ref)
    tol = max(floor, rel * float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


def _jax_ring(key, causal, data, model):
    q, k, v = (jnp.asarray(a) for a in X[key])
    b, t, h, hd = q.shape
    got = np.asarray(ring_attention(q, k, v, mesh=_mesh(data, model), causal=causal,
                                    precision=HI))
    cfg = TernaryAttentionConfig(d_model=h * hd, n_heads=h, causal=causal,
                                 n_kv_heads=k.shape[2])
    full = np.asarray(_attention_math(q.reshape(b, t, -1), k.reshape(b, t, -1),
                                      v.reshape(b, t, -1), cfg, precision=HI))
    return got, full


@pytest.mark.parametrize("data,model", [(1, 2), (1, 4), (2, 4)])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_full(port, data, model, causal):
    want, full = _jax_ring("qkv", causal, data, model)
    got = port[f"ring_{data}x{model}_{causal}"]
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.reshape(full.shape), full, atol=2e-5, rtol=0)


def test_ring_single_ring_degenerate(port):
    want, full = _jax_ring("qkv_1", True, 1, 1)
    np.testing.assert_allclose(port["ring_1x1"], want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(port["ring_1x1"].reshape(full.shape), full, atol=2e-5, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_gqa_matches_full(port, causal):
    want, full = _jax_ring("qkv_gqa", causal, 1, 4)
    got = port[f"ring_gqa_{causal}"]
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.reshape(full.shape), full, atol=2e-5, rtol=0)


def _jax_attn(key, x_key):
    return np.asarray(attention_forward_sp(J[key], jnp.asarray(X[x_key]),
                                           TernaryAttentionConfig(**ATTN_KW[key]),
                                           mesh=_mesh(2, 2), use_kernel=False, precision=HI))


def test_attention_forward_sp_gqa_matches_single(port):
    _close(port["attn_gqa"], _jax_attn("attn_gqa", "attn_gqa_x"), 2e-5, 2e-4)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_attention_forward_sp_matches_single(port, use_kernel):
    _close(port[f"attn_{use_kernel}"], _jax_attn("attn", "attn_x"), 2e-5, 2e-4)


def _jax_block(key):
    return np.asarray(block_forward_sp(J[key], jnp.asarray(X[key + "_x"]),
                                       TernaryBlockConfig(**BLOCK_KW[key]), mesh=_mesh(2, 4),
                                       use_kernel=False, precision=HI))


@pytest.mark.parametrize("key", ["block", "block_rope", "block_window"])
def test_block_forward_sp_matches_single(port, key):
    """``block`` is tests/test_ring.py:123's case, ``block_rope``
    tests/test_rope.py:153's and ``block_window`` tests/test_window.py:154's."""
    _close(port[key], _jax_block(key), 5e-5, 1e-4)


def test_block_forward_sp_rejects_ragged_t(port):
    assert port["ragged_t"] == "T=30 % model=8 != 0"


def test_lm_forward_sp_matches_single(port):
    want = np.asarray(lm_forward_sp(J["lm"], jnp.asarray(X["lm_toks"]),
                                    TernaryLMConfig(**LM_KW["lm"]), mesh=_mesh(1, 8),
                                    use_kernel=False, precision=HI))
    _close(port["lm"], want, 5e-5, 1e-4)


def test_lm_forward_sp_kernel_path(port):
    want = np.asarray(lm_forward_sp(J["lm_k"], jnp.asarray(X["lm_k_toks"]),
                                    TernaryLMConfig(**LM_KW["lm_k"]), mesh=_mesh(1, 4),
                                    use_kernel=True))
    _close(port["lm_kernel"], want, 1e-4, 1e-3)
