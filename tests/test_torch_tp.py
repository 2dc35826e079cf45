"""Port parity: the tensor-parallel block and LM
(smmb_tpu_torch.parallel.tp_transformer) against JAX's
(smmb_tpu.parallel.tp_transformer) — the twins of tests/test_tp.py.

JAX's weights are carried into the port by convert.py; prompts and inputs
are numpy arrays made from seeds. JAX runs on the 8-device virtual CPU
mesh, the port on a gloo world of CPU ranks of the same data × model shape,
every case in one 8-rank world started once for the file
(tests/torch_parallel_ranks.py). Tolerance: JAX's
max(TOL_DENSE, 2e-5·max|ref|) for the forwards and decode steps; tokens
exactly. JAX's decode twins compare the TP decode step with JAX's TP
forward at the last position (JAX's eager TP decode takes ~40 s a case);
the generate twins compare the port's ``generate_tp`` with JAX's jitted
``generate_tp`` (and, where JAX's test does, with its single-device
``generate``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from smmb_tpu.models.lm import TernaryLMConfig, generate, init_lm, pack_lm
from smmb_tpu.models.transformer import TernaryBlockConfig, init_block, pack_block
from smmb_tpu.parallel import make_mesh
from smmb_tpu.parallel.tp_transformer import (
    block_forward_tp,
    generate_tp,
    lm_forward_tp,
    shard_block_tp,
    shard_lm_tp,
)
from smmb_tpu.utils.compare import TOL_DENSE, assert_close
from smmb_tpu_torch.convert import packed_lm_from_jax
from smmb_tpu_torch.parallel.mesh import run_world

torch.set_num_threads(2)

CFG_KW = dict(d_model=1024, n_heads=4, d_ff=1024)
CFG = TernaryBlockConfig(**CFG_KW)
GQA = dataclasses.replace(CFG, n_kv_heads=2)
LM_KW = dict(vocab=512, d_model=1024, n_heads=4, d_ff=1024, n_layers=2, max_len=32)
LM_CFG = TernaryLMConfig(**LM_KW)
SMALL_KW = dict(vocab=256, d_model=1024, n_heads=4, d_ff=1024, n_layers=1, max_len=32)
SMALL = TernaryLMConfig(**SMALL_KW)


def _x(seed, shape):
    return (np.random.default_rng(seed).uniform(-1, 1, shape) * 0.1).astype(np.float32)


def _toks(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _block(seed, cfg=CFG, quantize=False):
    params = init_block(jax.random.PRNGKey(seed), cfg)
    if quantize:
        params = jax.tree.map(lambda a: a + 0.01, params)
    return pack_block(params, quantize=quantize)


def _ragged():
    rs = np.random.default_rng(62)
    p1 = rs.integers(0, LM_CFG.vocab, (1, 3)).astype(np.int32)
    p2 = rs.integers(0, LM_CFG.vocab, (1, 6)).astype(np.int32)
    batch = np.concatenate([np.pad(p1, ((0, 0), (3, 0))), p2])
    mask = np.stack([np.arange(6) >= 3, np.ones(6, bool)])
    return p1, p2, batch, mask


J = {
    "block": _block(11),
    "block_k": _block(13),
    "block_qat": _block(7, quantize=True),
    "block_gqa": _block(91, GQA),
    "decode_gqa": _block(93, GQA),
    "decode": _block(31),
    "lm": pack_lm(init_lm(jax.random.PRNGKey(21), LM_CFG)),
    "small": pack_lm(init_lm(jax.random.PRNGKey(23), SMALL)),
    "small_q": pack_lm(init_lm(jax.random.PRNGKey(33), SMALL)),
}
X = {
    "block_x": _x(12, (4, 6, 1024)),
    "block_k_x": _x(14, (2, 2, 1024)),
    "gqa_x": _x(92, (2, 4, 1024)),
    "decode_gqa_x": _x(94, (2, 5, 1024)),
    "decode_x": _x(32, (2, 5, 1024)),
    "lm_toks": _toks(22, (2, 6), LM_CFG.vocab),
    "gen_toks": _toks(52, (2, 4), LM_CFG.vocab),
    "small_toks": _toks(24, (2, 8), SMALL.vocab),
    "small_q_toks": _toks(34, (2, 8), SMALL.vocab),
}
RAGGED = _ragged()


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    path = tmp_path_factory.mktemp("tp")
    inp = {k: packed_lm_from_jax(v, device="cpu") for k, v in J.items()}
    inp.update(X)
    inp["ragged_toks"], inp["ragged_mask"] = RAGGED[2], RAGGED[3]
    inp["block_cfg"], inp["lm_cfg"], inp["small_cfg"] = CFG_KW, LM_KW, SMALL_KW
    torch.save(inp, path / "inputs.pt")
    return run_world(ranks.suite_tp, 8, backend="gloo", device="cpu", args=(str(path),))[0]


def _assert_scaled(y, ref, what):
    tol = max(TOL_DENSE, 2e-5 * float(np.abs(np.asarray(ref)).max()))
    assert_close(y, ref, tol, what)


def _mesh(data, model):
    return make_mesh(data, model, devices=jax.devices()[: data * model])


def _jax_block(key, x_key, cfg, data, model, **kw):
    mesh = _mesh(data, model)
    return np.asarray(block_forward_tp(shard_block_tp(J[key], mesh), jnp.asarray(X[x_key]),
                                       cfg, mesh=mesh, use_kernel=False, **kw))


@pytest.mark.parametrize("data,model", [(2, 2), (4, 2), (1, 2)])
def test_block_tp_matches_single(port, data, model):
    _assert_scaled(port[f"block_{data}x{model}"], _jax_block("block", "block_x", CFG, data,
                                                             model), "block tp")


def test_block_tp_kernel_path(port):
    mesh = _mesh(2, 2)
    want = np.asarray(block_forward_tp(shard_block_tp(J["block_k"], mesh),
                                       jnp.asarray(X["block_k_x"]), CFG, mesh=mesh,
                                       use_kernel=True))
    _assert_scaled(port["block_kernel"], want, "block tp kernel")


def test_block_tp_quantized_scales(port):
    _assert_scaled(port["block_qat"], _jax_block("block_qat", "block_x", CFG, 2, 2),
                   "block tp qat")


def test_block_tp_rejects_bad_heads(port):
    assert port["block_bad_heads"] is True  # n_heads=4 over model=8


def test_lm_tp_matches_single(port):
    """JAX's check (TP == one rank at every position) on the port's own
    single-rank ``lm_forward``; against JAX's TP forward at the last
    position. This LM's unnormalised attention scores amplify the f32 sum
    orders in which the two packages differ: their single-rank forwards
    already part by 2.2e-3 at one earlier position (max|logit| 102), so, as
    tests/test_torch_lm.py does, the packages meet at the last position."""
    got, single = port["lm_forward"]
    _assert_scaled(got, single, "lm tp vs the port's single rank")
    mesh = _mesh(2, 2)
    want = np.asarray(lm_forward_tp(shard_lm_tp(J["lm"], mesh), jnp.asarray(X["lm_toks"]),
                                    LM_CFG, mesh=mesh, use_kernel=False))
    _assert_scaled(got[:, -1], want[:, -1], "lm tp vs JAX's, last position")


def test_block_tp_gqa_matches_single(port):
    _assert_scaled(port["block_gqa"], _jax_block("block_gqa", "gqa_x", GQA, 2, 2),
                   "block tp gqa")


def test_block_decode_tp_gqa_matches_forward(port):
    y_t, cache_shape = port["decode_gqa"]
    assert cache_shape == (2, 8, 256)  # the rank's flat cache: its kv_heads*hd
    full = _jax_block("decode_gqa", "decode_gqa_x", GQA, 1, 2)
    _assert_scaled(y_t, full[:, -1], "tp gqa decode")


def test_block_decode_tp_matches_forward(port):
    y_t, _ = port["decode"]
    full = _jax_block("decode", "decode_x", CFG, 2, 2)
    _assert_scaled(y_t, full[:, -1], "tp decode")


def test_lm_decode_tp_matches_single(port):
    mesh = _mesh(2, 2)
    ref = np.asarray(lm_forward_tp(shard_lm_tp(J["lm"], mesh), jnp.asarray(X["lm_toks"]),
                                   LM_CFG, mesh=mesh, use_kernel=False))
    _assert_scaled(port["lm_decode"], ref[:, -1], "lm tp decode")


def _jax_generate_tp(key, cfg, toks, steps, data, model, **kw):
    mesh = _mesh(data, model)
    return np.asarray(generate_tp(shard_lm_tp(J[key], mesh), jnp.asarray(toks), cfg, steps,
                                  mesh=mesh, use_kernel=False, **kw))


def test_generate_tp_matches_single(port):
    want = np.asarray(generate(J["lm"], jnp.asarray(X["gen_toks"]), LM_CFG, 4,
                               use_kernel=False))
    np.testing.assert_array_equal(port["generate"], want)
    np.testing.assert_array_equal(
        port["generate"], _jax_generate_tp("lm", LM_CFG, X["gen_toks"], 4, 2, 2))


def test_block_tp_flash_matches_single(port):
    _assert_scaled(port["block_flash"], _jax_block("block", "block_x", CFG, 2, 2,
                                                   use_flash=True), "block tp flash")


def test_generate_tp_flash_matches_plain(port):
    want = _jax_generate_tp("small", SMALL, X["small_toks"], 6, 1, 2, use_flash=True)
    np.testing.assert_array_equal(port["generate_flash"], want)
    np.testing.assert_array_equal(port["generate_plain"], port["generate_flash"])


def test_generate_tp_kv_quant_runs(port):
    out = port["generate_kv_quant"]
    assert out.shape == (2, 6)
    assert np.all((out >= 0) & (out < SMALL.vocab))
    want = _jax_generate_tp("small_q", SMALL, X["small_q_toks"], 6, 1, 2, kv_quant=True)
    np.testing.assert_array_equal(out, want)
    assert port["kv_quant_cache"] == [("torch.int8", True)]


def test_generate_tp_ragged_matches_per_row(port):
    p1, p2, _, _ = RAGGED
    for r, p in enumerate((p1, p2)):
        ref = np.asarray(generate(J["lm"], jnp.asarray(p), LM_CFG, 5, use_kernel=False))
        np.testing.assert_array_equal(port["generate_ragged"][r], ref[0], err_msg=f"row {r}")
