"""Port parity: rotary embeddings and sliding-window attention at the LM
level (smmb_tpu_torch.models.lm over .attention), twinning
tests/test_rope.py:79,105,128 and tests/test_window.py:90,114,130,144.

Each test checks the JAX test's own contract inside the port, at the JAX
test's tolerance (2e-4 abs on logits, 1e-4 on roped keys), and holds the
port's result against JAX's on the same weights (carried across by
convert.py) and the same numpy tokens. Both run their plain paths
(``use_kernel=False``) in f32.

Across the packages the bound is JAX's own spread between its kernel and
jnp paths, which the probe of ROADMAP item A1 measured on the CPU in f32:
up to 2.9e-3 on a rope + GQA decode step's logits at max|logit| 53, i.e.
5.5e-5 of the largest logit. Two plain paths that sum the same products in
other orders differ by as much, and this random model's unnormalised
attention scores amplify each ulp through the softmax, so the logits are
held at 2e-4 plus twice that share, 1.1e-4 of max|logit|. Greedy tokens
are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smmb_tpu.models import lm as jlm
from smmb_tpu_torch import convert
from smmb_tpu_torch.models import lm as tlm

torch.set_num_threads(2)
BASE = dict(vocab=64, d_model=128, n_heads=2, d_ff=256, n_layers=2, max_len=32)
ROPE = dict(BASE, n_kv_heads=1, rope=True)
WINDOW = dict(BASE, window=6)
SPREAD = 1.1e-4  # twice JAX's kernel-vs-jnp spread, relative to max|logit|


def _pair(seed, cfg):
    jcfg, tcfg = jlm.TernaryLMConfig(**cfg), tlm.TernaryLMConfig(**cfg)
    jpacked = jlm.pack_lm(jlm.init_lm(jax.random.PRNGKey(seed), jcfg))
    return jcfg, tcfg, jpacked, convert.packed_lm_from_jax(jpacked, device="cpu")


def _toks(seed, b, t):
    return np.random.default_rng(seed).integers(0, BASE["vocab"], (b, t))


def _jit(fn, cfg, **kw):
    """JAX's ``fn(packed, tokens, [cache,] cfg, ...)`` on its plain path,
    jitted (eager JAX dispatches op by op, slowly on the CPU)."""
    if fn is jlm.lm_forward:
        return jax.jit(lambda p, t: fn(p, t, cfg, use_kernel=False, **kw))
    return jax.jit(lambda p, t, c: fn(p, t, c, cfg, use_kernel=False, **kw))


def _within(got, want, atol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=atol)


def _vs_jax(got, want):
    want = np.asarray(want)
    _within(got, want, 2e-4 + SPREAD * float(np.abs(want).max()))


def _decode_matches_forward(seed, cfg, b, t, t0):
    """Prefill t0 tokens, then decode the rest: each step's logits against
    the full forward (inside the port) and against JAX's step."""
    jcfg, tcfg, jpacked, tpacked = _pair(seed, cfg)
    toks = _toks(seed + 1, b, t)
    tt = torch.from_numpy(toks)
    full = tlm.lm_forward(tpacked, tt, tcfg, use_kernel=False)
    _vs_jax(full[:, -1], _jit(jlm.lm_forward, jcfg)(jpacked, jnp.asarray(toks))[:, -1])
    logits, cache = tlm.lm_prefill(tpacked, tt[:, :t0], tlm.lm_init_cache(tcfg, b, device="cpu"),
                                   tcfg, use_kernel=False)
    jl, jc = _jit(jlm.lm_prefill, jcfg)(jpacked, jnp.asarray(toks[:, :t0]),
                                        jlm.lm_init_cache(jcfg, b))
    _within(logits, full[:, t0 - 1], 2e-4)
    _vs_jax(logits, jl)
    jstep = _jit(jlm.lm_decode_step, jcfg)
    for i in range(t0, t):
        logits, cache = tlm.lm_decode_step(tpacked, tt[:, i], cache, tcfg, use_kernel=False)
        jl, jc = jstep(jpacked, jnp.asarray(toks[:, i]), jc)
        _within(logits, full[:, i], 2e-4)
        _vs_jax(logits, jl)


def _chunked_matches_one_shot(seed, cfg, keys_atol=None):
    jcfg, tcfg, jpacked, tpacked = _pair(seed, cfg)
    toks = _toks(seed + 1, 2, 16)
    tt = torch.from_numpy(toks)
    l_ref, c_ref = tlm.lm_prefill(tpacked, tt, tlm.lm_init_cache(tcfg, 2, device="cpu"), tcfg,
                                  use_kernel=False)
    l_ch, c_ch = tlm.lm_prefill_chunked(tpacked, tt, tlm.lm_init_cache(tcfg, 2, device="cpu"),
                                        tcfg, 4, use_kernel=False)
    _within(l_ch, l_ref, 2e-4)
    if keys_atol is not None:
        for c, cr in zip(c_ch, c_ref):
            _within(c["k"], cr["k"], keys_atol)
    jl, _ = jlm.lm_prefill_chunked(jpacked, jnp.asarray(toks), jlm.lm_init_cache(jcfg, 2),
                                   jcfg, chunk=4, use_kernel=False)
    _vs_jax(l_ch, jl)


def _generate_flash_matches_plain(seed, cfg):
    jcfg, tcfg, jpacked, tpacked = _pair(seed, cfg)
    toks = _toks(seed + 1, 2, 8)
    g0 = tlm.generate(tpacked, torch.from_numpy(toks), tcfg, 6, use_kernel=False)
    g1 = tlm.generate(tpacked, torch.from_numpy(toks), tcfg, 6, use_kernel=False,
                      use_flash=True)
    np.testing.assert_array_equal(g0.numpy(), g1.numpy())
    want = jlm.generate(jpacked, jnp.asarray(toks), jcfg, steps=6, use_kernel=False)
    np.testing.assert_array_equal(g0.numpy(), np.asarray(want))


@pytest.mark.parametrize("name,cfg,t0,t", [("rope", ROPE, 8, 12), ("window", WINDOW, 10, 16)])
def test_decode_matches_forward_and_jax(name, cfg, t0, t):
    _decode_matches_forward(90 if name == "rope" else 2, cfg, 2, t, t0)


@pytest.mark.parametrize("name,cfg,keys_atol", [("rope", ROPE, 1e-4), ("window", WINDOW, None)])
def test_chunked_prefill_matches_one_shot_and_jax(name, cfg, keys_atol):
    _chunked_matches_one_shot(93 if name == "rope" else 4, cfg, keys_atol)


@pytest.mark.parametrize("name,cfg", [("rope", ROPE), ("window", WINDOW)])
def test_generate_flash_matches_plain_and_jax(name, cfg):
    _generate_flash_matches_plain(94 if name == "rope" else 8, cfg)


def test_window_changes_output():
    """The window restricts attention: positions before it see the full
    context, the last one does not (inside the port and in JAX)."""
    jcfg, tcfg, jpacked, tpacked = _pair(6, WINDOW)
    toks = _toks(7, 1, 16)
    y_win = tlm.lm_forward(tpacked, torch.from_numpy(toks), tcfg, use_kernel=False)
    y_full = tlm.lm_forward(tpacked, torch.from_numpy(toks),
                            dataclasses.replace(tcfg, window=None), use_kernel=False)
    assert float((y_win[:, :5] - y_full[:, :5]).abs().max()) < 1e-4
    assert float((y_win[:, -1] - y_full[:, -1]).abs().max()) > 1e-3
    _vs_jax(y_win[:, -1], _jit(jlm.lm_forward, jcfg)(jpacked, jnp.asarray(toks))[:, -1])
