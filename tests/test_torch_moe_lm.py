"""Port parity: the MoE LM (``TernaryLMConfig(n_experts=...)``) through the
port's serving stack and QAT against smmb_tpu.models.lm (twins of
tests/test_moe_lm.py's single-device cases).

JAX's packed trees and masters are carried into the port by ``convert``;
tokens are numpy arrays from a seed. JAX's entry points are jitted at
``Precision.HIGHEST``. The port runs on CPU tensors (the kernels' plain
versions).

Tolerances: logits at the LM rule 2e-4 + 1.1e-4·max|logit| (twice JAX's own
spread between its kernel and jnp paths, as tests/test_torch_rope_window.py);
generated tokens exactly; one QAT step's loss at rtol 3e-5 and a trajectory
within 1e-3 relative (tests/test_torch_lm_train.py gives the reasons).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smmb_tpu.models import lm as jlm
from smmb_tpu.models import spec_decode as jsd
from smmb_tpu_torch import convert
from smmb_tpu_torch.models import lm as tlm
from smmb_tpu_torch.models import moe_block as tmb
from smmb_tpu_torch.models import spec_decode as tsd

torch.set_num_threads(2)
HI = jax.lax.Precision.HIGHEST
KW = dict(vocab=64, d_model=128, n_heads=2, d_ff=128, n_layers=2, max_len=32,
          n_experts=4, top_k=2, n_kv_heads=1, rope=True)
JCFG, TCFG = jlm.TernaryLMConfig(**KW), tlm.TernaryLMConfig(**KW)
DKW = dict(vocab=64, d_model=64, n_heads=2, d_ff=128, n_layers=1, max_len=32)


def _rule_close(got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    lim = 2e-4 + 1.1e-4 * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= lim, f"max err {err:.3e} > {lim:.3e}"


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, KW["vocab"], shape)


def _lm(seed):
    """(JAX packed, the port's packed) of one MoE LM."""
    jpacked = jlm.pack_lm(jlm.init_lm(jax.random.PRNGKey(seed), JCFG))
    return jpacked, convert.packed_lm_from_jax(jpacked, device="cpu")


_jforward = jax.jit(lambda p, t: jlm.lm_forward(p, t, JCFG, use_kernel=False, precision=HI))


def test_moe_lm_forward_and_block_structure():
    jp, tp = _lm(1)
    assert isinstance(TCFG.block, tmb.TernaryMoEBlockConfig)
    assert "moe" in tp["blocks"][0] and "w_up" not in tp["blocks"][0]
    assert tp["blocks"][0]["moe"]["w_up"].data.shape[0] == KW["n_experts"]
    toks = _tokens(2, (2, 8))
    want = _jforward(jp, jnp.asarray(toks))
    for use_kernel in (True, False):
        got = tlm.lm_forward(tp, torch.from_numpy(toks), TCFG, use_kernel=use_kernel)
        assert got.shape == (2, 8, KW["vocab"]) and bool(torch.isfinite(got).all())
        _rule_close(got, want)


def test_moe_lm_decode_matches_forward():
    jp, tp = _lm(3)
    toks = torch.from_numpy(_tokens(4, (2, 10)))
    full = tlm.lm_forward(tp, toks, TCFG)
    _rule_close(full, _jforward(jp, jnp.asarray(toks.numpy())))
    logits, cache = tlm.lm_prefill(tp, toks[:, :6], tlm.lm_init_cache(TCFG, 2, device="cpu"),
                                   TCFG)
    _rule_close(logits, full[:, 5])
    for i in range(6, 10):
        logits, cache = tlm.lm_decode_step(tp, toks[:, i], cache, TCFG)
        _rule_close(logits, full[:, i])


def test_moe_lm_chunked_prefill_matches():
    jp, tp = _lm(5)
    toks = _tokens(6, (2, 16))
    want, _ = jlm.lm_prefill(jp, jnp.asarray(toks), jlm.lm_init_cache(JCFG, 2), JCFG,
                             use_kernel=False, precision=HI)
    l1, _ = tlm.lm_prefill(tp, torch.from_numpy(toks), tlm.lm_init_cache(TCFG, 2, device="cpu"),
                           TCFG)
    l2, _ = tlm.lm_prefill_chunked(tp, torch.from_numpy(toks),
                                   tlm.lm_init_cache(TCFG, 2, device="cpu"), TCFG, chunk=4)
    _rule_close(l1, want)
    _rule_close(l2, l1.numpy())


def test_moe_lm_generate_beam_spec_kvquant():
    jp, tp = _lm(7)
    prompt = _tokens(8, (1, 8))
    jprompt, tprompt = jnp.asarray(prompt), torch.from_numpy(prompt)
    g = tlm.generate(tp, tprompt, TCFG, 6)
    np.testing.assert_array_equal(
        g.numpy(), np.asarray(jlm.generate(jp, jprompt, JCFG, steps=6, use_kernel=False)))
    np.testing.assert_array_equal(tlm.generate(tp, tprompt, TCFG, 6, use_flash=True).numpy(),
                                  g.numpy())
    gq = tlm.generate(tp, tprompt, TCFG, 6, kv_quant=True)
    np.testing.assert_array_equal(gq.numpy(), np.asarray(jlm.generate(
        jp, jprompt, JCFG, steps=6, use_kernel=False, kv_quant=True)))
    b, s = tlm.generate_beam(tp, tprompt, TCFG, 6, beam=2)
    jb, js = jlm.generate_beam(jp, jprompt, JCFG, 6, beam=2, use_kernel=False)
    assert b.shape == (2, 6) and float(s[0]) >= float(s[1])
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4)
    # a dense draft against the MoE target: the draft only proposes
    dcfg = tlm.TernaryLMConfig(**DKW)
    draft = convert.packed_lm_from_jax(
        jlm.pack_lm(jlm.init_lm(jax.random.PRNGKey(9), jlm.TernaryLMConfig(**DKW))),
        device="cpu")
    got = tsd.generate_speculative(tp, draft, tprompt, TCFG, dcfg, 6, k=2)
    np.testing.assert_array_equal(got.numpy(), g.numpy())
    jgot = jsd.generate_speculative(
        jp, jlm.pack_lm(jlm.init_lm(jax.random.PRNGKey(9), jlm.TernaryLMConfig(**DKW))),
        jprompt, JCFG, jlm.TernaryLMConfig(**DKW), steps=6, k=2, use_kernel=False)
    np.testing.assert_array_equal(np.asarray(jgot), g.numpy())


def test_moe_lm_trains_with_aux():
    params = jlm.init_lm(jax.random.PRNGKey(10), JCFG)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + np.float32(0.01), params)
    toks = _tokens(11, (4, 12))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    j_init, j_step = jlm.make_lm_train_step(JCFG, learning_rate=1e-2)
    jstep, jopt = jax.jit(j_step), j_init(jparams)
    tparams = convert.lm_params_from_jax(params, device="cpu")
    t_init, t_step = tlm.make_lm_train_step(TCFG, learning_rate=1e-2)
    topt = t_init(tparams)
    jl, tl = [], []
    for _ in range(6):
        jparams, jopt, loss = jstep(jparams, jopt, jnp.asarray(toks))
        jl.append(float(loss))
        tparams, topt, loss = t_step(tparams, topt, torch.from_numpy(toks))
        tl.append(float(loss))
    np.testing.assert_allclose(tl[0], jl[0], rtol=3e-5)
    assert jl[-1] < jl[0] and tl[-1] < tl[0], (jl, tl)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        served = tlm.lm_forward(tlm.pack_lm(tparams, quantize=True), tt, TCFG)
        _, aux = tlm._qat_lm_forward_aux(tparams, tt, TCFG)
    assert bool(torch.isfinite(served).all())
    assert float(aux) > 0  # the two MoE blocks' load-balance losses
    # aux_weight now moves the loss
    fresh = convert.lm_params_from_jax(params, device="cpu")
    losses = []
    for w in (0.0, 1e-2):
        init0, step0 = tlm.make_lm_train_step(TCFG, learning_rate=1e-2, aux_weight=w)
        _, _, loss = step0(fresh, init0(fresh), tt)
        losses.append(float(loss))
        fresh = convert.lm_params_from_jax(params, device="cpu")
    assert losses[1] > losses[0]
    np.testing.assert_allclose(losses[1], jl[0], rtol=3e-5)


def test_moe_lm_generate_with_chunked_prefill():
    jp, tp = _lm(12)
    prompt = _tokens(13, (2, 12))
    tprompt = torch.from_numpy(prompt)
    g0 = tlm.generate(tp, tprompt, TCFG, 6)
    g1 = tlm.generate(tp, tprompt, TCFG, 6, prefill_chunk=4)
    np.testing.assert_array_equal(g1.numpy(), g0.numpy())
    np.testing.assert_array_equal(g0.numpy(), np.asarray(
        jlm.generate(jp, jnp.asarray(prompt), JCFG, steps=6, use_kernel=False)))
    with pytest.raises(ValueError, match="not combinable"):
        tlm.generate(tp, tprompt, TCFG, 6, prefill_chunk=4, use_flash=True)


def test_moe_lm_draft_distillation_runs():
    """A MoE draft distils toward a dense target through its QAT forward
    (the distillation loss has no aux term, as in JAX)."""
    dcfg = tlm.TernaryLMConfig(**{**KW, "n_layers": 1})
    tcfg = tlm.TernaryLMConfig(**DKW)
    target = convert.packed_lm_from_jax(
        jlm.pack_lm(jlm.init_lm(jax.random.PRNGKey(14), jlm.TernaryLMConfig(**DKW))),
        device="cpu")
    draft = convert.lm_params_from_jax(
        jax.tree_util.tree_map(lambda a: np.asarray(a) + np.float32(0.01), jlm.init_lm(
            jax.random.PRNGKey(15), jlm.TernaryLMConfig(**{**KW, "n_layers": 1}))),
        device="cpu")
    init_opt, step = tsd.make_draft_distill_step(target, tcfg, dcfg, learning_rate=5e-3)
    opt = init_opt(draft)
    toks = torch.from_numpy(_tokens(16, (4, 16)))
    losses = []
    for _ in range(4):
        draft, opt, loss = step(draft, opt, toks)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
