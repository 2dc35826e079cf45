"""Port parity: the LM training surface (smmb_tpu_torch.models.attention's
``attention_math_chunked`` and ``qat_attention_forward``, .transformer's
``qat_block_forward``, .lm's ``qat_lm_forward`` and ``make_lm_train_step``,
.spec_decode's ``make_draft_distill_step``) against smmb_tpu.models.

JAX's master trees are carried into the port by ``convert.lm_params_from_jax``;
tokens and inputs are numpy arrays from a seed. JAX's steps are jitted and
run at ``Precision.HIGHEST``; the port's f32 products run with TF32 off.

Tolerances:
- the chunked attention: forward within 1e-5 of JAX's (absolute, as
  tests/test_attention.py) and its gradients within 1e-4 (absolute and
  relative);
- one QAT attention backward and one LM train step: the loss at rtol 3e-5
  and every gradient within 3e-5 of the largest |g| of all tensors
  (tests/test_torch_train.py gives the reason: XLA's CPU absmean sums are
  off the exact mean by up to ~5e-6 relative). The largest |g| overall, not
  per tensor: the K bias's gradient is zero in exact arithmetic (a shift of
  every key by one vector moves a query's scores by a constant), so both
  packages give rounding noise there. The updated masters within 1e-6,
  masking entries whose |g| is below 1e-6 of that largest |g| (Adam's first
  update is about lr·sign(g), so a gradient within rounding of 0 can move a
  whole lr either way);
- trajectories (6 to 20 steps): the losses fall in both packages and agree
  within 1e-3 relative (2.5e-5 at most on these draws): absmean sums taken
  in another order can flip a code at the ±0.5 boundary, after which the
  two runs train slightly different models. The codes that differ at the
  end are counted and printed (0 on these draws);
- the trained model's serving parity: JAX's own 5e-4 (tests/test_lm.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from smmb_tpu.models import attention as jattn
from smmb_tpu.models import lm as jlm
from smmb_tpu.models import spec_decode as jsd
from smmb_tpu.models import train as jtrain
from smmb_tpu_torch import convert
from smmb_tpu_torch.models import attention as tattn
from smmb_tpu_torch.models import lm as tlm
from smmb_tpu_torch.models import spec_decode as tsd
from smmb_tpu_torch.models import train as ttrain

torch.set_num_threads(2)
HI = jax.lax.Precision.HIGHEST
SMALL = dict(vocab=64, d_model=64, n_heads=2, d_ff=128, n_layers=1)
TRAJ_REL = 1e-3


def _normal(seed, *shapes):
    rs = np.random.default_rng(seed)
    return [rs.standard_normal(s).astype(np.float32) for s in shapes]


def _tokens(seed, shape, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _lm_masters(seed, cfg_kw):
    """JAX init_lm masters made f32 (``a + 0.01``, as the JAX tests), numpy."""
    params = jlm.init_lm(jax.random.PRNGKey(seed), jlm.TernaryLMConfig(**cfg_kw))
    return jax.tree_util.tree_map(lambda a: np.asarray(a) + np.float32(0.01), params)


def _pair(p):
    return (jax.tree_util.tree_map(jnp.asarray, p),
            convert.lm_params_from_jax(p, device="cpu"))


def _code_flips(tparams, jparams) -> int:
    """Ternary codes that differ between the two packages' block and head
    masters."""
    flips = 0
    for tb, jb in zip(tparams["blocks"], jparams["blocks"]):
        for name in ("w_up", "w_down"):
            flips += int((ttrain.ternarize_ste(tb[name]).detach().numpy()
                          != np.asarray(jtrain.ternarize_ste(jb[name]))).sum())
        for name in ("wq", "wk", "wv", "wo"):
            flips += int((ttrain.ternarize_ste(tb["attn"][name]).detach().numpy()
                          != np.asarray(jtrain.ternarize_ste(jb["attn"][name]))).sum())
    return flips + int((ttrain.ternarize_ste(tparams["head"]).detach().numpy()
                        != np.asarray(jtrain.ternarize_ste(jparams["head"]))).sum())


# ---------------------------------------------------------------- attention


@pytest.mark.parametrize("kwargs", [
    dict(), dict(n_kv_heads=2), dict(rope=True), dict(window=40), dict(causal=False)],
    ids=["mha", "gqa", "rope", "window", "non-causal"])
def test_chunked_attention_matches_jax(kwargs):
    jcfg = jattn.TernaryAttentionConfig(d_model=128, n_heads=4, **kwargs)
    tcfg = tattn.TernaryAttentionConfig(d_model=128, n_heads=4, **kwargs)
    q, k, v = _normal(11, (2, 128, 128), (2, 128, jcfg.kv_dim), (2, 128, jcfg.kv_dim))
    want = np.asarray(jax.jit(lambda q, k, v: jattn.attention_math_chunked(
        q, k, v, jcfg, chunk=32, precision=HI))(q, k, v))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    got = tattn.attention_math_chunked(qt, kt, vt, tcfg, chunk=32)
    full = tattn._attention_math(qt, kt, vt, tcfg)
    assert float(np.abs(got.numpy() - want).max()) < 1e-5
    assert float((got - full).abs().max()) < 1e-5
    with pytest.raises(ValueError):
        tattn.attention_math_chunked(qt, kt, vt, tcfg, chunk=48)


def test_chunked_attention_gradients_match_jax():
    jcfg = jattn.TernaryAttentionConfig(d_model=64, n_heads=2, n_kv_heads=1)
    tcfg = tattn.TernaryAttentionConfig(d_model=64, n_heads=2, n_kv_heads=1)
    q, k, v = _normal(12, (1, 64, 64), (1, 64, 32), (1, 64, 32))

    def jloss(q, k, v):
        return jnp.sum(jattn.attention_math_chunked(q, k, v, jcfg, chunk=16, precision=HI) ** 2)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    (tattn.attention_math_chunked(*ins, tcfg, chunk=16) ** 2).sum().backward()
    full = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    (tattn._attention_math(*full, tcfg) ** 2).sum().backward()
    for t, f, j in zip(ins, full, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(t.grad.numpy(), f.grad.numpy(), atol=1e-4, rtol=1e-4)


def test_attention_qat_gradients_match_jax():
    jcfg = jattn.TernaryAttentionConfig(d_model=32, n_heads=2)
    tcfg = tattn.TernaryAttentionConfig(d_model=32, n_heads=2)
    params = jattn.init_attention(jax.random.PRNGKey(4), jcfg)
    p = {k_: np.asarray(v) + np.float32(0.01) for k_, v in params.items()}
    (x,) = _normal(5, (2, 4, 32))

    def jloss(p):
        return jnp.sum(jattn.qat_attention_forward(p, x, jcfg) ** 2)

    jl, jg = jax.jit(jax.value_and_grad(jloss))({k_: jnp.asarray(v) for k_, v in p.items()})
    for chunk in (None, 2):
        tp = {k_: torch.from_numpy(v.copy()).requires_grad_(True) for k_, v in p.items()}
        loss = (tattn.qat_attention_forward(tp, torch.from_numpy(x), tcfg,
                                            attn_chunk=chunk) ** 2).sum()
        loss.backward()
        np.testing.assert_allclose(float(loss), float(jl), rtol=3e-5)
        assert all(torch.isfinite(t.grad).all() for t in tp.values())
        assert any(float(t.grad.abs().max()) > 0 for t in tp.values())
        gmax = max(float(np.abs(np.asarray(g)).max()) for g in jg.values())
        for name, t in tp.items():
            assert np.abs(t.grad.numpy() - np.asarray(jg[name])).max() <= 3e-5 * gmax, name


# ---------------------------------------------------------------- LM training


def _run_both(cfg_kw, seed, toks, steps, lr, **step_kw):
    p = _lm_masters(seed, cfg_kw)
    jp, tp = _pair(p)
    j_init, j_step = jlm.make_lm_train_step(jlm.TernaryLMConfig(**cfg_kw), learning_rate=lr,
                                            **step_kw)
    t_init, t_step = tlm.make_lm_train_step(tlm.TernaryLMConfig(**cfg_kw), learning_rate=lr,
                                            **step_kw)
    jopt, topt, jstep = j_init(jp), t_init(tp), jax.jit(j_step)
    jl, tl = [], []
    for _ in range(steps):
        jp, jopt, a = jstep(jp, jopt, jnp.asarray(toks))
        tp, topt, b = t_step(tp, topt, torch.from_numpy(toks))
        jl.append(float(a))
        tl.append(float(b))
    return jp, tp, jl, tl


def test_qat_train_step_with_chunked_attention():
    kw = dict(SMALL, max_len=32)
    toks = _tokens(14, (2, 32))
    jp, tp, jl, tl = _run_both(kw, 13, toks, 6, 1e-2, attn_chunk=8)
    assert jl[-1] < jl[0] and tl[-1] < tl[0], (jl, tl)
    np.testing.assert_allclose(tl, jl, rtol=TRAJ_REL)
    print(f"chunked LM: codes that differ after 6 steps: {_code_flips(tp, jp)}")


def test_lm_train_step_reduces_loss_and_serves_what_it_trained():
    kw = dict(SMALL, max_len=16)
    toks = _tokens(31, (4, 8))
    jp, tp, jl, tl = _run_both(kw, 30, toks, 8, 1e-2)
    assert jl[-1] < jl[0] and tl[-1] < tl[0], (jl, tl)
    np.testing.assert_allclose(tl, jl, rtol=TRAJ_REL)
    print(f"LM: codes that differ after 8 steps: {_code_flips(tp, jp)}")
    cfg = tlm.TernaryLMConfig(**kw)
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        served = tlm.lm_forward(tlm.pack_lm(tp, quantize=True), tt, cfg, use_kernel=False)
        kern = tlm.lm_forward(tlm.pack_lm(tp, quantize=True), tt, cfg)
        qat = tlm.qat_lm_forward(tp, tt, cfg)
    np.testing.assert_allclose(served.numpy(), qat.numpy(), atol=5e-4, rtol=0)
    np.testing.assert_allclose(kern.numpy(), qat.numpy(), atol=5e-4, rtol=0)


def test_lm_train_grad_accumulation_matches_full_batch():
    kw = dict(SMALL, max_len=16)
    cfg = tlm.TernaryLMConfig(**kw)
    p = _lm_masters(50, kw)
    toks = torch.from_numpy(_tokens(51, (8, 8)))
    out = {}
    for accum in (1, 4):
        tp = convert.lm_params_from_jax(p, device="cpu")
        init_opt, step = tlm.make_lm_train_step(cfg, learning_rate=1e-2, accum_steps=accum)
        opt = init_opt(tp)
        tp, opt, loss = step(tp, opt, toks)
        out[accum] = (loss, [t.grad.clone() for t in ttrain.param_leaves(tp)])
    np.testing.assert_allclose(float(out[4][0]), float(out[1][0]), rtol=1e-5)
    for g4, g1 in zip(out[4][1], out[1][1]):
        np.testing.assert_allclose(g4.numpy(), g1.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(g1.abs().max()))
    with pytest.raises(ValueError, match="divisible"):
        step(tp, opt, toks[:6])


def _jax_lm_loss_and_grads(cfg, p, toks):
    def loss(params):
        logits, aux = jlm._qat_lm_forward_aux(params, toks, cfg)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], toks[:, 1:]).mean() + 1e-2 * aux

    return jax.jit(jax.value_and_grad(loss))(p)


def test_lm_train_step_one_step_matches_jax():
    kw = dict(SMALL, max_len=16, n_kv_heads=1, rope=True)
    p = _lm_masters(60, kw)
    toks = _tokens(61, (4, 16))
    jp, tp = _pair(p)
    jl, jg = _jax_lm_loss_and_grads(jlm.TernaryLMConfig(**kw), jp, jnp.asarray(toks))
    j_init, j_step = jlm.make_lm_train_step(jlm.TernaryLMConfig(**kw), learning_rate=1e-2)
    jnew, _, _ = jax.jit(j_step)(jp, j_init(jp), jnp.asarray(toks))
    t_init, t_step = tlm.make_lm_train_step(tlm.TernaryLMConfig(**kw), learning_rate=1e-2)
    tp, _, loss = t_step(tp, t_init(tp), torch.from_numpy(toks))
    np.testing.assert_allclose(float(loss), float(jl), rtol=3e-5)
    # the port's tree in JAX's leaf order (sorted dict keys), for pairing
    tleaves = jax.tree_util.tree_leaves(tp, is_leaf=lambda a: isinstance(a, torch.Tensor))
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(tleaves) == len(jleaves) == len(ttrain.param_leaves(tp))
    gmax = max(float(np.abs(np.asarray(g)).max()) for g in jleaves)
    for t, g, new in zip(tleaves, jleaves, jax.tree_util.tree_leaves(jnew)):
        g = np.asarray(g)
        live = np.abs(g) >= 1e-6 * gmax
        assert np.abs(t.grad.numpy() - g).max() <= 3e-5 * gmax
        assert np.abs(t.detach().numpy() - np.asarray(new))[live].max() <= 1e-6


# ---------------------------------------------------------------- distillation

TARGET = dict(vocab=64, d_model=128, n_heads=2, d_ff=256, n_layers=2, max_len=64)
DRAFT = dict(vocab=64, d_model=64, n_heads=2, d_ff=128, n_layers=1, max_len=64)


def test_draft_distillation_improves_agreement():
    """Distilling the draft toward the packed target lowers the soft CE in
    both packages, raises the port's greedy agreement on the batch, and the
    distilled draft drives speculative decoding token for token the
    target's greedy ``generate``."""
    jtarget = jlm.pack_lm(jlm.init_lm(jax.random.PRNGKey(50), jlm.TernaryLMConfig(**TARGET)))
    ttarget = convert.packed_lm_from_jax(jtarget, device="cpu")
    tcfg, dcfg = tlm.TernaryLMConfig(**TARGET), tlm.TernaryLMConfig(**DRAFT)
    p = _lm_masters(51, DRAFT)
    jp, tp = _pair(p)
    toks = _tokens(52, (8, 16))
    tt = torch.from_numpy(toks)
    j_init, j_step = jsd.make_draft_distill_step(jtarget, jlm.TernaryLMConfig(**TARGET),
                                                 jlm.TernaryLMConfig(**DRAFT),
                                                 learning_rate=5e-3)
    t_init, t_step = tsd.make_draft_distill_step(ttarget, tcfg, dcfg, learning_rate=5e-3)
    jopt, topt, jstep = j_init(jp), t_init(tp), jax.jit(j_step)

    def agreement(params):
        with torch.no_grad():
            t = tlm.lm_forward(ttarget, tt, tcfg).argmax(-1)
            d = tlm.lm_forward(tlm.pack_lm(params, quantize=True), tt, dcfg).argmax(-1)
        return float((t == d).float().mean())

    a0 = agreement(tp)
    jl, tl = [], []
    for _ in range(20):
        jp, jopt, a = jstep(jp, jopt, jnp.asarray(toks))
        tp, topt, b = t_step(tp, topt, tt)
        jl.append(float(a))
        tl.append(float(b))
    assert jl[-1] < jl[0] and tl[-1] < tl[0], (jl, tl)
    np.testing.assert_allclose(tl, jl, rtol=TRAJ_REL)
    a1 = agreement(tp)
    assert a1 > a0, f"argmax agreement did not improve: {a0} -> {a1}"
    print(f"distillation: agreement {a0:.3f} -> {a1:.3f}, codes that differ "
          f"{_code_flips(tp, jp)}")
    prompt = tt[:1, :8]
    with torch.no_grad():
        want = tlm.generate(ttarget, prompt, tcfg, 10, use_kernel=False)
        got = tsd.generate_speculative(ttarget, tlm.pack_lm(tp, quantize=True), prompt,
                                       tcfg, dcfg, 10, k=3, use_kernel=False)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_distill_rejects_vocab_mismatch():
    jtarget = jlm.pack_lm(jlm.init_lm(jax.random.PRNGKey(60), jlm.TernaryLMConfig(**TARGET)))
    with pytest.raises(ValueError, match="vocab"):
        jsd.make_draft_distill_step(jtarget, jlm.TernaryLMConfig(**TARGET),
                                    jlm.TernaryLMConfig(**{**DRAFT, "vocab": 32}))
    ttarget = convert.packed_lm_from_jax(jtarget, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        tsd.make_draft_distill_step(ttarget, tlm.TernaryLMConfig(**TARGET),
                                    dataclasses.replace(tlm.TernaryLMConfig(**DRAFT), vocab=32))
