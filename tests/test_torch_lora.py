"""Port parity: LoRA adapters over the frozen 2-bit LM
(smmb_tpu_torch.models.lora and the adapter residuals of .attention and
.transformer) against smmb_tpu.models.lora (twins of tests/test_lora.py's
single-device cases).

JAX's packed LM and adapters are carried into the port as numpy arrays;
tokens come from a seed. The port runs on CPU tensors (the kernels' plain
versions). Tolerances: an untrained adapter changes nothing (bitwise);
logits at the LM rule 2e-4 + 1.1e-4·max|logit|; generated tokens exactly;
one adapter step's loss at rtol 3e-5 and its gradients within 3e-5 of the
largest |g|; trajectories within 1e-3 relative (tests/test_torch_lm_train.py
gives the reasons).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from smmb_tpu.models import lm as jlm
from smmb_tpu.models import lora as jlora
from smmb_tpu_torch import convert
from smmb_tpu_torch.models import lm as tlm
from smmb_tpu_torch.models import lora as tlora
from smmb_tpu_torch.models import transformer as ttb
from smmb_tpu_torch.models.attention import _qkv_prenorm_fusable
from smmb_tpu_torch.utils import rng

torch.set_num_threads(2)
KW = dict(vocab=64, d_model=128, n_heads=2, d_ff=256, n_layers=2, max_len=32, n_kv_heads=1)
JCFG, TCFG = jlm.TernaryLMConfig(**KW), tlm.TernaryLMConfig(**KW)
ALL = ("wq", "wv", "wo", "w_up", "w_down")


def _setup(seed):
    jpacked = jlm.pack_lm(jlm.init_lm(jax.random.PRNGKey(seed), JCFG))
    toks = np.random.default_rng(seed + 1).integers(0, KW["vocab"], (4, 16))
    return jpacked, convert.packed_lm_from_jax(jpacked, device="cpu"), toks


def _adapters(seed, targets, bump=0.0):
    """JAX adapters (``+ bump``) and the same arrays as the port's."""
    ad = jlora.init_lora_lm(jax.random.PRNGKey(seed), JCFG, rank=4, targets=targets)
    ad = jax.tree_util.tree_map(lambda a: np.asarray(a) + np.float32(bump), ad)
    tad = [{n: tuple(torch.from_numpy(np.array(a)) for a in ab) for n, ab in blk.items()}
           for blk in ad]
    return jax.tree_util.tree_map(jnp.asarray, ad), tad


def _rule_close(got, want):
    want = np.asarray(want, np.float32)
    lim = 2e-4 + 1.1e-4 * float(np.abs(want).max())
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= lim, f"max err {err:.3e} > {lim:.3e}"


_jforward = jax.jit(lambda p, t: jlm.lm_forward(p, t, JCFG, use_kernel=False))


def test_zero_adapter_is_noop():
    jp, tp, toks = _setup(1)
    jad, tad = _adapters(2, ALL)
    tt = torch.from_numpy(toks)
    base = tlm.lm_forward(tp, tt, TCFG, use_kernel=False)
    adapted = tlm.lm_forward(tlora.attach_lora(tp, tad), tt, TCFG, use_kernel=False)
    assert torch.equal(base, adapted)
    _rule_close(adapted, _jforward(jlora.attach_lora(jp, jad), jnp.asarray(toks)))
    own = tlora.init_lora_lm(rng.make_generator(3, "cpu"), TCFG, rank=4, targets=ALL)
    assert own[0]["wq"][0].shape == (128, 4) and own[0]["w_down"][1].shape == (4, 128)
    assert torch.equal(tlm.lm_forward(tlora.attach_lora(tp, own), tt, TCFG), base)


def test_lora_attach_leaves_the_input_untouched():
    _, tp, _ = _setup(1)
    _, tad = _adapters(2, ALL)
    model = tlora.attach_lora(tp, tad, alpha=8.0)
    assert all("wq_lora" not in b["attn"] and "w_up_lora" not in b for b in tp["blocks"])
    a, b, sc = model["blocks"][1]["attn"]["wv_lora"]
    assert a is tad[1]["wv"][0] and sc.dtype == torch.float32 and float(sc) == 2.0
    assert model["blocks"][0]["attn"]["wq"] is tp["blocks"][0]["attn"]["wq"]


def _jax_lora_loss(jpacked, cfg):
    def loss(ad, t):
        logits = jlm.lm_forward(jlora.attach_lora(jpacked, ad), t, cfg, use_kernel=False)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], t[:, 1:]).mean()

    return jax.jit(jax.value_and_grad(loss))


def test_lora_trains_and_base_is_frozen():
    jp, tp, toks = _setup(3)
    jad, tad = _adapters(4, ("wq", "wv", "w_up"))
    base_planes = [b["attn"]["wq"].data.clone() for b in tp["blocks"]]
    j_init, j_step = jlora.make_lora_train_step(jp, JCFG, learning_rate=5e-3)
    jstep, jopt = jax.jit(j_step), j_init(jad)
    t_init, t_step = tlora.make_lora_train_step(tp, TCFG, learning_rate=5e-3)
    topt = t_init(tad)
    jl, tl = [], []
    for _ in range(8):
        jad, jopt, loss = jstep(jad, jopt, jnp.asarray(toks))
        jl.append(float(loss))
        tad, topt, loss = t_step(tad, topt, torch.from_numpy(toks))
        tl.append(float(loss))
    np.testing.assert_allclose(tl[0], jl[0], rtol=3e-5)
    assert jl[-1] < jl[0] and tl[-1] < tl[0], (jl, tl)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    for b, before in zip(tp["blocks"], base_planes):  # the 2-bit base never moved
        assert torch.equal(b["attn"]["wq"].data, before)
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        y0 = tlm.lm_forward(tp, tt, TCFG, use_kernel=False)
        y1 = tlm.lm_forward(tlora.attach_lora(tp, tad), tt, TCFG, use_kernel=False)
    assert float((y1 - y0).abs().max()) > 1e-3


def _lecun_packed(seed):
    """A well-conditioned packed LM: ``init_lm``'s projection and head
    masters times 1/sqrt(fan_in), packed with their absmean scales, so the
    attention scores are O(sqrt(hd)) and a rounding is not amplified
    through the layers (the random LM's unit-scale planes put scores in the
    hundreds)."""
    params = jax.tree_util.tree_map(np.asarray, jlm.init_lm(jax.random.PRNGKey(seed), JCFG))
    for blk in params["blocks"]:
        for name in ("wq", "wk", "wv", "wo"):
            blk["attn"][name] = blk["attn"][name] / np.sqrt(blk["attn"][name].shape[0])
        for name in ("w_up", "w_down"):
            blk[name] = blk[name] / np.sqrt(blk[name].shape[0])
    params["head"] = params["head"] / np.sqrt(params["head"].shape[0])
    jpacked = jlm.pack_lm(jax.tree_util.tree_map(jnp.asarray, params), quantize=True)
    return jpacked, convert.packed_lm_from_jax(jpacked, device="cpu")


def test_lora_train_step_gradients_match_jax():
    """One adapter step's loss and gradients against JAX's, on a
    well-conditioned LM (on the unit-scale one, the chaotic attention
    amplifies the two packages' rounding in the gradients too)."""
    jp, tp = _lecun_packed(3)
    toks = np.random.default_rng(4).integers(0, KW["vocab"], (4, 16))
    targets = ("wq", "wv", "w_up", "w_down")
    jad, tad = _adapters(4, targets, bump=0.01)
    jl, jg = _jax_lora_loss(jp, JCFG)(jad, jnp.asarray(toks))
    t_init, t_step = tlora.make_lora_train_step(tp, TCFG, learning_rate=5e-3)
    tad, _, loss = t_step(tad, t_init(tad), torch.from_numpy(toks))
    np.testing.assert_allclose(float(loss), float(jl), rtol=3e-5)
    tleaves = jax.tree_util.tree_leaves(tad, is_leaf=lambda a: isinstance(a, torch.Tensor))
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(tleaves) == len(jleaves) == 2 * len(targets) * KW["n_layers"]
    gmax = max(float(np.abs(np.asarray(g)).max()) for g in jleaves)
    for t, g in zip(tleaves, jleaves):
        assert float(np.abs(t.grad.numpy() - np.asarray(g)).max()) <= 3e-5 * gmax


def test_lora_serves_through_kernel_route_and_generate():
    jp, tp, toks = _setup(5)
    jad, tad = _adapters(6, ("wq", "wv", "w_down"), bump=0.01)
    jmodel, tmodel = jlora.attach_lora(jp, jad), tlora.attach_lora(tp, tad)
    tt = torch.from_numpy(toks)
    yk = tlm.lm_forward(tmodel, tt, TCFG, use_kernel=True)
    yj = tlm.lm_forward(tmodel, tt, TCFG, use_kernel=False)
    assert float((yk - yj).abs().max() / yj.abs().max()) < 2e-5
    _rule_close(yk, _jforward(jmodel, jnp.asarray(toks)))
    prompt = toks[:1, :8]
    g_lora = tlm.generate(tmodel, torch.from_numpy(prompt), TCFG, 6)
    np.testing.assert_array_equal(g_lora.numpy(), np.asarray(
        jlm.generate(jmodel, jnp.asarray(prompt), JCFG, steps=6, use_kernel=False)))
    g_base = tlm.generate(tp, torch.from_numpy(prompt), TCFG, 6)
    assert g_lora.shape == g_base.shape
    full = tlm.lm_forward(tmodel, torch.from_numpy(prompt), TCFG)
    assert int(g_lora[0, 0]) == int(full[0, -1].argmax())
    # decode and the chunked extend take the adapters too: a decode step's
    # logits follow the adapted forward's
    logits, cache = tlm.lm_prefill(tmodel, tt[:1, :8], tlm.lm_init_cache(TCFG, 1, device="cpu"),
                                   TCFG)
    step, _ = tlm.lm_decode_step(tmodel, tt[0, 8:9], cache, TCFG)
    ext, _ = tlm.lm_extend(tmodel, tt[:1, 8:12], cache, TCFG)
    whole = tlm.lm_forward(tmodel, tt[:1, :12], TCFG)
    _rule_close(logits, whole[:, 7].numpy())
    _rule_close(step, whole[:, 8].numpy())
    _rule_close(ext, whole[:, 8:12].numpy())


def test_adapted_layers_leave_the_fused_routes():
    """The fused gates answer as JAX's: an adapted Q/K/V keeps the step off
    B3 (and B7), an adapted wo/w_up/w_down keeps the block off B5 and B6
    (at d_model 512, where the unadapted block takes them)."""
    cfg = tlm.TernaryLMConfig(vocab=64, d_model=512, n_heads=4, d_ff=1024, n_layers=1)
    tp = tlm.pack_lm(tlm.init_lm(rng.make_generator(7, "cpu"), cfg))
    ad = tlora.init_lora_lm(rng.make_generator(8, "cpu"), cfg, rank=4, targets=ALL)
    blk, h = tp["blocks"][0], torch.zeros(1, 512)
    assert ttb._tail_fusable(blk, 1, torch.bfloat16, True)
    assert ttb._mlp_fusable(blk, h, torch.bfloat16, True)
    assert _qkv_prenorm_fusable(blk["attn"], cfg.block.attn, torch.bfloat16, True)
    for name in ALL:
        one = tlora.attach_lora(tp, [{name: ad[0][name]}])["blocks"][0]
        assert ttb._tail_fusable(one, 1, torch.bfloat16, True) == (name in ("wq", "wv"))
        assert ttb._mlp_fusable(one, h, torch.bfloat16, True) == (name not in ("w_up", "w_down"))
        assert _qkv_prenorm_fusable(one["attn"], cfg.block.attn, torch.bfloat16,
                                    True) == (name not in ("wq", "wv"))


def test_lora_rejects_bad_targets_and_mismatch():
    _, tp, _ = _setup(7)
    gen = rng.make_generator(8, "cpu")
    with pytest.raises(ValueError, match="unknown LoRA target"):
        tlora.init_lora_lm(gen, TCFG, targets=("nope",))
    ad = tlora.init_lora_lm(gen, TCFG)
    with pytest.raises(ValueError, match="adapter blocks"):
        tlora.attach_lora(tp, ad[:1])
