"""Port parity: the ternary LM serving slice (smmb_tpu_torch.models.attention,
.transformer, .lm and convert's LM converters) against smmb_tpu.models.

The JAX weights are carried into the port by convert.py, so both packages
compute with the same packed planes; prompts and inputs are numpy arrays.
JAX runs its Pallas kernels in interpret mode (``use_kernel=True``), the
port its plain versions. The configuration is small (d_model 512, so that
the fused QKV route is taken; 4 heads; d_ff 1024; vocab 512; 2 layers).

Tolerances are the JAX tests' (tests/test_lm.py, tests/test_attention.py,
tests/test_fused_mlp.py: 2e-4 abs; the fused block decode adds rtol 1e-4)
plus 1e-5 of the output's largest magnitude. Within JAX the paths compared
share one kernel; across the packages the f32 products are summed in
different orders (about 1e-7 relative each), and the random model's
unnormalised attention scores (in the hundreds) amplify that through the
softmax: JAX's own kernel and jnp paths differ by up to 2.9e-2 on
``lm_forward``'s logits at this configuration. So, as tests/test_lm.py
does, forward logits are compared at the last position. Greedy f32 tokens
are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smmb_tpu.models import attention as jattn
from smmb_tpu.models import lm as jlm
from smmb_tpu.models import transformer as jtb
from smmb_tpu_torch import convert
from smmb_tpu_torch.kernels import flash_attention as tfa
from smmb_tpu_torch.kernels import fused_mlp as tfk
from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
from smmb_tpu_torch.models import attention as tattn
from smmb_tpu_torch.models import lm as tlm
from smmb_tpu_torch.models import transformer as ttb
from smmb_tpu_torch.utils import rng

torch.set_num_threads(2)
CFG = dict(vocab=512, d_model=512, n_heads=4, d_ff=1024, n_layers=2, max_len=32)
JCFG, TCFG = jlm.TernaryLMConfig(**CFG), tlm.TernaryLMConfig(**CFG)


@pytest.fixture(scope="module")
def lm_pair():
    params = jlm.init_lm(jax.random.PRNGKey(0), JCFG)
    jpacked = jlm.pack_lm(params)
    return params, jpacked, convert.packed_lm_from_jax(jpacked, device="cpu")


def _close(got, want, atol=2e-4, rtol=0.0):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol + 1e-5 * float(np.abs(want).max()))


def _prompt(seed, b=2, t=8):
    return np.random.default_rng(seed).integers(0, CFG["vocab"], (b, t))


def _cache():
    return tlm.lm_init_cache(TCFG, 2, device="cpu")


def test_converted_planes_are_jax_bytes(lm_pair):
    _, jpacked, tpacked = lm_pair
    for jb, tb in zip(jpacked["blocks"], tpacked["blocks"]):
        for name in ("wq", "wk", "wv", "wo", "wqkv"):
            np.testing.assert_array_equal(tb["attn"][name].data.numpy(),
                                          np.asarray(jb["attn"][name].data))
        np.testing.assert_array_equal(tb["w_up"].data.numpy(), np.asarray(jb["w_up"].data))
    assert tpacked["head"].shape == (512, 512)
    assert tpacked["blocks"][0]["attn"]["qkv_scale"].shape == (3 * 512,)


def test_lm_params_from_jax_packs_like_jax(lm_pair):
    params, jpacked, _ = lm_pair
    np_params = jax.tree_util.tree_map(np.asarray, params)
    tparams = convert.lm_params_from_jax(np_params, device="cpu")
    tpacked = tlm.pack_lm(tparams)
    for jb, tb in zip(jpacked["blocks"], tpacked["blocks"]):
        np.testing.assert_array_equal(tb["attn"]["wqkv"].data.numpy(),
                                      np.asarray(jb["attn"]["wqkv"].data))
        np.testing.assert_array_equal(tb["w_down"].data.numpy(),
                                      np.asarray(jb["w_down"].data))
    toks = _prompt(1)
    want = np.asarray(jlm.lm_forward(jpacked, jnp.asarray(toks), JCFG))
    got = tlm.lm_forward(tpacked, torch.from_numpy(toks), TCFG).numpy()
    assert got.shape == want.shape == (2, 8, 512)
    _close(got[:, -1], want[:, -1])


@pytest.mark.parametrize("rope,kv", [(False, None), (True, 2)], ids=["mha", "rope-gqa"])
def test_attention_prefill_and_decode_match_jax(rope, kv):
    jcfg = jattn.TernaryAttentionConfig(d_model=512, n_heads=4, rope=rope, n_kv_heads=kv)
    tcfg = tattn.TernaryAttentionConfig(d_model=512, n_heads=4, rope=rope, n_kv_heads=kv)
    jp = jattn.pack_attention(jattn.init_attention(jax.random.PRNGKey(3), jcfg))
    tp = convert.packed_lm_from_jax(jp, device="cpu")
    rs = np.random.default_rng(4)
    x = rs.uniform(-1, 1, (2, 6, 512)).astype(np.float32)
    x_t = rs.uniform(-1, 1, (2, 1, 512)).astype(np.float32)
    jy, jc = jattn.attention_prefill(jp, jnp.asarray(x), jattn.init_kv_cache(jcfg, 2, 16), jcfg)
    tc = tattn.init_kv_cache(tcfg, 2, 16, device="cpu")
    assert tc["k"].shape == (2, 16, tcfg.kv_dim) and tc["pos"] == 0  # flat layout
    ty, tc = tattn.attention_prefill(tp, torch.from_numpy(x), tc, tcfg)
    _close(ty, jy)
    _close(tc["k"], jc["k"], atol=1e-5)
    assert tc["pos"] == int(jc["pos"]) == 6
    jd, jc = jattn.attention_decode_step(jp, jnp.asarray(x_t), jc, jcfg)
    td, tc = tattn.attention_decode_step(tp, torch.from_numpy(x_t), tc, tcfg)
    _close(td, jd)
    _close(tc["v"], jc["v"], atol=1e-5)
    assert tc["pos"] == 7


@pytest.mark.parametrize("kv,dff", [(None, 1024), (2, 3072)], ids=["mha", "gqa-3072"])
def test_block_decode_fused_tail_matches_jax(kv, dff):
    jcfg = jtb.TernaryBlockConfig(d_model=512, n_heads=4, d_ff=dff, n_kv_heads=kv, rope=True)
    tcfg = ttb.TernaryBlockConfig(d_model=512, n_heads=4, d_ff=dff, n_kv_heads=kv, rope=True)
    jp = jtb.pack_block(jtb.init_block(jax.random.PRNGKey(5), jcfg), quantize=True)
    tp = convert.packed_lm_from_jax(jp, device="cpu")
    assert ttb._tail_fusable(tp, 2, torch.float32, True)
    assert tattn._qkv_prenorm_fusable(tp["attn"], tcfg.attn, torch.float32, True)
    x_t = np.random.default_rng(6).uniform(-1, 1, (2, 1, 512)).astype(np.float32)
    want, _ = jtb.block_decode_step(jp, jnp.asarray(x_t), jtb.init_block_cache(jcfg, 2, 16),
                                    jcfg, compute_dtype=jnp.float32, use_kernel=True)
    got, cache = ttb.block_decode_step(tp, torch.from_numpy(x_t),
                                       ttb.init_block_cache(tcfg, 2, 16, device="cpu"),
                                       tcfg, compute_dtype=torch.float32, use_kernel=True)
    _close(got, want, rtol=1e-4)
    ref, _ = ttb.block_decode_step(tp, torch.from_numpy(x_t),
                                   ttb.init_block_cache(tcfg, 2, 16, device="cpu"),
                                   tcfg, compute_dtype=torch.float32, use_kernel=False)
    _close(got, ref, rtol=1e-4)
    assert cache["pos"] == 1


def test_block_prefill_fused_mlp_matches_jax():
    jcfg = jtb.TernaryBlockConfig(d_model=512, n_heads=4, d_ff=1024)
    tcfg = ttb.TernaryBlockConfig(d_model=512, n_heads=4, d_ff=1024)
    jp = jtb.pack_block(jtb.init_block(jax.random.PRNGKey(7), jcfg))
    tp = convert.packed_lm_from_jax(jp, device="cpu")
    x = np.random.default_rng(8).uniform(-1, 1, (1, 8, 512)).astype(np.float32)
    assert ttb._mlp_fusable(tp, torch.zeros(8, 512), torch.float32, True)
    want, _ = jtb.block_prefill(jp, jnp.asarray(x), jtb.init_block_cache(jcfg, 1, 16), jcfg)
    got, _ = ttb.block_prefill(tp, torch.from_numpy(x),
                               ttb.init_block_cache(tcfg, 1, 16, device="cpu"), tcfg)
    _close(got, want, rtol=1e-4)


def test_lm_prefill_and_decode_logits_match_jax(lm_pair):
    _, jpacked, tpacked = lm_pair
    toks = _prompt(9)
    jl, jc = jlm.lm_prefill(jpacked, jnp.asarray(toks), jlm.lm_init_cache(JCFG, 2), JCFG)
    tl, tc = tlm.lm_prefill(tpacked, torch.from_numpy(toks), _cache(), TCFG)
    _close(tl, jl)
    assert [c["pos"] for c in tc] == [8, 8]
    nxt = np.array([5, 11])
    for _ in range(2):
        jl, jc = jlm.lm_decode_step(jpacked, jnp.asarray(nxt), jc, JCFG)
        tl, tc = tlm.lm_decode_step(tpacked, torch.from_numpy(nxt), tc, TCFG)
        _close(tl, jl)
        nxt = np.array(jnp.argmax(jl, axis=-1))


def test_lm_decode_matches_forward(lm_pair):
    # inside the port: prefill T-1 then one decode step == full forward
    _, _, tpacked = lm_pair
    toks = torch.from_numpy(_prompt(10))
    full = tlm.lm_forward(tpacked, toks, TCFG)
    _, cache = tlm.lm_prefill(tpacked, toks[:, :-1], _cache(), TCFG)
    step, _ = tlm.lm_decode_step(tpacked, toks[:, -1], cache, TCFG)
    _close(step, full[:, -1])


def test_generate_greedy_matches_jax(lm_pair):
    _, jpacked, tpacked = lm_pair
    toks = _prompt(11)
    want = np.asarray(jlm.generate(jpacked, jnp.asarray(toks), JCFG, 4))
    before = (packed_spmm.launches, tfk.fused_norm_qkv.launches,
              tfk.fused_block_tail.launches, tfk.fused_mlp.launches)
    got = tlm.generate(tpacked, torch.from_numpy(toks), TCFG, 4)
    assert got.shape == (2, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    # CPU tensors run the plain versions: no kernel launch is counted
    assert before == (packed_spmm.launches, tfk.fused_norm_qkv.launches,
                      tfk.fused_block_tail.launches, tfk.fused_mlp.launches)


def test_sampler_masks_and_determinism():
    logits = torch.tensor([[0.0, 3.0, 1.0, 2.5], [5.0, -1.0, 4.9, 0.0]])
    assert tlm._make_sampler(0.0, None)(None, logits).tolist() == [1, 0]
    top1 = tlm._make_sampler(1.0, 1)
    gen = rng.make_generator(0, "cpu")
    assert all(top1(gen, logits).tolist() == [1, 0] for _ in range(5))
    nucleus = tlm._make_sampler(1.0, None, top_p=0.5)
    seen = {tuple(nucleus(gen, logits).tolist()) for _ in range(20)}
    assert all(a in (1, 3) and b in (0, 2) for a, b in seen)
    a = tlm._make_sampler(0.7, 3)(rng.make_generator(4, "cpu"), logits.repeat(8, 1))
    b = tlm._make_sampler(0.7, 3)(rng.make_generator(4, "cpu"), logits.repeat(8, 1))
    assert torch.equal(a, b)


def test_generate_sampling_needs_a_generator_and_fits_max_len(lm_pair):
    _, _, tpacked = lm_pair
    toks = torch.from_numpy(_prompt(12, b=1, t=4))
    with pytest.raises(ValueError, match="Generator"):
        tlm.generate(tpacked, toks, TCFG, 2, temperature=0.8)
    with pytest.raises(ValueError, match="max_len"):
        tlm.generate(tpacked, toks, TCFG, 29)
    out = tlm.generate(tpacked, toks, TCFG, 3, temperature=0.8, top_k=5,
                       generator=rng.make_generator(1, "cpu"))
    assert out.shape == (1, 3) and int(out.max()) < CFG["vocab"]


@pytest.mark.parametrize("call,match", [
    (lambda p, t: tfa.flash_attention(*(torch.zeros(1, 2, 4, 128),) * 3,
                                      pipeline_p=True), "B9"),
    (lambda p, t: tlm.generate(p, t, TCFG, 2, prompt_mask=torch.ones_like(t)), "ragged"),
    (lambda p, t: tlm.lm_extend(p, t, tlm.lm_init_cache(TCFG, 1, device="cpu"), TCFG,
                                pos_ids=t), "ragged"),
    (lambda p, t: tlm.fork_cache([], 2), "fork_cache"),
    (lambda p, t: tlm.generate_beam(p, t, TCFG, 2), "generate_beam"),
    (lambda p, t: tlm.lm_decode_step(p, t[:, 0], [{"pos": 0}], TCFG,
                                     pos_ids=t[:, 0]), "ragged"),
    (lambda p, t: tlm.TernaryLMConfig(**{**CFG, "n_experts": 4}).block, "MoE"),
    (lambda p, t: tlm.qat_lm_forward({}, t, TCFG), "qat_lm_forward"),
    (lambda p, t: tlm.make_lm_train_step(TCFG), "make_lm_train_step"),
    (lambda p, t: tlm.lm_forward(
        {**p, "blocks": [{**p["blocks"][0], "w_up_lora": (1, 2, 3)}]}, t, TCFG), "LoRA"),
], ids=["pipeline_p", "prompt_mask", "extend_pos_ids", "fork_cache", "generate_beam",
        "pos_ids", "moe", "qat_lm_forward", "make_lm_train_step", "lora"])
def test_left_out_options_raise(lm_pair, call, match):
    _, _, tpacked = lm_pair
    with pytest.raises(NotImplementedError, match=match):
        call(tpacked, torch.from_numpy(_prompt(13, b=1, t=4)))


def test_lm_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.lm_init_cache(TCFG, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.packed_lm_from_jax({"norm_f": np.ones(4, np.float32)})


def test_init_lm_on_the_port(lm_pair):
    cfg = tlm.TernaryLMConfig(vocab=64, d_model=512, n_heads=4, d_ff=512,
                              n_layers=1, max_len=16)
    params = tlm.init_lm(rng.make_generator(0, "cpu"), cfg)
    assert params["embed"].shape == (64, 512) and params["pos"].shape == (16, 512)
    assert set(np.unique(params["head"].numpy())) <= {-1.0, 0.0, 1.0}
    packed = tlm.pack_lm(params, quantize=True)
    assert packed["blocks"][0]["attn"]["wqkv"].shape == (512, 3 * 512)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 64, (1, 5)))
    out = tlm.generate(packed, toks, cfg, 3)
    assert out.shape == (1, 3)
