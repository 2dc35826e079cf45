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
from smmb_tpu_torch.kernels import fused_mlp as tfk
from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
from smmb_tpu_torch.models import attention as tattn
from smmb_tpu_torch.models import lm as tlm
from smmb_tpu_torch.models import spec_decode as tsd
from smmb_tpu_torch.models import transformer as ttb
from smmb_tpu_torch.utils import rng

torch.set_num_threads(2)
CFG = dict(vocab=512, d_model=512, n_heads=4, d_ff=1024, n_layers=2, max_len=32)
JCFG, TCFG = jlm.TernaryLMConfig(**CFG), tlm.TernaryLMConfig(**CFG)
MOE_CFG = tlm.TernaryLMConfig(**CFG, n_experts=4)


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


def _moe_masters():
    return tlm.init_lm(rng.make_generator(13, "cpu"), MOE_CFG)


def _zero_lora(p):
    from smmb_tpu_torch.models.lora import attach_lora, init_lora_lm

    return attach_lora(p, init_lora_lm(rng.make_generator(14, "cpu"), TCFG,
                                       targets=("wq", "w_up", "w_down")))


@pytest.mark.parametrize("call,check", [
    (lambda p, t: tlm.TernaryLMConfig(**{**CFG, "n_experts": 4}).block,
     lambda out, p, t: out.n_experts == 4 and out.moe.d_ff == CFG["d_ff"]),
    (lambda p, t: tlm.qat_lm_forward(_moe_masters(), t, MOE_CFG),
     lambda out, p, t: out.shape == (1, 4, CFG["vocab"]) and bool(torch.isfinite(out).all())),
    (lambda p, t: tlm.make_lm_train_step(MOE_CFG),
     lambda out, p, t: len(out) == 2 and all(callable(f) for f in out)),
    (lambda p, t: tlm.lm_forward(_zero_lora(p), t, TCFG, use_kernel=False),
     lambda out, p, t: torch.equal(out, tlm.lm_forward(p, t, TCFG, use_kernel=False))),
    (lambda p, t: tsd.make_draft_distill_step(p, TCFG, MOE_CFG),
     lambda out, p, t: len(out) == 2 and all(callable(f) for f in out)),
], ids=["moe", "qat_lm_forward", "make_lm_train_step", "lora", "make_draft_distill_step"])
def test_left_out_options_raise(lm_pair, call, check):
    """The options earlier slices left out with a ``NotImplementedError``
    (MoE blocks, LoRA adapters) now run: the MoE block config, its QAT
    forward and train steps, and a zero-B adapter that changes nothing
    (tests/test_torch_moe*.py and test_torch_lora.py hold them against JAX)."""
    _, _, tpacked = lm_pair
    toks = torch.from_numpy(_prompt(13, b=1, t=4))
    assert check(call(tpacked, toks), tpacked, toks)


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


# ------------------------------------------- fork_cache and beam search
SMALL = dict(vocab=64, d_model=128, n_heads=2, d_ff=256, n_layers=2, max_len=32)


def _small_pair(seed):
    jcfg, tcfg = jlm.TernaryLMConfig(**SMALL), tlm.TernaryLMConfig(**SMALL)
    jpacked = jlm.pack_lm(jlm.init_lm(jax.random.PRNGKey(seed), jcfg))
    return jcfg, tcfg, jpacked, convert.packed_lm_from_jax(jpacked, device="cpu")


def test_fork_cache_prefix_caching_matches_jax():
    """Prefill once at batch 1, fork to 3 rows, decode divergent tokens:
    each row matches a full pass over (prompt + its token), and JAX."""
    jcfg, tcfg, jpacked, tpacked = _small_pair(60)
    prompt = np.random.default_rng(61).integers(0, 64, (1, 8))
    div = np.array([5, 17, 42])
    _, cache1 = tlm.lm_prefill(tpacked, torch.from_numpy(prompt),
                               tlm.lm_init_cache(tcfg, 1, device="cpu"), tcfg, use_kernel=False)
    forked = tlm.fork_cache(cache1, 3)
    assert forked[0]["k"].shape == (3, 32, 128) and forked[0]["pos"] == 8
    logits, forked = tlm.lm_decode_step(tpacked, torch.from_numpy(div), forked, tcfg,
                                        use_kernel=False)
    for r in range(3):
        toks = torch.from_numpy(np.concatenate([prompt, div[r:r + 1, None]], 1))
        full = tlm.lm_forward(tpacked, toks, tcfg, use_kernel=False)
        _close(logits[r], full[0, -1], atol=5e-4)
    _, jc = jlm.lm_prefill(jpacked, jnp.asarray(prompt), jlm.lm_init_cache(jcfg, 1), jcfg,
                           use_kernel=False)
    jl, _ = jlm.lm_decode_step(jpacked, jnp.asarray(div), jlm.fork_cache(jc, 3), jcfg,
                               use_kernel=False)
    _close(logits, jl)
    with pytest.raises(ValueError, match="batch-1"):
        tlm.fork_cache(forked, 2)


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_fork_cache_rows_own_their_bytes(quantized):
    """The port writes caches in place, so each forked row is a copy: a
    decode step's write into row 0 leaves row 1's bytes as they were."""
    _, tcfg, _, tpacked = _small_pair(62)
    prompt = torch.from_numpy(np.random.default_rng(63).integers(0, 64, (1, 6)))
    _, cache1 = tlm.lm_prefill(tpacked, prompt,
                               tlm.lm_init_cache(tcfg, 1, quantized=quantized, device="cpu"),
                               tcfg, use_kernel=False)
    forked = tlm.fork_cache(cache1, 2)
    before = [{k: v.clone() for k, v in c.items() if isinstance(v, torch.Tensor)}
              for c in forked]
    row0 = [{k: (v[:1] if isinstance(v, torch.Tensor) else v) for k, v in c.items()}
            for c in forked]  # views of row 0 alone
    tlm.lm_decode_step(tpacked, torch.tensor([7]), row0, tcfg, use_kernel=False)
    for c, b in zip(forked, before):
        for name, old in b.items():
            assert torch.equal(c[name][1], old[1]), name
            assert c[name].data_ptr() != cache1[0][name].data_ptr()
        assert not torch.equal(c["kv" if quantized else "k"][0], b["kv" if quantized else "k"][0])


def test_beam_search_matches_greedy_and_jax():
    jcfg, tcfg, jpacked, tpacked = _small_pair(80)
    prompt = np.random.default_rng(81).integers(0, 64, (1, 8))
    tp = torch.from_numpy(prompt)
    greedy = tlm.generate(tpacked, tp, tcfg, 8, use_kernel=False)
    b1, s1 = tlm.generate_beam(tpacked, tp, tcfg, 8, beam=1, use_kernel=False)
    np.testing.assert_array_equal(b1.numpy(), greedy.numpy())
    b4, s4 = tlm.generate_beam(tpacked, tp, tcfg, 8, beam=4, use_kernel=False)
    assert b4.shape == (4, 8) and s4.dtype == torch.float32
    assert bool((s4[1:] <= s4[:-1] + 1e-6).all())  # best first
    assert float(s4[0]) >= float(s1[0]) - 1e-5  # a wider beam never scores worse
    jb4, js4 = jlm.generate_beam(jpacked, jnp.asarray(prompt), jcfg, steps=8, beam=4,
                                 use_kernel=False)
    np.testing.assert_array_equal(b4.numpy(), np.asarray(jb4))
    _close(s4, js4)
    with pytest.raises(ValueError, match="batch-1"):
        tlm.generate_beam(tpacked, torch.zeros((2, 4), dtype=torch.int64), tcfg, 4,
                          use_kernel=False)
