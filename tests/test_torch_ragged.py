"""Port parity: ragged (left-padded) batches (smmb_tpu_torch.models.lm
``prompt_mask``/``pos_ids`` and the ragged caches of .attention) against
smmb_tpu, twinning tests/test_ragged.py.

The contract: each row of a left-padded batch generates exactly the tokens
it generates as an unpadded batch-1 prompt. The JAX weights are carried
across by convert.py; prompts and masks are numpy arrays from one seed fed
to both packages. Both run their plain paths (``use_kernel=False``), in f32.
Logits across the packages are held at tests/test_torch_lm.py's bound
(2e-4 + 1e-5 of the largest magnitude), inside the port at JAX's own
5e-4 between a padded row and its unpadded prompt.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smmb_tpu.models import lm as jlm
from smmb_tpu_torch import convert
from smmb_tpu_torch.models import lm as tlm

torch.set_num_threads(2)
CFG = dict(vocab=64, d_model=128, n_heads=2, d_ff=256, n_layers=2, max_len=48)


def _pair(seed, **kw):
    jcfg = jlm.TernaryLMConfig(**{**CFG, **kw})
    tcfg = tlm.TernaryLMConfig(**{**CFG, **kw})
    jpacked = jlm.pack_lm(jlm.init_lm(jax.random.PRNGKey(seed), jcfg))
    return jcfg, tcfg, jpacked, convert.packed_lm_from_jax(jpacked, device="cpu")


def _prompts(seed, lengths):
    rs = np.random.default_rng(seed)
    return [rs.integers(0, CFG["vocab"], (1, n)) for n in lengths]


def _padded(prompts, t_pad):
    """Left-pad (1, L) prompts with token 0 to (N, t_pad), and the mask."""
    rows = [np.concatenate([np.zeros((1, t_pad - p.shape[1]), p.dtype), p], 1)
            for p in prompts]
    mask = [np.arange(t_pad)[None] >= t_pad - p.shape[1] for p in prompts]
    return np.concatenate(rows), np.concatenate(mask)


def _jit(fn, cfg):
    """A JAX entry point ``fn(packed, tokens, cache, cfg, ...)`` on its plain
    path, jitted (eager JAX dispatches op by op, slowly on the CPU)."""
    return jax.jit(lambda p, t, c, **kw: fn(p, t, c, cfg, use_kernel=False, **kw))


def _close(got, want, atol=2e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=atol + 1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("rope", [False, True])
def test_ragged_generate_matches_per_row_and_jax(rope):
    jcfg, tcfg, jpacked, tpacked = _pair(0, rope=rope)
    prompts = _prompts(1, (5, 12, 9))
    batch, mask = _padded(prompts, 12)
    got = tlm.generate(tpacked, torch.from_numpy(batch), tcfg, 8, use_kernel=False,
                       prompt_mask=torch.from_numpy(mask)).numpy()
    for r, p in enumerate(prompts):
        alone = tlm.generate(tpacked, torch.from_numpy(p), tcfg, 8, use_kernel=False)
        np.testing.assert_array_equal(got[r], alone.numpy()[0], err_msg=f"row {r}")
    want = jlm.generate(jpacked, jnp.asarray(batch), jcfg, steps=8, use_kernel=False,
                        prompt_mask=jnp.asarray(mask))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_ragged_prefill_logits_and_valid_layout():
    jcfg, tcfg, jpacked, tpacked = _pair(2)
    pa, pb = _prompts(3, (4, 10))
    batch, mask = _padded([pa, pb], 10)
    lr, cache = tlm.lm_prefill(tpacked, torch.from_numpy(batch),
                               tlm.lm_init_cache(tcfg, 2, ragged=True, device="cpu"), tcfg,
                               use_kernel=False, prompt_mask=torch.from_numpy(mask))
    for r, p in enumerate((pa, pb)):
        alone, _ = tlm.lm_prefill(tpacked, torch.from_numpy(p),
                                  tlm.lm_init_cache(tcfg, 1, device="cpu"), tcfg,
                                  use_kernel=False)
        _close(lr[r], alone[0], atol=5e-4)
    jl, jc = _jit(jlm.lm_prefill, jcfg)(jpacked, jnp.asarray(batch),
                                        jlm.lm_init_cache(jcfg, 2, ragged=True),
                                        prompt_mask=jnp.asarray(mask))
    _close(lr, jl)
    valid = cache[0]["valid"]
    assert valid.dtype == torch.bool and valid.shape == (2, 48)
    assert not bool(valid[0, :6].any()) and bool(valid[0, 6:10].all())
    assert not bool(valid[:, 10:].any())  # the unwritten tail
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jc[0]["valid"]))
    assert all(c["pos"] == 10 for c in cache)


def test_ragged_composes_with_kv_quant():
    jcfg, tcfg, jpacked, tpacked = _pair(4)
    batch, mask = _padded(_prompts(5, (3, 8)), 8)
    got = tlm.generate(tpacked, torch.from_numpy(batch), tcfg, 6, use_kernel=False,
                       prompt_mask=torch.from_numpy(mask), kv_quant=True)
    assert got.shape == (2, 6)
    want = jlm.generate(jpacked, jnp.asarray(batch), jcfg, steps=6, use_kernel=False,
                        prompt_mask=jnp.asarray(mask), kv_quant=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_and_extend_pos_ids_match_jax():
    """Per-row learned positions through lm_decode_step and lm_extend over a
    ragged cache (the batched speculative-decoding calls)."""
    jcfg, tcfg, jpacked, tpacked = _pair(6)
    batch, mask = _padded(_prompts(7, (6, 9)), 9)
    jl, jc = _jit(jlm.lm_prefill, jcfg)(jpacked, jnp.asarray(batch),
                                        jlm.lm_init_cache(jcfg, 2, ragged=True),
                                        prompt_mask=jnp.asarray(mask))
    tl, tc = tlm.lm_prefill(tpacked, torch.from_numpy(batch),
                            tlm.lm_init_cache(tcfg, 2, ragged=True, device="cpu"), tcfg,
                            use_kernel=False, prompt_mask=torch.from_numpy(mask))
    row_pos = mask.sum(1)
    tok = np.array(jnp.argmax(jl, -1))
    jl, jc = _jit(jlm.lm_decode_step, jcfg)(jpacked, jnp.asarray(tok), jc,
                                            pos_ids=jnp.asarray(row_pos))
    tl, tc = tlm.lm_decode_step(tpacked, torch.from_numpy(tok), tc, tcfg, use_kernel=False,
                                pos_ids=torch.from_numpy(row_pos))
    _close(tl, jl)
    chunk = np.random.default_rng(8).integers(0, 64, (2, 3))
    ids = row_pos[:, None] + 1 + np.arange(3)[None]
    jl, jc = _jit(jlm.lm_extend, jcfg)(jpacked, jnp.asarray(chunk), jc,
                                       pos_ids=jnp.asarray(ids))
    tl, tc = tlm.lm_extend(tpacked, torch.from_numpy(chunk), tc, tcfg, use_kernel=False,
                           pos_ids=torch.from_numpy(ids))
    assert tl.shape == (2, 3, 64) and tc[0]["pos"] == int(jc[0]["pos"]) == 13
    _close(tl, jl)
    np.testing.assert_array_equal(tc[0]["valid"].numpy(), np.asarray(jc[0]["valid"]))


def test_ragged_attention_math_masks_pads():
    """A pad row attends only itself; real rows never see a pad column."""
    from smmb_tpu.models import attention as jattn
    from smmb_tpu_torch.models import attention as tattn

    jcfg = jattn.TernaryAttentionConfig(d_model=128, n_heads=2, n_kv_heads=1)
    tcfg = tattn.TernaryAttentionConfig(d_model=128, n_heads=2, n_kv_heads=1)
    rs = np.random.default_rng(9)
    q, k, v = (rs.standard_normal((2, 6, d)).astype(np.float32) for d in (128, 64, 64))
    valid = np.arange(6)[None] >= np.array([[2], [0]])
    want = jattn._attention_math(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcfg,
                                 precision=jax.lax.Precision.HIGHEST,
                                 valid=jnp.asarray(valid))
    got = tattn._attention_math(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), tcfg, valid=torch.from_numpy(valid))
    _close(got, want, atol=1e-5)
    # row 1 is unpadded: the mask changes nothing there
    plain = tattn._attention_math(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), tcfg)
    assert torch.equal(got[1], plain[1])


def test_generate_ragged_refuses_flash_prefill_and_chunks():
    _, tcfg, _, tpacked = _pair(10)
    batch, mask = _padded(_prompts(11, (3, 4)), 4)
    with pytest.raises(ValueError, match="ragged"):
        tlm.generate(tpacked, torch.from_numpy(batch), tcfg, 2,
                     prompt_mask=torch.from_numpy(mask), use_flash=True)
    with pytest.raises(ValueError, match="not combinable"):
        tlm.generate(tpacked, torch.from_numpy(batch), tcfg, 2,
                     prompt_mask=torch.from_numpy(mask), prefill_chunk=2)


def test_ragged_cache_layout_matches_jax():
    from smmb_tpu.models import attention as jattn
    from smmb_tpu_torch.models import attention as tattn

    for quantized in (False, True):
        jc = jattn.init_kv_cache(jattn.TernaryAttentionConfig(d_model=128, n_heads=2), 3, 16,
                                 quantized=quantized, ragged=True)
        tc = tattn.init_kv_cache(tattn.TernaryAttentionConfig(d_model=128, n_heads=2), 3, 16,
                                 quantized=quantized, ragged=True, device="cpu")
        assert sorted(tc) == sorted(jc)
        assert tc["valid"].shape == jc["valid"].shape and not bool(tc["valid"].any())
