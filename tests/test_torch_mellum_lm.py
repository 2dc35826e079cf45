"""The MoE LM in Mellum2-12B-A2.5B's shape at a tiny size, against the plain
reference ``smmb_tpu_torch/reference/moe_lm.py``; and the new options' defaults.

The tiny model keeps what the published one forces: a head width apart from
d_model (hd 32 over d 48, Q 128 wide), grouped KV heads, windowed and full
layers in one model (two at a window of 8, then one full), 16 experts, top-4
with renormalised gates, every layer routed. Masters are LeCun-scale
(projections over sqrt(fan_in)), served through absmean ternarisation.

Tolerance: the program computes in f32 here, so it differs from the
reference only by the order of its sums and the split of each scale from
its ternary matrix (``(x·s)·T`` against ``x·(s·T)``): ~1e-6 of the largest
logit. ``TOL`` = 1e-4 of it leaves that room a hundredfold, and the
reference rounded to f16 at every activation lands farther off than that
(checked below), so a program computing in f16 or fp8 would fail.
"""

import dataclasses

import pytest
import torch

from smmb_tpu_torch.models import lm as tl
from smmb_tpu_torch.reference import moe_lm as ref

torch.set_num_threads(2)
TOL = 1e-4  # of max|reference logit|: see the module's docstring

CFG = tl.TernaryLMConfig(
    vocab=96, d_model=48, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=32, n_layers=3,
    max_len=32, eps=1e-6, rope=True, rope_theta=5e5, n_experts=16, top_k=4,
    layer_windows=(8, 8, None))


def _lecun(params: dict) -> dict:
    """Projection masters over sqrt(fan_in) (the served scale), in place."""
    for blk in params["blocks"]:
        for name in ("wq", "wk", "wv", "wo"):
            blk["attn"][name] /= blk["attn"][name].shape[0] ** 0.5
        for name in ("w_up", "w_down"):
            blk["moe"][name] /= blk["moe"][name].shape[1] ** 0.5
    params["head"] /= params["head"].shape[0] ** 0.5
    return params


def _model(cfg=CFG, seed=0):
    params = _lecun(tl.init_lm(torch.Generator().manual_seed(seed), cfg))
    return params, tl.pack_lm(params, quantize=True)


def _tokens(b, t, seed=1):
    return torch.randint(0, CFG.vocab, (b, t), generator=torch.Generator().manual_seed(seed))


def _close(got, want):
    err = float((got - want).abs().max())
    assert err <= TOL * float(want.abs().max()), err


def test_config_shapes():
    blocks = CFG.blocks
    assert [b.window for b in blocks] == [8, 8, None]
    assert all(b.attn.head_dim == 32 and b.attn.q_dim == 128 for b in blocks)
    params, _ = _model()
    attn = params["blocks"][0]["attn"]
    assert attn["wq"].shape == (48, 128) and attn["wo"].shape == (128, 48)
    assert attn["wk"].shape == (48, 64)
    with pytest.raises(ValueError, match="windows differ"):
        _ = CFG.block
    with pytest.raises(ValueError, match="entries"):
        dataclasses.replace(CFG, layer_windows=(8, None))


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "plain"])
def test_prefill_logits_match_reference(use_kernel):
    """Every position of a 14-token prompt (past the window of 8), and the
    prefill's last position, against the reference's full forward."""
    params, packed = _model()
    tokens = _tokens(2, 14)
    want = ref.logits(params, tokens, CFG)
    full = tl.lm_forward(packed, tokens, CFG, use_kernel=use_kernel)
    _close(full, want)
    cache = tl.lm_init_cache(CFG, 2, device="cpu")
    last, cache = tl.lm_prefill(packed, tokens, cache, CFG, use_kernel=use_kernel)
    _close(last, want[:, -1])
    assert cache[0]["pos"] == 14


def test_decode_through_the_cache_matches_reference():
    """A 5-token prefill, then decode steps through the cache to position
    15, each step's logits against the reference's full forward over the
    same tokens: the windowed layers' reach crosses the window's edge at 8."""
    params, packed = _model()
    tokens = _tokens(2, 16, seed=2)
    want = ref.logits(params, tokens, CFG)
    cache = tl.lm_init_cache(CFG, 2, device="cpu")
    last, cache = tl.lm_prefill(packed, tokens[:, :5], cache, CFG)
    _close(last, want[:, 4])
    for t in range(5, 16):
        step, cache = tl.lm_decode_step(packed, tokens[:, t], cache, CFG)
        _close(step, want[:, t])
    ext_cache = tl.lm_init_cache(CFG, 2, device="cpu")
    _, ext_cache = tl.lm_prefill(packed, tokens[:, :5], ext_cache, CFG)
    ext, _ = tl.lm_extend(packed, tokens[:, 5:12], ext_cache, CFG)
    _close(ext, want[:, 5:12])


def test_full_layer_sees_past_the_window():
    """The windows matter: the reference with every layer windowed at 8 (or
    every layer full) lies ten tolerances or more from the pattern's logits
    past the window's edge."""
    params, packed = _model()
    tokens = _tokens(1, 16, seed=3)
    got = tl.lm_forward(packed, tokens, CFG)
    for wins in ((8, 8, 8), (None, None, None)):
        other = ref.logits(params, tokens, dataclasses.replace(CFG, layer_windows=wins))
        assert float((other - got)[:, 8:].abs().max()) > 10 * TOL * float(got.abs().max())


def test_tolerance_fails_a_half_precision_program():
    params, _ = _model()
    tokens = _tokens(2, 14)
    want = ref.logits(params, tokens, CFG)
    f16 = ref.logits(params, tokens, CFG, rounding=torch.float16)
    assert float((f16 - want).abs().max()) > TOL * float(want.abs().max())


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_defaults_leave_outputs_unchanged(moe):
    """``head_dim=None`` and ``layer_windows=None`` are today's model: the
    same draws, and bitwise the same logits as the head width and one window
    for every layer spelled out."""
    kw = dict(vocab=64, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64, n_layers=2,
              max_len=24, rope=True, window=6)
    if moe:
        kw.update(n_experts=4, top_k=2)
    base = tl.TernaryLMConfig(**kw)
    spelled = tl.TernaryLMConfig(**kw, head_dim=16, layer_windows=(6, 6))
    assert [b.attn for b in base.blocks] == [b.attn for b in spelled.blocks]
    assert base.block.attn == spelled.block.attn
    outs = []
    for cfg in (base, spelled):
        params = tl.init_lm(torch.Generator().manual_seed(7), cfg)
        packed = tl.pack_lm(params, quantize=True)
        tokens = _tokens(2, 12, seed=8) % 64
        cache = tl.lm_init_cache(cfg, 2, device="cpu")
        last, cache = tl.lm_prefill(packed, tokens, cache, cfg)
        step, _ = tl.lm_decode_step(packed, tokens[:, 0], cache, cfg)
        outs.append((tl.lm_forward(packed, tokens, cfg), last, step))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "plain"])
def test_prefill_spans_name_the_routed_layer_and_the_window(use_flash):
    """One span of each kind a layer: the MoE half, its route, dispatch and
    combine, two B1g calls; the windowed layers' prefill route carries
    ``/w``, the full layer's does not."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    from smmb_tpu_torch.utils import spans

    _, packed = _model()
    tokens = _tokens(2, 12)
    cache = tl.lm_init_cache(CFG, 2, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:  # bf16: the grouped route
        tl.lm_prefill(packed, tokens, cache, CFG, compute_dtype=torch.bfloat16,
                      use_flash=use_flash)
    names = {spans.BLOCK_MOE, spans.MOE_ROUTE, spans.MOE_DISPATCH, spans.MOE_COMBINE,
             spans.KERNEL_B1G, *spans.ATTN_PREFILL}
    n = collections.Counter(e.name() for e in prof.profiler.kineto_results.events()
                            if e.name() in names)
    route = "B9" if use_flash else "plain"
    assert n == {"block.moe": 3, "moe.route": 3, "moe.dispatch": 3, "moe.combine": 3,
                 "kernel.B1g": 6, f"attn.prefill[{route}/w]": 2, f"attn.prefill[{route}]": 1}


def test_bf16_prefill_grouped_equals_slab(monkeypatch):
    """Served in bf16, the LM's routed layers take the grouped experts; the
    prefill's logits are bitwise those of the same model on the per-expert
    slab path."""
    from smmb_tpu_torch.models import moe

    _, packed = _model()
    tokens = _tokens(2, 14)

    def prefill():
        cache = tl.lm_init_cache(CFG, 2, device="cpu")
        return tl.lm_prefill(packed, tokens, cache, CFG, compute_dtype=torch.bfloat16)[0]

    seen = moe.moe_forward.routed_offsets = []
    try:
        grouped = prefill()
    finally:
        moe.moe_forward.routed_offsets = None
    assert len(seen) == CFG.n_layers

    def slab(packed_moe, x, cfg, expert, slot, keep, weight, use_kernel):
        return moe._slab_forward(packed_moe, x, cfg, expert, slot, keep, weight,
                                 moe._round8(x.shape[0]), torch.bfloat16, use_kernel)

    monkeypatch.setattr(moe, "_grouped_forward", slab)
    assert torch.equal(grouped, prefill())
