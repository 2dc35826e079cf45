"""Port parity: the int8 KV cache slice (smmb_tpu_torch.models.attention's
merged int8 layout, its writes, reads and routes; kernels.fused_mlp B7
``fused_norm_qkv_quant``; kernels.flash_decode B8
``flash_attention_decode_quant``/``_chunk_quant``; ``generate(kv_quant=True)``)
against smmb_tpu.

Inputs are numpy arrays from a seed, fed to both packages; JAX runs its
Pallas kernels in interpret mode, the port its plain versions (CPU tensors).
Tolerances are those of JAX's own tests: tests/test_kv_quant.py (int8 cache
against the f32 cache 2e-2 relative; extend against decode 1e-4),
tests/test_fused_mlp.py (B7: q atol 1e-5, codes within 1, scales rtol 1e-5;
the routed block 5e-3 abs + 1e-3 rel, codes within 1, scales rtol 1e-4) and
tests/test_flash_decode.py (B8 against the dequantized oracle 5e-4).
Where both packages quantize the same float arrays, codes and scales are
compared bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smmb_tpu.formats.packed import pack_ternary as jpack
from smmb_tpu.kernels import flash_decode as jfd
from smmb_tpu.kernels import fused_mlp as jfk
from smmb_tpu.models import attention as jattn
from smmb_tpu.models import lm as jlm
from smmb_tpu.models import transformer as jtb
from smmb_tpu_torch import convert
from smmb_tpu_torch.bench import lm_bench
from smmb_tpu_torch.formats.packed import pack_ternary
from smmb_tpu_torch.kernels import flash_decode as tfd
from smmb_tpu_torch.kernels import fused_mlp as tfk
from smmb_tpu_torch.models import attention as tattn
from smmb_tpu_torch.models import lm as tlm
from smmb_tpu_torch.models import transformer as ttb

torch.set_num_threads(2)
HI = jax.lax.Precision.HIGHEST
INT8_REL = 2e-2  # tests/test_kv_quant.py: the int8 cache's relative error


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _max_err(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))))


def _rel(got, want):
    return _max_err(got, want) / float(np.max(np.abs(np.asarray(want, np.float64))))


def _port_cache(jcache):
    """A JAX int8 cache carried into the port from the same arrays."""
    return {"kv": _t(jcache["kv"]), "kv_scale": _t(jcache["kv_scale"]),
            "pos": int(jcache["pos"])}


# ------------------------------------------------ layout, quantize, writes
def test_quantize_roundtrip_error_bound():
    x = _normal(0, 2, 16, 4, 64) * 3.0
    codes, scale = tattn._quantize_kv(_t(x))
    assert codes.dtype == torch.int8 and scale.shape == (2, 16, 4, 1)
    jcodes, jscale = jattn._quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    back = codes.to(torch.float32) * scale
    assert bool(((back - _t(x)).abs() <= scale * 0.5 + 1e-7).all())
    z, zs = tattn._quantize_kv(torch.zeros(1, 1, 1, 8))
    assert float(z.abs().max()) == 0.0 and float(zs.max()) == 0.0
    # round half to even, as jnp.round: 0.5 → 0, 1.5 → 2, -2.5 → -2
    half, _ = tattn._quantize_kv(torch.tensor([[0.5, 1.5, -2.5, 127.0]]))
    assert half.tolist() == [[0, 2, -2, 127]]


@pytest.mark.parametrize("kv", [None, 2], ids=["mha", "gqa"])
def test_init_and_post_hoc_write_match_jax(kv):
    jcfg = jattn.TernaryAttentionConfig(d_model=512, n_heads=4, n_kv_heads=kv)
    tcfg = tattn.TernaryAttentionConfig(d_model=512, n_heads=4, n_kv_heads=kv)
    tc = tattn.init_kv_cache(tcfg, 2, 16, quantized=True, device="cpu")
    kvh, hd = tcfg.kv_heads, tcfg.head_dim
    assert tc["kv"].shape == (2, 16, 2 * kvh * hd) and tc["kv"].dtype == torch.int8
    assert tc["kv_scale"].shape == (2, 2 * kvh, 16) and tc["kv_scale"].dtype == torch.float32
    assert tc["pos"] == 0 and "k" not in tc
    jc = jattn.init_kv_cache(jcfg, 2, 16, quantized=True)
    k, v = _normal(1, 2, 5, kvh, hd), _normal(2, 2, 5, kvh, hd) * 3.0
    jc = jattn._cache_write(jc, jnp.asarray(k), jnp.asarray(v), 3)
    tc = tattn._cache_write(tc, _t(k), _t(v), 3)
    np.testing.assert_array_equal(tc["kv"].numpy(), np.asarray(jc["kv"]))
    np.testing.assert_array_equal(tc["kv_scale"].numpy(), np.asarray(jc["kv_scale"]))
    assert tc["pos"] == int(jc["pos"]) == 8
    tk, tv = tattn._cache_kv(tc, kvh)
    jk, jv = jattn._cache_kv(jc, kvh)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tattn._cache_code_bytes(tc) == jattn._cache_code_bytes(jc) == 2 * 16 * 2 * kvh * hd
    with pytest.raises(ValueError, match="max_len"):  # JAX clamps; the port raises
        tattn._cache_write(tc, _t(k), _t(v), 12)


def test_lm_init_cache_quantized():
    cfg = tlm.TernaryLMConfig(vocab=64, d_model=128, n_heads=2, d_ff=256, n_layers=2,
                              max_len=32)
    caches = tlm.lm_init_cache(cfg, 2, quantized=True, device="cpu")
    assert len(caches) == 2
    assert all(c["kv"].dtype == torch.int8 and c["kv"].shape == (2, 32, 256) for c in caches)
    assert caches[0]["kv"].data_ptr() != caches[1]["kv"].data_ptr()


# ---------------------------------------------------------------- B7
def _b7_inputs(seed, m, d, kvh, hd, scales=(0.7, 1.1, 0.9)):
    rs = np.random.default_rng(seed)
    kvd = kvh * hd
    n = d + 2 * kvd
    x = rs.uniform(-1, 1, (m, d)).astype(np.float32)
    g = (1.0 + 0.1 * rs.uniform(-1, 1, (d,))).astype(np.float32)
    w = rs.choice(np.array([-1.0, 0.0, 1.0], np.float32), size=(d, n))
    b = rs.uniform(-1, 1, (n,)).astype(np.float32)
    sc = np.concatenate([np.full(d, scales[0]), np.full(kvd, scales[1]),
                         np.full(kvd, scales[2])]).astype(np.float32)
    return x, g, w, b, sc


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
@pytest.mark.parametrize("m,d,kvh,hd", [(3, 512, 2, 128), (2, 512, 1, 256)],
                         ids=["kvh2-hd128", "hd256"])
def test_fused_norm_qkv_quant_matches_jax(cdt, m, d, kvh, hd):
    x, g, w, b, sc = _b7_inputs(m + hd, m, d, kvh, hd)
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[cdt]
    kw = dict(eps=1e-6, d_model=d, kv_heads=kvh, head_dim=hd)
    jq, jcodes, jscales = jfk.fused_norm_qkv_quant(
        jnp.asarray(x), jnp.asarray(g), jpack(w), jnp.asarray(sc), jnp.asarray(b),
        compute_dtype=jdt, **kw)
    before = tfk.fused_norm_qkv_quant.launches
    tq, tcodes, tscales = tfk.fused_norm_qkv_quant(
        _t(x), _t(g), pack_ternary(w, device="cpu"), _t(sc), _t(b), compute_dtype=tdt, **kw)
    assert tfk.fused_norm_qkv_quant.launches == before  # CPU: the plain version
    assert tq.shape == (m, d) and tq.dtype == torch.float32
    assert tcodes.shape == (m, 2 * kvh * hd) and tcodes.dtype == torch.int8
    assert tscales.shape == (m, 2 * kvh) and tscales.dtype == torch.float32
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(tcodes.numpy().astype(np.int32),
                               np.asarray(jcodes, np.int32), atol=1)
    np.testing.assert_allclose(tscales.numpy(), np.asarray(jscales), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_fused_norm_qkv_quant_is_b3_plus_quantize(cdt):
    """Inside the port: B7's q is B3's first d columns bitwise, and its codes
    and scales are bitwise the per-head quantize of B3's f32 output."""
    m, d, kvh, hd = 4, 512, 2, 256
    x, g, w, b, sc = (_t(a) for a in _b7_inputs(7, m, d, kvh, hd))
    p = pack_ternary(w.numpy(), device="cpu")
    q, codes, scales = tfk.fused_norm_qkv_quant(
        x, g, p, sc, b, eps=1e-6, d_model=d, kv_heads=kvh, head_dim=hd, compute_dtype=cdt)
    y = tfk.fused_norm_qkv(x, g, p, sc, b, eps=1e-6, compute_dtype=cdt)
    assert torch.equal(q, y[:, :d])
    want_codes, want_scales = tfk.quantize_heads(y, d, kvh, hd)
    assert torch.equal(codes, want_codes) and torch.equal(scales, want_scales)
    # the interleave: KV head 1's v span holds slot 3
    kq, ks = tattn._quantize_kv(y[:, d + kvh * hd + hd:].reshape(m, 1, hd))
    assert torch.equal(codes[:, 3 * hd:4 * hd], kq.reshape(m, hd))
    assert torch.equal(scales[:, 3], ks.reshape(m))


def test_fused_norm_qkv_quant_rejects_as_jax():
    x, g, w, b, sc = (_t(a) for a in _b7_inputs(8, 2, 512, 2, 128))
    p = pack_ternary(w.numpy(), device="cpu")
    kw = dict(eps=1e-6, d_model=512, head_dim=128)
    with pytest.raises(ValueError, match="float-only"):
        tfk.fused_norm_qkv_quant(x, g, p, sc, b, kv_heads=2, compute_dtype=torch.int8, **kw)
    with pytest.raises(ValueError, match="N="):
        tfk.fused_norm_qkv_quant(x, g, p, sc, b, kv_heads=1, **kw)
    assert tfk.fits_shared_quant(1024, 128) and tfk.fits_shared_quant(1024, 256)
    assert not tfk.fits_shared_quant(8192, 128)


def test_block_decode_quant_epilogue_routes(monkeypatch):
    """block_decode_step over an int8 cache takes B7 (a spy shows the call),
    matches JAX's routed step and the port's own unfused route."""
    jcfg = jtb.TernaryBlockConfig(d_model=512, n_heads=4, d_ff=1024)
    tcfg = ttb.TernaryBlockConfig(d_model=512, n_heads=4, d_ff=1024)
    jp = jtb.pack_block(jtb.init_block(jax.random.PRNGKey(0), jcfg), quantize=True)
    tp = convert.packed_lm_from_jax(jp, device="cpu")
    x_t = np.random.default_rng(21).uniform(-1, 1, (2, 1, 512)).astype(np.float32)
    jy, jc = jtb.block_decode_step(jp, jnp.asarray(x_t),
                                   jtb.init_block_cache(jcfg, 2, 16, quantized=True), jcfg,
                                   compute_dtype=jnp.float32, use_kernel=True, use_flash=True)
    calls = []
    real = tfk.fused_norm_qkv_quant
    monkeypatch.setattr(tfk, "fused_norm_qkv_quant",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ty, tc = ttb.block_decode_step(tp, _t(x_t),
                                   ttb.init_block_cache(tcfg, 2, 16, quantized=True,
                                                        device="cpu"),
                                   tcfg, compute_dtype=torch.float32, use_kernel=True,
                                   use_flash=True)
    assert calls == [1]
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=5e-3, rtol=1e-3)
    np.testing.assert_allclose(tc["kv"].numpy()[:, 0].astype(np.int32),
                               np.asarray(jc["kv"], np.int32)[:, 0], atol=1)
    np.testing.assert_allclose(tc["kv_scale"].numpy()[:, :, 0],
                               np.asarray(jc["kv_scale"])[:, :, 0], rtol=1e-4, atol=1e-6)
    uy, uc = ttb.block_decode_step(tp, _t(x_t),
                                   ttb.init_block_cache(tcfg, 2, 16, quantized=True,
                                                        device="cpu"),
                                   tcfg, compute_dtype=torch.float32, use_kernel=False)
    assert calls == [1]
    np.testing.assert_allclose(ty.numpy(), uy.numpy(), atol=5e-3, rtol=1e-3)
    np.testing.assert_allclose(tc["kv"].numpy()[:, 0].astype(np.int32),
                               uc["kv"].numpy()[:, 0].astype(np.int32), atol=1)


def test_quant_gate_follows_jax():
    cfg = tattn.TernaryAttentionConfig(d_model=512, n_heads=4)
    jcfg = jattn.TernaryAttentionConfig(d_model=512, n_heads=4)
    jp = jattn.pack_attention(jattn.init_attention(jax.random.PRNGKey(1), jcfg))
    tp = convert.packed_lm_from_jax(jp, device="cpu")
    for c, jc in ((cfg, jcfg),
                  (tattn.TernaryAttentionConfig(d_model=512, n_heads=4, rope=True),
                   jattn.TernaryAttentionConfig(d_model=512, n_heads=4, rope=True)),
                  (tattn.TernaryAttentionConfig(d_model=512, n_heads=8),
                   jattn.TernaryAttentionConfig(d_model=512, n_heads=8))):
        for dt, jdt, uk in ((torch.float32, jnp.float32, True),
                            (torch.bfloat16, jnp.bfloat16, True),
                            (torch.float32, jnp.float32, False)):
            assert tattn._qkv_quant_fusable(tp, c, dt, uk) == bool(
                jattn._qkv_quant_fusable(jp, jc, jdt, uk)), (c, dt, uk)


# ---------------------------------------------------------------- B8
def _jax_int8_cache(seed, b, s, kvh, hd, n):
    """JAX's int8 cache with the first n positions written from numpy k, v
    (tests/test_flash_decode.py::_filled_cache)."""
    cfg = jattn.TernaryAttentionConfig(d_model=hd * kvh, n_heads=kvh)
    cache = jattn.init_kv_cache(cfg, b, max_len=s, quantized=True)
    k, v = _normal(seed, b, n, kvh, hd), _normal(seed + 1, b, n, kvh, hd)
    return jattn._cache_write(cache, jnp.asarray(k), jnp.asarray(v), 0)


@pytest.mark.parametrize("h,kvh,window,block_kv", [
    (4, 4, None, 32), (8, 2, None, 32), (4, 2, 16, 32), (4, 4, None, None),
], ids=["mha", "gqa", "window", "kernel-tile"])
def test_flash_decode_int8_cache_matches_jax(h, kvh, window, block_kv):
    b, s, hd, pos = 1, 96, 128, 50
    jc = _jax_int8_cache(11, b, s, kvh, hd, pos + 1)
    q = _normal(12, b, h, hd)
    kc, vc = jattn._cache_kv(jc, kvh)  # dequantized jnp view = the oracle
    want = np.asarray(jattn._decode_attention_math(jnp.asarray(q)[:, None], kc, vc,
                                                   jnp.int32(pos), hd, window=window))
    jgot = np.asarray(jfd.flash_attention_decode_quant(
        jnp.asarray(q), jc["kv"], jc["kv_scale"], jnp.int32(pos), window=window,
        block_kv=32))
    tc = _port_cache(jc)
    before = tfd.flash_attention_decode_quant.launches
    got = tfd.flash_attention_decode_quant(_t(q), tc["kv"], tc["kv_scale"], pos,
                                           window=window, block_kv=block_kv)
    assert tfd.flash_attention_decode_quant.launches == before
    assert got.shape == (b, h, hd) and got.dtype == torch.float32  # q's dtype
    assert _max_err(got.reshape(b, 1, -1), want) < 5e-4
    assert _max_err(got, jgot) < 5e-4


@pytest.mark.parametrize("h,kvh,window", [(4, 4, None), (8, 2, 12)], ids=["mha", "gqa-window"])
def test_flash_chunk_int8_matches_jax(h, kvh, window):
    b, s, hd, pos, c = 1, 96, 128, 20, 4
    jc = _jax_int8_cache(3, b, s, kvh, hd, pos + c)
    q = _normal(4, b, c, h, hd)
    kc, vc = jattn._cache_kv(jc, kvh)
    want = np.asarray(jattn._chunk_attention_math(jnp.asarray(q), kc, vc, jnp.int32(pos), hd,
                                                  window=window))
    jgot = np.asarray(jfd.flash_attention_chunk_quant(
        jnp.asarray(q), jc["kv"], jc["kv_scale"], jnp.int32(pos), window=window, block_kv=32))
    tc = _port_cache(jc)
    got = tfd.flash_attention_chunk_quant(_t(q), tc["kv"], tc["kv_scale"], pos,
                                          window=window, block_kv=32)
    assert got.shape == (b, c, h, hd)
    assert _max_err(got.reshape(b, c, -1), want) < 5e-4
    assert _max_err(got, jgot) < 5e-4


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_flash_int8_rows_bitwise(cdt):
    """Under int8 too, chunk row c equals the decode step at pos + c and a
    batch row equals the row served alone, bitwise (the plain version keeps
    the kernel's order)."""
    b, s, h, kvh, hd, c, pos = 3, 160, 4, 2, 128, 5, 97
    tc = tattn.init_kv_cache(tattn.TernaryAttentionConfig(d_model=kvh * hd, n_heads=kvh),
                             b, s, quantized=True, device="cpu")
    tc = tattn._cache_write(tc, _t(_normal(5, b, pos + c, kvh, hd)),
                            _t(_normal(6, b, pos + c, kvh, hd)), 0)
    q = _t(_normal(7, b, c, h, hd) * 4.0)
    kv, sc = tc["kv"], tc["kv_scale"]
    chunk = tfd.flash_attention_chunk_quant(q, kv, sc, pos, window=70, compute_dtype=cdt)
    assert chunk.dtype == cdt
    for i in range(c):
        solo = tfd.flash_attention_decode_quant(q[:, i], kv, sc, pos + i, window=70,
                                                compute_dtype=cdt)
        assert torch.equal(chunk[:, i], solo), f"row {i}"
    for r in range(b):
        row = tfd.flash_attention_chunk_quant(q[r:r + 1], kv[r:r + 1], sc[r:r + 1], pos,
                                              window=70, compute_dtype=cdt)
        assert torch.equal(chunk[r:r + 1], row), f"batch row {r}"


def test_flash_decode_quant_rejects_as_jax():
    q = torch.zeros(1, 4, 128)
    kv = torch.zeros(1, 16, 4 * 2 * 128, dtype=torch.int8)
    sc = torch.zeros(1, 8, 16)
    with pytest.raises(ValueError, match="no separate v"):
        tfd._cache_attention_plain(q[:, None], kv, kv, 0, None, None, None, None, sc)
    with pytest.raises(ValueError, match="no separate v"):
        tfd.flash_attention_decode_quant(q, kv.float(), sc, 0)
    with pytest.raises(ValueError, match="kv_scale must be"):
        tfd.flash_attention_decode_quant(q, kv, sc[:, :4], 0)
    with pytest.raises(ValueError, match="KVH"):
        tfd.flash_attention_decode_quant(torch.zeros(1, 3, 128), kv, sc, 0)


# ------------------------------------------------------- the chunk gate
def test_int8_chunk_gate_counts_merged_heads():
    """The int8 cache's width is 2·KVH·hd: the gate counts KVH = width //
    (2·hd), so it admits exactly the chunks the kernel block takes (128
    rows at hd 128 over int8, one fewer than over a float cache)."""
    kvd2 = 2 * 8 * 128  # MHA, 8 heads
    assert tfd.flash_chunk_rows_ok(128, 8, 128, kvd2, 1)
    assert not tfd.flash_chunk_rows_ok(129, 8, 128, kvd2, 1)
    assert tfd.flash_chunk_rows_ok(129, 8, 128, 8 * 128, 2)  # the float cache's limit
    gqa2 = 2 * 2 * 128  # 8 query heads over 2 KV heads: g = 4
    assert tfd.flash_chunk_rows_ok(32, 8, 128, gqa2, 1)
    assert not tfd.flash_chunk_rows_ok(33, 8, 128, gqa2, 1)
    assert tfd.shared_bytes(128, 128, True) <= tfd.MAX_SHARED_BYTES < \
        tfd.shared_bytes(129, 128, True)
    cfg = tattn.TernaryAttentionConfig(d_model=1024, n_heads=8, n_kv_heads=2)
    cache = {"kv": torch.empty((1, 64, gqa2), dtype=torch.int8, device="meta"),
             "kv_scale": torch.empty((1, 4, 64), device="meta"), "pos": 0}
    assert tattn._flash_chunk_ok(cache, cfg, 32, True)
    assert not tattn._flash_chunk_ok(cache, cfg, 33, True)
    assert not tattn._flash_chunk_ok(cache, cfg, 4, False)
    # under int8, the decode gate takes B8 at any batch (JAX's `or quant`)
    big = {**cache, "kv": torch.empty((4, 64, gqa2), dtype=torch.int8, device="meta")}
    assert tattn._flash_decode_ok(big, cfg, 4, True)
    assert not tattn._flash_decode_ok(
        {"k": big["kv"].to(torch.bfloat16), "v": big["kv"], "pos": 0}, cfg, 4, True)


@pytest.mark.parametrize("c,want", [(32, 1), (33, 0)], ids=["fits", "too-many-rows"])
def test_int8_extend_route_at_the_limit(monkeypatch, c, want):
    """attention_extend_core over an int8 cache: a chunk within the block's
    rows reads through B8, one row more through the plain chunk math (the
    kernel would refuse it); both give the dequantized answer."""
    cfg = tattn.TernaryAttentionConfig(d_model=1024, n_heads=8, n_kv_heads=2)
    jcfg = jattn.TernaryAttentionConfig(d_model=1024, n_heads=8, n_kv_heads=2)
    tp = convert.packed_lm_from_jax(
        jattn.pack_attention(jattn.init_attention(jax.random.PRNGKey(2), jcfg)), device="cpu")
    calls = []
    real = tfd.flash_attention_chunk_quant
    monkeypatch.setattr(tfd, "flash_attention_chunk_quant",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = _t(_normal(9, 1, c, 1024) * 0.1)
    out, cache = tattn.attention_extend_core(
        tp, x, tattn.init_kv_cache(cfg, 1, 64, quantized=True, device="cpu"), cfg,
        use_flash=True)
    assert len(calls) == want and cache["pos"] == c
    ref, _ = tattn.attention_extend_core(
        tp, x, tattn.init_kv_cache(cfg, 1, 64, quantized=True, device="cpu"), cfg)
    assert _max_err(out, ref) < 1e-4 * max(1.0, float(ref.abs().max()))


# ------------------------------------------------------- serving entries
def test_quantized_decode_near_f32_cache():
    jcfg = jattn.TernaryAttentionConfig(d_model=256, n_heads=4, n_kv_heads=2)
    tcfg = tattn.TernaryAttentionConfig(d_model=256, n_heads=4, n_kv_heads=2)
    tp = convert.packed_lm_from_jax(
        jattn.pack_attention(jattn.init_attention(jax.random.PRNGKey(1), jcfg)), device="cpu")
    x = _t(_normal(2, 2, 12, 256) * 0.1)

    def run(quantized):
        cache = tattn.init_kv_cache(tcfg, 2, 16, quantized=quantized, device="cpu")
        y, cache = tattn.attention_prefill(tp, x[:, :8], cache, tcfg, use_kernel=False)
        ys = [y]
        for i in range(8, 12):
            y_t, cache = tattn.attention_decode_step(tp, x[:, i:i + 1], cache, tcfg,
                                                     use_kernel=False)
            ys.append(y_t)
        return torch.cat(ys, dim=1)

    assert 0 < _rel(run(True), run(False)) < INT8_REL  # quantization happened


def test_quantized_extend_matches_decode_composition():
    jcfg = jattn.TernaryAttentionConfig(d_model=128, n_heads=2)
    tcfg = tattn.TernaryAttentionConfig(d_model=128, n_heads=2)
    jp = jattn.pack_attention(jattn.init_attention(jax.random.PRNGKey(3), jcfg))
    tp = convert.packed_lm_from_jax(jp, device="cpu")
    x = _normal(4, 1, 8, 128) * 0.1
    y1, c1 = tattn.attention_extend(
        tp, _t(x), tattn.init_kv_cache(tcfg, 1, 16, quantized=True, device="cpu"), tcfg,
        use_kernel=False)
    c2 = tattn.init_kv_cache(tcfg, 1, 16, quantized=True, device="cpu")
    ys = []
    for i in range(8):
        y_t, c2 = tattn.attention_decode_step(tp, _t(x[:, i:i + 1]), c2, tcfg,
                                              use_kernel=False)
        ys.append(y_t)
    # the same codes (JAX's check); the scales to the f32 sums' order
    assert torch.equal(c1["kv"], c2["kv"])
    np.testing.assert_allclose(c1["kv_scale"].numpy(), c2["kv_scale"].numpy(), rtol=1e-6)
    np.testing.assert_allclose(y1.numpy(), torch.cat(ys, 1).numpy(), atol=1e-4, rtol=0)
    jy, jc = jattn.attention_extend(jp, jnp.asarray(x),
                                    jattn.init_kv_cache(jcfg, 1, 16, quantized=True), jcfg,
                                    use_kernel=False, precision=HI)
    np.testing.assert_allclose(c1["kv"].numpy().astype(np.int32),
                               np.asarray(jc["kv"], np.int32), atol=1)
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy), atol=1e-4, rtol=0)


@pytest.mark.parametrize("rope,kv,window", [(True, 2, None), (True, 2, 4)],
                         ids=["rope-gqa", "rope-gqa-window"])
def test_unfused_int8_route_matches_jax(rope, kv, window):
    """With rope (no B7: the keys are roped before the quantize) the int8
    cache is written after the fact from B3's (or the unfused product's)
    k and v. Port against JAX at the spread of JAX's own kernel and jnp
    routes on the same step: the two packages' f32 sums
    differ in order, and the quantize can round a code either way."""
    kw = dict(d_model=512, n_heads=4, d_ff=1024, n_kv_heads=kv, rope=rope, window=window)
    jcfg, tcfg = jtb.TernaryBlockConfig(**kw), ttb.TernaryBlockConfig(**kw)
    jp = jtb.pack_block(jtb.init_block(jax.random.PRNGKey(5), jcfg), quantize=True)
    tp = convert.packed_lm_from_jax(jp, device="cpu")
    assert not tattn._qkv_quant_fusable(tp["attn"], tcfg.attn, torch.float32, True)
    x = np.random.default_rng(6).uniform(-1, 1, (2, 7, 512)).astype(np.float32)

    def jax_run(use_kernel):
        c = jtb.init_block_cache(jcfg, 2, 16, quantized=True)
        _, c = jtb.block_prefill(jp, jnp.asarray(x[:, :5]), c, jcfg, use_kernel=use_kernel)
        ys = []
        for i in (5, 6):
            y, c = jtb.block_decode_step(jp, jnp.asarray(x[:, i:i + 1]), c, jcfg,
                                         compute_dtype=jnp.float32, use_kernel=use_kernel)
            ys.append(np.asarray(y))
        return np.concatenate(ys, 1), c

    want, jc = jax_run(True)
    jnp_path, _ = jax_run(False)
    c = ttb.init_block_cache(tcfg, 2, 16, quantized=True, device="cpu")
    _, c = ttb.block_prefill(tp, _t(x[:, :5]), c, tcfg)
    ys = []
    for i in (5, 6):
        y, c = ttb.block_decode_step(tp, _t(x[:, i:i + 1]), c, tcfg, compute_dtype=torch.float32)
        ys.append(y.numpy())
    got = np.concatenate(ys, 1)
    spread = _max_err(jnp_path, want)
    assert _max_err(got, want) <= max(2e-4 + 1e-5 * float(np.abs(want).max()), spread)
    np.testing.assert_allclose(c["kv"].numpy().astype(np.int32), np.asarray(jc["kv"], np.int32),
                               atol=1)


# ------------------------------------------------------------ the LM
CFG = dict(vocab=256, d_model=512, n_heads=4, d_ff=1024, n_layers=1, max_len=32)
JCFG, TCFG = jlm.TernaryLMConfig(**CFG), tlm.TernaryLMConfig(**CFG)


@pytest.fixture(scope="module")
def lm_pair():
    jpacked = jlm.pack_lm(jlm.init_lm(jax.random.PRNGKey(0), JCFG))
    return jpacked, convert.packed_lm_from_jax(jpacked, device="cpu")


def _int8_close(got, want):
    assert _rel(got, want) < INT8_REL


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
def test_lm_prefill_and_decode_int8_match_jax(lm_pair, use_flash):
    jpacked, tpacked = lm_pair
    toks = np.random.default_rng(9).integers(0, 256, (2, 8))
    jl, jc = jlm.lm_prefill(jpacked, jnp.asarray(toks), jlm.lm_init_cache(JCFG, 2,
                                                                          quantized=True),
                            JCFG, use_flash=use_flash)
    tl, tc = tlm.lm_prefill(tpacked, _t(toks), tlm.lm_init_cache(TCFG, 2, quantized=True,
                                                                 device="cpu"),
                            TCFG, use_flash=use_flash)
    _int8_close(tl, jl)
    assert [c["pos"] for c in tc] == [8] and tc[0]["kv"].dtype == torch.int8
    nxt = np.array([5, 11])
    for _ in range(2):
        jl, jc = jlm.lm_decode_step(jpacked, jnp.asarray(nxt), jc, JCFG, use_flash=use_flash)
        tl, tc = tlm.lm_decode_step(tpacked, _t(nxt), tc, TCFG, use_flash=use_flash)
        _int8_close(tl, jl)
        nxt = np.array(jnp.argmax(jl, axis=-1))
    for t, j in zip(tc, jc):
        np.testing.assert_allclose(t["kv"].numpy().astype(np.int32),
                                   np.asarray(j["kv"], np.int32), atol=1)


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
def test_generate_kv_quant_matches_jax(lm_pair, use_flash):
    jpacked, tpacked = lm_pair
    toks = np.random.default_rng(11).integers(0, 256, (2, 8))
    want = np.asarray(jlm.generate(jpacked, jnp.asarray(toks), JCFG, 4, kv_quant=True,
                                   use_flash=use_flash))
    got = tlm.generate(tpacked, _t(toks), TCFG, 4, kv_quant=True, use_flash=use_flash)
    assert got.shape == (2, 4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_kv_quant_generate_tracks_greedy():
    kw = dict(vocab=64, d_model=128, n_heads=2, d_ff=256, n_layers=2, max_len=32)
    jcfg, tcfg = jlm.TernaryLMConfig(**kw), tlm.TernaryLMConfig(**kw)
    jpacked = jlm.pack_lm(jlm.init_lm(jax.random.PRNGKey(5), jcfg))
    tpacked = convert.packed_lm_from_jax(jpacked, device="cpu")
    toks = np.random.default_rng(6).integers(0, 64, (2, 8))
    g0 = tlm.generate(tpacked, _t(toks), tcfg, 8, use_kernel=False).numpy()
    gq = tlm.generate(tpacked, _t(toks), tcfg, 8, use_kernel=False, kv_quant=True).numpy()
    assert gq.shape == (2, 8)
    np.testing.assert_array_equal(gq[:, :2], g0[:, :2])
    jq = np.asarray(jlm.generate(jpacked, jnp.asarray(toks), jcfg, 8, use_kernel=False,
                                 kv_quant=True))
    np.testing.assert_array_equal(gq, jq)


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
def test_lm_extend_and_chunked_prefill_int8_match_jax(lm_pair, use_flash):
    jpacked, tpacked = lm_pair
    toks = np.random.default_rng(2).integers(0, 256, (2, 10))
    _, jc = jlm.lm_prefill(jpacked, jnp.asarray(toks[:, :6]),
                           jlm.lm_init_cache(JCFG, 2, quantized=True), JCFG)
    _, tc = tlm.lm_prefill(tpacked, _t(toks[:, :6]),
                           tlm.lm_init_cache(TCFG, 2, quantized=True, device="cpu"), TCFG)
    jl, jc = jlm.lm_extend(jpacked, jnp.asarray(toks[:, 6:]), jc, JCFG, use_flash=use_flash)
    tl, tc = tlm.lm_extend(tpacked, _t(toks[:, 6:]), tc, TCFG, use_flash=use_flash)
    assert tl.shape == (2, 4, 256) and [c["pos"] for c in tc] == [10]
    _int8_close(tl[:, -1], jl[:, -1])
    # JAX's jitted lm_prefill_chunked runs the jnp chunk path (it traces use_flash);
    # the port's flash chunk path is held against it
    jl, _ = jlm.lm_prefill_chunked(jpacked, jnp.asarray(toks[:, :8]),
                                   jlm.lm_init_cache(JCFG, 2, quantized=True), JCFG, 4)
    tl, tc = tlm.lm_prefill_chunked(tpacked, _t(toks[:, :8]),
                                    tlm.lm_init_cache(TCFG, 2, quantized=True, device="cpu"),
                                    TCFG, 4, use_flash=use_flash)
    _int8_close(tl, jl)
    assert [c["pos"] for c in tc] == [8]


def test_block_extend_int8_rows_equal_decode_steps():
    """A C=4 chunk through block_extend over an int8 cache gives, row for
    row and bitwise, the four decode steps' outputs (B7, B8's chunk entry
    and B5 at M=C), and writes the same codes."""
    cfg = ttb.TernaryBlockConfig(d_model=512, n_heads=4, d_ff=1024)
    jcfg = jtb.TernaryBlockConfig(d_model=512, n_heads=4, d_ff=1024)
    tp = convert.packed_lm_from_jax(
        jtb.pack_block(jtb.init_block(jax.random.PRNGKey(8), jcfg), quantize=True),
        device="cpu")
    x = _t(_normal(9, 1, 7, 512))
    c1 = ttb.init_block_cache(cfg, 1, 16, quantized=True, device="cpu")
    _, c1 = ttb.block_prefill(tp, x[:, :3], c1, cfg, use_flash=True)
    c2 = {**c1, "kv": c1["kv"].clone(), "kv_scale": c1["kv_scale"].clone()}
    chunk, c1 = ttb.block_extend(tp, x[:, 3:], c1, cfg, use_flash=True)
    for i in range(4):
        step, c2 = ttb.block_decode_step(tp, x[:, 3 + i:4 + i], c2, cfg, use_flash=True)
        assert torch.equal(chunk[:, i], step[:, 0]), f"row {i}"
    assert torch.equal(c1["kv"], c2["kv"]) and torch.equal(c1["kv_scale"], c2["kv_scale"])
    assert c1["pos"] == c2["pos"] == 7


def test_lm_bench_takes_kv_quant():
    args = lm_bench.parser().parse_args(["--kv-quant", "--flash"])
    assert args.kv_quant and args.flash
    assert not lm_bench.parser().parse_args([]).kv_quant
