"""Port parity: the split of the live cache in B4 and B8
(smmb_tpu_torch.kernels.flash_decode): spans of ``split_cols(S)`` columns,
cut at absolute multiples of the span, each walked as the kernel walks it,
and their partial states combined in ascending order.

The plain version walks the kernel's spans and combine, and takes
``split_cols`` to force many spans at small S; held against JAX's unsplit
kernels (interpret mode, jitted entries) at the tolerances of the existing
twins: f32 2e-5 (tests/test_torch_flash.py), int8 5e-4
(tests/test_torch_kv_quant.py). Row identity is held bitwise: chunk rows
against the decode steps (chunks straddling a span boundary, windows whose
edge lies inside a span) and batch rows against the rows served alone, in
f32 and bf16, in both modes.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smmb_tpu.kernels import flash_decode as jfd
from smmb_tpu.models import attention as jattn
from smmb_tpu_torch.kernels import flash_decode as tfd
from smmb_tpu_torch.models import attention as tattn

torch.set_num_threads(2)
HD = 128


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _max_err(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))))


def _float_cache(seed, b, s, kvh, n):
    """Flat (B, S, KVH·hd) caches with the first n positions written."""
    kc = np.zeros((b, s, kvh * HD), np.float32)
    vc = np.zeros_like(kc)
    kc[:, :n] = _normal(seed, b, n, kvh * HD)
    vc[:, :n] = _normal(seed + 1, b, n, kvh * HD)
    return kc, vc


def _int8_cache(seed, b, s, kvh, n):
    """JAX's merged int8 cache with the first n positions written, and the
    same arrays as the port's cache."""
    cfg = jattn.TernaryAttentionConfig(d_model=HD * kvh, n_heads=kvh)
    cache = jattn.init_kv_cache(cfg, b, max_len=s, quantized=True)
    k, v = _normal(seed, b, n, kvh, HD), _normal(seed + 1, b, n, kvh, HD)
    jc = jattn._cache_write(cache, jnp.asarray(k), jnp.asarray(v), 0)
    return jc, torch.from_numpy(np.array(jc["kv"])), torch.from_numpy(np.array(jc["kv_scale"]))


# ------------------------------------------------------------ the spans
@pytest.mark.parametrize("s_len", [1, 64, 65, 224, 1024, 2047, 2048, 2049, 8192, 32768, 40000])
def test_split_cols_depends_on_s_alone_and_tiles_the_cache(s_len):
    span = tfd.split_cols(s_len)
    assert span % tfd.KV_TILE == 0 and span > 0
    assert -(-s_len // span) <= tfd.MAX_SPLITS
    # the smallest such multiple of the tile: one tile less would need more spans
    if span > tfd.KV_TILE:
        assert -(-s_len // (span - tfd.KV_TILE)) > tfd.MAX_SPLITS
    # every call on this cache reads whole spans at absolute multiples of
    # the span, from the one holding token 0's window edge to the one
    # holding its last row; the span itself never moves
    for pos in sorted({0, s_len // 3, s_len - 1}):
        for nq in (1, 4):
            if pos + nq > s_len:
                continue
            for window in (None, 1, 70, 1000):
                first, count = tfd.live_spans(pos, nq, window, span)
                edge = max(0, pos - window + 1) if window else 0
                assert first * span <= edge < (first + 1) * span
                last = first + count - 1
                assert last * span <= pos + nq - 1 < (last + 1) * span
                assert count <= tfd.MAX_SPLITS


def test_kernel_source_constants_match():
    """The tile and the copy ring in csrc/flash_decode.cu are the wrapper's
    KV_TILE and KV_RING, and its combine takes MAX_SPLITS spans."""
    src = (Path(tfd.__file__).parent / "csrc" / "flash_decode.cu").read_text()
    tk = int(re.search(r"constexpr int TK = (\d+);", src)[1])
    assert tk == tfd.KV_TILE
    assert int(re.search(r"constexpr int RING = (\d+);", src)[1]) == tfd.KV_RING
    spans = re.search(r"constexpr int MAX_SPANS = (\w+);", src)[1]
    assert tfd.MAX_SPLITS <= (tk if spans == "TK" else int(spans))


# ------------------------------------------------- forced spans vs JAX
@pytest.mark.parametrize("s,pos,window", [(256, 200, None), (512, 397, 150), (384, 300, 45)],
                         ids=["s256", "s512-window", "s384-window"])
def test_forced_spans_float_match_jax(s, pos, window):
    """Spans of 32 columns: the live prefix crosses several spans, and a
    window's edge lies inside a span (pos 397, window 150: edge 248)."""
    b, h, kvh, c = 2, 4, 2, 3
    kc, vc = _float_cache(s + pos, b, s, kvh, pos + c)
    q = _normal(pos, b, c, h, HD)
    kw = dict(window=window, block_kv=32)
    want = jfd.flash_attention_decode(jnp.asarray(q[:, 0]), jnp.asarray(kc), jnp.asarray(vc),
                                      jnp.int32(pos), **kw)
    got = tfd.flash_attention_decode_plain(torch.from_numpy(q[:, 0]), torch.from_numpy(kc),
                                           torch.from_numpy(vc), pos, split_cols=32, **kw)
    assert _max_err(got, want) < 2e-5
    want = jfd.flash_attention_chunk(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                     jnp.int32(pos), **kw)
    got = tfd.flash_attention_chunk_plain(torch.from_numpy(q), torch.from_numpy(kc),
                                          torch.from_numpy(vc), pos, split_cols=32, **kw)
    assert got.shape == (b, c, h, HD)
    assert _max_err(got, want) < 2e-5


@pytest.mark.parametrize("s,pos,window", [(256, 200, None), (512, 397, 150)],
                         ids=["s256", "s512-window"])
def test_forced_spans_int8_match_jax(s, pos, window):
    b, h, kvh, c = 1, 4, 2, 3
    jc, kv, sc = _int8_cache(s + pos, b, s, kvh, pos + c)
    q = _normal(pos + 1, b, c, h, HD)
    kw = dict(window=window, block_kv=32)
    want = jfd.flash_attention_decode_quant(jnp.asarray(q[:, 0]), jc["kv"], jc["kv_scale"],
                                            jnp.int32(pos), **kw)
    got = tfd.flash_attention_decode_quant_plain(torch.from_numpy(q[:, 0]), kv, sc, pos,
                                                 split_cols=32, **kw)
    assert _max_err(got, want) < 5e-4
    want = jfd.flash_attention_chunk_quant(jnp.asarray(q), jc["kv"], jc["kv_scale"],
                                           jnp.int32(pos), **kw)
    got = tfd.flash_attention_chunk_quant_plain(torch.from_numpy(q), kv, sc, pos,
                                                split_cols=32, **kw)
    assert _max_err(got, want) < 5e-4


# --------------------------------------------------------- row identity
def _entries(quant, b, s, kvh, n, cdt):
    """The plain (decode, chunk) entries of a mode and the cache buffers
    they take, the first n positions written."""
    if quant:
        tc = tattn.init_kv_cache(tattn.TernaryAttentionConfig(d_model=kvh * HD, n_heads=kvh),
                                 b, s, quantized=True, device="cpu")
        tc = tattn._cache_write(tc, torch.from_numpy(_normal(21, b, n, kvh, HD)),
                                torch.from_numpy(_normal(22, b, n, kvh, HD)), 0)
        bufs = (tc["kv"], tc["kv_scale"])
        dec, chunk = tfd.flash_attention_decode_quant_plain, tfd.flash_attention_chunk_quant_plain
    else:
        bufs = tuple(torch.from_numpy(a).to(cdt) for a in _float_cache(23, b, s, kvh, n))
        dec, chunk = tfd.flash_attention_decode_plain, tfd.flash_attention_chunk_plain
    return dec, chunk, bufs


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("split,pos,window", [
    (32, 62, None),   # rows 62..66 straddle the span boundary at 64
    (32, 93, 40),     # and at 96, with the window's edges (54..58) inside a span
    (None, 125, 70),  # the kernel's own spans (64 columns at S = 192)
], ids=["straddle", "straddle-window", "kernel-spans"])
def test_chunk_rows_bitwise_decode_steps(quant, cdt, split, pos, window):
    b, s, h, kvh, c = 2, 192, 4, 2, 5
    dec, chunk, bufs = _entries(quant, b, s, kvh, pos + c, cdt)
    q = torch.from_numpy(_normal(24, b, c, h, HD) * 4.0)
    kw = dict(window=window, compute_dtype=cdt, split_cols=split)
    rows = chunk(q, *bufs, pos, **kw)
    assert rows.dtype == cdt
    for i in range(c):
        assert torch.equal(rows[:, i], dec(q[:, i], *bufs, pos + i, **kw)), f"row {i}"
    # the chunk's launch holds more spans than row 0's decode step
    span = split or tfd.split_cols(s)
    assert tfd.live_spans(pos, c, window, span)[1] > tfd.live_spans(pos, 1, window, span)[1]


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_batch_rows_bitwise_rows_alone(quant, cdt):
    b, s, h, kvh, pos = 3, 160, 4, 2, 130
    dec, chunk, bufs = _entries(quant, b, s, kvh, pos + 1, cdt)
    q = torch.from_numpy(_normal(25, b, h, HD) * 4.0)
    kw = dict(window=100, compute_dtype=cdt, split_cols=32)
    batched = dec(q, *bufs, pos, **kw)
    for r in range(b):
        alone = dec(q[r:r + 1], *(t[r:r + 1] for t in bufs), pos, **kw)
        assert torch.equal(batched[r:r + 1], alone), f"batch row {r}"


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_one_live_span_bitwise_a_larger_span(quant, cdt):
    """A launch with one live span combines one state with weight exp2(0)
    = 1: the same bits as that span's state divided out, whatever the
    span's length."""
    b, s, h, kvh, pos = 1, 256, 4, 2, 27
    dec, chunk, bufs = _entries(quant, b, s, kvh, pos + 4, cdt)
    q = torch.from_numpy(_normal(26, b, 4, h, HD) * 4.0)
    for span in (32, 64, 256):
        assert tfd.live_spans(pos, 4, None, span)[1] == 1
    kw = dict(compute_dtype=cdt, block_kv=16)
    got = {span: chunk(q, *bufs, pos, split_cols=span, **kw) for span in (32, 64, 256)}
    assert torch.equal(got[32], got[64]) and torch.equal(got[32], got[256])
    assert torch.equal(dec(q[:, 0], *bufs, pos, split_cols=32, **kw),
                       dec(q[:, 0], *bufs, pos, split_cols=1024, **kw))


def test_split_plain_rejects_a_bad_span():
    q = torch.zeros(1, 4, HD)
    kc = torch.zeros(1, 64, 4 * HD)
    with pytest.raises(ValueError, match="split_cols"):
        tfd.flash_attention_decode_plain(q, kc, kc, 3, split_cols=0)


# -------------------------------------------------------- the chunk gate
def _first_kernel_limit(c, h, hd, kvd, cache_itemsize):
    """The first kernel's block, as flash_chunk_rows_ok decided it before the
    split: f32 rows, scores, accumulators, m, l, rescale, one f32 K and V
    tile of 64 columns and, over the int8 cache, 128 f32 scales."""
    quant = cache_itemsize == 1
    kvh = max(1, kvd // (2 * hd if quant else hd))
    rows = c * (h // kvh)
    need = 4 * (rows * (2 * hd + 64 + 3) + 2 * 64 * hd + (128 if quant else 0))
    return need <= 232448


@pytest.mark.parametrize("hd,kvd,itemsize", [
    (128, 1024, 2), (128, 1024, 4), (128, 256, 2), (128, 2048, 1), (128, 512, 1),
    (256, 1024, 2), (256, 2048, 1),
])
def test_flash_chunk_rows_ok_unchanged(hd, kvd, itemsize):
    """The extend route answers as before the split, at every chunk size up
    to past its limit, and the split kernel's block fits every chunk the
    route admits (its copy ring drops to fewer slots where more do not
    fit)."""
    h = 8 if kvd // hd >= 8 else 4 * max(1, kvd // hd // (2 if itemsize == 1 else 1))
    for c in range(1, 300):
        want = _first_kernel_limit(c, h, hd, kvd, itemsize)
        assert tfd.flash_chunk_rows_ok(c, h, hd, kvd, itemsize) is want, c
        if want:
            quant = itemsize == 1
            kvh = max(1, kvd // (2 * hd if quant else hd))
            rows = c * (h // kvh)
            assert tfd.kernel_shared_bytes(rows, hd, itemsize, quant) <= tfd.MAX_SHARED_BYTES
