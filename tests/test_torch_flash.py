"""Port parity: the flash slice (smmb_tpu_torch.kernels.flash_decode B4,
.flash_attention B9, and the extend path of models.attention, .transformer
and .lm) against smmb_tpu.

Inputs are numpy arrays from a seed, fed to both packages; JAX runs its
Pallas kernels in interpret mode, the port its plain versions (CPU tensors).
Tolerances are those of JAX's own tests: tests/test_flash.py (f32 1e-5, bf16
0.05, the projected paths 1e-4 relative) and tests/test_flash_decode.py
(2e-5; the serving entries 1e-4 abs + 1e-5 rel, held inside the port
between the flash and the plain attention). Across the two packages the
serving entries use tests/test_torch_lm.py's bound (2e-4 + 1e-5 of the
largest output): the projections' f32 sums differ in order by ~1e-7, and
this random model's large attention scores amplify that to ~2e-3 of outputs
near 360 on the plain attention path as much as on the flash path.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smmb_tpu.kernels import flash_attention as jfa
from smmb_tpu.kernels import flash_decode as jfd
from smmb_tpu.models import attention as jattn
from smmb_tpu.models import lm as jlm
from smmb_tpu.models import transformer as jtb
from smmb_tpu_torch import convert
from smmb_tpu_torch.kernels import flash_attention as tfa
from smmb_tpu_torch.kernels import flash_decode as tfd
from smmb_tpu_torch.models import attention as tattn
from smmb_tpu_torch.models import lm as tlm
from smmb_tpu_torch.models import transformer as ttb

torch.set_num_threads(2)


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=2e-4 + 1e-5 * float(np.abs(want).max()))


def _max_err(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))))


# ---------------------------------------------------------------- B9
def _qkv(seed, b, h, kvh, t, hd):
    return _normal(seed, b, h, t, hd), _normal(seed + 1, b, kvh, t, hd), \
        _normal(seed + 2, b, kvh, t, hd)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,kvh,t,hd", [(2, 4, 4, 64, 64), (1, 4, 2, 96, 128),
                                          (2, 8, 2, 128, 64)])
def test_flash_attention_matches_jax(causal, b, h, kvh, t, hd):
    q, k, v = _qkv(b * 10 + t, b, h, kvh, t, hd)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, block_q=64, block_kv=64)
    got = tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal, block_q=64,
                              block_kv=64)
    assert got.shape == (b, h, t, hd) and got.dtype == torch.float32
    assert _max_err(got, want) < 1e-5


def test_flash_attention_multi_tile_and_window():
    q, k, v = _qkv(1, 1, 2, 2, 300, 64)
    q = q * 4.0  # large scores stress the running-max rescale
    for window in (None, 48):
        want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   window=window, block_q=64, block_kv=64)
        got = tfa.flash_attention(_t(q), _t(k), _t(v), window=window, block_kv=64)
        assert _max_err(got, want) < 1e-5


def test_flash_attention_default_blocks_nonaligned():
    q, k, v = _qkv(3, 1, 2, 2, 200, 128)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    assert _max_err(tfa.flash_attention(_t(q), _t(k), _t(v)), want) < 1e-5


def test_flash_attention_bf16():
    q, k, v = _qkv(2, 2, 4, 4, 128, 64)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = jfa.flash_attention(*bf, block_q=64, block_kv=64)
    got = tfa.flash_attention(*(_t(a, torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    assert _max_err(got.float(), np.asarray(want, np.float32)) < 0.05


def test_flash_attention_rejects_as_jax():
    q, k, v = (_t(a) for a in _qkv(4, 1, 3, 2, 8, 64))
    with pytest.raises(ValueError, match="KVH"):
        tfa.flash_attention(q, k, v)
    q = q[:, :2]
    with pytest.raises(ValueError, match="window requires causal"):
        tfa.flash_attention(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError, match="window must be"):
        tfa.flash_attention(q, k, v, window=0)
    assert tfa.kernel_tile(128) == 64 and tfa.kernel_tile(256) == 32
    assert tfa.kernel_tile(512) == 16
    with pytest.raises(ValueError, match="causal"):
        tfa.flash_attention(q, k, v, causal=False, pipeline_p=True)


# --------------------------------------------------------------- B9p
@pytest.mark.parametrize("window", [None, 64])
def test_flash_pipeline_p_matches_jax(window):
    """B9p (pipeline_p=True) against JAX's interpret-mode pipelined kernel
    at tests/test_flash.py:130's shape, at the B9 tolerance."""
    q, k, v = _qkv(5, 1, 2, 2, 256, 128)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
                               block_q=128, block_kv=128, pipeline_p=True)
    got = tfa.flash_attention(_t(q), _t(k), _t(v), window=window, block_q=128,
                              block_kv=128, pipeline_p=True)
    assert got.shape == (1, 2, 256, 128)
    _close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("window,block_kv", [(None, 64), (48, 32), (None, 16)])
def test_flash_pipeline_p_plain_equals_serial(dtype, window, block_kv):
    """The pipelined walk rounds every value as the serial walk does, so the
    two plain versions are equal at the same block_kv (GQA 4/2)."""
    q, k, v = (_t(a, dtype) for a in _qkv(6, 2, 4, 2, 200, 64))
    q = q * 4.0
    serial = tfa.flash_attention_plain(q, k, v, window=window, block_kv=block_kv)
    pipe = tfa.flash_attention_plain(q, k, v, window=window, block_kv=block_kv,
                                     pipeline_p=True)
    assert pipe.dtype == dtype and torch.equal(pipe, serial)


def test_flash_pipeline_p_tile_and_counter():
    # the second p buffer: 165.6 KB at the 64-row tile and hd 128
    assert tfa.shared_bytes_pipe(64, 128) == 165632
    assert tfa.shared_bytes_pipe(64, 128) - tfa.shared_bytes(64, 128) == 4 * 64 * 65
    assert tfa.kernel_tile(128, True) == 64 and tfa.kernel_tile(256, True) == 32
    # where the extra buffer forces a smaller tile than the serial kernel's
    assert tfa.kernel_tile(200) == 64 and tfa.kernel_tile(200, True) == 32
    before = (tfa.flash_attention.launches, tfa.flash_attention.pipe_launches)
    q = _t(_normal(7, 1, 2, 8, 64))
    tfa.flash_attention(q, q, q, pipeline_p=True)  # a CPU tensor: the plain version
    assert (tfa.flash_attention.launches, tfa.flash_attention.pipe_launches) == before


# ------------------------------------------------------ B9's routing
_BF16, _F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,hd,pipeline_p,want", [
    (_BF16, 64, False, ("mma", 64)), (_BF16, 64, True, ("mma", 64)),
    (_BF16, 128, False, ("mma", 64)), (_BF16, 128, True, ("mma", 64)),
    (_BF16, 96, False, ("cuda_core", 64)), (_BF16, 256, False, ("cuda_core", 32)),
    (_BF16, 256, True, ("cuda_core", 32)), (_BF16, 512, False, ("cuda_core", 16)),
    (_BF16, 512, True, ("cuda_core", 16)),
    (_F32, 64, False, ("cuda_core", 64)), (_F32, 64, True, ("cuda_core", 64)),
    (_F32, 128, False, ("cuda_core", 64)), (_F32, 128, True, ("cuda_core", 64)),
    (_F32, 200, True, ("cuda_core", 32)), (_F32, 256, False, ("cuda_core", 32)),
    (_F32, 512, True, ("cuda_core", 16)),
], ids=lambda x: str(x).replace("torch.", ""))
def test_kernel_route_truth_table(dtype, hd, pipeline_p, want):
    """bf16 at hd 64 and 128 takes the tensor-core body at its 64-row tile;
    f32 at any width and bf16 at other widths the CUDA-core body."""
    assert tfa.kernel_route(dtype, hd, pipeline_p) == want


@pytest.mark.parametrize("dtype", [_BF16, _F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("hd", [64, 96, 128, 200, 256, 512])
def test_kernel_route_tiles_and_shared_memory(dtype, hd):
    """Serial and pipelined calls take the same body, and the same tile
    wherever the pipelined block fits the serial tile (so B9p can be held
    bitwise to B9); each body's block fits shared memory at its tile."""
    serial, pipe = tfa.kernel_route(dtype, hd), tfa.kernel_route(dtype, hd, True)
    assert serial.body == pipe.body
    for route, pipeline_p in ((serial, False), (pipe, True)):
        if route.body == "mma":
            size = tfa.shared_bytes_mma(hd)
        else:
            size = (tfa.shared_bytes_pipe if pipeline_p else tfa.shared_bytes)(route.tile, hd)
        assert size <= 232448
    both_fit = serial.body == "mma" or \
        tfa.shared_bytes_pipe(serial.tile, hd) <= 232448
    assert (serial.tile == pipe.tile) == both_fit


def test_mma_body_shared_bytes_and_widths_match_the_source():
    """The wrapper's account of the mma body agrees with csrc: 80 KB at hd
    128 (the bf16 Q tile and two slots each of K and V), and a launch
    instantiated for each width the router sends there."""
    assert tfa.shared_bytes_mma(128) == 81920 and tfa.shared_bytes_mma(64) == 40960
    src = (Path(tfa.__file__).parent / "csrc" / "flash_attention.cu").read_text()
    assert "QBYTES + 4 * KV" in src
    for hd in tfa.MMA_HEAD_DIMS:
        assert f"launch_mma<{hd}, PIPE>" in src


def test_mma_inputs_aligned_in_place_or_copied():
    """The mma body's 16-byte copies read aligned tensors in place; a
    misaligned pointer or stride gets a contiguous copy of the same values."""
    base = torch.arange(2 * 3 * 8 * 64 + 8, dtype=torch.float32).to(_BF16)
    x = base[:2 * 3 * 8 * 64].view(2, 3, 8, 64)
    assert tfa._aligned(x) is x
    odd = base[1:1 + 2 * 3 * 8 * 64].view(2, 3, 8, 64)
    got = tfa._aligned(odd)
    assert got.data_ptr() % 16 == 0 and got.is_contiguous() and torch.equal(got, odd)
    wide = torch.zeros(2, 3, 8, 68, dtype=_BF16)[..., :64]  # token stride 68
    got = tfa._aligned(wide)
    assert got is not wide and all(s % 8 == 0 for s in got.stride()[:3])


# ---------------------------------------------------------------- B4
def _filled(seed, b, s, kvh, hd, n):
    """Flat (B, S, KVH·hd) caches with the first n positions written."""
    kc = np.zeros((b, s, kvh * hd), np.float32)
    vc = np.zeros_like(kc)
    kc[:, :n] = _normal(seed, b, n, kvh * hd)
    vc[:, :n] = _normal(seed + 1, b, n, kvh * hd)
    return kc, vc


@pytest.mark.parametrize("h,kvh", [(4, 4), (8, 2)])
@pytest.mark.parametrize("pos", [0, 5, 37])
def test_flash_decode_matches_jax(h, kvh, pos):
    b, s, hd = 2, 64, 128
    kc, vc = _filled(h * 100 + pos, b, s, kvh, hd, pos + 1)
    q = _normal(pos + 7, b, h, hd)
    want = jfd.flash_attention_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                      jnp.int32(pos), block_kv=32)
    got = tfd.flash_attention_decode(_t(q), _t(kc), _t(vc), pos, block_kv=32)
    assert got.shape == (b, h, hd)
    assert _max_err(got, want) < 2e-5
    # the kernel's own tile gives the same result within the tolerance
    assert _max_err(tfd.flash_attention_decode(_t(q), _t(kc), _t(vc), pos), want) < 2e-5


@pytest.mark.parametrize("window", [4, 16])
def test_flash_decode_window(window):
    b, s, h, kvh, hd, pos = 1, 64, 4, 2, 128, 33
    kc, vc = _filled(7, b, s, kvh, hd, pos + 1)
    q = _normal(8, b, h, hd)
    want = jfd.flash_attention_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                      jnp.int32(pos), window=window, block_kv=32)
    got = tfd.flash_attention_decode(_t(q), _t(kc), _t(vc), pos, window=window,
                                     block_kv=32)
    assert _max_err(got, want) < 2e-5


@pytest.mark.parametrize("h,kvh,window", [(4, 4, None), (8, 2, None), (4, 2, 16)])
def test_flash_chunk_matches_jax(h, kvh, window):
    b, s, hd, pos, c = 2, 96, 128, 37, 5
    kc, vc = _filled(h * 10 + (window or 0), b, s, kvh, hd, pos + c)
    q = _normal(3, b, c, h, hd)
    want = jfd.flash_attention_chunk(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                     jnp.int32(pos), window=window, block_kv=32)
    got = tfd.flash_attention_chunk(_t(q), _t(kc), _t(vc), pos, window=window,
                                    block_kv=32)
    assert got.shape == (b, c, h, hd)
    assert _max_err(got, want) < 2e-5


@pytest.mark.parametrize("window", [None, 12])
def test_flash_chunk_rows_bitwise_match_decode(window):
    """Token c's row in a C-token chunk equals decoding it alone (the
    speculative-decoding contract), for the plain version too."""
    b, s, h, kvh, hd, c, pos = 1, 96, 4, 2, 128, 5, 17
    kc, vc = (_t(a) for a in _filled(9, b, s, kvh, hd, pos + c))
    q = _t(_normal(10, b, c, h, hd))
    chunk = tfd.flash_attention_chunk(q, kc, vc, pos, window=window)
    for i in range(c):
        solo = tfd.flash_attention_decode(q[:, i], kc, vc, pos + i, window=window)
        assert torch.equal(chunk[:, i], solo), f"row {i}"


def test_flash_decode_batch_rows_independent():
    b, s, kvh, hd, pos = 4, 256, 2, 128, 199
    q = _t(_normal(5, b, 4, hd), torch.bfloat16)
    kc = _t(_normal(6, b, s, kvh * hd), torch.bfloat16)
    vc = _t(_normal(7, b, s, kvh * hd), torch.bfloat16)
    batched = tfd.flash_attention_decode(q, kc, vc, pos)
    assert batched.dtype == torch.bfloat16
    for r in range(b):
        row = tfd.flash_attention_decode(q[r:r + 1], kc[r:r + 1], vc[r:r + 1], pos)
        assert torch.equal(batched[r], row[0])


def test_flash_decode_rejects_as_jax():
    with pytest.raises(ValueError, match="head_dim"):
        tfd.flash_attention_decode(torch.zeros(1, 4, 64), torch.zeros(1, 16, 256),
                                   torch.zeros(1, 16, 256), 0)
    with pytest.raises(ValueError, match="floating"):
        tfd.flash_attention_decode(torch.zeros(1, 4, 128), torch.zeros(1, 16, 512),
                                   torch.zeros(1, 16, 512), 0, compute_dtype=torch.int8)
    with pytest.raises(ValueError, match="KVH"):
        tfd.flash_attention_decode(torch.zeros(1, 3, 128), torch.zeros(1, 16, 256),
                                   torch.zeros(1, 16, 256), 0)


def test_flash_chunk_rows_ok_is_the_kernel_block():
    # JAX's serving cases keep their answers ...
    assert tfd.flash_chunk_rows_ok(1, 8, 128, 1024, 2)
    assert tfd.flash_chunk_rows_ok(64, 8, 128, 1024, 2)
    assert not tfd.flash_chunk_rows_ok(2048, 32, 128, 4096, 2)
    # ... and the limit is the block's shared memory: C·g ≤ 129 rows at
    # hd 128, whatever the itemsizes
    assert tfd.flash_chunk_rows_ok(129, 8, 128, 1024, 4)
    assert not tfd.flash_chunk_rows_ok(130, 8, 128, 1024, 2)
    assert tfd.flash_chunk_rows_ok(32, 8, 128, 256, 2)  # g = 4: 128 rows
    assert not tfd.flash_chunk_rows_ok(33, 8, 128, 256, 2)
    assert tfd.shared_bytes(129, 128) <= tfd.MAX_SHARED_BYTES < tfd.shared_bytes(130, 128)


# ------------------------------------------------------- serving entries
def _attn_pair(seed, d_model, n_heads, kv=None):
    jcfg = jattn.TernaryAttentionConfig(d_model=d_model, n_heads=n_heads, n_kv_heads=kv)
    tcfg = tattn.TernaryAttentionConfig(d_model=d_model, n_heads=n_heads, n_kv_heads=kv)
    jp = jattn.pack_attention(jattn.init_attention(jax.random.PRNGKey(seed), jcfg))
    return jcfg, tcfg, jp, convert.packed_lm_from_jax(jp, device="cpu")


def test_attention_decode_step_use_flash_matches_jax():
    jcfg, tcfg, jp, tp = _attn_pair(0, 256, 2)
    x = _normal(3, 1, 8, 256)
    jc = jattn.init_kv_cache(jcfg, 1, max_len=8)
    tc = tattn.init_kv_cache(tcfg, 1, 8, device="cpu")
    pc = tattn.init_kv_cache(tcfg, 1, 8, device="cpu")
    for t in range(8):
        jy, jc = jattn.attention_decode_step(jp, jnp.asarray(x[:, t:t + 1]), jc, jcfg,
                                             use_kernel=False, use_flash=True)
        ty, tc = tattn.attention_decode_step(tp, _t(x[:, t:t + 1]), tc, tcfg,
                                             use_kernel=False, use_flash=True)
        py, pc = tattn.attention_decode_step(tp, _t(x[:, t:t + 1]), pc, tcfg,
                                             use_kernel=False)
        np.testing.assert_allclose(ty.numpy(), py.numpy(), atol=1e-4, rtol=1e-5,
                                   err_msg=f"step {t}")
        _close(ty, jy)


def test_attention_extend_use_flash_matches_jax():
    jcfg, tcfg, jp, tp = _attn_pair(1, 256, 2)
    x = _normal(4, 1, 9, 256)
    jc = jattn.init_kv_cache(jcfg, 1, max_len=16)
    tc = tattn.init_kv_cache(tcfg, 1, 16, device="cpu")
    for t in range(6):
        _, jc = jattn.attention_decode_step(jp, jnp.asarray(x[:, t:t + 1]), jc, jcfg,
                                            use_kernel=False)
        _, tc = tattn.attention_decode_step(tp, _t(x[:, t:t + 1]), tc, tcfg,
                                            use_kernel=False)
    jy, _ = jattn.attention_extend(jp, jnp.asarray(x[:, 6:]), jc, jcfg, use_kernel=False,
                                   use_flash=True)
    py, _ = tattn.attention_extend(tp, _t(x[:, 6:]), {**tc, "k": tc["k"].clone(),
                                                      "v": tc["v"].clone()},
                                   tcfg, use_kernel=False)
    ty, tc = tattn.attention_extend(tp, _t(x[:, 6:]), tc, tcfg, use_kernel=False,
                                    use_flash=True)
    np.testing.assert_allclose(ty.numpy(), py.numpy(), atol=1e-4, rtol=1e-5)
    _close(ty, jy)
    assert tc["pos"] == 9


def test_attention_forward_flash_matches_jax():
    jcfg, tcfg, jp, tp = _attn_pair(4, 256, 4, kv=2)
    x = _normal(5, 2, 96, 256)
    want = np.asarray(jattn.attention_forward(jp, jnp.asarray(x), jcfg, use_flash=True))
    got = tattn.attention_forward(tp, _t(x), tcfg, use_flash=True).numpy()
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-4
    base = tattn.attention_forward(tp, _t(x), tcfg).numpy()
    assert np.max(np.abs(got - base)) / np.max(np.abs(base)) < 1e-4
    with pytest.raises(ValueError, match="ragged"):
        tattn.attention_forward(tp, _t(x), tcfg, use_flash=True,
                                valid=torch.ones(2, 96, dtype=torch.bool))


def test_lm_forward_flash_matches_jax():
    kw = dict(vocab=64, d_model=128, n_heads=1, d_ff=256, n_layers=2, max_len=64)
    jcfg, tcfg = jlm.TernaryLMConfig(**kw), tlm.TernaryLMConfig(**kw)
    jpacked = jlm.pack_lm(jlm.init_lm(jax.random.PRNGKey(6), jcfg))
    tpacked = convert.packed_lm_from_jax(jpacked, device="cpu")
    toks = np.random.default_rng(7).integers(0, 64, (2, 32))
    want = np.asarray(jlm.lm_forward(jpacked, jnp.asarray(toks), jcfg, use_flash=True))
    got = tlm.lm_forward(tpacked, torch.from_numpy(toks), tcfg, use_flash=True).numpy()
    base = tlm.lm_forward(tpacked, torch.from_numpy(toks), tcfg).numpy()
    # JAX's bound between its flash and plain paths, inside the port; across
    # the packages, tests/test_torch_lm.py's bound at the last position
    assert np.max(np.abs(got - base)) / np.max(np.abs(base)) < 1e-4
    _close(got[:, -1], want[:, -1])


def test_generate_use_flash_matches_jax():
    kw = dict(vocab=64, d_model=128, n_heads=1, d_ff=128, n_layers=1, max_len=24)
    jcfg, tcfg = jlm.TernaryLMConfig(**kw), tlm.TernaryLMConfig(**kw)
    jpacked = jlm.pack_lm(jlm.init_lm(jax.random.PRNGKey(0), jcfg))
    tpacked = convert.packed_lm_from_jax(jpacked, device="cpu")
    toks = np.random.default_rng(1).integers(0, 64, (1, 8))
    want = np.asarray(jlm.generate(jpacked, jnp.asarray(toks), jcfg, 6, use_kernel=False,
                                   use_flash=True))
    got = tlm.generate(tpacked, torch.from_numpy(toks), tcfg, 6, use_kernel=False,
                       use_flash=True)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------ the LM extend path
CFG = dict(vocab=512, d_model=512, n_heads=4, d_ff=1024, n_layers=2, max_len=32)
JCFG, TCFG = jlm.TernaryLMConfig(**CFG), tlm.TernaryLMConfig(**CFG)


@pytest.fixture(scope="module")
def lm_pair():
    jpacked = jlm.pack_lm(jlm.init_lm(jax.random.PRNGKey(0), JCFG))
    return jpacked, convert.packed_lm_from_jax(jpacked, device="cpu")


@pytest.mark.parametrize("use_flash", [False, True], ids=["jnp", "flash"])
def test_lm_extend_matches_jax(lm_pair, use_flash):
    jpacked, tpacked = lm_pair
    toks = np.random.default_rng(2).integers(0, 512, (2, 10))
    _, jc = jlm.lm_prefill(jpacked, jnp.asarray(toks[:, :6]), jlm.lm_init_cache(JCFG, 2),
                           JCFG)
    _, tc = tlm.lm_prefill(tpacked, torch.from_numpy(toks[:, :6]),
                           tlm.lm_init_cache(TCFG, 2, device="cpu"), TCFG)
    jl, jc = jlm.lm_extend(jpacked, jnp.asarray(toks[:, 6:]), jc, JCFG, use_flash=use_flash)
    tl, tc = tlm.lm_extend(tpacked, torch.from_numpy(toks[:, 6:]), tc, TCFG,
                           use_flash=use_flash)
    assert tl.shape == (2, 4, 512) and [c["pos"] for c in tc] == [10, 10]
    _close(tl[:, -1], jl[:, -1])
    np.testing.assert_array_equal(tl.argmax(-1).numpy(), np.asarray(jl.argmax(-1)))


def test_lm_prefill_chunked_matches_jax_and_prefill(lm_pair):
    jpacked, tpacked = lm_pair
    toks = np.random.default_rng(3).integers(0, 512, (2, 8))
    # JAX's jitted lm_prefill_chunked traces use_flash, so it runs the jnp
    # chunk path there; the port's flash chunk path is held against it
    jl, _ = jlm.lm_prefill_chunked(jpacked, jnp.asarray(toks), jlm.lm_init_cache(JCFG, 2),
                                   JCFG, 4)
    tl, tc = tlm.lm_prefill_chunked(tpacked, torch.from_numpy(toks),
                                    tlm.lm_init_cache(TCFG, 2, device="cpu"), TCFG, 4,
                                    use_flash=True)
    _close(tl, jl)
    assert [c["pos"] for c in tc] == [8, 8]
    one, _ = tlm.lm_prefill(tpacked, torch.from_numpy(toks),
                            tlm.lm_init_cache(TCFG, 2, device="cpu"), TCFG)
    _close(tl, one)
    with pytest.raises(ValueError, match="divisible"):
        tlm.lm_prefill_chunked(tpacked, torch.from_numpy(toks),
                               tlm.lm_init_cache(TCFG, 2, device="cpu"), TCFG, 3)


def test_generate_prefill_chunk(lm_pair):
    jpacked, tpacked = lm_pair
    toks = np.random.default_rng(4).integers(0, 512, (1, 8))
    want = np.asarray(jlm.generate(jpacked, jnp.asarray(toks), JCFG, 3, prefill_chunk=4))
    got = tlm.generate(tpacked, torch.from_numpy(toks), TCFG, 3, prefill_chunk=4)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="not combinable"):
        tlm.generate(tpacked, torch.from_numpy(toks), TCFG, 3, prefill_chunk=4,
                     use_flash=True)


def test_block_extend_rows_equal_decode_steps():
    """A C=4 chunk through block_extend gives, row for row and bitwise,
    the four decode steps' outputs (B3, B4's chunk entry, B5 at M=C)."""
    cfg = ttb.TernaryBlockConfig(d_model=512, n_heads=4, d_ff=1024)
    jcfg = jtb.TernaryBlockConfig(d_model=512, n_heads=4, d_ff=1024)
    tp = convert.packed_lm_from_jax(
        jtb.pack_block(jtb.init_block(jax.random.PRNGKey(8), jcfg), quantize=True),
        device="cpu")
    x = _t(_normal(9, 1, 7, 512))
    c1 = ttb.init_block_cache(cfg, 1, 16, device="cpu")
    _, c1 = ttb.block_prefill(tp, x[:, :3], c1, cfg, use_flash=True)
    c2 = {**c1, "k": c1["k"].clone(), "v": c1["v"].clone()}
    assert ttb._tail_fusable(tp, 4, torch.float32, True)
    chunk, c1 = ttb.block_extend(tp, x[:, 3:], c1, cfg, use_flash=True)
    for i in range(4):
        step, c2 = ttb.block_decode_step(tp, x[:, 3 + i:4 + i], c2, cfg, use_flash=True)
        assert torch.equal(chunk[:, i], step[:, 0]), f"row {i}"
    assert torch.equal(c1["k"], c2["k"]) and c1["pos"] == c2["pos"] == 7


def _fake_cache(b, s, kvd, dtype=torch.bfloat16):
    return {"k": torch.empty((b, s, kvd), dtype=dtype, device="meta"),
            "v": torch.empty((b, s, kvd), dtype=dtype, device="meta"), "pos": 0}


@pytest.mark.parametrize("b,s,hd,valid,want", [
    (1, 64, 128, False, True),
    (4, 64, 128, False, False),  # batch > 1 with a small cache
    (4, 4096, 128, False, True),  # 2 * 4·4096·1024·2 bytes = 64 MiB
    (9, 4096, 128, False, False),  # batch above FLASH_DECODE_MAX_BATCH
    (1, 64, 64, False, False),  # head_dim % 128
    (1, 64, 128, True, False),  # a ragged cache
], ids=["b1", "b4-small", "b4-32MB", "b9", "hd64", "valid"])
def test_flash_decode_gate_truth_table(b, s, hd, valid, want):
    cfg = tattn.TernaryAttentionConfig(d_model=8 * hd, n_heads=8)
    cache = _fake_cache(b, s, cfg.kv_dim)
    if valid:
        cache["valid"] = torch.ones((b, s), dtype=torch.bool, device="meta")
    assert tattn._flash_decode_ok(cache, cfg, b, True) is want
    assert tattn._flash_decode_ok(cache, cfg, b, False) is False


@pytest.mark.parametrize("b,want", [(1, 1), (2, 0)])
def test_decode_core_route(monkeypatch, b, want):
    """The route shows in a spy on B4: batch 1 takes it, batch 2 with a
    small cache takes the chunk math, and so does a ragged cache."""
    jcfg, tcfg, _, tp = _attn_pair(2, 256, 2)
    calls = []
    real = tfd.flash_attention_decode
    monkeypatch.setattr(tfd, "flash_attention_decode",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = _t(_normal(11, b, 1, 256))
    cache = tattn.init_kv_cache(tcfg, b, 8, device="cpu")
    tattn.attention_decode_core(tp, x, cache, tcfg, use_flash=True)
    assert len(calls) == want
    ragged = tattn.init_kv_cache(tcfg, b, 8, ragged=True, device="cpu")
    out, ragged = tattn.attention_decode_core(tp, x, ragged, tcfg, use_flash=True)
    assert len(calls) == want and out.shape == (b, 1, 256)
    assert ragged["valid"][:, 0].all() and not ragged["valid"][:, 1:].any()
