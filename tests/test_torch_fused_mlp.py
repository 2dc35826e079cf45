"""Port parity: the fused kernels' plain versions (smmb_tpu_torch.kernels.
fused_mlp: B3 fused_norm_qkv, B6 fused_mlp, B5 fused_block_tail) against the
JAX kernels, which run in interpret mode on the CPU as the JAX tests run
them, and the routing gates against JAX's. Inputs are made once in numpy
and fed to both packages.

Tolerances are the JAX tests' own (tests/test_fused_mlp.py): B6 f32 1e-4
abs, bf16 0.05·max|Y| (the bf16 casts of the two paths round apart); the
multi-slab case rtol 1e-5, atol 1e-4; B5 and B3 rtol 1e-5, atol 2e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smmb_tpu.formats.packed import pack_ternary as jpack
from smmb_tpu.kernels import fused_mlp as jfk
from smmb_tpu.models import attention as jattn
from smmb_tpu.models import transformer as jtb
from smmb_tpu_torch.formats.packed import pack_ternary
from smmb_tpu_torch.kernels import fused_mlp as tfk
from smmb_tpu_torch.models import attention as tattn
from smmb_tpu_torch.models import transformer as ttb

torch.set_num_threads(2)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _dense(rs, shape):
    return rs.uniform(-1, 1, shape).astype(np.float32)


def _tern(rs, shape):
    return rs.choice(np.array([-1.0, 0.0, 1.0], np.float32), size=shape)


def _planes(*ws):
    """The same ternary matrices packed by both packages."""
    return [jpack(w) for w in ws], [pack_ternary(w, device="cpu") for w in ws]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _mlp_inputs(seed, m, k, h, kout):
    rs = np.random.default_rng(seed)
    return (_dense(rs, (m, k)), _tern(rs, (k, h)), _dense(rs, (h,)),
            _tern(rs, (h, kout)), _dense(rs, (kout,)))


def _mlp_oracle(x, wu, bu, su, wd, bd, sd, alpha):
    up = (np.asarray(x, np.float64) * su) @ wu.astype(np.float64) + bu
    up = np.where(up > 0, up, alpha * up)
    return (up * sd) @ wd.astype(np.float64) + bd


def _both_mlp(x, wu, bu, su, wd, bd, sd, dtype, block_h):
    jdt, tdt = DTYPES[dtype]
    (jwu, jwd), (twu, twd) = _planes(wu, wd)
    want = np.asarray(jfk.fused_mlp(
        jnp.asarray(x), jwu, jnp.float32(su), jnp.asarray(bu), jwd,
        jnp.float32(sd), jnp.asarray(bd), alpha=0.2, compute_dtype=jdt,
        block_h=block_h), np.float64)
    got = tfk.fused_mlp(_t(x), twu, torch.tensor(su), _t(bu), twd, torch.tensor(sd),
                        _t(bd), alpha=0.2, compute_dtype=tdt, block_h=block_h)
    return want, got.double().numpy()


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_mlp_matches_jax(m, dtype):
    x, wu, bu, wd, bd = _mlp_inputs(10 + m, m, 512, 1024, 512)
    want, got = _both_mlp(x, wu, bu, 0.37, wd, bd, 1.21, dtype, 512)
    oracle = _mlp_oracle(x, wu, bu, 0.37, wd, bd, 1.21, 0.2)
    tol = 1e-4 if dtype == "f32" else 0.05 * np.abs(oracle).max()
    assert got.shape == (m, 512)
    assert np.abs(got - want).max() < tol
    assert np.abs(got - oracle).max() < tol


def test_fused_mlp_multi_slab():
    # H spans four 512-wide slabs (and 16 of the CUDA kernel's tiles)
    x, wu, bu, wd, bd = _mlp_inputs(20, 1, 512, 2048, 512)
    want, got = _both_mlp(x, wu, bu, 1.0, wd, bd, 1.0, "f32", 512)
    oracle = _mlp_oracle(x, wu, bu, 1.0, wd, bd, 1.0, 0.2)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _tail_inputs(seed, m, a, d, h):
    rs = np.random.default_rng(seed)
    return dict(att=_dense(rs, (m, a)), x=_dense(rs, (m, d)), wo=_tern(rs, (a, d)),
                bo=_dense(rs, (d,)), g2=(1.0 + 0.1 * _dense(rs, (d,))).astype(np.float32),
                wu=_tern(rs, (d, h)), bu=_dense(rs, (h,)), wd=_tern(rs, (h, d)),
                bd=_dense(rs, (d,)))


def _both_tail(p, scales, dtype, block_h=512):
    jdt, tdt = DTYPES[dtype]
    (jwo, jwu, jwd), (two, twu, twd) = _planes(p["wo"], p["wu"], p["wd"])
    s_wo, s_up, s_down = scales
    kw = dict(alpha=0.2, eps=1e-6, block_h=block_h)
    want = np.asarray(jfk.fused_block_tail(
        jnp.asarray(p["att"]), jnp.asarray(p["x"]), jwo, jnp.float32(s_wo),
        jnp.asarray(p["bo"]), jnp.asarray(p["g2"]), jwu, jnp.float32(s_up),
        jnp.asarray(p["bu"]), jwd, jnp.float32(s_down), jnp.asarray(p["bd"]),
        compute_dtype=jdt, **kw), np.float64)
    got = tfk.fused_block_tail(
        _t(p["att"]), _t(p["x"]), two, s_wo, _t(p["bo"]), _t(p["g2"]), twu, s_up,
        _t(p["bu"]), twd, s_down, _t(p["bd"]), compute_dtype=tdt, **kw)
    return want, got.double().numpy()


def test_fused_block_tail_matches_jax():
    p = _tail_inputs(30, 2, 512, 512, 1024)
    scales = (0.9, 0.37, 1.21)
    want, got = _both_tail(p, scales, "f32")
    # the JAX test's f64 oracle of the composition
    attn_out = p["att"].astype(np.float64) * scales[0] @ p["wo"] + p["bo"]
    resid = p["x"] + attn_out
    h2 = resid / np.sqrt((resid ** 2).mean(-1, keepdims=True) + 1e-6) * p["g2"]
    oracle = resid + _mlp_oracle(h2, p["wu"], p["bu"], scales[1], p["wd"], p["bd"],
                                 scales[2], 0.2)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=2e-4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-4)


def test_fused_block_tail_bf16_matches_jax():
    p = _tail_inputs(31, 4, 512, 512, 1024)
    want, got = _both_tail(p, (1.0, 1.0, 1.0), "bf16")
    assert np.abs(got - want).max() < 0.05 * np.abs(want).max()


def _norm_qkv_both(seed, m, d, n, spans, dtype):
    rs = np.random.default_rng(seed)
    x, g = _dense(rs, (m, d)), (1.0 + 0.1 * _dense(rs, (d,))).astype(np.float32)
    w, b = _tern(rs, (d, n)), _dense(rs, (n,))
    sc = np.concatenate([np.full((c,), s, np.float32) for c, s in spans])
    jdt, tdt = DTYPES[dtype]
    (jw,), (tw,) = _planes(w)
    want = np.asarray(jfk.fused_norm_qkv(jnp.asarray(x), jnp.asarray(g), jw,
                                         jnp.asarray(sc), jnp.asarray(b), eps=1e-6,
                                         compute_dtype=jdt), np.float64)
    got = tfk.fused_norm_qkv(_t(x), _t(g), tw, _t(sc), _t(b), eps=1e-6,
                             compute_dtype=tdt).double().numpy()
    x64 = x.astype(np.float64)
    h = x64 / np.sqrt((x64 ** 2).mean(-1, keepdims=True) + 1e-6) * g
    oracle = h @ w.astype(np.float64) * sc + b
    return want, got, oracle


@pytest.mark.parametrize("d,n,spans", [
    (512, 1536, ((512, 0.7), (512, 1.1), (512, 0.9))),  # MHA, the JAX test
    (1024, 1536, ((1024, 0.7), (256, 1.1), (256, 0.9))),  # GQA: 8 heads over 2
], ids=["mha", "gqa"])
def test_fused_norm_qkv_matches_jax(d, n, spans):
    want, got, oracle = _norm_qkv_both(40 + d, 2, d, n, spans, "f32")
    assert got.shape == (2, n)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=2e-4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-4)


def test_fused_norm_qkv_bf16_matches_jax():
    want, got, oracle = _norm_qkv_both(50, 3, 512, 1536, ((1536, 1.0),), "bf16")
    assert np.abs(got - want).max() < 0.05 * np.abs(oracle).max()


def test_fused_kernels_reject_int8():
    x, wu, bu, wd, bd = _mlp_inputs(60, 1, 512, 512, 512)
    (twu, twd) = _planes(wu, wd)[1]
    with pytest.raises(ValueError, match="float-only"):
        tfk.fused_mlp(_t(x), twu, 1.0, _t(bu), twd, 1.0, _t(bd), alpha=0.2,
                      compute_dtype=torch.int8)
    with pytest.raises(ValueError, match="float-only"):
        tfk.fused_norm_qkv(_t(x), torch.ones(512), twu, torch.ones(512),
                           torch.zeros(512), eps=1e-6, compute_dtype=torch.int8)
    with pytest.raises(ValueError, match="float-only"):
        tfk.fused_block_tail(_t(x), _t(x), twd, 1.0, _t(bd), torch.ones(512), twu,
                             1.0, _t(bu), twd, 1.0, _t(bd), alpha=0.2, eps=1e-6,
                             compute_dtype=torch.int8)


def test_fused_kernels_check_shapes_like_jax():
    x, wu, bu, wd, bd = _mlp_inputs(61, 2, 512, 1024, 512)
    twu, twd = _planes(wu, wd)[1]
    with pytest.raises(ValueError, match="block_h"):
        tfk.fused_mlp(_t(x), twu, 1.0, _t(bu), twd, 1.0, _t(bd), alpha=0.2,
                      block_h=768)
    with pytest.raises(ValueError, match="shape chain"):
        tfk.fused_mlp(_t(x), twu, 1.0, _t(bu), twu, 1.0, _t(bd), alpha=0.2)
    with pytest.raises(ValueError, match="N="):
        tfk.fused_norm_qkv(_t(x), torch.ones(512), twu, torch.ones(1000),
                           torch.zeros(1024), eps=1e-6)
    assert tfk.fused_mlp.launches == 0 and tfk.fused_block_tail.launches == 0
    assert tfk.fused_norm_qkv.launches == 0


def test_mlp_fusable_gate_truth_table():
    rs = np.random.RandomState(0)
    wu = np.sign(rs.randn(512, 1024)).astype(np.float32)
    wd = np.sign(np.random.RandomState(1).randn(1024, 512)).astype(np.float32)
    (jwu, jwd), (twu, twd) = _planes(wu, wd)
    jp, tp = {"w_up": jwu, "w_down": jwd}, {"w_up": twu, "w_down": twd}
    cases = [  # (rows, compute dtype, use_kernel, LoRA)
        (1, "bf16", True, False), (1, "bf16", False, False),
        (1, "int8", True, False), (64, "bf16", True, False),
        (32, "f32", True, False), (1, "bf16", True, True),
    ]
    got = []
    for rows, dt, use_kernel, lora in cases:
        jdt = {"bf16": jnp.bfloat16, "f32": jnp.float32, "int8": jnp.int8}[dt]
        tdt = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8}[dt]
        extra = {"w_up_lora": (1, 2, 3)} if lora else {}
        want = jtb._mlp_fusable({**jp, **extra}, jnp.zeros((rows, 512)), jdt, use_kernel)
        have = ttb._mlp_fusable({**tp, **extra}, torch.zeros(rows, 512), tdt, use_kernel)
        assert have == bool(want), (rows, dt, use_kernel, lora)
        got.append(have)
    # the JAX test's table (tests/test_fused_mlp.py:264-271)
    assert got == [True, False, False, False, True, False]


def _block_pair(seed, d, h, n_heads, n_kv_heads=None):
    """The same packed block in both packages."""
    import jax

    from smmb_tpu_torch.convert import packed_lm_from_jax

    cfg = jtb.TernaryBlockConfig(d_model=d, n_heads=n_heads, d_ff=h,
                                 n_kv_heads=n_kv_heads)
    jp = jtb.pack_block(jtb.init_block(jax.random.PRNGKey(seed), cfg))
    return cfg, jp, packed_lm_from_jax(jp, device="cpu")


@pytest.mark.parametrize("d,h,heads,kv,dt,use_kernel", [
    (512, 1024, 4, None, "bf16", True),
    (512, 1024, 4, None, "f32", False),
    (512, 1024, 4, None, "int8", True),
    (1024, 3072, 8, 2, "bf16", True),
    (512, 256, 4, None, "bf16", True),
], ids=["fused", "no-kernel", "int8", "gqa-3072", "no-slab"])
def test_tail_and_prenorm_gates_match_jax(d, h, heads, kv, dt, use_kernel):
    cfg, jp, tp = _block_pair(70, d, h, heads, kv)
    jdt = {"bf16": jnp.bfloat16, "f32": jnp.float32, "int8": jnp.int8}[dt]
    tdt = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8}[dt]
    for m in (1, 32, 33):
        assert ttb._tail_fusable(tp, m, tdt, use_kernel) == bool(
            jtb._tail_fusable(jp, m, jdt, use_kernel))
    tcfg = ttb.TernaryBlockConfig(d_model=d, n_heads=heads, d_ff=h, n_kv_heads=kv)
    assert tattn._qkv_prenorm_fusable(tp["attn"], tcfg.attn, tdt, use_kernel) == bool(
        jattn._qkv_prenorm_fusable(jp["attn"], cfg.attn, jdt, use_kernel))
    assert ttb._fused_block_h(h) == jtb._fused_block_h(h)
    assert ttb._fused_block_h(h, 1024) == jtb._fused_block_h(h, 1024)


def test_hopper_shared_memory_limit():
    # 32·(max(K, 1024) + 128) + 288 bytes ≤ 227 KB: K ≤ 6656 at 8 rows a block
    assert tfk.fits_shared(6656) and not tfk.fits_shared(7168)
    assert tfk.shared_bytes(1024) == 4 * (8 * 1024 + 8 * 128 + 8 + 64)
