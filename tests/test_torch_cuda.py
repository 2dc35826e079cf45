"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version, through the wrappers, the MLP path and the LM path. Every
test needs a CUDA device and skips without one (the kernels have no CPU
mode).

This file imports neither JAX nor smmb_tpu, so it also runs where only the
port is installed: ``python -m pytest --noconftest -q tests/test_torch_cuda.py``
(tests/conftest.py imports JAX).

Tolerances, relative to max(1, max|Y|): f32 1e-4 (f32 sums in another
order); bf16 compute with f32 X and Y 1e-5 (the same bf16 values summed in
f32 in another order); int8 1e-6 (same codes, exact int32 sums, the same
separately rounded epilogue). The fused kernels (B3, B5, B6) and the flash
kernels (B4, B9) and the BCSR kernel (B2): f32 1e-4 and bf16 2**-7 (a staged
value, or B2's f32 sum rounded once to bf16, can round to the neighbouring
bf16).
"""

import numpy as np
import pytest
import torch

from smmb_tpu_torch.bench import sweep as tsweep
from smmb_tpu_torch.formats.bcsr import bcsr_from_dense
from smmb_tpu_torch.formats.packed import pack_ternary
from smmb_tpu_torch.kernels import bcsr_spmm as bk
from smmb_tpu_torch.kernels import flash_attention as fa
from smmb_tpu_torch.kernels import flash_decode as fd
from smmb_tpu_torch.kernels import fused_mlp as fk
from smmb_tpu_torch.kernels.packed_spmm import packed_spmm, packed_spmm_plain
from smmb_tpu_torch.models import lm as tlm
from smmb_tpu_torch.models import mlp as tmlp
from smmb_tpu_torch.nn import PackedTernaryDense
from smmb_tpu_torch.utils import rng
from smmb_tpu_torch.utils.compare import assert_close

ALPHA = 0.2
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-5, torch.int8: 1e-6}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _setup(seed, m, k, n, dev):
    rs = np.random.default_rng(seed)
    x = torch.from_numpy(rs.uniform(-1, 1, (m, k)).astype(np.float32)).to(dev)
    w = rs.choice(np.array([-1.0, 0.0, 1.0], np.float32), size=(k, n))
    b = torch.from_numpy(rs.uniform(-1, 1, (n,)).astype(np.float32)).to(dev)
    return x, pack_ternary(w, device=dev), b


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("m,k,n", [(1, 512, 1024), (8, 1024, 640), (100, 512, 512),
                                   (4, 100, 256), (65, 2048, 129), (256, 4096, 4096)])
def test_kernel_matches_plain(cuda, cdt, m, k, n):
    x, p, b = _setup(31 + m, m, k, n, cuda)
    for bias, alpha in ((b, ALPHA), (None, None)):
        before = packed_spmm.launches
        y = packed_spmm(x, p, bias, alpha, compute_dtype=cdt)
        assert packed_spmm.launches == before + 1
        ref = packed_spmm_plain(x, p, bias, alpha, compute_dtype=cdt)
        torch.cuda.synchronize()
        assert y.shape == (m, n) and y.dtype == torch.float32
        assert_close(y, ref, TOL[cdt] * max(1.0, float(ref.abs().max())),
                     f"kernel vs plain {cdt} {m}x{k}x{n}")


@pytest.mark.cuda
def test_kernel_bf16_in_bf16_out_and_3d(cuda):
    x, p, b = _setup(5, 24, 512, 384, cuda)
    x3 = x.to(torch.bfloat16).reshape(2, 12, 512)
    y = packed_spmm(x3, p, b, ALPHA, compute_dtype=torch.bfloat16)
    ref = packed_spmm_plain(x3.reshape(24, 512), p, b, ALPHA,
                            compute_dtype=torch.bfloat16)
    assert y.shape == (2, 12, 384) and y.dtype == torch.bfloat16
    # the same f32 sums rounded to bf16 differ by at most one bf16 ulp
    assert_close(y.reshape(24, 384), ref, 2.0 ** -7 * float(ref.float().abs().max()))


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda):
    x, p, b = _setup(6, 4, 512, 256, cuda)
    with pytest.raises(TypeError):
        packed_spmm(x.to(torch.float16), p, b)
    with pytest.raises(ValueError):
        packed_spmm(x, p.to("cpu"), b)
    with pytest.raises(ValueError):
        packed_spmm(x, p, b[:100])


@pytest.mark.cuda
def test_mlp_kernel_path_matches_plain(cuda):
    gen = rng.make_generator(0)
    cfg = tmlp.TernaryMLPConfig(layer_dims=(512, 1024, 1024, 512))
    packed = tmlp.pack_mlp(tmlp.init_mlp(gen, cfg))
    x = rng.rand_dense(gen, (32, 512))
    packed_spmm.launches = 0
    y = tmlp.PackedTernaryMLP(packed, cfg)(x)
    assert packed_spmm.launches == cfg.num_layers
    ref = tmlp.mlp_forward(packed, x, cfg, use_kernel=False)
    assert_close(y, ref, 1e-5 * float(ref.abs().max()), "MLP kernel vs plain")


@pytest.mark.cuda
def test_packed_ternary_dense_on_the_card(cuda):
    x, p, b = _setup(7, 16, 700, 256, cuda)
    layer = PackedTernaryDense(700, 256, compute_dtype=torch.float32)
    layer.packed_kernel.copy_(p.data)
    layer.bias.copy_(b)
    layer.kernel_scale.fill_(0.5)
    y = layer(x)
    layer.use_kernel = False
    ref = layer(x)
    assert_close(y, ref, 1e-4 * max(1.0, float(ref.abs().max())), "dense layer")


FUSED_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}


def _fused_args(name, seed, m, d, h, dev):
    rs = np.random.default_rng(seed)

    def dense(*shape):
        return torch.from_numpy(rs.uniform(-1, 1, shape).astype(np.float32)).to(dev)

    def plane(k, n):
        return pack_ternary(rs.choice(np.array([-1.0, 0.0, 1.0], np.float32), (k, n)),
                            device=dev)

    s = torch.tensor(0.8, device=dev)
    if name == "fused_norm_qkv":
        return (dense(m, d), 1 + 0.1 * dense(d), plane(d, h), 0.5 + dense(h).abs(),
                dense(h)), dict(eps=1e-6)
    if name == "fused_mlp":
        return (dense(m, d), plane(d, h), s, dense(h), plane(h, d), s * 1.5,
                dense(d)), dict(alpha=ALPHA, block_h=512)
    return (dense(m, d).to(torch.bfloat16), dense(m, d), plane(d, d), s, dense(d),
            1 + 0.1 * dense(d), plane(d, h), s, dense(h), plane(h, d), s, dense(d)), \
        dict(alpha=ALPHA, eps=1e-6, block_h=512)


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,m,d,h", [
    ("fused_norm_qkv", 1, 1024, 3072), ("fused_norm_qkv", 5, 1024, 1536),
    ("fused_norm_qkv", 2, 512, 1536), ("fused_mlp", 32, 1024, 4096),
    ("fused_mlp", 1, 512, 2048), ("fused_block_tail", 1, 1024, 4096),
    ("fused_block_tail", 9, 512, 1536),
])
def test_fused_kernel_matches_plain(cuda, cdt, name, m, d, h):
    args, kw = _fused_args(name, m + d, m, d, h, cuda)
    fn, plain = getattr(fk, name), getattr(fk, name + "_plain")
    before = fn.launches
    y = fn(*args, compute_dtype=cdt, **kw)
    assert fn.launches == before + 1
    ref = plain(*args, compute_dtype=cdt, **{k: v for k, v in kw.items() if k != "block_h"})
    torch.cuda.synchronize()
    assert y.shape == ref.shape and y.dtype == ref.dtype
    assert_close(y, ref, FUSED_TOL[cdt] * max(1.0, float(ref.abs().max())),
                 f"{name} {cdt} M={m}")


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["fused_norm_qkv", "fused_mlp", "fused_block_tail"])
def test_fused_kernel_row_identity(cuda, cdt, name):
    """Row r of an M=8 call is bitwise the M=1 call on row r."""
    args, kw = _fused_args(name, 3, 8, 1024, 2048 if name != "fused_norm_qkv" else 3072,
                           cuda)
    n_act = 2 if name == "fused_block_tail" else 1
    fn = getattr(fk, name)
    chunk = fn(*args, compute_dtype=cdt, **kw)
    for r in (0, 5):
        one = tuple(a[r:r + 1] if i < n_act else a for i, a in enumerate(args))
        assert torch.equal(chunk[r:r + 1], fn(*one, compute_dtype=cdt, **kw))


@pytest.mark.cuda
def test_generate_launch_counts_and_tokens(cuda):
    cfg = tlm.TernaryLMConfig(vocab=512, d_model=512, n_heads=4, d_ff=1024,
                              n_layers=2, max_len=32)
    gen = rng.make_generator(0)
    packed = tlm.pack_lm(tlm.init_lm(gen, cfg))
    prompt = torch.randint(0, cfg.vocab, (1, 8), generator=gen, device=cuda)
    counted = (packed_spmm, fk.fused_norm_qkv, fk.fused_block_tail, fk.fused_mlp)
    for fn in counted:
        fn.launches = 0
    toks = tlm.generate(packed, prompt, cfg, 5)
    assert [fn.launches for fn in counted] == [6 * 2 + 1 + 5, 2 * 5, 2 * 5, 2]
    # f32 greedy tokens of the kernel path and the plain path agree
    plain = tlm.generate(packed, prompt, cfg, 5, use_kernel=False)
    assert torch.equal(toks, plain)


def _normal(rs, shape, dtype, dev, scale=1.0):
    return (torch.from_numpy(rs.standard_normal(shape).astype(np.float32)) * scale).to(
        device=dev, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kvh,s,pos,window", [
    (1, 8, 8, 224, 95, None), (1, 8, 2, 1024, 512, None), (2, 4, 4, 300, 260, 64),
    (4, 8, 8, 1024, 512, None),
])
def test_flash_decode_matches_plain_rows_bitwise(cuda, cdt, b, h, kvh, s, pos, window):
    rs = np.random.default_rng(pos + h)
    q = _normal(rs, (b, 5, h, 128), torch.float32, cuda, 8.0)
    kc = _normal(rs, (b, s, kvh * 128), cdt, cuda)
    vc = _normal(rs, (b, s, kvh * 128), cdt, cuda)
    kw = dict(window=window, compute_dtype=cdt)
    before = fd.flash_attention_decode.launches
    y = fd.flash_attention_decode(q[:, 0], kc, vc, pos, **kw)
    assert fd.flash_attention_decode.launches == before + 1
    ref = fd.flash_attention_decode_plain(q[:, 0], kc, vc, pos, **kw)
    torch.cuda.synchronize()
    assert y.shape == ref.shape and y.dtype == cdt
    assert_close(y.float(), ref.float(),
                 FUSED_TOL[cdt] * max(1.0, float(ref.float().abs().max())), "B4")
    chunk = fd.flash_attention_chunk(q, kc, vc, pos - 4, **kw)
    for c in range(5):
        assert torch.equal(chunk[:, c], fd.flash_attention_decode(q[:, c], kc, vc,
                                                                  pos - 4 + c, **kw))
    for r in range(b):
        assert torch.equal(y[r:r + 1], fd.flash_attention_decode(
            q[r:r + 1, 0], kc[r:r + 1], vc[r:r + 1], pos, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kvh,t,hd,causal,window", [
    (1, 8, 8, 32, 128, True, None), (2, 8, 2, 200, 128, True, None),
    (1, 4, 4, 300, 64, True, 64), (1, 4, 2, 130, 128, False, None),
    (1, 2, 2, 70, 256, True, None),
])
def test_flash_attention_matches_plain(cuda, dt, b, h, kvh, t, hd, causal, window):
    rs = np.random.default_rng(t + hd)
    q = _normal(rs, (b, h, t, hd), dt, cuda, 4.0)
    k = _normal(rs, (b, kvh, t, hd), dt, cuda)
    v = _normal(rs, (b, kvh, t, hd), dt, cuda)
    before = fa.flash_attention.launches
    y = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.flash_attention.launches == before + 1
    ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert y.shape == ref.shape and y.dtype == dt
    assert_close(y.float(), ref.float(),
                 FUSED_TOL[dt] * max(1.0, float(ref.float().abs().max())), "B9")


@pytest.mark.cuda
def test_generate_flash_launch_counts_and_tokens(cuda):
    cfg = tlm.TernaryLMConfig(vocab=512, d_model=512, n_heads=4, d_ff=1024,
                              n_layers=2, max_len=32)
    gen = rng.make_generator(0)
    packed = tlm.pack_lm(tlm.init_lm(gen, cfg))
    prompt = torch.randint(0, cfg.vocab, (1, 8), generator=gen, device=cuda)
    counted = (packed_spmm, fk.fused_norm_qkv, fk.fused_block_tail, fk.fused_mlp,
               fa.flash_attention, fd.flash_attention_decode)
    for fn in counted:
        fn.launches = 0
    toks = tlm.generate(packed, prompt, cfg, 5, use_flash=True)
    assert [fn.launches for fn in counted] == [6 * 2 + 1 + 5, 2 * 5, 2 * 5, 2, 2, 2 * 5]
    plain = tlm.generate(packed, prompt, cfg, 5, use_kernel=False)
    assert torch.equal(toks, plain)


def _bcsr_case(seed, m, k, n, r, c, keep, dt, dev):
    gen = rng.make_generator(seed, dev)
    w = rng.rand_block_ternary(gen, (k, n), block=(r, c), keep=keep, non_zero=2)
    prep = bk.bcsr_prepare(bcsr_from_dense(w, r, c, device=dev), device=dev)
    return rng.rand_dense(gen, (m, k), dtype=dt), w, prep, rng.rand_dense(gen, (n,))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,r,c,keep,block_m", [
    (16, 512, 512, 8, 128, 0.3, 256), (100, 512, 1024, 128, 128, 0.4, 256),
    (140, 256, 512, 8, 128, 0.3, 64), (3, 512, 512, 4, 256, 0.5, 256),
    (256, 1024, 4096, 128, 128, 1.0, 256),
])
def test_bcsr_kernel_matches_plain(cuda, dt, m, k, n, r, c, keep, block_m):
    x, _, prep, b = _bcsr_case(m + k, m, k, n, r, c, keep, dt, cuda)
    assert prep.k > 0
    for bias, alpha in ((b, ALPHA), (None, None)):
        before = bk.bcsr_spmm_kernel.launches
        y = bk.bcsr_spmm_kernel(x, prep, bias, alpha, block_m=block_m)
        assert bk.bcsr_spmm_kernel.launches == before + 1
        ref = bk.bcsr_spmm_kernel_plain(x, prep, bias, alpha)
        torch.cuda.synchronize()
        assert y.shape == (m, n) and y.dtype == dt
        assert_close(y.float(), ref.float(),
                     FUSED_TOL[dt] * max(1.0, float(ref.float().abs().max())), "B2")
        for resident in (True, False):
            assert torch.equal(y, bk.bcsr_spmm_kernel(x, prep, bias, alpha, block_m=16,
                                                      x_resident=resident))


@pytest.mark.cuda
def test_bcsr_kernel_empty_and_bad_inputs(cuda):
    prep = bk.bcsr_prepare(bcsr_from_dense(torch.zeros(256, 256), 8, 128, device=cuda),
                           device=cuda)
    b = torch.arange(256, dtype=torch.float32, device=cuda) - 128.0
    before = bk.bcsr_spmm_kernel.launches
    y = bk.bcsr_spmm_kernel(torch.ones(4, 256, device=cuda), prep, b, ALPHA)
    assert bk.bcsr_spmm_kernel.launches == before
    assert torch.equal(y, torch.where(b > 0, b, ALPHA * b).expand(4, 256))
    x, _, prep, b = _bcsr_case(1, 4, 256, 256, 8, 128, 1.0, torch.float32, cuda)
    with pytest.raises(TypeError):
        bk.bcsr_spmm_kernel(x.half(), prep, b)
    with pytest.raises(ValueError):
        bk.bcsr_spmm_kernel(x, prep, b[:100])
    with pytest.raises(ValueError):
        bk.bcsr_spmm_kernel(x[:, :128], prep, b)


@pytest.mark.cuda
def test_run_case_on_the_card_times_every_row(cuda):
    rows = tsweep.run_case(16, 512, 2048, 2, reps=2)
    names = [r.kernel for r in rows]
    assert "bcsr_kernel" in names and "packed_kernel_w2a8_prelu" in names
    assert all(r.valid and np.isfinite(r.time_s) and r.time_s > 0 for r in rows)
