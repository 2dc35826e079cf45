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
kernels (B4, B9 on both of its bodies) and the BCSR kernel (B2): f32 1e-4
and bf16 2**-7 (a staged value, or B2's f32 sum rounded once to bf16, can
round to the neighbouring bf16); B2's f32 showcase cases also at absolute
TOL_DENSE against the dense oracle, as the showcase holds them. The int8 cache's kernels: B7's q as B3's; its codes bitwise the
quantize of B3's f32 output (codes within 1 and scales within 1e-5 of the
plain version, whose f32 sums run in another order); B8 against its plain
version as B4, and within 2e-2 relative of B4 on the dequantized cache (p
rounds to the compute dtype after the v scale in B8, before it in B4).
The packed VJP (B1 forward on W, backward on the packed Wᵀ): y, dx and db
against autograd through the plain version at the fused kernels' f32 1e-4
and bf16 2**-7 (bf16 x, y and dx; the backward rounds the masked gradient to
bf16 before its product, as JAX's VJP casts it). The MoE layer on B1 (2·E
launches a call; in bf16 serving two B1g launches) against its plain
products as the fused kernels (a bf16
hidden row can round to the neighbouring bf16 before the down projection);
B1g's rows bitwise B1's on each expert's rows, and the grouped serving
path bitwise the slab path;
its serving rows bitwise the one-token calls (B1's rows do not depend on
M, and the combine sums each token's experts in rank order). The sharded
B1 and B2 paths run in one 2-rank gloo world sharing the card
(tests/torch_parallel_ranks.py): column shards bitwise the unsharded call,
row and ring-overlap shards at f32 1e-4, bf16 2**-7 and int8 1e-6 of the
same calls on the plain bodies. So do the expert-parallel MoE layer (bitwise
the single-rank ``moe_forward``: at most two non-zero terms a token across
the ranks) and the sequence-parallel ring (JAX's 2e-5 of the attention
math).
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
from smmb_tpu_torch.kernels.packed_spmm import (
    F32_TILES,
    MMA_TILES,
    grouped_spmm,
    packed_spmm,
    packed_spmm_f32_chain,
    packed_spmm_plain,
    tile_for,
)
from smmb_tpu_torch.kernels.packed_vjp import make_packed_linear, pack_with_transpose
from smmb_tpu_torch.models import attention as tattn
from smmb_tpu_torch.models import lm as tlm
from smmb_tpu_torch.models import mlp as tmlp
from smmb_tpu_torch.models import moe as tmoe
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
                                   (4, 100, 256), (65, 2048, 129), (256, 4096, 4096),
                                   (1, 1024, 8192), (17, 1000, 640), (33, 2048, 1024),
                                   (8, 100, 129)])
def test_kernel_matches_plain(cuda, cdt, m, k, n):
    # k=100, n=129 and int8 at k=1000 take the tensor-core kernel's element
    # loads (pieces_aligned is False there)
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
@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("k,n", [(1024, 8192), (4096, 4096)])
def test_kernel_rows_equal_the_m1_call(cuda, cdt, k, n):
    """Row r of an M-row call is bitwise the M=1 call of row r, whatever
    tile the wrapper picks for M (one K walk for every M)."""
    x, p, b = _setup(41, 256, k, n, cuda)
    ones = torch.cat([packed_spmm(x[r:r + 1], p, b, ALPHA, compute_dtype=cdt)
                      for r in range(256)])
    for m in (2, 5, 16, 17, 64, 256):
        y = packed_spmm(x[:m], p, b, ALPHA, compute_dtype=cdt)
        torch.cuda.synchronize()
        assert torch.equal(y, ones[:m]), f"{cdt} M={m} tile {tile_for(m, n, cdt)}"


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("m,k,n", [(5, 1024, 640), (100, 512, 512), (8, 100, 129),
                                   (256, 4096, 4096)])
def test_kernel_tile_override_is_bitwise(cuda, cdt, m, k, n):
    """Every tile that ``block_m``/``block_n`` name (and one side named, the
    other ``tile_for``'s) launches once and gives ``tile_for``'s output
    bitwise; a tile the kernel lacks raises before any launch."""
    x, p, b = _setup(47 + m, m, k, n, cuda)
    want = packed_spmm(x, p, b, ALPHA, compute_dtype=cdt)
    kws = [dict(block_m=bm, block_n=bn) for bm, bn in MMA_TILES]
    kws += [dict(block_m=16), dict(block_n=128)]
    for kw in kws:
        before = packed_spmm.launches
        y = packed_spmm(x, p, b, ALPHA, compute_dtype=cdt, **kw)
        assert packed_spmm.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(y, want), f"{cdt} {m}x{k}x{n} {kw}"
    before = packed_spmm.launches
    with pytest.raises(ValueError, match="16x64"):
        packed_spmm(x, p, b, ALPHA, compute_dtype=cdt, block_m=32, block_n=256)
    with pytest.raises(ValueError, match="64x128"):
        packed_spmm(x, p, b, ALPHA, block_m=32, block_n=256)
    assert packed_spmm.launches == before
    f32 = packed_spmm(x, p, b, ALPHA)
    for bm, bn in F32_TILES:
        y = packed_spmm(x, p, b, ALPHA, block_m=bm, block_n=bn)
        torch.cuda.synchronize()
        assert torch.equal(y, f32), f"f32 {m}x{k}x{n} {bm}x{bn}"


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(256, 4096, 4096), (64, 1024, 2048), (32, 1024, 1024),
                                   (1, 1024, 8192), (5, 100, 256), (17, 1000, 300),
                                   (65, 2048, 129)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_kernel_f32_tiles_are_the_chain(cuda, m, k, n, out_dtype):
    """Every f32 tile's output, and the wrapper's pick, is bitwise
    ``packed_spmm_f32_chain`` (the kernel's FMA chains in plain adds; for a
    bf16 x rounded once to bf16), and so every other tile's: aligned pieces,
    ragged K and N (element loads at 1000x300 and 2048x129), and an f32 X
    one float past a 16-byte boundary (element loads; a bf16 x is cast to a
    new f32 tensor)."""
    x, p, b = _setup(61 + m, m, k, n, cuda)
    if out_dtype == torch.bfloat16:
        xins = [x.to(torch.bfloat16)]
    else:
        shifted = torch.empty(x.numel() + 1, device=cuda)[1:].view(m, k)
        shifted.copy_(x)
        assert shifted.data_ptr() % 16 != 0
        xins = [x, shifted]
    for xin in xins:
        want = packed_spmm_f32_chain(xin.float(), p, b, ALPHA).to(out_dtype)
        for kw in [dict(block_m=bm, block_n=bn) for bm, bn in F32_TILES] + [{}]:
            before = packed_spmm.launches
            y = packed_spmm(xin, p, b, ALPHA, **kw)
            assert packed_spmm.launches == before + 1
            torch.cuda.synchronize()
            assert y.dtype == out_dtype
            assert torch.equal(y, want), f"{m}x{k}x{n} {kw} {out_dtype}"


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(1024, 8192), (4096, 4096), (1000, 300)])
def test_kernel_f32_rows_equal_the_m1_call(cuda, k, n):
    """In f32, row r of an M-row call is bitwise the M=1 call of row r,
    whatever tile the wrapper picks for M (one K walk for every tile)."""
    x, p, b = _setup(43, 256, k, n, cuda)
    ones = torch.cat([packed_spmm(x[r:r + 1], p, b, ALPHA) for r in range(256)])
    for m in (2, 5, 16, 17, 33, 64, 256):
        y = packed_spmm(x[:m], p, b, ALPHA)
        torch.cuda.synchronize()
        assert torch.equal(y, ones[:m]), f"f32 M={m} tile {tile_for(m, n, torch.float32)}"


@pytest.mark.cuda
def test_kernel_misaligned_x_pointer(cuda):
    """A bf16 X whose data starts 2 bytes past a 16-byte boundary takes the
    element loads and gives the aligned call's result bitwise."""
    x, p, b = _setup(44, 12, 512, 640, cuda)
    xb = x.to(torch.bfloat16)
    flat = torch.empty(xb.numel() + 1, dtype=torch.bfloat16, device=cuda)
    shifted = flat[1:].view(12, 512)
    shifted.copy_(xb)
    assert shifted.data_ptr() % 16 != 0
    want = packed_spmm(xb, p, b, ALPHA, compute_dtype=torch.bfloat16)
    got = packed_spmm(shifted, p, b, ALPHA, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_f32_mode_rows_and_plain(cuda):
    """The f32 parity mode (CUDA cores): within 1e-4 of the plain version,
    and its rows independent of M."""
    x, p, b = _setup(45, 64, 2048, 640, cuda)
    y = packed_spmm(x, p, b, ALPHA)
    ref = packed_spmm_plain(x, p, b, ALPHA)
    torch.cuda.synchronize()
    assert_close(y, ref, 1e-4 * max(1.0, float(ref.abs().max())), "f32 mode")
    assert torch.equal(packed_spmm(x[:5], p, b, ALPHA), y[:5])
    assert torch.equal(packed_spmm(x[3:4], p, b, ALPHA), y[3:4])


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


def _vjp_pair(x, b, gy, w, wt, cdt, kernel):
    """(y, dx, db) of one backward: through ``make_packed_linear`` (B1 on W
    forward, on Wᵀ backward) or, ``kernel=False``, autograd through the
    plain version."""
    x = x.detach().clone().requires_grad_(True)
    b = b.detach().clone().requires_grad_(True)
    if kernel:
        y = make_packed_linear(w, wt, alpha=ALPHA, compute_dtype=cdt)(x, b)
    else:
        y = packed_spmm_plain(x, w, b, ALPHA, compute_dtype=cdt)
    (y.float() * gy).sum().backward()
    return y.detach(), x.grad, b.grad


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(8, 512, 256), (4, 1000, 600), (256, 4096, 4096)])
def test_packed_linear_vjp_matches_plain_autograd(cuda, cdt, m, k, n):
    """B1 forward on W and backward on the packed Wᵀ against autograd
    through the plain version: f32 1e-4, bf16 (x, y and dx in bf16) 2**-7,
    relative to max(1, max|·|); two launches, one without dx."""
    rs = np.random.default_rng(m + k)
    wd = rs.choice(np.array([-1.0, 0.0, 1.0], np.float32), size=(k, n), p=[0.05, 0.9, 0.05])
    w, wt = pack_with_transpose(torch.from_numpy(wd).to(cuda))
    x = torch.from_numpy(rs.uniform(-1, 1, (m, k)).astype(np.float32)).to(cuda, cdt)
    b = torch.from_numpy(rs.uniform(-1, 1, (n,)).astype(np.float32)).to(cuda)
    gy = torch.from_numpy(rs.uniform(-1, 1, (m, n)).astype(np.float32)).to(cuda)
    before = packed_spmm.launches
    got = _vjp_pair(x, b, gy, w, wt, cdt, True)
    assert packed_spmm.launches == before + 2
    want = _vjp_pair(x, b, gy, w, wt, cdt, False)
    assert packed_spmm.launches == before + 2
    for g, r, what in zip(got, want, ("y", "dx", "db")):
        assert g.shape == r.shape
        tol = FUSED_TOL[cdt] * max(1.0, float(r.float().abs().max()))
        assert_close(g.float(), r.float(), tol, what)
    layer = make_packed_linear(w, wt, alpha=ALPHA, compute_dtype=cdt)
    (layer(x, b.detach().clone().requires_grad_(True)).float() * gy).sum().backward()
    assert packed_spmm.launches == before + 3  # x needs no grad: no backward launch


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
    ("fused_block_tail", 9, 512, 1536), ("fused_block_tail", 1, 2048, 8192),
    ("fused_block_tail", 32, 1024, 4096), ("fused_mlp", 9, 2048, 8192),
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
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [3072, 1536])
def test_fused_norm_qkv_rows_of_m5_equal_the_m1_calls(cuda, cdt, n):
    """B3 at M=5 (the 8-row tile of a chunk or a verify): every row bitwise
    the M=1 call on that row."""
    args, kw = _fused_args("fused_norm_qkv", 13, 5, 1024, n, cuda)
    chunk = fk.fused_norm_qkv(*args, compute_dtype=cdt, **kw)
    for r in range(5):
        one = fk.fused_norm_qkv(args[0][r:r + 1], *args[1:], compute_dtype=cdt, **kw)
        assert torch.equal(chunk[r:r + 1], one), r


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["B3", "B7"])
def test_qkv_items_one_launch_per_call(cuda, quant):
    """B3 and B7 are one kernel a call (B7's a cluster launch), and the
    counter rises once a call."""
    if quant:
        args, kw = _b7_args(4, 1, 1024, 8, 128, cuda)
        fn = fk.fused_norm_qkv_quant
    else:
        args, kw = _fused_args("fused_norm_qkv", 4, 1, 1024, 3072, cuda)
        fn = fk.fused_norm_qkv
    rows, counted = _counted_breakdown(fn, lambda: fn(*args, compute_dtype=torch.bfloat16, **kw))
    assert counted
    assert [r["name"] for r in rows if "qkv_items_kernel" not in r["name"]] == []
    assert sum(r["launches"] for r in rows) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_fused_items_rows_equal_the_m1_call(cuda, cdt):
    """B6 at the prefill's M=32 and B5 at a verify's M=9: rows bitwise the
    M=1 calls (two row tiles and a one-row tile walk the same items)."""
    for name, m, d, h, rows in (("fused_mlp", 32, 1024, 4096, (0, 5, 31)),
                                ("fused_block_tail", 9, 512, 1536, (0, 8))):
        args, kw = _fused_args(name, 21, m, d, h, cuda)
        n_act = 2 if name == "fused_block_tail" else 1
        fn = getattr(fk, name)
        chunk = fn(*args, compute_dtype=cdt, **kw)
        for r in rows:
            one = tuple(a[r:r + 1] if i < n_act else a for i, a in enumerate(args))
            assert torch.equal(chunk[r:r + 1], fn(*one, compute_dtype=cdt, **kw)), (name, r)


@pytest.mark.cuda
@pytest.mark.parametrize("name,m,d,h", [("fused_block_tail", 1, 1024, 4096),
                                        ("fused_block_tail", 9, 512, 1536),
                                        ("fused_mlp", 32, 1024, 4096),
                                        ("fused_mlp", 9, 2048, 8192)])
def test_fused_items_grid_does_not_change_the_result(cuda, name, m, d, h):
    """One cooperative launch at any grid: blocks walk the same fixed items,
    so forced grids of 1, 7 and 33 blocks give the occupancy grid's output
    bitwise; a grid the card cannot hold at once is refused."""
    args, kw = _fused_args(name, 5, m, d, h, cuda)
    fn = getattr(fk, name)
    a = d if name == "fused_block_tail" else None
    grid = fk.items_grid(m, d, h, d, a, cuda)
    assert 0 < grid <= fk.most_items(m, h, d, a)
    for cdt in (torch.float32, torch.bfloat16):
        base = fn(*args, compute_dtype=cdt, **kw)
        for forced in (1, 7, 33, grid):
            assert torch.equal(fn(*args, compute_dtype=cdt, _grid=forced, **kw), base)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fn(*args, compute_dtype=torch.bfloat16, _grid=1 << 20, **kw)
    assert torch.equal(fn(*args, compute_dtype=torch.bfloat16, **kw),
                       fn(*args, compute_dtype=torch.bfloat16, _grid=grid, **kw))


def _counted_breakdown(fn, call, n_calls=5):
    """bench/trace.py's kernel rows of ``call`` (which calls the wrapper
    ``fn`` once), and whether ``fn.launches`` rose once a call."""
    from smmb_tpu_torch.bench.trace import kernel_breakdown

    calls = [0]

    def counted():
        calls[0] += 1
        call()

    before = fn.launches
    rows = kernel_breakdown(counted, n_calls=n_calls)
    return rows, fn.launches - before == calls[0]


@pytest.mark.cuda
@pytest.mark.parametrize("name,m", [("fused_block_tail", 1), ("fused_mlp", 32)])
def test_fused_items_one_launch_per_call(cuda, name, m):
    """B5 and B6 are one kernel a call (no memset, no second launch), and
    the counter rises once a call."""
    args, kw = _fused_args(name, 9, m, 1024, 4096, cuda)
    fn = getattr(fk, name)
    rows, counted = _counted_breakdown(
        fn, lambda: fn(*args, compute_dtype=torch.bfloat16, **kw))
    assert counted
    assert [r["name"] for r in rows if "mlp_items_kernel" not in r["name"]] == []
    assert sum(r["launches"] for r in rows) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_fused_mlp_ragged_output_columns(cuda, cdt):
    """B6 with K_out = 1000 (not a multiple of the 16-byte copies): the
    plane's rows are padded for the copies, the columns past K_out unwritten."""
    rs = np.random.default_rng(31)
    x = torch.from_numpy(rs.uniform(-1, 1, (3, 512)).astype(np.float32)).to(cuda)
    wu = pack_ternary(rs.choice(np.array([-1.0, 0.0, 1.0], np.float32), (512, 1024)),
                      device=cuda)
    wd = pack_ternary(rs.choice(np.array([-1.0, 0.0, 1.0], np.float32), (1024, 1000)),
                      device=cuda)
    bu = torch.from_numpy(rs.uniform(-1, 1, 1024).astype(np.float32)).to(cuda)
    bd = torch.from_numpy(rs.uniform(-1, 1, 1000).astype(np.float32)).to(cuda)
    s = torch.tensor(0.7, device=cuda)
    y = fk.fused_mlp(x, wu, s, bu, wd, s, bd, alpha=ALPHA, compute_dtype=cdt)
    ref = fk.fused_mlp_plain(x, wu, s, bu, wd, s, bd, alpha=ALPHA, compute_dtype=cdt)
    torch.cuda.synchronize()
    assert y.shape == (3, 1000)
    assert_close(y, ref, FUSED_TOL[cdt] * max(1.0, float(ref.abs().max())), "ragged B6")


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


# B4 and B8: (B, H, KVH, S, pos, window). The kernel splits the cache into
# spans of 64 columns at S <= 2048 and 256 at S = 8192: the chunks at
# pos - 4 .. pos of the S = 224 pos 66, S = 1024 and pos 7938 shapes
# straddle a span boundary, and the window of 1000 at pos 8191 has its edge
# inside a span.
DECODE_SHAPES = [
    (1, 8, 8, 224, 95, None), (1, 8, 2, 1024, 512, None), (2, 4, 4, 300, 260, 64),
    (4, 8, 8, 1024, 512, None), (1, 8, 8, 224, 66, None), (1, 8, 8, 8192, 8191, None),
    (1, 8, 8, 8192, 7938, None), (1, 8, 2, 8192, 8191, 1000), (4, 8, 8, 8192, 8191, None),
]


def _normal(rs, shape, dtype, dev, scale=1.0):
    return (torch.from_numpy(rs.standard_normal(shape).astype(np.float32)) * scale).to(
        device=dev, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kvh,s,pos,window", DECODE_SHAPES)
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


# B9's CUDA-core body at the widths and lengths the first port's card tests
# did not reach: f32 at T=4096 causal, bf16 at hd 256 and 512
@pytest.mark.cuda
@pytest.mark.parametrize("dt,b,h,kvh,t,hd", [
    (torch.float32, 1, 8, 8, 4096, 128), (torch.bfloat16, 1, 4, 4, 1024, 256),
    (torch.bfloat16, 1, 2, 2, 512, 512),
])
def test_flash_attention_cuda_core_matches_plain(cuda, dt, b, h, kvh, t, hd):
    assert fa.kernel_route(dt, hd).body == "cuda_core"
    rs = np.random.default_rng(t + hd + 11)
    q = _normal(rs, (b, t, h, hd), dt, cuda, 4.0).permute(0, 2, 1, 3)
    k = _normal(rs, (b, kvh, t, hd), dt, cuda)
    v = _normal(rs, (b, kvh, t, hd), dt, cuda)
    before = fa.flash_attention.launches
    y = fa.flash_attention(q, k, v)
    assert fa.flash_attention.launches == before + 1
    ref = fa.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert y.shape == ref.shape and y.dtype == dt
    assert_close(y.float(), ref.float(),
                 FUSED_TOL[dt] * max(1.0, float(ref.float().abs().max())), "B9 cuda core")


@pytest.mark.cuda
@pytest.mark.parametrize("dt,hd", [(torch.float32, 128), (torch.bfloat16, 256)])
@pytest.mark.parametrize("pipeline_p", [False, True])
def test_flash_attention_prefix_rows_bitwise(cuda, dt, hd, pipeline_p):
    """Causal rows 0..511 of a T=1536 call equal the call on the first 512
    tokens bitwise: the kv tile and a row's walk do not depend on T (the
    two calls take other row tiles and blocks)."""
    rs = np.random.default_rng(hd + 5)
    q = _normal(rs, (1, 4, 1536, hd), dt, cuda, 4.0)
    k = _normal(rs, (1, 4, 1536, hd), dt, cuda)
    v = _normal(rs, (1, 4, 1536, hd), dt, cuda)
    y = fa.flash_attention(q, k, v, pipeline_p=pipeline_p)
    head = fa.flash_attention(q[:, :, :512], k[:, :, :512], v[:, :, :512],
                              pipeline_p=pipeline_p)
    torch.cuda.synchronize()
    assert torch.equal(y[:, :, :512], head)


# every row tile the CUDA-core body takes at these widths: T=300 causal
# with a window (ragged q tiles, masked tiles before and after a row's live
# ones), T=100 over S=160 (T < S), GQA 8/2, both schedules
@pytest.mark.cuda
@pytest.mark.parametrize("dt,hd", [(torch.float32, 128), (torch.float32, 64),
                                   (torch.float32, 200), (torch.bfloat16, 256),
                                   (torch.bfloat16, 512), (torch.float32, 902)])
@pytest.mark.parametrize("b,h,kvh,t,s,window", [(1, 8, 2, 300, 300, 100),
                                                (2, 4, 4, 100, 160, None)])
def test_flash_attention_every_row_tile_bitwise(cuda, dt, hd, b, h, kvh, t, s, window):
    rs = np.random.default_rng(t + hd)
    q = _normal(rs, (b, h, t, hd), dt, cuda, 4.0)
    k = _normal(rs, (b, kvh, s, hd), dt, cuda)
    v = _normal(rs, (b, kvh, s, hd), dt, cuda)
    for pipe in (False, True):
        if hd > 898 and pipe:
            continue
        y = fa.flash_attention(q, k, v, window=window, pipeline_p=pipe)
        for rows in fa.core_rows(dt, hd, pipe):
            got = fa.flash_attention(q, k, v, window=window, pipeline_p=pipe, _rows=rows)
            torch.cuda.synchronize()
            assert torch.equal(got, y), (pipe, rows)
    with pytest.raises(ValueError, match="row tile"):
        fa.flash_attention(q, k, v, _rows=48)


# B9's tensor-core body: hd 64 and 128, GQA 8/2, a window, a ragged last
# tile (T=200), non-causal, and g = 3 (64-row blocks of 21 tokens)
MMA_SHAPES = [
    (1, 8, 8, 256, 64, True, None), (1, 8, 8, 256, 128, True, None),
    (1, 8, 2, 512, 128, True, None), (1, 8, 8, 512, 128, True, 64),
    (2, 8, 8, 200, 128, True, None), (1, 8, 8, 256, 128, False, None),
    (1, 4, 2, 130, 64, False, None), (1, 6, 2, 100, 64, True, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kvh,t,hd,causal,window", MMA_SHAPES)
def test_flash_attention_mma_body_matches_plain(cuda, b, h, kvh, t, hd, causal, window):
    """bf16 at hd 64 and 128 runs the mma.sync body (kernel_route says so)
    and agrees with the plain version at 2**-7 of max(1, max|Y|)."""
    assert fa.kernel_route(torch.bfloat16, hd) == ("mma", 64)
    rs = np.random.default_rng(t + hd + 7)
    q = _normal(rs, (b, t, h, hd), torch.bfloat16, cuda, 4.0).permute(0, 2, 1, 3)
    k = _normal(rs, (b, kvh, t, hd), torch.bfloat16, cuda)
    v = _normal(rs, (b, kvh, t, hd), torch.bfloat16, cuda)
    before = fa.flash_attention.launches
    y = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.flash_attention.launches == before + 1
    ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert y.shape == ref.shape and y.dtype == torch.bfloat16
    assert_close(y.float(), ref.float(),
                 FUSED_TOL[torch.bfloat16] * max(1.0, float(ref.float().abs().max())),
                 "B9 mma")


@pytest.mark.cuda
def test_flash_attention_mma_body_misaligned_view(cuda):
    """A view the mma body cannot copy in 16-byte pieces (odd pointer) is
    copied by the wrapper, and the result equals the aligned call's."""
    rs = np.random.default_rng(3)
    flat = _normal(rs, (1 + 8 * 128 * 64,), torch.bfloat16, cuda)
    q = flat[1:].view(1, 8, 128, 64)
    y = fa.flash_attention(q, q, q)
    torch.cuda.synchronize()
    assert torch.equal(y, fa.flash_attention(q.clone(), q.clone(), q.clone()))


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


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kvh,t,hd,window", [
    (1, 8, 8, 32, 128, None), (2, 8, 2, 200, 128, None), (1, 4, 4, 300, 64, 64),
    (1, 2, 2, 70, 256, None), (1, 8, 8, 512, 128, None), (1, 4, 4, 512, 256, None),
    *((b, h, kvh, t, hd, window) for b, h, kvh, t, hd, causal, window in MMA_SHAPES if causal),
])
def test_flash_pipeline_p_bitwise_serial(cuda, dt, b, h, kvh, t, hd, window):
    """B9p equals the serial kernel bitwise where both take the same tile,
    counts its launches apart, and agrees with its plain version."""
    rs = np.random.default_rng(t + hd + 1)
    q = _normal(rs, (b, h, t, hd), dt, cuda, 4.0)
    k = _normal(rs, (b, kvh, t, hd), dt, cuda)
    v = _normal(rs, (b, kvh, t, hd), dt, cuda)
    before = (fa.flash_attention.launches, fa.flash_attention.pipe_launches)
    y = fa.flash_attention(q, k, v, window=window, pipeline_p=True)
    assert (fa.flash_attention.launches, fa.flash_attention.pipe_launches) == \
        (before[0], before[1] + 1)
    route = fa.kernel_route(dt, hd, True)
    assert route == fa.kernel_route(dt, hd)
    serial = fa.flash_attention(q, k, v, window=window)
    ref = fa.flash_attention_plain(q, k, v, window=window, pipeline_p=True,
                                   block_kv=route.tile)
    torch.cuda.synchronize()
    assert torch.equal(y, serial)
    assert_close(y.float(), ref.float(),
                 FUSED_TOL[dt] * max(1.0, float(ref.float().abs().max())), "B9p")


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_speculative_flash_equals_flash_generate(cuda, cdt):
    """Greedy speculative decoding under use_flash emits flash generate's
    tokens: B1/B3/B5 rows do not depend on M, and B4's chunk rows equal its
    decode rows."""
    from smmb_tpu_torch.models.spec_decode import generate_speculative

    cfg = tlm.TernaryLMConfig(vocab=512, d_model=512, n_heads=4, d_ff=1024,
                              n_layers=2, max_len=48)
    dcfg = tlm.TernaryLMConfig(vocab=512, d_model=256, n_heads=2, d_ff=512,
                               n_layers=1, max_len=48)
    target = tlm.pack_lm(tlm.init_lm(rng.make_generator(0), cfg))
    draft = tlm.pack_lm(tlm.init_lm(rng.make_generator(1), dcfg))
    prompt = torch.randint(0, cfg.vocab, (1, 8), generator=rng.make_generator(2),
                           device=cuda)
    want = tlm.generate(target, prompt, cfg, 16, compute_dtype=cdt, use_flash=True)
    for d, d_cfg in ((draft, dcfg), (target, cfg)):
        before = fd.flash_attention_decode.launches
        got = generate_speculative(target, d, prompt, cfg, d_cfg, 16, k=4,
                                   compute_dtype=cdt, use_flash=True)
        assert fd.flash_attention_decode.launches > before
        assert torch.equal(got, want)


def _bcsr_case(seed, m, k, n, r, c, keep, dt, dev):
    gen = rng.make_generator(seed, dev)
    w = rng.rand_block_ternary(gen, (k, n), block=(r, c), keep=keep, non_zero=2)
    prep = bk.bcsr_prepare(bcsr_from_dense(w, r, c, device=dev), device=dev)
    return rng.rand_dense(gen, (m, k), dtype=dt), w, prep, rng.rand_dense(gen, (n,))


def _bcsr_kernel_names(x, prep, b):
    """The device kernels one B2 call runs (by the profiler)."""
    from smmb_tpu_torch.bench.trace import kernel_breakdown

    return {r["name"] for r in kernel_breakdown(
        lambda: bk.bcsr_spmm_kernel(x, prep, b, ALPHA), n_calls=2)}


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,r,c,keep,block_m,route", [
    (16, 512, 512, 8, 128, 0.3, 256, "cuda_core"), (100, 512, 1024, 128, 128, 0.4, 256, "mma"),
    (140, 256, 512, 8, 128, 0.3, 64, "cuda_core"), (3, 512, 512, 4, 256, 0.5, 256, "cuda_core"),
    (256, 1024, 4096, 128, 128, 1.0, 256, "mma"),
    (256, 4096, 4096, 128, 128, 0.3, 256, "mma"),  # the block-sparse workload
    (1, 1024, 4096, 128, 128, 1.0, 256, "mma"),  # the showcase's M = 1
    (8, 512, 512, 64, 128, 0.5, 256, "mma"),  # 16-row chunks
    (5, 1024, 512, 256, 128, 0.5, 256, "mma"),  # two chunks a block
    (4, 768, 512, 192, 256, 0.5, 256, "mma"),  # three 16-row chunks a block
])
def test_bcsr_kernel_matches_plain(cuda, dt, m, k, n, r, c, keep, block_m, route):
    x, _, prep, b = _bcsr_case(m + k, m, k, n, r, c, keep, dt, cuda)
    assert prep.k > 0
    assert bk.bcsr_route(r, c) == route
    names = _bcsr_kernel_names(x, prep, b)
    body = "bcsr_spmm_mma" if route == "mma" else "bcsr_spmm_kernel"
    assert len(names) == 1 and body in names.pop()
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
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_bcsr_rows_equal_the_m1_call(cuda, dt):
    """No split of K: rows of M = 2 ... 256 calls are bitwise the M = 1
    calls at 1024×4096, under every tile of the mma body (the C entry under
    a forced tile)."""
    x, _, prep, b = _bcsr_case(77, 256, 1024, 4096, 128, 128, 1.0, dt, cuda)
    ones = torch.cat([bk.bcsr_spmm_kernel(x[i:i + 1], prep, b, ALPHA) for i in range(256)])
    for m in (1, 2, 5, 16, 17, 64, 256):
        for tile in bk.MMA_TILES:
            y = bk._launch(x[:m], prep, b, ALPHA, tile)
            torch.cuda.synchronize()
            assert torch.equal(y, ones[:m]), (m, tile)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", tsweep.SHOWCASE_CASES)
def test_bcsr_showcase_cases_within_tol_dense(cuda, m, k, n):
    """The showcase's f32 ``bcsr_kernel`` row, held as the showcase holds it:
    every element within TOL_DENSE (1e-4 absolute) of the dense oracle."""
    from smmb_tpu_torch.ops.dense import gemm
    from smmb_tpu_torch.utils.compare import TOL_DENSE

    gen = rng.make_generator(0, cuda)
    x = rng.rand_dense(gen, (m, k))
    w = rng.rand_ternary(gen, (k, n), non_zero=2)
    b = rng.rand_dense(gen, (n,))
    prep = bk.bcsr_prepare(bcsr_from_dense(w.cpu().numpy(), 128, 128, device=cuda),
                           device=cuda)
    assert prep.k == (k // 128) * (n // 128)
    assert_close(bk.bcsr_spmm_kernel(x, prep, b), gemm(x, w, b), TOL_DENSE, "B2 showcase")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_bcsr_kernel_one_launch_per_call(cuda, dt):
    """One kernel event a call (the f32 split is in the kernel: no pre-pass),
    and the counter rises once a call."""
    x, _, prep, b = _bcsr_case(5, 256, 1024, 4096, 128, 128, 1.0, dt, cuda)
    rows, counted = _counted_breakdown(
        bk.bcsr_spmm_kernel, lambda: bk.bcsr_spmm_kernel(x, prep, b, ALPHA))
    assert counted
    assert [r["name"] for r in rows if "bcsr_spmm_mma" not in r["name"]] == []
    assert sum(r["launches"] for r in rows) == 1


@pytest.mark.cuda
def test_bcsr_kernel_misaligned_x_pointer(cuda):
    """A view of X off 16 bytes takes an aligned copy, not a refusal; a
    forced tile the mma body has not is refused before the launch."""
    x, _, prep, b = _bcsr_case(6, 12, 512, 1024, 128, 128, 0.5, torch.float32, cuda)
    flat = torch.empty(x.numel() + 1, device=cuda)
    xv = flat[1:].view(12, 512)
    xv.copy_(x)
    assert xv.data_ptr() % 16
    y = bk.bcsr_spmm_kernel(xv, prep, b, ALPHA)
    assert torch.equal(y, bk.bcsr_spmm_kernel(x, prep, b, ALPHA))
    with pytest.raises(ValueError):  # not a tile of the mma body
        bk._launch(x, prep, b, ALPHA, (32, 128))


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


def _b7_args(seed, m, d, kvh, hd, dev, x_dtype=torch.float32):
    args, _ = _fused_args("fused_norm_qkv", seed, m, d, d + 2 * kvh * hd, dev)
    return (args[0].to(x_dtype),) + args[1:], dict(eps=1e-6, d_model=d, kv_heads=kvh,
                                                   head_dim=hd)


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,kvh,hd", [(1, 1024, 8, 128), (1, 1024, 2, 128),
                                        (5, 1024, 4, 256), (9, 512, 2, 128),
                                        (5, 1024, 8, 128), (1, 512, 1, 512),
                                        (2, 512, 1, 384)])
def test_fused_norm_qkv_quant_matches_plain(cuda, cdt, m, d, kvh, hd):
    """B7 against its plain version; its q bitwise B3's output (at hd 256
    and 512 too) and its codes bitwise the quantize of B3's f32 y; every row
    of the call bitwise the M=1 call of that row."""
    args, kw = _b7_args(m + kvh, m, d, kvh, hd, cuda)
    before = fk.fused_norm_qkv_quant.launches
    q, codes, scales = fk.fused_norm_qkv_quant(*args, compute_dtype=cdt, **kw)
    assert fk.fused_norm_qkv_quant.launches == before + 1
    pq, pcodes, pscales = fk.fused_norm_qkv_quant_plain(*args, compute_dtype=cdt, **kw)
    y = fk.fused_norm_qkv(*args, eps=1e-6, compute_dtype=cdt)
    torch.cuda.synchronize()
    assert torch.equal(q, y[:, :d])
    want_codes, want_scales = fk.quantize_heads(y, d, kvh, hd)
    assert torch.equal(codes, want_codes) and torch.equal(scales, want_scales)
    assert_close(q, pq, FUSED_TOL[cdt] * max(1.0, float(pq.abs().max())), "B7 q")
    assert int((codes.int() - pcodes.int()).abs().max()) <= 1
    assert_close(scales, pscales, 1e-5 * float(pscales.abs().max()), "B7 scales")
    for r in range(m):
        one = fk.fused_norm_qkv_quant(args[0][r:r + 1], *args[1:], compute_dtype=cdt, **kw)
        assert all(torch.equal(a[r:r + 1], b) for a, b in zip((q, codes, scales), one)), r


def _int8_cache(rs, b, s, kvh, n, dev):
    cfg = tattn.TernaryAttentionConfig(d_model=kvh * 128, n_heads=kvh)
    cache = tattn.init_kv_cache(cfg, b, s, quantized=True, device=dev)
    k = _normal(rs, (b, n, kvh, 128), torch.float32, dev)
    v = _normal(rs, (b, n, kvh, 128), torch.float32, dev)
    return tattn._cache_write(cache, k, v, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kvh,s,pos,window", DECODE_SHAPES)
def test_flash_decode_quant_matches_plain_rows_bitwise(cuda, cdt, b, h, kvh, s, pos, window):
    rs = np.random.default_rng(pos + h + 1)
    cache = _int8_cache(rs, b, s, kvh, pos + 1, cuda)
    kv, sc = cache["kv"], cache["kv_scale"]
    q = _normal(rs, (b, 5, h, 128), torch.float32, cuda, 8.0)
    kw = dict(window=window, compute_dtype=cdt)
    dec = fd.flash_attention_decode_quant
    before = dec.launches
    y = dec(q[:, 0], kv, sc, pos, **kw)
    assert dec.launches == before + 1
    ref = fd.flash_attention_decode_quant_plain(q[:, 0], kv, sc, pos, **kw)
    torch.cuda.synchronize()
    assert y.shape == ref.shape and y.dtype == cdt
    scale = max(1.0, float(ref.float().abs().max()))
    assert_close(y.float(), ref.float(), FUSED_TOL[cdt] * scale, "B8")
    kc, vc = (t.reshape(b, s, kvh * 128).contiguous() for t in tattn._cache_kv(cache, kvh))
    b4 = fd.flash_attention_decode(q[:, 0], kc, vc, pos, **kw)
    assert_close(y.float(), b4.float(), 2e-2 * scale, "B8 vs B4 on the dequantized cache")
    chunk = fd.flash_attention_chunk_quant(q, kv, sc, pos - 4, **kw)
    for c in range(5):
        assert torch.equal(chunk[:, c], dec(q[:, c], kv, sc, pos - 4 + c, **kw))
    for r in range(b):
        assert torch.equal(y[r:r + 1], dec(q[r:r + 1, 0], kv[r:r + 1], sc[r:r + 1], pos, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["B4", "B8"])
def test_flash_decode_one_launch_per_call(cuda, quant):
    """Each call is one launch of one kernel, over (live spans, KVH, B)
    blocks: no memset and no second combine kernel; at pos 8191 of S = 8192
    the grid has at least 128 blocks."""
    rs = np.random.default_rng(11)
    b, h, kvh, s, pos = 1, 8, 8, 8192, 8191
    q = _normal(rs, (b, h, 128), torch.float32, cuda, 8.0)
    if quant:
        cache = _int8_cache(rs, b, s, kvh, pos + 1, cuda)
        bufs, fn = (cache["kv"], cache["kv_scale"]), fd.flash_attention_decode_quant
    else:
        bufs = tuple(_normal(rs, (b, s, kvh * 128), torch.bfloat16, cuda) for _ in range(2))
        fn = fd.flash_attention_decode
    rows, counted = _counted_breakdown(
        fn, lambda: fn(q, *bufs, pos, compute_dtype=torch.bfloat16))
    assert counted
    assert [r["name"] for r in rows if "flash_decode_kernel" not in r["name"]] == []
    assert sum(r["launches"] for r in rows) == 1
    assert fd.live_spans(pos, 1, None, fd.split_cols(s))[1] * kvh * b >= 128


@pytest.mark.cuda
def test_generate_kv_quant_launch_counts_and_tokens(cuda):
    cfg = tlm.TernaryLMConfig(vocab=512, d_model=512, n_heads=4, d_ff=1024,
                              n_layers=2, max_len=32)
    gen = rng.make_generator(0)
    packed = tlm.pack_lm(tlm.init_lm(gen, cfg))
    prompt = torch.randint(0, cfg.vocab, (1, 8), generator=gen, device=cuda)
    counted = (packed_spmm, fk.fused_norm_qkv, fk.fused_norm_qkv_quant, fk.fused_block_tail,
               fk.fused_mlp, fa.flash_attention, fd.flash_attention_decode,
               fd.flash_attention_decode_quant)
    for flash, want in ((True, [6 * 2 + 1 + 5, 0, 2 * 5, 2 * 5, 2, 2, 0, 2 * 5]),
                        (False, [6 * 2 + 1 + 5, 0, 2 * 5, 2 * 5, 2, 0, 0, 0])):
        for fn in counted:
            fn.launches = 0
        toks = tlm.generate(packed, prompt, cfg, 5, kv_quant=True, use_flash=flash)
        assert [fn.launches for fn in counted] == want
        # int8 cache noise may flip late near-tie tokens; early steps agree
        plain = tlm.generate(packed, prompt, cfg, 5, use_kernel=False, kv_quant=True)
        assert torch.equal(toks[:, :2], plain[:, :2])


def _moe_layer(cuda, seed, d=1024, f=4096, e=8, k=2):
    cfg = tmoe.TernaryMoEConfig(d_model=d, d_ff=f, n_experts=e, top_k=k)
    gen = rng.make_generator(seed)
    packed = tmoe.pack_moe(tmoe.init_moe(gen, cfg))
    return cfg, packed, rng.rand_dense(gen, (32, d)) * 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("no_drop", [False, True])
def test_moe_layer_on_b1_matches_plain(cuda, cdt, no_drop):
    cfg, packed, x = _moe_layer(cuda, 40)
    packed_spmm.launches = packed_spmm.launches_grouped = 0
    y = tmoe.moe_forward(packed, x, cfg, compute_dtype=cdt, no_drop=no_drop)
    grouped = no_drop and cdt == torch.bfloat16  # B1g: the experts in two launches
    assert (packed_spmm.launches, packed_spmm.launches_grouped) == (
        (0, 2) if grouped else (2 * cfg.n_experts, 0))
    ref = tmoe.moe_forward(packed, x, cfg, compute_dtype=cdt, no_drop=no_drop,
                           use_kernel=False)
    torch.cuda.synchronize()
    assert y.dtype == torch.float32 and bool(torch.isfinite(y).all())
    assert_close(y, ref, FUSED_TOL[cdt] * max(1.0, float(ref.abs().max())), "MoE on B1")


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_moe_decode_rows_bitwise_the_forward_rows(cuda, cdt):
    """Serving (no_drop): each token's row of a 32-token call equals its
    one-token call bitwise, as a decode step's row equals the prefill's."""
    cfg, packed, x = _moe_layer(cuda, 41)
    full = tmoe.moe_forward(packed, x, cfg, compute_dtype=cdt, no_drop=True)
    for i in (0, 5, 31):
        one = tmoe.moe_forward(packed, x[i:i + 1], cfg, compute_dtype=cdt, no_drop=True)
        assert torch.equal(one[0], full[i]), i


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,e,m,out_dtype,alpha", [
    (256, 384, 8, 300, torch.float32, ALPHA),  # 64-row tiles
    (256, 384, 64, 40, torch.bfloat16, None),  # 16-row tiles, most experts empty
    (72, 40, 5, 123, torch.float32, ALPHA),  # element loads: K % 8, N % 16
])
def test_b1g_rows_bitwise_b1(cuda, k, n, e, m, out_dtype, alpha):
    """Each expert's rows of one B1g call equal B1's call on those rows and
    that expert's plane, bit for bit."""
    gen = rng.make_generator(50 + e)
    cfg = tmoe.TernaryMoEConfig(d_model=k, d_ff=n, n_experts=e)
    packed = tmoe.pack_moe(tmoe.init_moe(gen, cfg), quantize=True)
    counts = torch.randint(0, 2 * m // e + 1, (e,), generator=gen, device=cuda)
    counts[0] = 0
    offsets = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    x = rng.rand_dense(gen, (int(offsets[-1]), k)).to(torch.bfloat16)
    packed_spmm.launches_grouped = 0
    y = grouped_spmm(x, packed["w_up"], packed["b_up"], offsets, alpha, out_dtype=out_dtype)
    assert packed_spmm.launches_grouped == 1 and y.dtype == out_dtype
    host = offsets.tolist()
    for i, (lo, hi) in enumerate(zip(host[:-1], host[1:])):
        want = packed_spmm(x[lo:hi].to(out_dtype), tmoe.expert_plane(packed["w_up"], i),
                           packed["b_up"][i], alpha, compute_dtype=torch.bfloat16)
        assert torch.equal(y[lo:hi], want), i


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 300])
def test_moe_grouped_equals_slab_on_card(cuda, n):
    """Serving's grouped experts (two B1g launches) against the slab path
    (2·E B1 launches) on the same routing: bitwise, 64 experts, top-8."""
    cfg = tmoe.TernaryMoEConfig(d_model=256, d_ff=128, n_experts=64, top_k=8)
    gen = rng.make_generator(60)
    packed = tmoe.pack_moe(tmoe.init_moe(gen, cfg), quantize=True)
    x = rng.rand_dense(gen, (n, 256)).to(torch.bfloat16)
    got = tmoe.moe_forward(packed, x, cfg, compute_dtype=torch.bfloat16, no_drop=True)
    cap = tmoe._round8(n)
    route = tmoe._assign(tmoe.router_logits(x, packed["router"]), cap, 8)
    want = tmoe._slab_forward(packed, x, cfg, *route, cap, torch.bfloat16, True)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_moe_generate_launch_counts_and_tokens(cuda):
    cfg = tlm.TernaryLMConfig(vocab=512, d_model=512, n_heads=4, d_ff=1024, n_layers=2,
                              max_len=32, n_experts=4, top_k=2)
    gen = rng.make_generator(0)
    packed = tlm.pack_lm(tlm.init_lm(gen, cfg))
    prompt = torch.randint(0, cfg.vocab, (1, 8), generator=gen, device=cuda)
    counted = (packed_spmm, fk.fused_norm_qkv, fk.fused_block_tail, fk.fused_mlp)
    for fn in counted:
        fn.launches = 0
    toks = tlm.generate(packed, prompt, cfg, 5)
    # no fused kernel on an MoE block: B1 for every projection and expert
    assert [fn.launches for fn in counted] == [2 * (6 + 8) + 1 + 5 * (2 * (2 + 8) + 1), 0, 0, 0]
    plain = tlm.generate(packed, prompt, cfg, 5, use_kernel=False)
    assert torch.equal(toks, plain)


@pytest.mark.cuda
def test_lora_generate_launch_counts_and_logits(cuda):
    from smmb_tpu_torch.models.lora import attach_lora, init_lora_lm

    cfg = tlm.TernaryLMConfig(vocab=512, d_model=512, n_heads=4, d_ff=1024,
                              n_layers=2, max_len=32)
    gen = rng.make_generator(0)
    packed = tlm.pack_lm(tlm.init_lm(gen, cfg))
    ad = init_lora_lm(gen, cfg, rank=8, targets=("wq", "wv", "w_up", "w_down"))
    ad = [{n: (a, b + 0.01) for n, (a, b) in blk.items()} for blk in ad]
    model = attach_lora(packed, ad)
    prompt = torch.randint(0, cfg.vocab, (1, 8), generator=gen, device=cuda)
    counted = (packed_spmm, fk.fused_norm_qkv, fk.fused_block_tail, fk.fused_mlp)
    for fn in counted:
        fn.launches = 0
    toks = tlm.generate(model, prompt, cfg, 5)
    # adapted layers are off B3, B5 and B6; the base stays on B1
    assert [fn.launches for fn in counted] == [2 * 8 + 1 + 5 * (2 * 6 + 1), 0, 0, 0]
    assert torch.equal(toks, tlm.generate(model, prompt, cfg, 5, use_kernel=False))
    y = tlm.lm_forward(model, prompt, cfg)
    ref = tlm.lm_forward(model, prompt, cfg, use_kernel=False)
    assert_close(y, ref, 2e-4 + 1.1e-4 * float(ref.abs().max()), "LoRA logits")


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16, torch.int8])
def test_native_packed_planes_through_b1_bitwise(cuda, cdt):
    from smmb_tpu_torch.runtime import native

    assert native.native_available()
    gen = rng.make_generator(41, "cuda")
    w = rng.rand_ternary(gen, (1000, 640), non_zero=4)
    x = rng.rand_dense(gen, (33, 1000))
    b = rng.rand_dense(gen, (640,))
    p_native = native.pack_ternary_native(w.cpu().numpy(), "cuda")
    p_numpy = pack_ternary(w.cpu().numpy(), "cuda")
    assert torch.equal(p_native.data, p_numpy.data) and p_native.nnz == p_numpy.nnz
    before = packed_spmm.launches
    y = packed_spmm(x, p_native, b, ALPHA, compute_dtype=cdt)
    assert torch.equal(y, packed_spmm(x, p_numpy, b, ALPHA, compute_dtype=cdt))
    assert packed_spmm.launches == before + 2


@pytest.mark.cuda
def test_measure_device_times_a_graph(cuda):
    from smmb_tpu_torch.bench.measure import measure, measure_device

    gen = rng.make_generator(42, "cuda")
    p = pack_ternary(rng.rand_ternary(gen, (1024, 8192)).cpu(), "cuda")
    x = rng.rand_dense(gen, (1, 1024))

    def head():
        return packed_spmm(x, p, compute_dtype=torch.bfloat16)

    m = measure_device(head, iters=64, reps=3)
    assert m.calls_per_batch == 64 and 0 < m.min_s <= m.mean_s
    # the host's launch cost is cancelled: under the host-timed call's time
    assert m.min_s < measure(head, reps=3).min_s


@pytest.fixture(scope="module")
def sharded_card():
    """One 2-rank gloo world on the card (tests/torch_parallel_ranks.py),
    its collectives staged through host memory: every sharded case below."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import torch_parallel_ranks

    from smmb_tpu_torch.parallel.mesh import run_world

    return run_world(torch_parallel_ranks.card_sharded, 2, backend="gloo", device="cuda")[0]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,tol", [("f32", 1e-4), ("bf16", 2.0 ** -7), ("int8", 1e-6)])
def test_sharded_b1_on_two_ranks(sharded_card, mode, tol):
    """Column shards gathered bitwise the unsharded B1 call; row and
    ring-overlap shards within the mode's tolerance of the same sharded
    calls on the plain bodies (bf16: the sum rounds once to bf16); 4 B1
    launches a rank (column 1, row 1, overlap 2)."""
    r = sharded_card[mode]
    assert r["column_bitwise"]
    assert r["row"] <= tol and r["overlap"] <= tol, r
    assert r["launches"] == 4
    assert sharded_card["staged"].get("all_reduce", 0) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode,tol", [("bcsr_f32", 1e-4), ("bcsr_bf16", 2.0 ** -7)])
def test_sharded_b2_on_two_ranks(sharded_card, mode, tol):
    """Block-column shards of B2 (padded block lists) against their plain
    bodies, one B2 launch a rank."""
    r = sharded_card[mode]
    assert r["err"] <= tol and r["launches"] == 1, r


@pytest.fixture(scope="module")
def a4b_card():
    """One 2-rank gloo world on the card: the expert-parallel and ring cases."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import torch_parallel_ranks

    from smmb_tpu_torch.parallel.mesh import run_world

    return run_world(torch_parallel_ranks.card_a4b, 2, backend="gloo", device="cuda")[0]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ep_top1_f32", "ep_top1_bf16", "ep_top2_f32", "ep_top2_bf16"])
def test_ep_moe_on_two_ranks(a4b_card, case):
    """``moe_forward_ep`` bitwise ``moe_forward`` on the same tokens; B1 on
    the rank's 4 experts only: 8 launches a rank, against 16 on one."""
    assert a4b_card[case] == {"bitwise": True, "launches": 8}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ring_causal", "ring_non_causal", "ring_gqa_window"])
def test_ring_attention_on_two_ranks(a4b_card, case):
    """The ring (T = 512, hd 128) within JAX's 2e-5 of the attention math."""
    assert a4b_card[case] <= 2e-5 and a4b_card["ring_worst"] <= 2e-5, a4b_card
