"""The port's CUDA kernel on the card: each kernel against its plain PyTorch
version, through the wrappers and the MLP path. Every test needs a CUDA
device and skips without one (the kernel has no CPU mode).

This file imports neither JAX nor smmb_tpu, so it also runs where only the
port is installed: ``python -m pytest --noconftest -q tests/test_torch_cuda.py``
(tests/conftest.py imports JAX).

Tolerances, relative to max(1, max|Y|): f32 1e-4 (f32 sums in another
order); bf16 compute with f32 X and Y 1e-5 (the same bf16 values summed in
f32 in another order); int8 1e-6 (same codes, exact int32 sums, the same
separately rounded epilogue).
"""

import numpy as np
import pytest
import torch

from smmb_tpu_torch.formats.packed import pack_ternary
from smmb_tpu_torch.kernels.packed_spmm import packed_spmm, packed_spmm_plain
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
