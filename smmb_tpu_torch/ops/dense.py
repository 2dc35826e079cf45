"""Dense oracle ops (counterpart of smmb_tpu/ops/dense.py:22-54).

Shapes follow the framework's convention throughout:
    X : (M, K) activations    W : (K, N) weights    B : (N,) bias
    Y : (M, N)

f32 products run in full f32: TF32 is switched off explicitly before each
product, the counterpart of JAX's ``Precision.HIGHEST`` (TF32 keeps about
three decimal digits and would break the 1e-4 parity contract).
"""

from __future__ import annotations

import torch


def full_f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in f32 with TF32 off (no-op setting on the CPU)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def prelu(y: torch.Tensor, alpha: float) -> torch.Tensor:
    """PReLU epilogue: ``y if y > 0 else alpha * y``."""
    return torch.where(y > 0, y, alpha * y)


def gemm(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None
) -> torch.Tensor:
    """Dense ``Y = X·W + B`` oracle in full f32."""
    y = full_f32_matmul(x, w)
    if b is not None:
        y = y + b
    return y


def gemm_prelu(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, alpha: float
) -> torch.Tensor:
    """Dense GEMM + PReLU oracle."""
    return prelu(gemm(x, w, b), alpha)
