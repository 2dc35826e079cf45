"""Plain PyTorch reference of the packed ternary MLP, in float32 with TF32
off: each layer ``Y = PReLU(X·W + B)``, W the exact ternary draw (the
serving format holds it unscaled), X the served input upcast. It imports
nothing of the port and draws the weights again from the run's seed."""

from __future__ import annotations

import torch

from perfbench.inputs import ternary_mlp as inputs
from perfbench.reference.ternary_lm import f32_mode


@torch.no_grad()
def outputs(cfg: dict, seed: int, x: torch.Tensor, dev) -> torch.Tensor:
    """(…, rows, d0) served inputs → (…, rows, dL) f32 outputs."""
    f32_mode()
    y = x.to(device=dev, dtype=torch.float32)
    for i in range(len(cfg["layer_dims"]) - 1):
        w, b = inputs.layer(cfg, seed, i, dev)
        if not bool(((w == 0) | (w.abs() == 1)).all()):
            raise ValueError(f"layer {i}'s weight is not ternary")
        y = y @ w + b
        y = torch.where(y > 0, y, cfg["alpha"] * y)
    return y
