"""Weights and input batches of the packed ternary MLP, made on the device
from the run's seed, with the reference benchmark's distributions (the
port's ``init_mlp``): exact ternary weights, P(±1) = 1/(2·non_zero), served
unscaled; f32 biases and inputs uniform in [-1, 1), the inputs in the
served type. One generator a layer and one for the inputs, so the
reference can draw each again alone."""

from __future__ import annotations

import torch

from perfbench.inputs.ternary_lm import ternary
from perfbench.lib.seeds import derive


def _gen(dev, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(derive(seed, *tags))


def layer(cfg: dict, seed: int, i: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """Layer ``i``'s (K, N) ternary weight and (N,) bias, f32."""
    k, n = cfg["layer_dims"][i], cfg["layer_dims"][i + 1]
    g = _gen(dev, seed, "mlp-layer", i)
    w = ternary(torch.rand(k * n, generator=g, device=dev), cfg["non_zero"]).view(k, n)
    b = torch.rand(n, generator=g, device=dev) * 2.0 - 1.0
    return w, b


def input_pool(cfg: dict, seed: int, dev, count: int, rows: int, dtype) -> torch.Tensor:
    """(count, rows, d0) input batches in ``dtype``."""
    g = _gen(dev, seed, "mlp-inputs")
    x = torch.rand(count, rows, cfg["layer_dims"][0], generator=g, device=dev) * 2.0 - 1.0
    return x.to(dtype)
