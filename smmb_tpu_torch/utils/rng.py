"""Seeded generators with the reference's distributions
(counterpart of smmb_tpu/utils/rng.py:34-50).

- ``rand_dense``: uniform floats in [-1, 1) (reference dense/utils.h:9-16);
- ``rand_ternary``: {-1, 0, +1} with P(+1) = P(-1) = 1 / (2 * non_zero),
  P(0) = 1 - 1/non_zero, so the expected density is 1/non_zero
  (reference dense/utils.h:36-68).

Numbers are drawn from an explicit ``torch.Generator`` on the target device.
They differ from ``jax.random``'s streams for the same seed, so parity
tests share numpy arrays between the packages, never seeds.
"""

from __future__ import annotations

import torch

from smmb_tpu_torch.utils.device import resolve_device


def make_generator(seed: int, device=None) -> torch.Generator:
    """A seeded generator on ``device`` (None = the CUDA card)."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


def _uniform(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device)


def rand_dense(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    """Uniform floats in [-1, 1)."""
    return (_uniform(gen, shape) * 2.0 - 1.0).to(dtype)


def rand_ternary(
    gen: torch.Generator, shape, non_zero: int = 2, dtype=torch.float32
) -> torch.Tensor:
    """Ternary matrix with P(±1) = 1/(2*non_zero) each, P(0) = 1 - 1/non_zero."""
    p_one = 1.0 / (2 * non_zero)
    p_zero = 1.0 - 1.0 / non_zero
    u = _uniform(gen, shape)
    out = torch.where(
        u < p_one,
        -1.0,
        torch.where(u < p_one + p_zero, 0.0, 1.0),
    )
    return out.to(dtype)


def rand_block_ternary(
    gen: torch.Generator, shape, block=128, keep: float = 0.3, non_zero: int = 10,
) -> torch.Tensor:
    """Block-sparse ternary matrix: each block (``block`` = r or (r, c)) is
    kept with probability ``keep`` and holds ``rand_ternary(non_zero)``
    entries; the others are zero (the block-sparse workload of
    smmb_tpu/bench/scaling.py:97-103 at 128×128, keep 0.3, 1/10)."""
    r, c = (block, block) if isinstance(block, int) else block
    k, n = shape
    w = rand_ternary(gen, shape, non_zero=non_zero)
    mask = (_uniform(gen, (k // r, n // c)) < keep).to(w.dtype)
    return w * mask.repeat_interleave(r, 0).repeat_interleave(c, 1)
