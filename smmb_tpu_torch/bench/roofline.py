"""Per-card roofline model: peak device-memory bandwidth and compute rates
(counterpart of smmb_tpu/bench/roofline.py, for NVIDIA H100 cards).

Numbers are NVIDIA's data-sheet peaks (dense, no sparsity) at the card's
full power limit; a card set below it runs slower under load, so every
measurement states the card's power limit beside it. The spec is chosen by
``torch.cuda.get_device_name()``; an unknown card raises rather than guess.

f32 work whose operands are both f32 (attention) has no tensor-core path
(TF32 is excluded), so its ceiling is the f32 rate of the CUDA cores. f32
activations times a ternary operand do: W ∈ {-1, 0, +1} is exact in bf16
and an f32 X splits exactly into three bf16 pieces, so three bf16 passes
give the exact products (kernel B2's mma body), and its ceiling,
``"f32_ternary"``, is the bf16 rate over three.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_gbps: float  # device-memory bandwidth, GB/s
    bf16_tflops: float  # dense tensor-core bf16, TFLOP/s
    int8_tops: float  # dense tensor-core int8, TOP/s
    fp32_tflops: float  # f32 on CUDA cores (no tensor cores), TFLOP/s

    def peak_ops(self, dtype: str) -> float:
        """Peak operations/s for ``dtype`` in {"bf16", "int8", "f32",
        "f32_ternary"}. ``"f32_ternary"`` is f32 X times a ternary W: exact
        on the tensor cores as three bf16 passes (x = hi + mid + lo, each a
        bf16, W ±1/0), so a third of the bf16 rate, where ``"f32"`` (both
        operands f32, no TF32) is the CUDA cores' rate."""
        tera = {"bf16": self.bf16_tflops, "int8": self.int8_tops,
                "f32": self.fp32_tflops, "f32_ternary": self.bf16_tflops / 3}[dtype]
        return tera * 1e12


_SPECS = {
    "sxm": ChipSpec("NVIDIA H100 SXM", 3350.0, 989.0, 1979.0, 67.0),
    "pcie": ChipSpec("NVIDIA H100 PCIe", 2000.0, 756.0, 1513.0, 51.0),
}


def chip_spec(device_name: str | None = None) -> ChipSpec:
    """Spec of the named card (default: CUDA device 0)."""
    name = device_name if device_name is not None else torch.cuda.get_device_name(0)
    norm = name.lower()
    if "h100" in norm:
        if "pcie" in norm:
            return _SPECS["pcie"]
        if "sxm" in norm or "hbm3" in norm:
            return _SPECS["sxm"]
    raise ValueError(f"no roofline spec for device {name!r}")


def roofline_bound(
    ops: float, bytes_moved: float, spec: ChipSpec, dtype: str = "bf16"
) -> tuple[float, str]:
    """Least seconds the card could take and what bounds it: the larger of
    ``ops`` at the peak rate of ``dtype`` and ``bytes_moved`` at the memory
    rate. Returns (seconds, "operations" or "bytes")."""
    t_ops = ops / spec.peak_ops(dtype)
    t_bytes = bytes_moved / (spec.hbm_gbps * 1e9)
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")
