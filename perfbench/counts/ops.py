"""Operations and bytes a kernel's work needs, from its shapes, and the
card's peaks they are held against.

The ternary product counts are copied from the port's ``bench/flops.py``
(the reference benchmark's analytic counts): ``2·M·nnz + M·N`` operations
for ``Y = X·W + B`` with a ternary W (one add or subtract a stored ±1 a row,
and the bias), and its bytes with X, the 2-bit W, Y and the bias each moved
once. Attention counts the two products, ``QKᵀ`` and ``PV``, over the keys
each query attends: the causal half (``T(T+1)/2`` pairs a head) in a
prefill, ``pos + 1`` keys a query in a decode step.

``Work`` adds up these counts; ``bound_s`` is the least time the card could
take for one item, the larger of its operations over the peak rate and its
bytes over the memory rate (per item, then summed, as each kernel call is
bounded on its own).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Peaks:
    name: str
    hbm_bytes_per_s: float
    bf16_flops: float
    int8_ops: float
    f32_flops: float


def peaks_for(device_name: str) -> Peaks:
    """The peaks of the card named ``device_name`` (``counts/peaks/*.json``);
    an unknown card raises rather than guess."""
    norm = device_name.lower()
    for path in sorted((HERE / "peaks").glob("*.json")):
        for card in json.loads(path.read_text())["cards"]:
            if all(s in norm for s in card["match_all"]) and any(
                    s in norm for s in card["match_any"]):
                return Peaks(card["name"], card["hbm_bytes_per_s"], card["bf16_flops"],
                             card["int8_ops"], card["f32_flops"])
    raise ValueError(f"no peaks for device {device_name!r}")


def kernel_group(group: str) -> list[str]:
    """The kernel-name strings of ``group`` from every ``counts/kernels/*.json``."""
    names = []
    for path in sorted((HERE / "kernels").glob("*.json")):
        names += json.loads(path.read_text()).get(group, [])
    return names


@dataclasses.dataclass(frozen=True)
class Item:
    """One kernel call's needed work: operations and bytes."""
    ops: float
    bytes: float

    def bound_s(self, peaks: Peaks) -> float:
        return max(self.ops / peaks.bf16_flops, self.bytes / peaks.hbm_bytes_per_s)


def ternary_flops(m: int, n: int, nnz: int) -> int:
    """``2·M·nnz + M·N``: the ternary product and the bias."""
    return 2 * m * nnz + m * n


def ternary_bytes(m: int, k: int, n: int, *, x_itemsize: int, y_itemsize: int,
                  bias_itemsize: int = 4) -> int:
    """X read, the 2-bit W read, Y written and the bias read, each once."""
    return m * k * x_itemsize + (k * n) // 4 + m * n * y_itemsize + n * bias_itemsize


def ternary_item(m: int, k: int, n: int, nnz: int, itemsize: int) -> Item:
    return Item(ternary_flops(m, n, nnz),
                ternary_bytes(m, k, n, x_itemsize=itemsize, y_itemsize=itemsize))


def causal_attention_flops(b: int, h: int, hd: int, t: int) -> int:
    """``QKᵀ`` and ``PV`` over the causal half: ``4·B·H·hd·T(T+1)/2``."""
    return 4 * b * h * hd * (t * (t + 1) // 2)


def prefill_attention_item(b: int, h: int, kvh: int, hd: int, t: int, itemsize: int) -> Item:
    """A causal prefill's attention: Q, K, V read and O written once."""
    return Item(causal_attention_flops(b, h, hd, t),
                b * t * (2 * h + 2 * kvh) * hd * itemsize)


def decode_attention_flops(b: int, h: int, hd: int, keys: int) -> int:
    """One query a row over ``keys`` cached keys: ``4·B·H·hd·keys``."""
    return 4 * b * h * hd * keys
