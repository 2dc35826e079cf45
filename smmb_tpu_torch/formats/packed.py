"""TernaryPacked — the 2-bit dense execution format
(counterpart of smmb_tpu/formats/packed.py).

The bytes are identical to the JAX package's, so a plane packed by either
package serves in the other. Layout — group-strided so the decode is
gather-free:

    data : int8[K_pad // 4, N],  K_pad = round_up(K, GROUP_ROWS)

Logical rows are packed in groups of ``GROUP_ROWS = 512``; each group owns
``SUB = 128`` packed rows. Packed row ``p`` of group ``g`` (``data[g*128 +
p]``) stores four logical rows in its four 2-bit fields:

    bits 0-1 → row  g*512 +   0 + p
    bits 2-3 → row  g*512 + 128 + p
    bits 4-5 → row  g*512 + 256 + p
    bits 6-7 → row  g*512 + 384 + p

The planes are strided by 128 rows, not interleaved: a byte does NOT hold
four consecutive rows. Codes are 2-bit two's complement (``0b00=0``,
``0b01=+1``, ``0b11=-1``); field ``i`` of an int32-widened word ``w``
decodes as ``(w << (30 - 2i)) >> 30``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from smmb_tpu_torch.utils.device import resolve_device
from smmb_tpu_torch.utils.shapes import round_up

VALUES_PER_BYTE = 4
SUB = 128  # packed rows per group
GROUP_ROWS = VALUES_PER_BYTE * SUB  # 512 logical rows per group


@dataclasses.dataclass(frozen=True)
class TernaryPacked:
    """2-bit packed ternary matrix; logical shape (rows, cols)."""

    data: torch.Tensor  # int8[K_pad // 4, cols]
    rows: int  # logical K (un-padded)
    cols: int  # N
    nnz: int  # number of ±1 entries (-1 when unknown)

    @property
    def shape(self):
        return (self.rows, self.cols)

    @property
    def packed_rows(self) -> int:
        return self.data.shape[0]

    @property
    def padded_rows(self) -> int:
        return self.packed_rows * VALUES_PER_BYTE

    @property
    def density(self) -> float:
        return self.nnz / float(self.rows * self.cols)

    def weight_bytes(self) -> int:
        """Device-memory bytes of weight traffic per full read of the matrix."""
        return int(self.data.shape[0]) * int(self.data.shape[1])

    def to(self, device) -> TernaryPacked:
        return dataclasses.replace(self, data=self.data.to(device))


def _pack_groups(t):
    """(K_pad, N) int8 ternary → (K_pad//4, N) packed words (torch or numpy)."""
    is_torch = isinstance(t, torch.Tensor)
    kpad, cols = t.shape
    g = kpad // GROUP_ROWS
    t4 = t.reshape(g, VALUES_PER_BYTE, SUB, cols)
    codes = (t4 & 3).to(torch.uint8) if is_torch else (t4 & 3).astype(np.uint8)
    packed = (
        codes[:, 0]
        | (codes[:, 1] << 2)
        | (codes[:, 2] << 4)
        | (codes[:, 3] << 6)
    )
    packed = packed.reshape(g * SUB, cols)
    # reinterpret the bits: a value cast would depend on the conversion rule
    return packed.view(torch.int8) if is_torch else packed.view(np.int8)


def pack_ternary(w, device=None) -> TernaryPacked:
    """Dense (K × N) ternary float matrix → 2-bit packed (host-side).

    Entries exactly equal to ±1.0 are encoded; everything else is 0, like
    the reference's format constructors. ``w`` is a numpy array or a tensor;
    the packed words land on ``device`` (None = the CUDA card).
    """
    dev = resolve_device(device)
    if isinstance(w, torch.Tensor):
        w = w.detach().to("cpu", torch.float32).numpy()
    w = np.asarray(w, dtype=np.float32)
    rows, cols = w.shape
    t = np.zeros(w.shape, dtype=np.int8)
    t[w == 1.0] = 1
    t[w == -1.0] = -1
    nnz = int(np.count_nonzero(t))
    pad_rows = round_up(max(rows, 1), GROUP_ROWS)
    if pad_rows != rows:
        t = np.concatenate([t, np.zeros((pad_rows - rows, cols), np.int8)])
    data = torch.from_numpy(np.ascontiguousarray(_pack_groups(t))).to(dev)
    return TernaryPacked(data=data, rows=rows, cols=cols, nnz=nnz)


def pack_ternary_device(t: torch.Tensor, nnz: int = -1) -> TernaryPacked:
    """Packer for already-ternary input, on ``t``'s own device.

    Same contract as ``pack_ternary``: anything not exactly ±1 encodes as 0
    (a bare cast would mis-encode e.g. 2.0 → code 0b10). ``nnz`` is
    metadata; -1 when unknown.
    """
    rows, cols = t.shape
    ti = torch.where(
        t.abs() == 1,
        torch.sign(t).to(torch.int8),
        torch.zeros((), dtype=torch.int8, device=t.device),
    )
    pad_rows = round_up(max(rows, 1), GROUP_ROWS)
    if pad_rows != rows:
        ti = torch.cat(
            [ti, torch.zeros((pad_rows - rows, cols), dtype=torch.int8, device=t.device)]
        )
    return TernaryPacked(
        data=_pack_groups(ti).contiguous(), rows=rows, cols=cols, nnz=nnz
    )


def concat_packed_cols(mats: list[TernaryPacked]) -> TernaryPacked:
    """Column-concatenate packed matrices sharing a row count.

    The packing is column-independent (each byte holds 4 row-values of ONE
    column), so fusing [Wq | Wk | Wv] is a plain axis-1 concat of the words.
    """
    rows = {m.rows for m in mats}
    if len(rows) != 1:
        raise ValueError(f"row mismatch across packed matrices: {rows}")
    nnz = -1 if any(m.nnz < 0 for m in mats) else sum(m.nnz for m in mats)
    return TernaryPacked(
        data=torch.cat([m.data for m in mats], dim=1),
        rows=mats[0].rows,
        cols=sum(m.cols for m in mats),
        nnz=nnz,
    )


def decode_words(words: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Decode packed words covering whole groups → dense logical rows.

    ``words`` is int8[(g*SUB), N] (a slice of ``data`` aligned to group
    boundaries); returns dense[(g*GROUP_ROWS), N] in ``dtype``. This is the
    decode the CUDA kernel performs per K chunk, kept here so the plain
    version and the kernel share one definition of the layout.
    """
    prows, cols = words.shape
    g = prows // SUB
    w3 = words.reshape(g, SUB, cols).to(torch.int32)
    planes = [
        ((w3 << (30 - 2 * i)) >> 30).to(dtype) for i in range(VALUES_PER_BYTE)
    ]
    out = torch.stack(planes, dim=1)  # (g, 4, SUB, cols)
    return out.reshape(g * GROUP_ROWS, cols)


def unpack_ternary(p: TernaryPacked, dtype=torch.float32) -> torch.Tensor:
    """Packed → dense (rows × cols); also the round-trip test hook."""
    return decode_words(p.data, dtype)[: p.rows]
