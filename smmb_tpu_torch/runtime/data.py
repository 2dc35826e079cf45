"""Token-corpus loader for LM training (counterpart of
smmb_tpu/runtime/data.py).

A corpus is a flat little-endian uint32 token file, memory-mapped (the OS
pages it in; a corpus never has to fit in RAM). Each epoch yields shuffled
(batch, seq_len+1) windows: seq_len inputs and the shifted next-token
targets that ``models.lm.make_lm_train_step`` takes.

The epoch's permutation (a seeded Fisher-Yates shuffle) and the window
gather run in the native runtime library (``runtime/native.py``) when it
builds, else in numpy (``default_rng(mixed).permutation`` and a copy loop).
Each mode gives JAX's window order in the same mode, element for element;
the two modes give different orders (numpy's generator is another PRNG), as
in JAX.

Batches are int64 CPU tensors, torch's index dtype, which the caller moves
to its device. Token ids are bounded to int32, as in JAX: the native gather
writes int32 codes.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from smmb_tpu_torch.runtime import native


def write_token_file(path: str, tokens) -> None:
    """Write a 1-D int token sequence as the flat uint32 corpus format.

    Ids must lie in [0, 2**31): the gather reads them as int32."""
    arr = np.asarray(tokens)
    if arr.ndim != 1:
        raise ValueError(f"tokens must be 1-D, got shape {arr.shape}")
    if arr.size and (arr.min() < 0 or arr.max() > np.iinfo(np.int32).max):
        raise ValueError("token ids must be in [0, 2**31) (int32 batches)")
    arr.astype("<u4").tofile(path)


class TokenDataset:
    """Shuffled fixed-window batches over a memory-mapped token corpus.

    Windows are the ``n_windows`` non-overlapping (seq_len+1)-token spans
    (a trailing partial span is dropped). ``batches(epoch)`` yields
    (batch, seq_len+1) int64 tensors in an order fixed by (seed, epoch),
    dropping the last ragged batch so every batch is full.
    """

    def __init__(self, path: str, seq_len: int, batch: int, seed: int = 0):
        self.tokens = np.memmap(path, dtype="<u4", mode="r")
        self.seq_len = int(seq_len)
        self.batch = int(batch)
        self.seed = int(seed)
        self.window = self.seq_len + 1
        self.n_windows = len(self.tokens) // self.window
        if self.n_windows < self.batch:
            raise ValueError(
                f"corpus has {self.n_windows} windows of {self.window} "
                f"tokens — fewer than one batch of {self.batch}"
            )
        self.n_batches = self.n_windows // self.batch

    def _perm(self, epoch: int) -> np.ndarray:
        mixed = (self.seed << 32) ^ (epoch & 0xFFFFFFFF)
        lib = native._lib()
        if lib is None:
            return np.random.default_rng(mixed).permutation(self.n_windows).astype(np.int64)
        out = np.empty(self.n_windows, np.int64)
        lib.shuffle_offsets(self.n_windows, ctypes.c_uint64(mixed & (2**64 - 1)),
                            native.ptr(out, ctypes.c_int64))
        return out

    def _gather(self, starts: np.ndarray) -> torch.Tensor:
        lib = native._lib()
        out = np.empty((len(starts), self.window), np.int32)
        if lib is None:
            for i, s in enumerate(starts):
                out[i] = self.tokens[s:s + self.window]
        else:
            starts = np.ascontiguousarray(starts, np.int64)
            lib.gather_windows(native.ptr(self.tokens, ctypes.c_uint32),
                               native.ptr(starts, ctypes.c_int64), len(starts), self.window,
                               native.ptr(out, ctypes.c_int32))
        return torch.from_numpy(out).to(torch.int64)

    def batches(self, epoch: int = 0):
        """Yield ``n_batches`` tensors of shape (batch, seq_len+1)."""
        perm = self._perm(epoch)
        for b in range(self.n_batches):
            yield self._gather(perm[b * self.batch:(b + 1) * self.batch] * self.window)

    def __len__(self) -> int:
        return self.n_batches
