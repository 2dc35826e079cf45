"""ctypes bindings for the native C++ format constructors and the corpus
loader's shuffle and gather (counterpart of smmb_tpu/runtime/native.py).

``csrc/converters.cpp`` is the port's own copy of the JAX package's source
(the same code; a CPU test holds it so). It is compiled at first use by
``g++ -O3 -march=native -fopenmp -shared -fPIC`` into ``_build/`` beside
the package (listed in ``.gitignore``), under a name that carries a hash of
the source and the flags, as ``kernels/_build.py`` names its libraries, and
bound through ctypes. Nothing is built at import time.

As in JAX, every constructor falls back to the port's numpy constructor
(``formats/*``) when no toolchain builds the library; ``native_available()``
says which one runs. Both give the same bytes. The formats land on
``device`` (None = the CUDA card), as the numpy constructors' do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from smmb_tpu_torch.formats import bcsr as bcsr_mod
from smmb_tpu_torch.formats import packed as packed_mod
from smmb_tpu_torch.formats import tcsc as tcsc_mod
from smmb_tpu_torch.utils.device import resolve_device

SRC = Path(__file__).resolve().parent / "csrc" / "converters.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False


def library_path() -> Path:
    """``_build/libsmmb_runtime_<hash of the source and flags>.so``."""
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libsmmb_runtime_{digest.hexdigest()[:16]}.so"


def _build() -> Path | None:
    """The library, compiled unless it exists; None when g++ fails. It is
    written to a temporary name and renamed into place, so a concurrent or
    interrupted build never leaves a partial library."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib)
    return lib


def _lib() -> ctypes.CDLL | None:
    """The bound library, built on the first call; None without a toolchain."""
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _TRIED = True
            so = _build()
            if so is not None:
                lib = ctypes.CDLL(str(so))
                _bind(lib)
                _LIB = lib
        return _LIB


def _bind(lib: ctypes.CDLL) -> None:
    """Declare the argtypes of the seven exported symbols."""
    i64, u64 = ctypes.c_int64, ctypes.c_uint64
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    i8p = ctypes.POINTER(ctypes.c_int8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.tcsc_count.argtypes = [f32p, i64, i64, i32p, i32p, i64p, i64p]
    lib.tcsc_fill.argtypes = [f32p, i64, i64, i32p, i32p, i32p, i32p]
    lib.pack_ternary.argtypes = [f32p, i64, i64, i64, i8p]
    lib.bcsr_count.argtypes = [f32p, i64, i64, i64, i64, i32p, u8p]
    lib.bcsr_count.restype = i64
    lib.bcsr_fill.argtypes = [f32p, i64, i64, i64, i64, i32p, u8p, i32p, f32p]
    lib.shuffle_offsets.argtypes = [i64, u64, i64p]
    lib.gather_windows.argtypes = [u32p, i64p, i64, i64, i32p]


def native_available() -> bool:
    return _lib() is not None


def ptr(a: np.ndarray, ctype):
    """``a``'s buffer as a ctypes pointer to ``ctype``."""
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def tcsc_from_dense_native(w, device=None) -> tcsc_mod.TCSC:
    """Native two-pass TCSC construction; the bytes of
    ``formats.tcsc.tcsc_from_dense``, which it falls back to."""
    lib = _lib()
    if lib is None:
        return tcsc_mod.tcsc_from_dense(w, device)
    dev = resolve_device(device)
    w = np.ascontiguousarray(tcsc_mod._dense_np(w))
    rows, cols = w.shape
    csp = np.zeros(cols + 1, np.int32)
    csn = np.zeros(cols + 1, np.int32)
    n_pos, n_neg = ctypes.c_int64(), ctypes.c_int64()
    f32, i32 = ctypes.c_float, ctypes.c_int32
    lib.tcsc_count(ptr(w, f32), rows, cols, ptr(csp, i32), ptr(csn, i32),
                   ctypes.byref(n_pos), ctypes.byref(n_neg))
    rip = np.empty(n_pos.value, np.int32)
    rin = np.empty(n_neg.value, np.int32)
    lib.tcsc_fill(ptr(w, f32), rows, cols, ptr(csp, i32), ptr(csn, i32), ptr(rip, i32),
                  ptr(rin, i32))
    put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return tcsc_mod.TCSC(
        col_start_pos=put(csp), col_start_neg=put(csn),
        row_index_pos=put(rip), row_index_neg=put(rin),
        rows=rows, cols=cols, n_pos=int(n_pos.value), n_neg=int(n_neg.value),
    )


def pack_ternary_native(w, device=None) -> packed_mod.TernaryPacked:
    """Native group-strided 2-bit packing; the bytes of
    ``formats.packed.pack_ternary``, which it falls back to."""
    lib = _lib()
    if lib is None:
        return packed_mod.pack_ternary(w, device)
    dev = resolve_device(device)
    w = np.ascontiguousarray(tcsc_mod._dense_np(w))
    rows, cols = w.shape
    g = packed_mod.GROUP_ROWS
    pad_rows = -(-max(rows, 1) // g) * g
    out = np.empty((pad_rows // 4, cols), np.int8)
    lib.pack_ternary(ptr(w, ctypes.c_float), rows, cols, pad_rows, ptr(out, ctypes.c_int8))
    nnz = int(np.count_nonzero((w == 1.0) | (w == -1.0)))
    return packed_mod.TernaryPacked(data=torch.from_numpy(out).to(dev), rows=rows,
                                    cols=cols, nnz=nnz)


def bcsr_from_dense_native(w, r: int, c: int, device=None) -> bcsr_mod.BCSR:
    """Native BCSR construction (an all-zero block row is safe); the bytes
    of ``formats.bcsr.bcsr_from_dense``, which it falls back to."""
    lib = _lib()
    if lib is None:
        return bcsr_mod.bcsr_from_dense(w, r, c, device)
    dev = resolve_device(device)
    w = np.ascontiguousarray(tcsc_mod._dense_np(w))
    rows, cols = w.shape
    if rows % r or cols % c:
        raise ValueError(f"shape {w.shape} not divisible by block ({r}, {c})")
    br, bc = rows // r, cols // c
    row_start = np.zeros(br + 1, np.int32)
    valid = np.zeros(br * bc, np.uint8)
    f32, i32 = ctypes.c_float, ctypes.c_int32
    k = int(lib.bcsr_count(ptr(w, f32), rows, cols, r, c, ptr(row_start, i32),
                           ptr(valid, ctypes.c_uint8)))
    col_idx = np.empty(k, np.int32)
    values = np.empty((k, r, c), np.float32)
    lib.bcsr_fill(ptr(w, f32), rows, cols, r, c, ptr(row_start, i32),
                  ptr(valid, ctypes.c_uint8), ptr(col_idx, i32), ptr(values, f32))
    put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return bcsr_mod.BCSR(
        b_row_start=put(row_start), b_col_idx=put(col_idx), b_values=put(values),
        rows=rows, cols=cols, r=r, c=c, br=br, bc=bc, k=k,
    )
