"""Build the port's CUDA kernels at first use and load them through ctypes.

Each source under ``csrc/`` becomes its own shared library with a plain C
interface, compiled by ``nvcc`` for Hopper (``sm_90a``) into ``_build/``
beside the package (listed in ``.gitignore``). The library name carries a
hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source or header is rebuilt and a stale library is never loaded. Builds of several sources run in parallel.
Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = (
    "packed_spmm.cu", "fused_mlp.cu", "flash_decode.cu", "flash_attention.cu",
    "bcsr_spmm.cu",
)


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` or the default toolkit."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def library_path(source: str) -> Path:
    digest = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(source).stem}_{digest.hexdigest()[:16]}.so"


def build_all(sources=SOURCES) -> dict[str, str]:
    """Compile every source whose library is missing, all at once.

    Returns ``{source: compiler output}`` for the sources built now (ptxas
    register and shared-memory reports). Raises if any build fails. Each
    library is written to a temporary name and renamed into place, so a
    concurrent or interrupted build never leaves a partial library.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for src in sources:
        lib = library_path(src)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs[src] = (proc, tmp, lib)
    logs, failed = {}, []
    for src, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        logs[src] = out
        if proc.returncode != 0:
            failed.append(f"{src} (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def _load(source: str, entries: dict) -> ctypes.CDLL:
    """``source``'s library, built first if missing, with each C entry's
    argument types declared (``{name: argtypes}``; every entry returns int)."""
    build_all((source,))
    lib = ctypes.CDLL(str(library_path(source)))
    for name, argtypes in entries.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


@functools.cache
def packed_spmm_lib() -> ctypes.CDLL:
    """``packed_spmm.cu`` (B1)."""
    return _load("packed_spmm.cu", {"smmb_packed_spmm": [
        _P, _P, _P, _P, _P,  # x, w, bias, scale, out
        _I, _I, _I, _I,  # m, k, n, kp
        _I, _I, _I, _I, _I,  # x_mode, out_bf16, bm, bn, aligned
        _I, _F,  # has_alpha, alpha
        _P,  # stream
    ]})


@functools.cache
def bcsr_spmm_lib() -> ctypes.CDLL:
    """``bcsr_spmm.cu`` (B2)."""
    return _load("bcsr_spmm.cu", {"smmb_bcsr_spmm": [
        _P, _I, _P, _P, _P, _P, _P,  # x, x_bf16, values, blk_row, col_start, bias, out
        _I, _I, _I, _I, _I, _I, _I,  # m, k, n, r, c, bm, bn
        _I, _F,  # has_alpha, alpha
        _P,  # stream
    ]})


@functools.cache
def fused_mlp_lib() -> ctypes.CDLL:
    """``fused_mlp.cu`` (B3, B7, B6, B5)."""
    return _load("fused_mlp.cu", {
        "smmb_fused_norm_qkv": [
            _P, _I, _P, _P, _P, _P, _P,  # x, x_bf16, g, w, scale, bias, out
            _I, _I, _I, _F, _I,  # m, d, n, eps, cbf16
            _P,  # stream
        ],
        "smmb_fused_norm_qkv_quant": [
            _P, _I, _P, _P, _P, _P,  # x, x_bf16, g, w, scale, bias
            _P, _P, _P,  # q_out, codes, scales
            _I, _I, _I, _I, _I, _F, _I,  # m, d, n, kvh, hd, eps, cbf16
            _P,  # stream
        ],
        "smmb_fused_mlp": [
            _P, _I, _P, _P, _P,  # x, x_bf16, wu, s_up, b_up
            _P, _I, _P, _P,  # wd, ldd, s_down, b_down
            _P, _P, _P,  # up, ws, out
            _I, _I, _I, _I, _F, _I, _I,  # m, k, h, kout, alpha, cbf16, grid
            _P,  # stream
        ],
        "smmb_fused_block_tail": [
            _P, _I, _P, _I,  # att, att_bf16, x, x_bf16
            _P, _P, _P, _P,  # wo, s_wo, b_wo, g2
            _P, _P, _P, _P, _P, _P,  # wu, s_up, b_up, wd, s_down, b_down
            _P, _P, _P, _P,  # resid, up, ws, out
            _I, _I, _I, _I, _F, _F, _I, _I,  # m, a, dm, h, alpha, eps, cbf16, grid
            _P,  # stream
        ],
        "smmb_fused_items_capacity": [_I, _I, _I],  # tail, rows, kmax
    })


@functools.cache
def flash_decode_lib() -> ctypes.CDLL:
    """``flash_decode.cu`` (B4, and B8 in its int8 mode)."""
    shape = [_P, _P,  # ws, counters
             _I, _I, _I, _I, _I, _I, _I,  # b, nq, h, kvh, hd, s, pos
             _I, _I, _I, _F, _I,  # window, span, nspans, qscale, cbf16
             _P]  # stream
    return _load("flash_decode.cu", {
        "smmb_flash_decode": [
            _P, _I, _L, _L,  # q, q_bf16, q_sb, q_sc
            _P, _P, _I, _P,  # k, v, cache_bf16, out
            *shape,
        ],
        "smmb_flash_decode_quant": [
            _P, _I, _L, _L,  # q, q_bf16, q_sb, q_sc
            _P, _P, _P,  # kv, kv_scale, out
            *shape,
        ],
    })


@functools.cache
def flash_attention_lib() -> ctypes.CDLL:
    """``flash_attention.cu`` (B9, and B9p, its pipelined variant)."""
    strides = ctypes.POINTER(ctypes.c_longlong)
    args = [
        _P, strides, _P, strides, _P, strides, _P, strides,  # q, k, v, out
        _I, _I, _I, _I, _I, _I, _I,  # bf16, b, t, s, h, kvh, hd
        _I, _I, _F, _I, _I,  # causal, window, qscale, body, tile
        _P,  # stream
    ]
    return _load("flash_attention.cu", {"smmb_flash_attention": args,
                                        "smmb_flash_attention_pipe": args})
