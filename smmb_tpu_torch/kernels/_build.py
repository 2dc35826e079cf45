"""Build the port's CUDA kernels at first use and load them through ctypes.

Each source under ``csrc/`` becomes its own shared library with a plain C
interface, compiled by ``nvcc`` for Hopper (``sm_90a``) into ``_build/``
beside the package (listed in ``.gitignore``). The library name carries a
hash of the source and the flags, so an edited source is rebuilt and a
stale library is never loaded. Builds of several sources run in parallel.
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
SOURCES = ("packed_spmm.cu",)


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


@functools.cache
def packed_spmm_lib() -> ctypes.CDLL:
    """``packed_spmm.cu``, built first if missing, with its C entry's
    argument types declared."""
    build_all(("packed_spmm.cu",))
    lib = ctypes.CDLL(str(library_path("packed_spmm.cu")))
    fn = lib.smmb_packed_spmm
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [
        ptr, ptr, ptr, ptr, ptr,  # x, w, bias, scale, out
        i32, i32, i32, i32,  # m, k, n, kp
        i32, i32, i32, ctypes.c_float,  # x_mode, out_bf16, has_alpha, alpha
        ptr,  # stream
    ]
    fn.restype = i32
    return lib
