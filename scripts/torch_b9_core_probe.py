"""B9's CUDA-core body on the card: the registers and spills of every
instantiation, every row tile the wrapper can pick bitwise the default and
(with ``--parent DIR``, an earlier tree of the port) bitwise that tree's
body, and the device time of each row tile beside the earlier body's and
SDPA's in the same process; the HMMA count of each tree's SASS. With
``--variants``, where the time goes: the serial f32 body with one part
taken out at a time (string replacements, timed only: those outputs are
wrong) at T=512 and T=4096.

    python scripts/torch_b9_core_probe.py [--parent DIR] [--variants] [--out PATH]

Needs a CUDA card and nvcc; imports neither JAX nor smmb_tpu. Device times
by ``bench/trace.py::kernel_breakdown`` (torch.profiler), f32 matmuls with
TF32 off. Prints one JSON line a shape and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from smmb_tpu_torch.bench.trace import kernel_breakdown  # noqa: E402
from smmb_tpu_torch.kernels import _build  # noqa: E402
from smmb_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from smmb_tpu_torch.utils import rng  # noqa: E402

F32, BF16 = torch.float32, torch.bfloat16
# (label, dtype, B, H, KVH, T, hd, causal, window, pipeline_p)
SHAPES = [
    ("lm prefill", F32, 1, 8, 8, 32, 128, True, None, False),
    ("T=512", F32, 1, 8, 8, 512, 128, True, None, False),
    ("T=4096", F32, 1, 8, 8, 4096, 128, True, None, False),
    ("T=4096 non-causal", F32, 1, 8, 8, 4096, 128, False, None, False),
    ("GQA 8/2 window 100 T=200", F32, 1, 8, 2, 200, 128, True, 100, False),
    ("hd 64", F32, 1, 8, 8, 512, 64, True, None, False),
    ("hd 200", F32, 1, 4, 4, 512, 200, True, None, False),
    ("hd 256 bf16", BF16, 1, 4, 4, 512, 256, True, None, False),
    ("hd 512 bf16", BF16, 1, 2, 2, 256, 512, True, None, False),
    ("hd 902", F32, 1, 2, 2, 100, 902, True, None, False),
    ("B9p T=512", F32, 1, 8, 8, 512, 128, True, None, True),
    ("B9p hd 200", F32, 1, 4, 4, 512, 200, True, None, True),
    ("B9p hd 256 bf16", BF16, 1, 4, 4, 512, 256, True, None, True),
]
PARENT_ARGS = [  # the C entry before the row tile argument
    ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)] * 4 + [ctypes.c_int] * 9 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def registers(log: str) -> list:
    """(dtype, BT, SR, DV, PIPE, registers, spill stores, spill loads) of
    each CUDA-core instantiation in ``nvcc -Xptxas -v`` output."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = re.search(r"flash_prefill_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELi(\d+)"
                             r"ELb([01])E", line)
        elif "spill stores" in line:
            spills = [int(x) for x in re.findall(r"(\d+) bytes spill", line)]
        elif "Used" in line and "registers" in line and name:
            out.append(["f32" if name[1] == "f" else "bf16", *map(int, name.groups()[1:]),
                        int(re.search(r"Used (\d+) registers", line)[1]), *spills])
            name = None
    return out


def parent_entry(tree: Path, work: Path):
    """``tree``'s flash_attention.cu built with this checkout's flags, its
    two C entries with their argument types."""
    csrc = tree / "smmb_tpu_torch" / "kernels" / "csrc"
    lib = work / "libparent_flash.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib),
                    str(csrc / "flash_attention.cu")], check=True, capture_output=True,
                   timeout=900)
    dll = ctypes.CDLL(str(lib))
    for name in ("smmb_flash_attention", "smmb_flash_attention_pipe"):
        getattr(dll, name).argtypes = PARENT_ARGS
        getattr(dll, name).restype = ctypes.c_int
    return dll


def parent_call(dll, q, k, v, causal, window, pipe):
    """The earlier body on the wrapper's operands: its kv tile, body 0."""
    b, h, t, hd = q.shape
    kvh, s_len = k.shape[1], k.shape[2]
    out = torch.empty((b, t, h, hd), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    strides = [(ctypes.c_longlong * 3)(*x.stride()[:3]) for x in (q, k, v, out)]
    qscale = torch.tensor(1.0 / math.sqrt(hd) * LOG2E, dtype=q.dtype).item()
    fn = dll.smmb_flash_attention_pipe if pipe else dll.smmb_flash_attention

    def call():
        rc = fn(q.data_ptr(), strides[0], k.data_ptr(), strides[1], v.data_ptr(), strides[2],
                out.data_ptr(), strides[3], int(q.dtype == BF16), b, t, s_len, h, kvh, hd,
                int(causal), window or 0, qscale, 0, fa.kernel_tile(hd, pipe),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent launch: CUDA error {rc}")
        return out

    return call


LOG2E = 1.4426950408889634
# one part of the serial f32 body taken out at a time (timing only)
VARIANTS = {
    "no_staging": [("      cp_async16(to, ok ? from : src, ok);",
                    "      if (c0 < 0) cp_async16(to, ok ? from : src, ok);")],
    "no_scores": [("    for (int c = 0; c < nv; ++c) {", "    for (int c = 0; c < nv && c0 < 0; ++c) {"),
                  ("    float sc[SR][SC];", "    const int c0 = tile * BT;\n    float sc[SR][SC];"),
                  ("    const int c0 = tile * BT;\n    float p[SC][SR];", "    float p[SC][SR];")],
    "no_exp": [("      rsc[i] = walk ? exp2f(__fsub_rn(m[i], m_new)) : 1.f;",
                "      rsc[i] = walk ? __fsub_rn(m[i], m_new) : 1.f;"),
               ("pr[jj] = walk ? exp2f(__fsub_rn(sc[i][jj], m_new)) : 0.f;",
                "pr[jj] = walk ? __fsub_rn(sc[i][jj], m_new) : 0.f;")],
    "no_pv": [("      if (busy) pv_add();", "      if (busy && tile < 0) pv_add();")],
}
STUBS = r"""
#include <cuda_runtime.h>
namespace smmb_fa {
struct Call;
int core_f32_pipe(int, int, const Call&) { return cudaErrorInvalidValue; }
int core_bf16(int, int, const Call&) { return cudaErrorInvalidValue; }
int core_bf16_pipe(int, int, const Call&) { return cudaErrorInvalidValue; }
}
"""


def hmma(lib: Path) -> int:
    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    return subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=600).stdout.count("HMMA")


def variant_libs(work: Path) -> dict:
    """Each variant of this checkout's source built as the entries' part and
    the f32 serial part (the other parts stubbed), all at once."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xptxas", "-v")]
    procs, out = [], {}
    (work / "stubs.cu").write_text(STUBS)
    for name, edits in VARIANTS.items():
        text = src
        for a, b in edits:
            if a not in text:
                raise RuntimeError(f"variant {name}: {a!r} not in the source")
            text = text.replace(a, b, 1)
        path = work / f"{name}.cu"
        path.write_text(text)
        objs = [work / f"{name}{i}.o" for i in (0, 1)]
        for i, o in zip((0, 1), objs):
            procs.append(subprocess.Popen([_build.nvcc_path(), *flags, "-I", str(_build.CSRC),
                                           f"-DSMMB_PART={i}", "-c", "-o", str(o), str(path)]))
        out[name] = objs
    procs.append(subprocess.Popen([_build.nvcc_path(), *flags, "-c", "-o",
                                   str(work / "stubs.o"), str(work / "stubs.cu")]))
    if any(p.wait(timeout=900) for p in procs):
        raise RuntimeError("a variant failed to build")
    libs = {}
    for name, objs in out.items():
        lib = work / f"lib{name}.so"
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), *map(str, objs),
                        str(work / "stubs.o")], check=True, capture_output=True, timeout=300)
        dll = ctypes.CDLL(str(lib))
        dll.smmb_flash_attention.argtypes = _build.flash_attention_lib().smmb_flash_attention.argtypes
        dll.smmb_flash_attention.restype = ctypes.c_int
        libs[name] = dll
    return libs


def variant_call(dll, q, k, v, rows):
    """A variant's serial entry on the wrapper's operands (causal, its row
    tile and kv tile)."""
    b, h, t, hd = q.shape
    out = torch.empty((b, t, h, hd), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    strides = [(ctypes.c_longlong * 3)(*x.stride()[:3]) for x in (q, k, v, out)]
    qscale = torch.tensor(1.0 / math.sqrt(hd) * LOG2E, dtype=q.dtype).item()

    def call():
        rc = dll.smmb_flash_attention(
            q.data_ptr(), strides[0], k.data_ptr(), strides[1], v.data_ptr(), strides[2],
            out.data_ptr(), strides[3], 0, b, t, k.shape[2], h, k.shape[1], hd, 1, 0, qscale, 0,
            fa.kernel_tile(hd), rows, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"variant launch: CUDA error {rc}")

    return call


def device_us(fn, n):
    return sum(r["us"] for r in kernel_breakdown(fn, n_calls=n))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="an earlier tree of the port")
    ap.add_argument("--variants", action="store_true",
                    help="also time the serial f32 body with one part taken out at a time")
    ap.add_argument("--out", type=Path, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    lines = []

    def emit(row):
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)

    t = time.time()
    logs = _build.build_all(("flash_attention.cu",))
    emit({"build_s": time.time() - t,
          "registers": registers(logs.get("flash_attention.cu", ""))})
    with tempfile.TemporaryDirectory() as work:
        dll = parent_entry(args.parent, Path(work)) if args.parent else None
        emit({"hmma": hmma(_build.library_path("flash_attention.cu")),
              "parent_hmma": hmma(Path(work) / "libparent_flash.so") if dll else None})
        if args.variants:
            libs = variant_libs(Path(work))
            gen = rng.make_generator(5, torch.device("cuda"))
            for t_len in (512, 4096):
                q = (rng.rand_dense(gen, (1, t_len, 8, 128)) * 4.0).permute(0, 2, 1, 3)
                k, v = (rng.rand_dense(gen, (1, 8, t_len, 128)) for _ in range(2))
                rows = fa.row_tile(F32, 128, 1, 8, 8, t_len)
                n = 10 if t_len == 4096 else 30
                us = {"as_built": device_us(lambda: fa.flash_attention(q, k, v), n)}
                for name, lib in libs.items():
                    us[name] = device_us(variant_call(lib, q, k, v, rows), n)
                us["as_built_again"] = device_us(lambda: fa.flash_attention(q, k, v), n)
                emit({"variants_us": us, "T": t_len, "row_tile": rows, "dtype": "f32",
                      "B": 1, "H": 8, "hd": 128, "causal": True})
        gen = rng.make_generator(23, torch.device("cuda"))
        for label, dt, b, h, kvh, t_len, hd, causal, window, pipe in SHAPES:
            q = (rng.rand_dense(gen, (b, t_len, h, hd)) * 4.0).to(dt).permute(0, 2, 1, 3)
            k = rng.rand_dense(gen, (b, kvh, t_len, hd), dtype=dt)
            v = rng.rand_dense(gen, (b, kvh, t_len, hd), dtype=dt)
            kw = dict(causal=causal, window=window, pipeline_p=pipe)
            n = 10 if t_len * hd > 512 * 256 else 30
            default = fa.row_tile(dt, hd, b, h, kvh, t_len, pipe)
            y = fa.flash_attention(q, k, v, **kw)
            row = {"shape": label, "dtype": str(dt), "B": b, "H": h, "KVH": kvh, "T": t_len,
                   "hd": hd, "causal": causal, "window": window, "pipeline_p": pipe,
                   "tile": fa.kernel_tile(hd, pipe), "row_tile": default, "by_rows_us": {},
                   "rows_bitwise": True}
            for rows in fa.core_rows(dt, hd, pipe):
                yr = fa.flash_attention(q, k, v, _rows=rows, **kw)
                torch.cuda.synchronize()
                row["rows_bitwise"] &= torch.equal(yr, y)
                row["by_rows_us"][rows] = device_us(
                    lambda r=rows: fa.flash_attention(q, k, v, _rows=r, **kw), n)
            if dll is not None:
                call = parent_call(dll, q, k, v, causal, window, pipe)
                row["parent_bitwise"] = torch.equal(call(), y)
                row["parent_us"] = device_us(call, n)
            if window is None and not pipe:
                gqa = {"enable_gqa": True} if kvh < h else {}
                row["sdpa_us"] = device_us(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, **gqa), n)
            ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                           pipeline_p=pipe, block_kv=fa.kernel_tile(hd, pipe))
            row["max_abs_err"] = float((y.float() - ref.float()).abs().max())
            row["max_abs_ref"] = float(ref.float().abs().max())
            emit(row)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join([card, *lines]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
