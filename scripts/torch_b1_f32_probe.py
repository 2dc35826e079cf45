"""Where B1's f32 body spends its time on the card: the body as built, the
same source with one part taken out (each a string replacement, timed only:
those outputs are wrong), a pure-FFMA kernel of the same shape as the
ceiling, and the SM clock and power while the headline call runs.

    python scripts/torch_b1_f32_probe.py [--out PATH]

Needs a CUDA card and nvcc; imports neither JAX nor smmb_tpu. Prints one JSON
line a measurement and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from smmb_tpu_torch.bench.trace import kernel_breakdown  # noqa: E402
from smmb_tpu_torch.formats.packed import pack_ternary_device, unpack_ternary  # noqa: E402
from smmb_tpu_torch.kernels import _build  # noqa: E402
from smmb_tpu_torch.kernels.packed_spmm import packed_spmm_f32_chain  # noqa: E402
from smmb_tpu_torch.utils import rng  # noqa: E402

# one part of the body taken out at a time (timing only; the tiles timed
# here take 16-byte pieces, so the copy warps run)
VARIANTS = {
    "no_fragment_loads": [
        ("    const unsigned* row = wd + (j0 + jj) * (T::TBN / 2) + col0 / 2;",
         "    const unsigned* row = wd + jj * (T::TBN / 2) + col0 / 2;"),
        ("    a[r] = *reinterpret_cast<const float4*>(xs + (row0 + 4 * r) * F32_XROW + j0);",
         "    a[r] = *reinterpret_cast<const float4*>(xs + (row0 + 4 * r) * F32_XROW);")],
    "no_decode": [("        decode_f32_stage<T, P>(wd(s), ws(s), idx);",
                   "        if (s < 0) decode_f32_stage<T, P>(wd(s), ws(s), idx);")],
    "no_staging": [("        if (s + 1 < nst)\n          load_f32_stage<T, true, P>",
                    "        if (s + 1 < 0)\n          load_f32_stage<T, true, P>")],
    "no_handoff": [("        named_barrier(1, T::THREADS + P);\n", ""),
                   ("      named_barrier(1, T::THREADS + P);\n", "")],
    "no_fma": [("      if (active) fma_f32_stage<T>(acc, xs(s), wd(s), row0, col0);\n    }\n  } else {",
                "      if (s < 0) fma_f32_stage<T>(acc, xs(s), wd(s), row0, col0);\n    }\n  } else {")],
}

FFMA_SRC = r"""
#include <cuda_runtime.h>
// 64 independent accumulators a thread, operands in registers: the FFMA
// issue rate of 128-thread blocks, one an SM, as B1's 64x128 f32 tile runs
__global__ void __launch_bounds__(128) ffma_kernel(float* out, float a0, float b0, int iters) {
  float acc[8][8], a[8], b[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) a[r] = a0 + r * 1e-7f + threadIdx.x * 1e-9f;
#pragma unroll
  for (int c = 0; c < 8; ++c) b[c] = b0 - c * 1e-7f;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
#pragma unroll 1
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int s = 0; s < 8; ++s)
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  float t = 0.f;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) t += acc[r][c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
}
extern "C" int ffma_run(float* out, int blocks, int iters, void* stream) {
  ffma_kernel<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(out, 1.f, .5f, iters);
  return (int)cudaGetLastError();
}
"""
SHAPES = ((256, 4096, 4096, (64, 128)), (1, 1024, 8192, (16, 64)))


def _build_lib(src: str, name: str, tmp: Path) -> ctypes.CDLL:
    path, lib = tmp / f"{name}.cu", tmp / f"lib{name}.so"
    path.write_text(src)
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(path)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def _entry(lib):
    fn = lib.smmb_packed_spmm
    fn.argtypes, fn.restype = _build.packed_spmm_lib().smmb_packed_spmm.argtypes, ctypes.c_int
    return fn


def _clock(call, seconds=2.0) -> dict:
    """SM clock and power by nvidia-smi while ``call`` runs back to back."""
    mon = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    t0 = time.time()
    while time.time() - t0 < seconds:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    mon.terminate()
    rows = [[float(v) for v in line.split(",")] for line in mon.communicate()[0].splitlines()
            if line.strip()][2:]
    return {"sm_mhz": [min(r[0] for r in rows), max(r[0] for r in rows)],
            "power_w": [min(r[1] for r in rows), max(r[1] for r in rows)]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    stream = torch.cuda.current_stream().cuda_stream
    base = (_build.CSRC / "packed_spmm.cu").read_text()
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        libs = {"as_built": _build.packed_spmm_lib().smmb_packed_spmm}
        for name, reps in VARIANTS.items():
            src = base
            for old, new in reps:
                if src.count(old) != 1:
                    raise SystemExit(f"variant {name}: the body changed, {old!r} is not in it once")
                src = src.replace(old, new)
            libs[name] = _entry(_build_lib(src, name, tmp))
        gen = rng.make_generator(5, dev)
        for m, k, n, tile in SHAPES:
            p = pack_ternary_device(rng.rand_ternary(gen, (k, n), non_zero=10 if k == 4096 else 2))
            x, b = rng.rand_dense(gen, (m, k)), rng.rand_dense(gen, (n,))
            out = torch.empty(m, n, device=dev)

            def call(fn, x=x, p=p, b=b, out=out, m=m, k=k, n=n, tile=tile):
                rc = fn(x.data_ptr(), p.data.data_ptr(), b.data_ptr(), None, out.data_ptr(),
                        m, k, n, p.data.shape[0], 0, 0, *tile, 1, 1, 0.2, stream)
                if rc:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")

            call(libs["as_built"])
            torch.cuda.synchronize()
            if not torch.equal(out, packed_spmm_f32_chain(x, p, b, 0.2)):
                raise SystemExit(f"the body as built differs from its chain at {m}x{k}x{n}")
            row = {"shape": [m, k, n], "tile": list(tile), "device_us": {
                name: sum(r["us"] for r in kernel_breakdown(lambda fn=fn: call(fn), n_calls=20))
                for name, fn in libs.items()}}
            if m == 256:
                row["clock"] = _clock(lambda: call(libs["as_built"]))
            lines.append(row)
        ffma = _build_lib(FFMA_SRC, "ffma", tmp).ffma_run
        ffma.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        buf = torch.empty(132 * 128, device=dev)
        iters = 2000
        us = sum(r["us"] for r in kernel_breakdown(
            lambda: ffma(buf.data_ptr(), 132, iters, stream), n_calls=10))
        fmas = 132 * 128 * iters * 8 * 64
        lines.append({"pure_ffma": {"blocks": 132, "threads": 128, "accumulators": 64, "us": us,
                                    "fma_per_us_per_sm": fmas / us / 132}})
    for row in lines:
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in lines) + "\n")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
