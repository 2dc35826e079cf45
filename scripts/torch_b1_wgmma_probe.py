"""Does one ``wgmma`` k16 step into an f32 accumulator give the bits of
``mma.sync m16n8k16`` on the same operands, in the same order?

B1's bf16 mode promises that every tile walks K in the same steps, so row r
of an M-row call is bitwise the M = 1 call whatever tile runs it. Its small
tiles run ``mma.sync m16n8k16`` with X as the A operand and decoded W as B.
A body on ``wgmma`` would swap the operands (``Yᵀ = Wᵀ·Xᵀ``: decoded W the
register-sourced A, X's rows read from shared memory as B) and keep the
promise only if each k16 step rounds as ``mma.sync``'s does. This probe
runs both instructions on the same bf16 X and ternary W, a chain of K/16
steps into one f32 register an output, and counts the outputs whose bits
differ:

- ``mma.sync``: one warp a block, X rows 0..7 in A (rows 8..15 zero), W's
  64 columns as eight n8 B fragments, exactly as B1's small tiles order it;
- ``wgmma.m64n8k16`` with A from registers: one warpgroup a block, Wᵀ's 64
  rows (W's columns) in A, X's 8 rows as B in shared memory (K-major, no
  swizzle), the accumulator zeroed and scaled in (``scale-d`` 1), as B1's
  chains start from zero.

X is drawn with exponents spread over 2^-24..2^24 (each sum then rounds at
many alignments) and as plain normals; W from {-1, 0, +1}.

    python scripts/torch_b1_wgmma_probe.py [--blocks 2048] [--k 2048]

Needs a CUDA card (sm_90a) and nvcc; imports neither JAX nor smmb_tpu.
Prints one JSON line a distribution and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from smmb_tpu_torch.kernels import _build  # noqa: E402

SOURCE = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned pair(const __nv_bfloat16* lo, const __nv_bfloat16* hi) {
  return static_cast<unsigned>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<unsigned>(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

// x [blocks][8][k], w [blocks][k][64], out [blocks][8][64]; one warp a block
__global__ void probe_mma(const __nv_bfloat16* x, const __nv_bfloat16* w, float* out, int k) {
  x += static_cast<size_t>(blockIdx.x) * 8 * k;
  w += static_cast<size_t>(blockIdx.x) * k * 64;
  out += static_cast<size_t>(blockIdx.x) * 8 * 64;
  const int g = threadIdx.x / 4, t = threadIdx.x % 4;
  float acc[8][4] = {};
  for (int k0 = 0; k0 < k; k0 += 16) {
    const __nv_bfloat16* xr = x + g * k + k0;
    const unsigned a0 = pair(xr + 2 * t, xr + 2 * t + 1), a2 = pair(xr + 2 * t + 8, xr + 2 * t + 9);
    for (int j = 0; j < 8; ++j) {
      const __nv_bfloat16* wc = w + 8 * j + g;
      const unsigned b0 = pair(wc + (k0 + 2 * t) * 64, wc + (k0 + 2 * t + 1) * 64);
      const unsigned b1 = pair(wc + (k0 + 2 * t + 8) * 64, wc + (k0 + 2 * t + 9) * 64);
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
          : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
    }
  }
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 2; ++e) out[g * 64 + 8 * j + 2 * t + e] = acc[j][e];
}

constexpr int KMAX = 2048;

// the same product as Y^T = W^T X^T on one warpgroup: A = W^T from registers,
// B = X^T from shared memory, K-major without swizzle: core matrix (step s,
// half h) of 8 rows x 16 bytes at (2s + h) * 128
__global__ void probe_wgmma(const __nv_bfloat16* x, const __nv_bfloat16* w, float* out, int k) {
  __shared__ __align__(128) __nv_bfloat16 xs[8 * KMAX];
  x += static_cast<size_t>(blockIdx.x) * 8 * k;
  w += static_cast<size_t>(blockIdx.x) * k * 64;
  out += static_cast<size_t>(blockIdx.x) * 8 * 64;
  for (int e = threadIdx.x; e < 8 * k; e += 128) {
    const int n = e / k, c = e % k;
    xs[((c / 8) * 8 + n) * 8 + c % 8] = x[e];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int wq = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(xs));
  float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
  for (int k0 = 0; k0 < k; k0 += 16) {
    const __nv_bfloat16* wc = w + 16 * wq + g;
    const unsigned a0 = pair(wc + (k0 + 2 * t) * 64, wc + (k0 + 2 * t + 1) * 64);
    const unsigned a1 = pair(wc + 8 + (k0 + 2 * t) * 64, wc + 8 + (k0 + 2 * t + 1) * 64);
    const unsigned a2 = pair(wc + (k0 + 2 * t + 8) * 64, wc + (k0 + 2 * t + 9) * 64);
    const unsigned a3 = pair(wc + 8 + (k0 + 2 * t + 8) * 64, wc + 8 + (k0 + 2 * t + 9) * 64);
    const uint64_t addr = base + (k0 / 8) * 128;
    const uint64_t desc = ((addr & 0x3FFFF) >> 4) | (uint64_t(128 >> 4) << 16) |
                          (uint64_t(128 >> 4) << 32);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(1));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  const int c = 16 * wq + g;
  out[(2 * t) * 64 + c] = d0;
  out[(2 * t + 1) * 64 + c] = d1;
  out[(2 * t) * 64 + c + 8] = d2;
  out[(2 * t + 1) * 64 + c + 8] = d3;
}

}  // namespace

extern "C" int run_probe(int which, const void* x, const void* w, void* out, int blocks, int k,
                         void* stream) {
  if (k % 16 || k > KMAX) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  if (which == 0)
    probe_mma<<<blocks, 32, 0, s>>>(xb, wb, static_cast<float*>(out), k);
  else
    probe_wgmma<<<blocks, 128, 0, s>>>(xb, wb, static_cast<float*>(out), k);
  return static_cast<int>(cudaGetLastError());
}
"""


def build() -> ctypes.CDLL:
    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "b1_wgmma_probe.cu", out / "libb1_wgmma_probe.so"
    src.write_text(SOURCE)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True)
    so = ctypes.CDLL(str(lib))
    so.run_probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    so.run_probe.restype = ctypes.c_int
    return so


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--blocks", type=int, default=2048)
    ap.add_argument("--k", type=int, default=2048)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card: the probe runs on the card", file=sys.stderr)
        return 2
    so = build()
    gen = torch.Generator(device="cuda").manual_seed(27)
    dev, bl, k = torch.device("cuda"), args.blocks, args.k
    w = torch.randint(-1, 2, (bl, k, 64), device=dev, generator=gen).to(torch.bfloat16)
    spread = torch.randint(-24, 25, (bl, 8, k), device=dev, generator=gen).float()
    draws = {
        "spread 2^-24..2^24": torch.randn(bl, 8, k, device=dev, generator=gen) * torch.exp2(spread),
        "normal": torch.randn(bl, 8, k, device=dev, generator=gen),
    }
    ok = True
    for name, x in draws.items():
        x = x.to(torch.bfloat16).contiguous()
        outs = []
        for which in (0, 1):
            out = torch.empty(bl, 8, 64, device=dev)
            rc = so.run_probe(which, x.data_ptr(), w.data_ptr(), out.data_ptr(), bl, k,
                              torch.cuda.current_stream().cuda_stream)
            if rc:
                print(f"probe launch failed: CUDA error {rc}", file=sys.stderr)
                return 1
            outs.append(out)
        torch.cuda.synchronize()
        ref = torch.matmul(x.double(), w.double())
        differ = int((outs[0].view(torch.int32) != outs[1].view(torch.int32)).sum())
        row = {"draw": name, "outputs": outs[0].numel(), "k16_steps": k // 16,
               "bits_differ": differ,
               "mma_err": float((outs[0].double() - ref).abs().max()),
               "wgmma_err": float((outs[1].double() - ref).abs().max()),
               "wgmma_equals_mma_sync": differ == 0}
        ok &= differ == 0
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    print(json.dumps({"wgmma_equals_mma_sync": ok}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
