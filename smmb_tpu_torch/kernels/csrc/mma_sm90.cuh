// Inline-PTX building blocks of the port's tensor-core kernels (sm_90a):
// 16-byte cp.async copies, ldmatrix loads of MMA fragments, and the warp
// MMA (mma.sync m16n8k16 bf16 -> f32, m16n8k32 s8 -> s32). Used by
// packed_spmm.cu (B1's bf16 and W2A8 modes) and flash_attention.cu (B9 and
// B9p in bf16).
//
// Fragment layouts (PTX ISA, mma.m16n8k16, lane = 4 g + t): A holds rows g
// and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9 (a0..a3 = (g, lo),
// (g + 8, lo), (g, hi), (g + 8, hi)); B holds column g, rows 2t, 2t + 1
// (b0) and 2t + 8, 2t + 9 (b1); C holds rows g (c0, c1) and g + 8 (c2,
// c3), columns 2t, 2t + 1. The C layout of two neighbouring n8 tiles is
// thus the A layout of one k16 step.
#pragma once

#include <cuda_runtime.h>

namespace smmb_mma {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and receives in r[i] its pair of matrix i
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, each matrix transposed: from a row-major (k, n) tile it gives
// the B fragments of mma's column-major operand
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma(int (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace smmb_mma
