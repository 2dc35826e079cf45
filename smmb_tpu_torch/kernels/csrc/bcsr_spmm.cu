// BCSR block-sparse SpMM with fused bias + PReLU for Hopper (sm_90a).
//
//   Y = PReLU(X · W + b, alpha),  W stored as r x c blocks of 2-bit codes
//
// Replaces the Pallas TPU kernel smmb_tpu/kernels/bcsr_spmm.py::_kernel
// (bcsr_spmm_pallas, pallas_call at bcsr_spmm.py:260).
//
// Layout (kernels/bcsr_spmm.py::bcsr_prepare, byte-identical to JAX's):
// values is int8[k, r/4, c], blocks sorted by block column, then block row;
// byte [b, i, j] holds block rows i, r/4+i, 2r/4+i, 3r/4+i in its 2-bit
// fields 0..3 (not TernaryPacked's 512-row groups: only the shift decode of
// packed_decode.cuh is shared). blk_row[b] is block b's block row and
// col_start[j] .. col_start[j+1] the run of blocks of block column j.
//
// Design (first, simple version; CUDA cores only, no wgmma/TMA yet):
//   * One thread block per BM x BN output tile, BN = 128 columns of one
//     block column (c % 128 == 0). The block walks its block column's run
//     in the prepared order; this loop replaces the TPU's sequential grid
//     over stored blocks and its output-tile revisits.
//   * Per stored block, chunks of BK block rows: the X slice (BM x BK, rows
//     of the block's X panel) and the decoded W slice (BK x BN) are staged
//     in shared memory; rows past r are zero. Each thread keeps a TM x TN
//     f32 micro-tile in registers, as packed_spmm.cu does.
//   * f32 carrier whatever X is: f32 X multiplies in f32 FMA (never TF32),
//     bf16 X is widened exactly to f32. W is ±1/0, so every product is
//     exact and only the sums round.
//   * Epilogue: f32 bias, PReLU, one store in X's dtype. A block column
//     with an empty run has acc = 0 and writes PReLU(bias), the activated
//     bias of the TPU kernel's seed. __fadd_rn/__fmul_rn keep the epilogue
//     free of FMA contraction, like the plain version's separate ops.
//   * No split across blocks, no atomics: a row's result does not depend on
//     M or the tiling.
//   * The kernel allocates nothing, launches on the caller's stream and does
//     not synchronise; the C entry returns cudaGetLastError().
//
// Bound on an H100 SXM at M=256, K=N=4096 with ~30% of 128x128 blocks
// stored and ~1/10 nonzero inside: f32 by the operations the data needs
// (2·M·nnz at 67 TFLOP/s), bf16 by its bytes. This kernel runs the dense
// in-block count 2·M·k·r·c on CUDA cores, far above both (PERF.md).

#include "packed_decode.cuh"

using namespace smmb_packed;

namespace {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 128;       // output columns per block
constexpr int BK = 32;        // block rows per chunk
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int TM = 4;         // accumulator rows per thread
constexpr int TN = 8;         // accumulator columns per thread (2 runs of 4)

// thread (ty, tx) owns rows ty*TM + i and columns tx*4 + q, 64 + tx*4 + q
__device__ __forceinline__ int out_col(int tx, int q) {
  return (q < 4 ? 0 : BN / 2 - 4) + tx * 4 + q;
}

template <typename XT>
__global__ void __launch_bounds__(THREADS)
bcsr_spmm_kernel(const XT* __restrict__ x, const int8_t* __restrict__ values,
                 const int* __restrict__ blk_row,
                 const int* __restrict__ col_start,
                 const float* __restrict__ bias, XT* __restrict__ out, int m,
                 int k, int n, int r, int c, int has_alpha, float alpha) {
  __shared__ __align__(16) float xs[BK][BM];  // X chunk, transposed
  __shared__ __align__(16) float ws[BK][BN];  // decoded W chunk

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int bcol = n0 / c;        // block column of this tile
  const int cc0 = n0 - bcol * c;  // tile's first column inside the block
  const int sub = r / 4;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[i][q] = 0.f;

  // staging roles: X — 8 consecutive block rows xk.. of output row xm;
  // W — block rows wr + 8*s (s = 0..3) of 4 consecutive columns wn..
  const int xm = tid % BM, xk = (tid / BM) * 8;
  const int wr = tid / 32, wn = (tid % 32) * 4;
  const bool x_row_ok = m0 + xm < m;
  const XT* xrow = x + static_cast<size_t>(m0 + xm) * k;

  const int run0 = col_start[bcol], run1 = col_start[bcol + 1];
  for (int blk = run0; blk < run1; ++blk) {
    const XT* xpanel = xrow + static_cast<size_t>(blk_row[blk]) * r;
    const int8_t* vblk = values + static_cast<size_t>(blk) * sub * c + cc0 + wn;
    for (int kk = 0; kk < r; kk += BK) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int row = kk + xk + q;
        xs[xk + q][xm] = (x_row_ok && row < r) ? load_as_float(xpanel + row) : 0.f;
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int row = kk + wr + 8 * s;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < r) {
          const int field = row / sub;
          const unsigned word = *reinterpret_cast<const unsigned*>(
              vblk + static_cast<size_t>(row - field * sub) * c);
          v = make_float4(word_field(word, 0, field), word_field(word, 1, field),
                          word_field(word, 2, field), word_field(word, 3, field));
        }
        *reinterpret_cast<float4*>(&ws[wr + 8 * s][wn]) = v;
      }
      __syncthreads();

#pragma unroll
      for (int j = 0; j < BK; ++j) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[j][ty * TM]);
        const float4 b0 = *reinterpret_cast<const float4*>(&ws[j][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&ws[j][BN / 2 + tx * 4]);
        const float av[TM] = {a.x, a.y, a.z, a.w};
        const float bv[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int q = 0; q < TN; ++q) acc[i][q] = fmaf(av[i], bv[q], acc[i][q]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * TM + i;
    if (row >= m) continue;
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      const int col = n0 + out_col(tx, q);
      if (col >= n) continue;
      float v = acc[i][q];
      if (bias != nullptr) v = __fadd_rn(v, bias[col]);
      if (has_alpha && !(v > 0.f)) v = __fmul_rn(alpha, v);
      store_out(out + static_cast<size_t>(row) * n + col, v);
    }
  }
}

}  // namespace

// x: (m, k) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); out: (m, n) of x's
// dtype. values: int8[k_blocks, r/4, c], 4-byte aligned rows; blk_row:
// int32 per block; col_start: int32[n/c + 1]. bias may be null.
// Returns the CUDA error of the launch (0 on success).
extern "C" int smmb_bcsr_spmm(const void* x, int x_bf16, const void* values,
                              const void* blk_row, const void* col_start,
                              const void* bias, void* out, int m, int k, int n,
                              int r, int c, int has_alpha, float alpha,
                              void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || r <= 0 || r % 4 != 0 || c <= 0 ||
      c % BN != 0 || n % c != 0 || k % r != 0 || (m + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n / BN, (m + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* v = static_cast<const int8_t*>(values);
  const int* br = static_cast<const int*>(blk_row);
  const int* cs = static_cast<const int*>(col_start);
  const float* b = static_cast<const float*>(bias);
  if (x_bf16)
    bcsr_spmm_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), v, br, cs, b,
        static_cast<__nv_bfloat16*>(out), m, k, n, r, c, has_alpha, alpha);
  else
    bcsr_spmm_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), v, br, cs, b, static_cast<float*>(out), m,
        k, n, r, c, has_alpha, alpha);
  return static_cast<int>(cudaGetLastError());
}
