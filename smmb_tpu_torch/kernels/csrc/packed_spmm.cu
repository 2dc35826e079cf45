// Packed ternary SpMM with fused bias + PReLU for Hopper (sm_90a).
//
//   Y = PReLU(X · W + b, alpha),  W 2-bit packed, group-strided
//
// Replaces the Pallas TPU kernel smmb_tpu/kernels/packed_spmm.py::_kernel
// (pallas_call at packed_spmm.py:388). The layout of W and its decode are
// in packed_decode.cuh, shared with fused_mlp.cu.
//
// Design (first, simple version; CUDA cores only, no wgmma/TMA yet):
//   * Each block owns a BM x BN output tile. A loop inside the block walks
//     K in chunks of PK packed rows (4*PK logical rows, one slice of every
//     plane of a group); it replaces the TPU's sequential K grid axis.
//   * Per chunk the block stages the chunk's X slice and the decoded W
//     slice in shared memory; each thread keeps a TM x TN micro-tile of
//     accumulators in registers. W is decoded once per block, so the decode
//     cost is shared by the BM rows of the tile.
//   * No split-K and no atomics: a row's result does not depend on M.
//   * Modes: f32 X (f32 FMA, no TF32), bf16 X (converted to f32, f32
//     accumulation; W decodes exactly so the only error is the cast of X),
//     int8 X codes (dp4a on four planes at once, int32 accumulation, per-row
//     f32 dequant in the epilogue).
//   * Epilogue: dequant, f32 bias, PReLU, store in the output dtype. The
//     epilogue uses __fmul_rn/__fadd_rn so it rounds exactly like the
//     reference's separate multiply and add (no FMA contraction).
//   * Ragged M, N and K edges are masked in the kernel: K need not be a
//     multiple of 512 (the format pads W's rows, not X's columns).
//   * The kernel allocates nothing, launches on the caller's stream and
//     does not synchronise; the C entry returns cudaGetLastError().
//
// Bound on an H100 SXM at the M=256, K=N=4096, ~10% nnz headline: bytes
// (X, W, bias and Y read or written once, ~3.6 us at 3.35 TB/s) for bf16 and
// int8; operations for f32, which has no tensor-core path without TF32.

#include "packed_decode.cuh"

using namespace smmb_packed;

namespace {

constexpr int BM = 64;          // output rows per block
constexpr int BN = 128;         // output columns per block
constexpr int PK = 8;           // packed rows per K chunk
constexpr int BK = 4 * PK;      // logical rows per K chunk (PK of each plane)
constexpr int THREADS = 256;    // 16 x 16 threads
constexpr int TM = 4;           // accumulator rows per thread
constexpr int TN = 8;           // accumulator columns per thread (2 runs of 4)

// thread (ty, tx) owns rows ty*TM + r and columns tx*4 + c, 64 + tx*4 + c
__device__ __forceinline__ int out_col(int tx, int c) {
  return (c < 4 ? 0 : BN / 2 - 4) + tx * 4 + c;
}

template <typename OT>
__device__ __forceinline__ void epilogue(float v, int row, int col, int n,
                                         const float* __restrict__ bias,
                                         int has_alpha, float alpha,
                                         OT* __restrict__ out) {
  if (bias != nullptr) v = __fadd_rn(v, bias[col]);
  if (has_alpha && !(v > 0.f)) v = __fmul_rn(alpha, v);
  store_out(out + static_cast<size_t>(row) * n + col, v);
}

// f32 and bf16 modes: X is converted to f32 while it is staged.
template <typename XT, typename OT>
__global__ void __launch_bounds__(THREADS)
packed_spmm_float(const XT* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ bias, OT* __restrict__ out, int m,
                  int k, int n, int kp, int has_alpha, float alpha) {
  __shared__ __align__(16) float xs[BK][BM];  // X chunk, transposed
  __shared__ __align__(16) float ws[BK][BN];  // decoded W chunk

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;

  // staging roles: X — plane xi of row xm (8 logical columns per thread);
  // W — 4 consecutive columns of packed row wp
  const int xm = tid % BM, xi = tid / BM;
  const int wp = tid / 32, wn = (tid % 32) * 4;
  const bool x_row_ok = m0 + xm < m;
  const XT* xrow = x + static_cast<size_t>(m0 + xm) * k;

  for (int pr0 = 0; pr0 < kp; pr0 += PK) {
    const int col0 = logical_row(pr0, xi);
#pragma unroll
    for (int pp = 0; pp < PK; ++pp) {
      const int col = col0 + pp;
      xs[xi * PK + pp][xm] =
          (x_row_ok && col < k) ? load_as_float(xrow + col) : 0.f;
    }
    const int8_t* wrow = w + static_cast<size_t>(pr0 + wp) * n;
    int bytes[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = n0 + wn + q;
      bytes[q] = col < n ? static_cast<int>(wrow[col]) : 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 v = make_float4(static_cast<float>(decode_field(bytes[0], i)),
                             static_cast<float>(decode_field(bytes[1], i)),
                             static_cast<float>(decode_field(bytes[2], i)),
                             static_cast<float>(decode_field(bytes[3], i)));
      *reinterpret_cast<float4*>(&ws[i * PK + wp][wn]) = v;
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
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int row = m0 + ty * TM + r;
    if (row >= m) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int col = n0 + out_col(tx, c);
      if (col < n) epilogue(acc[r][c], row, col, n, bias, has_alpha, alpha, out);
    }
  }
}

// W2A8 mode: X holds int8 codes, scale the per-row f32 dequant scale.
// One dp4a multiplies the four planes of a packed row at once: the X word
// holds the codes of logical columns g*512 + i*128 + p for i = 0..3 and the
// W word the four decoded fields of the same packed byte.
template <typename OT>
__global__ void __launch_bounds__(THREADS)
packed_spmm_int8(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ bias,
                 const float* __restrict__ scale, OT* __restrict__ out, int m,
                 int k, int n, int kp, int has_alpha, float alpha) {
  __shared__ __align__(16) int xs[PK][BM];  // 4 X codes per word
  __shared__ __align__(16) int ws[PK][BN];  // 4 decoded fields per word

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0;

  // staging roles: X — packed rows xp, xp + 1 of row xm; W — as float mode
  const int xm = tid % BM, xp = (tid / BM) * 2;
  const int wp = tid / 32, wn = (tid % 32) * 4;
  const bool x_row_ok = m0 + xm < m;
  const int8_t* xrow = x + static_cast<size_t>(m0 + xm) * k;

  for (int pr0 = 0; pr0 < kp; pr0 += PK) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned word = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = logical_row(pr0 + xp + h, i);
        const unsigned code =
            (x_row_ok && col < k) ? static_cast<uint8_t>(xrow[col]) : 0u;
        word |= code << (8 * i);
      }
      xs[xp + h][xm] = static_cast<int>(word);
    }
    const int8_t* wrow = w + static_cast<size_t>(pr0 + wp) * n;
    int4 v;
    int* vp = reinterpret_cast<int*>(&v);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = n0 + wn + q;
      vp[q] = col < n ? decode_word(static_cast<uint8_t>(wrow[col])) : 0;
    }
    *reinterpret_cast<int4*>(&ws[wp][wn]) = v;
    __syncthreads();

#pragma unroll
    for (int pp = 0; pp < PK; ++pp) {
      const int4 a = *reinterpret_cast<const int4*>(&xs[pp][ty * TM]);
      const int4 b0 = *reinterpret_cast<const int4*>(&ws[pp][tx * 4]);
      const int4 b1 = *reinterpret_cast<const int4*>(&ws[pp][BN / 2 + tx * 4]);
      const int av[TM] = {a.x, a.y, a.z, a.w};
      const int bv[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = __dp4a(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int row = m0 + ty * TM + r;
    if (row >= m) continue;
    const float s = scale[row];
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int col = n0 + out_col(tx, c);
      if (col < n)
        epilogue(__fmul_rn(static_cast<float>(acc[r][c]), s), row, col, n,
                 bias, has_alpha, alpha, out);
    }
  }
}

template <typename OT>
void launch(const void* x, const void* w, const void* bias, const void* scale,
            void* out, int m, int k, int n, int kp, int x_mode, int has_alpha,
            float alpha, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* b = static_cast<const float*>(bias);
  OT* o = static_cast<OT*>(out);
  if (x_mode == 0) {
    packed_spmm_float<float, OT><<<grid, THREADS, 0, stream>>>(
        static_cast<const float*>(x), wq, b, o, m, k, n, kp, has_alpha, alpha);
  } else if (x_mode == 1) {
    packed_spmm_float<__nv_bfloat16, OT><<<grid, THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), wq, b, o, m, k, n, kp, has_alpha,
        alpha);
  } else {
    packed_spmm_int8<OT><<<grid, THREADS, 0, stream>>>(
        static_cast<const int8_t*>(x), wq, b, static_cast<const float*>(scale),
        o, m, k, n, kp, has_alpha, alpha);
  }
}

}  // namespace

// x_mode: 0 = f32 X, 1 = bf16 X, 2 = int8 X codes with per-row f32 `scale`.
// out_bf16: 0 = f32 output, 1 = bf16 output. bias may be null.
// w is int8[kp, n] with kp a multiple of 128 (K padded to 512 rows).
// Returns the CUDA error of the launch (0 on success).
extern "C" int smmb_packed_spmm(const void* x, const void* w, const void* bias,
                                const void* scale, void* out, int m, int k,
                                int n, int kp, int x_mode, int out_bf16,
                                int has_alpha, float alpha, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || kp % SUB != 0 || kp * 4 < k ||
      x_mode < 0 || x_mode > 2 || (x_mode == 2 && scale == nullptr) ||
      (m + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    launch<__nv_bfloat16>(x, w, bias, scale, out, m, k, n, kp, x_mode,
                          has_alpha, alpha, s);
  else
    launch<float>(x, w, bias, scale, out, m, k, n, kp, x_mode, has_alpha,
                  alpha, s);
  return static_cast<int>(cudaGetLastError());
}
