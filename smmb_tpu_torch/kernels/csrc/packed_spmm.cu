// Packed ternary SpMM with fused bias + PReLU for Hopper (sm_90a).
//
//   Y = PReLU(X · W + b, alpha),  W 2-bit packed, group-strided
//
// Replaces the Pallas TPU kernel smmb_tpu/kernels/packed_spmm.py::_kernel
// (pallas_call at packed_spmm.py:388). The layout of W and its decode are
// in packed_decode.cuh, shared with fused_mlp.cu; the cp.async, ldmatrix
// and mma wrappers in mma_sm90.cuh, shared with flash_attention.cu.
//
// Two kernels, one per kind of arithmetic:
//   * packed_spmm_float (f32 parity mode): CUDA cores, f32 FMA, no TF32;
//     a 64 x 128 tile, K in chunks of 8 packed rows, X and decoded W staged
//     in shared memory, a 4 x 8 register micro-tile per thread.
//   * packed_spmm_mma (bf16 and W2A8 modes): tensor cores through the warp
//     MMA (mma.sync m16n8k16 bf16 -> f32, m16n8k32 s8 -> s32).
//     - W crosses shared memory only as raw packed bytes. MMA step (u, i)
//       of a K chunk takes plane i of KROWS consecutive packed rows (16 in
//       bf16, 32 in int8). The bytes a thread reads for its B fragment
//       (its column; rows 2t, 2t+1, 8+2t, 9+2t in bf16, 4t..4t+3 and
//       16+4t..19+4t in int8) are decoded in registers with bit operations
//       into the B registers of all four planes: one byte load feeds four
//       MMA steps, and every decoded register feeds the warp's FM row
//       fragments.
//     - X is staged as it lies in memory: per row, four runs of PK columns,
//       one per plane (logical columns g*512 + i*128 + p), so 16-byte
//       cp.async copies fill it, and one ldmatrix.x4 loads an A fragment in
//       the same (plane, packed row) order of K.
//     - A cp.async ring of TC_STAGES K chunks of PK packed rows. The W
//       bytes' 16-byte pieces are XOR-swizzled by row, so the four lanes t
//       of a column group read four different banks; X rows are padded by
//       16 bytes, so ldmatrix's eight rows hit eight bank groups.
//     - One K walk for every M: each output element accumulates in one f32
//       (int32) register, chunks in order, MMA steps in order, no split-K,
//       no atomics. PK does not depend on the tile, so row r of an M-row
//       call equals the M = 1 call bitwise whatever tile the wrapper picks
//       (BM 16 or 64 by M, BN 64/128 so that the grid fills about a wave).
//     - Rows that cannot be copied in 16-byte pieces (K or N not a multiple
//       of the piece, or a misaligned pointer) take element loads into the
//       same shared layout (template flag ALIGNED, chosen by the wrapper).
//   * Epilogue (both kernels): dequant as __fmul_rn(float(acc), scale),
//     f32 bias with __fadd_rn, PReLU as !(v > 0), store in the output
//     dtype; rounded like the reference's separate multiply and add.
//   * Ragged M, N and K edges are zero in shared memory: K need not be a
//     multiple of 512 (the format pads W's rows, not X's columns).
//   * The kernels allocate nothing, launch on the caller's stream and do
//     not synchronise; the C entry returns cudaGetLastError().
//
// Bound on an H100 SXM at the M=256, K=N=4096, ~10% nnz headline: bytes
// (X, W, bias and Y read or written once, ~3.6 us at 3.35 TB/s) for bf16 and
// int8; operations for f32, which has no tensor-core path without TF32. At
// M = 1 every mode is bound by W's bytes.

#include <type_traits>

#include "mma_sm90.cuh"
#include "packed_decode.cuh"

using namespace smmb_mma;
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

// f32 mode (f32 FMA on CUDA cores, never TF32): X is staged in f32.
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

// ---- bf16 and W2A8 modes: warp MMA on tensor cores

constexpr int TC_PK = 32;      // packed rows per K chunk, for every tile
constexpr int TC_STAGES = 4;   // cp.async ring depth (K chunks in flight)
constexpr int TC_XPAD = 16;    // bytes after each staged X row (ldmatrix banks)

template <int BM_, int BN_, bool INT8>
struct TcTile {
  static constexpr int TBM = BM_, TBN = BN_;
  static constexpr int XB = INT8 ? 1 : 2;            // bytes per X element
  static constexpr int XRUN = TC_PK * XB;            // bytes per plane run
  static constexpr int XROW = 4 * XRUN + TC_XPAD;    // bytes per staged X row
  static constexpr int XSTAGE = BM_ * XROW;
  static constexpr int STAGE = XSTAGE + TC_PK * BN_;  // X, then raw W bytes
  static constexpr int SMEM = TC_STAGES * STAGE;
  // 8 warps split the columns only: each decoded B register feeds all of
  // a warp's FM row fragments (FM = 4 at BM = 64)
  static constexpr int WARPS = 8;
  static constexpr int FM = BM_ / 16;           // m16 fragments a warp
  static constexpr int FN = BN_ / (8 * WARPS);  // n8 fragments a warp
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int KROWS = INT8 ? 32 : 16;       // packed rows a step
  static constexpr int PIECES = BN_ / 16;            // 16-byte pieces a W row
  static constexpr int SWZ_MASK = (PIECES < 8 ? PIECES : 8) - 1;
  static constexpr int SWZ_SHIFT = INT8 ? 2 : 1;     // lanes' rows 4t / 2t apart
  static_assert(BM_ == 16 || BM_ == 64, "BM");
  static_assert(BN_ == 64 || BN_ == 128, "BN");
  static_assert(SUB % TC_PK == 0 && TC_PK % KROWS == 0, "PK");
};

// byte offset of (packed row r, column c) in a W stage: the 16-byte piece
// c / 16 of row r lies at piece (c / 16) ^ swizzle(r)
template <class T>
__device__ __forceinline__ int w_off(int r, int c) {
  const int piece = (c >> 4) ^ ((r >> T::SWZ_SHIFT) & T::SWZ_MASK);
  return r * T::TBN + piece * 16 + (c & 15);
}

// Field i of the two packed bytes in bits 0-7 and 8-15 of x, as a bf16 pair
// (the values decode_field gives): 0b00 -> 0, 0b01 -> +1 (0x3F80), 0b11 ->
// -1 (0xBF80), 0b10 -> -2 (0xC000). The two codes land in nibbles 0 and 2;
// v * 0x11 + 0x4040 copies them to nibbles 1 and 3 plus 4, and one byte
// permute reads each value's low byte from {00, 80, 00, 80} and its high
// byte from {00, 3F, C0, BF}.
__device__ __forceinline__ unsigned bf16_pair(unsigned x, int i) {
  const unsigned v = (x >> (2 * i)) & 0x0303u;
  return __byte_perm(0x80008000u, 0xBFC03F00u, v * 0x11u + 0x4040u);
}

// Field i of the four packed bytes of x, as four signed int8 lanes (the
// spread-and-sign-extend of decode_word, one plane at a time).
__device__ __forceinline__ unsigned s8_quad(unsigned x, int i) {
  const unsigned t = (x >> (2 * i)) & 0x03030303u;
  return t | ((t & 0x02020202u) * 0x7Eu);
}

// Stage K chunk pr0 (TC_PK packed rows) of X and W into one ring slot.
// X row r, plane i, packed row p of the chunk lands at r*XROW + i*XRUN +
// p*XB; rows past M, columns past K and columns past N are zero.
template <class T, bool ALIGNED>
__device__ __forceinline__ void load_chunk(uint8_t* xs, uint8_t* ws,
                                           const uint8_t* __restrict__ x,
                                           const int8_t* __restrict__ w,
                                           int m0, int n0, int m, int k, int n,
                                           int pr0, int tid) {
  const int col0 = (pr0 / SUB) * GROUP_ROWS + pr0 % SUB;  // plane 0's column
  if (ALIGNED) {
    constexpr int XP = T::XRUN / 16;  // pieces a plane run
    for (int p = tid; p < T::TBM * 4 * XP; p += T::THREADS) {
      const int r = p / (4 * XP), i = (p / XP) % 4, j = p % XP;
      const int col = col0 + i * SUB + j * (16 / T::XB);
      const bool ok = m0 + r < m && col < k;
      const uint8_t* src =
          ok ? x + (static_cast<size_t>(m0 + r) * k + col) * T::XB : x;
      cp_async16(xs + r * T::XROW + i * T::XRUN + j * 16, src, ok);
    }
    for (int p = tid; p < TC_PK * T::PIECES; p += T::THREADS) {
      const int r = p / T::PIECES, c = (p % T::PIECES) * 16;
      const bool ok = n0 + c < n;
      const int8_t* src = ok ? w + static_cast<size_t>(pr0 + r) * n + n0 + c : w;
      cp_async16(ws + w_off<T>(r, c), src, ok);
    }
  } else {
    for (int e = tid; e < T::TBM * 4 * TC_PK; e += T::THREADS) {
      const int r = e / (4 * TC_PK), i = (e / TC_PK) % 4, pp = e % TC_PK;
      const int col = col0 + i * SUB + pp;
      const bool ok = m0 + r < m && col < k;
      const size_t at = static_cast<size_t>(m0 + r) * k + col;
      uint8_t* dst = xs + r * T::XROW + i * T::XRUN + pp * T::XB;
      if (T::XB == 1)
        *dst = ok ? x[at] : 0;
      else
        *reinterpret_cast<uint16_t*>(dst) =
            ok ? reinterpret_cast<const uint16_t*>(x)[at] : 0;
    }
    for (int e = tid; e < TC_PK * T::TBN; e += T::THREADS) {
      const int r = e / T::TBN, c = e % T::TBN;
      ws[w_off<T>(r, c)] =
          n0 + c < n ? static_cast<uint8_t>(w[static_cast<size_t>(pr0 + r) * n + n0 + c])
                     : 0;
    }
  }
}

// bf16 (INT8 = false: X bf16, f32 sums) and W2A8 (INT8 = true: X int8
// codes, int32 sums, per-row f32 dequant `scale`) on the warp MMA.
template <int BM_, int BN_, bool INT8, bool ALIGNED, typename OT>
__global__ void __launch_bounds__(TcTile<BM_, BN_, INT8>::THREADS)
packed_spmm_mma(const uint8_t* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ bias, const float* __restrict__ scale,
                OT* __restrict__ out, int m, int k, int n, int kp,
                int has_alpha, float alpha) {
  using T = TcTile<BM_, BN_, INT8>;
  using Acc = typename std::conditional<INT8, int, float>::type;
  extern __shared__ __align__(16) uint8_t smem[];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wn0 = warp * T::FN * 8;
  const int m0 = blockIdx.y * BM_, n0 = blockIdx.x * BN_;
  const int nch = kp / TC_PK;

  Acc acc[T::FM][T::FN][4];
#pragma unroll
  for (int f = 0; f < T::FM; ++f)
#pragma unroll
    for (int j = 0; j < T::FN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][j][e] = 0;

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < nch)
      load_chunk<T, ALIGNED>(smem + s * T::STAGE, smem + s * T::STAGE + T::XSTAGE,
                             x, w, m0, n0, m, k, n, s * TC_PK, tid);
    cp_async_commit();
  }

  for (int c = 0; c < nch; ++c) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();  // chunk c landed; every warp is done with chunk c - 1
    {
      const int nc = c + TC_STAGES - 1, slot = nc % TC_STAGES;
      if (nc < nch)
        load_chunk<T, ALIGNED>(smem + slot * T::STAGE,
                               smem + slot * T::STAGE + T::XSTAGE, x, w, m0, n0,
                               m, k, n, nc * TC_PK, tid);
      cp_async_commit();
    }
    const uint8_t* xs = smem + (c % TC_STAGES) * T::STAGE;
    const uint8_t* ws = xs + T::XSTAGE;

#pragma unroll
    for (int u = 0; u < TC_PK / T::KROWS; ++u) {
      // this thread's raw W bytes for its column of each n8 fragment:
      // bf16 rows 2t, 2t+1 | 8+2t, 9+2t (bytes 0, 1); int8 rows
      // 4t..4t+3 | 16+4t..19+4t (bytes), counted from u*KROWS
      unsigned wb[T::FN][2];
#pragma unroll
      for (int j = 0; j < T::FN; ++j) {
        const int col = wn0 + j * 8 + g;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r0 = u * T::KROWS + h * (T::KROWS / 2);
          if (INT8) {
            const int r = r0 + 4 * t;
            wb[j][h] = static_cast<unsigned>(ws[w_off<T>(r, col)]) |
                       (static_cast<unsigned>(ws[w_off<T>(r + 1, col)]) << 8) |
                       (static_cast<unsigned>(ws[w_off<T>(r + 2, col)]) << 16) |
                       (static_cast<unsigned>(ws[w_off<T>(r + 3, col)]) << 24);
          } else {
            const int r = r0 + 2 * t;
            wb[j][h] = static_cast<unsigned>(ws[w_off<T>(r, col)]) |
                       (static_cast<unsigned>(ws[w_off<T>(r + 1, col)]) << 8);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // A fragments: plane i, packed rows u*KROWS .. +KROWS; lane l gives
        // the address of row l % 16, k half l / 16 (16 bytes each)
        unsigned a[T::FM][4];
#pragma unroll
        for (int f = 0; f < T::FM; ++f)
          ldmatrix_x4(a[f], xs + (f * 16 + (lane & 15)) * T::XROW +
                                i * T::XRUN + u * T::KROWS * T::XB +
                                (lane >> 4) * 16);
#pragma unroll
        for (int j = 0; j < T::FN; ++j) {
          const unsigned b0 = INT8 ? s8_quad(wb[j][0], i) : bf16_pair(wb[j][0], i);
          const unsigned b1 = INT8 ? s8_quad(wb[j][1], i) : bf16_pair(wb[j][1], i);
#pragma unroll
          for (int f = 0; f < T::FM; ++f) mma(acc[f][j], a[f], b0, b1);
        }
      }
    }
  }
  cp_async_wait<0>();

  // C fragment: acc[f][j][2h + e] is row g + 8h, column 2t + e
#pragma unroll
  for (int f = 0; f < T::FM; ++f)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + f * 16 + g + 8 * h;
      if (row >= m) continue;
      const float s = INT8 ? scale[row] : 1.f;
#pragma unroll
      for (int j = 0; j < T::FN; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn0 + j * 8 + 2 * t + e;
          if (col >= n) continue;
          const float v = INT8 ? __fmul_rn(static_cast<float>(acc[f][j][2 * h + e]), s)
                               : static_cast<float>(acc[f][j][2 * h + e]);
          epilogue(v, row, col, n, bias, has_alpha, alpha, out);
        }
    }
}

template <int BM_, int BN_, bool INT8, bool ALIGNED, typename OT>
cudaError_t launch_mma(const void* x, const void* w, const void* bias,
                       const void* scale, void* out, int m, int k, int n,
                       int kp, int has_alpha, float alpha, cudaStream_t stream) {
  using T = TcTile<BM_, BN_, INT8>;
  auto kern = packed_spmm_mma<BM_, BN_, INT8, ALIGNED, OT>;
  // the ring is above the 48 KB static limit: raise the kernel's dynamic
  // shared memory once per device
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::SMEM);
    if (e != cudaSuccess) return e;
    raised[dev] = true;
  }
  const dim3 grid((n + BN_ - 1) / BN_, (m + BM_ - 1) / BM_);
  kern<<<grid, T::THREADS, T::SMEM, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(scale),
      static_cast<OT*>(out), m, k, n, kp, has_alpha, alpha);
  return cudaSuccess;
}

template <bool INT8, bool ALIGNED, typename OT>
cudaError_t dispatch_tile(int bm, int bn, const void* x, const void* w,
                          const void* bias, const void* scale, void* out, int m,
                          int k, int n, int kp, int has_alpha, float alpha,
                          cudaStream_t s) {
#define SMMB_TILE(BM_, BN_)                                                  \
  if (bm == BM_ && bn == BN_)                                                \
    return launch_mma<BM_, BN_, INT8, ALIGNED, OT>(x, w, bias, scale, out, m, \
                                                   k, n, kp, has_alpha,      \
                                                   alpha, s);
  SMMB_TILE(16, 64)
  SMMB_TILE(16, 128)
  SMMB_TILE(64, 64)
  SMMB_TILE(64, 128)
#undef SMMB_TILE
  return cudaErrorInvalidValue;
}

template <typename OT>
cudaError_t launch(const void* x, const void* w, const void* bias,
                   const void* scale, void* out, int m, int k, int n, int kp,
                   int x_mode, int bm, int bn, int aligned, int has_alpha,
                   float alpha, cudaStream_t stream) {
  if (x_mode == 0) {
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    packed_spmm_float<float, OT><<<grid, THREADS, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(bias), static_cast<OT*>(out), m, k, n, kp,
        has_alpha, alpha);
    return cudaSuccess;
  }
  const bool int8 = x_mode == 2;
  if (int8 && aligned)
    return dispatch_tile<true, true, OT>(bm, bn, x, w, bias, scale, out, m, k,
                                         n, kp, has_alpha, alpha, stream);
  if (int8)
    return dispatch_tile<true, false, OT>(bm, bn, x, w, bias, scale, out, m, k,
                                          n, kp, has_alpha, alpha, stream);
  if (aligned)
    return dispatch_tile<false, true, OT>(bm, bn, x, w, bias, scale, out, m, k,
                                          n, kp, has_alpha, alpha, stream);
  return dispatch_tile<false, false, OT>(bm, bn, x, w, bias, scale, out, m, k,
                                         n, kp, has_alpha, alpha, stream);
}

}  // namespace

// x_mode: 0 = f32 X, 1 = bf16 X, 2 = int8 X codes with per-row f32 `scale`.
// out_bf16: 0 = f32 output, 1 = bf16 output. bias may be null.
// w is int8[kp, n] with kp a multiple of 128 (K padded to 512 rows).
// bm x bn: the tensor-core modes' tile (16 or 64 x 64 or 128, chosen by the
// wrapper); the f32 mode takes its fixed 64 x 128 and ignores them.
// aligned: X and W rows may be copied in 16-byte pieces (K a multiple of
// 16 / XB, N of 16, both pointers 16-byte aligned); else element loads.
// Returns the CUDA error of the launch (0 on success).
extern "C" int smmb_packed_spmm(const void* x, const void* w, const void* bias,
                                const void* scale, void* out, int m, int k,
                                int n, int kp, int x_mode, int out_bf16,
                                int bm, int bn, int aligned, int has_alpha,
                                float alpha, void* stream) {
  const int rows = x_mode == 0 ? BM : bm;
  if (m <= 0 || n <= 0 || k <= 0 || kp % SUB != 0 || kp * 4 < k ||
      x_mode < 0 || x_mode > 2 || (x_mode == 2 && scale == nullptr) ||
      rows <= 0 || (m + rows - 1) / rows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      out_bf16 ? launch<__nv_bfloat16>(x, w, bias, scale, out, m, k, n, kp,
                                       x_mode, bm, bn, aligned, has_alpha,
                                       alpha, s)
               : launch<float>(x, w, bias, scale, out, m, k, n, kp, x_mode, bm,
                               bn, aligned, has_alpha, alpha, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
