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
// fields 0..3 (B1's plane layout with planes r/4 rows apart instead of 128,
// so packed_decode.cuh's byte decodes apply). blk_row[b] is block b's block
// row and col_start[j] .. col_start[j+1] the run of blocks of block column j.
//
// Two bodies, chosen by the block shape before the launch
// (kernels/bcsr_spmm.py::bcsr_route):
//   * bcsr_spmm_mma (r % 64 == 0: the showcase's, the sweep's and the
//     block-sparse workload's 128 x 128 blocks) on the tensor cores through
//     the warp MMA (mma.sync m16n8k16 bf16 -> f32, mma_sm90.cuh).
//     - One thread block owns a BM x BN output tile (bcsr_tile: BM 16 or 64
//       by M, BN 32/64/128 so that the grid fills about a wave) and walks its
//       block column's run in the prepared order; the loop replaces the TPU's
//       sequential grid over stored blocks. A block is r/(4 PK) chunks of PK
//       packed rows (PK = 32, or 16 where r/4 is not a multiple of 32): per
//       chunk, the X slice (BM rows, the chunk's four plane runs of PK
//       columns, as they lie in X) and the raw code bytes (PK x BN) are
//       copied by 16-byte cp.async into a ring of MMA_STAGES chunks, which
//       runs on across block boundaries.
//     - The codes cross shared memory as raw bytes (16-byte pieces XOR-
//       swizzled by row) and are decoded in registers into B fragments
//       (bf16_pair): one byte pair feeds the four planes' MMA steps.
//     - bf16 X: ldmatrix.x4 from the staged rows (16 bytes of padding a row
//       keep its eight rows in eight bank groups); one pass, exact products.
//       Warps split the columns first, so each decoded B register feeds up
//       to four row fragments (the decode, not the MMA, bounds a k16 step).
//     - f32 X, never TF32: X is staged in f32 (32 bytes of padding a row keep
//       the 8-byte fragment loads of a half-warp in distinct banks) and every
//       A register is split on the fly into three bf16 pieces, x = hi + mid +
//       lo exactly (split_bf16x3); three passes with the same B registers
//       give the exact f32 products. One launch, no scratch. Each warp owns
//       one 16-row fragment and up to 8 column fragments: the split of an A
//       fragment (the costlier work here) feeds 3 FN MMAs.
//     - Accumulation. The tensor core's f32 accumulation aligns the addends
//       and truncates, so a long chain of MMAs into one register drifts. Per
//       stored block the hi pass sums into one zeroed fragment and mid + lo
//       into another; at the block's end both are added into the running f32
//       sums with __fadd_rn, block by block, hi then mid + lo. Within a block
//       the hi products of |x| >= 2^-9 are multiples of the accumulator's ulp,
//       so truncation has nothing to cut there.
//     - No split of K, no atomics: each output sums in one register, in the
//       order of its block column's run and of the K walk inside a block, so
//       row i of an M-row call is bitwise the M = 1 call whatever the tile.
//   * bcsr_spmm_kernel (any other r: the tests' 4- and 8-row blocks) on the
//     CUDA cores: a 64 x 128 tile, per stored block chunks of 32 block rows,
//     the X slice and the decoded codes staged in shared memory, a 4 x 8 f32
//     register micro-tile a thread (f32 FMA, bf16 X widened exactly).
//   * Epilogue (both): f32 bias with __fadd_rn, PReLU as !(v > 0) ->
//     __fmul_rn, one store in X's dtype. A block column with an empty run
//     writes the activated bias. The kernels allocate nothing, launch on the
//     caller's stream and do not synchronise; the C entry returns
//     cudaGetLastError().
//
// Bound on an H100 SXM: f32 X times the ternary W is the bf16 tensor-core
// rate over three passes (bench/roofline.py's "f32_ternary", 329.7 TFLOP/s);
// at the showcase's 256 x 1024 x 4096 with every block stored that is the
// operations' bound, and at M = 1 W's bytes. The mma body executes the
// dense in-block count 2·M·k·r·c (three times in f32): skipping the zeros
// inside a block is left to a later design (ROADMAP.md). Measured, a k16
// step is bound by the B decode (bf16) or the A split (f32) beside the
// MMAs, hence the two warp layouts above, and the dependent reads of
// col_start, blk_row and the first chunk cost a few us a call.

#include <type_traits>

#include "mma_sm90.cuh"
#include "packed_decode.cuh"

using namespace smmb_mma;
using namespace smmb_packed;

namespace {

// ---- the CUDA-core body (r % 64 != 0)

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


// ---- the tensor-core body (r % MMA_R == 0)

constexpr int MMA_R = 64;       // block rows the mma body needs a multiple of
constexpr int MMA_PK = 32;      // packed rows a chunk (16 where r/4 % 32 != 0)
constexpr int MMA_KROWS = 16;   // packed rows an MMA step (k16)
constexpr int MMA_STAGES = 3;   // cp.async ring depth (chunks in flight)

template <int BM_, int BN_, bool F32>
struct MmaTile {
  static constexpr int TBM = BM_, TBN = BN_;
  static constexpr int XB = F32 ? 4 : 2;                   // bytes an X element
  static constexpr int XPAD = F32 ? 32 : 16;               // bytes after a row
  static constexpr int XROW = 4 * MMA_PK * XB + XPAD;      // bytes a staged row
  static constexpr int XSTAGE = BM_ * XROW;
  static constexpr int STAGE = XSTAGE + MMA_PK * BN_;      // X, then raw codes
  static constexpr int SMEM = MMA_STAGES * STAGE;
  // warps: WM row groups of FM m16 fragments x WN column groups of FN n8
  // fragments (4 warps at BM = 16, 8 at 64). A decoded B register feeds FM
  // MMAs a pass and an A fragment FN: f32 takes one row fragment a warp
  // (its A split is the costlier), bf16 as many as the tile allows (its B
  // decode is).
  static constexpr int WN = BM_ == 16 ? 4 : F32 ? 2 : (BN_ / 16 < 8 ? BN_ / 16 : 8);
  static constexpr int WM = (BM_ == 16 ? 4 : 8) / WN;
  static constexpr int FM = BM_ / (16 * WM);
  static constexpr int FN = BN_ / (8 * WN);
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int PIECES = BN_ / 16;                  // 16-byte pieces a code row
  static_assert(BM_ == 16 || BM_ == 64, "BM");
  static_assert(BN_ == 32 || BN_ == 64 || BN_ == 128, "BN");
  static_assert(FM >= 1 && FN >= 1 && FM * 16 * WM == BM_ && FN * 8 * WN == BN_, "warps");
};

// byte offset of (packed row r, column c) in a code stage: piece c / 16 of
// row r lies at piece (c / 16) ^ ((r / 2) % PIECES), so the four lanes t of
// a column group, reading rows 2t apart, hit different banks
template <class T>
__device__ __forceinline__ int w_off(int r, int c) {
  const int piece = (c >> 4) ^ ((r >> 1) & (T::PIECES - 1));
  return r * T::TBN + piece * 16 + (c & 15);
}

// x = hi + mid + lo exactly, for the two floats of v, each piece a bf16
// rounded to nearest even: hi holds x's leading 8 significant bits, mid the
// next 8 of x - hi, lo those of the rest (x has 24, and a remainder after
// rounding to nearest is at most half the piece's ulp, so its sign costs no
// bit). Exact for x = 0 and |x| >= 2^-103, where every nonzero piece is a
// normal bf16; below that a piece may be subnormal, which the tensor core
// need not keep (an error under 2^-126 a product). The pieces come packed as
// the MMA's A registers: the lower column in the low half.
// kernels/bcsr_spmm.py::split_bf16x3 is the same arithmetic.
__device__ __forceinline__ void split_bf16x3(float2 v, unsigned& hi,
                                             unsigned& mid, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 hf = __bfloat1622float2(h);
  const float2 r1 = make_float2(__fsub_rn(v.x, hf.x), __fsub_rn(v.y, hf.y));
  const __nv_bfloat162 md = __floats2bfloat162_rn(r1.x, r1.y);
  const float2 mf = __bfloat1622float2(md);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(r1.x, mf.x), __fsub_rn(r1.y, mf.y));
  hi = *reinterpret_cast<const unsigned*>(&h);
  mid = *reinterpret_cast<const unsigned*>(&md);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// Stage chunk q of the run into one ring slot: block b = run0 + q / nh,
// packed rows h*pk .. h*pk + pk of it (h = q % nh). X row i, plane p,
// packed row j lands at i*XROW + (p*pk + j)*XB; rows past M are zero.
template <class T>
__device__ __forceinline__ void load_chunk(uint8_t* xs, uint8_t* ws,
                                           const uint8_t* __restrict__ x,
                                           const int8_t* __restrict__ values,
                                           const int* __restrict__ blk_row,
                                           int run0, int q, int nh, int pk,
                                           int m0, int m, int k, int r, int c,
                                           int cc0, int tid) {
  const int b = run0 + q / nh, h = q - (q / nh) * nh;
  const int sub = r / 4;
  const int col0 = blk_row[b] * r + h * pk;  // plane 0's first column
  const int xp = pk * T::XB / 16;            // pieces a plane run
  for (int p = tid; p < T::TBM * 4 * xp; p += T::THREADS) {
    const int row = p / (4 * xp), i = (p / xp) % 4, j = p % xp;
    const bool ok = m0 + row < m;
    const uint8_t* src =
        ok ? x + (static_cast<size_t>(m0 + row) * k + col0 + i * sub) * T::XB + j * 16
           : x;
    cp_async16(xs + row * T::XROW + i * pk * T::XB + j * 16, src, ok);
  }
  const int8_t* wblk =
      values + (static_cast<size_t>(b) * sub + h * pk) * c + cc0;
  for (int p = tid; p < pk * T::PIECES; p += T::THREADS) {
    const int rr = p / T::PIECES, cp = (p % T::PIECES) * 16;
    cp_async16(ws + w_off<T>(rr, cp), wblk + static_cast<size_t>(rr) * c + cp, true);
  }
}

template <int BM_, int BN_, bool F32>
__global__ void __launch_bounds__(MmaTile<BM_, BN_, F32>::THREADS)
bcsr_spmm_mma(const uint8_t* __restrict__ x, const int8_t* __restrict__ values,
              const int* __restrict__ blk_row, const int* __restrict__ col_start,
              const float* __restrict__ bias,
              typename std::conditional<F32, float, __nv_bfloat16>::type* __restrict__ out,
              int m, int k, int n, int r, int c, int has_alpha, float alpha) {
  using T = MmaTile<BM_, BN_, F32>;
  constexpr int FM = T::FM, FN = T::FN;
  extern __shared__ __align__(16) uint8_t smem[];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow0 = (warp / T::WN) * FM * 16;    // the warp's first tile row
  const int wcol0 = (warp % T::WN) * FN * 8;     // and first tile column
  const int m0 = blockIdx.y * BM_, n0 = blockIdx.x * BN_;
  const int bcol = n0 / c, cc0 = n0 - bcol * c;
  const int sub = r / 4;
  const int pk = sub % MMA_PK == 0 ? MMA_PK : MMA_KROWS;
  const int nh = sub / pk, steps = pk / MMA_KROWS;
  const int run0 = col_start[bcol];
  const int nch = (col_start[bcol + 1] - run0) * nh;

  // acc: the running sums; hi (and ml: mid + lo in f32) the current block's
  float acc[FM][FN][4], hi[FM][FN][4], ml[FM][FN][4];
#pragma unroll
  for (int f = 0; f < FM; ++f)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][j][e] = hi[f][j][e] = ml[f][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    if (s < nch)
      load_chunk<T>(smem + s * T::STAGE, smem + s * T::STAGE + T::XSTAGE, x, values,
                    blk_row, run0, s, nh, pk, m0, m, k, r, c, cc0, tid);
    cp_async_commit();
  }

  for (int q = 0; q < nch; ++q) {
    cp_async_wait<MMA_STAGES - 2>();
    __syncthreads();  // chunk q landed; every warp is done with chunk q - 1
    {
      const int nq = q + MMA_STAGES - 1, slot = nq % MMA_STAGES;
      if (nq < nch)
        load_chunk<T>(smem + slot * T::STAGE, smem + slot * T::STAGE + T::XSTAGE, x,
                      values, blk_row, run0, nq, nh, pk, m0, m, k, r, c, cc0, tid);
      cp_async_commit();
    }
    const uint8_t* xs = smem + (q % MMA_STAGES) * T::STAGE;
    const uint8_t* ws = xs + T::XSTAGE;
    const int h = q % nh;
    if (h == 0) {
#pragma unroll
      for (int f = 0; f < FM; ++f)
#pragma unroll
        for (int j = 0; j < FN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) hi[f][j][e] = ml[f][j][e] = 0.f;
    }

#pragma unroll
    for (int u = 0; u < MMA_PK / MMA_KROWS; ++u) {
      if (u >= steps) break;
      // this thread's raw code bytes for its column of each n8 fragment:
      // rows 2t, 2t+1 (wb[j][0]) and 8+2t, 9+2t (wb[j][1]) from u*16
      unsigned wb[FN][2];
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int col = wcol0 + j * 8 + g;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int rr = u * MMA_KROWS + hh * 8 + 2 * t;
          wb[j][hh] = static_cast<unsigned>(ws[w_off<T>(rr, col)]) |
                      (static_cast<unsigned>(ws[w_off<T>(rr + 1, col)]) << 8);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // A fragments of plane i, packed rows u*16 .. u*16 + 15 (PTX layout:
        // a0..a3 = (g, 2t), (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8))
        unsigned a[FM][4], am[FM][4], al[FM][4];
        const int kcol = i * pk + u * MMA_KROWS;
#pragma unroll
        for (int f = 0; f < FM; ++f) {
          const int row0 = wrow0 + f * 16;
          if (F32) {
            const uint8_t* xa = xs + (row0 + g) * T::XROW + (kcol + 2 * t) * 4;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 v = *reinterpret_cast<const float2*>(
                  xa + (e & 1) * 8 * T::XROW + (e >> 1) * 32);
              split_bf16x3(v, a[f][e], am[f][e], al[f][e]);
            }
          } else {
            ldmatrix_x4(a[f], xs + (row0 + (lane & 15)) * T::XROW + kcol * 2 +
                                  (lane >> 4) * 16);
          }
        }
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          const unsigned b0 = bf16_pair(wb[j][0], i), b1 = bf16_pair(wb[j][1], i);
#pragma unroll
          for (int f = 0; f < FM; ++f) {
            mma(hi[f][j], a[f], b0, b1);
            if (F32) {
              mma(ml[f][j], am[f], b0, b1);
              mma(ml[f][j], al[f], b0, b1);
            }
          }
        }
      }
    }

    if (h == nh - 1) {  // the block's last chunk: fold it into the sums
#pragma unroll
      for (int f = 0; f < FM; ++f)
#pragma unroll
        for (int j = 0; j < FN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[f][j][e] = __fadd_rn(acc[f][j][e], hi[f][j][e]);
            if (F32) acc[f][j][e] = __fadd_rn(acc[f][j][e], ml[f][j][e]);
          }
    }
  }
  cp_async_wait<0>();

  // C fragment: acc[f][j][2hh + e] is row 16f + g + 8hh, column 8j + 2t + e
#pragma unroll
  for (int f = 0; f < FM; ++f)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + wrow0 + f * 16 + g + 8 * hh;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wcol0 + j * 8 + 2 * t + e;
          float v = acc[f][j][2 * hh + e];
          if (bias != nullptr) v = __fadd_rn(v, bias[col]);
          if (has_alpha && !(v > 0.f)) v = __fmul_rn(alpha, v);
          store_out(out + static_cast<size_t>(row) * n + col, v);
        }
    }
}

template <int BM_, int BN_, bool F32>
cudaError_t launch_mma(const void* x, const void* values, const void* blk_row,
                       const void* col_start, const void* bias, void* out,
                       int m, int k, int n, int r, int c, int has_alpha,
                       float alpha, cudaStream_t stream) {
  using T = MmaTile<BM_, BN_, F32>;
  using OT = typename std::conditional<F32, float, __nv_bfloat16>::type;
  auto kern = bcsr_spmm_mma<BM_, BN_, F32>;
  // the f32 ring is above the 48 KB static limit: raise the kernel's
  // dynamic shared memory once per device
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
  const dim3 grid(n / BN_, (m + BM_ - 1) / BM_);
  kern<<<grid, T::THREADS, T::SMEM, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const int8_t*>(values),
      static_cast<const int*>(blk_row), static_cast<const int*>(col_start),
      static_cast<const float*>(bias), static_cast<OT*>(out), m, k, n, r, c,
      has_alpha, alpha);
  return cudaSuccess;
}

template <bool F32>
cudaError_t dispatch_tile(int bm, int bn, const void* x, const void* values,
                          const void* blk_row, const void* col_start,
                          const void* bias, void* out, int m, int k, int n,
                          int r, int c, int has_alpha, float alpha,
                          cudaStream_t s) {
#define SMMB_TILE(BM_, BN_)                                                    \
  if (bm == BM_ && bn == BN_)                                                  \
    return launch_mma<BM_, BN_, F32>(x, values, blk_row, col_start, bias, out, \
                                     m, k, n, r, c, has_alpha, alpha, s);
  SMMB_TILE(16, 32)
  SMMB_TILE(16, 64)
  SMMB_TILE(16, 128)
  SMMB_TILE(64, 32)
  SMMB_TILE(64, 64)
  SMMB_TILE(64, 128)
#undef SMMB_TILE
  return cudaErrorInvalidValue;
}

}  // namespace

// x: (m, k) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1), 16-byte aligned rows;
// out: (m, n) of x's dtype. values: int8[k_blocks, r/4, c], 16-byte aligned;
// blk_row: int32 per block; col_start: int32[n/c + 1]. bias may be null.
// bm x bn: the mma body's tile (kernels/bcsr_spmm.py::bcsr_tile) where
// r % MMA_R == 0, else 0 x 0 for the CUDA-core body; a tile that does not
// match the route's is refused. Returns the CUDA error of the launch (0 on
// success).
extern "C" int smmb_bcsr_spmm(const void* x, int x_bf16, const void* values,
                              const void* blk_row, const void* col_start,
                              const void* bias, void* out, int m, int k, int n,
                              int r, int c, int bm, int bn, int has_alpha,
                              float alpha, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || r <= 0 || r % 4 != 0 || c <= 0 ||
      c % BN != 0 || n % c != 0 || k % r != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r % MMA_R == 0) {
    if (bm <= 0 || bn <= 0 || c % bn != 0 || (m + bm - 1) / bm > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e =
        x_bf16 ? dispatch_tile<false>(bm, bn, x, values, blk_row, col_start,
                                      bias, out, m, k, n, r, c, has_alpha,
                                      alpha, s)
               : dispatch_tile<true>(bm, bn, x, values, blk_row, col_start,
                                     bias, out, m, k, n, r, c, has_alpha,
                                     alpha, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  }
  if (bm != 0 || bn != 0 || (m + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n / BN, (m + BM - 1) / BM);
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
