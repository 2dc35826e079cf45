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
//   * packed_spmm_float (f32 parity mode): CUDA cores, f32 FMA, no TF32.
//     - One f32 register an output takes fmaf(x, w, acc) in one K order:
//       chunk by chunk of PK = 8 packed rows, in a chunk plane 0's 8 logical
//       rows, then plane 1's, 2's and 3's. No split-K, no partial sums, so
//       every tile gives the same bits and row r of an M-row call is the
//       M = 1 call's (w is 0 or +-1: each product is exact).
//     - Four tiles (BM 16 or 64 by BN 64 or 128), 4 FMA warps each; the
//       wrapper picks the one whose grid fills about a wave. BM 64: an 8 x 8
//       (BN 128) or 4 x 8 register micro-tile a lane; BM 16: the lanes on
//       columns (2 x 8 or 1 x 8), so M = 1..32 spreads over the card.
//     - A cp.async ring of stages of 4 chunks: X in 16-byte pieces of a
//       plane's columns, laid out in K order in rows padded to 132 floats (a
//       warp's four rows hit four bank groups); W as raw bytes, decoded once
//       a stage into shared bf16 pairs (exact; double buffered) for all the
//       block's rows, widened to f32 with one bit operation.
//     - With 16-byte pieces, four copy warps (one a scheduler) issue stage
//       s + 1's copies and decode it while the FMA warps compute stage s, one
//       named barrier a stage: the copies' issue stalls (a block re-reads its
//       X rows from L2 for every column block) and the decode's latency
//       leave the FMA warps. With element loads the four warps stage, decode
//       and compute in turn, one __syncthreads a stage.
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
//   * Rows that cannot be copied in 16-byte pieces (K or N not a multiple
//     of the piece, or a misaligned pointer) take element loads into the
//     same shared layout (template flag ALIGNED, chosen by the wrapper), in
//     both kernels.
//   * Epilogue (both kernels): dequant as __fmul_rn(float(acc), scale),
//     f32 bias with __fadd_rn, PReLU as !(v > 0), store in the output
//     dtype; rounded like the reference's separate multiply and add.
//   * Ragged M, N and K edges are zero in shared memory: K need not be a
//     multiple of 512 (the format pads W's rows, not X's columns).
//   * The kernels allocate nothing, launch on the caller's stream and do
//     not synchronise; the C entry returns cudaGetLastError().
//
// Bound on an H100 SXM at the M=256, K=N=4096, ~10% nnz headline: bytes
// (X, W, bias and Y read or written once, ~3.6 us at 3.35 TB/s) for every
// mode, f32 counted as three exact bf16 passes (bench/roofline.py's
// "f32_ternary", which bcsr_spmm.cu runs and the f32 mode here does not:
// those passes would change its sums). On the CUDA cores the f32 mode's own
// ceiling is the f32 rate: 2 M N K / 66.9 TFLOP/s, 0.128 ms at the headline.
// At M = 1 every mode is bound by W's bytes.

#include <type_traits>

#include "mma_sm90.cuh"
#include "packed_decode.cuh"

using namespace smmb_mma;
using namespace smmb_packed;

namespace {

// ---- f32 mode: CUDA-core FMA chains, one per output, in one K order

constexpr int PK = 8;             // packed rows per K chunk (the K order's unit)
constexpr int BK = 4 * PK;        // logical rows per K chunk (PK of each plane)
constexpr int F32_SPK = 32;       // packed rows per ring stage (4 chunks)
constexpr int F32_SBK = 4 * F32_SPK;  // FMA steps per stage
constexpr int F32_THREADS = 128;  // 4 FMA warps for every f32 tile
constexpr int F32_XROW = F32_SBK + 4;  // floats per staged X row (padded: banks)

// An f32 tile: 4 FMA warps of 4 x 8 lanes; a lane owns TM rows (lr + 4r of
// its warp's rows) and 8 columns (two runs of 4, at lc*4 and 32 + lc*4 of
// its warp's 64). The large tile's TM is 8 (64 accumulators); the small-M
// tiles put their lanes on columns (TM 2 or 1), so M = 1..32 spreads over
// many blocks.
template <int BM_, int BN_>
struct F32Tile {
  static constexpr int TBM = BM_, TBN = BN_;
  static constexpr int THREADS = F32_THREADS;
  static constexpr int TM = BM_ * BN_ / (THREADS * 8);
  static constexpr int WN = BN_ / 64;           // warps along N
  static constexpr int WM = THREADS / 32 / WN;  // warps along M
  static constexpr int STAGES = BM_ == 16 ? 4 : 3;   // ring stages (>= 3)
  static constexpr int XSTAGE = BM_ * F32_XROW * 4;  // bytes of staged X
  static constexpr int STAGE = XSTAGE + F32_SPK * BN_;  // X, then raw W bytes
  static constexpr int WDEC = F32_SBK * BN_ / 2;  // words of a decoded stage (bf16 pairs)
  static constexpr int SMEM = STAGES * STAGE + 2 * WDEC * 4;
  static constexpr int X_PIECES = BM_ * F32_SBK / 4;  // 16-byte pieces of a stage's X
  static constexpr int W_PIECES = F32_SPK * BN_ / 16;  // and of its W bytes
  static constexpr int DEC_ITEMS = F32_SPK * BN_ / 8;  // 8 packed bytes an item
  static_assert(BM_ == 16 || BM_ == 64, "BM");
  static_assert(BN_ == 64 || BN_ == 128, "BN");
  static_assert(WM * 4 * TM == BM_, "tile");
};

// a named barrier of `count` threads (id 0 is __syncthreads')
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
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

// Stage F32_SPK packed rows from pr0 (4 chunks; pr0 a multiple of F32_SPK,
// so the stage lies in one group) of X and W into one ring slot, by WORKERS
// threads (idx among them). X row r holds the stage's columns in K order:
// chunk q's plane i's PK columns at q*BK + i*PK. In memory the stage's
// columns of plane i are 4*PK consecutive ones from logical_row(pr0, i),
// copied in 16-byte pieces: piece e of a row (e = idx % 32 for every row a
// thread copies) is plane e/8, columns 4(e%8)..+3 of the run. W lands as raw
// bytes. Rows past M, columns past K and columns past N are zero.
template <class T, bool ALIGNED, int WORKERS>
__device__ __forceinline__ void load_f32_stage(float* xs, uint8_t* ws,
                                               const float* __restrict__ x,
                                               const int8_t* __restrict__ w,
                                               int m0, int n0, int m, int k,
                                               int n, int pr0, int idx) {
  static_assert(WORKERS % 32 == 0 && T::X_PIECES % WORKERS == 0 &&
                T::W_PIECES % WORKERS == 0, "staging");
  const int col0 = logical_row(pr0, 0);
  if (ALIGNED) {
    const int e = idx % 32, i = e / 8, q = (e % 8) / 2;
    const int col = col0 + i * SUB + (e % 8) * 4, j = q * BK + i * PK + (e % 2) * 4;
#pragma unroll 8
    for (int it = 0; it < T::X_PIECES / WORKERS; ++it) {
      const int r = idx / 32 + it * (WORKERS / 32);
      const bool ok = m0 + r < m && col < k;
      const float* src = ok ? x + static_cast<size_t>(m0 + r) * k + col : x;
      cp_async16(xs + r * F32_XROW + j, src, ok);
    }
#pragma unroll
    for (int it = 0; it < T::W_PIECES / WORKERS; ++it) {
      const int p = idx + it * WORKERS;
      const int r = p / (T::TBN / 16), c = (p % (T::TBN / 16)) * 16;
      const bool ok = n0 + c < n;
      const int8_t* src = ok ? w + static_cast<size_t>(pr0 + r) * n + n0 + c : w;
      cp_async16(ws + r * T::TBN + c, src, ok);
    }
  } else {
    for (int e = idx; e < T::TBM * F32_SBK; e += WORKERS) {
      const int r = e / F32_SBK, j = e % F32_SBK;
      const int q = j / BK, i = (j % BK) / PK;
      const int col = col0 + i * SUB + q * PK + j % PK;
      xs[r * F32_XROW + j] =
          m0 + r < m && col < k ? x[static_cast<size_t>(m0 + r) * k + col] : 0.f;
    }
    for (int e = idx; e < F32_SPK * T::TBN; e += WORKERS) {
      const int r = e / T::TBN, c = e % T::TBN;
      ws[r * T::TBN + c] =
          n0 + c < n ? static_cast<uint8_t>(w[static_cast<size_t>(pr0 + r) * n + n0 + c])
                     : 0;
    }
  }
}

// Decode a staged stage's raw W bytes once for the whole block into bf16
// pairs (bf16_pair: decode_field's values, exact in bf16), by WORKERS
// threads: word c/2 of row q*BK + i*PK + pp of wd holds plane i of packed
// row q*PK + pp at columns c (low half) and c + 1 (high half).
template <class T, int WORKERS>
__device__ __forceinline__ void decode_f32_stage(unsigned* wd, const uint8_t* ws,
                                                 int idx) {
  static_assert(T::DEC_ITEMS % WORKERS == 0, "decode");
#pragma unroll 4
  for (int it = 0; it < T::DEC_ITEMS / WORKERS; ++it) {
    const int e = idx + it * WORKERS;
    const int pr = e / (T::TBN / 8), c = (e % (T::TBN / 8)) * 8;
    const uint2 b = *reinterpret_cast<const uint2*>(ws + pr * T::TBN + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint4*>(wd + ((pr / PK) * BK + i * PK + pr % PK) * (T::TBN / 2) +
                                c / 2) =
          make_uint4(bf16_pair(b.x, i), bf16_pair(b.x >> 16, i), bf16_pair(b.y, i),
                     bf16_pair(b.y >> 16, i));
  }
}

// A lane's operands for four FMA steps from j0: its rows' X (a warp's four
// rows are F32_XROW floats apart: four bank groups) and, a step, W's two
// runs as bf16 pairs (eight lanes, 64 contiguous bytes).
template <class T>
__device__ __forceinline__ void load_f32_frags(float4 (&a)[T::TM], uint2 (&b)[8],
                                               const float* xs, const unsigned* wd,
                                               int row0, int col0, int j0) {
#pragma unroll
  for (int r = 0; r < T::TM; ++r)
    a[r] = *reinterpret_cast<const float4*>(xs + (row0 + 4 * r) * F32_XROW + j0);
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const unsigned* row = wd + (j0 + jj) * (T::TBN / 2) + col0 / 2;
    b[2 * jj] = *reinterpret_cast<const uint2*>(row);
    b[2 * jj + 1] = *reinterpret_cast<const uint2*>(row + 16);
  }
}

// Four FMA steps: step j0 + jj of every accumulator before step j0 + jj + 1.
// A bf16 pair's halves widen to f32 exactly (low << 16, high & 0xFFFF0000).
template <class T>
__device__ __forceinline__ void fma_f32_frags(float (&acc)[T::TM][8],
                                              const float4 (&a)[T::TM],
                                              const uint2 (&b)[8]) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const uint2 b0 = b[2 * jj], b1 = b[2 * jj + 1];
    const float bv[8] = {__uint_as_float(b0.x << 16), __uint_as_float(b0.x & 0xFFFF0000u),
                         __uint_as_float(b0.y << 16), __uint_as_float(b0.y & 0xFFFF0000u),
                         __uint_as_float(b1.x << 16), __uint_as_float(b1.x & 0xFFFF0000u),
                         __uint_as_float(b1.y << 16), __uint_as_float(b1.y & 0xFFFF0000u)};
#pragma unroll
    for (int r = 0; r < T::TM; ++r) {
      const float av = jj == 0 ? a[r].x : jj == 1 ? a[r].y : jj == 2 ? a[r].z : a[r].w;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av, bv[c], acc[r][c]);
    }
  }
}

// STEPS FMA steps from j into acc in K order, four at a time, the next four
// steps' operands loaded while these compute (two register sets; the loop
// is unrolled by two, sixteen steps, and no more, to keep the code in the
// instruction cache).
template <class T, int STEPS>
__device__ __forceinline__ void fma_f32_steps(float (&acc)[T::TM][8],
                                              const float* xs, const unsigned* wd,
                                              int row0, int col0, int j) {
  float4 a0[T::TM], a1[T::TM];
  uint2 b0[8], b1[8];
  load_f32_frags<T>(a0, b0, xs, wd, row0, col0, j);
#pragma unroll 2
  for (int j0 = j; j0 < j + STEPS; j0 += 8) {
    load_f32_frags<T>(a1, b1, xs, wd, row0, col0, j0 + 4);
    fma_f32_frags<T>(acc, a0, b0);
    if (j0 + 8 < j + STEPS) load_f32_frags<T>(a0, b0, xs, wd, row0, col0, j0 + 8);
    fma_f32_frags<T>(acc, a1, b1);
  }
}

// A stage's FMA steps into acc: one chain an output, or, built with
// -DSMMB_C1_FOLD, each chunk summed from zero and folded into acc with
// __fadd_rn (C1's candidate, chip_smoke.py --c1-candidate).
template <class T>
__device__ __forceinline__ void fma_f32_stage(float (&acc)[T::TM][8], const float* xs,
                                              const unsigned* wd, int row0, int col0) {
#ifdef SMMB_C1_FOLD
#pragma unroll 1
  for (int q = 0; q < F32_SPK / PK; ++q) {
    float part[T::TM][8] = {};
    fma_f32_steps<T, BK>(part, xs, wd, row0, col0, q * BK);
#pragma unroll
    for (int r = 0; r < T::TM; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = __fadd_rn(acc[r][j], part[r][j]);
  }
#else
  fma_f32_steps<T, F32_SBK>(acc, xs, wd, row0, col0, 0);
#endif
}

// f32 mode (f32 FMA on CUDA cores, never TF32): each output element is one
// f32 register taking fmaf(x, w, acc) chunk by chunk (PK packed rows), within
// a chunk plane 0's PK rows, then plane 1's, 2's and 3's, whatever the tile.
// ALIGNED: four more warps (one a scheduler) copy and decode stage s + 1
// while the four FMA warps compute stage s (one named barrier a stage), so
// the copies' issue stalls and the decode's latency leave the FMA warps;
// element loads: the four warps stage, decode and compute in turn between
// __syncthreads.
template <int BM_, int BN_, bool ALIGNED, typename OT>
__global__ void __launch_bounds__(F32Tile<BM_, BN_>::THREADS * (ALIGNED ? 2 : 1))
packed_spmm_float(const float* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ bias, OT* __restrict__ out, int m,
                  int k, int n, int kp, int has_alpha, float alpha) {
  using T = F32Tile<BM_, BN_>;
  extern __shared__ __align__(16) uint8_t smem[];
  unsigned* const wdec = reinterpret_cast<unsigned*>(smem + T::STAGES * T::STAGE);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / T::WN, wn = warp % T::WN;
  const int row0 = wm * 4 * T::TM + lane / 8;  // rows row0 + 4r
  const int col0 = wn * 64 + (lane % 8) * 4;   // columns col0 + c, col0 + 32 + c
  const int m0 = blockIdx.y * BM_, n0 = blockIdx.x * BN_;
  const int nst = kp / F32_SPK;
  const bool active = m0 + wm * 4 * T::TM < m;  // the warp has a row below M

  auto xs = [&](int s) {
    return reinterpret_cast<float*>(smem + (s % T::STAGES) * T::STAGE);
  };
  auto ws = [&](int s) { return smem + (s % T::STAGES) * T::STAGE + T::XSTAGE; };
  auto wd = [&](int s) { return wdec + (s % 2) * T::WDEC; };

  float acc[T::TM][8];
#pragma unroll
  for (int r = 0; r < T::TM; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;

  if (ALIGNED) {
    constexpr int P = T::THREADS;  // copy threads
    if (tid >= T::THREADS) {
      // the copy warps: at step s, stage s + 1's copies go to the slot stage
      // s - 2 held, stage s is decoded into the buffer stage s - 2 used, and
      // barrier 1 hands stage s over once the FMA warps are done with s - 1
      const int idx = tid - T::THREADS;
      load_f32_stage<T, true, P>(xs(0), ws(0), x, w, m0, n0, m, k, n, 0, idx);
      cp_async_commit();
      for (int s = 0; s < nst; ++s) {
        if (s + 1 < nst)
          load_f32_stage<T, true, P>(xs(s + 1), ws(s + 1), x, w, m0, n0, m, k, n,
                                     (s + 1) * F32_SPK, idx);
        cp_async_commit();
        cp_async_wait<1>();
        named_barrier(2, P);  // stage s landed for every copy thread
        decode_f32_stage<T, P>(wd(s), ws(s), idx);
        named_barrier(1, T::THREADS + P);
      }
      return;
    }
    for (int s = 0; s < nst; ++s) {
      named_barrier(1, T::THREADS + P);
      if (active) fma_f32_stage<T>(acc, xs(s), wd(s), row0, col0);
    }
  } else {
#pragma unroll
    for (int s = 0; s < T::STAGES - 1; ++s) {
      if (s < nst)
        load_f32_stage<T, false, T::THREADS>(xs(s), ws(s), x, w, m0, n0, m, k, n,
                                             s * F32_SPK, tid);
      cp_async_commit();
    }
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();
    decode_f32_stage<T, T::THREADS>(wd(0), ws(0), tid);
    for (int s = 0; s < nst; ++s) {
      cp_async_wait<T::STAGES - 3>();
      // stages s and s + 1 landed and stage s decoded; every warp is done with
      // stage s - 1, its ring slot and its decoded buffer
      __syncthreads();
      const int ns = s + T::STAGES - 1;
      if (ns < nst)
        load_f32_stage<T, false, T::THREADS>(xs(ns), ws(ns), x, w, m0, n0, m, k, n,
                                             ns * F32_SPK, tid);
      cp_async_commit();
      if (s + 1 < nst) decode_f32_stage<T, T::THREADS>(wd(s + 1), ws(s + 1), tid);
      if (active) fma_f32_stage<T>(acc, xs(s), wd(s), row0, col0);
    }
    cp_async_wait<0>();
  }

#pragma unroll
  for (int r = 0; r < T::TM; ++r) {
    const int row = m0 + row0 + 4 * r;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + col0 + (j < 4 ? j : 28 + j);
      if (col < n) epilogue(acc[r][j], row, col, n, bias, has_alpha, alpha, out);
    }
  }
}

// Raise a kernel's dynamic shared memory limit to `bytes`, once per device
// (`raised`: the launcher's own flags).
template <typename K>
cudaError_t raise_smem(K kern, int bytes, bool (&raised)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    raised[dev] = true;
  }
  return cudaSuccess;
}

template <int BM_, int BN_, bool ALIGNED, typename OT>
cudaError_t launch_float(const void* x, const void* w, const void* bias,
                         void* out, int m, int k, int n, int kp, int has_alpha,
                         float alpha, cudaStream_t stream) {
  using T = F32Tile<BM_, BN_>;
  auto kern = packed_spmm_float<BM_, BN_, ALIGNED, OT>;
  static bool raised[64] = {};
  const cudaError_t e = raise_smem(kern, T::SMEM, raised);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + BN_ - 1) / BN_, (m + BM_ - 1) / BM_);
  kern<<<grid, T::THREADS * (ALIGNED ? 2 : 1), T::SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(bias), static_cast<OT*>(out), m, k, n, kp,
      has_alpha, alpha);
  return cudaSuccess;
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
  // the ring is above the 48 KB static limit
  static bool raised[64] = {};
  const cudaError_t e = raise_smem(kern, T::SMEM, raised);
  if (e != cudaSuccess) return e;
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

template <bool ALIGNED, typename OT>
cudaError_t dispatch_float(int bm, int bn, const void* x, const void* w,
                           const void* bias, void* out, int m, int k, int n,
                           int kp, int has_alpha, float alpha, cudaStream_t s) {
#define SMMB_F32_TILE(BM_, BN_)                                               \
  if (bm == BM_ && bn == BN_)                                                 \
    return launch_float<BM_, BN_, ALIGNED, OT>(x, w, bias, out, m, k, n, kp,  \
                                               has_alpha, alpha, s);
  SMMB_F32_TILE(16, 64)
  SMMB_F32_TILE(16, 128)
  SMMB_F32_TILE(64, 64)
  SMMB_F32_TILE(64, 128)
#undef SMMB_F32_TILE
  return cudaErrorInvalidValue;
}

template <typename OT>
cudaError_t launch(const void* x, const void* w, const void* bias,
                   const void* scale, void* out, int m, int k, int n, int kp,
                   int x_mode, int bm, int bn, int aligned, int has_alpha,
                   float alpha, cudaStream_t stream) {
  if (x_mode == 0 && aligned)
    return dispatch_float<true, OT>(bm, bn, x, w, bias, out, m, k, n, kp,
                                    has_alpha, alpha, stream);
  if (x_mode == 0)
    return dispatch_float<false, OT>(bm, bn, x, w, bias, out, m, k, n, kp,
                                     has_alpha, alpha, stream);
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
// bm x bn: the tile (16 or 64 x 64 or 128, chosen by the wrapper), in
// every mode. aligned: X and W rows may be copied in 16-byte pieces (K a
// multiple of 16 / XB, N of 16, both pointers 16-byte aligned); else
// element loads.
// Returns the CUDA error of the launch (0 on success).
extern "C" int smmb_packed_spmm(const void* x, const void* w, const void* bias,
                                const void* scale, void* out, int m, int k,
                                int n, int kp, int x_mode, int out_bf16,
                                int bm, int bn, int aligned, int has_alpha,
                                float alpha, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || kp % SUB != 0 || kp * 4 < k ||
      x_mode < 0 || x_mode > 2 || (x_mode == 2 && scale == nullptr) ||
      bm <= 0 || (m + bm - 1) / bm > 65535)
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
