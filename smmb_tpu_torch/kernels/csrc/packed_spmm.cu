// Packed ternary SpMM with fused bias + PReLU for Hopper (sm_90a).
//
//   Y = PReLU(X · W + b, alpha),  W 2-bit packed, group-strided
//
// Replaces the Pallas TPU kernel smmb_tpu/kernels/packed_spmm.py::_kernel
// (pallas_call at packed_spmm.py:388). The layout of W and its decode are
// in packed_decode.cuh, shared with fused_mlp.cu; the cp.async, ldmatrix
// and mma wrappers in mma_sm90.cuh, shared with flash_attention.cu.
//
// Three kernels, by kind of arithmetic and size of M:
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
//   * packed_spmm_mma_wg (bf16 at large M: the 128 x 256 tile, where its
//     grid has 40 blocks or more and rows copy in 16-byte pieces): the
//     warpgroup MMA (wgmma m64n128k16 bf16 -> f32) on Y^T = W^T X^T.
//     - The instruction was settled by a probe on the card
//       (scripts/torch_b1_wgmma_probe.py, H100): a wgmma k16 step into an
//       f32 register gives the bits of mma.sync m16n8k16 on the same
//       operands in the same order (0 of 2 x 1,048,576 outputs differed over
//       128 chained steps, X spread over 2^-24..2^24 and normal, W ternary).
//       So wgmma, with the operands swapped: decoded W is the register A
//       operand (64 W columns an instruction), X's 128 rows the B operand
//       read from shared memory, so each decoded register feeds 128 rows
//       and X crosses shared memory once a warpgroup's two m64 tiles.
//     - Warpgroup 2's first lane is the producer (setmaxnreg 40): a ring of
//       WG_STAGES = 5 K chunks filled by TMA on mbarriers, X as four boxes
//       of TC_PK columns x 128 rows (one a plane run, in the (plane, packed
//       row) K order; 64-byte swizzle, wgmma's descriptor layout), W's raw
//       bytes as one 128-column box a consumer warpgroup (128-byte swizzle:
//       a warp's 32-bit loads of rows 2t.. hit 32 banks). TMA's zero fill
//       takes ragged M, N and K (6912 = 13.5 groups of 512).
//     - Warpgroups 0 and 1 consume (setmaxnreg 232; without it ptxas
//       serialises the wgmmas): 128 W columns each as two m64 tiles. A
//       lane's rows g, g + 8 of both tiles are four adjacent W columns, so
//       one 32-bit load a packed row feeds bf16_pair's decode of all four
//       planes' A fragments; two wgmmas a step, one commit group a step, at
//       most two in flight; a chunk's slot is released when the next
//       chunk's first group is waited on. Its outputs are four adjacent
//       columns of 32 rows: one 8- or 16-byte store a row.
//     - The K walk is packed_spmm_mma's (chunks in order, steps (u, i) in
//       order, one f32 register an output from zero, no split-K, no
//       atomics), so its outputs are the small tiles' bit for bit.
//     - Bound at the prefill's shapes: operations. At 16384 x 2560 x 2560
//       the dense bf16 rate needs 0.217 ms (0.109 counting only density
//       1/2's non-zeros); the body took 0.313 ms, 69% of the dense rate,
//       against the 64 x 128 tile's 0.92 (an H100 80GB HBM3 at 700 W).
//       What is left: one tile a block (no persistent grid), so each
//       block's TMA fill and epilogue are not overlapped with another
//       tile's MMAs, and W's decode in the consumers' issue slots.
//   * Rows that cannot be copied in 16-byte pieces (K or N not a multiple
//     of the piece, or a misaligned pointer) take element loads into the
//     same shared layout (template flag ALIGNED, chosen by the wrapper), in
//     packed_spmm_float and packed_spmm_mma.
//   * Epilogue (every kernel): dequant as __fmul_rn(float(acc), scale),
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

#include <cuda.h>

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

// ---- B1g: a mixture's experts in one launch (expert_spmm_grouped)
//
// X's rows lie in expert order: expert e's rows are offsets[e] ..
// offsets[e + 1], its W the e-th (kp, n) plane of the stacked words, its
// bias the e-th row of an (E, n) table. blockIdx.y counts the row tiles of
// expert 0, then expert 1's, and so on; each block walks `offsets` to find
// its expert (E loads, L1-resident), and the grid's ceil(R / BM) + E row
// tiles bound the sum of ceil(rows_e / BM), so the blocks past the last
// tile exit. Nothing of the routing reaches the host.
//
// The tile and its K walk are packed_spmm_mma<BM, 128, false, ALIGNED, OT>'s
// in bf16, written out again here so that B1's kernels stay as they are:
// chunks of TC_PK packed rows in order, MMA steps (u, i) in order, one f32
// register an output from zero, the same epilogue. So row r of expert e is
// B1's row on the same X row and plane, bit for bit.
template <int BM_, bool ALIGNED, typename OT>
__global__ void __launch_bounds__(TcTile<BM_, 128, false>::THREADS)
expert_spmm_grouped(const uint8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ bias, const int* __restrict__ offsets,
                    OT* __restrict__ out, int experts, int k, int n, int kp,
                    int has_alpha, float alpha) {
  using T = TcTile<BM_, 128, false>;
  extern __shared__ __align__(16) uint8_t smem[];

  int tile = blockIdx.y, e = 0, r0 = 0, m = 0;
  for (; e < experts; ++e) {
    r0 = offsets[e];
    m = offsets[e + 1] - r0;
    const int tiles = (m + BM_ - 1) / BM_;
    if (tile < tiles) break;
    tile -= tiles;
  }
  if (e == experts) return;
  x += static_cast<size_t>(r0) * k * 2;
  w += static_cast<size_t>(e) * kp * n;
  if (bias != nullptr) bias += static_cast<size_t>(e) * n;
  out += static_cast<size_t>(r0) * n;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wn0 = warp * T::FN * 8;
  const int m0 = tile * BM_, n0 = blockIdx.x * 128;
  const int nch = kp / TC_PK;

  float acc[T::FM][T::FN][4];
#pragma unroll
  for (int f = 0; f < T::FM; ++f)
#pragma unroll
    for (int j = 0; j < T::FN; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[f][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < nch)
      load_chunk<T, ALIGNED>(smem + s * T::STAGE, smem + s * T::STAGE + T::XSTAGE,
                             x, w, m0, n0, m, k, n, s * TC_PK, tid);
    cp_async_commit();
  }

  for (int c = 0; c < nch; ++c) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();
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
      unsigned wb[T::FN][2];
#pragma unroll
      for (int j = 0; j < T::FN; ++j) {
        const int col = wn0 + j * 8 + g;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = u * T::KROWS + h * (T::KROWS / 2) + 2 * t;
          wb[j][h] = static_cast<unsigned>(ws[w_off<T>(r, col)]) |
                     (static_cast<unsigned>(ws[w_off<T>(r + 1, col)]) << 8);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        unsigned a[T::FM][4];
#pragma unroll
        for (int f = 0; f < T::FM; ++f)
          ldmatrix_x4(a[f], xs + (f * 16 + (lane & 15)) * T::XROW +
                                i * T::XRUN + u * T::KROWS * T::XB +
                                (lane >> 4) * 16);
#pragma unroll
        for (int j = 0; j < T::FN; ++j) {
          const unsigned b0 = bf16_pair(wb[j][0], i);
          const unsigned b1 = bf16_pair(wb[j][1], i);
#pragma unroll
          for (int f = 0; f < T::FM; ++f) mma(acc[f][j], a[f], b0, b1);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int f = 0; f < T::FM; ++f)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + f * 16 + g + 8 * h;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < T::FN; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int col = n0 + wn0 + j * 8 + 2 * t + q;
          if (col < n) epilogue(acc[f][j][2 * h + q], row, col, n, bias, has_alpha, alpha, out);
        }
    }
}

template <int BM_, bool ALIGNED, typename OT>
cudaError_t launch_grouped(const void* x, const void* w, const void* bias,
                           const void* offsets, void* out, int rows, int k, int n,
                           int kp, int experts, int has_alpha, float alpha,
                           cudaStream_t stream) {
  using T = TcTile<BM_, 128, false>;
  auto kern = expert_spmm_grouped<BM_, ALIGNED, OT>;
  static bool raised[64] = {};
  const cudaError_t e = raise_smem(kern, T::SMEM, raised);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + 127) / 128, (rows + BM_ - 1) / BM_ + experts);
  kern<<<grid, T::THREADS, T::SMEM, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(offsets),
      static_cast<OT*>(out), experts, k, n, kp, has_alpha, alpha);
  return cudaSuccess;
}

template <typename OT>
cudaError_t dispatch_grouped(int bm, int aligned, const void* x, const void* w,
                             const void* bias, const void* offsets, void* out,
                             int rows, int k, int n, int kp, int experts,
                             int has_alpha, float alpha, cudaStream_t s) {
#define SMMB_GROUPED(BM_, AL_)                                                   \
  if (bm == BM_ && (aligned != 0) == AL_)                                        \
    return launch_grouped<BM_, AL_, OT>(x, w, bias, offsets, out, rows, k, n, kp, \
                                        experts, has_alpha, alpha, s);
  SMMB_GROUPED(16, true)
  SMMB_GROUPED(16, false)
  SMMB_GROUPED(64, true)
  SMMB_GROUPED(64, false)
#undef SMMB_GROUPED
  return cudaErrorInvalidValue;
}

// ---- bf16 mode at large M: warpgroup MMA fed by TMA (packed_spmm_mma_wg)

constexpr int WG_BM = 128;       // X rows a tile (wgmma N)
constexpr int WG_BN = 256;       // W columns a tile: 128 a consumer warpgroup
constexpr int WG_STAGES = 5;     // TMA ring depth (K chunks of TC_PK packed rows)
constexpr int WG_XPLANE = WG_BM * TC_PK * 2;          // one plane run of X: 8 KB
constexpr int WG_WBOX = TC_PK * 128;                  // one warpgroup's W bytes: 4 KB
constexpr int WG_STAGE = 4 * WG_XPLANE + 2 * WG_WBOX;  // 40 KB
constexpr int WG_THREADS = 384;  // warpgroups 0, 1: consumers; 2: the TMA producer
constexpr int WG_SMEM = WG_STAGES * WG_STAGE + 2 * WG_STAGES * 8 + 1024;  // + barriers, alignment

__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// a 2-D box of `map` at (c0 innermost, c1) into shared memory at dst,
// completing on `bar`; the parts past the tensor's edges read as zero
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map, int c0,
                                         int c1, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma's shared-memory descriptor of one X plane run (rows of 64 bytes,
// 64-byte swizzle as TMA wrote them; 8-row groups 512 bytes apart; the
// leading offset, unused under a swizzle, is 1)
__device__ __forceinline__ uint64_t x_desc(unsigned addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

// D(64 x 128, f32) += A(64 x 16, bf16, registers) * B(16 x 128, bf16, desc)
__device__ __forceinline__ void wgmma_128(float (&d)[64], const unsigned (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// keep the compiler from moving the computation of registers that an
// asynchronous wgmma reads or writes across the asm statements around it
template <typename R, int N>
__device__ __forceinline__ void pin(R (&r)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if constexpr (std::is_same<R, float>::value)
      asm volatile("" : "+f"(r[e])::"memory");
    else
      asm volatile("" : "+r"(r[e])::"memory");
  }
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                            *reinterpret_cast<const unsigned*>(&hi));
}

// The producer: one lane keeps WG_STAGES K chunks in flight by TMA, each
// chunk's X as four plane runs of TC_PK columns (64-byte swizzle) and W's
// raw bytes as one box a consumer warpgroup (128-byte swizzle), on the
// chunk's `full` barrier; a slot is filled again once both warpgroups have
// released it on its `empty` barrier.
__device__ __forceinline__ void wg_produce(const CUtensorMap* tmx, const CUtensorMap* tmw,
                                           unsigned base, unsigned full0, unsigned empty0,
                                           int m0, int n0, int nch) {
  for (int c = 0; c < nch; ++c) {
    const int s = c % WG_STAGES;
    if (c >= WG_STAGES) mbar_wait(empty0 + 8 * s, ((c / WG_STAGES) & 1) ^ 1);
    const unsigned st = base + s * WG_STAGE, bar = full0 + 8 * s;
    mbar_expect_tx(bar, WG_STAGE);
    const int pr0 = c * TC_PK, col0 = (pr0 / SUB) * GROUP_ROWS + pr0 % SUB;
#pragma unroll
    for (int i = 0; i < 4; ++i) tma_load(st + i * WG_XPLANE, tmx, col0 + i * SUB, m0, bar);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      tma_load(st + 4 * WG_XPLANE + h * WG_WBOX, tmw, n0 + 128 * h, pr0, bar);
  }
}

// A consumer warpgroup q: W columns 128q..128q+127 of the tile as two m64
// tiles. Lane (g, t) of its warp wq holds rows g and g + 8 of both tiles:
// W columns 32wq + 4g + {0, 1} (tile 0) and + {2, 3} (tile 1), so one
// 32-bit load a packed row brings its four columns' bytes, decoded in
// registers into the A fragments of all four planes. Its outputs are four
// adjacent columns of 32 rows: one 8- or 16-byte store a row.
template <typename OT>
__device__ __forceinline__ void wg_consume(const uint8_t* smem_raw, unsigned base,
                                           unsigned full0, unsigned empty0, int m0, int n0,
                                           int nch, int q, int wq, int lane,
                                           const float* __restrict__ bias,
                                           OT* __restrict__ out, int m, int n, int has_alpha,
                                           float alpha) {
  const int g = lane / 4, t = lane % 4;
  const int cb = 32 * wq + 4 * g;  // this lane's first column in its warpgroup's box
  float acc[2][64];
#pragma unroll
  for (int T = 0; T < 2; ++T)
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[T][e] = 0.f;
  pin(acc[0]);
  pin(acc[1]);

  for (int c = 0; c < nch; ++c) {
    const int s = c % WG_STAGES;
    mbar_wait(full0 + 8 * s, (c / WG_STAGES) & 1);
    const unsigned st = base + s * WG_STAGE;
    const uint8_t* wbox =
        smem_raw + (st + 4 * WG_XPLANE + q * WG_WBOX - smem_addr(smem_raw));
#pragma unroll
    for (int u = 0; u < TC_PK / 16; ++u) {
      // packed rows r, r + 1 (k 2t, 2t + 1) and r + 8, r + 9 (k 2t + 8, 2t + 9)
      // of this lane's four columns; byte (row, col) of the box lies at
      // row * 128 + ((col / 16) ^ (row % 8)) * 16 + col % 16
      unsigned wr[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 16 * u + 2 * t + (j & 1) + 8 * (j >> 1);
        wr[j] = *reinterpret_cast<const unsigned*>(
            wbox + r * 128 + (((cb >> 4) ^ (r & 7)) << 4) + (cb & 15));
      }
      // two columns' bytes of rows (r, r + 1) a 16-bit half each
      const unsigned p01 = __byte_perm(wr[0], wr[1], 0x5140);
      const unsigned p23 = __byte_perm(wr[0], wr[1], 0x7362);
      const unsigned q01 = __byte_perm(wr[2], wr[3], 0x5140);
      const unsigned q23 = __byte_perm(wr[2], wr[3], 0x7362);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        unsigned a0[4] = {bf16_pair(p01, i), bf16_pair(p01 >> 16, i), bf16_pair(q01, i),
                          bf16_pair(q01 >> 16, i)};
        unsigned a1[4] = {bf16_pair(p23, i), bf16_pair(p23 >> 16, i), bf16_pair(q23, i),
                          bf16_pair(q23 >> 16, i)};
        const uint64_t desc = x_desc(st + i * WG_XPLANE + u * 32);
        pin(a0);
        pin(a1);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        wgmma_128(acc[0], a0, desc);
        wgmma_128(acc[1], a1, desc);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        // the first step of chunk c done waiting: chunk c - 1's steps are done
        if (u == 0 && i == 0 && c > 0 && lane == 0)
          mbar_arrive(empty0 + 8 * ((c - 1) % WG_STAGES));
      }
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  pin(acc[0]);
  pin(acc[1]);

  // acc[T][4j + e + 2h] is W column cb + 2T + h, X row 8j + 2t + e
  const int col = n0 + 128 * q + cb;
  if (col >= n) return;  // n is a multiple of 16: four columns in or out
  float bv[4] = {0.f, 0.f, 0.f, 0.f};
  if (bias != nullptr) {
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4) bv[c4] = bias[col + c4];
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = m0 + 8 * j + 2 * t + e;
      if (row >= m) continue;
      float v[4];
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) {
        float y = acc[c4 >> 1][4 * j + e + 2 * (c4 & 1)];
        if (bias != nullptr) y = __fadd_rn(y, bv[c4]);
        if (has_alpha && !(y > 0.f)) y = __fmul_rn(alpha, y);
        v[c4] = y;
      }
      store4(out + static_cast<size_t>(row) * n + col, v);
    }
}

// bf16 mode, Y^T = W^T X^T on the warpgroup MMA: a 128 x 256 output tile,
// K chunks of TC_PK packed rows in order and, in a chunk, MMA steps (u, i)
// in order (packed rows 16u..16u+15 of plane i), one f32 register an output
// from zero: packed_spmm_mma's K walk, so its bits (wgmma's k16 step rounds
// as mma.sync's, scripts/torch_b1_wgmma_probe.py). Warpgroups 0 and 1
// consume, warpgroup 2's first lane produces; setmaxnreg moves registers
// from the producer to the consumers (ptxas serialises the wgmmas without
// them).
template <typename OT>
__global__ void __launch_bounds__(WG_THREADS, 1)
packed_spmm_mma_wg(const __grid_constant__ CUtensorMap tmx,
                   const __grid_constant__ CUtensorMap tmw, const float* __restrict__ bias,
                   OT* __restrict__ out, int m, int n, int kp, int has_alpha, float alpha) {
  extern __shared__ uint8_t smem_raw[];
  // swizzled boxes want 1024-byte alignment
  const unsigned base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const unsigned full0 = base + WG_STAGES * WG_STAGE, empty0 = full0 + WG_STAGES * 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * WG_BM, n0 = blockIdx.x * WG_BN;
  const int nch = kp / TC_PK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0) wg_produce(&tmx, &tmw, base, full0, empty0, m0, n0, nch);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    wg_consume<OT>(smem_raw, base, full0, empty0, m0, n0, nch, warp / 4, warp % 4, lane, bias,
                   out, m, n, has_alpha, alpha);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                           12000, cudaEnableDefault, &q);
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 2-D row-major tensor (rows x cols elements of `bytes` each) cut in
// boxes of box_rows x box_cols, swizzled; the edges read as zero
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, int bytes, const void* ptr,
               uint64_t rows, uint64_t cols, uint32_t box_cols, uint32_t box_rows,
               CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename OT>
cudaError_t launch_wide(const void* x, const void* w, const void* bias, void* out, int m,
                        int k, int n, int kp, int has_alpha, float alpha,
                        cudaStream_t stream) {
  CUtensorMap tmx, tmw;
  if (!encode_2d(&tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, m, k, TC_PK, WG_BM,
                 CU_TENSOR_MAP_SWIZZLE_64B) ||
      !encode_2d(&tmw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, kp, n, 128, TC_PK,
                 CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  auto kern = packed_spmm_mma_wg<OT>;
  static bool raised[64] = {};
  const cudaError_t e = raise_smem(kern, WG_SMEM, raised);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + WG_BN - 1) / WG_BN, (m + WG_BM - 1) / WG_BM);
  kern<<<grid, WG_THREADS, WG_SMEM, stream>>>(tmx, tmw, static_cast<const float*>(bias),
                                              static_cast<OT*>(out), m, n, kp, has_alpha,
                                              alpha);
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
  if (x_mode == 1 && bm == WG_BM && bn == WG_BN)  // TMA wants 16-byte rows
    return aligned ? launch_wide<OT>(x, w, bias, out, m, k, n, kp, has_alpha, alpha, stream)
                   : cudaErrorInvalidValue;
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
// every mode, and 128 x 256 in bf16 (the wide body; aligned calls only).
// aligned: X and W rows may be copied in 16-byte pieces (K a multiple of
// 16 / XB, N of 16, both pointers 16-byte aligned); else element loads.
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

// B1g: x bf16 (rows, k) in expert order, w int8 (experts, kp, n), bias f32
// (experts, n) or null, offsets int32 (experts + 1) on the card with
// offsets[experts] = rows. bm: 16 or 64 (the columns' tile is 128).
// out_bf16, aligned, has_alpha, alpha: as smmb_packed_spmm's.
extern "C" int smmb_expert_spmm_grouped(const void* x, const void* w, const void* bias,
                                        const void* offsets, void* out, int rows, int k,
                                        int n, int kp, int experts, int out_bf16, int bm,
                                        int aligned, int has_alpha, float alpha,
                                        void* stream) {
  if (rows <= 0 || n <= 0 || k <= 0 || experts <= 0 || kp % SUB != 0 || kp * 4 < k ||
      (bm != 16 && bm != 64) || (rows + bm - 1) / bm + experts > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      out_bf16 ? dispatch_grouped<__nv_bfloat16>(bm, aligned, x, w, bias, offsets, out, rows,
                                                 k, n, kp, experts, has_alpha, alpha, s)
               : dispatch_grouped<float>(bm, aligned, x, w, bias, offsets, out, rows, k, n,
                                         kp, experts, has_alpha, alpha, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
