// Fused packed-ternary kernels of the LM decode and prefill path for Hopper
// (sm_90a): B3 fused_norm_qkv, B7 fused_norm_qkv_quant, B6 fused_mlp and B5
// fused_block_tail.
//
// Replaces the Pallas TPU kernels of smmb_tpu/kernels/fused_mlp.py:
//   B3 fused_norm_qkv   (_norm_qkv_kernel, pallas_call at :332)
//        y = (rmsnorm(x; g, eps) . Wqkv) * scale[col] + bias[col]
//   B7 fused_norm_qkv_quant (_norm_qkv_quant_kernel, pallas_call at :489)
//        B3's y; q = y[:, :d]; per (row, KV head h, plane k|v) of the f32 y:
//        s = absmax / 127, codes = round_half_even(y / (s > 0 ? s : 1)),
//        written in the per-head [k_h | v_h] interleave of the int8 cache
//   B6 fused_mlp        (_kernel, pallas_call at :195)
//        y = (PReLU(s_up (x . Wup) + b_up) . Wdown) * s_down + b_down
//   B5 fused_block_tail (_tail_kernel, pallas_call at :707)
//        resid = x + s_wo (att . Wo) + b_wo;  h = rmsnorm(resid; g2, eps)
//        y = resid + s_down (PReLU(s_up (h . Wup) + b_up) . Wdown) + b_down
//
// What bounds them on this card. At the decode shapes (M = 1..32 rows, K =
// 1024) every product is a weight stream: at M = 1, B3 reads 0.786 MB of
// packed Wqkv (1024 x 3072 at 2 bits a weight), 0.248 us at 3.35 TB/s, and
// B5 2.4 MB. What a call costs on the device is latency: the launch, an L2
// read of the weights, the staged rows and a 128-long FMA chain an output.
// So the kernels spread the weight bytes over many blocks, keep each
// block's chain short, and have a block's weight bytes in flight before it
// stages its rows. CUDA cores only: tensor cores would change the sums.
//   * A product item is (row tile, 32 output columns). A row tile is MT
//     rows (MT = 1 for M = 1, else 8), staged in shared memory in f32,
//     already rounded to the compute dtype (the TPU kernel's cast before
//     each dot). The 8 warps of a 256-thread block take the 8 eighths of K
//     (warp w: packed rows [w Kp/8, (w+1) Kp/8)), a lane one column; each
//     warp sums its rows in order, the planes inside each, with f32 FMA
//     (never TF32), and the block adds the 8 partial sums in warp order.
//     The order of every sum depends on K and these constants only, never
//     on M or on which rows share the call, so a row's result is bitwise
//     the same at M = 1 and M = 8 (the speculative-decoding contract,
//     smmb_tpu/kernels/fused_mlp.py:645-649). These are the sums of the
//     port's first kernels (128-column blocks, a lane 4 columns read as one
//     word), so every output is bitwise theirs. There are no atomics.
//   * A warp's weight rows arrive by 16-byte cp.async pieces of 16 packed
//     rows in a 4-deep ring (a 1024-row K in flight at once); a weight's
//     float is built in the mantissa instead of by an int-to-float
//     conversion, the same value.
//   * B3 and B7 are one body, qkv_items_kernel<MT, QUANT>: a plain launch of
//     one item a block, N / 32 blocks a row tile (96 at the LM's 1024 x
//     3072, one wave on 132 SMs, where the first kernel ran 24 blocks of 128
//     columns). A block issues its weight pieces first, then stages x in f32
//     and takes its rows' RMSNorm (recomputed per block, in a fixed order)
//     while they land. B7's blocks over the first d columns are B3's,
//     writing q. A K/V span (one plane of one KV head, hd columns) is one
//     thread block cluster of c = 8 blocks (4 where hd / 32 is not a
//     multiple of 8), each summing hd / c of its columns in 32-column items
//     and keeping its f32 y in shared memory. A block writes its rows'
//     absmax into every block of the cluster (distributed shared memory),
//     the cluster syncs once, and every block takes the maximum of the c
//     values (exact in any order). Each
//     block then writes the codes of its own columns with the IEEE
//     __fdiv_rn and __float2int_rn (round half to even, as jnp.round), never
//     roundf, a bare cast or a multiply by 1/127; the cluster's first block
//     writes the scale. A cluster shares the span's absmax without a
//     workspace, a grid sync or a cooperative launch; Hopper has them.
//   * The TPU kernels carry the MLP's sum across a sequential grid axis of
//     hidden slabs. Blocks on Hopper run in no order, so the hidden axis is
//     cut into tiles of 128 units (32 packed rows of each of the 4 planes of
//     one group); each tile's down product is one f32 partial, and the
//     partials are added in ascending tile order.
//   * B6 and B5 are one cooperative launch each (cudaLaunchCooperativeKernel)
//     of as many blocks as fit the card at once, capped at the largest
//     phase's item count. Their phases (B5: wo, up, down, sum; B6: up, down,
//     sum) are separated by grid syncs; each phase is a list of items fixed
//     by the shapes, which block b takes in the contiguous range b/grid of,
//     so no result depends on the grid size. Before each grid sync a block
//     issues the weight copies of its first item of the next phase. The
//     hidden layer goes to an f32 workspace, already in the compute dtype,
//     between the up and down phases. Workspaces come from the wrapper.
//   * B5's wo phase ends at a grid sync, so the RMSNorm over full rows sees
//     every column before any up item reads h. Each block recomputes the
//     norm of its rows from the f32 residual in a fixed order.
//   * Rounding follows the JAX order: cast to the compute dtype before each
//     product, scale after the product on the f32 sum, then the bias; the
//     epilogues use __fmul_rn/__fadd_rn so no FMA contraction changes the
//     rounding; rsqrt is the IEEE __frsqrt_rn (not the approximate rsqrtf).
//   * Kernels allocate nothing, launch on the caller's stream and do not
//     synchronise; each C entry returns the CUDA error of its launch (a
//     refused cooperative or cluster launch included).

#include <cooperative_groups.h>

#include "mma_sm90.cuh"
#include "packed_decode.cuh"

namespace cg = cooperative_groups;

using namespace smmb_packed;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;  // the fixed split of K inside a block
constexpr int HT_PACKED = 32;        // packed rows of a hidden tile per plane
constexpr int HT = 4 * HT_PACKED;    // hidden units per tile
constexpr int MAX_SMEM = 232448;     // dynamic shared memory a block may use

__device__ __forceinline__ float load_elem(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_elem(void* p, size_t i, float v,
                                           int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// the value a product sees: f32 as is, or rounded to bf16 (held in f32)
__device__ __forceinline__ float to_compute(float v, int cbf16) {
  return cbf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// inv[r] = rsqrt(sum_k v[r][k]^2 / d + eps) for the MT staged rows, in an
// order that depends on d only: thread t sums columns t, t + 256, ...; a
// fixed shuffle tree gives lane 0 its warp's sum; warp sums add in order.
template <int MT>
__device__ void row_rms(const float* v, int d, float eps, float* inv,
                        float* scratch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = 0; r < MT; ++r) {
    float ss = 0.f;
    for (int k = threadIdx.x; k < d; k += THREADS) {
      const float x = v[r * d + k];
      ss = fmaf(x, x, ss);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
    if (lane == 0) scratch[warp * MT + r] = ss;
  }
  __syncthreads();
  if (threadIdx.x < MT) {
    const int r = threadIdx.x;
    float s = scratch[r];
    for (int wi = 1; wi < WARPS; ++wi) s = __fadd_rn(s, scratch[wi * MT + r]);
    inv[r] = __frsqrt_rn(__fadd_rn(__fdiv_rn(s, static_cast<float>(d)), eps));
  }
  __syncthreads();
}

// ------------------------------------------------- B6 / B5: one launch
// A call is one cooperative launch; its work is a list of items in phases
// separated by grid syncs. The items of a row tile depend on the shapes
// alone (k, a, dm, h, kout): a row tile of M multiplies them, and the grid
// only says which block takes an item (Range). Every sum is the one the
// earlier multi-launch kernels took, so the outputs are bitwise theirs:
//   wo (B5)  item = (row tile, ITEM_COLS columns of Wo): the 8 warps take
//            the 8 eighths of K, a lane one column (chunk_dot), the block
//            adds the eighths in warp order, resid = (x + s_wo acc) + b_wo;
//   up       item = (row tile, ITEM_COLS columns of Wup) on the staged x
//            rows (B6) or rmsnorm(resid) rows (B5, recomputed per block as
//            before): up = PReLU(s_up acc + b_up) in the compute dtype, to
//            the f32 workspace `up`;
//   down     item = (row tile, hidden tile t of 128 units, DOWN_COLS output
//            columns): a thread's column is one chain over the tile's 32
//            packed rows of Wdown (j-major, planes i-minor) into ws[t];
//   sum      item = (row tile, SUM_COLS columns): the tiles' partials in
//            ascending tile order, then the epilogue.
constexpr int ITEM_COLS = 32;     // columns of a product item: one a lane
constexpr int PIECE_ROWS = 16;    // packed rows of a warp's cp.async piece
constexpr int PIECE_BYTES = PIECE_ROWS * ITEM_COLS;  // 16 bytes a lane
constexpr int RING = 4;           // pieces of a warp in flight
constexpr int RING_BYTES = WARPS * RING * PIECE_BYTES;
constexpr int DOWN_COLS = THREADS;  // columns of a down item: one a thread
constexpr int SUM_COLS = 32;        // columns of a sum item: a warp a row, a lane a column
constexpr int MAX_CLUSTER = 8;      // blocks of a K/V span's cluster (B7): the portable most
constexpr int HEAD_COLS = 4 * ITEM_COLS;  // B7's head widths are multiples: 4 items or more
constexpr int STAGE_BATCH = 8;      // row loads a thread has in flight while staging
// tile partials a thread has in flight while summing: all 32 of H = 4096 at
// one row, fewer at 8 rows, where the registers are short
__host__ __device__ constexpr int sum_batch(int mt) { return mt == 1 ? 32 : 8; }

struct MlpArgs {
  const void* att;  // B5: (m, a) attention mix
  const void* x;    // B6: (m, k) input rows; B5: (m, dm) residual stream
  int att_bf16, x_bf16;
  const int8_t* wo;  // B5: packed (a, dm)
  const float *s_wo, *b_wo, *g2;
  const int8_t* wu;  // packed (k, h)
  const float *s_up, *b_up;
  const int8_t* wd;  // packed (h, kout), rows ldd bytes apart
  const float *s_down, *b_down;
  float* resid;  // B5: (m, dm) f32
  float* up;     // (m, h) f32, already in the compute dtype
  float* ws;     // (h / HT, m, kout) f32 partials
  void* out;     // (m, kout) in x's dtype
  int m, a, k, h, kout, ldd;
  float alpha, eps;
  int cbf16;
};

// items of one row tile in each phase (kout = dm for B5)
struct Items {
  int wo, up, down, sum;
};
__host__ __device__ inline Items items_per_tile(int h, int kout, bool tail) {
  return {tail ? kout / ITEM_COLS : 0, h / ITEM_COLS,
          h / HT * ((kout + DOWN_COLS - 1) / DOWN_COLS), (kout + SUM_COLS - 1) / SUM_COLS};
}
// field i of a packed byte as a float: static_cast<float>(decode_field(b, i))
// without the int-to-float conversion. The field, its high bit flipped, is
// placed in the mantissa of 1.5 * 2^23 at bit 2i; one exact FMA scales it
// back and takes the offset off ((f ^ 2) - 2 is the two's-complement value).
__device__ __forceinline__ float field_value(unsigned b, int i) {
  const unsigned f = ((b & (3u << (2 * i))) ^ (2u << (2 * i))) | 0x4B400000u;
  const float scale = i == 0 ? 1.f : i == 1 ? 0.25f : i == 2 ? 0.0625f : 0.015625f;
  const float offset = i == 0   ? -12582914.f
                       : i == 1 ? -3145730.f
                       : i == 2 ? -786434.f
                                : -196610.f;  // -(1.5 * 2^23 / 4^i + 2)
  return __fmaf_rn(__uint_as_float(f), scale, offset);
}

__device__ __forceinline__ float lane_of(const float4& v, int t) {
  return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
}

// elements i..i+3 of an f32 or bf16 array as f32 (bf16 widened exactly, as
// __bfloat162float), read through L2: the array may have been written
// earlier in the same launch
__device__ __forceinline__ float4 load_quad(const void* p, size_t i, int bf16) {
  if (!bf16) return __ldcg(reinterpret_cast<const float4*>(static_cast<const float*>(p) + i));
  const uint2 u =
      __ldcg(reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p) + i));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// MT rows of a (m, k) matrix from row m0 into a[r][k], in f32 rounded to
// the compute dtype (zeros past m), with STAGE_BATCH 4-element loads of
// each thread in flight before any is stored; src's rows are 16-byte aligned
template <int MT>
__device__ void stage_quads(float* a, const void* src, int src_bf16, int m, int m0,
                            int k, int cbf16) {
  const int quads = MT * k / 4;
  for (int q0 = threadIdx.x; q0 < quads; q0 += THREADS * STAGE_BATCH) {
    float4 v[STAGE_BATCH];
#pragma unroll
    for (int b = 0; b < STAGE_BATCH; ++b) {
      const int q = q0 + b * THREADS;
      v[b] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q < quads && m0 + 4 * q / k < m)
        v[b] = load_quad(src, static_cast<size_t>(m0) * k + 4 * q, src_bf16);
    }
#pragma unroll
    for (int b = 0; b < STAGE_BATCH; ++b) {
      const int q = q0 + b * THREADS;
      if (q < quads)
        *reinterpret_cast<float4*>(a + 4 * q) =
            make_float4(to_compute(v[b].x, cbf16), to_compute(v[b].y, cbf16),
                        to_compute(v[b].z, cbf16), to_compute(v[b].w, cbf16));
    }
  }
  __syncthreads();
}

// the product sums over one ITEM_COLS-column chunk of a (k, n) plane: warp
// w takes packed rows [w Kp/8, (w+1) Kp/8), lane l column c0 + l, one fmaf
// chain per staged row over the packed rows in order and the planes inside
// each. The warp's rows arrive by 16-byte cp.async pieces of PIECE_ROWS
// rows (lane l copies half l % 2 of row l / 2) in a RING-deep ring, the
// first RING - 1 issued by chunk_start. The partials go to red[w][r][l];
// red aliases the ring.
// the first RING - 1 pieces of a warp's rows, issued before the block
// stages its rows so that both reads are in flight at once
__device__ __forceinline__ void chunk_start(int k, const int8_t* __restrict__ w, int n,
                                            int c0, uint8_t* ring) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kp = k / 4, p0 = warp * kp / WARPS;
  const int pieces = kp / WARPS / PIECE_ROWS;  // k % 512 == 0
  uint8_t* mine = ring + warp * RING * PIECE_BYTES;
  const int8_t* src =
      w + static_cast<size_t>(p0 + (lane >> 1)) * n + c0 + (lane & 1) * 16;
  const size_t step = static_cast<size_t>(PIECE_ROWS) * n;
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) {
    if (s < pieces)
      smmb_mma::cp_async16(mine + s * PIECE_BYTES + lane * 16, src + s * step, true);
    smmb_mma::cp_async_commit();
  }
}

template <int MT>
__device__ __forceinline__ void chunk_dot(const float* act, int k,
                                          const int8_t* __restrict__ w, int n,
                                          int c0, uint8_t* ring, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kp = k / 4, p0 = warp * kp / WARPS;
  const int pieces = kp / WARPS / PIECE_ROWS;
  uint8_t* mine = ring + warp * RING * PIECE_BYTES;
  const int8_t* src =
      w + static_cast<size_t>(p0 + (lane >> 1)) * n + c0 + (lane & 1) * 16;
  const size_t step = static_cast<size_t>(PIECE_ROWS) * n;
  float acc[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = 0.f;
  for (int j = 0; j < pieces; ++j) {
    const int nx = j + RING - 1;
    if (nx < pieces)
      smmb_mma::cp_async16(mine + (nx % RING) * PIECE_BYTES + lane * 16,
                           src + nx * step, true);
    smmb_mma::cp_async_commit();
    smmb_mma::cp_async_wait<RING - 1>();  // piece j has landed
    __syncwarp();
    const uint8_t* piece = mine + (j % RING) * PIECE_BYTES;
    const int pr = p0 + j * PIECE_ROWS;
#pragma unroll(MT == 1 ? 4 : 1)  // 8 rows: no hoisting across steps, no spills
    for (int q = 0; q < PIECE_ROWS; q += 4) {
      const int kb = logical_row(pr + q, 0);  // rows pr+q..pr+q+3 share a group
      float wv[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const unsigned b = piece[(q + t) * ITEM_COLS + lane];
#pragma unroll
        for (int i = 0; i < 4; ++i) wv[t][i] = field_value(b, i);
      }
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        float4 xa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          xa[i] = *reinterpret_cast<const float4*>(act + r * k + kb + i * SUB);
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[r] = fmaf(lane_of(xa[i], t), wv[t][i], acc[r]);
      }
    }
    __syncwarp();  // the warp is done with piece j before its slot refills
  }
  __syncthreads();  // every warp is done with the ring
#pragma unroll
  for (int r = 0; r < MT; ++r) red[(warp * MT + r) * ITEM_COLS + lane] = acc[r];
  __syncthreads();
}

// the 8 warps' partials of output (r, c) of a chunk, added in warp order
template <int MT>
__device__ __forceinline__ float chunk_sum(const float* red, int r, int c) {
  float s = red[r * ITEM_COLS + c];
#pragma unroll
  for (int wi = 1; wi < WARPS; ++wi) s = __fadd_rn(s, red[(wi * MT + r) * ITEM_COLS + c]);
  return s;
}

// shared memory of a block: MT staged rows of width kmax, the warps' rings
// (red aliases them), the norm's inverse and scratch; the down phase reuses
// the front for its (MT, HT) up tile and HT_PACKED x DOWN_COLS weight bytes
template <int MT>
size_t items_smem_bytes(int kmax) {
  return sizeof(float) * (static_cast<size_t>(MT) * kmax + MT + WARPS * MT) + RING_BYTES;
}

// output (row, col): the tiles' partials in ascending tile order (SUM_BATCH
// loads in flight), then the epilogue: B6 s_down acc + b_down, B5 (resid +
// s_down acc) + b_down, in x's dtype
template <bool TAIL, int SUM_BATCH>
__device__ __forceinline__ void sum_tiles(const MlpArgs& p, int row, int col, int tiles) {
  const size_t o = static_cast<size_t>(row) * p.kout + col;
  const size_t plane = static_cast<size_t>(p.m) * p.kout;
  const float base = TAIL ? __ldcg(p.resid + o) : 0.f, bias = p.b_down[col];
  float s = 0.f;
  for (int t0 = 0; t0 < tiles; t0 += SUM_BATCH) {
    float v[SUM_BATCH];
#pragma unroll
    for (int b = 0; b < SUM_BATCH; ++b)
      v[b] = t0 + b < tiles ? __ldcg(p.ws + (t0 + b) * plane + o) : 0.f;
#pragma unroll
    for (int b = 0; b < SUM_BATCH; ++b)
      if (t0 + b < tiles) s = t0 + b == 0 ? v[b] : __fadd_rn(s, v[b]);
  }
  const float sd = *p.s_down;
  const float v = TAIL ? __fadd_rn(__fadd_rn(base, __fmul_rn(s, sd)), bias)
                       : __fadd_rn(__fmul_rn(s, sd), bias);
  store_elem(p.out, o, v, p.x_bf16);
}

// the HT_PACKED x DOWN_COLS bytes of Wdown a down item reads: packed rows
// g*128 + pb + j (j < 32) of hidden tile t = 4 g + pb / 32, columns c0 ..
// c0 + DOWN_COLS (16-byte copies past ldd skipped), one commit group
__device__ __forceinline__ void down_start(const MlpArgs& p, int t, int c0, uint8_t* slab) {
  const int g = t / 4, pb = (t % 4) * HT_PACKED;
  const int8_t* rows = p.wd + static_cast<size_t>(g * SUB + pb) * p.ldd;
  for (int ci = threadIdx.x; ci < HT_PACKED * DOWN_COLS / 16; ci += THREADS) {
    const int j = ci / (DOWN_COLS / 16), seg = ci % (DOWN_COLS / 16) * 16;
    const bool in = c0 + seg < p.ldd;
    smmb_mma::cp_async16(slab + j * DOWN_COLS + seg,
                         rows + static_cast<size_t>(j) * p.ldd + (in ? c0 + seg : 0), in);
  }
  smmb_mma::cp_async_commit();
}

// rows of h = rmsnorm(v; g, eps) in place over the MT staged rows, rounded
// to the compute dtype, with row_rms's sums and the scaling by 4-element
// steps; g is 16-byte aligned
template <int MT>
__device__ void norm_quads(float* v, int d, const float* __restrict__ g, float eps,
                           float* inv, float* scratch, int cbf16) {
  row_rms<MT>(v, d, eps, inv, scratch);
  for (int q = threadIdx.x; q < MT * d / 4; q += THREADS) {
    const int r = 4 * q / d, k = 4 * q - r * d;
    const float4 gv = __ldg(reinterpret_cast<const float4*>(g + k));
    float4 x = *reinterpret_cast<float4*>(v + 4 * q);
    x.x = to_compute(__fmul_rn(__fmul_rn(x.x, inv[r]), gv.x), cbf16);
    x.y = to_compute(__fmul_rn(__fmul_rn(x.y, inv[r]), gv.y), cbf16);
    x.z = to_compute(__fmul_rn(__fmul_rn(x.z, inv[r]), gv.z), cbf16);
    x.w = to_compute(__fmul_rn(__fmul_rn(x.w, inv[r]), gv.w), cbf16);
    *reinterpret_cast<float4*>(v + 4 * q) = x;
  }
  __syncthreads();
}

// block b's items of a phase of `total`: the contiguous range
// [b total / grid, (b + 1) total / grid), so a block's items share their
// row tile (staged once) wherever they can
struct Range {
  int begin, end;
  __device__ Range(int total)
      : begin(static_cast<int>(static_cast<long long>(blockIdx.x) * total / gridDim.x)),
        end(static_cast<int>(static_cast<long long>(blockIdx.x + 1) * total / gridDim.x)) {}
};

// Phases end at grid syncs; before each sync a block issues the weight
// copies of its first item of the next phase (into the ring, free once its
// last item is summed), so they land while the grid waits. __launch_bounds__
// caps the 8-row kernel at 128 registers: two blocks a SM.
template <int MT, bool TAIL>
__global__ void __launch_bounds__(THREADS, MT == 1 ? 1 : 2) mlp_items_kernel(const MlpArgs p) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int kmax = TAIL && p.a > p.k ? p.a : p.k;
  float* act = smem;
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem + MT * kmax);
  float* red = reinterpret_cast<float*>(ring);
  float* inv = reinterpret_cast<float*>(ring + RING_BYTES);
  float* scratch = inv + MT;
  const int row_tiles = (p.m + MT - 1) / MT;
  const Items n = items_per_tile(p.h, p.kout, TAIL);
  const Range ups(row_tiles * n.up);

  if (TAIL) {  // wo: resid = (x + s_wo (att . Wo)) + b_wo, in f32
    const float sw = *p.s_wo;
    const Range wos(row_tiles * n.wo);
    int staged = -1;
    for (int it = wos.begin; it < wos.end; ++it) {
      const int rt = it / n.wo, c0 = it % n.wo * ITEM_COLS, m0 = rt * MT;
      __syncthreads();  // the block's last item is done with act and red
      chunk_start(p.a, p.wo, p.kout, c0, ring);
      // thread (r, c) < (MT, ITEM_COLS) writes resid[m0 + r, c0 + c]
      const int r = threadIdx.x / ITEM_COLS, c = threadIdx.x % ITEM_COLS, col = c0 + c;
      const bool mine = r < MT && m0 + r < p.m;
      const size_t o = static_cast<size_t>(m0 + r) * p.kout + col;
      if (rt != staged) stage_quads<MT>(act, p.att, p.att_bf16, p.m, m0, p.a, p.cbf16);
      staged = rt;
      chunk_dot<MT>(act, p.a, p.wo, p.kout, c0, ring, red);
      if (mine)  // JAX order: (x + s_wo acc) + b_wo
        p.resid[o] = __fadd_rn(__fadd_rn(__fmul_rn(chunk_sum<MT>(red, r, c), sw),
                                         load_elem(p.x, o, p.x_bf16)),
                               p.b_wo[col]);
    }
    __syncthreads();
    if (ups.begin < ups.end) chunk_start(p.k, p.wu, p.h, ups.begin % n.up * ITEM_COLS, ring);
    grid.sync();
  }

  {  // up = PReLU(s_up (h . Wup) + b_up), rounded to the compute dtype
    const float su = *p.s_up;
    int staged = -1;
    for (int it = ups.begin; it < ups.end; ++it) {
      const int rt = it / n.up, c0 = it % n.up * ITEM_COLS, m0 = rt * MT;
      __syncthreads();
      if (!TAIL || it != ups.begin) chunk_start(p.k, p.wu, p.h, c0, ring);
      const int r = threadIdx.x / ITEM_COLS, c = threadIdx.x % ITEM_COLS, unit = c0 + c;
      const bool mine = r < MT && m0 + r < p.m;
      if (rt != staged) {
        if (TAIL) {  // the norm reads the f32 residual of every column
          stage_quads<MT>(act, p.resid, 0, p.m, m0, p.k, 0);
          norm_quads<MT>(act, p.k, p.g2, p.eps, inv, scratch, p.cbf16);
        } else {
          stage_quads<MT>(act, p.x, p.x_bf16, p.m, m0, p.k, p.cbf16);
        }
      }
      staged = rt;
      chunk_dot<MT>(act, p.k, p.wu, p.h, c0, ring, red);
      if (mine) {
        float v = __fadd_rn(__fmul_rn(chunk_sum<MT>(red, r, c), su), p.b_up[unit]);
        if (!(v > 0.f)) v = __fmul_rn(p.alpha, v);
        p.up[static_cast<size_t>(m0 + r) * p.h + unit] = to_compute(v, p.cbf16);
      }
    }
  }
  // down items: (row tile, hidden tile t, DOWN_COLS columns)
  const int col_chunks = (p.kout + DOWN_COLS - 1) / DOWN_COLS;
  const Range downs(row_tiles * n.down);
  uint8_t* slab = ring;  // HT_PACKED x DOWN_COLS bytes of the ring
  __syncthreads();
  if (downs.begin < downs.end)
    down_start(p, downs.begin % n.down / col_chunks, downs.begin % col_chunks * DOWN_COLS, slab);
  grid.sync();

  {  // down: ws[t] = up tile t . its 32 packed rows of Wdown
    float* upt = act;  // MT x HT
    int staged = -1;   // the (row tile, hidden tile) of upt
    for (int it = downs.begin; it < downs.end; ++it) {
      const int rt = it / n.down, t = it % n.down / col_chunks;
      const int c0 = it % col_chunks * DOWN_COLS, m0 = rt * MT;
      const int g = t / 4, pb = (t % 4) * HT_PACKED;
      __syncthreads();
      if (it != downs.begin) down_start(p, t, c0, slab);
      // local unit u: plane u / 32, unit g*512 + plane*128 + pb + u % 32
      if (it / col_chunks != staged)
        for (int q = threadIdx.x; q < MT * HT / 4; q += THREADS) {
          const int r = q / (HT / 4), u = q % (HT / 4) * 4;
          const int unit = g * GROUP_ROWS + (u / HT_PACKED) * SUB + pb + u % HT_PACKED;
          *reinterpret_cast<float4*>(upt + r * HT + u) =
              m0 + r < p.m ? load_quad(p.up, static_cast<size_t>(m0 + r) * p.h + unit, 0)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      staged = it / col_chunks;
      smmb_mma::cp_async_wait<0>();
      __syncthreads();
      float acc[MT];
#pragma unroll
      for (int r = 0; r < MT; ++r) acc[r] = 0.f;
#pragma unroll(MT == 1 ? 2 : 1)
      for (int j0 = 0; j0 < HT_PACKED; j0 += 4) {
        float wv[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const unsigned b = slab[(j0 + q) * DOWN_COLS + threadIdx.x];
#pragma unroll
          for (int i = 0; i < 4; ++i) wv[q][i] = field_value(b, i);
        }
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          float4 ua[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            ua[i] = *reinterpret_cast<const float4*>(upt + r * HT + i * HT_PACKED + j0);
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[r] = fmaf(lane_of(ua[i], q), wv[q][i], acc[r]);
        }
      }
      const int col = c0 + threadIdx.x;
      if (col < p.kout)
#pragma unroll
        for (int r = 0; r < MT; ++r)
          if (m0 + r < p.m)
            p.ws[(static_cast<size_t>(t) * p.m + m0 + r) * p.kout + col] = acc[r];
    }
  }
  grid.sync();

  // sum items (row tile, SUM_COLS columns), warp r taking row m0 + r
  const int tiles = p.h / HT;
  const Range sums(row_tiles * n.sum);
  for (int it = sums.begin; it < sums.end; ++it) {
    const int row = it / n.sum * MT + (threadIdx.x >> 5);
    const int col = it % n.sum * SUM_COLS + (threadIdx.x & 31);
    if ((threadIdx.x >> 5) < MT && row < p.m && col < p.kout)
      sum_tiles<TAIL, sum_batch(MT)>(p, row, col, tiles);
  }
}

// ------------------------------------------------------ B3 / B7: items
// One launch of one item a block (kernels/fused_mlp.py::qkv_blocks lists
// them): blockIdx.y is the row tile, blockIdx.x the block of the row tile.
// B3: block x sums columns [32 x, 32 x + 32) of Wqkv. B7: blocks x < d / 32
// are B3's over the q columns; the rest are the K/V spans' clusters in slot
// order (slot 2 h + plane: KV head h's k or v span), rank j of a span's c
// blocks summing its columns [j hd / c, (j + 1) hd / c) a chunk at a time.
struct QkvArgs {
  const void* x;  // (m, d) rows, 16-byte aligned
  int x_bf16;
  const float* g;             // (d,) norm gain, 16-byte aligned
  const int8_t* w;            // packed (d, n), 16-byte aligned
  const float *scale, *bias;  // (n,)
  void* out;                  // B3: (m, n); B7: q (m, d); in x's dtype
  int8_t* codes;              // B7: (m, 2 kvh hd)
  float* scales;              // B7: (m, 2 kvh)
  int m, d, n, kvh, hd;
  float eps;
  int cbf16;
};

// blocks of a K/V span's cluster: MAX_CLUSTER where they split its hd / 32
// items evenly, else half (hd is a multiple of HEAD_COLS)
__host__ __device__ constexpr int span_cluster(int hd) {
  return hd / ITEM_COLS % MAX_CLUSTER == 0 ? MAX_CLUSTER : MAX_CLUSTER / 2;
}

// shared memory of a block (hd 0 for B3): items_smem_bytes' rows, rings and
// scratch, and B7's f32 y of the block's hd / c span columns, its rows'
// scales and the c blocks' absmax of each row
template <int MT>
size_t qkv_smem_bytes(int d, int hd) {
  const size_t quant =
      hd ? static_cast<size_t>(MT) * (hd / span_cluster(hd) + 1 + span_cluster(hd)) : 0;
  return items_smem_bytes<MT>(d) + sizeof(float) * quant;
}

// output (r, c) of the chunk at column c0: the eighths in warp order, then
// (sum * scale) + bias
template <int MT>
__device__ __forceinline__ float qkv_out(const QkvArgs& p, const float* red, int r, int c,
                                         int c0) {
  return __fadd_rn(__fmul_rn(chunk_sum<MT>(red, r, c), p.scale[c0 + c]), p.bias[c0 + c]);
}

// A block issues its item's weight pieces first and stages and normalizes
// its rows while they land. A K/V block pushes its rows' absmax into every
// block of its cluster before the one cluster barrier, so that no block
// reads another's shared memory after it (a block may then exit).
template <int MT, bool QUANT>
__global__ void __launch_bounds__(THREADS) qkv_items_kernel(const QkvArgs p) {
  extern __shared__ __align__(16) float smem[];
  float* act = smem;
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem + MT * p.d);
  float* red = reinterpret_cast<float*>(ring);
  float* inv = reinterpret_cast<float*>(ring + RING_BYTES);
  float* scratch = inv + MT;
  const int m0 = blockIdx.y * MT, q_items = (QUANT ? p.d : p.n) / ITEM_COLS;
  // thread (r, c) < (MT, ITEM_COLS) takes output (m0 + r, c0 + c) of a chunk
  const int r = threadIdx.x / ITEM_COLS, c = threadIdx.x % ITEM_COLS;
  if (static_cast<int>(blockIdx.x) < q_items) {  // B3's item; B7's q columns
    const int c0 = blockIdx.x * ITEM_COLS;
    chunk_start(p.d, p.w, p.n, c0, ring);
    stage_quads<MT>(act, p.x, p.x_bf16, p.m, m0, p.d, 0);  // the norm reads x in f32
    norm_quads<MT>(act, p.d, p.g, p.eps, inv, scratch, p.cbf16);
    chunk_dot<MT>(act, p.d, p.w, p.n, c0, ring, red);
    if (r < MT && m0 + r < p.m)
      store_elem(p.out, static_cast<size_t>(m0 + r) * q_items * ITEM_COLS + c0 + c,
                 qkv_out<MT>(p, red, r, c, c0), p.x_bf16);
    return;
  }
  if constexpr (QUANT) {  // a K/V span's block
    cg::cluster_group cluster = cg::this_cluster();
    const int cs = span_cluster(p.hd), own = p.hd / cs;
    const int s = blockIdx.x - q_items, slot = s / cs, rank = s % cs;
    const int first = p.d + (slot & 1) * p.kvh * p.hd + (slot >> 1) * p.hd + rank * own;
    float* ys = scratch + WARPS * MT;  // MT x own: y of the block's columns, f32
    float* qsc = ys + MT * own;        // MT: the span's scales
    float* amax = qsc + MT;            // cs x MT: each block's absmax of each row
    for (int j = 0; j < own; j += ITEM_COLS) {
      if (j) __syncthreads();  // the last chunk's epilogue is done with red
      chunk_start(p.d, p.w, p.n, first + j, ring);
      if (!j) {
        stage_quads<MT>(act, p.x, p.x_bf16, p.m, m0, p.d, 0);
        norm_quads<MT>(act, p.d, p.g, p.eps, inv, scratch, p.cbf16);
      }
      chunk_dot<MT>(act, p.d, p.w, p.n, first + j, ring, red);
      if (r < MT) ys[r * own + j + c] = qkv_out<MT>(p, red, r, c, first + j);
    }
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int rr = warp; rr < MT; rr += WARPS) {
      float a = 0.f;
      for (int cc = lane; cc < own; cc += 32) a = fmaxf(a, fabsf(ys[rr * own + cc]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
      if (lane < cs) cluster.map_shared_rank(amax, lane)[rank * MT + rr] = a;
    }
    cluster.sync();  // every block of the span holds every block's absmax
    if (threadIdx.x < MT) {
      float a = 0.f;
      for (int k = 0; k < cs; ++k) a = fmaxf(a, amax[k * MT + threadIdx.x]);
      qsc[threadIdx.x] = __fdiv_rn(a, 127.f);
    }
    __syncthreads();
    if (rank == 0 && threadIdx.x < MT && m0 + static_cast<int>(threadIdx.x) < p.m)
      p.scales[static_cast<size_t>(m0 + threadIdx.x) * 2 * p.kvh + slot] = qsc[threadIdx.x];
    const int row_codes = 2 * p.kvh * p.hd;
    for (int idx = threadIdx.x; idx < MT * own; idx += THREADS) {
      const int rr = idx / own, cc = idx - rr * own;
      if (m0 + rr >= p.m) continue;
      const float safe = qsc[rr] > 0.f ? qsc[rr] : 1.f;
      p.codes[static_cast<size_t>(m0 + rr) * row_codes + slot * p.hd + rank * own + cc] =
          static_cast<int8_t>(__float2int_rn(__fdiv_rn(ys[idx], safe)));
    }
  }
}

// above 48 KB a block's dynamic shared memory must be allowed per kernel
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool bad_rows(int m, int mt) { return m <= 0 || (m + mt - 1) / mt > 65535; }

// the blocks of a kernel that fit the current device at once: the grid a
// cooperative launch may have
template <int MT, bool TAIL>
cudaError_t items_capacity(size_t smem, int* blocks) {
  cudaError_t e = allow_smem(mlp_items_kernel<MT, TAIL>, smem);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mlp_items_kernel<MT, TAIL>,
                                                      THREADS, smem);
  *blocks = per_sm * sms;
  return e == cudaSuccess && *blocks <= 0 ? cudaErrorInvalidConfiguration : e;
}

template <int MT, bool TAIL>
size_t items_smem(const MlpArgs& a) {
  return items_smem_bytes<MT>(TAIL && a.a > a.k ? a.a : a.k);
}

// one cooperative launch of grid blocks (the wrapper takes the capacity,
// at most the largest phase's item count; a grid larger than fits the card
// at once is refused by the launch). A refused call's error is returned
// and cleared, so the library's next launch does not report it.
template <int MT, bool TAIL>
int mlp_items(const MlpArgs& a, int grid, cudaStream_t stream) {
  const size_t smem = items_smem<MT, TAIL>(a);
  if (smem > MAX_SMEM || bad_rows(a.m, MT) || grid <= 0) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(mlp_items_kernel<MT, TAIL>, smem);
  if (e == cudaSuccess) {
    void* args[] = {const_cast<MlpArgs*>(&a)};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(mlp_items_kernel<MT, TAIL>),
                                    dim3(grid), dim3(THREADS), args, smem, stream);
  }
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

template <bool TAIL>
int mlp_items_rows(const MlpArgs& a, int grid, cudaStream_t stream) {
  return a.m == 1 ? mlp_items<1, TAIL>(a, grid, stream) : mlp_items<8, TAIL>(a, grid, stream);
}

// one launch of the B3 (QUANT false) or B7 kernel: (blocks of a row tile,
// row tiles), B7's in clusters of span_cluster(hd) blocks (a K/V span each;
// the q items' clusters never sync). A refused launch's error is returned
// and cleared, so the library's next launch does not report it.
template <int MT, bool QUANT>
int qkv_items(const QkvArgs& a, cudaStream_t stream) {
  const size_t smem = qkv_smem_bytes<MT>(a.d, QUANT ? a.hd : 0);
  if (smem > MAX_SMEM || bad_rows(a.m, MT)) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(qkv_items_kernel<MT, QUANT>, smem);
  if (e == cudaSuccess) {
    const int cs = QUANT ? span_cluster(a.hd) : 1;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = cs;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(QUANT ? a.d / ITEM_COLS + 2 * a.kvh * cs : a.n / ITEM_COLS,
                       (a.m + MT - 1) / MT);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = cluster;
    cfg.numAttrs = QUANT ? 1 : 0;
    e = cudaLaunchKernelEx(&cfg, qkv_items_kernel<MT, QUANT>, a);
  }
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

QkvArgs qkv_args(const void* x, int x_bf16, const void* g, const void* w, const void* scale,
                 const void* bias, void* out, int m, int d, int n, float eps, int cbf16) {
  QkvArgs a{};
  a.x = x;
  a.x_bf16 = x_bf16;
  a.g = static_cast<const float*>(g);
  a.w = static_cast<const int8_t*>(w);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.m = m, a.d = d, a.n = n;
  a.eps = eps;
  a.cbf16 = cbf16;
  return a;
}

bool bad_qkv(const void* x, const void* g, const void* w, int d, int n) {
  return d <= 0 || d % GROUP_ROWS || n <= 0 || n % ITEM_COLS || misaligned(x) ||
         misaligned(g) || misaligned(w);
}

}  // namespace

// All matrices are row-major and contiguous; packed planes are
// int8[rows / 4, cols] in the layout of packed_decode.cuh. *_bf16 flags say
// whether a float tensor is bf16 (else f32); cbf16 selects the bf16 compute
// dtype (else f32). Scales s_* are device pointers to one f32 each; biases,
// norm gains and qkv scale vectors are f32. The output has x's dtype. Each
// entry returns the CUDA error of its launch (0 on success).

// B3: out (m, n) = (rmsnorm(x) . w) * scale + bias; d % 512 == 0,
// n % 32 == 0; x, g and w 16-byte aligned.
extern "C" int smmb_fused_norm_qkv(const void* x, int x_bf16, const void* g,
                                   const void* w, const void* scale,
                                   const void* bias, void* out, int m, int d,
                                   int n, float eps, int cbf16, void* stream) {
  if (bad_qkv(x, g, w, d, n)) return cudaErrorInvalidValue;
  const QkvArgs a = qkv_args(x, x_bf16, g, w, scale, bias, out, m, d, n, eps, cbf16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return m == 1 ? qkv_items<1, false>(a, s) : qkv_items<8, false>(a, s);
}

// B7: q_out (m, d) = B3's first d columns, in x's dtype; codes (m, 2 kvh hd)
// int8 and scales (m, 2 kvh) f32 of the K and V columns, slot 2 h + plane;
// n = d + 2 kvh hd, d % 512 == 0, hd % 128 == 0; x, g and w 16-byte aligned.
extern "C" int smmb_fused_norm_qkv_quant(const void* x, int x_bf16, const void* g,
                                         const void* w, const void* scale,
                                         const void* bias, void* q_out, void* codes,
                                         void* scales, int m, int d, int n, int kvh,
                                         int hd, float eps, int cbf16, void* stream) {
  if (bad_qkv(x, g, w, d, n) || kvh <= 0 || hd <= 0 || hd % HEAD_COLS ||
      n != d + 2 * kvh * hd)
    return cudaErrorInvalidValue;
  QkvArgs a = qkv_args(x, x_bf16, g, w, scale, bias, q_out, m, d, n, eps, cbf16);
  a.codes = static_cast<int8_t*>(codes);
  a.scales = static_cast<float*>(scales);
  a.kvh = kvh, a.hd = hd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return m == 1 ? qkv_items<1, true>(a, s) : qkv_items<8, true>(a, s);
}

// B6: out (m, kout) = (PReLU(s_up (x . wu) + b_up) . wd) * s_down + b_down;
// k and h multiples of 512; wd's rows ldd bytes apart (ldd >= kout, a
// multiple of 16, every pointer 16-byte aligned); up (m, h) and ws
// (h / 128, m, kout) f32 workspaces; grid > 0 blocks (smmb_fused_items_capacity
// at most).
extern "C" int smmb_fused_mlp(const void* x, int x_bf16, const void* wu,
                              const void* s_up, const void* b_up,
                              const void* wd, int ldd, const void* s_down,
                              const void* b_down, void* up, void* ws, void* out,
                              int m, int k, int h, int kout, float alpha,
                              int cbf16, int grid, void* stream) {
  if (k <= 0 || k % GROUP_ROWS || h <= 0 || h % GROUP_ROWS || kout <= 0 ||
      ldd < kout || ldd % 16)
    return cudaErrorInvalidValue;
  MlpArgs p{};
  p.x = x;
  p.x_bf16 = x_bf16;
  p.wu = static_cast<const int8_t*>(wu);
  p.s_up = static_cast<const float*>(s_up);
  p.b_up = static_cast<const float*>(b_up);
  p.wd = static_cast<const int8_t*>(wd);
  p.s_down = static_cast<const float*>(s_down);
  p.b_down = static_cast<const float*>(b_down);
  p.up = static_cast<float*>(up);
  p.ws = static_cast<float*>(ws);
  p.out = out;
  p.m = m, p.k = k, p.h = h, p.kout = kout, p.ldd = ldd;
  p.alpha = alpha;
  p.cbf16 = cbf16;
  return mlp_items_rows<false>(p, grid, static_cast<cudaStream_t>(stream));
}

// B5: out (m, dm) = the block tail above; a, dm and h multiples of 512;
// resid (m, dm), up (m, h) and ws (h / 128, m, dm) f32 workspaces.
extern "C" int smmb_fused_block_tail(
    const void* att, int att_bf16, const void* x, int x_bf16, const void* wo,
    const void* s_wo, const void* b_wo, const void* g2, const void* wu,
    const void* s_up, const void* b_up, const void* wd, const void* s_down,
    const void* b_down, void* resid, void* up, void* ws, void* out, int m, int a,
    int dm, int h, float alpha, float eps, int cbf16, int grid, void* stream) {
  if (a <= 0 || a % GROUP_ROWS || dm <= 0 || dm % GROUP_ROWS || h <= 0 ||
      h % GROUP_ROWS)
    return cudaErrorInvalidValue;
  MlpArgs p{};
  p.att = att;
  p.att_bf16 = att_bf16;
  p.x = x;
  p.x_bf16 = x_bf16;
  p.wo = static_cast<const int8_t*>(wo);
  p.s_wo = static_cast<const float*>(s_wo);
  p.b_wo = static_cast<const float*>(b_wo);
  p.g2 = static_cast<const float*>(g2);
  p.wu = static_cast<const int8_t*>(wu);
  p.s_up = static_cast<const float*>(s_up);
  p.b_up = static_cast<const float*>(b_up);
  p.wd = static_cast<const int8_t*>(wd);
  p.s_down = static_cast<const float*>(s_down);
  p.b_down = static_cast<const float*>(b_down);
  p.resid = static_cast<float*>(resid);
  p.up = static_cast<float*>(up);
  p.ws = static_cast<float*>(ws);
  p.out = out;
  p.m = m, p.a = a, p.k = dm, p.h = h, p.kout = dm, p.ldd = dm;
  p.alpha = alpha;
  p.eps = eps;
  p.cbf16 = cbf16;
  return mlp_items_rows<true>(p, grid, static_cast<cudaStream_t>(stream));
}

// the blocks of the B6 (tail 0) or B5 (tail 1) kernel for row tiles of
// `rows` (1 or 8) and staged rows of width kmax that fit the current
// device at once, or minus the CUDA error
extern "C" int smmb_fused_items_capacity(int tail, int rows, int kmax) {
  if ((rows != 1 && rows != 8) || kmax <= 0 || kmax % GROUP_ROWS)
    return -static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = rows == 1 ? items_smem_bytes<1>(kmax) : items_smem_bytes<8>(kmax);
  if (smem > MAX_SMEM) return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  cudaError_t e = rows == 1 ? (tail ? items_capacity<1, true>(smem, &blocks)
                                    : items_capacity<1, false>(smem, &blocks))
                            : (tail ? items_capacity<8, true>(smem, &blocks)
                                    : items_capacity<8, false>(smem, &blocks));
  cudaGetLastError();  // clear a failed query's error
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}
