// Flash (online-softmax) prefill attention for Hopper (sm_90a): B9.
//
// Replaces the Pallas TPU kernel of smmb_tpu/kernels/flash_attention.py
// (flash_attention :421; _flash_kernel :53, pallas_call at :662 for the
// causal triangular grid and :688 for the non-causal rectangular grid):
//
//   q (B, H, T, hd), k and v (B, KVH, S, hd), f32 or bf16, any element
//   strides for b, head and token (d contiguous); query head h reads KV head
//   h / g (g = H / KVH); causal: row t attends col <= t, and under a window
//   col > t - window; out (B, H, T, hd) in q's dtype.
//
// What bounds it on the card: the larger of the q + k + v + o bytes over the
// memory rate (3.35 TB/s) and 2 * B * H * T * S * hd multiply-adds (halved
// when causal) over the dtype's peak. At prefill lengths it is the
// operations.
//
// Two device bodies; kernels/flash_attention.py::kernel_route picks one per
// call and passes it as `body` (there is no fallback between them):
//   * prefill_mma_body<HD, PIPE> (bf16 at hd 64 and 128): tensor cores,
//     mma.sync m16n8k16 bf16 -> f32, in the FlashAttention-2 shape.
//   * prefill_body<T, BT, PIPE> (f32 at any hd, bf16 at other widths): the
//     CUDA-core body of the first port, true f32 FMAs (no TF32).
// Both share the contract: q is multiplied by qscale = scale * log2(e)
// rounded to q's dtype, the product rounded to q's dtype
// (flash_attention.py:109); scores accumulate in f32; the softmax runs in
// base 2 (exp2f); masked scores are the finite -1e30 (col >= S, and under
// causal col > t or col <= t - window); l sums the f32 p; p is rounded to
// v's dtype before P.V; the output is acc / l where l > 0, else 0, in q's
// dtype. Blocks own rows (token, head) over the gb query heads of one KV
// head (gb the largest divisor of g that is <= the tile), so each K and V
// tile is staged once for the whole group. Causal blocks walk only the live
// kv tiles, ascending: from the tile of the window's lower edge of the
// block's first token (0 without a window) to the tile of its last token's
// diagonal, the triangular grid's order (flash_attention.py:630-679);
// non-causal blocks walk every kv tile. Kernels allocate nothing, launch on
// the caller's stream and do not synchronise; the C entries return
// cudaGetLastError().
//
// B9p, the pipelined variant (PIPE = true, C entry
// smmb_flash_attention_pipe), replaces _flash_kernel_pipe
// (flash_attention.py:253, pallas_call at :607; causal only): step s issues
// tile s's scores beside the pending P_{s-1}.V_{s-1}, then runs tile s's
// softmax and rescales acc; a last step flushes the final P.V. acc sees
// the serial walk's operations in the serial walk's order (acc * r_s, then
// + P_s.V_s), so at the same tile the output is bitwise the serial
// kernel's, in both bodies.
//
// The mma body (a block of 4 warps, 64 query rows, 16 a warp, kv tiles of
// 64 columns):
//   * Q is scaled and rounded once, staged in shared memory and loaded into
//     registers as A fragments (ldmatrix.x4); it stays there for the walk.
//   * K and V tiles flow through a two-slot cp.async ring of 16-byte copies
//     (rows past S zero-filled), rows' 16-byte pieces XOR-swizzled by row so
//     ldmatrix's eight rows hit eight bank groups. Step s waits for its own
//     tiles, passes one barrier and issues the next step's copies into the
//     other slot, which every warp finished reading at step s - 1. Under
//     PIPE the V tile issued at step s is V_s (read at s + 1), so two V
//     slots suffice there too.
//   * S = Q.K^T on mma.sync, K's B fragments by ldmatrix (not transposed).
//     The mask is applied in registers, only on boundary tiles (diagonal,
//     window edge, S tail): JAX's interior/boundary split
//     (flash_attention.py:163-200).
//   * The row max and row sum reduce over each row's quad with two
//     __shfl_xor_sync; p is rounded to bf16 straight from S's accumulator
//     layout into P.V's A fragments (P never touches shared memory). acc
//     (16 x hd f32 a warp, 64 registers at hd 128) lives in registers:
//     acc = acc * r, then acc = mma(P, V, acc), V's B fragments by
//     ldmatrix.trans.
//   * The grid launches the q tiles last token first, so the longest causal
//     blocks do not form the tail.
//   * Under PIPE the pending P_{s-1} stays in registers as bf16 A fragments:
//     tile s's Q.K^T and the pending P.V are independent tensor-core work in
//     the same warp, beside the softmax's exp2f.
//
// The CUDA-core body: a block of 256 threads owns BT (64, or 32 / 16 for
// wide heads) query rows; q, k, v are staged in shared memory as f32,
// scores accumulate with fmaf over d in order (a 16 x 16 thread grid, each
// thread a BT/16 x BT/16 micro-tile) and P makes a round trip through
// shared memory (double-buffered under PIPE, where at step s the K tile
// staged is tile s's and the V tile is tile s-1's).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

using namespace smmb_mma;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may use
constexpr float NEG = -1e30f;     // a masked score
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float rnd(float v, const float*) { return v; }
__device__ __forceinline__ float rnd(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

size_t smem_bytes(int bt, int hd, bool pipe) {
  const size_t b = bt, d = hd, np = pipe ? 2 : 1;
  // q and k tiles padded to hd + 1 floats a row, v tile, p tile (two under
  // pipe) padded to bt + 1, the accumulator, and m, l, rescale
  return sizeof(float) * (2 * b * (d + 1) + 2 * b * d + np * b * (b + 1) + 3 * b);
}

// The body of both kernels. PIPE = false is the serial walk: step s stages
// tile s's K and V, and after the softmax acc = acc * rescale + P.V. PIPE =
// true is B9p's: step s stages tile s's K and tile s-1's V into the same
// buffers, adds the pending P[(s-1)%2].V to acc (already rescaled at s-1)
// beside tile s's scores, writes P[s%2], then acc *= rescale; step hi + 1
// only flushes. Every value is rounded as in the serial walk.
template <typename T, int BT, bool PIPE>
__device__ __forceinline__ void prefill_body(
    const T* __restrict__ q, long long qsb, long long qsh, long long qst,
    const T* __restrict__ k, long long ksb, long long ksh, long long kst,
    const T* __restrict__ v, long long vsb, long long vsh, long long vst,
    T* __restrict__ out, long long osb, long long osh, long long ost, int t_len,
    int s_len, int h, int kvh, int hd, int gb, int causal, int window, float qscale) {
  constexpr int MR = BT / 16;        // micro-tile rows and columns of a thread
  constexpr int PS = BT * (BT + 1);  // one p buffer
  extern __shared__ float smem[];
  const int hdp = hd + 1;
  float* qs = smem;                  // (BT, hd + 1)
  float* ks = qs + BT * hdp;         // (BT, hd + 1)
  float* vs = ks + BT * hdp;         // (BT, hd)
  float* ps = vs + BT * hd;          // (BT, BT + 1), two under PIPE
  float* acc = ps + (PIPE ? 2 : 1) * PS;  // (BT, hd)
  float* mrow = acc + BT * hd;
  float* lrow = mrow + BT;
  float* resc = lrow + BT;

  const int g = h / kvh, qt = BT / gb, rows = qt * gb;
  const int groups = g / gb;
  const int by = blockIdx.y;
  const int gs = by % groups, kh = (by / groups) % kvh, b = by / (groups * kvh);
  const int t0 = blockIdx.x * qt;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tr = tid >> 4, tc = tid & 15;

  // row r: token t0 + r / gb of query head kh * g + gs * gb + r % gb
  for (int i = tid; i < BT * hd; i += THREADS) {
    const int r = i / hd, d = i - r * hd;
    const int tok = t0 + r / gb, head = kh * g + gs * gb + r % gb;
    float val = 0.f;
    if (r < rows && tok < t_len)
      val = rnd(__fmul_rn(ld(q + b * qsb + head * qsh + tok * qst + d), qscale), q);
    qs[r * hdp + d] = val;
    acc[i] = 0.f;
  }
  for (int r = tid; r < BT; r += THREADS) {
    mrow[r] = NEG;
    lrow[r] = 0.f;
  }

  const int ns = (s_len + BT - 1) / BT;
  const int last_tok = min(t0 + qt, t_len) - 1;
  int lo = 0, hi = ns - 1;
  if (causal) {
    hi = min(last_tok / BT, ns - 1);
    if (window > 0) {
      const int edge = t0 - window + 1;
      lo = edge > 0 ? edge / BT : 0;
    }
  }
  const T* kb = k + b * ksb + kh * ksh;
  const T* vb = v + b * vsb + kh * vsh;

  for (int tile = lo; tile <= hi + (PIPE ? 1 : 0); ++tile) {
    const bool comp = tile <= hi, pend = PIPE && tile > lo;
    const int c0 = tile * BT, cv = PIPE ? c0 - BT : c0;  // the K and V tiles' columns
    float* pcur = PIPE ? ps + (tile & 1) * PS : ps;
    __syncthreads();  // the previous step's reads are done
    for (int i = tid; i < BT * hd; i += THREADS) {
      const int j = i / hd, d = i - j * hd;
      if (comp) ks[j * hdp + d] = c0 + j < s_len ? ld(kb + (c0 + j) * kst + d) : 0.f;
      if (PIPE ? pend : comp) vs[i] = cv + j < s_len ? ld(vb + (cv + j) * vst + d) : 0.f;
    }
    __syncthreads();

    if (pend) {  // B9p: the pending P.V of tile s-1
      const float* pprev = ps + ((tile - 1) & 1) * PS;
      for (int i = tid; i < BT * hd; i += THREADS) {
        const int r = i / hd, d = i - r * hd;
        const float* pr = pprev + r * (BT + 1);
        float pv = 0.f;
#pragma unroll 8
        for (int j = 0; j < BT; ++j) pv = fmaf(pr[j], vs[j * hd + d], pv);
        acc[i] = __fadd_rn(acc[i], pv);
      }
    }
    if (!comp) break;

    // scores: thread (tr, tc) owns rows tr + 16 ii and columns tc + 16 jj
    float sc[MR][MR];
#pragma unroll
    for (int ii = 0; ii < MR; ++ii)
#pragma unroll
      for (int jj = 0; jj < MR; ++jj) sc[ii][jj] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float a[MR], bk[MR];
#pragma unroll
      for (int ii = 0; ii < MR; ++ii) a[ii] = qs[(tr + 16 * ii) * hdp + d];
#pragma unroll
      for (int jj = 0; jj < MR; ++jj) bk[jj] = ks[(tc + 16 * jj) * hdp + d];
#pragma unroll
      for (int ii = 0; ii < MR; ++ii)
#pragma unroll
        for (int jj = 0; jj < MR; ++jj) sc[ii][jj] = fmaf(a[ii], bk[jj], sc[ii][jj]);
    }
#pragma unroll
    for (int ii = 0; ii < MR; ++ii) {
      const int r = tr + 16 * ii, tok = t0 + r / gb;
      const bool rv = r < rows && tok < t_len;
#pragma unroll
      for (int jj = 0; jj < MR; ++jj) {
        const int j = tc + 16 * jj, col = c0 + j;
        bool live = rv && col < s_len;
        if (causal) live = live && col <= tok && (window <= 0 || col > tok - window);
        pcur[r * (BT + 1) + j] = live ? sc[ii][jj] : NEG;
      }
    }
    __syncthreads();

    // online softmax: one warp per row
    for (int r = warp; r < BT; r += WARPS) {
      float* pr = pcur + r * (BT + 1);
      float mx = NEG;
      for (int j = lane; j < BT; j += 32) mx = fmaxf(mx, pr[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_prev = mrow[r];
      const float m_new = fmaxf(m_prev, mx);
      const float rs = exp2f(__fsub_rn(m_prev, m_new));
      float sum = 0.f;
      for (int j = lane; j < BT; j += 32) {
        const float p = exp2f(__fsub_rn(pr[j], m_new));
        sum = __fadd_rn(sum, p);
        pr[j] = rnd(p, v);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(FULL, sum, o));
      if (lane == 0) {
        mrow[r] = m_new;
        lrow[r] = __fadd_rn(__fmul_rn(lrow[r], rs), sum);
        resc[r] = rs;
      }
    }
    __syncthreads();

    if (PIPE) {  // acc *= rescale; tile s's P.V is added at step s + 1
      for (int i = tid; i < BT * hd; i += THREADS) acc[i] = __fmul_rn(acc[i], resc[i / hd]);
    } else {  // acc = acc * rescale + p . V
      for (int i = tid; i < BT * hd; i += THREADS) {
        const int r = i / hd, d = i - r * hd;
        const float* pr = pcur + r * (BT + 1);
        float pv = 0.f;
#pragma unroll 8
        for (int j = 0; j < BT; ++j) pv = fmaf(pr[j], vs[j * hd + d], pv);
        acc[i] = __fadd_rn(__fmul_rn(acc[i], resc[r]), pv);
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < BT * hd; i += THREADS) {
    const int r = i / hd, d = i - r * hd;
    const int tok = t0 + r / gb, head = kh * g + gs * gb + r % gb;
    if (r >= rows || tok >= t_len) continue;
    const float l = lrow[r];
    st(out + b * osb + head * osh + tok * ost + d, l > 0.f ? __fdiv_rn(acc[i], l) : 0.f);
  }
}

template <typename T, int BT>
__global__ void __launch_bounds__(THREADS)
    flash_prefill_kernel(const T* __restrict__ q, long long qsb, long long qsh,
                         long long qst, const T* __restrict__ k, long long ksb,
                         long long ksh, long long kst, const T* __restrict__ v,
                         long long vsb, long long vsh, long long vst,
                         T* __restrict__ out, long long osb, long long osh,
                         long long ost, int t_len, int s_len, int h, int kvh,
                         int hd, int gb, int causal, int window, float qscale) {
  prefill_body<T, BT, false>(q, qsb, qsh, qst, k, ksb, ksh, kst, v, vsb, vsh, vst, out,
                             osb, osh, ost, t_len, s_len, h, kvh, hd, gb, causal, window,
                             qscale);
}

template <typename T, int BT>
__global__ void __launch_bounds__(THREADS)
    flash_prefill_pipe_kernel(const T* __restrict__ q, long long qsb, long long qsh,
                              long long qst, const T* __restrict__ k, long long ksb,
                              long long ksh, long long kst, const T* __restrict__ v,
                              long long vsb, long long vsh, long long vst,
                              T* __restrict__ out, long long osb, long long osh,
                              long long ost, int t_len, int s_len, int h, int kvh,
                              int hd, int gb, int causal, int window, float qscale) {
  prefill_body<T, BT, true>(q, qsb, qsh, qst, k, ksb, ksh, kst, v, vsb, vsh, vst, out,
                            osb, osh, ost, t_len, s_len, h, kvh, hd, gb, causal, window,
                            qscale);
}

// ---- bf16 on the tensor cores

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MMA_BR = 16 * MMA_WARPS;  // query rows a block, 16 a warp
constexpr int MMA_BC = 64;              // kv columns a tile

template <int HD>
struct MmaTile {
  static constexpr int ROW = 2 * HD;           // bytes of a staged row
  static constexpr int PIECES = HD / 8;        // 16-byte pieces a row
  static constexpr int QBYTES = MMA_BR * ROW;  // the Q tile
  static constexpr int KV = MMA_BC * ROW;      // one K or V slot
  static constexpr int SMEM = QBYTES + 4 * KV;  // Q, two K and two V slots
  static constexpr int DK = HD / 16;           // k16 steps of Q.K^T
  static constexpr int SN = MMA_BC / 8;        // n8 tiles of S
  static constexpr int PK = MMA_BC / 16;       // k16 steps of P.V
  static constexpr int ON = HD / 8;            // n8 tiles of acc
  static_assert(HD == 64 || HD == 128, "the mma body takes hd 64 and 128");
};

// byte offset of 16-byte piece c of staged row r: pieces XOR-swizzled by
// r % 8, so ldmatrix's eight consecutive rows at one piece hit eight bank
// groups
template <int HD>
__device__ __forceinline__ int swz(int r, int c) {
  return r * MmaTile<HD>::ROW + ((c ^ (r & 7)) << 4);
}

// kv rows c0 .. c0 + 63 of one head into a slot; rows past S are zero
template <int HD>
__device__ __forceinline__ void stage_tile(uint8_t* slot,
                                           const __nv_bfloat16* __restrict__ src,
                                           long long st, int c0, int s_len,
                                           int tid) {
  using M = MmaTile<HD>;
#pragma unroll
  for (int it = 0; it < MMA_BC * M::PIECES / MMA_THREADS; ++it) {
    const int i = tid + it * MMA_THREADS, j = i / M::PIECES, c = i % M::PIECES;
    const bool ok = c0 + j < s_len;
    cp_async16(slot + swz<HD>(j, c), ok ? src + (c0 + j) * st + c * 8 : src, ok);
  }
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The bf16 body. PIPE = false is the serial walk: step s computes S_s, its
// softmax, acc *= r_s and acc += P_s.V_s. PIPE = true is B9p's: step s
// computes S_s, adds the pending P_{s-1}.V_{s-1}, then runs S_s's softmax
// and acc *= r_s; step hi + 1 only flushes. Lane 4g + t of warp w holds
// rows w*16 + g and w*16 + g + 8 of the block (C layout).
template <int HD, bool PIPE>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q, long long qsb,
                             long long qsh, long long qst,
                             const __nv_bfloat16* __restrict__ k, long long ksb,
                             long long ksh, long long kst,
                             const __nv_bfloat16* __restrict__ v, long long vsb,
                             long long vsh, long long vst,
                             __nv_bfloat16* __restrict__ out, long long osb,
                             long long osh, long long ost, int t_len, int s_len,
                             int h, int kvh, int gb, int causal, int window,
                             float qscale) {
  using M = MmaTile<HD>;
  extern __shared__ __align__(16) uint8_t mma_smem[];
  uint8_t* qs = mma_smem;
  uint8_t* ks = qs + M::QBYTES;   // two slots
  uint8_t* vs = ks + 2 * M::KV;   // two slots

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lg = lane >> 2, lt = lane & 3;
  const int g = h / kvh, qt = MMA_BR / gb, rows = qt * gb, groups = g / gb;
  const int bx = blockIdx.x;
  const int gs = bx % groups, kh = (bx / groups) % kvh, b = bx / (groups * kvh);
  const int t0 = (gridDim.y - 1 - blockIdx.y) * qt;  // last tokens first

  const int ns = (s_len + MMA_BC - 1) / MMA_BC;
  const int last_tok = min(t0 + qt, t_len) - 1;
  int lo = 0, hi = ns - 1;
  if (causal) {
    hi = min(last_tok / MMA_BC, ns - 1);
    if (window > 0) {
      const int edge = t0 - window + 1;
      lo = edge > 0 ? edge / MMA_BC : 0;
    }
  }
  const __nv_bfloat16* kb = k + b * ksb + kh * ksh;
  const __nv_bfloat16* vb = v + b * vsb + kh * vsh;
  // tile x lives in slot (x - lo) & 1 of the K ring and of the V ring
  stage_tile<HD>(ks, kb, kst, lo * MMA_BC, s_len, tid);
  if (!PIPE) stage_tile<HD>(vs, vb, vst, lo * MMA_BC, s_len, tid);
  cp_async_commit();

  // row r: token t0 + r / gb of query head kh * g + gs * gb + r % gb
#pragma unroll
  for (int it = 0; it < MMA_BR * M::PIECES / MMA_THREADS; ++it) {
    const int i = tid + it * MMA_THREADS, r = i / M::PIECES, c = i % M::PIECES;
    const int tok = t0 + r / gb, head = kh * g + gs * gb + r % gb;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && tok < t_len) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(q + b * qsb + head * qsh + tok * qst + c * 8);
      const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(&raw);
      unsigned* o = reinterpret_cast<unsigned*>(&val);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(in[e]);
        o[e] = pack_bf16(__fmul_rn(f.x, qscale), __fmul_rn(f.y, qscale));
      }
    }
    *reinterpret_cast<uint4*>(qs + swz<HD>(r, c)) = val;
  }
  __syncthreads();
  unsigned qf[M::DK][4];  // A fragments: rows w*16 + l % 16, d piece 2kk + l / 16
#pragma unroll
  for (int kk = 0; kk < M::DK; ++kk)
    ldmatrix_x4(qf[kk], qs + swz<HD>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));

  const int tok0 = t0 + (warp * 16 + lg) / gb, tok1 = t0 + (warp * 16 + lg + 8) / gb;
  float acc[M::ON][4];
#pragma unroll
  for (int j = 0; j < M::ON; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float mrow[2] = {NEG, NEG}, lrow[2] = {0.f, 0.f};
  unsigned pf[M::PK][4];  // P (of tile s, or the pending s - 1 under PIPE)

  // P.V of the tile in V slot vslot: acc += P.V, k16 steps in order
  auto pv = [&](int vslot) {
    const uint8_t* vt = vs + vslot * M::KV;
#pragma unroll
    for (int kk = 0; kk < M::PK; ++kk)
#pragma unroll
      for (int jp = 0; jp < M::ON / 2; ++jp) {
        // matrix m = l / 8: kv rows 16kk + 8(m % 2) .., d piece 2jp + m / 2
        unsigned bv[4];
        ldmatrix_x4_trans(bv, vt + swz<HD>(kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7),
                                           2 * jp + (lane >> 4)));
        mma(acc[2 * jp], pf[kk], bv[0], bv[1]);
        mma(acc[2 * jp + 1], pf[kk], bv[2], bv[3]);
      }
  };

  const int steps = hi - lo + 1 + (PIPE ? 1 : 0);
  for (int n = 0; n < steps; ++n) {
    const int tile = lo + n;
    const bool comp = tile <= hi;
    cp_async_wait<0>();
    __syncthreads();  // this step's tiles landed; step n - 1's reads are done
    if (tile + 1 <= hi) stage_tile<HD>(ks + ((n + 1) & 1) * M::KV, kb, kst,
                                       (tile + 1) * MMA_BC, s_len, tid);
    if (PIPE ? comp : tile + 1 <= hi)
      stage_tile<HD>(vs + ((PIPE ? n : n + 1) & 1) * M::KV, vb, vst,
                     (PIPE ? tile : tile + 1) * MMA_BC, s_len, tid);
    cp_async_commit();

    float s[M::SN][4];
    if (comp) {  // S = Q.K^T
      const uint8_t* kt = ks + (n & 1) * M::KV;
#pragma unroll
      for (int j = 0; j < M::SN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < M::DK; ++kk)
#pragma unroll
        for (int jp = 0; jp < M::SN / 2; ++jp) {
          // matrix m = l / 8: kv rows 16jp + 8(m / 2) .., d piece 2kk + m % 2
          unsigned bk[4];
          ldmatrix_x4(bk, kt + swz<HD>(jp * 16 + (lane >> 4) * 8 + (lane & 7),
                                       2 * kk + ((lane >> 3) & 1)));
          mma(s[2 * jp], qf[kk], bk[0], bk[1]);
          mma(s[2 * jp + 1], qf[kk], bk[2], bk[3]);
        }
    }
    if (PIPE && n > 0) pv((n - 1) & 1);  // the pending P_{s-1}.V_{s-1}
    if (!comp) break;

    const int c0 = tile * MMA_BC;
    const bool interior =
        c0 + MMA_BC <= s_len &&
        (!causal || (c0 + MMA_BC - 1 <= t0 && (window <= 0 || c0 > last_tok - window)));
    if (!interior) {
#pragma unroll
      for (int j = 0; j < M::SN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + j * 8 + 2 * lt + (e & 1), tok = e < 2 ? tok0 : tok1;
          bool live = col < s_len;
          if (causal) live = live && col <= tok && (window <= 0 || col > tok - window);
          if (!live) s[j][e] = NEG;
        }
    }

    // online softmax over rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float rs[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = mrow[hh];
#pragma unroll
      for (int j = 0; j < M::SN; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      rs[hh] = exp2f(__fsub_rn(mrow[hh], mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < M::SN; ++j)
#pragma unroll
        for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
          s[j][e] = exp2f(__fsub_rn(s[j][e], mx));
          sum = __fadd_rn(sum, s[j][e]);
        }
      sum = __fadd_rn(sum, __shfl_xor_sync(FULL, sum, 1));
      sum = __fadd_rn(sum, __shfl_xor_sync(FULL, sum, 2));
      lrow[hh] = __fadd_rn(__fmul_rn(lrow[hh], rs[hh]), sum);
      mrow[hh] = mx;
    }
    // p in bf16 from the C layout of n8 tiles 2kk, 2kk + 1 into A step kk
#pragma unroll
    for (int kk = 0; kk < M::PK; ++kk) {
      pf[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
#pragma unroll
    for (int j = 0; j < M::ON; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = __fmul_rn(acc[j][e], rs[e >> 1]);
    if (!PIPE) pv(n & 1);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + lg + 8 * hh;
    const int tok = t0 + r / gb, head = kh * g + gs * gb + r % gb;
    if (r >= rows || tok >= t_len) continue;
    const float l = lrow[hh];
    __nv_bfloat16* o = out + b * osb + head * osh + tok * ost;
#pragma unroll
    for (int j = 0; j < M::ON; ++j) {
      const float y0 = l > 0.f ? __fdiv_rn(acc[j][2 * hh], l) : 0.f;
      const float y1 = l > 0.f ? __fdiv_rn(acc[j][2 * hh + 1], l) : 0.f;
      *reinterpret_cast<unsigned*>(o + j * 8 + 2 * lt) = pack_bf16(y0, y1);
    }
  }
}

int largest_divisor_at_most(int g, int cap) {
  for (int d = cap < g ? cap : g; d > 1; --d)
    if (g % d == 0) return d;
  return 1;
}

template <typename T, int BT, bool PIPE>
int launch(const void* q, const long long* qs, const void* k, const long long* ks,
           const void* v, const long long* vs, void* out, const long long* os,
           int b, int t_len, int s_len, int h, int kvh, int hd, int causal,
           int window, float qscale, cudaStream_t stream) {
  const size_t smem = smem_bytes(BT, hd, PIPE);
  auto kernel = PIPE ? flash_prefill_pipe_kernel<T, BT> : flash_prefill_kernel<T, BT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int g = h / kvh, gb = largest_divisor_at_most(g, BT), qt = BT / gb;
  const dim3 grid((t_len + qt - 1) / qt, b * kvh * (g / gb));
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), qs[0], qs[1], qs[2], static_cast<const T*>(k),
      ks[0], ks[1], ks[2], static_cast<const T*>(v), vs[0], vs[1], vs[2],
      static_cast<T*>(out), os[0], os[1], os[2], t_len, s_len, h, kvh, hd, gb,
      causal, window, qscale);
  return cudaGetLastError();
}

template <typename T, bool PIPE>
int dispatch(int bt, const void* q, const long long* qs, const void* k,
             const long long* ks, const void* v, const long long* vs, void* out,
             const long long* os, int b, int t_len, int s_len, int h, int kvh,
             int hd, int causal, int window, float qscale, cudaStream_t stream) {
  switch (bt) {
    case 64:
      return launch<T, 64, PIPE>(q, qs, k, ks, v, vs, out, os, b, t_len, s_len, h, kvh,
                                 hd, causal, window, qscale, stream);
    case 32:
      return launch<T, 32, PIPE>(q, qs, k, ks, v, vs, out, os, b, t_len, s_len, h, kvh,
                                 hd, causal, window, qscale, stream);
    case 16:
      return launch<T, 16, PIPE>(q, qs, k, ks, v, vs, out, os, b, t_len, s_len, h, kvh,
                                 hd, causal, window, qscale, stream);
  }
  return cudaErrorInvalidValue;
}

template <int HD, bool PIPE>
int launch_mma(const void* q, const long long* qs, const void* k, const long long* ks,
               const void* v, const long long* vs, void* out, const long long* os,
               int b, int t_len, int s_len, int h, int kvh, int causal, int window,
               float qscale, cudaStream_t stream) {
  auto kernel = flash_prefill_mma_kernel<HD, PIPE>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       MmaTile<HD>::SMEM);
  if (e != cudaSuccess) return e;
  const int g = h / kvh, gb = largest_divisor_at_most(g, MMA_BR), qt = MMA_BR / gb;
  const int tiles = (t_len + qt - 1) / qt;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(b * kvh * (g / gb), tiles);
  kernel<<<grid, MMA_THREADS, MmaTile<HD>::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), qs[0], qs[1], qs[2],
      static_cast<const __nv_bfloat16*>(k), ks[0], ks[1], ks[2],
      static_cast<const __nv_bfloat16*>(v), vs[0], vs[1], vs[2],
      static_cast<__nv_bfloat16*>(out), os[0], os[1], os[2], t_len, s_len, h, kvh, gb,
      causal, window, qscale);
  return cudaGetLastError();
}

// the mma body's 16-byte copies and loads: q, k, v 16-byte aligned with
// strides of whole 8-element pieces; out 4-byte aligned with even strides
bool mma_aligned(const void* q, const long long* qs, const void* k, const long long* ks,
                 const void* v, const long long* vs, const void* out, const long long* os) {
  const void* in[3] = {q, k, v};
  const long long* st[3] = {qs, ks, vs};
  for (int i = 0; i < 3; ++i) {
    if (reinterpret_cast<uintptr_t>(in[i]) % 16) return false;
    for (int j = 0; j < 3; ++j)
      if (st[i][j] % 8) return false;
  }
  if (reinterpret_cast<uintptr_t>(out) % 4) return false;
  for (int j = 0; j < 3; ++j)
    if (os[j] % 2) return false;
  return true;
}

// body 1 (mma): bf16 at hd 64 or 128, the 64-row tile; body 0 (CUDA
// cores): any dtype and hd, tile bt
template <bool PIPE>
int entry(const void* q, const long long* q_str, const void* k, const long long* k_str,
          const void* v, const long long* v_str, void* out, const long long* o_str,
          int bf16, int b, int t_len, int s_len, int h, int kvh, int hd, int causal,
          int window, float qscale, int body, int bt, void* stream) {
  if (b <= 0 || t_len <= 0 || s_len <= 0 || kvh <= 0 || h % kvh || hd <= 0 ||
      (PIPE && !causal))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (!bf16 || bt != MMA_BR ||
        !mma_aligned(q, q_str, k, k_str, v, v_str, out, o_str))
      return cudaErrorInvalidValue;
    if (hd == 64)
      return launch_mma<64, PIPE>(q, q_str, k, k_str, v, v_str, out, o_str, b, t_len,
                                  s_len, h, kvh, causal, window, qscale, st);
    if (hd == 128)
      return launch_mma<128, PIPE>(q, q_str, k, k_str, v, v_str, out, o_str, b, t_len,
                                   s_len, h, kvh, causal, window, qscale, st);
    return cudaErrorInvalidValue;
  }
  if (body != 0 || smem_bytes(bt, hd, PIPE) > MAX_SMEM) return cudaErrorInvalidValue;
  return bf16 ? dispatch<__nv_bfloat16, PIPE>(bt, q, q_str, k, k_str, v, v_str, out, o_str,
                                              b, t_len, s_len, h, kvh, hd, causal, window,
                                              qscale, st)
              : dispatch<float, PIPE>(bt, q, q_str, k, k_str, v, v_str, out, o_str, b,
                                      t_len, s_len, h, kvh, hd, causal, window, qscale, st);
}

}  // namespace

// q, k, v, out: element strides (b, head, token) in q_str, k_str, v_str,
// o_str, d contiguous; all four f32 (bf16 = 0) or all bf16. body 1 is the
// tensor-core body (bf16, hd 64 or 128, bt 64, 16-byte aligned q, k, v with
// strides of whole 8-element pieces), body 0 the CUDA-core body with tile
// bt (64, 32 or 16) whose shared memory fits; window <= 0 means none;
// qscale is scale * log2(e) already rounded to q's dtype.
extern "C" int smmb_flash_attention(const void* q, const long long* q_str,
                                    const void* k, const long long* k_str,
                                    const void* v, const long long* v_str,
                                    void* out, const long long* o_str, int bf16,
                                    int b, int t_len, int s_len, int h, int kvh,
                                    int hd, int causal, int window, float qscale,
                                    int body, int bt, void* stream) {
  return entry<false>(q, q_str, k, k_str, v, v_str, out, o_str, bf16, b, t_len, s_len, h,
                      kvh, hd, causal, window, qscale, body, bt, stream);
}

// B9p: smmb_flash_attention's arguments; causal must be 1, and under body 0
// bt must fit the pipelined block's shared memory (two p buffers).
extern "C" int smmb_flash_attention_pipe(const void* q, const long long* q_str,
                                         const void* k, const long long* k_str,
                                         const void* v, const long long* v_str,
                                         void* out, const long long* o_str, int bf16,
                                         int b, int t_len, int s_len, int h, int kvh,
                                         int hd, int causal, int window, float qscale,
                                         int body, int bt, void* stream) {
  return entry<true>(q, q_str, k, k_str, v, v_str, out, o_str, bf16, b, t_len, s_len, h,
                     kvh, hd, causal, window, qscale, body, bt, stream);
}
