// Flash decode / chunk attention over the flat KV cache for Hopper (sm_90a):
// B4 (float cache) and B8 (the merged int8 cache).
//
// Replaces the Pallas TPU kernel of smmb_tpu/kernels/flash_decode.py
// (_decode_kernel :91, pallas_call at :412), which serves
// flash_attention_decode (:462, nq = 1) and flash_attention_chunk (:533) and,
// through its quant arms (:129-133, :150-151, :165-169, :196-198),
// flash_attention_decode_quant (:505) and flash_attention_chunk_quant (:565).
//
//   q (B, nq, H, hd) at positions pos .. pos + nq - 1, row strides given;
//   float mode: k, v (B, S, KVH * hd) flat caches, f32 or bf16, read in place;
//   int8 mode:  kv (B, S, 2 * KVH * hd) int8 codes, KV head h's k at slot 2h
//               and its v at slot 2h + 1 of a row; kv_scale (B, 2 * KVH, S)
//               f32 per-token absmax scales in the same interleave;
//   query head h reads KV head h / g (g = H / KVH, contiguous grouping);
//   row (token c, head h) attends columns col <= pos + c, and under a window
//   col > pos + c - window;
//   out (B, nq, H, hd) in the compute dtype.
//
// What bounds it on the card: the live cache prefix, (pos + 1) * 2 * KVH * hd
// * itemsize bytes per batch row (plus 8 bytes of scales per KV head and
// column in the int8 mode), over the memory rate. The products are a few
// FLOPs per byte, so CUDA cores suffice; what the card needs is many blocks
// with copies in flight.
//
// Design (the live cache split across blocks, CUDA cores):
//   * The cache is cut into spans of `span` columns (a multiple of TK = 64,
//     kernels/flash_decode.py::split_cols, a function of S alone) at absolute
//     multiples of the span from column 0. The grid is (live spans, KVH, B):
//     the live spans run from the one holding token 0's window edge (column
//     0 without a window) to the one holding column pos + nq - 1. Each block
//     stages the nq * g query rows of its KV head (row r = c * g + gi is token
//     c, query head kvh * g + gi) in shared memory, with sm_scale * log2(e)
//     folded in: the product is taken in f32 and rounded to the compute dtype
//     (flash_decode.py:308-310).
//   * A block walks its span's tiles of TK columns in ascending order,
//     clipped to the launch's live tiles. K and V tiles are copied into
//     shared memory as they lie in the cache (int8 codes, bf16 or f32) by
//     16-byte cp.async copies, neighbouring threads on neighbouring 16-byte
//     pieces, so the stores have no bank conflicts; in the int8 mode the
//     tile's TK k and TK v scales come beside them by 4-byte copies. A
//     two-slot ring lets the next tile's copy fly while the current one is
//     computed (one slot where two would not fit: f32 caches at many rows).
//     Values are converted where the score and P.V loops read them: the
//     compute dtype's rounding of the stored value, an int8 code exactly.
//   * Per tile, the arithmetic of the first (unsplit) kernel: a score is one
//     warp's f32 sum (fmaf; lane l takes d = l, l + 32, ... in order, then a
//     fixed butterfly), a warp's eight columns side by side; in the int8
//     mode it is multiplied by its column's k scale after the sum
//     (flash_decode.py:169; linear, so it commutes with the fold on q).
//     Masked scores are the finite -1e30, never -inf. The online softmax
//     runs in base 2 (exp2f); p is multiplied by its column's v scale in the
//     int8 mode (:198) and rounded to the compute dtype before P.V, while l
//     sums the unscaled, unrounded p (:190-194). P.V is a sequential sum
//     over the tile. The compute dtype is a template flag.
//   * Each block writes its rows' partial (m, l, acc) in f32 to a workspace,
//     then __threadfence() and an atomicAdd on its (b, KV head) counter. The
//     block that arrives last combines that (b, KV head)'s spans in ascending
//     span index, whatever order the blocks finished in, reading the
//     partials through L2 (__ldcg): M = max_j m_j, w_j = exp2(m_j - M),
//     l = sum_j l_j * w_j and acc = sum_j acc_j * w_j as ascending sequential
//     sums, out = acc / l (__fdiv_rn) where l > 0, else 0. It resets the
//     counter to 0 for the next launch. A launch of one live span skips the
//     workspace and writes acc / l itself: its combine weight is exp2(0) = 1,
//     so the bits are the same, and they are the unsplit kernel's. One launch
//     per call: no second kernel, no memset. The counters assume launches on
//     one stream.
//   * Row identity (the speculative-decoding contract): the order of every
//     sum of a row depends on hd, TK and the span, and the span on S alone.
//     Which rows share a block changes nothing. A tile that is fully masked
//     for a row is a bitwise no-op for it (rescale exp2(0) = 1, p = 0; before
//     the row's first live tile of a span, everything it added is multiplied
//     by exp2(-1e30 - m) = 0). A span wholly after a row's position, or
//     wholly before its window edge, has m_j = -1e30 for it, so its weight is
//     0 and it adds exact zeros to the combine. So a token's row is the same
//     at nq = 1 and inside a chunk (whose launch may hold extra leading and
//     trailing spans), at B = 1 and inside a batch, in both modes.
//   * Kernels allocate nothing (the wrapper passes the workspace and the
//     counters), launch on the caller's stream and do not synchronise; the C
//     entries return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

using namespace smmb_mma;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TK = 64;               // cache columns per tile
constexpr int CPW = TK / WARPS;      // score columns a warp takes per row
constexpr int RING = 2;              // K/V copy slots (one where two do not fit)
constexpr int MAX_SPANS = TK;        // a lane holds two spans' weights, staged in (rows, TK)
constexpr int MAX_SMEM = 232448;     // dynamic shared memory a block may use
constexpr float NEG = -1e30f;        // a masked score
constexpr unsigned FULL = 0xffffffffu;

// v in the compute dtype (CB: bf16)
template <bool CB>
__device__ __forceinline__ float to_compute(float v) {
  return CB ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// a staged cache value in the compute dtype: f32 rounded to it, a bf16
// value or an int8 code exact in either
template <bool CB>
__device__ __forceinline__ float cval(const float* p) {
  return to_compute<CB>(*p);
}
template <bool CB>
__device__ __forceinline__ float cval(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <bool CB>
__device__ __forceinline__ float cval(const int8_t* p) {
  return static_cast<float>(*p);
}

// output element i = (r, d) of a block's rows (r = c * g + gi), to out
// (B, nq, H, hd) in the compute dtype
template <bool CB>
__device__ __forceinline__ void store_out(void* out, int b, int nq, int h, int kh, int g,
                                          int hd, int i, float o) {
  const int r = i / hd, d = i - r * hd, c = r / g, gi = r - c * g;
  const size_t oi = ((static_cast<size_t>(b) * nq + c) * h + kh * g + gi) * hd + d;
  if (CB)
    static_cast<__nv_bfloat16*>(out)[oi] = __float2bfloat16_rn(o);
  else
    static_cast<float*>(out)[oi] = o;
}

// 4 bytes global -> shared, zero-filled when !valid (nothing is read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// one ring slot: the K tile and the V tile in the storage type, then in the
// int8 mode the tile's TK k scales and TK v scales
__host__ __device__ size_t slot_bytes(int hd, int itemsize, bool quant) {
  return 2 * static_cast<size_t>(TK) * hd * itemsize + (quant ? 2 * TK * sizeof(float) : 0);
}

// the ring, then f32: the query rows, their accumulators and scores, m, l
// and the rescale
size_t smem_bytes(int rows, int hd, int itemsize, bool quant, int slots) {
  return slots * slot_bytes(hd, itemsize, quant) +
         sizeof(float) * static_cast<size_t>(rows) * (2 * hd + TK + 3);
}

// One thread's share of the copy of a tile of one KV head into a ring slot.
// Thread i copies the 16-byte pieces i, i + THREADS, ... of the K tile and of
// the V tile (rows of hd values, unpadded), so a warp's stores are
// contiguous; columns at or beyond S are zero-filled. In the int8 mode
// threads 0 .. 2 TK - 1 copy the tile's k scales ([0, TK)) and v scales
// ([TK, 2 TK)) beside them.
template <typename CT>
struct TileCopy {
  static constexpr int VEC = 16 / sizeof(CT);  // values per piece
  const CT* k;        // this head's k (row 0), and its v
  const CT* v;
  const float* sc;    // int8 mode: this head's k scales; its v scales follow at + s
  int width, hd, s, tid;
  int pieces, j0, p0, jstep, pstep;  // the thread's first (row, piece) and its step

  __device__ TileCopy(const CT* k_, const CT* v_, const float* sc_, int width_, int hd_,
                      int s_, int tid_)
      : k(k_), v(v_), sc(sc_), width(width_), hd(hd_), s(s_), tid(tid_) {
    pieces = hd / VEC;
    j0 = tid / pieces;
    p0 = tid - j0 * pieces;
    jstep = THREADS / pieces;
    pstep = THREADS - jstep * pieces;
  }

  __device__ __forceinline__ void issue(unsigned char* slot, int c0) const {
    CT* kt = reinterpret_cast<CT*>(slot);
    CT* vt = kt + TK * hd;
    for (int j = j0, p = p0; j < TK;) {
      const int d = p * VEC;
      const bool in = c0 + j < s;
      const long long off = static_cast<long long>(in ? c0 + j : 0) * width + d;
      cp_async16(kt + j * hd + d, k + off, in);
      cp_async16(vt + j * hd + d, v + off, in);
      j += jstep;
      p += pstep;
      if (p >= pieces) {
        p -= pieces;
        ++j;
      }
    }
    if (sizeof(CT) == 1 && tid < 2 * TK) {
      float* dst = reinterpret_cast<float*>(vt + TK * hd);
      const int j = tid & (TK - 1);
      const bool in = c0 + j < s;
      cp_async4(dst + tid, sc + (tid < TK ? 0 : s) + (in ? c0 + j : 0), in);
    }
    cp_async_commit();
  }
};

// CT is the cache's element type: float or bf16 (float mode, kc and vc the
// two caches), int8_t (int8 mode, kc the merged codes, vc unused, kvs the
// scales); CB: the compute dtype is bf16. Block (sp, kh, b) takes span
// lo_span + sp of KV head kh, batch row b.
template <typename QT, typename CT, bool CB>
__global__ void __launch_bounds__(THREADS)
    flash_decode_kernel(const QT* __restrict__ q, long long q_sb, long long q_sc,
                        const CT* __restrict__ kc, const CT* __restrict__ vc,
                        const float* __restrict__ kvs, void* __restrict__ out,
                        float* __restrict__ ws, unsigned* __restrict__ counters,
                        int nq, int h, int kvh, int hd, int s, int pos, int window,
                        int span, int lo_span, int slots, float qscale) {
  constexpr bool QUANT = sizeof(CT) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const int g = h / kvh, rows = nq * g;
  const int tile = TK * hd;  // values in a K or V tile
  const size_t slot = slot_bytes(hd, sizeof(CT), QUANT);
  float* qs = reinterpret_cast<float*>(smem + slots * slot);  // (rows, hd) scaled queries
  float* acc = qs + rows * hd;   // (rows, hd)
  float* ps = acc + rows * hd;   // (rows, TK) scores, then p
  float* mrow = ps + rows * TK;
  float* lrow = mrow + rows;
  float* resc = lrow + rows;
  const int sp = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // this block's tiles: its span's, clipped to the launch's live tiles
  int lo = 0;
  if (window > 0) {
    const int edge = pos - window + 1;  // token 0's lowest live column
    lo = edge > 0 ? edge / TK : 0;
  }
  const int tps = span / TK;
  const int t0 = max((lo_span + sp) * tps, lo);
  const int t1 = min((lo_span + sp + 1) * tps - 1, (pos + nq - 1) / TK);
  // a row of the cache: KVH * hd values (float mode) or 2 * KVH * hd codes
  // (int8 mode: k at slot 2 kh, v at slot 2 kh + 1)
  const int width = (QUANT ? 2 * kvh : kvh) * hd;
  const CT* kh_k = kc + static_cast<size_t>(b) * s * width + (QUANT ? 2 * kh : kh) * hd;
  const TileCopy<CT> copy(kh_k, QUANT ? kh_k + hd : vc + (kh_k - kc),
                          QUANT ? kvs + (static_cast<size_t>(b) * 2 * kvh + 2 * kh) * s : kvs,
                          width, hd, s, tid);

  // with two slots the first tile flies while the queries are staged
  if (slots == 2) copy.issue(smem, t0 * TK);
  for (int i = tid; i < rows * hd; i += THREADS) {
    const int r = i / hd, d = i - r * hd, c = r / g, gi = r - c * g;
    const float v = ld(q + b * q_sb + c * q_sc + static_cast<long long>(kh * g + gi) * hd + d);
    qs[i] = to_compute<CB>(__fmul_rn(v, qscale));
    acc[i] = 0.f;
  }
  for (int r = tid; r < rows; r += THREADS) {
    mrow[r] = NEG;
    lrow[r] = 0.f;
  }

  for (int t = t0; t <= t1; ++t) {
    const int c0 = t * TK, sl = slots == 2 ? (t - t0) & 1 : 0;
    if (slots == 1) {
      __syncthreads();  // the previous tile's reads of the slot are done
      copy.issue(smem, c0);
    }
    cp_async_wait<0>();
    __syncthreads();  // tile t is visible; every thread is done with tile t - 1
    // the next tile goes into the slot tile t - 1 was read from
    if (slots == 2 && t < t1) copy.issue(smem + (sl ^ 1) * slot, c0 + TK);
    const CT* kt = reinterpret_cast<const CT*>(smem + sl * slot);
    const CT* vt = kt + tile;
    const float* kss = reinterpret_cast<const float*>(vt + tile);  // int8 mode
    const float* vss = kss + TK;

    // scores: a warp takes columns warp, warp + WARPS, ... (CPW of them) of
    // each row; lane l sums d = l, l + 32, ... in order, then a fixed
    // butterfly (every lane ends with the same sum); the CPW columns' sums
    // run side by side, and lane u writes column warp + u * WARPS
    for (int r = 0; r < rows; ++r) {
      float sum[CPW];
#pragma unroll
      for (int u = 0; u < CPW; ++u) sum[u] = 0.f;
      for (int d = lane; d < hd; d += 32) {
        const float qv = qs[r * hd + d];
#pragma unroll
        for (int u = 0; u < CPW; ++u)
          sum[u] = fmaf(qv, cval<CB>(kt + (warp + u * WARPS) * hd + d), sum[u]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < CPW; ++u) sum[u] = __fadd_rn(sum[u], __shfl_xor_sync(FULL, sum[u], o));
      float mine = sum[0];
#pragma unroll
      for (int u = 1; u < CPW; ++u)
        if (lane == u) mine = sum[u];
      if (lane < CPW) {
        const int j = warp + lane * WARPS, col = c0 + j, rp = pos + r / g;
        const bool live = col <= rp && (window <= 0 || col > rp - window);
        ps[r * TK + j] = live ? (QUANT ? __fmul_rn(mine, kss[j]) : mine) : NEG;
      }
    }
    __syncthreads();

    // online softmax: one warp per row, two columns a lane
    for (int r = warp; r < rows; r += WARPS) {
      const float s0 = ps[r * TK + lane], s1 = ps[r * TK + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_prev = mrow[r];
      const float m_new = fmaxf(m_prev, mx);
      const float rs = exp2f(__fsub_rn(m_prev, m_new));
      const float p0 = exp2f(__fsub_rn(s0, m_new)), p1 = exp2f(__fsub_rn(s1, m_new));
      float sum = __fadd_rn(p0, p1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(FULL, sum, o));
      // int8 mode: p times its column's v scale, after l's sum
      ps[r * TK + lane] = to_compute<CB>(QUANT ? __fmul_rn(p0, vss[lane]) : p0);
      ps[r * TK + lane + 32] = to_compute<CB>(QUANT ? __fmul_rn(p1, vss[lane + 32]) : p1);
      __syncwarp();
      if (lane == 0) {
        mrow[r] = m_new;
        lrow[r] = __fadd_rn(__fmul_rn(lrow[r], rs), sum);
        resc[r] = rs;
      }
    }
    __syncthreads();

    // acc = acc * rescale + p . V, a sequential sum over the tile
    for (int i = tid; i < rows * hd; i += THREADS) {
      const int r = i / hd, d = i - r * hd;
      const float* pr = ps + r * TK;
      float pv = 0.f;
#pragma unroll 4
      for (int j = 0; j < TK; j += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(pr + j);
        pv = fmaf(p4.x, cval<CB>(vt + (j + 0) * hd + d), pv);
        pv = fmaf(p4.y, cval<CB>(vt + (j + 1) * hd + d), pv);
        pv = fmaf(p4.z, cval<CB>(vt + (j + 2) * hd + d), pv);
        pv = fmaf(p4.w, cval<CB>(vt + (j + 3) * hd + d), pv);
      }
      acc[i] = __fadd_rn(__fmul_rn(acc[i], resc[r]), pv);
    }
  }
  __syncthreads();  // every accumulator is final

  const int ns = gridDim.x;
  if (ns == 1) {  // one live span: its state divided out (its combine weight is exp2(0) = 1)
    for (int i = tid; i < rows * hd; i += THREADS) {
      const float l = lrow[i / hd];
      store_out<CB>(out, b, nq, h, kh, g, hd, i, l > 0.f ? __fdiv_rn(acc[i], l) : 0.f);
    }
    return;
  }

  // this span's partial state: (rows, hd) acc, then rows m and rows l
  const size_t part = static_cast<size_t>(rows) * (hd + 2);
  const size_t first = (static_cast<size_t>(b) * kvh + kh) * ns;  // this (b, kh)'s span 0
  float* mine = ws + (first + sp) * part;
  for (int i = tid; i < rows * hd; i += THREADS) mine[i] = acc[i];
  for (int r = tid; r < rows; r += THREADS) {
    mine[rows * hd + r] = mrow[r];
    mine[rows * hd + rows + r] = lrow[r];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    unsigned* counter = counters + static_cast<size_t>(b) * kvh + kh;
    last = atomicAdd(counter, 1u) == static_cast<unsigned>(ns - 1);
    if (last) *counter = 0;  // every span of this (b, kh) has arrived
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block combines the spans in ascending order
  const float* parts = ws + first * part;
  float* wts = ps;  // (rows, TK): w_j = exp2(m_j - M)
  float* lpr = qs;  // (rows, TK): l_j * w_j (qs holds rows * hd >= rows * TK floats)
  for (int r = warp; r < rows; r += WARPS) {
    float mj[2], lj[2], mx = NEG;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int j = lane + 32 * k;
      mj[k] = j < ns ? __ldcg(parts + j * part + rows * hd + r) : NEG;
      lj[k] = j < ns ? __ldcg(parts + j * part + rows * hd + rows + r) : 0.f;
      mx = fmaxf(mx, mj[k]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int j = lane + 32 * k;
      if (j < ns) {
        const float w = exp2f(__fsub_rn(mj[k], mx));
        wts[r * TK + j] = w;
        lpr[r * TK + j] = __fmul_rn(lj[k], w);
      }
    }
    __syncwarp();
    if (lane == 0) {
      float l = 0.f;
#pragma unroll 8
      for (int j = 0; j < ns; ++j) l = __fadd_rn(l, lpr[r * TK + j]);
      lrow[r] = l;
    }
  }
  __syncthreads();

  // a = sum_j acc_j * w_j in ascending j, in unrolled runs of 32 and 8 so
  // that a run's partials are loaded together
  for (int i = tid; i < rows * hd; i += THREADS) {
    const float* w = wts + (i / hd) * TK;
    const float* pi = parts + i;
    float a = 0.f;
    int j = 0;
    for (; j + 32 <= ns; j += 32)
#pragma unroll
      for (int k = 0; k < 32; ++k) a = __fadd_rn(a, __fmul_rn(__ldcg(pi + (j + k) * part), w[j + k]));
    for (; j + 8 <= ns; j += 8)
#pragma unroll
      for (int k = 0; k < 8; ++k) a = __fadd_rn(a, __fmul_rn(__ldcg(pi + (j + k) * part), w[j + k]));
    for (; j < ns; ++j) a = __fadd_rn(a, __fmul_rn(__ldcg(pi + j * part), w[j]));
    const float l = lrow[i / hd];
    store_out<CB>(out, b, nq, h, kh, g, hd, i, l > 0.f ? __fdiv_rn(a, l) : 0.f);
  }
}

template <typename QT, typename CT>
int launch(const void* q, long long q_sb, long long q_sc, const void* k, const void* v,
           const float* kvs, void* out, void* ws, void* counters, int b, int nq, int h,
           int kvh, int hd, int s, int pos, int window, int span, int nspans, float qscale,
           int cbf16, cudaStream_t stream) {
  constexpr bool QUANT = sizeof(CT) == 1;
  const int rows = nq * (h / kvh);
  // RING slots where they fit, else one (f32 caches at many rows)
  const int slots = smem_bytes(rows, hd, sizeof(CT), QUANT, RING) <= MAX_SMEM ? RING : 1;
  const size_t smem = smem_bytes(rows, hd, sizeof(CT), QUANT, slots);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  int lo_span = 0;
  if (window > 0) {
    const int edge = pos - window + 1;
    lo_span = edge > 0 ? edge / span : 0;
  }
  // the wrapper sized the workspace for exactly these spans
  if ((pos + nq - 1) / span - lo_span + 1 != nspans) return cudaErrorInvalidValue;
  auto kernel = cbf16 ? flash_decode_kernel<QT, CT, true> : flash_decode_kernel<QT, CT, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<dim3(nspans, kvh, b), THREADS, smem, stream>>>(
      static_cast<const QT*>(q), q_sb, q_sc, static_cast<const CT*>(k),
      static_cast<const CT*>(v), kvs, out, static_cast<float*>(ws),
      static_cast<unsigned*>(counters), nq, h, kvh, hd, s, pos, window, span, lo_span, slots,
      qscale);
  return cudaGetLastError();
}

bool bad_shape(int b, int nq, int h, int kvh, int hd, int s, int pos, int span, int nspans) {
  return b <= 0 || nq <= 0 || kvh <= 0 || h % kvh || hd <= 0 || hd % 128 || pos < 0 ||
         pos + nq > s || span <= 0 || span % TK || nspans <= 0 || nspans > MAX_SPANS;
}

}  // namespace

// q (B, nq, H, hd) with element strides q_sb, q_sc for b and c (h and d
// contiguous), f32 (q_bf16 = 0) or bf16; out (B, nq, H, hd) contiguous in the
// compute dtype (cbf16). pos + nq <= S; window <= 0 means none; qscale is
// sm_scale * log2(e) as an f32. hd % 128 == 0 and H % KVH == 0. span is the
// span's columns (a multiple of 64) and nspans the live spans, at most 64;
// ws holds B * KVH * nspans * nq * (H / KVH) * (hd + 2) f32 partials;
// counters holds B * KVH uint32 zeros, and is left zeroed.

// B4: k, v (B, S, KVH * hd) contiguous, f32 or bf16 (cache_bf16), 16-byte
// aligned.
extern "C" int smmb_flash_decode(const void* q, int q_bf16, long long q_sb,
                                 long long q_sc, const void* k, const void* v,
                                 int cache_bf16, void* out, void* ws, void* counters, int b,
                                 int nq, int h, int kvh, int hd, int s, int pos, int window,
                                 int span, int nspans, float qscale, int cbf16,
                                 void* stream) {
  if (bad_shape(b, nq, h, kvh, hd, s, pos, span, nspans)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    return cache_bf16
               ? launch<__nv_bfloat16, __nv_bfloat16>(q, q_sb, q_sc, k, v, nullptr, out, ws,
                                                      counters, b, nq, h, kvh, hd, s, pos,
                                                      window, span, nspans, qscale, cbf16, st)
               : launch<__nv_bfloat16, float>(q, q_sb, q_sc, k, v, nullptr, out, ws, counters,
                                              b, nq, h, kvh, hd, s, pos, window, span, nspans,
                                              qscale, cbf16, st);
  return cache_bf16
             ? launch<float, __nv_bfloat16>(q, q_sb, q_sc, k, v, nullptr, out, ws, counters, b,
                                            nq, h, kvh, hd, s, pos, window, span, nspans,
                                            qscale, cbf16, st)
             : launch<float, float>(q, q_sb, q_sc, k, v, nullptr, out, ws, counters, b, nq, h,
                                    kvh, hd, s, pos, window, span, nspans, qscale, cbf16, st);
}

// B8: kv (B, S, 2 * KVH * hd) int8 codes, contiguous and 16-byte aligned;
// kv_scale (B, 2 * KVH, S) f32, contiguous.
extern "C" int smmb_flash_decode_quant(const void* q, int q_bf16, long long q_sb,
                                       long long q_sc, const void* kv, const void* kv_scale,
                                       void* out, void* ws, void* counters, int b, int nq,
                                       int h, int kvh, int hd, int s, int pos, int window,
                                       int span, int nspans, float qscale, int cbf16,
                                       void* stream) {
  if (bad_shape(b, nq, h, kvh, hd, s, pos, span, nspans)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* kvs = static_cast<const float*>(kv_scale);
  if (q_bf16)
    return launch<__nv_bfloat16, int8_t>(q, q_sb, q_sc, kv, kv, kvs, out, ws, counters, b, nq,
                                         h, kvh, hd, s, pos, window, span, nspans, qscale,
                                         cbf16, st);
  return launch<float, int8_t>(q, q_sb, q_sc, kv, kv, kvs, out, ws, counters, b, nq, h, kvh,
                               hd, s, pos, window, span, nspans, qscale, cbf16, st);
}
