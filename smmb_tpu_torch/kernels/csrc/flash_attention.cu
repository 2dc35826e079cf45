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
// operations: in f32 on the CUDA cores, 4 * B * H * hd * T * (T + 1) / 2
// flops over 66.9 TFLOP/s, 0.513 ms at B=1, H=8, hd 128, T=4096 causal.
//
// Two device bodies; kernels/flash_attention.py::kernel_route picks one per
// call and passes it as `body` (there is no fallback between them):
//   * flash_prefill_mma_kernel<HD, PIPE> (bf16 at hd 64 and 128): tensor
//     cores, mma.sync m16n8k16 bf16 -> f32, in the FlashAttention-2 shape.
//   * flash_prefill_kernel<T, BT, SR, DV, PIPE> (f32 at any hd, bf16 at
//     other widths): CUDA cores, true f32 FMAs (no TF32).
// Both share the contract: q is multiplied by qscale = scale * log2(e)
// rounded to q's dtype, the product rounded to q's dtype
// (flash_attention.py:109); scores accumulate in f32; the softmax runs in
// base 2 (exp2f); masked scores are the finite -1e30 (col >= S, and under
// causal col > t or col <= t - window); l sums the f32 p; p is rounded to
// v's dtype before P.V; the output is acc / l where l > 0, else 0, in q's
// dtype. Blocks own rows (token, head) over the gb query heads of one KV
// head (gb the largest divisor of g that is <= the block's rows), so each K
// and V tile is staged once for the whole group. Causal blocks walk only
// the live kv tiles, ascending (the triangular grid's order,
// flash_attention.py:630-679); non-causal blocks walk every kv tile. The
// grid launches the q tiles last token first, so the longest causal blocks
// do not form the tail. Kernels allocate nothing, launch on the caller's
// stream and do not synchronise; the C entries return cudaGetLastError().
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
//   * Under PIPE the pending P_{s-1} stays in registers as bf16 A fragments:
//     tile s's Q.K^T and the pending P.V are independent tensor-core work in
//     the same warp, beside the softmax's exp2f.
//
// The CUDA-core body computes every output with the first port's rounded
// f32 operations in the first port's order, so its outputs are bitwise
// that body's: each score one fmaf chain over d
// ascending from 0; the kv tile BT (64, or 32 / 16 for wide heads) fixed
// by the first port's shared memory (kernel_tile), since BT sets where the
// online softmax rescales; a row's max, rescale exp2f(m - m_new), p =
// exp2f(s - m_new), its sum in the first port's lane order (lane l adds
// p[l], p[l + 32] from 0, then the xor butterfly over 16, 8, 4, 2, 1), l =
// l * r + sum; pv one fmaf chain over the tile's columns ascending from 0,
// then acc = acc * r + pv (under PIPE acc * r at step s, + pv at s + 1).
// Each row updates only on the kv tiles its first-port block walked (a
// block of BT rows, qt = BT / its gb tokens); on other tiles of this
// block's walk its state is left as it is, so even a row with no live
// column (T > S under a window) reads as before. The design around that:
//   * A block of 256 threads owns R = 16 * SR query rows (SR = 1, 2, 4 or 8,
//     picked by the wrapper, kernels/flash_attention.py::row_tile); 16
//     groups of 16 threads, group tr owning rows tr * SR .. tr * SR + SR - 1
//     and thread tc of it the score columns tc + 16 jj. Lanes tc and tc + 16
//     of the first port's warp live in thread tc, so the row sum is two
//     partials, their add, and four __shfl_xor_sync inside the half-warp.
//   * Q is scaled, rounded and staged once as f32, rows padded to an odd
//     number of 16-byte vectors; K tiles flow through a two-slot cp.async
//     ring of 16-byte copies in the storage type (rows past S zero-filled;
//     a single slot where two do not fit, only serial at hd 901 and 902), V
//     through one slot issued at the start of the step that reads it (under
//     PIPE, V_{s-1} for the pending P.V; the slot is refilled after it). bf16
//     K and V are widened at the fragment load, which is exact. Inputs that
//     16-byte copies cannot read (an odd stride or width) are staged by
//     element loads into the same layout.
//   * Scores from a register micro-tile SR x BT/16 read as 16-byte vectors
//     along d (LDS.128, conflict-free on the odd row stride); masked in
//     registers; the softmax and l stay in registers, replicated over the
//     row's 16 threads. Only p goes to shared memory, per row group, for
//     the P.V of the same threads.
//   * P.V and acc in registers: thread tc owns d vectors tc + 16 c (DV of
//     them, CH at a time) of its SR rows, a separate fmaf chain each, V read
//     as 16-byte vectors, p as SR-wide vectors.
//   * Two barriers a kv tile: K landed (and the V slot free), then V landed
//     (and the K slot free, p written).
// At T=4096 (f32, hd 128, 128-row blocks) the threads issue one LDS.128
// per 10.7 FFMA in the scores and in P.V (the first port: one scalar LDS
// per 2 FFMA in the scores, 2 per FFMA in P.V), so the work is the f32
// FMAs: the bound above.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

using namespace smmb_mma;

// kernels/_build.py compiles this source in parts (PARTS), in parallel: part
// 0 holds the mma body and the C entries, parts 1 to 4 the CUDA-core body's
// instantiations for f32 and bf16, serial and pipelined. Without SMMB_PART
// one build holds everything.
#ifndef SMMB_PART
#define SMMB_PART -1
#endif

namespace smmb_fa {

// one call's operands (element strides b, head, token; d contiguous)
struct Call {
  const void* q;
  const long long* qs;
  const void* k;
  const long long* ks;
  const void* v;
  const long long* vs;
  void* out;
  const long long* os;
  int b, t_len, s_len, h, kvh, hd, causal, window;
  float qscale;
  cudaStream_t stream;
};

// the CUDA-core body with kv tile bt and rows query rows a block
int core_f32(int bt, int rows, const Call& c);
int core_f32_pipe(int bt, int rows, const Call& c);
int core_bf16(int bt, int rows, const Call& c);
int core_bf16_pipe(int bt, int rows, const Call& c);

}  // namespace smmb_fa

namespace {

using smmb_fa::Call;

constexpr int THREADS = 256;
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

// ---- f32 (any hd) and bf16 at other widths on the CUDA cores

// The CUDA-core block's shared memory (bytes): Q (rows x lq floats, lq an
// odd number of 4-float vectors, and up to 16 vectors of skew), kslots K
// slots (bt rows of an odd number nv | 1 of 16-byte vectors), one V slot
// (bt rows of nv vectors) and p (rows x bt floats, and 16 vectors of skew);
// nv = the 16-byte vectors of a row of hd elements of size esize
// (kernels/flash_attention.py::core_shared_bytes).
__host__ __device__ __forceinline__ int core_vectors(int hd, int esize) {
  return (hd * esize + 15) / 16;
}
__host__ __device__ __forceinline__ int core_lq(int nv, int esize) {
  return 4 * ((nv * 16 / esize / 4) | 1);
}
size_t core_smem(int esize, int hd, int rows, int bt, int kslots) {
  const size_t nv = core_vectors(hd, esize), lq = core_lq(nv, esize);
  return 4 * (rows * lq + 64) + 16 * (kslots * bt * (nv | 1) + bt * nv) + 4 * (rows * bt + 64);
}

// one 16-byte vector of shared memory as f32 (bf16 widened, which is exact)
__device__ __forceinline__ void vec_f32(const float* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
__device__ __forceinline__ void vec_f32(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f[2 * e] = __uint_as_float(w[e] << 16);
    f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}
// N consecutive floats of shared memory (N a multiple of 4, or 1 or 2)
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&f)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      f[i] = x.x;
      f[i + 1] = x.y;
      f[i + 2] = x.z;
      f[i + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    f[0] = x.x;
    f[1] = x.y;
  } else {
    f[0] = *p;
  }
}
template <int N>
__device__ __forceinline__ void store_f32(float* p, const float (&f)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
  } else {
    *p = f[0];
  }
}

// kv rows c0 .. c0 + BT - 1 of one head into a slot of rows of ld elements:
// 16-byte cp.async copies where vec (rows past S zero-filled), else element
// loads zero-padded past hd
template <typename T, int BT>
__device__ __forceinline__ void stage_rows(T* slot, int ld, const T* __restrict__ src,
                                           long long st, int c0, int s_len, int hd,
                                           int nv, int vec, int tid) {
  constexpr int VE = 16 / sizeof(T);
  for (int i = tid; i < BT * nv; i += THREADS) {
    const int j = i / nv, c = i - j * nv;
    const bool ok = c0 + j < s_len;
    T* to = slot + j * ld + c * VE;
    const T* from = src + (c0 + j) * st + c * VE;
    if (vec) {
      cp_async16(to, ok ? from : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        const bool in = ok && c * VE + e < hd;
        if constexpr (sizeof(T) == 4) to[e] = in ? from[e] : 0.f;
        else to[e] = in ? from[e] : __float2bfloat16_rn(0.f);
      }
    }
  }
}

// The first port's per-lane row sum of one tile, for lanes tc and tc + 16
// of its warp: lane l added p[l], p[l + 32] (BT = 64) or p[l] (l < BT <=
// 32) from 0, then the butterfly's first step (xor 16) added the two lanes.
// p holds columns tc + 16 jj.
template <int SC>
__device__ __forceinline__ float lane_pair_sum(const float (&p)[SC]) {
  if constexpr (SC == 4)
    return __fadd_rn(__fadd_rn(__fadd_rn(0.f, p[0]), p[2]),
                     __fadd_rn(__fadd_rn(0.f, p[1]), p[3]));
  else if constexpr (SC == 2)
    return __fadd_rn(__fadd_rn(0.f, p[0]), __fadd_rn(0.f, p[1]));
  else
    return __fadd_rn(__fadd_rn(0.f, p[0]), 0.f);
}

// The kv tiles [lo, hi] a first-port block walked: the block of qt tokens
// holding token tok, with kv tile BT
template <int BT>
__device__ __forceinline__ void walk_range(int tok, int qt, int t_len, int ns, int causal,
                                           int window, int& lo, int& hi) {
  const int t0 = tok / qt * qt, last = min(t0 + qt, t_len) - 1;
  lo = 0;
  hi = ns - 1;
  if (causal) {
    hi = min(last / BT, ns - 1);
    if (window > 0) {
      const int edge = t0 - window + 1;
      lo = edge > 0 ? edge / BT : 0;
    }
  }
}

// The CUDA-core kernel. BT: the kv tile; SR: rows a thread (a block owns
// 16 * SR); DV: d vectors a thread in P.V (16 * DV * VE >= hd); pqt: the
// tokens of a first-port block (BT / its gb); kslots: 2 or 1 K slots (1
// only serial). PIPE = false is the serial walk: step s scores tile s, runs
// its softmax, then acc = acc * r_s + P_s.V_s. PIPE = true is B9p's: step s
// adds the pending P_{s-1}.V_{s-1} to acc, then scores tile s, runs its
// softmax and acc *= r_s; step hi + 1 only flushes.
template <typename T, int BT, int SR, int DV, bool PIPE>
__global__ void __launch_bounds__(THREADS, 1)
    flash_prefill_kernel(const T* __restrict__ q, long long qsb, long long qsh,
                         long long qst, const T* __restrict__ k, long long ksb,
                         long long ksh, long long kst, const T* __restrict__ v,
                         long long vsb, long long vsh, long long vst,
                         T* __restrict__ out, long long osb, long long osh,
                         long long ost, int t_len, int s_len, int h, int kvh, int hd,
                         int gb, int pqt, int causal, int window, float qscale, int vec,
                         int kslots) {
  constexpr int VE = 16 / sizeof(T);  // elements of a 16-byte vector
  constexpr int R = 16 * SR;          // query rows of the block
  constexpr int SC = BT / 16;         // score columns a thread
  constexpr int CHF = 32 / (SR * VE);
  constexpr int CH = CHF < 1 ? 1 : (CHF < DV ? CHF : DV);  // d vectors a P.V pass
  static_assert(DV % CH == 0, "P.V passes cover DV");
  // a row group's Q rows start QSKEW floats past the previous group's, so
  // the two groups of a warp read different banks (at SR = 8, SR * lq is a
  // multiple of 8 vectors); its p starts 4 floats past the previous group's
  // for the same reason (BT * SR is)
  constexpr int QSKEW = SR == 8 ? 4 : 0;
  extern __shared__ __align__(16) unsigned char core_mem[];
  const int nv = core_vectors(hd, sizeof(T)), dp = nv * VE;
  const int lq = core_lq(nv, sizeof(T)), lk = VE * (nv | 1);
  float* qs = reinterpret_cast<float*>(core_mem);  // 16 groups x (SR, lq), skewed
  T* ks = reinterpret_cast<T*>(qs + R * lq + 64);   // kslots x (BT, lk)
  T* vs = ks + kslots * BT * lk;                     // (BT, dp)
  float* ps = reinterpret_cast<float*>(vs + BT * dp);  // 16 groups x (BT, SR), skewed

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int g = h / kvh, qt = R / gb, rows = qt * gb, groups = g / gb;
  const int bx = blockIdx.x;
  const int gs = bx % groups, kh = (bx / groups) % kvh, b = bx / (groups * kvh);
  const int t0 = (gridDim.y - 1 - blockIdx.y) * qt;  // last tokens first
  const int ns = (s_len + BT - 1) / BT;
  const int last_tok = min(t0 + qt, t_len) - 1;
  int lo, hi, unused;
  walk_range<BT>(t0, pqt, t_len, ns, causal, window, lo, unused);
  walk_range<BT>(last_tok, pqt, t_len, ns, causal, window, unused, hi);
  const T* kb = k + b * ksb + kh * ksh;
  const T* vb = v + b * vsb + kh * vsh;
  stage_rows<T, BT>(ks, lk, kb, kst, lo * BT, s_len, hd, nv, vec, tid);
  cp_async_commit();

  // row r: token t0 + r / gb of query head kh * g + gs * gb + r % gb
  for (int i = tid; i < R * dp; i += THREADS) {
    const int r = i / dp, d = i - r * dp;
    const int tok = t0 + r / gb, head = kh * g + gs * gb + r % gb;
    float val = 0.f;
    if (r < rows && tok < t_len && d < hd)
      val = rnd(__fmul_rn(ld(q + b * qsb + head * qsh + tok * qst + d), qscale), q);
    qs[r * lq + r / SR * QSKEW + d] = val;
  }

  // this thread's rows: token, the first-port walk (lo << 16 | hi; none for
  // a row past the block's), the softmax state
  int rtok[SR];
  unsigned rwalk[SR];
  float m[SR], l[SR], rsc[SR], acc[SR][DV][VE];
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    const int r = tr * SR + i;
    rtok[i] = t0 + r / gb;
    int rlo, rhi;
    walk_range<BT>(rtok[i], pqt, t_len, ns, causal, window, rlo, rhi);
    rwalk[i] = r < rows && rtok[i] < t_len && rlo <= rhi ? unsigned(rlo) << 16 | rhi
                                                           : 0xffff0000u;
    m[i] = NEG;
    l[i] = 0.f;
    rsc[i] = 1.f;
#pragma unroll
    for (int c = 0; c < DV; ++c)
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[i][c][e] = 0.f;
  }
  // a warp whose rows are all past the block's (a ragged last q tile) only
  // stages
  const bool busy = __any_sync(FULL, tr * SR < rows && rtok[0] < t_len);
  float* pg = ps + tr * (BT * SR + 4);  // this row group's p: (BT, SR)

  // scores of tile `tile` from K slot kt, masked; the softmax; p to pg
  auto scores_softmax = [&](const T* kt, int tile) {
    float sc[SR][SC];
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int jj = 0; jj < SC; ++jj) sc[i][jj] = 0.f;
    const float* qrow = qs + tr * (SR * lq + QSKEW);
    const T* krow = kt + tc * lk;
#pragma unroll 2
    for (int c = 0; c < nv; ++c) {
      float kf[SC][VE];
#pragma unroll
      for (int jj = 0; jj < SC; ++jj) vec_f32(krow + 16 * jj * lk + c * VE, kf[jj]);
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        float qf[VE];
        load_f32<VE>(qrow + i * lq + c * VE, qf);
#pragma unroll
        for (int e = 0; e < VE; ++e)
#pragma unroll
          for (int jj = 0; jj < SC; ++jj) sc[i][jj] = fmaf(qf[e], kf[jj][e], sc[i][jj]);
      }
    }
    const int c0 = tile * BT;
    float p[SC][SR];
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const int tok = rtok[i];
      float mx = NEG;
#pragma unroll
      for (int jj = 0; jj < SC; ++jj) {
        const int col = c0 + tc + 16 * jj;
        bool live = col < s_len;
        if (causal) live = live && col <= tok && (window <= 0 || col > tok - window);
        if (!live) sc[i][jj] = NEG;
        mx = fmaxf(mx, sc[i][jj]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      // a tile outside the row's first-port walk leaves its state as it is
      const bool walk = tile >= int(rwalk[i] >> 16) && tile <= int(rwalk[i] & 0xffffu);
      const float m_new = walk ? fmaxf(m[i], mx) : m[i];
      rsc[i] = walk ? exp2f(__fsub_rn(m[i], m_new)) : 1.f;
      float pr[SC];
#pragma unroll
      for (int jj = 0; jj < SC; ++jj) pr[jj] = walk ? exp2f(__fsub_rn(sc[i][jj], m_new)) : 0.f;
      float sum = lane_pair_sum<SC>(pr);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(FULL, sum, o));
      if (walk) {
        l[i] = __fadd_rn(__fmul_rn(l[i], rsc[i]), sum);
        m[i] = m_new;
      }
#pragma unroll
      for (int jj = 0; jj < SC; ++jj) p[jj][i] = rnd(pr[jj], v);
    }
#pragma unroll
    for (int jj = 0; jj < SC; ++jj) store_f32<SR>(pg + (tc + 16 * jj) * SR, p[jj]);
  };

  // P.V of the tile in the V slot with the p in pg: serial acc = acc * r +
  // pv, B9p's pending acc = acc + pv
  auto pv_add = [&]() {
#pragma unroll
    for (int cb = 0; cb < DV; cb += CH) {
      float pv[SR][CH][VE];
      const T* vcol[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int vi = tc + 16 * (cb + c);
        vcol[c] = vs + (vi < nv ? vi : 0) * VE;  // a vector past the row: never stored
#pragma unroll
        for (int i = 0; i < SR; ++i)
#pragma unroll
          for (int e = 0; e < VE; ++e) pv[i][c][e] = 0.f;
      }
#pragma unroll 4
      for (int j = 0; j < BT; ++j) {
        float pr[SR];
        load_f32<SR>(pg + j * SR, pr);
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          float vf[VE];
          vec_f32(vcol[c] + j * dp, vf);
#pragma unroll
          for (int i = 0; i < SR; ++i)
#pragma unroll
            for (int e = 0; e < VE; ++e) pv[i][c][e] = fmaf(pr[i], vf[e], pv[i][c][e]);
        }
      }
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int c = 0; c < CH; ++c)
#pragma unroll
          for (int e = 0; e < VE; ++e) {
            float& a = acc[i][cb + c][e];
            a = PIPE ? __fadd_rn(a, pv[i][c][e]) : __fadd_rn(__fmul_rn(a, rsc[i]), pv[i][c][e]);
          }
    }
  };

  // tile x lives in K slot (x - lo) & 1 (slot 0 with one slot); V in its one
  const int steps = hi - lo + 1 + (PIPE ? 1 : 0);
  for (int n = 0; n < steps; ++n) {
    const int tile = lo + n;
    const T* kt = ks + (kslots == 2 ? (n & 1) : 0) * BT * lk;
    T* knext = ks + (kslots == 2 ? ((n + 1) & 1) : 0) * BT * lk;
    cp_async_wait<0>();
    __syncthreads();  // K of this step landed; the V slot and the other K slot are free
    if constexpr (!PIPE) {
      stage_rows<T, BT>(vs, dp, vb, vst, tile * BT, s_len, hd, nv, vec, tid);
      cp_async_commit();
      if (kslots == 2 && tile + 1 <= hi)
        stage_rows<T, BT>(knext, lk, kb, kst, (tile + 1) * BT, s_len, hd, nv, vec, tid);
      cp_async_commit();
      if (busy) scores_softmax(kt, tile);
      if (kslots == 2) cp_async_wait<1>();
      else cp_async_wait<0>();
      __syncthreads();  // V landed; the K slot read; p written
      if (kslots == 1 && tile + 1 <= hi)
        stage_rows<T, BT>(knext, lk, kb, kst, (tile + 1) * BT, s_len, hd, nv, vec, tid);
      cp_async_commit();
      if (busy) pv_add();
    } else {
      const bool comp = tile <= hi;
      if (tile + 1 <= hi)
        stage_rows<T, BT>(knext, lk, kb, kst, (tile + 1) * BT, s_len, hd, nv, vec, tid);
      cp_async_commit();
      if (busy && n > 0) pv_add();  // the pending P_{s-1}.V_{s-1}
      __syncthreads();  // the V slot and p read
      if (!comp) break;
      stage_rows<T, BT>(vs, dp, vb, vst, tile * BT, s_len, hd, nv, vec, tid);
      cp_async_commit();
      if (busy) {
        scores_softmax(kt, tile);
#pragma unroll
        for (int i = 0; i < SR; ++i)
#pragma unroll
          for (int c = 0; c < DV; ++c)
#pragma unroll
            for (int e = 0; e < VE; ++e) acc[i][c][e] = __fmul_rn(acc[i][c][e], rsc[i]);
      }
    }
  }
  cp_async_wait<0>();
  if (!busy) return;

#pragma unroll
  for (int i = 0; i < SR; ++i) {
    const int r = tr * SR + i;
    if (r >= rows || rtok[i] >= t_len) continue;
    const int head = kh * g + gs * gb + r % gb;
    T* o = out + b * osb + head * osh + rtok[i] * ost;
    const float li = l[i];
#pragma unroll
    for (int c = 0; c < DV; ++c) {
      const int d0 = (tc + 16 * c) * VE;
#pragma unroll
      for (int e = 0; e < VE; ++e)
        if (d0 + e < hd) st(o + d0 + e, li > 0.f ? __fdiv_rn(acc[i][c][e], li) : 0.f);
    }
  }
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

// 16-byte copies can read x in place: a 16-byte aligned pointer and
// strides of whole vectors of ve elements
bool vectors_aligned(const void* x, const long long* st, int ve) {
  if (reinterpret_cast<uintptr_t>(x) % 16) return false;
  for (int j = 0; j < 3; ++j)
    if (st[j] % ve) return false;
  return true;
}

template <typename T, int BT, int SR, int DV, bool PIPE>
int launch_core(const Call& c, int kslots, size_t smem) {
  constexpr int VE = 16 / sizeof(T);
  auto kernel = flash_prefill_kernel<T, BT, SR, DV, PIPE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int g = c.h / c.kvh, gb = largest_divisor_at_most(g, 16 * SR), qt = 16 * SR / gb;
  const int pqt = BT / largest_divisor_at_most(g, BT);  // the first port's block
  const int tiles = (c.t_len + qt - 1) / qt;
  if (tiles > 65535 || (c.s_len + BT - 1) / BT > 65535) return cudaErrorInvalidValue;
  const int vec = c.hd % VE == 0 && vectors_aligned(c.k, c.ks, VE) &&
                  vectors_aligned(c.v, c.vs, VE);
  const dim3 grid(c.b * c.kvh * (g / gb), tiles);
  kernel<<<grid, THREADS, smem, c.stream>>>(
      static_cast<const T*>(c.q), c.qs[0], c.qs[1], c.qs[2], static_cast<const T*>(c.k),
      c.ks[0], c.ks[1], c.ks[2], static_cast<const T*>(c.v), c.vs[0], c.vs[1], c.vs[2],
      static_cast<T*>(c.out), c.os[0], c.os[1], c.os[2], c.t_len, c.s_len, c.h, c.kvh,
      c.hd, gb, pqt, c.causal, c.window, c.qscale, vec, kslots);
  return cudaGetLastError();
}

// rows a thread: 1, 2, 4 or 8, as many as keep acc (SR * DV * VE floats)
// within 64 registers
template <typename T, int BT, int DV, bool PIPE>
int core_by_rows(int sr, const Call& c, int kslots, size_t smem) {
  constexpr int SRMAX = 64 / (DV * (16 / int(sizeof(T))));
  switch (sr) {
    case 1:
      return launch_core<T, BT, 1, DV, PIPE>(c, kslots, smem);
    case 2:
      if constexpr (SRMAX >= 2) return launch_core<T, BT, 2, DV, PIPE>(c, kslots, smem);
      break;
    case 4:
      if constexpr (SRMAX >= 4) return launch_core<T, BT, 4, DV, PIPE>(c, kslots, smem);
      break;
    case 8:
      if constexpr (SRMAX >= 8) return launch_core<T, BT, 8, DV, PIPE>(c, kslots, smem);
      break;
  }
  return cudaErrorInvalidValue;
}

// d vectors a thread: the powers of two that the widths of kv tile BT
// need (kernel_tile: 64 up to hd 209, 32 from 194 to 444, 16 from 437 to
// 902), ceil(ceil(hd / VE) / 16) rounded up
template <typename T, int BT, bool PIPE>
int core_by_width(int dv, int sr, const Call& c, int kslots, size_t smem) {
  constexpr int HI = (sizeof(T) == 4 ? 4 : 2) * (64 / BT), LO = BT == 64 ? 1 : HI / 2;
  switch (dv) {
    case 1:
      if constexpr (LO <= 1) return core_by_rows<T, BT, 1, PIPE>(sr, c, kslots, smem);
      break;
    case 2:
      if constexpr (LO <= 2 && HI >= 2) return core_by_rows<T, BT, 2, PIPE>(sr, c, kslots, smem);
      break;
    case 4:
      if constexpr (LO <= 4 && HI >= 4) return core_by_rows<T, BT, 4, PIPE>(sr, c, kslots, smem);
      break;
    case 8:
      if constexpr (LO <= 8 && HI >= 8) return core_by_rows<T, BT, 8, PIPE>(sr, c, kslots, smem);
      break;
    case 16:
      if constexpr (HI >= 16) return core_by_rows<T, BT, 16, PIPE>(sr, c, kslots, smem);
      break;
  }
  return cudaErrorInvalidValue;
}

// the CUDA-core body with kv tile bt and rows query rows a block
template <typename T, bool PIPE>
int launch_cuda_core(int bt, int rows, const Call& c) {
  if (rows != 16 && rows != 32 && rows != 64 && rows != 128) return cudaErrorInvalidValue;
  const int need = (core_vectors(c.hd, sizeof(T)) + 15) / 16;
  int dv = 1;
  while (dv < need) dv *= 2;
  int kslots = 2;
  size_t smem = core_smem(sizeof(T), c.hd, rows, bt, 2);
  if (smem > MAX_SMEM && !PIPE) smem = core_smem(sizeof(T), c.hd, rows, bt, kslots = 1);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const int sr = rows / 16;
  switch (bt) {
    case 64:
      return core_by_width<T, 64, PIPE>(dv, sr, c, kslots, smem);
    case 32:
      return core_by_width<T, 32, PIPE>(dv, sr, c, kslots, smem);
    case 16:
      return core_by_width<T, 16, PIPE>(dv, sr, c, kslots, smem);
  }
  return cudaErrorInvalidValue;
}

#if SMMB_PART <= 0
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
// cores): any dtype and hd, kv tile bt, rows query rows a block
template <bool PIPE>
int entry(const void* q, const long long* q_str, const void* k, const long long* k_str,
          const void* v, const long long* v_str, void* out, const long long* o_str,
          int bf16, int b, int t_len, int s_len, int h, int kvh, int hd, int causal,
          int window, float qscale, int body, int bt, int rows, void* stream) {
  if (b <= 0 || t_len <= 0 || s_len <= 0 || kvh <= 0 || h % kvh || hd <= 0 ||
      (PIPE && !causal))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (!bf16 || bt != MMA_BR || rows != MMA_BR ||
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
  if (body != 0) return cudaErrorInvalidValue;
  const Call c{q, q_str, k, k_str, v, v_str, out, o_str, b, t_len, s_len, h, kvh, hd,
               causal, window, qscale, st};
  if (PIPE)
    return bf16 ? smmb_fa::core_bf16_pipe(bt, rows, c) : smmb_fa::core_f32_pipe(bt, rows, c);
  return bf16 ? smmb_fa::core_bf16(bt, rows, c) : smmb_fa::core_f32(bt, rows, c);
}
#endif

}  // namespace

#if SMMB_PART < 0 || SMMB_PART == 1
int smmb_fa::core_f32(int bt, int rows, const Call& c) {
  return launch_cuda_core<float, false>(bt, rows, c);
}
#endif
#if SMMB_PART < 0 || SMMB_PART == 2
int smmb_fa::core_f32_pipe(int bt, int rows, const Call& c) {
  return launch_cuda_core<float, true>(bt, rows, c);
}
#endif
#if SMMB_PART < 0 || SMMB_PART == 3
int smmb_fa::core_bf16(int bt, int rows, const Call& c) {
  return launch_cuda_core<__nv_bfloat16, false>(bt, rows, c);
}
#endif
#if SMMB_PART < 0 || SMMB_PART == 4
int smmb_fa::core_bf16_pipe(int bt, int rows, const Call& c) {
  return launch_cuda_core<__nv_bfloat16, true>(bt, rows, c);
}
#endif

#if SMMB_PART <= 0

// q, k, v, out: element strides (b, head, token) in q_str, k_str, v_str,
// o_str, d contiguous; all four f32 (bf16 = 0) or all bf16. body 1 is the
// tensor-core body (bf16, hd 64 or 128, bt and rows 64, 16-byte aligned q,
// k, v with strides of whole 8-element pieces), body 0 the CUDA-core body
// with kv tile bt (64, 32 or 16: kernel_tile's) and rows (16, 32, 64 or
// 128: row_tile's) query rows a block, whose shared memory must fit;
// window <= 0 means none; qscale is scale * log2(e) already rounded to q's
// dtype.
extern "C" int smmb_flash_attention(const void* q, const long long* q_str,
                                    const void* k, const long long* k_str,
                                    const void* v, const long long* v_str,
                                    void* out, const long long* o_str, int bf16,
                                    int b, int t_len, int s_len, int h, int kvh,
                                    int hd, int causal, int window, float qscale,
                                    int body, int bt, int rows, void* stream) {
  return entry<false>(q, q_str, k, k_str, v, v_str, out, o_str, bf16, b, t_len, s_len, h,
                      kvh, hd, causal, window, qscale, body, bt, rows, stream);
}

// B9p: smmb_flash_attention's arguments; causal must be 1, and under body 0
// the block must fit with two K slots.
extern "C" int smmb_flash_attention_pipe(const void* q, const long long* q_str,
                                         const void* k, const long long* k_str,
                                         const void* v, const long long* v_str,
                                         void* out, const long long* o_str, int bf16,
                                         int b, int t_len, int s_len, int h, int kvh,
                                         int hd, int causal, int window, float qscale,
                                         int body, int bt, int rows, void* stream) {
  return entry<true>(q, q_str, k, k_str, v, v_str, out, o_str, bf16, b, t_len, s_len, h,
                     kvh, hd, causal, window, qscale, body, bt, rows, stream);
}
#endif
