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
// operations; this first kernel runs on the CUDA cores, far from the
// tensor-core peak (wgmma and the FA3 ping-pong come later).
//
// Design (first, simple version):
//   * A block of 256 threads owns BT (64, or 32 / 16 for wide heads) query
//     rows: QT = BT / gb tokens of gb query heads of one KV head, rows
//     ordered (token, head), so each K and V tile is staged once in shared
//     memory and read by every query head of the group that the block holds
//     (gb is the largest divisor of g that is <= BT).
//   * q is multiplied by scale * log2(e) rounded to q's dtype, the product
//     rounded to q's dtype (flash_attention.py:109). Scores accumulate in f32
//     with fmaf over d in order (a 16 x 16 thread grid, each thread a
//     BT/16 x BT/16 micro-tile); the softmax runs in base 2 (exp2f); masked
//     scores are the finite -1e30: col >= S, and under causal col > t or
//     col <= t - window. p is rounded to v's dtype before P.V; the output is
//     acc / l where l > 0, else 0, in q's dtype. f32 inputs take true f32
//     FMAs (no TF32).
//   * Causal blocks walk only the live kv tiles, ascending: from the tile of
//     the window's lower edge of the block's first token (0 without a window)
//     to the tile of its last token's diagonal, the triangular grid's order
//     (flash_attention.py:630-679). Non-causal blocks walk every kv tile.
//   * Kernels allocate nothing, launch on the caller's stream and do not
//     synchronise; the C entry returns cudaGetLastError().
//
// B9p, the pipelined variant (flash_prefill_pipe_kernel, C entry
// smmb_flash_attention_pipe), replaces _flash_kernel_pipe
// (flash_attention.py:253, pallas_call at :607; causal only). Same block,
// row order, micro-tile, masks and lo/hi walk as the serial kernel, with P
// double-buffered in shared memory (ps[2]): at step s the K tile staged is
// tile s's and the V tile is tile s-1's, and between one pair of barriers
// each thread adds the pending P[(s-1)%2].V_{s-1} to acc (the serial
// kernel's fmaf order over j) and computes its Q.K_s^T micro-tile, which
// does not depend on that sum. The per-row softmax then writes P[s%2] and
// acc is multiplied by the step's rescale. A last flush step adds the final
// pending P.V and stores acc / l. The rounded operations are the serial
// kernel's (acc * r_s + pv_s, each rounded), so at the same tile its output
// is bitwise the serial kernel's. On CUDA cores with one block per SM the
// two halves share the same warps, so there is little to overlap: this is
// the TPU design point carried over, not a faster kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <bool PIPE>
int entry(const void* q, const long long* q_str, const void* k, const long long* k_str,
          const void* v, const long long* v_str, void* out, const long long* o_str,
          int bf16, int b, int t_len, int s_len, int h, int kvh, int hd, int causal,
          int window, float qscale, int bt, void* stream) {
  if (b <= 0 || t_len <= 0 || s_len <= 0 || kvh <= 0 || h % kvh || hd <= 0 ||
      smem_bytes(bt, hd, PIPE) > MAX_SMEM || (PIPE && !causal))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16, PIPE>(bt, q, q_str, k, k_str, v, v_str, out, o_str,
                                              b, t_len, s_len, h, kvh, hd, causal, window,
                                              qscale, st)
              : dispatch<float, PIPE>(bt, q, q_str, k, k_str, v, v_str, out, o_str, b,
                                      t_len, s_len, h, kvh, hd, causal, window, qscale, st);
}

}  // namespace

// q, k, v, out: element strides (b, head, token) in q_str, k_str, v_str,
// o_str, d contiguous; all four f32 (bf16 = 0) or all bf16. bt is the tile
// (64, 32 or 16) whose shared memory fits; window <= 0 means none; qscale
// is scale * log2(e) already rounded to q's dtype.
extern "C" int smmb_flash_attention(const void* q, const long long* q_str,
                                    const void* k, const long long* k_str,
                                    const void* v, const long long* v_str,
                                    void* out, const long long* o_str, int bf16,
                                    int b, int t_len, int s_len, int h, int kvh,
                                    int hd, int causal, int window, float qscale,
                                    int bt, void* stream) {
  return entry<false>(q, q_str, k, k_str, v, v_str, out, o_str, bf16, b, t_len, s_len, h,
                      kvh, hd, causal, window, qscale, bt, stream);
}

// B9p: smmb_flash_attention's arguments; causal must be 1 and bt fit the
// pipelined block's shared memory (two p buffers).
extern "C" int smmb_flash_attention_pipe(const void* q, const long long* q_str,
                                         const void* k, const long long* k_str,
                                         const void* v, const long long* v_str,
                                         void* out, const long long* o_str, int bf16,
                                         int b, int t_len, int s_len, int h, int kvh,
                                         int hd, int causal, int window, float qscale,
                                         int bt, void* stream) {
  return entry<true>(q, q_str, k, k_str, v, v_str, out, o_str, bf16, b, t_len, s_len, h,
                     kvh, hd, causal, window, qscale, bt, stream);
}
