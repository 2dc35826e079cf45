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
// FLOPs per byte.
//
// Design (first, simple version; CUDA cores, no split of the cache across
// blocks):
//   * One block of 256 threads per (KV head, batch row). It stages the nq * g
//     query rows of its KV head (row r = c * g + gi is token c, query head
//     kvh * g + gi) in shared memory, with sm_scale * log2(e) folded in: the
//     product is taken in f32 and rounded to the compute dtype, which is the
//     arithmetic of flash_decode.py:308-310.
//   * It walks the live cache tiles of TK = 64 columns in ascending order:
//     from the tile holding the window's lower edge of token 0 (0 without a
//     window) up to the tile holding column pos + nq - 1. No other tile is
//     read. Each K and V tile is cast to the compute dtype as it is staged.
//   * The int8 mode is another tile loader: one 16-byte load gives 16 codes
//     of a row's k (or v) span, each converted to float as it is staged (an
//     int8 code is exact in bf16 and f32); the tile's TK k scales and TK v
//     scales are staged beside it. A score is multiplied by its column's k
//     scale after the Q.K sum (flash_decode.py:169; linear, so it commutes
//     with the fold on q), and p by its column's v scale before it is rounded
//     for P.V (:198), while l sums the unscaled p (:190-194). The walk, the
//     sums and the rescale are the float mode's.
//   * Scores accumulate in f32 (fmaf, never TF32 or bf16 sums); masked
//     scores are the finite -1e30, never -inf; the softmax runs in base 2
//     (exp2f). p is rounded to the compute dtype before P.V, l sums the
//     unrounded p; the output is acc / l where l > 0, else 0.
//   * Row identity (the speculative-decoding contract): the order of every
//     sum of a row depends on hd and TK only. A score is one warp's sum with
//     lane-strided d and a fixed butterfly; a row's max and sum are one
//     warp's butterfly over the tile; P.V is a sequential sum over the tile.
//     Which rows share a block changes nothing, and a tile that is fully
//     masked for a row is a bitwise no-op for it (rescale exp2(0) = 1, p = 0;
//     before the row's first live tile, everything it added is multiplied by
//     exp2(-1e30 - m) = 0). So a token's row is the same at nq = 1 and inside
//     a chunk, at B = 1 and inside a batch, in both modes.
//   * Kernels allocate nothing, launch on the caller's stream and do not
//     synchronise; the C entries return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TK = 64;               // cache columns per tile
constexpr int MAX_SMEM = 232448;     // dynamic shared memory a block may use
constexpr float NEG = -1e30f;        // a masked score
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_compute(float v, int cbf16) {
  return cbf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// 16 bytes of a cache row as floats: 4 f32 or 8 bf16 values
__device__ __forceinline__ void load16(const float* p, float* dst) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  dst[0] = u.x; dst[1] = u.y; dst[2] = u.z; dst[3] = u.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* dst) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// 16 bytes of the int8 cache: 16 codes
__device__ __forceinline__ void load16(const int8_t* p, float* dst) {
  const int4 u = __ldg(reinterpret_cast<const int4*>(p));
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 16; ++i) dst[i] = static_cast<float>(c[i]);
}

size_t smem_bytes(int rows, int hd, bool quant) {
  return sizeof(float) * (static_cast<size_t>(rows) * (2 * hd + TK + 3) +
                          2 * static_cast<size_t>(TK) * hd + (quant ? 2 * TK : 0));
}

// CT is the cache's element type: float or bf16 (float mode, kc and vc the
// two caches), int8_t (int8 mode, kc the merged codes, vc unused, kvs the
// scales).
template <typename QT, typename CT>
__global__ void __launch_bounds__(THREADS)
    flash_decode_kernel(const QT* __restrict__ q, long long q_sb, long long q_sc,
                        const CT* __restrict__ kc, const CT* __restrict__ vc,
                        const float* __restrict__ kvs, void* __restrict__ out,
                        int nq, int h, int kvh, int hd, int s, int pos, int window,
                        float qscale, int cbf16) {
  constexpr bool QUANT = sizeof(CT) == 1;
  constexpr int VEC = 16 / sizeof(CT);
  extern __shared__ float smem[];
  const int g = h / kvh, rows = nq * g;
  float* qs = smem;              // (rows, hd) scaled queries
  float* ks = qs + rows * hd;    // (TK, hd) K tile
  float* vs = ks + TK * hd;      // (TK, hd) V tile
  float* ps = vs + TK * hd;      // (rows, TK) scores, then p
  float* acc = ps + rows * TK;   // (rows, hd)
  float* mrow = acc + rows * hd;
  float* lrow = mrow + rows;
  float* resc = lrow + rows;
  float* kss = resc + rows;      // int8 mode: the tile's TK k scales
  float* vss = kss + TK;         //            and TK v scales
  const int kh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < rows * hd; i += THREADS) {
    const int r = i / hd, d = i - r * hd, c = r / g, gi = r - c * g;
    const float v = ld(q + b * q_sb + c * q_sc + static_cast<long long>(kh * g + gi) * hd + d);
    qs[i] = to_compute(__fmul_rn(v, qscale), cbf16);
    acc[i] = 0.f;
  }
  for (int r = tid; r < rows; r += THREADS) {
    mrow[r] = NEG;
    lrow[r] = 0.f;
  }

  const int top = (pos + nq - 1) / TK;
  int lo = 0;
  if (window > 0) {
    const int edge = pos - window + 1;  // token 0's lowest live column
    lo = edge > 0 ? edge / TK : 0;
  }
  // a row of the cache: KVH * hd values (float mode) or 2 * KVH * hd codes
  // (int8 mode: k at slot 2 kh, v at slot 2 kh + 1)
  const size_t width = static_cast<size_t>(QUANT ? 2 * kvh : kvh) * hd;
  const size_t kbase = static_cast<size_t>(b) * s * width +
                       static_cast<size_t>(QUANT ? 2 * kh : kh) * hd;
  const size_t vbase = QUANT ? kbase + hd : kbase;
  const CT* vsrc = QUANT ? kc : vc;
  const float* ksrow = QUANT ? kvs + (static_cast<size_t>(b) * 2 * kvh + 2 * kh) * s : nullptr;
  const int vecs_per_row = hd / VEC;

  for (int t = lo; t <= top; ++t) {
    const int c0 = t * TK;
    __syncthreads();  // the previous tile's reads of ks, vs, ps, kss, vss are done
#pragma unroll 4
    for (int i = tid; i < TK * vecs_per_row; i += THREADS) {
      const int j = i / vecs_per_row, d = (i - j * vecs_per_row) * VEC;
      float kv[VEC], vv[VEC];
      if (c0 + j < s) {
        const size_t row = static_cast<size_t>(c0 + j) * width + d;
        load16(kc + kbase + row, kv);
        load16(vsrc + vbase + row, vv);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kv[e] = vv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        // codes are exact in either compute dtype
        ks[j * hd + d + e] = QUANT ? kv[e] : to_compute(kv[e], cbf16);
        vs[j * hd + d + e] = QUANT ? vv[e] : to_compute(vv[e], cbf16);
      }
    }
    if (QUANT && tid < TK) {
      const bool in = c0 + tid < s;
      kss[tid] = in ? ksrow[c0 + tid] : 0.f;
      vss[tid] = in ? ksrow[s + c0 + tid] : 0.f;
    }
    __syncthreads();

    // scores: one warp per (row, column), lanes over d, fixed butterfly
    for (int pr = warp; pr < rows * TK; pr += WARPS) {
      const int r = pr / TK, j = pr - r * TK;
      const float* qr = qs + r * hd;
      const float* kr = ks + j * hd;
      float sum = 0.f;
      for (int d = lane; d < hd; d += 32) sum = fmaf(qr[d], kr[d], sum);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(FULL, sum, o));
      if (lane == 0) {
        const int col = c0 + j, rp = pos + r / g;
        const bool live = col <= rp && (window <= 0 || col > rp - window);
        ps[pr] = live ? (QUANT ? __fmul_rn(sum, kss[j]) : sum) : NEG;
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
      ps[r * TK + lane] = to_compute(QUANT ? __fmul_rn(p0, vss[lane]) : p0, cbf16);
      ps[r * TK + lane + 32] =
          to_compute(QUANT ? __fmul_rn(p1, vss[lane + 32]) : p1, cbf16);
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
#pragma unroll 8
      for (int j = 0; j < TK; ++j) pv = fmaf(pr[j], vs[j * hd + d], pv);
      acc[i] = __fadd_rn(__fmul_rn(acc[i], resc[r]), pv);
    }
  }
  __syncthreads();

  for (int i = tid; i < rows * hd; i += THREADS) {
    const int r = i / hd, d = i - r * hd, c = r / g, gi = r - c * g;
    const float l = lrow[r];
    const float o = l > 0.f ? __fdiv_rn(acc[i], l) : 0.f;
    const size_t oi = ((static_cast<size_t>(b) * nq + c) * h + kh * g + gi) * hd + d;
    if (cbf16)
      static_cast<__nv_bfloat16*>(out)[oi] = __float2bfloat16_rn(o);
    else
      static_cast<float*>(out)[oi] = o;
  }
}

template <typename QT, typename CT>
int launch(const void* q, long long q_sb, long long q_sc, const void* k,
           const void* v, const float* kvs, void* out, int b, int nq, int h,
           int kvh, int hd, int s, int pos, int window, float qscale, int cbf16,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(nq * (h / kvh), hd, sizeof(CT) == 1);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  auto kernel = flash_decode_kernel<QT, CT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<dim3(kvh, b), THREADS, smem, stream>>>(
      static_cast<const QT*>(q), q_sb, q_sc, static_cast<const CT*>(k),
      static_cast<const CT*>(v), kvs, out, nq, h, kvh, hd, s, pos, window, qscale,
      cbf16);
  return cudaGetLastError();
}

bool bad_shape(int b, int nq, int h, int kvh, int hd, int s, int pos) {
  return b <= 0 || nq <= 0 || kvh <= 0 || h % kvh || hd <= 0 || hd % 128 || pos < 0 ||
         pos + nq > s;
}

}  // namespace

// q (B, nq, H, hd) with element strides q_sb, q_sc for b and c (h and d
// contiguous), f32 (q_bf16 = 0) or bf16; out (B, nq, H, hd) contiguous in the
// compute dtype (cbf16). pos + nq <= S; window <= 0 means none; qscale is
// sm_scale * log2(e) as an f32. hd % 128 == 0 and H % KVH == 0.

// B4: k, v (B, S, KVH * hd) contiguous, f32 or bf16 (cache_bf16), 16-byte
// aligned.
extern "C" int smmb_flash_decode(const void* q, int q_bf16, long long q_sb,
                                 long long q_sc, const void* k, const void* v,
                                 int cache_bf16, void* out, int b, int nq,
                                 int h, int kvh, int hd, int s, int pos,
                                 int window, float qscale, int cbf16,
                                 void* stream) {
  if (bad_shape(b, nq, h, kvh, hd, s, pos)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    return cache_bf16
               ? launch<__nv_bfloat16, __nv_bfloat16>(q, q_sb, q_sc, k, v, nullptr, out, b,
                                                      nq, h, kvh, hd, s, pos, window,
                                                      qscale, cbf16, st)
               : launch<__nv_bfloat16, float>(q, q_sb, q_sc, k, v, nullptr, out, b, nq, h,
                                              kvh, hd, s, pos, window, qscale, cbf16, st);
  return cache_bf16
             ? launch<float, __nv_bfloat16>(q, q_sb, q_sc, k, v, nullptr, out, b, nq, h,
                                            kvh, hd, s, pos, window, qscale, cbf16, st)
             : launch<float, float>(q, q_sb, q_sc, k, v, nullptr, out, b, nq, h, kvh, hd,
                                    s, pos, window, qscale, cbf16, st);
}

// B8: kv (B, S, 2 * KVH * hd) int8 codes, contiguous and 16-byte aligned;
// kv_scale (B, 2 * KVH, S) f32, contiguous.
extern "C" int smmb_flash_decode_quant(const void* q, int q_bf16, long long q_sb,
                                       long long q_sc, const void* kv,
                                       const void* kv_scale, void* out, int b,
                                       int nq, int h, int kvh, int hd, int s,
                                       int pos, int window, float qscale,
                                       int cbf16, void* stream) {
  if (bad_shape(b, nq, h, kvh, hd, s, pos)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* kvs = static_cast<const float*>(kv_scale);
  if (q_bf16)
    return launch<__nv_bfloat16, int8_t>(q, q_sb, q_sc, kv, kv, kvs, out, b, nq, h, kvh,
                                         hd, s, pos, window, qscale, cbf16, st);
  return launch<float, int8_t>(q, q_sb, q_sc, kv, kv, kvs, out, b, nq, h, kvh, hd, s,
                               pos, window, qscale, cbf16, st);
}
