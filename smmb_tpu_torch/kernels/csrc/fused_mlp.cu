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
// Design (first, simple version; CUDA cores only, no wgmma/TMA yet). At the
// decode shapes (M = 1..32 rows, K = 1024) every product is a weight stream:
// the bound is the packed bytes over the memory rate, so the kernels spread
// the weight bytes over many blocks and read each byte once per row tile.
//   * A block has 8 warps and owns MT rows (MT = 1 for M = 1, else 8) and
//     128 output columns; lane l owns 4 consecutive columns and reads them
//     as one 32-bit word per packed row. The activation rows are staged in
//     shared memory in f32, already rounded to the compute dtype (the TPU
//     kernel's cast before each dot).
//   * K is split across the 8 warps of a block in a fixed way (warp w takes
//     packed rows [w Kp/8, (w+1) Kp/8)); each warp sums its rows in order
//     with f32 FMA (never TF32), and the 8 partial sums are added in warp
//     order. The order of every sum depends on K and these constants only,
//     never on M or on which rows share the call, so a row's result is
//     bitwise the same at M = 1 and M = 8 (the speculative-decoding contract,
//     smmb_tpu/kernels/fused_mlp.py:645-649). There are no atomics.
//   * The TPU kernels carry the MLP's sum across a sequential grid axis of
//     hidden slabs. Blocks on Hopper run in no order, so the hidden axis is
//     cut into tiles of 128 units (32 packed rows of each of the 4 planes of
//     one group). One block computes its tile's up = PReLU(...) rows in
//     shared memory (the hidden layer never reaches device memory), then
//     that tile's product with the matching 32 packed rows of Wdown, and
//     writes one f32 partial per tile to a workspace. A second launch sums
//     the partials in tile order and applies the epilogue.
//   * B7 is B3 plus a second kind of block. Its q-column blocks are B3's
//     blocks over the first d columns. A K/V block owns one (plane, KV head)
//     span of hd columns: hd = 256 spans two of B3's 128-column tiles, so it
//     walks hd / 128 sub-tiles with B3's fixed K split (every y is bitwise
//     B3's), keeping the warps' partial sums apart from the staged rows that
//     each sub-tile reads again. It stages the span's f32 y in shared memory
//     and takes each row's absmax (exact in any order); the scale and the
//     codes use the IEEE __fdiv_rn and __float2int_rn (round half to even,
//     as jnp.round), never roundf, a bare cast or a multiply by 1/127.
//   * B5's phase 0 (wo, residual) is its own launch, so the RMSNorm over
//     full rows sees every column before any tile reads h. Each tile block
//     recomputes the norm of its rows from the f32 residual in a fixed order.
//   * Rounding follows the JAX order: cast to the compute dtype before each
//     product, scale after the product on the f32 sum, then the bias; the
//     epilogues use __fmul_rn/__fadd_rn so no FMA contraction changes the
//     rounding; rsqrt is the IEEE __frsqrt_rn (not the approximate rsqrtf).
//   * Kernels allocate nothing, launch on the caller's stream and do not
//     synchronise; each C entry returns cudaGetLastError().

#include "packed_decode.cuh"

using namespace smmb_packed;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;  // the fixed split of K inside a block
constexpr int TILE_N = 128;          // output columns per block (4 per lane)
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

// columns col..col+3 of one packed row as a little-endian word (0 past n)
__device__ __forceinline__ unsigned load_word(const int8_t* __restrict__ row,
                                              int col, int n) {
  if ((n & 3) == 0 && col + 3 < n)
    return __ldg(reinterpret_cast<const unsigned*>(row + col));
  unsigned w = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (col + q < n)
      w |= static_cast<unsigned>(static_cast<uint8_t>(row[col + q])) << (8 * q);
  return w;
}

// acc[r][q] += sum over packed rows p in [p0, p1) and planes i of
// a[r][logical_row(p, i)] * W(p, col + q, field i), in that order.
template <int MT>
__device__ __forceinline__ void packed_dot(const float* __restrict__ a, int lda,
                                           const int8_t* __restrict__ w, int n,
                                           int col, int p0, int p1,
                                           float (&acc)[MT][4]) {
#pragma unroll 4
  for (int p = p0; p < p1; ++p) {
    const unsigned word = load_word(w + static_cast<size_t>(p) * n, col, n);
    const int kb = logical_row(p, 0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float wv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) wv[q] = word_field(word, q, i);
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        const float xv = a[r * lda + kb + i * SUB];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(xv, wv[q], acc[r][q]);
      }
    }
  }
}

// the K-split product of a block: warp w sums its packed rows of the (k, n)
// plane for the 4 columns col..col+3 of its lane; the partials go to
// red[w][r][lane * 4 + q] (red may alias a: a barrier separates the two).
template <int MT>
__device__ __forceinline__ void block_dot(float* a, int k,
                                          const int8_t* __restrict__ w, int n,
                                          int col, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kp = k / 4;
  float acc[MT][4];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
  packed_dot<MT>(a, k, w, n, col, warp * kp / WARPS, (warp + 1) * kp / WARPS,
                 acc);
  __syncthreads();  // every warp is done reading a
#pragma unroll
  for (int r = 0; r < MT; ++r)
    *reinterpret_cast<float4*>(&red[(warp * MT + r) * TILE_N + lane * 4]) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
}

// the 8 warps' partial sums of output (r, c), added in warp order
template <int MT>
__device__ __forceinline__ float warp_sum(const float* red, int r, int c) {
  float s = red[r * TILE_N + c];
#pragma unroll
  for (int wi = 1; wi < WARPS; ++wi) s = __fadd_rn(s, red[(wi * MT + r) * TILE_N + c]);
  return s;
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

// stage MT rows of a (m, k) matrix into a[r][k] as f32 rounded to the
// compute dtype (zeros past m)
template <int MT>
__device__ void stage_rows(float* a, const void* src, int src_bf16, int m,
                           int m0, int k, int cbf16) {
  for (int idx = threadIdx.x; idx < MT * k; idx += THREADS) {
    const int r = idx / k;
    a[idx] = m0 + r < m ? to_compute(load_elem(src, static_cast<size_t>(m0) * k + idx,
                                               src_bf16), cbf16)
                        : 0.f;
  }
  __syncthreads();
}

// rows of h = rmsnorm(v; g, eps) in place, rounded to the compute dtype
template <int MT>
__device__ void norm_rows(float* v, int d, const float* __restrict__ g,
                          float eps, float* inv, float* scratch, int cbf16) {
  row_rms<MT>(v, d, eps, inv, scratch);
  for (int idx = threadIdx.x; idx < MT * d; idx += THREADS) {
    const int r = idx / d, k = idx - r * d;
    v[idx] = to_compute(__fmul_rn(__fmul_rn(v[idx], inv[r]), g[k]), cbf16);
  }
  __syncthreads();
}

// shared memory of a block: MT rows of width k (reused for the warps'
// partial sums), the hidden tile, and the norm's scratch
template <int MT>
size_t smem_bytes(int k) {
  const int act = MT * k > WARPS * MT * TILE_N ? MT * k : WARPS * MT * TILE_N;
  return sizeof(float) * (act + MT * HT + MT + WARPS * MT);
}

template <int MT>
struct Smem {
  float* act;      // MT x k staged rows, then the warps' partial sums
  float* up;       // MT x HT hidden tile
  float* inv;      // MT
  float* scratch;  // WARPS x MT
  __device__ Smem(float* base, int k) {
    const int a = MT * k > WARPS * MT * TILE_N ? MT * k : WARPS * MT * TILE_N;
    act = base;
    up = base + a;
    inv = up + MT * HT;
    scratch = inv + MT;
  }
};

// ---------------------------------------------------------------- B3
template <int MT>
__global__ void __launch_bounds__(THREADS)
norm_qkv_kernel(const void* __restrict__ x, int x_bf16,
                const float* __restrict__ g, const int8_t* __restrict__ w,
                const float* __restrict__ scale, const float* __restrict__ bias,
                void* __restrict__ out, int m, int d, int n, float eps,
                int cbf16) {
  extern __shared__ __align__(16) float smem[];
  Smem<MT> s(smem, d);
  const int m0 = blockIdx.y * MT, n0 = blockIdx.x * TILE_N;
  stage_rows<MT>(s.act, x, x_bf16, m, m0, d, 0);  // the norm reads x in f32
  norm_rows<MT>(s.act, d, g, eps, s.inv, s.scratch, cbf16);
  block_dot<MT>(s.act, d, w, n, n0 + (threadIdx.x & 31) * 4, s.act);
  for (int idx = threadIdx.x; idx < MT * TILE_N; idx += THREADS) {
    const int r = idx / TILE_N, c = idx % TILE_N, col = n0 + c;
    if (m0 + r >= m || col >= n) continue;
    const float v = __fadd_rn(__fmul_rn(warp_sum<MT>(s.act, r, c), scale[col]),
                              bias[col]);
    store_elem(out, static_cast<size_t>(m0 + r) * n + col, v, x_bf16);
  }
}

// ---------------------------------------------------------------- B7
// shared memory of a B7 block: MT rows of width d, the warps' partial sums,
// one span's MT x hd f32 y, the norm's inverse, the absmax scales and the
// norm's scratch
template <int MT>
size_t quant_smem_bytes(int d, int hd) {
  return sizeof(float) *
         (static_cast<size_t>(MT) * d + WARPS * MT * TILE_N + MT * hd + 2 * MT + WARPS * MT);
}

template <int MT>
__global__ void __launch_bounds__(THREADS)
norm_qkv_quant_kernel(const void* __restrict__ x, int x_bf16,
                      const float* __restrict__ g, const int8_t* __restrict__ w,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      void* __restrict__ q_out, int8_t* __restrict__ codes,
                      float* __restrict__ scales, int m, int d, int n, int kvh, int hd,
                      float eps, int cbf16) {
  extern __shared__ __align__(16) float smem[];
  float* act = smem;                      // MT x d staged rows
  float* red = act + MT * d;              // WARPS x MT x TILE_N partial sums
  float* ys = red + WARPS * MT * TILE_N;  // MT x hd: one span's f32 y
  float* inv = ys + MT * hd;              // MT
  float* qsc = inv + MT;                  // MT: the span's scales
  float* scratch = qsc + MT;              // WARPS x MT
  const int m0 = blockIdx.y * MT, q_tiles = d / TILE_N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  stage_rows<MT>(act, x, x_bf16, m, m0, d, 0);  // the norm reads x in f32
  norm_rows<MT>(act, d, g, eps, inv, scratch, cbf16);
  if (static_cast<int>(blockIdx.x) < q_tiles) {  // B3's block over q columns
    const int n0 = blockIdx.x * TILE_N;
    block_dot<MT>(act, d, w, n, n0 + lane * 4, red);
    for (int idx = threadIdx.x; idx < MT * TILE_N; idx += THREADS) {
      const int r = idx / TILE_N, c = idx % TILE_N, col = n0 + c;
      if (m0 + r >= m) continue;
      const float v = __fadd_rn(__fmul_rn(warp_sum<MT>(red, r, c), scale[col]), bias[col]);
      store_elem(q_out, static_cast<size_t>(m0 + r) * d + col, v, x_bf16);
    }
    return;
  }
  // slot 2 h + plane of the interleave: KV head h's k (plane 0) or v span
  const int slot = blockIdx.x - q_tiles, kh = slot >> 1, plane = slot & 1;
  const int span0 = d + plane * kvh * hd + kh * hd;
  for (int t = 0; t < hd; t += TILE_N) {
    // block_dot's first barrier orders these reads of red before its writes
    block_dot<MT>(act, d, w, n, span0 + t + lane * 4, red);
    for (int idx = threadIdx.x; idx < MT * TILE_N; idx += THREADS) {
      const int r = idx / TILE_N, c = idx % TILE_N, col = span0 + t + c;
      ys[r * hd + t + c] =
          __fadd_rn(__fmul_rn(warp_sum<MT>(red, r, c), scale[col]), bias[col]);
    }
  }
  __syncthreads();
  for (int r = warp; r < MT; r += WARPS) {
    float a = 0.f;
    for (int c = lane; c < hd; c += 32) a = fmaxf(a, fabsf(ys[r * hd + c]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
    if (lane == 0) qsc[r] = __fdiv_rn(a, 127.f);
  }
  __syncthreads();
  const int row_codes = 2 * kvh * hd;
  for (int r = threadIdx.x; r < MT; r += THREADS)
    if (m0 + r < m) scales[static_cast<size_t>(m0 + r) * 2 * kvh + slot] = qsc[r];
  for (int idx = threadIdx.x; idx < MT * hd; idx += THREADS) {
    const int r = idx / hd, c = idx - r * hd;
    if (m0 + r >= m) continue;
    const float safe = qsc[r] > 0.f ? qsc[r] : 1.f;
    codes[static_cast<size_t>(m0 + r) * row_codes + slot * hd + c] =
        static_cast<int8_t>(__float2int_rn(__fdiv_rn(ys[idx], safe)));
  }
}

// ------------------------------------------------- B6 / B5 hidden tiles
// One hidden tile t of 128 units: units g*512 + i*128 + pb + j for the 4
// planes i and j < 32, where g = t / 4 and pb = (t % 4) * 32. The staged
// rows a (MT x k, compute dtype) go through Wup's tile columns, the bias,
// the scale and PReLU into up (never to device memory), then through the
// matching 32 packed rows of Wdown into the tile's f32 partial ws[t].
template <int MT>
__device__ void hidden_tile(Smem<MT>& s, int k, const int8_t* __restrict__ wu,
                            int h, const float* __restrict__ s_up,
                            const float* __restrict__ b_up, float alpha,
                            const int8_t* __restrict__ wd, int kout,
                            float* __restrict__ ws, int m, int m0, int cbf16) {
  const int t = blockIdx.x, g = t / 4, pb = (t % 4) * HT_PACKED;
  const int lane = threadIdx.x & 31;
  // lane l: plane l / 8, units j = (l % 8) * 4 + q; local unit l * 4 + q
  const int ucol = g * GROUP_ROWS + (lane >> 3) * SUB + pb + (lane & 7) * 4;
  block_dot<MT>(s.act, k, wu, h, ucol, s.act);
  const float su = *s_up;
  for (int idx = threadIdx.x; idx < MT * HT; idx += THREADS) {
    const int r = idx / HT, u = idx % HT;
    const int unit = g * GROUP_ROWS + (u / HT_PACKED) * SUB + pb + u % HT_PACKED;
    float v = __fadd_rn(__fmul_rn(warp_sum<MT>(s.act, r, u), su), b_up[unit]);
    if (!(v > 0.f)) v = __fmul_rn(alpha, v);
    s.up[idx] = to_compute(v, cbf16);
  }
  __syncthreads();
  const int8_t* wrows = wd + static_cast<size_t>(g * SUB + pb) * kout;
  for (int c0 = threadIdx.x * 4; c0 < kout; c0 += THREADS * 4) {
    float acc[MT][4];
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
#pragma unroll 4
    for (int j = 0; j < HT_PACKED; ++j) {
      const unsigned word = load_word(wrows + static_cast<size_t>(j) * kout, c0, kout);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float wv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) wv[q] = word_field(word, q, i);
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const float uv = s.up[r * HT + i * HT_PACKED + j];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(uv, wv[q], acc[r][q]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      if (m0 + r >= m) continue;
      float* dst = ws + (static_cast<size_t>(t) * m + m0 + r) * kout;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (c0 + q < kout) dst[c0 + q] = acc[r][q];
    }
  }
}

// B6 launch 1: x rows in the compute dtype, then the hidden tile
template <int MT>
__global__ void __launch_bounds__(THREADS)
mlp_tile_kernel(const void* __restrict__ x, int x_bf16,
                const int8_t* __restrict__ wu, const float* __restrict__ s_up,
                const float* __restrict__ b_up, const int8_t* __restrict__ wd,
                float* __restrict__ ws, int m, int k, int h, int kout,
                float alpha, int cbf16) {
  extern __shared__ __align__(16) float smem[];
  Smem<MT> s(smem, k);
  const int m0 = blockIdx.y * MT;
  stage_rows<MT>(s.act, x, x_bf16, m, m0, k, cbf16);
  hidden_tile<MT>(s, k, wu, h, s_up, b_up, alpha, wd, kout, ws, m, m0, cbf16);
}

// B6 launch 2: y = (sum of the tiles' partials, in tile order) * s_down + b
__global__ void __launch_bounds__(THREADS)
mlp_sum_kernel(const float* __restrict__ ws, int tiles,
               const float* __restrict__ s_down,
               const float* __restrict__ b_down, void* __restrict__ out,
               int out_bf16, int m, int kout) {
  const size_t total = static_cast<size_t>(m) * kout;
  const size_t idx = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= total) return;
  float s = ws[idx];
  for (int t = 1; t < tiles; ++t) s = __fadd_rn(s, ws[t * total + idx]);
  const float v = __fadd_rn(__fmul_rn(s, *s_down), b_down[idx % kout]);
  store_elem(out, idx, v, out_bf16);
}

// ---------------------------------------------------------------- B5
// launch 1: resid = x + s_wo (att . Wo) + b_wo, in f32
template <int MT>
__global__ void __launch_bounds__(THREADS)
tail_wo_kernel(const void* __restrict__ att, int att_bf16,
               const void* __restrict__ x, int x_bf16,
               const int8_t* __restrict__ wo, const float* __restrict__ s_wo,
               const float* __restrict__ b_wo, float* __restrict__ resid,
               int m, int a, int dm, int cbf16) {
  extern __shared__ __align__(16) float smem[];
  Smem<MT> s(smem, a);
  const int m0 = blockIdx.y * MT, n0 = blockIdx.x * TILE_N;
  stage_rows<MT>(s.act, att, att_bf16, m, m0, a, cbf16);
  block_dot<MT>(s.act, a, wo, dm, n0 + (threadIdx.x & 31) * 4, s.act);
  const float sw = *s_wo;
  for (int idx = threadIdx.x; idx < MT * TILE_N; idx += THREADS) {
    const int r = idx / TILE_N, c = idx % TILE_N, col = n0 + c;
    if (m0 + r >= m || col >= dm) continue;
    const size_t o = static_cast<size_t>(m0 + r) * dm + col;
    const float v = __fadd_rn(__fmul_rn(warp_sum<MT>(s.act, r, c), sw),
                              load_elem(x, o, x_bf16));
    // JAX order: (x + s_wo * acc) + b_wo
    resid[o] = __fadd_rn(v, b_wo[col]);
  }
}

// launch 2: h = rmsnorm(resid; g2, eps) of the block's rows, then the tile
template <int MT>
__global__ void __launch_bounds__(THREADS)
tail_tile_kernel(const float* __restrict__ resid, const float* __restrict__ g2,
                 float eps, const int8_t* __restrict__ wu,
                 const float* __restrict__ s_up, const float* __restrict__ b_up,
                 const int8_t* __restrict__ wd, float* __restrict__ ws, int m,
                 int dm, int h, float alpha, int cbf16) {
  extern __shared__ __align__(16) float smem[];
  Smem<MT> s(smem, dm);
  const int m0 = blockIdx.y * MT;
  stage_rows<MT>(s.act, resid, 0, m, m0, dm, 0);
  norm_rows<MT>(s.act, dm, g2, eps, s.inv, s.scratch, cbf16);
  hidden_tile<MT>(s, dm, wu, h, s_up, b_up, alpha, wd, dm, ws, m, m0, cbf16);
}

// launch 3: y = (resid + s_down * sum of the partials) + b_down
__global__ void __launch_bounds__(THREADS)
tail_sum_kernel(const float* __restrict__ ws, int tiles,
                const float* __restrict__ resid,
                const float* __restrict__ s_down,
                const float* __restrict__ b_down, void* __restrict__ out,
                int out_bf16, int m, int dm) {
  const size_t total = static_cast<size_t>(m) * dm;
  const size_t idx = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= total) return;
  float s = ws[idx];
  for (int t = 1; t < tiles; ++t) s = __fadd_rn(s, ws[t * total + idx]);
  const float v = __fadd_rn(resid[idx], __fmul_rn(s, *s_down));
  store_elem(out, idx, __fadd_rn(v, b_down[idx % dm]), out_bf16);
}

// above 48 KB a block's dynamic shared memory must be allowed per kernel
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool bad_rows(int m, int mt) { return m <= 0 || (m + mt - 1) / mt > 65535; }

template <int MT>
int norm_qkv(const void* x, int x_bf16, const void* g, const void* w,
             const void* scale, const void* bias, void* out, int m, int d,
             int n, float eps, int cbf16, cudaStream_t stream) {
  const size_t smem = smem_bytes<MT>(d);
  if (smem > MAX_SMEM || bad_rows(m, MT)) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(norm_qkv_kernel<MT>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + TILE_N - 1) / TILE_N, (m + MT - 1) / MT);
  norm_qkv_kernel<MT><<<grid, THREADS, smem, stream>>>(
      x, x_bf16, static_cast<const float*>(g), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias), out,
      m, d, n, eps, cbf16);
  return cudaGetLastError();
}

template <int MT>
int norm_qkv_quant(const void* x, int x_bf16, const void* g, const void* w,
                   const void* scale, const void* bias, void* q_out, void* codes,
                   void* scales, int m, int d, int n, int kvh, int hd, float eps,
                   int cbf16, cudaStream_t stream) {
  const size_t smem = quant_smem_bytes<MT>(d, hd);
  if (smem > MAX_SMEM || bad_rows(m, MT)) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(norm_qkv_quant_kernel<MT>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(d / TILE_N + 2 * kvh, (m + MT - 1) / MT);
  norm_qkv_quant_kernel<MT><<<grid, THREADS, smem, stream>>>(
      x, x_bf16, static_cast<const float*>(g), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias), q_out,
      static_cast<int8_t*>(codes), static_cast<float*>(scales), m, d, n, kvh, hd, eps,
      cbf16);
  return cudaGetLastError();
}

template <int MT>
int mlp(const void* x, int x_bf16, const void* wu, const void* s_up,
        const void* b_up, const void* wd, const void* s_down,
        const void* b_down, void* ws, void* out, int m, int k, int h, int kout,
        float alpha, int cbf16, cudaStream_t stream) {
  const size_t smem = smem_bytes<MT>(k);
  if (smem > MAX_SMEM || bad_rows(m, MT)) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(mlp_tile_kernel<MT>, smem);
  if (e != cudaSuccess) return e;
  const int tiles = h / HT;
  mlp_tile_kernel<MT><<<dim3(tiles, (m + MT - 1) / MT), THREADS, smem, stream>>>(
      x, x_bf16, static_cast<const int8_t*>(wu), static_cast<const float*>(s_up),
      static_cast<const float*>(b_up), static_cast<const int8_t*>(wd),
      static_cast<float*>(ws), m, k, h, kout, alpha, cbf16);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t total = static_cast<size_t>(m) * kout;
  mlp_sum_kernel<<<static_cast<unsigned>((total + THREADS - 1) / THREADS), THREADS, 0,
                   stream>>>(static_cast<const float*>(ws), tiles,
                             static_cast<const float*>(s_down),
                             static_cast<const float*>(b_down), out, x_bf16, m,
                             kout);
  return cudaGetLastError();
}

template <int MT>
int block_tail(const void* att, int att_bf16, const void* x, int x_bf16,
               const void* wo, const void* s_wo, const void* b_wo,
               const void* g2, const void* wu, const void* s_up,
               const void* b_up, const void* wd, const void* s_down,
               const void* b_down, void* resid, void* ws, void* out, int m,
               int a, int dm, int h, float alpha, float eps, int cbf16,
               cudaStream_t stream) {
  const size_t smem_wo = smem_bytes<MT>(a), smem_tile = smem_bytes<MT>(dm);
  if (smem_wo > MAX_SMEM || smem_tile > MAX_SMEM || bad_rows(m, MT))
    return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(tail_wo_kernel<MT>, smem_wo);
  if (e == cudaSuccess) e = allow_smem(tail_tile_kernel<MT>, smem_tile);
  if (e != cudaSuccess) return e;
  const unsigned row_tiles = (m + MT - 1) / MT;
  float* r = static_cast<float*>(resid);
  tail_wo_kernel<MT><<<dim3((dm + TILE_N - 1) / TILE_N, row_tiles), THREADS, smem_wo,
                       stream>>>(att, att_bf16, x, x_bf16,
                                 static_cast<const int8_t*>(wo),
                                 static_cast<const float*>(s_wo),
                                 static_cast<const float*>(b_wo), r, m, a, dm,
                                 cbf16);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int tiles = h / HT;
  tail_tile_kernel<MT><<<dim3(tiles, row_tiles), THREADS, smem_tile, stream>>>(
      r, static_cast<const float*>(g2), eps, static_cast<const int8_t*>(wu),
      static_cast<const float*>(s_up), static_cast<const float*>(b_up),
      static_cast<const int8_t*>(wd), static_cast<float*>(ws), m, dm, h, alpha,
      cbf16);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t total = static_cast<size_t>(m) * dm;
  tail_sum_kernel<<<static_cast<unsigned>((total + THREADS - 1) / THREADS), THREADS, 0,
                    stream>>>(static_cast<const float*>(ws), tiles, r,
                              static_cast<const float*>(s_down),
                              static_cast<const float*>(b_down), out, x_bf16, m,
                              dm);
  return cudaGetLastError();
}

}  // namespace

// All matrices are row-major and contiguous; packed planes are
// int8[rows / 4, cols] in the layout of packed_decode.cuh. *_bf16 flags say
// whether a float tensor is bf16 (else f32); cbf16 selects the bf16 compute
// dtype (else f32). Scales s_* are device pointers to one f32 each; biases,
// norm gains and qkv scale vectors are f32. The output has x's dtype. ws
// and resid are f32 workspaces of (h / 128, m, cols) and (m, dm). Each
// entry returns the CUDA error of its launches (0 on success).

// B3: out (m, n) = (rmsnorm(x) . w) * scale + bias; d % 512 == 0.
extern "C" int smmb_fused_norm_qkv(const void* x, int x_bf16, const void* g,
                                   const void* w, const void* scale,
                                   const void* bias, void* out, int m, int d,
                                   int n, float eps, int cbf16, void* stream) {
  if (d <= 0 || d % GROUP_ROWS || n <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return m == 1 ? norm_qkv<1>(x, x_bf16, g, w, scale, bias, out, m, d, n, eps,
                              cbf16, s)
                : norm_qkv<8>(x, x_bf16, g, w, scale, bias, out, m, d, n, eps,
                              cbf16, s);
}

// B7: q_out (m, d) = B3's first d columns, in x's dtype; codes (m, 2 kvh hd)
// int8 and scales (m, 2 kvh) f32 of the K and V columns, slot 2 h + plane;
// n = d + 2 kvh hd, d % 512 == 0, hd % 128 == 0.
extern "C" int smmb_fused_norm_qkv_quant(const void* x, int x_bf16, const void* g,
                                         const void* w, const void* scale,
                                         const void* bias, void* q_out, void* codes,
                                         void* scales, int m, int d, int n, int kvh,
                                         int hd, float eps, int cbf16, void* stream) {
  if (d <= 0 || d % GROUP_ROWS || kvh <= 0 || hd <= 0 || hd % TILE_N ||
      n != d + 2 * kvh * hd)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return m == 1 ? norm_qkv_quant<1>(x, x_bf16, g, w, scale, bias, q_out, codes, scales,
                                    m, d, n, kvh, hd, eps, cbf16, s)
                : norm_qkv_quant<8>(x, x_bf16, g, w, scale, bias, q_out, codes, scales,
                                    m, d, n, kvh, hd, eps, cbf16, s);
}

// B6: out (m, kout) = (PReLU(s_up (x . wu) + b_up) . wd) * s_down + b_down;
// k and h multiples of 512.
extern "C" int smmb_fused_mlp(const void* x, int x_bf16, const void* wu,
                              const void* s_up, const void* b_up,
                              const void* wd, const void* s_down,
                              const void* b_down, void* ws, void* out, int m,
                              int k, int h, int kout, float alpha, int cbf16,
                              void* stream) {
  if (k <= 0 || k % GROUP_ROWS || h <= 0 || h % GROUP_ROWS || kout <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return m == 1 ? mlp<1>(x, x_bf16, wu, s_up, b_up, wd, s_down, b_down, ws, out,
                         m, k, h, kout, alpha, cbf16, s)
                : mlp<8>(x, x_bf16, wu, s_up, b_up, wd, s_down, b_down, ws, out,
                         m, k, h, kout, alpha, cbf16, s);
}

// B5: out (m, dm) = the block tail above; a, dm and h multiples of 512.
extern "C" int smmb_fused_block_tail(
    const void* att, int att_bf16, const void* x, int x_bf16, const void* wo,
    const void* s_wo, const void* b_wo, const void* g2, const void* wu,
    const void* s_up, const void* b_up, const void* wd, const void* s_down,
    const void* b_down, void* resid, void* ws, void* out, int m, int a, int dm,
    int h, float alpha, float eps, int cbf16, void* stream) {
  if (a <= 0 || a % GROUP_ROWS || dm <= 0 || dm % GROUP_ROWS || h <= 0 ||
      h % GROUP_ROWS)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return m == 1
             ? block_tail<1>(att, att_bf16, x, x_bf16, wo, s_wo, b_wo, g2, wu,
                             s_up, b_up, wd, s_down, b_down, resid, ws, out, m,
                             a, dm, h, alpha, eps, cbf16, s)
             : block_tail<8>(att, att_bf16, x, x_bf16, wo, s_wo, b_wo, g2, wu,
                             s_up, b_up, wd, s_down, b_down, resid, ws, out, m,
                             a, dm, h, alpha, eps, cbf16, s);
}
