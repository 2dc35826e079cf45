// A CPU emulation of the CUDA constructs csrc/flash_attention.cu uses, for
// scripts/torch_b9_emulate.py: one OS thread per CUDA thread, std::barrier
// for __syncthreads and the warp shuffles, cp.async as a copy, shared memory
// a heap buffer filled with NaN bytes at each block (a read of a byte no
// thread wrote shows). IEEE f32 arithmetic (build with -ffp-contract=off);
// exp2f is the host's, so outputs compare only between two sources run
// here, not with the card's. The tensor-core helpers are stubs: the mma
// body does not run here.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstddef>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>
#include <algorithm>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(x) alignas(16)
struct dim3 { unsigned x, y, z; dim3(unsigned a=1, unsigned b=1, unsigned c=1):x(a),y(b),z(c){} };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;
struct alignas(16) float4 { float x, y, z, w; }; struct alignas(8) float2 { float x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a,b,c,d}; }
inline float2 make_float2(float a, float b) { return {a,b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a,b,c,d}; }
struct __nv_bfloat16 { unsigned short x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline float __bfloat162float(__nv_bfloat16 b) { return __uint_as_float(unsigned(b.x) << 16); }
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  unsigned u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(unsigned short)((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(unsigned short)(u >> 16)};
}
inline float2 __bfloat1622float2(__nv_bfloat162 v) { return {__bfloat162float(v.x), __bfloat162float(v.y)}; }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) { return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)}; }
inline float __fmul_rn(float a, float b) { return a*b; }
inline float __fadd_rn(float a, float b) { return a+b; }
inline float __fsub_rn(float a, float b) { return a-b; }
inline float __fdiv_rn(float a, float b) { return a/b; }
using std::min; using std::max;
inline float fmaf(float a, float b, float c) { return std::fma(a, b, c); }
inline float fmaxf(float a, float b) { return std::fmax(a, b); }
inline float exp2f(float a) { return std::exp2(a); }

struct Block {
  std::barrier<>* all;
  std::barrier<>* warp[32];
  float fx[32][32];
  bool bx[32][32];
  unsigned char* smem;
};
inline thread_local Block* blk;
inline void __syncthreads() { blk->all->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int o) {
  const int t = threadIdx.x, w = t / 32, l = t % 32;
  blk->fx[w][l] = v; blk->warp[w]->arrive_and_wait();
  float r = blk->fx[w][l ^ o]; blk->warp[w]->arrive_and_wait(); return r;
}
inline bool __any_sync(unsigned, bool v) {
  const int t = threadIdx.x, w = t / 32, l = t % 32;
  blk->bx[w][l] = v; blk->warp[w]->arrive_and_wait();
  bool r = false; for (int i = 0; i < 32; ++i) r |= blk->bx[w][i];
  blk->warp[w]->arrive_and_wait(); return r;
}
#define SMEM_PTR(type, name) type* name = reinterpret_cast<type*>(blk->smem)
typedef int cudaError_t; typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 2 };
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline size_t emu_smem_limit = 232448;
inline void emu_launch(dim3 grid, int threads, size_t smem, std::function<void()> body) {
  if (smem > emu_smem_limit) { fprintf(stderr, "smem %zu too big\n", smem); abort(); }
  gridDim = grid; blockDim = dim3(threads);
  std::vector<unsigned char> mem(smem + 16);
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bxx = 0; bxx < grid.x; ++bxx) {
      std::barrier<> all(threads);
      std::vector<std::barrier<>*> ws;
      Block b; b.all = &all;
      for (int w = 0; w < threads / 32; ++w) b.warp[w] = new std::barrier<>(32);
      // fill shared memory with NaN garbage to catch reads of unwritten data
      std::memset(mem.data(), 0xff, mem.size());
      b.smem = mem.data();
      std::vector<std::thread> th;
      for (int t = 0; t < threads; ++t)
        th.emplace_back([&, t] { blk = &b; threadIdx = dim3(t); blockIdx = dim3(bxx, by); body(); });
      for (auto& x : th) x.join();
      for (int w = 0; w < threads / 32; ++w) delete b.warp[w];
    }
}
namespace smmb_mma {
inline void cp_async16(void* d, const void* s, bool valid) { if (valid) std::memcpy(d, s, 16); else std::memset(d, 0, 16); }
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
inline void ldmatrix_x4(unsigned (&)[4], const void*) {}
inline void ldmatrix_x4_trans(unsigned (&)[4], const void*) {}
inline void mma(float (&)[4], const unsigned (&)[4], unsigned, unsigned) {}
}
