// The 2-bit packed ternary layout, decoded one way for every kernel of the
// port (packed_spmm.cu, fused_mlp.cu; bcsr_spmm.cu decodes its blocks' bytes,
// whose planes lie r/4 rows apart, with the same byte-level functions).
//
// Layout (formats/packed.py, byte-identical to smmb_tpu/formats/packed.py):
// W is int8[K_pad / 4, N]; packed row p of group g holds logical rows
// g*512 + i*128 + p in its 2-bit fields i = 0..3. The planes are 128 rows
// apart, not interleaved. Field i of an int32-widened byte w is
// (w << (30 - 2i)) >> 30 (two's complement: 0b01 = +1, 0b11 = -1).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace smmb_packed {

constexpr int SUB = 128;         // packed rows per group
constexpr int GROUP_ROWS = 512;  // logical rows per group

__device__ __forceinline__ float load_as_float(const float* p) { return *p; }
__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// field i of a packed byte, sign-extended: (w << (30 - 2i)) >> 30. Bits of
// w above the field are shifted out, so w need not be masked to a byte.
__device__ __forceinline__ int decode_field(int w, int i) {
  return static_cast<int>(static_cast<unsigned>(w) << (30 - 2 * i)) >> 30;
}

// field i of byte q of a little-endian word holding 4 consecutive columns
__device__ __forceinline__ float word_field(unsigned word, int q, int i) {
  return static_cast<float>(decode_field(static_cast<int>(word >> (8 * q)), i));
}

// all four fields of a packed byte as four signed int8 lanes (lane i = field
// i), for dp4a: spread the 2-bit fields to bytes, then sign-extend each byte
// by OR-ing 0xFC where the field's high bit is set (no carries cross lanes).
__device__ __forceinline__ int decode_word(unsigned b) {
  unsigned t = (b & 0x3u) | ((b & 0xCu) << 6) | ((b & 0x30u) << 12) |
               ((b & 0xC0u) << 18);
  return static_cast<int>(t | ((t & 0x02020202u) * 0x7Eu));
}

// Field i of the two packed bytes in bits 0-7 and 8-15 of x, as a bf16 pair
// (an MMA B register: the two bytes are two consecutive rows of one column)
// (the values decode_field gives): 0b00 -> 0, 0b01 -> +1 (0x3F80), 0b11 ->
// -1 (0xBF80), 0b10 -> -2 (0xC000). The two codes land in nibbles 0 and 2;
// v * 0x11 + 0x4040 copies them to nibbles 1 and 3 plus 4, and one byte
// permute reads each value's low byte from {00, 80, 00, 80} and its high
// byte from {00, 3F, C0, BF}.
__device__ __forceinline__ unsigned bf16_pair(unsigned x, int i) {
  const unsigned v = (x >> (2 * i)) & 0x0303u;
  return __byte_perm(0x80008000u, 0xBFC03F00u, v * 0x11u + 0x4040u);
}

// logical row of W (column of X) held in field i of packed row pr
__device__ __forceinline__ int logical_row(int pr, int i) {
  return (pr / SUB) * GROUP_ROWS + i * SUB + (pr % SUB);
}

}  // namespace smmb_packed
