// The weight tiers' chunk decode, shared by the CUDA-core GEMVs (the
// single-stream streaming GEMV gemv_stream.cuh and the persistent GPT-2
// step, the batched gemv_batch.cuh): the tier kinds, the codes of one
// 16-byte load as fp32, their dot with the load's inputs (the same partial
// sums in the same order for every GEMV), and the int4 scale group of a
// load. Each stages its input rows in the model dtype and widens a load's
// inputs in registers.
//
// Tiers (the JAX kernels' "wscale" / "w4scale" modes):
//   W_T   values of the model dtype (the GEMVs' own 16-byte loads);
//   W_I8  int8 codes, 16 a load, two's complement;
//   W_I4  int4 codes, 32 a load: byte j of a row holds input 2j in its low
//         nibble and 2j + 1 in its high one, two's complement (the model's
//         own order), so nibble i of a little-endian 32-bit word is input
//         8w + i of the load.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { W_T = 0, W_I4 = 4, W_I8 = 8 };

// Inputs a 16-byte load of codes covers.
template <int WK> struct QTier;
template <> struct QTier<W_I8> { static constexpr int N = 16; };
template <> struct QTier<W_I4> { static constexpr int N = 32; };

// Codes to fp32 without the conversion unit (16 a clock an SM, the int4
// tier's limit when each code took one): XOR-ing a word with 0x80808080
// (int8) or 0x88888888 (int4) turns each two's-complement code v into
// v + 128 (v + 8), an unsigned field; OR-ed into the mantissa of 2^23 it
// gives the float 2^23 + v + bias exactly, and subtracting 2^23 + bias
// leaves v: an integer op and an FADD a code.
__device__ __forceinline__ float code_i8(unsigned wx, int i) {
  return __uint_as_float(0x4B000000u | ((wx >> (8 * i)) & 0xFFu)) - 8388736.0f;
}
__device__ __forceinline__ float code_i4(unsigned wx, int i) {
  return __uint_as_float(0x4B000000u | ((wx >> (4 * i)) & 0xFu)) - 8388616.0f;
}

// The codes of one 16-byte load as fp32, in input order.
template <int WK>
__device__ __forceinline__ void decode_chunk(const uint4& u, float (&c)[QTier<WK>::N]) {
  constexpr int PW = QTier<WK>::N / 4;  // codes a 32-bit word
  constexpr unsigned X = WK == W_I8 ? 0x80808080u : 0x88888888u;
  const unsigned w[4] = {u.x ^ X, u.y ^ X, u.z ^ X, u.w ^ X};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < PW; ++j)
      c[PW * i + j] = WK == W_I8 ? code_i8(w[i], j) : code_i4(w[i], j);
}

// The fp32 sum of decoded codes c times their inputs a: one partial sum a
// 32-bit word of codes, in input order, then (p0 + p1) + (p2 + p3).
template <int WK>
__device__ __forceinline__ float chunk_dot(const float (&c)[QTier<WK>::N],
                                           const float (&a)[QTier<WK>::N]) {
  constexpr int PW = QTier<WK>::N / 4;
  float p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    p[i] = c[PW * i] * a[PW * i];
#pragma unroll
    for (int j = 1; j < PW; ++j) p[i] = fmaf(c[PW * i + j], a[PW * i + j], p[i]);
  }
  return (p[0] + p[1]) + (p[2] + p[3]);
}

// The int4 scale group of load c of a row, floor(c * 32 / G), taken in fp32
// with chunk_to_group = 32 / G: the product's error (~1e-5 for c < 2^9)
// stays under the 1e-3 nudge, itself under the fraction's spacing 32 / G
// (G <= 2^14), so the floor is exact without an integer division.
__device__ __forceinline__ int chunk_group(int c, float chunk_to_group) {
  return __float2int_rz(fmaf((float)c, chunk_to_group, 1e-3f));
}

}  // namespace
