// Elementwise dequantization of int8 codes and of packed int4 codes.
//
// Replaces efficient_llm_inference_tpu/ops/pallas/dequant.py: dequant_int8
// (out = f32(q) * f32(scale), rounded once to the output type) and
// dequant_int4_packed (each byte holds two codes, the even element in the
// high nibble, code = nibble - 8; the output's last axis is cut to
// orig_last_dim). The TPU kernel emits int4 values in deinterleaved order
// [evens..., odds...] and interleaves them again outside (a Mosaic limit);
// this kernel writes natural order directly.
//
// Scales: one float per row of the [rows, D] view, or per element (int8
// only). The row's scale sits at sum_i ((row / prod_{j<i} size_j) % size_i)
// * stride_i over up to 4 collapsed leading dims (inner first), so a scalar,
// a per-row [..., 1] tensor or a per-token scale broadcast over heads is
// read where it lies, with no broadcast copy. `col_stride` != 0 adds
// col * col_stride (a scale that varies along the last axis).
//
// Bound: bytes. A code is read once and an output written once, with one
// multiply in between: (input bytes + output bytes) / 3.35 TB/s. So each
// thread converts one 16-byte chunk of codes (16 int8 codes, or 32 int4
// codes) and writes its outputs with 16-byte stores; the row scale is read
// once a chunk (an L1 hit for the chunk's neighbours). Rows whose width or
// alignment do not allow 16-byte accesses (an odd orig_last_dim) take the
// element-wise path: the same chunks, element stores.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch; elit_cuda_error_string names a code. out_dtype: 0 = float32,
// 1 = bfloat16, 2 = float16. Codes and output are contiguous.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct ScaleIndex {
  const float* base;
  int nd;  // 1..4 collapsed leading dims, inner first
  long long size[4];
  long long stride[4];
  long long col_stride;

  __device__ __forceinline__ const float* row(long long r) const {
    long long off = 0;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (i + 1 >= nd) break;
      off += (r % size[i]) * stride[i];
      r /= size[i];
    }
    return base + off + r * stride[nd - 1];  // the outermost dim needs no modulo
  }
};

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void put(__half* p, float v) { *p = __float2half_rn(v); }

// 16 bytes of outputs from N floats (N * sizeof(T) a multiple of 16).
template <typename T, int N>
__device__ __forceinline__ void store_vec(T* dst, const float (&v)[N]) {
  static_assert(N * sizeof(T) % 16 == 0, "whole 16-byte stores");
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < N / kPer; ++c) {
    T tmp[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) put(&tmp[i], v[c * kPer + i]);
    reinterpret_cast<uint4*>(dst)[c] = *reinterpret_cast<const uint4*>(tmp);
  }
}

// Thread t: chunk t % cpr of row t / cpr, 16 codes. VEC: D % 16 == 0 and the
// pointers 16-byte aligned (the wrapper checks), one 16-byte load.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
dequant_int8_kernel(const int8_t* __restrict__ q, long long rows, int D, ScaleIndex s,
                    T* __restrict__ out) {
  const int cpr = (D + 15) / 16;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= rows * cpr) return;
  const long long r = t / cpr;
  const int c0 = (int)(t % cpr) * 16;
  const float* sr = s.row(r);
  const int8_t* src = q + r * D + c0;
  T* dst = out + r * D + c0;
  if constexpr (VEC) {
    const int4 raw = *reinterpret_cast<const int4*>(src);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
    float v[16];
    if (s.col_stride == 0) {
      const float sc = *sr;
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = (float)b[i] * sc;
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = (float)b[i] * sr[(c0 + i) * s.col_stride];
    }
    store_vec<T, 16>(dst, v);
  } else {
    const int n = min(16, D - c0);
    for (int i = 0; i < n; ++i) put(dst + i, (float)src[i] * sr[(c0 + i) * s.col_stride]);
  }
}

// Thread t: 16 packed bytes (32 codes) of row t / cpr. VEC: Dp % 16 == 0,
// orig == 2 Dp and aligned pointers: one 16-byte load, 32 outputs in natural
// order. Otherwise byte by byte, the output cut at `orig`.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
dequant_int4_kernel(const uint8_t* __restrict__ p, long long rows, int Dp, int orig,
                    ScaleIndex s, T* __restrict__ out) {
  const int cpr = (Dp + 15) / 16;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= rows * cpr) return;
  const long long r = t / cpr;
  const int j0 = (int)(t % cpr) * 16;
  const float sc = *s.row(r);
  const uint8_t* src = p + r * Dp + j0;
  T* dst = out + r * orig + 2 * j0;
  if constexpr (VEC) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
    float v[32];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      v[2 * i] = (float)((int)(b[i] >> 4) - 8) * sc;
      v[2 * i + 1] = (float)((int)(b[i] & 15) - 8) * sc;
    }
    store_vec<T, 32>(dst, v);
  } else {
    const int n = min(16, Dp - j0);
    for (int i = 0; i < n; ++i) {
      const int byte = src[i];
      if (2 * (j0 + i) < orig) put(dst + 2 * i, (float)((byte >> 4) - 8) * sc);
      if (2 * (j0 + i) + 1 < orig) put(dst + 2 * i + 1, (float)((byte & 15) - 8) * sc);
    }
  }
}

unsigned grid_of(long long threads) { return (unsigned)((threads + kThreads - 1) / kThreads); }

template <typename T>
int launch_int8(const int8_t* q, long long rows, int D, const ScaleIndex& s, void* out,
                bool vec, cudaStream_t st) {
  const long long n = rows * ((D + 15) / 16);
  if (vec)
    dequant_int8_kernel<T, true><<<grid_of(n), kThreads, 0, st>>>(q, rows, D, s,
                                                                  static_cast<T*>(out));
  else
    dequant_int8_kernel<T, false><<<grid_of(n), kThreads, 0, st>>>(q, rows, D, s,
                                                                   static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_int4(const uint8_t* p, long long rows, int Dp, int orig, const ScaleIndex& s,
                void* out, bool vec, cudaStream_t st) {
  const long long n = rows * ((Dp + 15) / 16);
  if (vec)
    dequant_int4_kernel<T, true><<<grid_of(n), kThreads, 0, st>>>(p, rows, Dp, orig, s,
                                                                  static_cast<T*>(out));
  else
    dequant_int4_kernel<T, false><<<grid_of(n), kThreads, 0, st>>>(p, rows, Dp, orig, s,
                                                                   static_cast<T*>(out));
  return (int)cudaGetLastError();
}

ScaleIndex scale_index(const float* scale, int nd, const long long* sizes,
                       const long long* strides, long long col_stride) {
  ScaleIndex s{scale, nd, {1, 1, 1, 1}, {0, 0, 0, 0}, col_stride};
  for (int i = 0; i < nd; ++i) {
    s.size[i] = sizes[i];
    s.stride[i] = strides[i];
  }
  return s;
}

}  // namespace

// nd, sizes, strides: the scale's 1..4 collapsed leading dims, inner first
// (host arrays).
extern "C" int elit_dequant_int8(const int8_t* q, long long rows, int D, const float* scale,
                                 int nd, const long long* sizes, const long long* strides,
                                 long long col_stride, int out_dtype, int vec, void* out,
                                 void* stream) {
  if (rows == 0 || D == 0) return (int)cudaGetLastError();
  if (nd < 1 || nd > 4) return (int)cudaErrorInvalidValue;
  const ScaleIndex s = scale_index(scale, nd, sizes, strides, col_stride);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) return launch_int8<float>(q, rows, D, s, out, vec, st);
  if (out_dtype == 1) return launch_int8<__nv_bfloat16>(q, rows, D, s, out, vec, st);
  if (out_dtype == 2) return launch_int8<__half>(q, rows, D, s, out, vec, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int elit_dequant_int4(const uint8_t* p, long long rows, int Dp, int orig,
                                 const float* scale, int nd, const long long* sizes,
                                 const long long* strides, int out_dtype, int vec, void* out,
                                 void* stream) {
  if (rows == 0 || orig == 0) return (int)cudaGetLastError();
  if (orig > 2 * Dp || nd < 1 || nd > 4) return (int)cudaErrorInvalidValue;
  const ScaleIndex s = scale_index(scale, nd, sizes, strides, 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) return launch_int4<float>(p, rows, Dp, orig, s, out, vec, st);
  if (out_dtype == 1) return launch_int4<__nv_bfloat16>(p, rows, Dp, orig, s, out, vec, st);
  if (out_dtype == 2) return launch_int4<__half>(p, rows, Dp, orig, s, out, vec, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* elit_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
