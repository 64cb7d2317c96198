// Per-row symmetric quantization of a [rows, n] block: int8, or int4 packed
// two per byte.
//
// Replaces efficient_llm_inference_tpu/ops/pallas/quantize.py:
// quantize_int8_rows and quantize_int4_rows (the Pallas kernels that quantize
// the new K/V block on write). A row is one token's [H*D] values
// ("per_token" scales) or one (head, token) pair's [D] values ("per_head").
//
// Bound: bytes. Each element is read once and written once at 1 byte (int8)
// or half a byte (int4), so the kernel moves ~3 bytes per bf16 input element
// and does a handful of operations on it. At decode a call is one or twelve
// rows, which is far below what fills the card: launch latency dominates.
//
// Design: one warp per row, four rows per block. The warp strides over the
// row with neighbouring lanes on neighbouring elements (coalesced), reduces
// max|x| with shuffles, then quantizes and stores. The arithmetic is the
// reference's exactly: fp32 max|x|, scale = max(max|x| * (1/qmax), eps) with
// 1/qmax rounded to fp32 (what XLA compiles the JAX division by qmax to),
// q = rint(x / scale) (round half to even, IEEE division), clamp to
// [-127, 127] or [-8, 7], int4 codes offset by +8 with the even element in
// the high nibble. So codes and scales are bit-exact with the plain version.
//
// C interface (loaded with ctypes): every entry point returns
// cudaGetLastError() after its launch; elit_cuda_error_string names a code.
// x_dtype: 0 = float32, 1 = bfloat16, 2 = float16. Rows of x are
// `row_stride` elements apart; q/p and s are contiguous [rows, n] /
// [rows, n/2] / [rows].

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ float row_scale(const T* xr, int n, int lane,
                                           float inv_qmax, float eps) {
  float m = 0.0f;
  for (int i = lane; i < n; i += 32) m = fmaxf(m, fabsf(to_f32(xr[i])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return fmaxf(m * inv_qmax, eps);
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
q8_rows_kernel(const T* __restrict__ x, long long rows, int n, long long row_stride,
               float eps, int8_t* __restrict__ q, float* __restrict__ s) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= rows) return;
  const T* xr = x + r * row_stride;
  const float sc = row_scale(xr, n, lane, 1.0f / 127.0f, eps);
  int8_t* qr = q + r * n;
  for (int i = lane; i < n; i += 32) {
    const float v = fminf(fmaxf(rintf(to_f32(xr[i]) / sc), -127.0f), 127.0f);
    qr[i] = (int8_t)v;
  }
  if (lane == 0) s[r] = sc;
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
q4_rows_kernel(const T* __restrict__ x, long long rows, int n, long long row_stride,
               float eps, uint8_t* __restrict__ p, float* __restrict__ s) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= rows) return;
  const T* xr = x + r * row_stride;
  const float sc = row_scale(xr, n, lane, 1.0f / 7.0f, eps);
  uint8_t* pr = p + r * (n / 2);
  for (int j = lane; j < n / 2; j += 32) {
    const float a = fminf(fmaxf(rintf(to_f32(xr[2 * j]) / sc), -8.0f), 7.0f);
    const float b = fminf(fmaxf(rintf(to_f32(xr[2 * j + 1]) / sc), -8.0f), 7.0f);
    const int hi = (int)a + 8;
    const int lo = (int)b + 8;
    pr[j] = (uint8_t)((hi << 4) | lo);
  }
  if (lane == 0) s[r] = sc;
}

template <typename T, typename Out, typename Kernel>
int launch(Kernel kernel, const void* x, long long rows, int n, long long row_stride,
           float eps, Out* out, float* s, cudaStream_t stream) {
  if (rows > 0) {
    const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    kernel<<<(unsigned)blocks, 32 * kWarpsPerBlock, 0, stream>>>(
        static_cast<const T*>(x), rows, n, row_stride, eps, out, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int elit_quantize_int8_rows(const void* x, int x_dtype, long long rows, int n,
                                       long long row_stride, float eps, int8_t* q,
                                       float* s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0: return launch<float>(q8_rows_kernel<float>, x, rows, n, row_stride, eps, q, s, st);
    case 1: return launch<__nv_bfloat16>(q8_rows_kernel<__nv_bfloat16>, x, rows, n, row_stride, eps, q, s, st);
    case 2: return launch<__half>(q8_rows_kernel<__half>, x, rows, n, row_stride, eps, q, s, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int elit_quantize_int4_rows(const void* x, int x_dtype, long long rows, int n,
                                       long long row_stride, float eps, uint8_t* p,
                                       float* s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n % 2) return (int)cudaErrorInvalidValue;
  switch (x_dtype) {
    case 0: return launch<float>(q4_rows_kernel<float>, x, rows, n, row_stride, eps, p, s, st);
    case 1: return launch<__nv_bfloat16>(q4_rows_kernel<__nv_bfloat16>, x, rows, n, row_stride, eps, p, s, st);
    case 2: return launch<__half>(q4_rows_kernel<__half>, x, rows, n, row_stride, eps, p, s, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* elit_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
