// Weight-streaming linear y = x @ w for a few rows: x [B, E], w [E, F]
// row-major (the JAX layout), fp32 accumulation, y [B, F] in x's type.
//
// Replaces efficient_llm_inference_tpu/ops/pallas/linear.py: pallas_linear
// (w float32 or bfloat16, x of either type: a mixed pair computes in fp32,
// as JAX's promotion does) and pallas_linear_int8 (w int8 codes with one
// fp32 scale per output column; the JAX kernel's rounding points: x rounded
// to bf16, the codes exact, an fp32 sum, times the column's scale in fp32,
// then cast to x's type).
//
// Two routes, chosen by the dtype pair alone:
//
// * bf16 x and bf16 w (elit_linear_bf16): the tensor cores, through
//   gemm_rows_tc.cuh's skinny GEMM on the [E, F] weight as it lies (N = F
//   contiguous: ldmatrix.trans), every weight read once for up to 256 rows,
//   K split by (F, E) alone, so a row's result does not depend on B. The
//   JAX kernel is dot_general with preferred fp32 and a cast: bf16 x bf16
//   products are exact in fp32, so only the order of the sum differs.
//   Ragged edges (E = 96, 100; F = 77, 50257) are zero-filled; rows that
//   are not 16-byte aligned (F or E not a multiple of 8) are loaded element
//   by element, the weights a stage ahead in registers.
// * a pair with an fp32 operand, and the int8 codes (elit_linear,
//   elit_linear_int8): the CUDA cores in fp32, which keeps the fp32 oracle
//   exact (TF32 would not) and int8's 16-byte code loads.
//
// Bound: bytes. At B <= 8 every weight element is used for at most 8
// multiply-adds, far below the ~20 operations per byte at which the H100's
// fp32 CUDA cores would limit, so the floor is the weight bytes
// (E F itemsize, plus F scales) / 3.35 TB/s. The CUDA-core design streams w
// exactly once per group of 8 rows with enough loads in flight to fill the
// card:
// * a block of 8 warps owns a strip of 256 output columns and 8 x ec rows
//   of E (ec in {8, 16, 32, 64}, chosen by the host so that the grid has at
//   least two blocks an SM); each warp walks its own ec rows, 4 rows at a
//   time (4 independent loads a lane in flight);
// * lane l holds 8 columns: with 16-byte aligned rows (F % 8 == 0) the 8
//   neighbouring columns 8 l .. 8 l + 7 (one 16-byte load of bf16, 8 bytes
//   of int8, two of fp32); otherwise (a ragged F such as GPT-2's vocabulary,
//   50257) the columns l, l + 32, ..., l + 224, each load still coalesced
//   across the warp; columns past F are masked;
// * the block's x rows (fp32, bf16-rounded for int8) are staged in shared
//   memory once, and each lane keeps B x 8 fp32 sums in registers;
// * the 8 warps' sums are added in shared memory in a fixed order, and each
//   block writes one fp32 partial per (row, column); a second kernel adds
//   the blocks' partials along E in order, applies the int8 scale and
//   rounds. So the result does not depend on scheduling.
//
// Above 8 rows the grid's z dimension walks groups of 8 rows, each group
// streaming the weights again (as csrc/gemv_batch.cuh does).
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launches; elit_cuda_error_string names a code. dtypes: 0 = float32,
// 1 = bfloat16 (x and, for elit_linear, w; elit_linear takes no bf16 pair).
// x, w, out contiguous; part is fp32 scratch of ceil(E / (8 ec)) x B x F.
// elit_linear_bf16: part holds tcg::part_floats(F, E, min(B, 256)) floats,
// counters tcg::kCounters zeroed ints (left zeroed); above 256 rows the
// groups of 256 run in turn.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_rows_tc.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 8;                // columns a lane
constexpr int kStrip = 32 * kCols;      // columns a block
constexpr int kGroup = 8;               // x rows a block
constexpr int kMaxEc = 64;              // E rows a warp
constexpr int kUnroll = 4;              // weight rows in flight a warp

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Lane `lane`'s 8 columns of one weight row (row points at column 0).
template <typename TW, bool VEC>
__device__ __forceinline__ void load_cols(const TW* __restrict__ row, int f0, int lane, int F,
                                          float (&out)[kCols]) {
  if constexpr (VEC) {
    const int f = f0 + lane * kCols;
    if (f >= F) {  // F % 8 == 0: a lane's 8 columns are all in or all out
#pragma unroll
      for (int i = 0; i < kCols; ++i) out[i] = 0.0f;
      return;
    }
    if constexpr (sizeof(TW) == 4) {
      const float4 a = *reinterpret_cast<const float4*>(row + f);
      const float4 b = *reinterpret_cast<const float4*>(row + f + 4);
      out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
      out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
    } else if constexpr (sizeof(TW) == 2) {
      const uint4 raw = *reinterpret_cast<const uint4*>(row + f);
      const TW* v = reinterpret_cast<const TW*>(&raw);
#pragma unroll
      for (int i = 0; i < kCols; ++i) out[i] = to_f32(v[i]);
    } else {
      const uint2 raw = *reinterpret_cast<const uint2*>(row + f);
      const TW* v = reinterpret_cast<const TW*>(&raw);
#pragma unroll
      for (int i = 0; i < kCols; ++i) out[i] = to_f32(v[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int f = f0 + lane + 32 * i;
      out[i] = f < F ? to_f32(row[f]) : 0.0f;
    }
  }
}

template <bool VEC>
__device__ __forceinline__ int col_of(int lane, int i) {
  return VEC ? lane * kCols + i : lane + 32 * i;
}

// Block (strip, e-block, row group): the strip's fp32 partial sums over the
// block's 8 ec rows of E for the group's rows, into part[e-block][b][f].
template <typename TX, typename TW, int NB, bool VEC, bool INT8>
__global__ void __launch_bounds__(kThreads)
linear_partial_kernel(const TX* __restrict__ x, int B, int E, const TW* __restrict__ w, int F,
                      int ec, float* __restrict__ part) {
  __shared__ float xs[NB][kWarps * kMaxEc];
  __shared__ float red[kWarps][kStrip];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f0 = blockIdx.x * kStrip;
  const int eb = blockIdx.y * kWarps * ec;
  const int b0 = blockIdx.z * kGroup;
  const int nb = min(kGroup, B - b0);
  const int ne = max(0, min(kWarps * ec, E - eb));

  for (int i = threadIdx.x; i < NB * kWarps * ec; i += kThreads) {
    const int b = i / (kWarps * ec), e = i % (kWarps * ec);
    float v = 0.0f;
    if (b < nb && e < ne) {
      v = to_f32(x[(size_t)(b0 + b) * E + eb + e]);
      if constexpr (INT8) v = __bfloat162float(__float2bfloat16(v));
    }
    xs[b][e] = v;
  }
  __syncthreads();

  float acc[NB][kCols];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[b][i] = 0.0f;

  const int e_end = min((warp + 1) * ec, ne);
  for (int e = warp * ec; e < e_end; e += kUnroll) {
    float wv[kUnroll][kCols];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (e + u < e_end) {
        load_cols<TW, VEC>(w + (size_t)(eb + e + u) * F, f0, lane, F, wv[u]);
      } else {
#pragma unroll
        for (int i = 0; i < kCols; ++i) wv[u][i] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float xv = xs[b][e + u];  // past e_end: a finite value times 0
#pragma unroll
        for (int i = 0; i < kCols; ++i) acc[b][i] = fmaf(xv, wv[u][i], acc[b][i]);
      }
    }
  }

  const int f = f0 + threadIdx.x;  // kThreads == kStrip: thread t adds column t
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int i = 0; i < kCols; ++i) red[warp][col_of<VEC>(lane, i)] = acc[b][i];
    __syncthreads();
    float s = 0.0f;
#pragma unroll
    for (int w_ = 0; w_ < kWarps; ++w_) s += red[w_][threadIdx.x];
    if (b < nb && f < F) part[((size_t)blockIdx.y * B + b0 + b) * F + f] = s;
    __syncthreads();
  }
}

// out[b, f] = (sum over e-blocks k of part[k][b][f], in order) [* scale[f]].
template <typename TX, bool INT8>
__global__ void __launch_bounds__(kThreads)
linear_reduce_kernel(const float* __restrict__ part, int KS, int B, int F,
                     const float* __restrict__ scale, TX* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n = (long long)B * F;
  if (i >= n) return;
  float s = 0.0f;
  for (int k = 0; k < KS; ++k) s += part[(size_t)k * n + i];
  if constexpr (INT8) s *= scale[i % F];
  put(out + i, s);
}

template <typename TX, typename TW, int NB, bool VEC, bool INT8>
void launch_partial(const void* x, int B, int E, const void* w, int F, int ec, float* part,
                    cudaStream_t st) {
  const dim3 grid((F + kStrip - 1) / kStrip, (E + kWarps * ec - 1) / (kWarps * ec),
                  (B + kGroup - 1) / kGroup);
  linear_partial_kernel<TX, TW, NB, VEC, INT8><<<grid, kThreads, 0, st>>>(
      static_cast<const TX*>(x), B, E, static_cast<const TW*>(w), F, ec, part);
}

template <typename TX, typename TW, bool INT8>
int launch(const void* x, int B, int E, const void* w, int F, const float* scale, int ec,
           int vec, float* part, void* out, cudaStream_t st) {
  const int nb = B < kGroup ? B : kGroup;
#define ELIT_PARTIAL(NB)                                                                  \
  (vec ? launch_partial<TX, TW, NB, true, INT8>(x, B, E, w, F, ec, part, st)              \
       : launch_partial<TX, TW, NB, false, INT8>(x, B, E, w, F, ec, part, st))
  if (nb <= 1) ELIT_PARTIAL(1);
  else if (nb <= 2) ELIT_PARTIAL(2);
  else if (nb <= 4) ELIT_PARTIAL(4);
  else ELIT_PARTIAL(8);
#undef ELIT_PARTIAL
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int KS = (E + kWarps * ec - 1) / (kWarps * ec);
  const long long n = (long long)B * F;
  linear_reduce_kernel<TX, INT8><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      part, KS, B, F, scale, static_cast<TX*>(out));
  return (int)cudaGetLastError();
}

bool shape_ok(int B, int E, int F, int ec) {
  return B >= 1 && E >= 1 && F >= 1 && (ec == 8 || ec == 16 || ec == 32 || ec == 64) &&
         (B + kGroup - 1) / kGroup <= 65535 && (E + kWarps * ec - 1) / (kWarps * ec) <= 65535;
}

}  // namespace

extern "C" int elit_linear(int x_dtype, int w_dtype, const void* x, int B, int E, const void* w,
                           int F, int ec, int vec, float* part, void* out, void* stream) {
  if (!shape_ok(B, E, F, ec)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float, false>(x, B, E, w, F, nullptr, ec, vec, part, out, st);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16, false>(x, B, E, w, F, nullptr, ec, vec, part, out, st);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float, false>(x, B, E, w, F, nullptr, ec, vec, part, out, st);
  return (int)cudaErrorInvalidValue;  // bf16 x bf16: elit_linear_bf16
}

namespace {

// The tensor-core route's epilogue: out[r, n] = bf16(y).
struct StoreEpi {
  __nv_bfloat16* out;
  __device__ void apply(const float* ys, int ldy, int n0, int N, int R) {
    for (int i = threadIdx.x; i < R * tcg::BM; i += tcg::kThreads) {
      const int r = i / tcg::BM, m = i - r * tcg::BM;
      if (n0 + m < N) out[(size_t)r * N + n0 + m] = __float2bfloat16(ys[r * ldy + m]);
    }
  }
  __device__ void finish(int) {}
  StoreEpi shifted(int r0, int N, int) const { return {out + (size_t)r0 * N}; }
};

}  // namespace

extern "C" int elit_linear_bf16(const void* x, int B, int E, const void* w, int F, int x_aligned,
                                int w_aligned, float* part, long long part_len, int* counters,
                                void* out, void* stream) {
  if (B < 1 || E < 1 || F < 1) return (int)cudaErrorInvalidValue;
  const tcg::Gemm g{w, nullptr, 0, F, E, B, static_cast<const __nv_bfloat16*>(x), w_aligned,
                    x_aligned, 1, part, counters};
  return tcg::gemm_rows<tcg::LAYOUT_KN, W_T>(g, part_len, 0, nullptr,
                                             StoreEpi{static_cast<__nv_bfloat16*>(out)},
                                             static_cast<cudaStream_t>(stream));
}

extern "C" int elit_linear_int8(int x_dtype, const void* x, int B, int E, const int8_t* w,
                                int F, const float* scale, int ec, int vec, float* part,
                                void* out, void* stream) {
  if (!shape_ok(B, E, F, ec)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return launch<float, int8_t, true>(x, B, E, w, F, scale, ec, vec, part, out, st);
  if (x_dtype == 1)
    return launch<__nv_bfloat16, int8_t, true>(x, B, E, w, F, scale, ec, vec, part, out, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* elit_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
