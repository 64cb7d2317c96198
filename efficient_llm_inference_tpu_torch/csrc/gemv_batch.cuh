// The batched GEMV shared by the chains that apply every weight row to
// several input rows at once: the static-batch steps of megabatch.cu (B
// slots), the speculative verify passes of megaverify.cu (R verify rows of
// one sequence) and the batched verify passes of megabatch_verify.cu (R rows
// of each of B slots). Included after megastep_common.cuh, whose prologues
// and epilogues it reuses; like it, each including source gets its own copy
// (anonymous namespace).

#pragma once

#include <algorithm>

#include "megastep_common.cuh"

namespace {

constexpr int kMaxRows = 256;  // input rows of one batched GEMV: 32 slots x 8 verify rows
constexpr int kGroup = 8;      // input rows of one gemv_batch_kernel launch

#define RETURN_IF(rc_expr)          \
  do {                              \
    const int rc_ = (rc_expr);      \
    if (rc_) return rc_;            \
  } while (0)

// ----------------------------------------------------------- batched GEMV
//
// y[b, row] = sum_k in[b, k] * W[row, k] for the B <= kMaxRows rows of
// in [B, K] over a row-major [N, K] weight, with the single-stream
// gemv_kernel's prologues and epilogues. One launch of gemv_batch_kernel
// takes up to kGroup = 8 input rows: a block stages them (norm applied,
// rounded to T) in shared memory, then walks its row groups: KS warps split
// a row's K, and each warp streams RW rows at once (RW independent 16-byte
// loads in flight a lane), applying every weight chunk to the staged rows
// from registers (RW x 8 fp32 accumulators a lane). Past 8 input rows the
// host launches it once per group of 8 rows, each launch streaming the
// weights again (a row's sums do not depend on its group). The input is
// staged once per block when 8 x K values fit kStageMax bytes (the grid is
// then at most the resident blocks, so a block serves many row groups);
// otherwise in K-chunks, one row group per block. Outputs are [B, N]
// ([B, N/2] for SwiGLU); the argmax partials of input row b go to
// part_val[b * grid + blockIdx.x], one grid for every group.

constexpr int kStageMax = 200 * 1024;  // dynamic shared memory for staged inputs

template <typename T> __device__ __forceinline__ uint4 pack16(const float (&v)[Vec<T>::N]);
template <> __device__ __forceinline__ uint4 pack16<float>(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
template <> __device__ __forceinline__ uint4 pack16<__nv_bfloat16>(const float (&v)[8]) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (unsigned)__bfloat16_as_ushort(__float2bfloat16(v[2 * i])) |
           ((unsigned)__bfloat16_as_ushort(__float2bfloat16(v[2 * i + 1])) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T, int PRO, int EPI, int KS, int RW>
__global__ void __launch_bounds__(kThreads)
gemv_batch_kernel(const T* __restrict__ W, int N, int K, int B, int KC,
                  const T* __restrict__ in, const float* __restrict__ ln_g,
                  const float* __restrict__ ln_b, float ln_eps, const float* __restrict__ bias,
                  T* __restrict__ out, float* __restrict__ part_val, int* __restrict__ part_idx) {
  constexpr int RPB = kWarps / KS * RW;  // rows per block and pass
  constexpr int VN = Vec<T>::N;
  static_assert(EPI != EPI_SWIGLU || RPB % 2 == 0, "SwiGLU pairs rows within a pass");
  extern __shared__ __align__(16) unsigned char stage_raw[];
  T* h = reinterpret_cast<T*>(stage_raw);  // [B, KC]
  __shared__ float part[kWarps][RW][kGroup];
  __shared__ float stat[2][kGroup];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = warp / KS, ks = warp % KS;
  const int n_kc = (K + KC - 1) / KC;

  // this warp's 16-byte chunks [c0, c1) of chunk kc, in units of VN values
  auto range = [&](int kc, int& c0, int& c1) {
    const int k0 = kc * KC, n = min(KC, K - k0) / VN;
    c0 = k0 / VN + ks * n / KS;
    c1 = k0 / VN + (ks + 1) * n / KS;
  };
  // the weight rows of this warp in the pass at row0 (past N: row N - 1,
  // computed and never stored)
  auto row_ptr = [&](int row0, int i) {
    return reinterpret_cast<const uint4*>(W + (size_t)min(row0 + r * RW + i, N - 1) * K);
  };

  uint4 pre[RW];  // the first chunk of each row, requested before the prologue
  {
    int c0, c1;
    range(0, c0, c1);
    if (c0 + lane < c1) {
#pragma unroll
      for (int i = 0; i < RW; ++i) pre[i] = load_stream(row_ptr(blockIdx.x * RPB, i) + c0 + lane);
    }
  }
  if (PRO != PRO_VEC && warp < B) {  // warp b: the norm statistics of slot b
    const uint4* xb = reinterpret_cast<const uint4*>(in + (size_t)warp * K);
    float s = 0.0f;
    for (int c = lane; c < K / VN; c += 32) {
      float v[VN];
      unpack16(xb[c], v);
#pragma unroll
      for (int i = 0; i < VN; ++i) s += PRO == PRO_LN ? v[i] : v[i] * v[i];
    }
    s = warp_sum(s);
    if (PRO == PRO_LN) {
      const float mean = s / (float)K;
      float s2 = 0.0f;
      for (int c = lane; c < K / VN; c += 32) {
        float v[VN];
        unpack16(xb[c], v);
#pragma unroll
        for (int i = 0; i < VN; ++i) s2 += (v[i] - mean) * (v[i] - mean);
      }
      s2 = warp_sum(s2);
      if (lane == 0) {
        stat[0][warp] = mean;
        stat[1][warp] = rsqrtf(s2 / (float)K + ln_eps);
      }
    } else if (lane == 0) {
      stat[1][warp] = rsqrtf(s / (float)K + ln_eps);
    }
  }

  // stage chunk kc of the B input rows (norm applied, rounded to T), 16 bytes
  // a thread and step
  auto stage = [&](int kc) {
    const int k0 = kc * KC, nv = min(KC, K - k0) / VN;
    for (int j = threadIdx.x; j < B * nv; j += kThreads) {
      const int b = j / nv, e = k0 + (j - b * nv) * VN;
      uint4 u = *reinterpret_cast<const uint4*>(in + (size_t)b * K + e);
      if (PRO != PRO_VEC) {
        float v[VN];
        unpack16(u, v);
#pragma unroll
        for (int i = 0; i < VN; ++i) {
          if (PRO == PRO_LN)
            v[i] = (v[i] - stat[0][b]) * stat[1][b] * ln_g[e + i] + ln_b[e + i];
          else
            v[i] = round_to<T>(v[i] * stat[1][b]) * round_to<T>(ln_g[e + i]);
        }
        u = pack16<T>(v);  // rounds to T
      }
      *reinterpret_cast<uint4*>(h + (size_t)b * KC + (e - k0)) = u;
    }
  };

  float acc[RW][kGroup];
  auto apply = [&](const uint4 (&u)[RW], int cl) {  // chunk cl (VN values) of the stage
    float w[RW][VN];
#pragma unroll
    for (int i = 0; i < RW; ++i) unpack16(u[i], w[i]);
#pragma unroll
    for (int b = 0; b < kGroup; ++b) {
      if (b < B) {
        float hv[VN];
        unpack16(*reinterpret_cast<const uint4*>(h + (size_t)b * KC + cl * VN), hv);
#pragma unroll
        for (int i = 0; i < RW; ++i)
#pragma unroll
          for (int v = 0; v < VN; ++v) acc[i][b] = fmaf(w[i][v], hv[v], acc[i][b]);
      }
    }
  };
  auto row_sum = [&](int j, int b) {  // row j of the pass
    float y = 0.0f;
#pragma unroll
    for (int q = 0; q < KS; ++q) y += part[(j / RW) * KS + q][j % RW][b];
    return y;
  };

  // epilogue thread t: slot t / RPB (t / (RPB/2) for SwiGLU), row t % RPB
  float best = -INFINITY;
  int best_idx = 0;
  int staged = -1;
  __syncthreads();  // stat[] is complete
  for (int row0 = blockIdx.x * RPB; row0 < N; row0 += gridDim.x * RPB) {
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int b = 0; b < kGroup; ++b) acc[i][b] = 0.0f;
    for (int kc = 0; kc < n_kc; ++kc) {
      if (kc != staged) {  // uniform over the block
        __syncthreads();
        stage(kc);
        __syncthreads();
        staged = kc;
      }
      int c0, c1;
      range(kc, c0, c1);
      const int cbase = kc * KC / VN;
      const uint4* wr[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i) wr[i] = row_ptr(row0, i);
      // software-pipelined: the next chunks are requested before this one's
      // FMAs, so each warp keeps 2 x RW loads in flight
      int c = c0 + lane;
      uint4 u[RW];
      if (row0 == blockIdx.x * RPB && kc == 0) {
#pragma unroll
        for (int i = 0; i < RW; ++i) u[i] = pre[i];
      } else if (c < c1) {
#pragma unroll
        for (int i = 0; i < RW; ++i) u[i] = load_stream(wr[i] + c);
      }
#pragma unroll (RW == 1 ? 2 : 1)
      for (; c < c1; c += 32) {
        uint4 un[RW];
        if (c + 32 < c1) {
#pragma unroll
          for (int i = 0; i < RW; ++i) un[i] = load_stream(wr[i] + c + 32);
        }
        apply(u, c - cbase);
#pragma unroll
        for (int i = 0; i < RW; ++i) u[i] = un[i];
      }
    }
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int b = 0; b < kGroup; ++b) {
        if (b < B) {
          const float v = warp_sum(acc[i][b]);
          if (lane == 0) part[warp][i][b] = v;
        }
      }
    __syncthreads();
    const int t = threadIdx.x;
    if (EPI == EPI_SWIGLU) {
      constexpr int HP = RPB / 2;
      if (t < HP * B) {
        const int j = t % HP, b = t / HP;
        if (row0 + 2 * j + 1 < N) {
          const float gate = round_to<T>(silu(row_sum(2 * j, b)));
          const float up = round_to<T>(row_sum(2 * j + 1, b));
          out[(size_t)b * (N / 2) + row0 / 2 + j] = from_f32<T>(gate * up);
        }
      }
    } else if (t < RPB * B && row0 + t % RPB < N) {
      const int j = t % RPB, b = t / RPB, o = row0 + j;
      const float y = row_sum(j, b);
      const float bo = bias != nullptr ? bias[o] : 0.0f;
      if (EPI == EPI_STORE) {
        out[(size_t)b * N + o] = from_f32<T>(y + bo);
      } else if (EPI == EPI_GELU) {
        out[(size_t)b * N + o] = from_f32<T>(gelu_tanh(y + bo));
      } else if (EPI == EPI_RESIDUAL) {
        T* ob = out + (size_t)b * N + o;
        *ob = from_f32<T>(to_f32(*ob) + round_to<T>(y + bo));
      } else if (better(y, o, best, best_idx)) {
        best = y;
        best_idx = o;
      }
    }
    __syncthreads();  // part[] is rewritten by the next pass
  }
  if (EPI == EPI_ARGMAX) {
    __shared__ float bv[kGroup][RPB];
    __shared__ int bi[kGroup][RPB];
    if (threadIdx.x < RPB * B) {
      bv[threadIdx.x / RPB][threadIdx.x % RPB] = best;
      bi[threadIdx.x / RPB][threadIdx.x % RPB] = best_idx;
    }
    __syncthreads();
    if (threadIdx.x < B) {
      const int b = threadIdx.x;
      float v = bv[b][0];
      int i = bi[b][0];
      for (int t = 1; t < RPB; ++t)
        if (better(bv[b][t], bi[b][t], v, i)) { v = bv[b][t]; i = bi[b][t]; }
      part_val[(size_t)b * gridDim.x + blockIdx.x] = v;
      part_idx[(size_t)b * gridDim.x + blockIdx.x] = i;
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

// One batched GEMV, launched once per group of 8 input rows. RW = 4 (or 2)
// rows a warp where that still leaves a row group for every SM, else 1.
// Whole-K staging when a full group fits kStageMax: at most two resident
// blocks an SM (or `max_grid`), each serving many row groups; K-chunked:
// one row group a block. Every group runs the same chunking and grid, which
// is stored in *grid_used.
template <typename T, int PRO, int EPI, int KS, int RW>
int gemv_batch_rw(const T* W, int N, int K, int B, const T* in, const float* g,
                  const float* beta, float eps, const float* bias, T* out, float* pv, int* pi,
                  int max_grid, int* grid_used, cudaStream_t st) {
  constexpr int RPB = kWarps / KS * RW;
  const size_t item = sizeof(T);
  const int G = std::min(B, kGroup);
  int KC = K;
  if ((size_t)G * K * item > (size_t)kStageMax)
    KC = (int)(kStageMax / (G * item)) / 256 * 256;
  const size_t smem = (size_t)G * KC * item;
  auto kernel = gemv_batch_kernel<T, PRO, EPI, KS, RW>;
  if (smem > 32 * 1024)  // above 48 KB with the static shared memory: opt in
    RETURN_IF((int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)smem));
  int grid = cdiv(N, RPB);
  if (KC == K) {
    const int per_sm = std::max(1, std::min(2, (int)((227 * 1024) / (smem + 4096))));
    grid = std::min(grid, sm_count() * per_sm);
  }
  if (max_grid > 0) grid = std::min(grid, max_grid);
  if (grid_used != nullptr) *grid_used = grid;
  const size_t n_out = EPI == EPI_SWIGLU ? N / 2 : N;
  const bool lm = pv != nullptr;
  for (int b0 = 0; b0 < B; b0 += kGroup) {
    kernel<<<grid, kThreads, smem, st>>>(W, N, K, std::min(kGroup, B - b0), KC,
                                         in + (size_t)b0 * K, g, beta, eps, bias,
                                         out ? out + b0 * n_out : nullptr,
                                         lm ? pv + (size_t)b0 * grid : nullptr,
                                         lm ? pi + (size_t)b0 * grid : nullptr);
    LAUNCH_CHECK();
  }
  return 0;
}

template <typename T, int PRO, int EPI, int KS>
int gemv_batch(const T* W, int N, int K, int B, const T* in, const float* g, const float* beta,
               float eps, const float* bias, T* out, float* pv, int* pi, int max_grid,
               int* grid_used, cudaStream_t st) {
  if (cdiv(N, kWarps / KS * 4) >= sm_count())
    return gemv_batch_rw<T, PRO, EPI, KS, 4>(W, N, K, B, in, g, beta, eps, bias, out, pv, pi,
                                             max_grid, grid_used, st);
  if (cdiv(N, kWarps / KS * 2) >= sm_count())
    return gemv_batch_rw<T, PRO, EPI, KS, 2>(W, N, K, B, in, g, beta, eps, bias, out, pv, pi,
                                             max_grid, grid_used, st);
  return gemv_batch_rw<T, PRO, EPI, KS, 1>(W, N, K, B, in, g, beta, eps, bias, out, pv, pi,
                                           max_grid, grid_used, st);
}

}  // namespace
