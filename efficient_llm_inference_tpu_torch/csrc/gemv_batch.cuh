// The batched GEMV shared by the chains that apply every weight row to
// several input rows at once: the static-batch steps of megabatch.cu (B
// slots), the speculative verify passes of megaverify.cu (R verify rows of
// one sequence) and, in fp32, the batched verify passes of megabatch_verify.cu
// (R rows of each of B slots; in bf16 those take gemm_rows_tc.cuh's tensor
// cores). Included after megastep_common.cuh, whose prologues
// and epilogues it reuses; like it, each including source gets its own copy
// (anonymous namespace).

#pragma once

#include <algorithm>
#include <initializer_list>

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
// in [B, K] over a row-major [N, K] weight, with megastep_common.cuh's
// GEMV prologues, epilogues and weight tiers. One launch of
// gemv_batch_kernel takes up to kGroup = 8 input rows: a block stages them
// (norm applied, rounded to T) in shared memory, then walks its row groups:
// KS warps split a row's K, and each warp streams RW rows at once (RW
// independent 16-byte loads in flight a lane), applying every weight chunk
// to the staged rows from registers (RW x 8 fp32 accumulators a lane). Past
// 8 input rows the host launches it once per group of 8 rows, each launch
// streaming the weights again (a row's sums do not depend on its group, and
// their summation order is fixed). The input is staged once per block when
// 8 x K values fit kStageMax bytes (the grid is then at most the resident
// blocks, so a block serves many row groups); otherwise in K-chunks (KC, a
// multiple of 256 and so of every tier's chunk), one row group per block.
// Outputs are [B, N] ([B, N/2] for SwiGLU); the argmax partials of input
// row b go to part_val[b * grid + blockIdx.x], one grid for every group.
//
// Weight tiers (WK, megastep_common.cuh's): the inputs are staged in T for every
// tier, so a tier stages as the model dtype does, with 16 bytes more a
// chunk (fp32 staging would double the shared memory and K-chunk
// Llama-3.2-1B's 8192-input down-projection at 8 rows). W_T applies each
// chunk of Vec<T>::N weights to the staged rows; W_I8 / W_I4 put 16 bytes
// after every chunk's inputs (so neighbouring lanes' reads of their chunks
// fall in distinct banks),
// decode each 16-byte load of codes once (weight_tier.cuh decode_chunk) and
// apply it to every staged row, widened to fp32 in registers (chunk_dot):
// the decode is shared by up to 8 rows. W_I8 scales a row's fp32 sum by its
// scale before the bias, the epilogue and the argmax compare; W_I4 scales
// each chunk's fp32 sum by its (row, group) scale in T.

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

// The staging of a tier: the inputs of one 16-byte weight chunk, and the
// padding after each chunk's inputs (values of T: 16 bytes; none for W_T).
template <typename T, int WK> struct Stage {
  static constexpr int CN = QTier<WK>::N, PAD = Vec<T>::N;
};
template <typename T> struct Stage<T, W_T> {
  static constexpr int CN = Vec<T>::N, PAD = 0;
};

// Staged values of a K-chunk of kc inputs (a whole number of chunks).
template <typename T, int WK> __host__ __device__ __forceinline__ int staged_len(int kc) {
  using St = Stage<T, WK>;
  return kc + St::PAD * (kc / St::CN);
}

// Two blocks an SM (at most 128 registers a thread): gemv_batch_rw sizes a
// whole-K grid for two resident blocks, and without the bound ptxas gave
// some RW = 4 instances more than 128 registers, one block an SM.
template <typename T, int PRO, int EPI, int KS, int RW, int WK>
__global__ void __launch_bounds__(kThreads, 2)
gemv_batch_kernel(const void* __restrict__ W, const void* __restrict__ ws, int group, int N,
                  int K, int B, int KC, const T* __restrict__ in,
                  const float* __restrict__ ln_g, const float* __restrict__ ln_b, float ln_eps,
                  const float* __restrict__ bias, T* __restrict__ out,
                  float* __restrict__ part_val, int* __restrict__ part_idx) {
  constexpr int RPB = kWarps / KS * RW;  // rows per block and pass
  constexpr int VN = Vec<T>::N;          // inputs of one 16-byte load of `in`
  constexpr int CN = Stage<T, WK>::CN, SPAD = Stage<T, WK>::PAD;
  static_assert(EPI != EPI_SWIGLU || RPB % 2 == 0, "SwiGLU pairs rows within a pass");
  extern __shared__ __align__(16) unsigned char stage_raw[];
  T* h = reinterpret_cast<T*>(stage_raw);  // [B, staged_len(KC)]
  __shared__ float part[kWarps][RW][kGroup];
  __shared__ float stat[2][kGroup];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = warp / KS, ks = warp % KS;
  const int n_kc = (K + KC - 1) / KC;
  const int KCs = staged_len<T, WK>(KC);
  const size_t row_bytes = weight_row_bytes<T>(WK, K);

  // this warp's 16-byte weight chunks [c0, c1) of K-chunk kc (CN inputs each)
  auto range = [&](int kc, int& c0, int& c1) {
    const int k0 = kc * KC, n = min(KC, K - k0) / CN;
    c0 = k0 / CN + ks * n / KS;
    c1 = k0 / CN + (ks + 1) * n / KS;
  };
  // row i of this warp in the pass at row0 (past N: row N - 1, computed and
  // never stored)
  auto row_of = [&](int row0, int i) { return min(row0 + r * RW + i, N - 1); };
  auto row_ptr = [&](int row0, int i) {
    return reinterpret_cast<const uint4*>(static_cast<const char*>(W) +
                                          (size_t)row_of(row0, i) * row_bytes);
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

  // stage chunk kc of the B input rows (norm applied, rounded to T), 16
  // bytes of `in` a thread and step
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
      *reinterpret_cast<uint4*>(h + (size_t)b * KCs + staged_len<T, WK>(e - k0)) = u;
    }
  };

  float acc[RW][kGroup];
  const int n_groups = WK == W_I4 ? K / group : 1;
  const float chunk_to_group = WK == W_I4 ? (float)CN / (float)group : 0.0f;
  // weight chunk c (cl within the stage) of the RW rows, in u, applied to
  // every staged row
  auto apply = [&](const uint4 (&u)[RW], int cl, int c, int row0) {
    if constexpr (WK == W_T) {
      float w[RW][VN];
#pragma unroll
      for (int i = 0; i < RW; ++i) unpack16(u[i], w[i]);
#pragma unroll
      for (int b = 0; b < kGroup; ++b) {
        if (b < B) {
          float hv[VN];
          unpack16(*reinterpret_cast<const uint4*>(h + (size_t)b * KCs + cl * VN), hv);
#pragma unroll
          for (int i = 0; i < RW; ++i)
#pragma unroll
            for (int v = 0; v < VN; ++v) acc[i][b] = fmaf(w[i][v], hv[v], acc[i][b]);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        float cd[CN];
        decode_chunk<WK>(u[i], cd);
        float sc = 1.0f;
        if constexpr (WK == W_I4)
          sc = to_f32(static_cast<const T*>(ws)[(size_t)row_of(row0, i) * n_groups +
                                                chunk_group(c, chunk_to_group)]);
#pragma unroll
        for (int b = 0; b < kGroup; ++b) {
          if (b < B) {
            const uint4* hb =
                reinterpret_cast<const uint4*>(h + (size_t)b * KCs + cl * (CN + SPAD));
            float a[CN];
#pragma unroll
            for (int q = 0; q < CN / VN; ++q) {
              float v[VN];
              unpack16(hb[q], v);
#pragma unroll
              for (int t = 0; t < VN; ++t) a[q * VN + t] = v[t];
            }
            const float d = chunk_dot<WK>(cd, a);
            acc[i][b] = WK == W_I4 ? fmaf(d, sc, acc[i][b]) : acc[i][b] + d;
          }
        }
      }
    }
  };
  auto row_sum = [&](int j, int b) {  // row j of the pass, the int8 scale applied
    float y = 0.0f;
#pragma unroll
    for (int q = 0; q < KS; ++q) y += part[(j / RW) * KS + q][j % RW][b];
    return y;
  };
  auto scaled = [&](float y, int row) {
    if constexpr (WK == W_I8) y *= static_cast<const float*>(ws)[row];
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
      const int cbase = kc * KC / CN;
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
        apply(u, c - cbase, c, row0);
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
        const int j = t % HP, b = t / HP, o = row0 + 2 * j;
        if (o + 1 < N) {
          const float gate = round_to<T>(silu(scaled(row_sum(2 * j, b), o)));
          const float up = round_to<T>(scaled(row_sum(2 * j + 1, b), o + 1));
          out[(size_t)b * (N / 2) + row0 / 2 + j] = from_f32<T>(gate * up);
        }
      }
    } else if (t < RPB * B && row0 + t % RPB < N) {
      const int j = t % RPB, b = t / RPB, o = row0 + j;
      const float y = scaled(row_sum(j, b), o);
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

// One batched GEMV of weight `w` (tier WK), launched once per group of 8
// input rows. Whole-K staging when a full group fits kStageMax: at most two
// resident blocks an SM (or `max_grid`), each serving many row groups;
// K-chunked: one row group a block. Every group runs the same chunking and
// grid, which is stored in *grid_used.
template <typename T, int PRO, int EPI, int KS, int RW, int WK>
int gemv_batch_rw(const WeightRef& w, int N, int K, int B, const T* in, const float* g,
                  const float* beta, float eps, const float* bias, T* out, float* pv, int* pi,
                  int max_grid, int* grid_used, cudaStream_t st) {
  constexpr int RPB = kWarps / KS * RW;
  using St = Stage<T, WK>;
  const size_t item = sizeof(T);
  const int G = std::min(B, kGroup);
  int KC = K;
  if ((size_t)G * staged_len<T, WK>(K) * item > (size_t)kStageMax)
    KC = (int)((size_t)kStageMax * St::CN / ((size_t)G * item * (St::CN + St::PAD))) / 256 *
         256;
  const size_t smem = (size_t)G * staged_len<T, WK>(KC) * item;
  auto kernel = gemv_batch_kernel<T, PRO, EPI, KS, RW, WK>;
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
    kernel<<<grid, kThreads, smem, st>>>(w.w, w.s, w.group, N, K, std::min(kGroup, B - b0),
                                         KC, in + (size_t)b0 * K, g, beta, eps, bias,
                                         out ? out + b0 * n_out : nullptr,
                                         lm ? pv + (size_t)b0 * grid : nullptr,
                                         lm ? pi + (size_t)b0 * grid : nullptr);
    LAUNCH_CHECK();
    ++launches_made();
  }
  return 0;
}

// RW rows a warp: the largest of 4 and 2 (2 at most for the quantized
// tiers, whose decoded chunks take the registers) that still leaves a row
// group for every SM, else 1.
template <typename T, int PRO, int EPI, int KS, int WK>
int gemv_batch_tier(const WeightRef& w, int N, int K, int B, const T* in, const float* g,
                    const float* beta, float eps, const float* bias, T* out, float* pv,
                    int* pi, int max_grid, int* grid_used, cudaStream_t st) {
  constexpr int kMaxRW = WK == W_T ? 4 : 2;
  if (kMaxRW == 4 && cdiv(N, kWarps / KS * 4) >= sm_count())
    return gemv_batch_rw<T, PRO, EPI, KS, kMaxRW, WK>(w, N, K, B, in, g, beta, eps, bias,
                                                      out, pv, pi, max_grid, grid_used, st);
  if (cdiv(N, kWarps / KS * 2) >= sm_count())
    return gemv_batch_rw<T, PRO, EPI, KS, 2, WK>(w, N, K, B, in, g, beta, eps, bias, out, pv,
                                                 pi, max_grid, grid_used, st);
  return gemv_batch_rw<T, PRO, EPI, KS, 1, WK>(w, N, K, B, in, g, beta, eps, bias, out, pv, pi,
                                               max_grid, grid_used, st);
}

// The batched GEMV of weight `w`'s tier (W_T, W_I8, W_I4).
template <typename T, int PRO, int EPI, int KS>
int gemv_batch(const WeightRef& w, int N, int K, int B, const T* in, const float* g,
               const float* beta, float eps, const float* bias, T* out, float* pv, int* pi,
               int max_grid, int* grid_used, cudaStream_t st) {
  if (w.kind == W_T)
    return gemv_batch_tier<T, PRO, EPI, KS, W_T>(w, N, K, B, in, g, beta, eps, bias, out, pv,
                                                 pi, max_grid, grid_used, st);
  if (w.kind == W_I8)
    return gemv_batch_tier<T, PRO, EPI, KS, W_I8>(w, N, K, B, in, g, beta, eps, bias, out, pv,
                                                  pi, max_grid, grid_used, st);
  if (w.kind == W_I4)
    return gemv_batch_tier<T, PRO, EPI, KS, W_I4>(w, N, K, B, in, g, beta, eps, bias, out, pv,
                                                  pi, max_grid, grid_used, st);
  return (int)cudaErrorInvalidValue;
}

// Whether a chain's weight tier can run: the model dtype, or int8 / int4
// with every code and scale pointer given (`ptrs`), an int4 group with
// G % 32 == 0, and every input width a whole number of the tier's chunks
// (int8: 16 codes; int4: groups).
bool tier_ok(int wk, int G, bool ptrs, std::initializer_list<int> widths) {
  if (wk == W_T) return true;
  if (!ptrs || (wk != W_I8 && wk != W_I4) || (wk == W_I4 && (G <= 0 || G % 32))) return false;
  const int chunk = wk == W_I8 ? 16 : G;
  for (int k : widths)
    if (k % chunk) return false;
  return true;
}

// The GPT-2 and Llama chains' args structs: their tier's pointers and widths.
template <typename Args> bool gpt2_tier_ok(const Args& a) {
  return tier_ok(a.w_kind, a.w_group,
                 a.head && a.attn_s && a.proj_s && a.fc_s && a.fcp_s && a.head_s, {a.n_embd});
}
template <typename Args> bool llama_tier_ok(const Args& a) {
  return tier_ok(a.w_kind, a.w_group, a.qkv_s && a.o_s && a.gu_s && a.down_s && a.head_s,
                 {a.n_embd, a.n_head * a.head_dim, a.inter});
}

}  // namespace
