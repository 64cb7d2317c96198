// k greedy steps of a small draft model in ONE launch (speculative decoding),
// for a GPT-2 draft and for a tied-embedding Llama/Qwen draft.
//
// Replaces efficient_llm_inference_tpu/ops/pallas/megakernel_draft.py:
// gpt2_draft_burst and llama_draft_burst, the TPU's one-program draft bursts.
// Entry point: elit_draft_burst (DraftArgs.family: 0 = GPT-2, 1 = Llama).
// From the round's current token (*tok_in) and the draft's cache length
// (*length = cur), step s = 0..k-1 runs the draft's decode step at cache row
// cur + s and writes its greedy token to tok_out[s], which step s + 1 embeds:
//
//   embed                  GPT-2: wte[tok] + wpe[min(cur + s, P-1)];
//                          Llama: embed[tok]
//   per layer l:
//     norm -> q|k|v        LayerNorm (GPT-2) / RMSNorm (Llama), bias
//     append + attention   query head h over rows c < cur + s and the step's
//                          own k/v (GQA, RoPE at min(cur + s, P-1) for
//                          Llama); one more task writes row cur + s
//     o-proj + x           residual add (GPT-2: bias)
//     norm -> MLP          GELU (GPT-2) or SwiGLU (Llama)
//     MLP-out + x          residual add
//   final norm -> tied LM head over V <= 2048 rows, argmax (first maximum)
//
// Bound: latency. The draft is at most 6 MB (the gate's byte budget, as the
// JAX package's), so after the first step it is read from L2, and a step is
// 5 L + 1 dependent phases of a few microseconds each; its bytes (6 MB at
// 3.35 TB/s: 1.8 us for the whole burst's first read) and operations bound
// it far below what the phases' latency costs.
//
// Launch: ONE thread-block cluster of kCluster = 8 blocks (compile-time
// __cluster_dims__, a plain <<<>>> launch), phases separated by
// cooperative_groups' cluster.sync() (barrier.cluster with release/acquire
// semantics, after a __threadfence). A cluster is chosen over a cooperative
// launch because its blocks are co-scheduled by the hardware on one GPC with
// no occupancy query and no -rdc, its barrier is cheaper than grid.sync(),
// and the launch is an ordinary kernel node, so the engine captures it in
// the speculation round's CUDA graph (checked on the card by chip_smoke.py's
// graph-captured rounds). Activations (the residual stream x, q|k|v, the
// attention and MLP outputs) live in global memory (L2) and are read with
// ld.global.cg so no block sees a stale L1 line; each block recomputes the
// norm it needs into shared memory. Every GEMV row is owned by one warp of
// the cluster (64 warps), 4 rows at a time with their 16-byte weight loads
// in flight together. Tokens never leave the device: every block reduces the
// 8 per-block LM-head partials itself, so the next step starts without
// another barrier.
//
// Numerics: the single-stream step's rounding points (megastep_common.cuh),
// so k bursts equal k plain steps (ops/megakernel_draft.py's plain bursts).
//
// C interface (ctypes): elit_draft_burst takes a DraftArgs (mirrored by
// ops/megakernel_draft.py) and a stream, checks cudaGetLastError() after
// the launch and returns it (0 = success); elit_cuda_error_string names a
// code. dtype: 0 = float32, 1 = bfloat16; head_dim 32, 64 or 128; KV panes
// in the model dtype, [L, C, KW].

#include <cooperative_groups.h>

#include <algorithm>

#include "megastep_common.cuh"

namespace cg = cooperative_groups;

// Mirrored field by field by ops/megakernel_draft.py's DraftArgs (ctypes).
struct DraftArgs {
  int family, dtype, n_layer, n_embd, n_head, n_kv_head, head_dim, inter, vocab, n_pos;
  int capacity, steps;
  float eps;
  const void* qkv_w;   // GPT-2 attn_w [L, 3E, E]; Llama qkv_w [L, QW + 2 KW, E]
  const void* o_w;     // [L, E, QW]
  const void* up_w;    // GPT-2 fc_w [L, 4E, E]; Llama gate|up interleaved [L, 2I, E]
  const void* down_w;  // GPT-2 fcp_w [L, E, 4E]; Llama down_w [L, E, I]
  const void* embed;   // [V, E]: the token embedding and the tied LM head
  const void* wpe;     // GPT-2 [P, E]; null for Llama
  const float* smalls; // GPT-2 [L, 13, E]; Llama norms [L, 2, E]
  const float* lnf;    // GPT-2 [2, E]; Llama [1, E]
  const float* qkvb;   // Llama [L, QW + 2 KW] or null
  const float* cos;    // Llama [P, D] RoPE tables; null for GPT-2
  const float* sin;
  void* k;             // [L, C, KW]
  void* v;
  const int* length;   // [1]: cur
  const int* tok_in;   // [1]: the round's current token
  int* tok_out;        // [steps]: the proposals
  void* x;             // workspace in the model dtype: [E], [QW + 2 KW], [QW], [FF]
  void* qkv;
  void* attn;
  void* ffn;
  float* part_val;     // [kCluster] LM-head partials
  int* part_idx;
};

namespace {

constexpr int kCluster = 8;  // blocks in the cluster (the portable maximum)
constexpr int kRows = 4;     // GEMV rows a warp streams at once

template <typename T> __device__ __forceinline__ float ld_act(const T* p) {
  return to_f32(__ldcg(p));
}

__device__ __forceinline__ void cluster_barrier() {
  __threadfence();
  cg::this_cluster().sync();
}

// The block's copy of a GEMV input in shared memory h[K]: the activation in
// as it is (PRO_VEC), or normalised as megastep_common.cuh's PRO_LN /
// PRO_RMS state it. in == nullptr: h already holds the raw values.
template <typename T, int PRO>
__device__ void stage(const T* in, const float* g, const float* b, int K, float eps, float* h,
                      float* red) {
  if (in != nullptr)
    for (int e = threadIdx.x; e < K; e += kThreads) h[e] = ld_act(in + e);
  __syncthreads();
  if (PRO == PRO_LN) {
    float s = 0.0f;
    for (int e = threadIdx.x; e < K; e += kThreads) s += h[e];
    const float mean = block_sum(s, red) / (float)K;
    float s2 = 0.0f;
    for (int e = threadIdx.x; e < K; e += kThreads) s2 += (h[e] - mean) * (h[e] - mean);
    const float r = rsqrtf(block_sum(s2, red) / (float)K + eps);
    for (int e = threadIdx.x; e < K; e += kThreads)
      h[e] = round_to<T>((h[e] - mean) * r * g[e] + b[e]);
  } else if (PRO == PRO_RMS) {
    float s = 0.0f;
    for (int e = threadIdx.x; e < K; e += kThreads) s += h[e] * h[e];
    const float r = rsqrtf(block_sum(s, red) / (float)K + eps);
    for (int e = threadIdx.x; e < K; e += kThreads)
      h[e] = round_to<T>(round_to<T>(h[e] * r) * round_to<T>(g[e]));
  }
  __syncthreads();
}

// y[row] = h . W[row] for the rows of W [N, K] owned by this warp of the
// cluster, with megastep_common.cuh's GEMV epilogues (EPI_ARGMAX: the warp's first
// (max, argmax) into *best / *best_idx of lane 0).
template <typename T, int EPI>
__device__ void cluster_gemv(const T* __restrict__ W, int N, int K, const float* h,
                             const float* __restrict__ bias, T* out, float* best,
                             int* best_idx) {
  constexpr int VN = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kWarps + (threadIdx.x >> 5), nw = gridDim.x * kWarps;
  const int nc = K / VN;
  for (int r0 = gw * kRows; r0 < N; r0 += nw * kRows) {
    const uint4* wr[kRows];
    float acc[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      wr[i] = reinterpret_cast<const uint4*>(W + (size_t)min(r0 + i, N - 1) * K);
      acc[i] = 0.0f;
    }
    for (int c = lane; c < nc; c += 32) {
      uint4 u[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) u[i] = __ldg(wr[i] + c);
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = dot16<T>(u[i], h + c * VN, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] = warp_sum(acc[i]);
    if (lane != 0) continue;
    if constexpr (EPI == EPI_SWIGLU) {  // rows (2j, 2j + 1) = (gate j, up j); r0 is even
#pragma unroll
      for (int i = 0; i < kRows; i += 2)
        if (r0 + i + 1 < N)
          out[(r0 + i) / 2] = from_f32<T>(round_to<T>(silu(acc[i])) * round_to<T>(acc[i + 1]));
      continue;
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int o = r0 + i;
      if (o >= N) break;
      const float y = acc[i] + (bias != nullptr ? bias[o] : 0.0f);
      if constexpr (EPI == EPI_STORE) {
        out[o] = from_f32<T>(y);
      } else if constexpr (EPI == EPI_GELU) {
        out[o] = from_f32<T>(gelu_tanh(y));
      } else if constexpr (EPI == EPI_RESIDUAL) {
        out[o] = from_f32<T>(ld_act(out + o) + round_to<T>(y));
      } else if (better(acc[i], o, *best, *best_idx)) {
        *best = acc[i];
        *best_idx = o;
      }
    }
  }
}

template <typename T, int D, bool LLAMA>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
draft_burst_kernel(const DraftArgs a) {
  extern __shared__ float h[];  // GEMV inputs; attention_block's scores alias it
  __shared__ float red[kWarps];
  __shared__ float wv[kWarps];
  __shared__ int wi[kWarps];
  __shared__ int cur_sh, tok_sh;
  const int L = a.n_layer, E = a.n_embd, V = a.vocab, C = a.capacity;
  const int QW = a.n_head * D, KW = a.n_kv_head * D, NQKV = QW + 2 * KW;
  const int FF = LLAMA ? a.inter : 4 * E;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* qkv_w = static_cast<const T*>(a.qkv_w);
  const T* o_w = static_cast<const T*>(a.o_w);
  const T* up_w = static_cast<const T*>(a.up_w);
  const T* down_w = static_cast<const T*>(a.down_w);
  const T* embed = static_cast<const T*>(a.embed);
  T* x = static_cast<T*>(a.x);
  T* qkv = static_cast<T*>(a.qkv);
  T* attn = static_cast<T*>(a.attn);
  T* ffn = static_cast<T*>(a.ffn);
  if (threadIdx.x == 0) tok_sh = min(max(*a.tok_in, 0), V - 1);
  const int len0 = *a.length;

  for (int s = 0; s < a.steps; ++s) {
    __syncthreads();  // tok_sh is set
    const int tok = tok_sh, cur = len0 + s;
    if (threadIdx.x == 0) cur_sh = cur;
    for (int l = 0; l < L; ++l) {
      const float* sm = a.smalls + (size_t)l * (LLAMA ? 2 : 13) * E;
      // q|k|v; layer 0 embeds the token into h (block 0 also stores x)
      if (l == 0) {
        const T* we = embed + (size_t)tok * E;
        const T* pe = LLAMA ? nullptr
                            : static_cast<const T*>(a.wpe) + (size_t)min(cur, a.n_pos - 1) * E;
        for (int e = threadIdx.x; e < E; e += kThreads) {
          const float v = LLAMA ? to_f32(we[e]) : round_to<T>(to_f32(we[e]) + to_f32(pe[e]));
          h[e] = v;
          if (blockIdx.x == 0) x[e] = from_f32<T>(v);
        }
      }
      if (LLAMA)
        stage<T, PRO_RMS>(l == 0 ? nullptr : x, sm, nullptr, E, a.eps, h, red);
      else
        stage<T, PRO_LN>(l == 0 ? nullptr : x, sm, sm + E, E, a.eps, h, red);
      const float* qb = LLAMA ? (a.qkvb ? a.qkvb + (size_t)l * NQKV : nullptr) : sm + 4 * E;
      cluster_gemv<T, EPI_STORE>(qkv_w + (size_t)l * NQKV * E, NQKV, E, h, qb, qkv, nullptr,
                                 nullptr);
      cluster_barrier();

      // append row cur and attend (task n_head is attention_block's writer)
      AttnParams p{};
      p.qkv = qkv;
      p.k = static_cast<T*>(a.k) + (size_t)l * C * KW;
      p.v = static_cast<T*>(a.v) + (size_t)l * C * KW;
      p.length = &cur_sh;
      p.cos = a.cos;
      p.sin = a.sin;
      p.n_pos = a.n_pos;
      p.capacity = C;
      p.n_head = a.n_head;
      p.q_width = QW;
      p.kv_width = KW;
      p.group = a.n_head / a.n_kv_head;
      p.sm_scale = 1.0f / sqrtf((float)D);
      p.out = attn;
      for (int task = blockIdx.x; task <= a.n_head; task += gridDim.x) {
        attention_block<T, 0, 0, D>(p, task);
        __syncthreads();  // the next task reuses the shared scores
      }
      cluster_barrier();

      // out-projection + residual
      stage<T, PRO_VEC>(attn, nullptr, nullptr, QW, 0.0f, h, red);
      cluster_gemv<T, EPI_RESIDUAL>(o_w + (size_t)l * E * QW, E, QW, h,
                                    LLAMA ? nullptr : sm + 7 * E, x, nullptr, nullptr);
      cluster_barrier();

      // MLP up (GELU, or SwiGLU over interleaved gate|up rows)
      if (LLAMA) {
        stage<T, PRO_RMS>(x, sm + E, nullptr, E, a.eps, h, red);
        cluster_gemv<T, EPI_SWIGLU>(up_w + (size_t)l * 2 * FF * E, 2 * FF, E, h, nullptr, ffn,
                                    nullptr, nullptr);
      } else {
        stage<T, PRO_LN>(x, sm + 2 * E, sm + 3 * E, E, a.eps, h, red);
        cluster_gemv<T, EPI_GELU>(up_w + (size_t)l * FF * E, FF, E, h, sm + 8 * E, ffn, nullptr,
                                  nullptr);
      }
      cluster_barrier();

      // MLP down + residual
      stage<T, PRO_VEC>(ffn, nullptr, nullptr, FF, 0.0f, h, red);
      cluster_gemv<T, EPI_RESIDUAL>(down_w + (size_t)l * E * FF, E, FF, h,
                                    LLAMA ? nullptr : sm + 12 * E, x, nullptr, nullptr);
      cluster_barrier();
    }

    // final norm -> tied LM head: per-block (max, argmax) partials
    if (LLAMA)
      stage<T, PRO_RMS>(x, a.lnf, nullptr, E, a.eps, h, red);
    else
      stage<T, PRO_LN>(x, a.lnf, a.lnf + E, E, a.eps, h, red);
    float best = -INFINITY;
    int best_idx = 0;
    cluster_gemv<T, EPI_ARGMAX>(embed, V, E, h, nullptr, nullptr, &best, &best_idx);
    if (lane == 0) {
      wv[warp] = best;
      wi[warp] = best_idx;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float v = wv[0];
      int i = wi[0];
      for (int w = 1; w < kWarps; ++w)
        if (better(wv[w], wi[w], v, i)) { v = wv[w]; i = wi[w]; }
      a.part_val[blockIdx.x] = v;
      a.part_idx[blockIdx.x] = i;
    }
    cluster_barrier();

    // every block: the first maximum over the partials -> the next token
    if (threadIdx.x == 0) {
      float v = __ldcg(a.part_val);
      int i = __ldcg(a.part_idx);
      for (int b = 1; b < (int)gridDim.x; ++b) {
        const float bv = __ldcg(a.part_val + b);
        const int bi = __ldcg(a.part_idx + b);
        if (better(bv, bi, v, i)) { v = bv; i = bi; }
      }
      tok_sh = min(max(i, 0), V - 1);
      if (blockIdx.x == 0) a.tok_out[s] = tok_sh;
    }
  }
}

template <typename T, bool LLAMA>
int launch_burst(const DraftArgs& a, cudaStream_t st) {
  const int QW = a.n_head * a.head_dim, KW = a.n_kv_head * a.head_dim;
  const int FF = LLAMA ? a.inter : 4 * a.n_embd;
  const int width = std::max(std::max(a.capacity, KW), std::max(std::max(a.n_embd, QW), FF));
  const size_t smem = sizeof(float) * (size_t)width;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (a.head_dim == 32)
    draft_burst_kernel<T, 32, LLAMA><<<kCluster, kThreads, smem, st>>>(a);
  else if (a.head_dim == 64)
    draft_burst_kernel<T, 64, LLAMA><<<kCluster, kThreads, smem, st>>>(a);
  else if (a.head_dim == 128)
    draft_burst_kernel<T, 128, LLAMA><<<kCluster, kThreads, smem, st>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  LAUNCH_CHECK();
  return 0;
}

int run(const DraftArgs* a, void* stream) {
  if (a == nullptr) return (int)cudaErrorInvalidValue;
  const int D = a->head_dim, Hq = a->n_head, Hkv = a->n_kv_head;
  const bool llama = a->family == 1;
  // 16-byte weight rows need widths that are multiples of 8 values
  if ((a->family != 0 && a->family != 1) || Hkv <= 0 || Hq % Hkv || a->n_embd % 8 ||
      (Hq * D) % 8 || (llama && a->inter % 8) || a->capacity <= 0 || a->steps < 1 ||
      a->vocab <= 0 || a->n_pos <= 0 || (llama && (!a->cos || !a->sin)) ||
      (!llama && (!a->wpe || Hq != Hkv)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->dtype == 0) return llama ? launch_burst<float, true>(*a, st)
                                  : launch_burst<float, false>(*a, st);
  if (a->dtype == 1) return llama ? launch_burst<__nv_bfloat16, true>(*a, st)
                                  : launch_burst<__nv_bfloat16, false>(*a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int elit_draft_burst(const DraftArgs* a, void* stream) { return run(a, stream); }

extern "C" const char* elit_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
