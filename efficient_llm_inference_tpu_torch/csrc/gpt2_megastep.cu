// One GPT-2 decode step (greedy, batch 1) as a fixed chain of kernels.
//
// Replaces efficient_llm_inference_tpu/ops/pallas/megakernel.py:
// gpt2_megastep and ops/pallas/megakernel_quant.py: gpt2_megastep_quant, the
// TPU's whole-step decode programs. Entry points: elit_gpt2_megastep (KV
// panes in the model dtype) and elit_gpt2_megastep_quant (int8, half-split
// int4 or mixed panes with per-token fp32 scales). Each launches, on the
// stream it is given:
//
//   embed                  x = wte[tok] + wpe[min(length, P-1)] (or x_emb)
//   per layer l:
//     gemv  LN1 -> qkv     LN1 (fp32 statistics) in the prologue, q|k|v out
//     attention            one block per head over rows t < length with the
//                          current token merged into the softmax; one more
//                          block writes row `length` of layer l's panes
//                          (quantize-on-write for quantized panes)
//     gemv  proj + x       out-projection, bias, residual add in place
//     gemv  LN2 -> fc      LN2 prologue, tanh-GELU epilogue in fp32
//     gemv  fc_proj + x    bias, residual add in place
//   gemv  LNf -> LM head   logits over wte's rows, per-block (max, argmax)
//   argmax                 first maximum over the blocks -> token; with
//                          `advance`, clamp it to [0, V-1] and length += 1
//
// Bound: bytes. A step reads every weight once: for GPT-2 small in bf16,
// 12 x 9216 x 768 x 2 B of layer weights + 50257 x 768 x 2 B of LM head =
// 247 MB, plus the visible KV rows (~9.8 MB at 319 rows in bf16), so it
// cannot take less than ~77 us at 3.35 TB/s; it does ~2 operations per
// weight byte, far below the ~295 per byte where compute would bind. So
// every GEMV streams its weight rows once with 16-byte non-caching loads,
// neighbouring lanes on neighbouring addresses, requests them before its
// layer-norm or input prologue so that the two overlap, accumulates in
// fp32, and is split (rows per block, and the input split across warps
// where outputs are few) so that 192-1056 blocks of 8 warps are in flight on
// the 132 SMs; activations stay in shared memory and L2 (a few KB per step).
// The layer norms are recomputed by every block of the GEMV that consumes
// them (E values from L2) instead of costing a launch. The chain is 5 L + 3
// kernels; the engine captures the N steps of a generation in one CUDA
// graph, so the host issues one replay per generation. Each kernel is short
// (1-5 MB of weights), so launch and ramp-up, not the byte rate, set most of
// its time. Left for later: overlapping kernels (programmatic dependent
// launch), a persistent single kernel, wgmma/TMA, and splitting attention
// rows across blocks (12 blocks per layer at GPT-2's 12 heads).
//
// Numerics (the JAX kernels' rounding points): LN output, q, k, v, the
// attention output, GELU output and every residual add round to the model
// dtype; matmul sums and biases stay fp32 until that cast; softmax in fp32.
// Quantized panes: scores are (q . codes) * k_scale * (1/sqrt(D)), and the
// probabilities times the V scales round to the model dtype before the PV
// product, as the JAX kernel's MXU inputs do. Quantize-on-write: scale =
// max(max|x| * (1/qmax), eps) with 1/qmax rounded to fp32, codes =
// clip(rint(x / scale)) with IEEE division; int4 bytes are 16*q[j] +
// q[j + E/2] + 8 (high nibble two's complement, low nibble biased).
//
// C interface (ctypes): both entry points take a MegaArgs (mirrored by
// ops/megakernel.py) and a stream, check the first error of each launch with
// cudaGetLastError() and return it (0 = success); elit_cuda_error_string
// names a code. dtype: 0 = float32, 1 = bfloat16. k_kind/v_kind: 0 = model
// dtype, 8 = int8, 4 = half-split int4. head_dim in {64, 128}; capacity up to
// 8192 (one head's scores, 32 KB, in shared memory without an opt-in).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Mirrored field by field by ops/megakernel.py's MegaArgs (ctypes).
struct MegaArgs {
  int dtype, n_layer, n_embd, n_head, vocab, n_pos, capacity;
  int k_kind, v_kind, advance, lm_blocks;
  float ln_eps, quant_eps;
  const void* attn_w;  // [L, 3E, E]
  const void* proj_w;  // [L, E, E]
  const void* fc_w;    // [L, 4E, E]
  const void* fcp_w;   // [L, E, 4E]
  const void* wte;     // [V, E], also the LM head
  const void* wpe;     // [P, E]
  const float* smalls; // [L, 13, E]
  const float* lnf;    // [2, E]
  void* k;             // [L, C, EK]
  void* v;             // [L, C, EV]
  float* ks;           // [L, C] (quantized panes)
  float* vs;
  int* length;         // [1]
  const int* tok_in;   // [1] or null
  const void* x_emb;   // [E] or null
  int* tok_out;        // [1]
  void* x;             // workspace: [E], [3E], [E], [4E] in the model dtype
  void* qkv;
  void* attn;
  void* ffn;
  float* lm_val;       // [lm_blocks]
  int* lm_idx;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Elements of T in one 16-byte load, and their unpacking to fp32.
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void unpack16(const uint4& u, float (&o)[4]) {
  o[0] = __uint_as_float(u.x); o[1] = __uint_as_float(u.y);
  o[2] = __uint_as_float(u.z); o[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&o)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little endian: the lower half comes first
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 r;  // read once per step: do not keep it in L1
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  return r;
}

// acc + the 16 bytes of weights in u . hv[0 : N), in order.
template <typename T>
__device__ __forceinline__ float dot16(const uint4& u, const float* hv, float acc) {
  float w[Vec<T>::N];
  unpack16(u, w);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) acc = fmaf(w[i], hv[i], acc);
  return acc;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum / max over the block; every thread gets the result. `red` holds kWarps
// floats of shared memory.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;
}
__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t = fmaxf(t, red[w]);
  return t;
}

// (value, index) argmax order: larger value first, then the lower index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// ---------------------------------------------------------------- embedding

template <typename T>
__global__ void __launch_bounds__(kThreads)
embed_kernel(const T* __restrict__ wte, const T* __restrict__ wpe, const int* __restrict__ tok_in,
             const T* __restrict__ x_emb, const int* __restrict__ length, int E, int V, int P,
             T* __restrict__ x) {
  if (tok_in == nullptr) {
    for (int e = threadIdx.x; e < E; e += kThreads) x[e] = x_emb[e];
    return;
  }
  const int tok = min(max(*tok_in, 0), V - 1);
  const int pos = min(max(*length, 0), P - 1);
  const T* we = wte + (size_t)tok * E;
  const T* pe = wpe + (size_t)pos * E;
  for (int e = threadIdx.x; e < E; e += kThreads)
    x[e] = from_f32<T>(to_f32(we[e]) + to_f32(pe[e]));
}

// -------------------------------------------------------------------- GEMV
//
// y[row] = sum_k in[k] * W[row, k] over rows of a row-major [N, K] weight.
// Prologue: PRO_LN puts LN(x) (rounded to T) in shared memory, PRO_VEC the
// input vector. KS warps split one row's K; a block covers kWarps / KS rows
// per pass and strides over row groups by the grid. The first pass's weights
// (up to kPrefetch<T> 16-byte chunks a lane: all of them at K = 768, KS = 1,
// or K = 3072, KS = 4) are requested before the prologue, so its latency
// overlaps the weight stream. Epilogues:
//   EPI_STORE     out[row] = T(y + b)
//   EPI_GELU      out[row] = T(gelu(y + b))
//   EPI_RESIDUAL  out[row] = T(out[row] + T(y + b))   (out is x, in place)
//   EPI_ARGMAX    per-block first (max, argmax) of y -> part_val/part_idx

enum { PRO_LN = 0, PRO_VEC = 1 };
template <typename T> constexpr int kPrefetch = 24 / Vec<T>::N;  // 3 in bf16, 6 in fp32
enum { EPI_STORE = 0, EPI_GELU = 1, EPI_RESIDUAL = 2, EPI_ARGMAX = 3 };

template <typename T>
__device__ void layer_norm_to_shared(const T* __restrict__ x, const float* __restrict__ g,
                                     const float* __restrict__ b, int E, float eps, float* h,
                                     float* red) {
  float s = 0.0f;
  for (int e = threadIdx.x; e < E; e += kThreads) {
    const float v = to_f32(x[e]);
    h[e] = v;
    s += v;
  }
  const float mean = block_sum(s, red) / (float)E;
  float s2 = 0.0f;
  for (int e = threadIdx.x; e < E; e += kThreads) {
    const float d = h[e] - mean;
    s2 += d * d;
  }
  const float r = rsqrtf(block_sum(s2, red) / (float)E + eps);
  for (int e = threadIdx.x; e < E; e += kThreads)
    h[e] = round_to<T>((h[e] - mean) * r * g[e] + b[e]);
}

__device__ __forceinline__ float gelu_tanh(float m) {
  return 0.5f * m * (1.0f + tanhf(0.7978845608028654f * (m + 0.044715f * (m * m * m))));
}

template <typename T, int PRO, int EPI, int KS>
__global__ void __launch_bounds__(kThreads)
gemv_kernel(const T* __restrict__ W, int N, int K, const T* __restrict__ in,
            const float* __restrict__ ln_g, const float* __restrict__ ln_b, float ln_eps,
            const float* __restrict__ bias, T* __restrict__ out, float* __restrict__ part_val,
            int* __restrict__ part_idx) {
  constexpr int RPB = kWarps / KS;  // rows per block and pass
  constexpr int VN = Vec<T>::N;
  extern __shared__ float h[];  // [K]
  __shared__ float red[kWarps];
  __shared__ float part[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = warp / KS, ks = warp % KS;
  const int n_chunks = K / VN;
  const int c0 = ks * n_chunks / KS, c1 = (ks + 1) * n_chunks / KS;

  uint4 pre[kPrefetch<T>];
  if (blockIdx.x * RPB + r < N) {
    const uint4* wr = reinterpret_cast<const uint4*>(W + (size_t)(blockIdx.x * RPB + r) * K);
#pragma unroll
    for (int i = 0; i < kPrefetch<T>; ++i)
      if (c0 + lane + 32 * i < c1) pre[i] = load_stream(wr + c0 + lane + 32 * i);
  }
  if (PRO == PRO_LN) {
    layer_norm_to_shared<T>(in, ln_g, ln_b, K, ln_eps, h, red);
  } else {
    for (int e = threadIdx.x; e < K; e += kThreads) h[e] = to_f32(in[e]);
  }
  __syncthreads();

  float best = -INFINITY;
  int best_idx = 0;
  for (int row0 = blockIdx.x * RPB; row0 < N; row0 += gridDim.x * RPB) {
    const int row = row0 + r;
    float acc = 0.0f;
    if (row < N) {
      const uint4* wr = reinterpret_cast<const uint4*>(W + (size_t)row * K);
      int c = c0 + lane;
      if (row0 == blockIdx.x * RPB) {  // the first pass: the prefetched chunks
#pragma unroll
        for (int i = 0; i < kPrefetch<T>; ++i, c += 32)
          if (c < c1) acc = dot16<T>(pre[i], h + c * VN, acc);
      }
#pragma unroll 4
      for (; c < c1; c += 32) acc = dot16<T>(load_stream(wr + c), h + c * VN, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) part[warp] = acc;
    __syncthreads();
    if (threadIdx.x < RPB && row0 + threadIdx.x < N) {
      const int o = row0 + threadIdx.x;
      float y = 0.0f;
#pragma unroll
      for (int j = 0; j < KS; ++j) y += part[threadIdx.x * KS + j];
      if (EPI == EPI_STORE) {
        out[o] = from_f32<T>(y + bias[o]);
      } else if (EPI == EPI_GELU) {
        out[o] = from_f32<T>(gelu_tanh(y + bias[o]));
      } else if (EPI == EPI_RESIDUAL) {
        out[o] = from_f32<T>(to_f32(out[o]) + round_to<T>(y + bias[o]));
      } else if (better(y, o, best, best_idx)) {
        best = y;
        best_idx = o;
      }
    }
    __syncthreads();  // part[] is rewritten by the next pass
  }
  if (EPI == EPI_ARGMAX) {
    __shared__ float bv[RPB];
    __shared__ int bi[RPB];
    if (threadIdx.x < RPB) {
      bv[threadIdx.x] = best;
      bi[threadIdx.x] = best_idx;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float v = bv[0];
      int i = bi[0];
      for (int t = 1; t < RPB; ++t)
        if (better(bv[t], bi[t], v, i)) { v = bv[t]; i = bi[t]; }
      part_val[blockIdx.x] = v;
      part_idx[blockIdx.x] = i;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
argmax_kernel(const float* __restrict__ part_val, const int* __restrict__ part_idx, int n,
              int V, int advance, int* __restrict__ tok_out, int* __restrict__ length) {
  __shared__ float sv[kWarps];
  __shared__ int si[kWarps];
  float v = -INFINITY;
  int i = 0;
  for (int t = threadIdx.x; t < n; t += kThreads)
    if (better(part_val[t], part_idx[t], v, i)) { v = part_val[t]; i = part_idx[t]; }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) { sv[warp] = v; si[warp] = i; }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w)
      if (better(sv[w], si[w], v, i)) { v = sv[w]; i = si[w]; }
    if (advance) {
      i = min(max(i, 0), V - 1);
      *length += 1;
    }
    *tok_out = i;
  }
}

// --------------------------------------------------------------- attention
//
// KIND 0: pane rows of E values in T; 8: int8 codes; 4: half-split int4, a
// row of E/2 bytes where byte j holds lane j (high nibble) and lane j + E/2
// (low nibble). A head lies in one half (checked by the host: (E/2) % D == 0).

template <typename T, int KIND>
struct Pane {
  const void* base;
  int E;
  // Lane-values [d0, d0 + n) of head h in row c, as fp32 (codes unscaled).
  template <int NV>
  __device__ __forceinline__ void load(int c, int h, int D, int d0, float (&o)[NV]) const {
    const int e0 = h * D + d0;
    if constexpr (KIND == 0) {
      const T* p = static_cast<const T*>(base) + (size_t)c * E + e0;
      if constexpr (NV == 8) {  // 8 aligned values: one or two 16-byte loads
        const uint4* p4 = reinterpret_cast<const uint4*>(p);
        if constexpr (sizeof(T) == 2) {
          unpack16(p4[0], o);
        } else {
          float a[4], b[4];
          unpack16(p4[0], a);
          unpack16(p4[1], b);
#pragma unroll
          for (int i = 0; i < 4; ++i) { o[i] = a[i]; o[i + 4] = b[i]; }
        }
      } else {
#pragma unroll
        for (int i = 0; i < NV; ++i) o[i] = to_f32(p[i]);
      }
    } else {
      const int half = E / 2;
      const bool hi = KIND == 4 && e0 < half;
      const int8_t* p = static_cast<const int8_t*>(base) +
                        (KIND == 8 ? (size_t)c * E + e0
                                   : (size_t)c * half + (e0 < half ? e0 : e0 - half));
      auto value = [hi](int byte) {  // byte: the stored int8, sign-extended
        return (float)(KIND == 8 ? byte : (hi ? (byte >> 4) : ((byte & 15) - 8)));
      };
      if constexpr (NV == 8) {  // 8 aligned bytes: one load
        const uint2 w = *reinterpret_cast<const uint2*>(p);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i] = value((int8_t)(w.x >> (8 * i)));
          o[i + 4] = value((int8_t)(w.y >> (8 * i)));
        }
      } else {
#pragma unroll
        for (int i = 0; i < NV; ++i) o[i] = value(p[i]);
      }
    }
  }
};

// Quantize-on-write of one token's row x [E] (block-wide), or a plain copy.
template <typename T, int KIND>
__device__ void write_row(const T* __restrict__ x, void* pane, float* scales, int row, int E,
                          float eps, float* red) {
  if constexpr (KIND == 0) {
    T* dst = static_cast<T*>(pane) + (size_t)row * E;
    for (int e = threadIdx.x; e < E; e += kThreads) dst[e] = x[e];
  } else {
    float m = 0.0f;
    for (int e = threadIdx.x; e < E; e += kThreads) m = fmaxf(m, fabsf(to_f32(x[e])));
    m = block_max(m, red);
    constexpr float inv_qmax = KIND == 8 ? 1.0f / 127.0f : 1.0f / 7.0f;
    const float s = fmaxf(m * inv_qmax, eps);
    if constexpr (KIND == 8) {
      int8_t* dst = static_cast<int8_t*>(pane) + (size_t)row * E;
      for (int e = threadIdx.x; e < E; e += kThreads)
        dst[e] = (int8_t)fminf(fmaxf(rintf(to_f32(x[e]) / s), -127.0f), 127.0f);
    } else {
      const int half = E / 2;
      int8_t* dst = static_cast<int8_t*>(pane) + (size_t)row * half;
      for (int j = threadIdx.x; j < half; j += kThreads) {
        const int hi = (int)fminf(fmaxf(rintf(to_f32(x[j]) / s), -8.0f), 7.0f);
        const int lo = (int)fminf(fmaxf(rintf(to_f32(x[j + half]) / s), -8.0f), 7.0f);
        dst[j] = (int8_t)(16 * hi + lo + 8);
      }
    }
    if (threadIdx.x == 0) scales[row] = s;
  }
}

// Blocks 0..H-1: attention of head blockIdx.x. Block H: writes row `length`.
// Phase 1: scores of the visible rows into shared memory, D/8 lanes per row
// (8 dims each, one shuffle tree). Phase 2: max, exp, sum. Phase 3: PV in
// the same lane layout, summed over the warp's row slots by shuffles and
// over the warps through shared memory; the current token (from qkv) enters
// the same softmax.
template <typename T, int KK, int VK, int D>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ qkv, void* kp, void* vp, float* ks, float* vs,
                 const int* __restrict__ length, int C, int E, int H, float sm_scale,
                 float quant_eps, T* __restrict__ out) {
  constexpr int LPR = D / 8;        // lanes per row in phase 1
  constexpr int RPW = 32 / LPR;     // rows per warp and pass
  constexpr int DPT = D / 32;       // dims per lane of the current token's score
  constexpr bool QUANT = KK != 0;
  extern __shared__ float sc[];     // [C] scores, then weights
  __shared__ float red[kWarps];
  __shared__ float pv[kWarps][D];
  __shared__ float s_cur_sh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int raw_len = *length;
  const int len = min(max(raw_len, 0), C);
  const T* q = qkv;
  const T* kc = qkv + E;
  const T* vc = qkv + 2 * E;

  if (blockIdx.x == H) {  // the new row of this layer (never read by this step)
    if (raw_len >= 0 && raw_len < C) {
      write_row<T, KK>(kc, kp, ks, raw_len, E, quant_eps, red);
      write_row<T, VK>(vc, vp, vs, raw_len, E, quant_eps, red);
    }
    return;
  }
  const int h = blockIdx.x;
  const Pane<T, KK> kpane{kp, E};
  const Pane<T, VK> vpane{vp, E};

  // phase 1: scores
  const int g = lane / LPR, d0 = (lane % LPR) * 8;
  float u[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) u[i] = to_f32(q[h * D + d0 + i]);
  for (int c0 = warp * RPW; c0 < len; c0 += kWarps * RPW) {
    const int c = c0 + g;
    float kv[8];
    kpane.template load<8>(min(c, len - 1), h, D, d0, kv);
    float dot = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) dot = fmaf(u[i], kv[i], dot);
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (lane % LPR == 0 && c < len) sc[c] = QUANT ? dot * ks[c] * sm_scale : dot * sm_scale;
  }
  if (warp == 0) {  // the current token, full precision
    float dot = 0.0f;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int e = h * D + lane * DPT + i;
      dot = fmaf(to_f32(q[e]), to_f32(kc[e]), dot);
    }
    dot = warp_sum(dot);
    if (lane == 0) s_cur_sh = dot * sm_scale;
  }
  __syncthreads();

  // phase 2: softmax statistics
  const float s_cur = s_cur_sh;
  float m = -INFINITY;
  for (int c = threadIdx.x; c < len; c += kThreads) m = fmaxf(m, sc[c]);
  const float mx = fmaxf(block_max(m, red), s_cur);
  float l = 0.0f;
  for (int c = threadIdx.x; c < len; c += kThreads) {
    const float p = expf(sc[c] - mx);
    l += p;
    sc[c] = QUANT ? round_to<T>(p * vs[c]) : p;
  }
  const float p_cur = expf(s_cur - mx);
  const float denom = block_sum(l, red) + p_cur;  // syncs: sc[] is complete

  // phase 3: PV
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
#pragma unroll 2
  for (int c0 = warp * RPW; c0 < len; c0 += kWarps * RPW) {
    const int c = c0 + g;
    float vv[8];
    vpane.template load<8>(min(c, len - 1), h, D, d0, vv);
    const float w = c < len ? sc[c] : 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = fmaf(w, vv[i], acc[i]);
  }
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
  }
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) pv[warp][d0 + i] = acc[i];
  }
  __syncthreads();
  if (threadIdx.x < D) {
    const int d = threadIdx.x;
    float num = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) num += pv[w][d];
    num += p_cur * to_f32(vc[h * D + d]);
    out[h * D + d] = from_f32<T>(num / denom);
  }
}

// ------------------------------------------------------------------- host

int cdiv(int a, int b) { return (a + b - 1) / b; }

#define LAUNCH_CHECK()                          \
  do {                                          \
    const cudaError_t e_ = cudaGetLastError();  \
    if (e_ != cudaSuccess) return (int)e_;      \
  } while (0)

template <typename T, int KK, int VK>
int launch_attention(const MegaArgs& a, int layer, cudaStream_t st) {
  const int E = a.n_embd, C = a.capacity, H = a.n_head, D = E / H;
  const size_t kw = KK == 0 ? sizeof(T) * E : (KK == 8 ? E : E / 2);
  const size_t vw = VK == 0 ? sizeof(T) * E : (VK == 8 ? E : E / 2);
  char* kl = static_cast<char*>(a.k) + (size_t)layer * C * kw;
  char* vl = static_cast<char*>(a.v) + (size_t)layer * C * vw;
  float* ksl = a.ks ? a.ks + (size_t)layer * C : nullptr;
  float* vsl = a.vs ? a.vs + (size_t)layer * C : nullptr;
  const float sm_scale = 1.0f / sqrtf((float)D);
  const size_t smem = sizeof(float) * C;
  T* qkv = static_cast<T*>(a.qkv);
  T* out = static_cast<T*>(a.attn);
  if (D == 64)
    attention_kernel<T, KK, VK, 64><<<H + 1, kThreads, smem, st>>>(
        qkv, kl, vl, ksl, vsl, a.length, C, E, H, sm_scale, a.quant_eps, out);
  else if (D == 128)
    attention_kernel<T, KK, VK, 128><<<H + 1, kThreads, smem, st>>>(
        qkv, kl, vl, ksl, vsl, a.length, C, E, H, sm_scale, a.quant_eps, out);
  else
    return (int)cudaErrorInvalidValue;
  LAUNCH_CHECK();
  return 0;
}

template <typename T>
int attention(const MegaArgs& a, int layer, cudaStream_t st) {
  const int kk = a.k_kind, vk = a.v_kind;
  if (kk == 0 && vk == 0) return launch_attention<T, 0, 0>(a, layer, st);
  if (kk == 8 && vk == 8) return launch_attention<T, 8, 8>(a, layer, st);
  if (kk == 4 && vk == 4) return launch_attention<T, 4, 4>(a, layer, st);
  if (kk == 8 && vk == 4) return launch_attention<T, 8, 4>(a, layer, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int run_step(const MegaArgs& a, cudaStream_t st) {
  const int L = a.n_layer, E = a.n_embd, V = a.vocab;
  const size_t E_ = E;
  const T* attn_w = static_cast<const T*>(a.attn_w);
  const T* proj_w = static_cast<const T*>(a.proj_w);
  const T* fc_w = static_cast<const T*>(a.fc_w);
  const T* fcp_w = static_cast<const T*>(a.fcp_w);
  const T* wte = static_cast<const T*>(a.wte);
  T* x = static_cast<T*>(a.x);
  T* qkv = static_cast<T*>(a.qkv);
  T* attn = static_cast<T*>(a.attn);
  T* ffn = static_cast<T*>(a.ffn);
  const size_t h1 = sizeof(float) * E, h4 = sizeof(float) * 4 * E;

  embed_kernel<T><<<1, kThreads, 0, st>>>(wte, static_cast<const T*>(a.wpe), a.tok_in,
                                          static_cast<const T*>(a.x_emb), a.length, E, V,
                                          a.n_pos, x);
  LAUNCH_CHECK();
  for (int l = 0; l < L; ++l) {
    const float* sm = a.smalls + (size_t)l * 13 * E;
    gemv_kernel<T, PRO_LN, EPI_STORE, 1><<<cdiv(3 * E, kWarps), kThreads, h1, st>>>(
        attn_w + l * 3 * E_ * E, 3 * E, E, x, sm, sm + E, a.ln_eps, sm + 4 * E, qkv, nullptr,
        nullptr);
    LAUNCH_CHECK();
    const int rc = attention<T>(a, l, st);
    if (rc) return rc;
    gemv_kernel<T, PRO_VEC, EPI_RESIDUAL, 2><<<cdiv(E, kWarps / 2), kThreads, h1, st>>>(
        proj_w + l * E_ * E, E, E, attn, nullptr, nullptr, 0.0f, sm + 7 * E, x, nullptr,
        nullptr);
    LAUNCH_CHECK();
    gemv_kernel<T, PRO_LN, EPI_GELU, 1><<<cdiv(4 * E, kWarps), kThreads, h1, st>>>(
        fc_w + l * 4 * E_ * E, 4 * E, E, x, sm + 2 * E, sm + 3 * E, a.ln_eps, sm + 8 * E, ffn,
        nullptr, nullptr);
    LAUNCH_CHECK();
    gemv_kernel<T, PRO_VEC, EPI_RESIDUAL, 4><<<cdiv(E, kWarps / 4), kThreads, h4, st>>>(
        fcp_w + l * 4 * E_ * E, E, 4 * E, ffn, nullptr, nullptr, 0.0f, sm + 12 * E, x, nullptr,
        nullptr);
    LAUNCH_CHECK();
  }
  gemv_kernel<T, PRO_LN, EPI_ARGMAX, 1><<<a.lm_blocks, kThreads, h1, st>>>(
      wte, V, E, x, a.lnf, a.lnf + E, a.ln_eps, nullptr, nullptr, a.lm_val, a.lm_idx);
  LAUNCH_CHECK();
  argmax_kernel<<<1, kThreads, 0, st>>>(a.lm_val, a.lm_idx, a.lm_blocks, V, a.advance,
                                        a.tok_out, a.length);
  LAUNCH_CHECK();
  return 0;
}

int run(const MegaArgs* a, void* stream, bool quant) {
  if (a == nullptr) return (int)cudaErrorInvalidValue;
  const bool q = a->k_kind != 0 || a->v_kind != 0;
  const int E = a->n_embd, H = a->n_head;
  const bool int4 = a->k_kind == 4 || a->v_kind == 4;
  if (q != quant || H <= 0 || E % H || E % 128 || a->capacity <= 0 ||
      a->capacity > 8192 || a->lm_blocks <= 0 || (q && (!a->ks || !a->vs)) ||
      (int4 && (E / 2) % (E / H)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->dtype == 0) return run_step<float>(*a, st);
  if (a->dtype == 1) return run_step<__nv_bfloat16>(*a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int elit_gpt2_megastep(const MegaArgs* a, void* stream) {
  return run(a, stream, false);
}

extern "C" int elit_gpt2_megastep_quant(const MegaArgs* a, void* stream) {
  return run(a, stream, true);
}

extern "C" const char* elit_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
