// Device code shared by the whole-step decode chains (gpt2_megastep.cu,
// llama_megastep.cu, and the batched and verify chains of megabatch.cu,
// megaverify.cu and megabatch_verify.cu, draft_burst.cu): conversions,
// 16-byte weight streaming, block reductions, the GEMVs' prologue, epilogue
// and weight-tier kinds and their norm and activation arithmetic (the tiers'
// chunk decode is weight_tier.cuh's), decode attention over fp / int8 /
// half-split int4 panes with quantize-on-write, the final argmax, and the
// slot strides of batched [L, B, C, W] panes. Each including source gets its
// own copy (anonymous namespace); the host sides stay in the sources.
//
// Numerics (the JAX kernels' rounding points): the norm output, q, k, v, the
// attention output, the activation output and every residual add round to the
// model dtype T; matmul sums and biases stay fp32 until that cast; softmax in
// fp32. Quantized panes: scores are (q . codes) * k_scale * (1/sqrt(D)), and
// the probabilities times the V scales round to T before the PV product, as
// the JAX kernel's MXU inputs do. Quantize-on-write: scale =
// max(max|x| * (1/qmax), eps) with 1/qmax rounded to fp32, codes =
// clip(rint(x / scale)) with IEEE division; int4 bytes are 16*q[j] +
// q[j + W/2] + 8 (high nibble two's complement, low nibble biased).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "weight_tier.cuh"

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

// A value of T as fp32, loaded through ld.global.cg (L2 only): for data that
// another block of the same launch wrote (L1 is not coherent).
__device__ __forceinline__ float ldcg_f32(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldcg_f32(const __nv_bfloat16* p) {
  return __uint_as_float((unsigned)__ldcg(reinterpret_cast<const unsigned short*>(p)) << 16);
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

// ------------------------------------------------------------ GEMV kinds
//
// y[row] = sum_k in[k] * W[row, k] over rows of a row-major [N, K] weight,
// as the chains' GEMVs compute it (gemv_stream.cuh, gemv_batch.cuh,
// gemv_stream_tc.cuh, gemm_rows_tc.cuh, draft_burst.cu, and the persistent
// GPT-2 step's tiles). Prologue: PRO_LN LayerNorm(x) with fp32 statistics,
// rounded to T; PRO_RMS RMSNorm(x) (the normalised value rounded to T before
// the gain, the product rounded again); PRO_VEC the input vector. Epilogues
// (`bias` may be null: no bias):
//   EPI_STORE     out[row] = T(y + b)
//   EPI_GELU      out[row] = T(gelu(y + b))
//   EPI_RESIDUAL  out[row] = T(out[row] + T(y + b))   (out is x, in place)
//   EPI_ARGMAX    per-block first (max, argmax) of y -> part_val/part_idx
//   EPI_SWIGLU    rows come in (gate, up) pairs 2j, 2j + 1:
//                 out[j] = T(T(silu(y_gate)) * T(y_up)), silu in fp32
//
// Weight tiers (WK; replaces the JAX kernels' "wscale" / "w4scale" modes,
// ops/pallas/megakernel.py:474-490, megakernel_llama.py:148-217; the chunk
// decode is weight_tier.cuh's):
//   W_T   values of the model dtype T, Vec<T>::N a 16-byte chunk;
//   W_I8  int8 codes, 16 a chunk, one fp32 scale a row (`ws` [N]):
//         y = (sum_k in[k] q[row, k]) * ws[row], the fp32 sum scaled before
//         the bias, the epilogue and the argmax compare (JAX: y * wscale,
//         then + bias);
//   W_I4  int4 codes, 32 a chunk in the model's own nibble order, read in
//         place, no shuffle. One scale a row and group of `group` inputs,
//         in T (`ws` [N, K/G]; the JAX packer rounds the scales to the
//         model dtype):
//         y = sum over chunks of (sum_k in[k] v[row, k]) * ws[row, k / G],
//         fp32 sums; G % 32 == 0 keeps a chunk in one group. This is the
//         JAX kernel's int4w8 form (raw nibble dots, the fp32 sums scaled)
//         at every G; its grouped form, which rounds each v * s to T before
//         the dot, is not kept (a multiply and a rounding a weight more).

enum { PRO_LN = 0, PRO_VEC = 1, PRO_RMS = 2 };
enum { EPI_STORE = 0, EPI_GELU = 1, EPI_RESIDUAL = 2, EPI_ARGMAX = 3, EPI_SWIGLU = 4 };

// Inputs a 16-byte chunk of weights covers.
template <typename T, int WK> struct WTier : QTier<WK> {};
template <typename T> struct WTier<T, W_T> { static constexpr int N = Vec<T>::N; };

__device__ __forceinline__ float gelu_tanh(float m) {
  return 0.5f * m * (1.0f + tanhf(0.7978845608028654f * (m + 0.044715f * (m * m * m))));
}

__device__ __forceinline__ float silu(float g) { return g * (1.0f / (1.0f + expf(-g))); }

// Bytes of one row of a [N, K] weight of tier `wk` in the model dtype T.
template <typename T>
__host__ __device__ __forceinline__ size_t weight_row_bytes(int wk, int K) {
  return wk == W_T ? (size_t)K * sizeof(T) : (wk == W_I8 ? (size_t)K : (size_t)K / 2);
}

// The first maximum over n per-block (max, argmax) partials -> *tok_out; with
// `advance`, the token is clamped to [0, V-1] and *length incremented. The
// partials are read through ld.global.cg (other blocks of a persistent
// launch write them).
__device__ void argmax_block(const float* __restrict__ part_val, const int* __restrict__ part_idx,
                             int n, int V, int advance, int* __restrict__ tok_out,
                             int* __restrict__ length) {
  __shared__ float sv[kWarps];
  __shared__ int si[kWarps];
  float v = -INFINITY;
  int i = 0;
  for (int t = threadIdx.x; t < n; t += kThreads) {
    const float pv_ = __ldcg(part_val + t);
    const int pi_ = __ldcg(part_idx + t);
    if (better(pv_, pi_, v, i)) { v = pv_; i = pi_; }
  }
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
// KIND 0: pane rows of W values in T; 8: int8 codes; 4: half-split int4, a
// row of W/2 bytes where byte j holds lane j (high nibble) and lane j + W/2
// (low nibble). A head lies in one half (checked by the host: (W/2) % D == 0).

template <typename T, int KIND>
struct Pane {
  const void* base;
  int W;
  // The bytes of 8 aligned lane-values as loaded: one or two 16-byte loads
  // of T, or 8 bytes of codes (in u[0].x, u[0].y).
  struct Raw {
    uint4 u[KIND == 0 ? (int)sizeof(T) / 2 : 1];
  };
  // Lane-values [d0, d0 + 8) of head h in row c, as loaded (raw) and as
  // fp32 (decode; codes unscaled): load<8> in two halves, so that a caller
  // can issue several rows' loads before it uses any.
  __device__ __forceinline__ Raw raw(int c, int h, int D, int d0) const {
    const int e0 = h * D + d0;
    Raw r;
    if constexpr (KIND == 0) {
      const uint4* p4 =
          reinterpret_cast<const uint4*>(static_cast<const T*>(base) + (size_t)c * W + e0);
#pragma unroll
      for (int i = 0; i < (int)sizeof(T) / 2; ++i) r.u[i] = p4[i];
    } else {
      const int half = W / 2;
      const int8_t* p = static_cast<const int8_t*>(base) +
                        (KIND == 8 ? (size_t)c * W + e0
                                   : (size_t)c * half + (e0 < half ? e0 : e0 - half));
      const uint2 w = *reinterpret_cast<const uint2*>(p);
      r.u[0] = make_uint4(w.x, w.y, 0u, 0u);
    }
    return r;
  }
  __device__ __forceinline__ void decode(const Raw& r, int h, int D, int d0,
                                         float (&o)[8]) const {
    if constexpr (KIND == 0) {
      if constexpr (sizeof(T) == 2) {
        unpack16(r.u[0], o);
      } else {
        float a[4], b[4];
        unpack16(r.u[0], a);
        unpack16(r.u[1], b);
#pragma unroll
        for (int i = 0; i < 4; ++i) { o[i] = a[i]; o[i + 4] = b[i]; }
      }
    } else {
      const bool hi = KIND == 4 && h * D + d0 < W / 2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[i] = value((int8_t)(r.u[0].x >> (8 * i)), hi);
        o[i + 4] = value((int8_t)(r.u[0].y >> (8 * i)), hi);
      }
    }
  }
  // Lane-values [d0, d0 + n) of head h in row c, as fp32 (codes unscaled).
  template <int NV>
  __device__ __forceinline__ void load(int c, int h, int D, int d0, float (&o)[NV]) const {
    if constexpr (NV == 8) {
      decode(raw(c, h, D, d0), h, D, d0, o);
    } else if constexpr (KIND == 0) {
      const T* p = static_cast<const T*>(base) + (size_t)c * W + h * D + d0;
#pragma unroll
      for (int i = 0; i < NV; ++i) o[i] = to_f32(p[i]);
    } else {
      const int e0 = h * D + d0, half = W / 2;
      const int8_t* p = static_cast<const int8_t*>(base) +
                        (KIND == 8 ? (size_t)c * W + e0
                                   : (size_t)c * half + (e0 < half ? e0 : e0 - half));
#pragma unroll
      for (int i = 0; i < NV; ++i) o[i] = value(p[i], KIND == 4 && e0 < half);
    }
  }
  // A code's value (byte: the stored int8, sign-extended; hi: the high nibble).
  __device__ __forceinline__ static float value(int byte, bool hi) {
    return (float)(KIND == 8 ? byte : (hi ? (byte >> 4) : ((byte & 15) - 8)));
  }
};

// Quantize-on-write of one token's row x [W] (block-wide), or a plain copy.
// x holds values of T (as T, or as fp32 already rounded to T). x is not
// __restrict__: in the draft burst it is q|k|v, which other blocks of the
// launch rewrite every layer, and a restricted const pointer lets the
// compiler read it through the non-coherent (read-only) cache.
template <typename T, int KIND, typename S>
__device__ void write_row(const S* x, void* pane, float* scales, int row, int W,
                          float eps, float* red) {
  if constexpr (KIND == 0) {
    T* dst = static_cast<T*>(pane) + (size_t)row * W;
    for (int e = threadIdx.x; e < W; e += kThreads) dst[e] = from_f32<T>(to_f32(x[e]));
  } else {
    float m = 0.0f;
    for (int e = threadIdx.x; e < W; e += kThreads) m = fmaxf(m, fabsf(to_f32(x[e])));
    m = block_max(m, red);
    constexpr float inv_qmax = KIND == 8 ? 1.0f / 127.0f : 1.0f / 7.0f;
    const float s = fmaxf(m * inv_qmax, eps);
    if constexpr (KIND == 8) {
      int8_t* dst = static_cast<int8_t*>(pane) + (size_t)row * W;
      for (int e = threadIdx.x; e < W; e += kThreads)
        dst[e] = (int8_t)fminf(fmaxf(rintf(to_f32(x[e]) / s), -127.0f), 127.0f);
    } else {
      const int half = W / 2;
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

// Value d of one head's vector (D values of T): as stored, or, with RoPE
// tables (cs/sn: the position's cos/sin rows, fp32 [D]), rotate-half RoPE of
// the stored value computed in fp32 without fused multiply-adds and rounded
// to T: x[d] cos[d] + r[d] sin[d], r = (-x[d + D/2], x[d - D/2]). Loaded
// through ld.global.cg: in the draft burst and the persistent steps another
// block of the same launch wrote the vector.
template <typename T>
__device__ __forceinline__ float head_value(const T* head, int d, int D, const float* cs,
                                            const float* sn) {
  const float a = ldcg_f32(head + d);
  if (cs == nullptr) return a;
  const int half = D / 2;
  const float r = d < half ? -ldcg_f32(head + d + half) : ldcg_f32(head + d - half);
  return round_to<T>(__fadd_rn(__fmul_rn(a, cs[d]), __fmul_rn(r, sn[d])));
}

// One layer's decode attention. The current token's q | k | v is `qkv`
// ([QW + 2 KW] in T, QW = n_head * D, KW = (n_head / group) * D): query head
// h reads K/V head h / group (grouped-query attention; group 1 is multi-head
// attention). With RoPE tables, q and k are rotated at position
// min(length, n_pos - 1) as they are read.
struct AttnParams {
  const void* qkv;
  void* k;             // this layer's panes: [C, KW] in T, int8 [C, KW], or int4 [C, KW/2]
  void* v;
  float* ks;           // this layer's per-token scales [C] (quantized panes)
  float* vs;
  const int* length;   // [1]: rows t < length are visible; row `length` is written
  const float* cos;    // [n_pos, D] fp32 RoPE tables, or null (no RoPE)
  const float* sin;
  int n_pos, capacity, n_head, q_width, kv_width, group;
  float sm_scale, quant_eps;
  void* out;           // [QW] in T
};

// Blocks 0..H-1: attention of query head `block`. Block H: writes row
// `length` of the layer's panes (never read by this step; with RoPE it first
// rotates the whole k row into shared memory). Phase 1: scores of the visible
// rows into shared memory, D/8 lanes per row (8 dims each, one shuffle
// tree). Phase 2: max, exp, sum. Phase 3: PV in the same lane layout, summed
// over the warp's row slots by shuffles and over the warps through shared
// memory; the current token (from qkv) enters the same softmax.
template <typename T, int KK, int VK, int D>
__device__ __forceinline__ void attention_block(const AttnParams& p, const int block) {
  constexpr int LPR = D / 8;        // lanes per row in phase 1
  constexpr int RPW = 32 / LPR;     // rows per warp and pass
  constexpr int DPT = D / 32;       // dims per lane of the current token's score
  constexpr bool QUANT = KK != 0;
  extern __shared__ float sc[];     // [C] scores, then weights (writer: [KW] roped k)
  __shared__ float red[kWarps];
  __shared__ float pv[kWarps][D];
  __shared__ float s_cur_sh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = p.capacity, KW = p.kv_width;
  const int raw_len = *p.length;
  const int len = min(max(raw_len, 0), C);
  const T* q = static_cast<const T*>(p.qkv);
  const T* kc = q + p.q_width;
  const T* vc = kc + KW;
  const float* cs = nullptr;
  const float* sn = nullptr;
  if (p.cos != nullptr) {
    const int pos = min(max(raw_len, 0), p.n_pos - 1);
    cs = p.cos + (size_t)pos * D;
    sn = p.sin + (size_t)pos * D;
  }

  if (block == p.n_head) {  // the new row of this layer
    if (raw_len >= 0 && raw_len < C) {
      if (cs != nullptr) {
        for (int e = threadIdx.x; e < KW; e += kThreads)
          sc[e] = head_value<T>(kc + (e / D) * D, e % D, D, cs, sn);
        __syncthreads();
        write_row<T, KK>(sc, p.k, p.ks, raw_len, KW, p.quant_eps, red);
      } else {
        write_row<T, KK>(kc, p.k, p.ks, raw_len, KW, p.quant_eps, red);
      }
      write_row<T, VK>(vc, p.v, p.vs, raw_len, KW, p.quant_eps, red);
    }
    return;
  }
  const int h = block, hk = h / p.group;
  const T* qh = q + h * D;
  const T* kh = kc + hk * D;
  const Pane<T, KK> kpane{p.k, KW};
  const Pane<T, VK> vpane{p.v, KW};
  const float* ks = p.ks;
  const float* vs = p.vs;

  // phase 1: scores
  const int g = lane / LPR, d0 = (lane % LPR) * 8;
  float u[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) u[i] = head_value<T>(qh, d0 + i, D, cs, sn);
  for (int c0 = warp * RPW; c0 < len; c0 += kWarps * RPW) {
    const int c = c0 + g;
    float kv[8];
    kpane.template load<8>(min(c, len - 1), hk, D, d0, kv);
    float dot = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) dot = fmaf(u[i], kv[i], dot);
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (lane % LPR == 0 && c < len) sc[c] = QUANT ? dot * ks[c] * p.sm_scale : dot * p.sm_scale;
  }
  if (warp == 0) {  // the current token, full precision
    float dot = 0.0f;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = lane * DPT + i;
      dot = fmaf(head_value<T>(qh, d, D, cs, sn), head_value<T>(kh, d, D, cs, sn), dot);
    }
    dot = warp_sum(dot);
    if (lane == 0) s_cur_sh = dot * p.sm_scale;
  }
  __syncthreads();

  // phase 2: softmax statistics
  const float s_cur = s_cur_sh;
  float m = -INFINITY;
  for (int c = threadIdx.x; c < len; c += kThreads) m = fmaxf(m, sc[c]);
  const float mx = fmaxf(block_max(m, red), s_cur);
  float l = 0.0f;
  for (int c = threadIdx.x; c < len; c += kThreads) {
    const float pr = expf(sc[c] - mx);
    l += pr;
    sc[c] = QUANT ? round_to<T>(pr * vs[c]) : pr;
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
    vpane.template load<8>(min(c, len - 1), hk, D, d0, vv);
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
    num += p_cur * ldcg_f32(vc + hk * D + d);
    static_cast<T*>(p.out)[h * D + d] = from_f32<T>(num / denom);
  }
}

// ------------------------------------------------------------------- host

int cdiv(int a, int b) { return (a + b - 1) / b; }

// Kernels this source's launch helpers have launched: launch_pdl and
// gemv_batch add one at each launch that succeeds, so a source that
// exports the count (elit_megaverify_kernels) counts its chains' launches
// where they happen.
inline long long& launches_made() {
  static long long n = 0;
  return n;
}

#define LAUNCH_CHECK()                          \
  do {                                          \
    const cudaError_t e_ = cudaGetLastError();  \
    if (e_ != cudaSuccess) return (int)e_;      \
  } while (0)

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// One weight of a step: its rows from row `row0` on, in tier `kind` (W_T,
// W_I8, W_I4) with its scales (null for W_T) and int4 group.
struct WeightRef {
  const void* w;
  const void* s;
  int kind, group;
};

// Rows [row0, ...) of a [*, K] weight that starts at w (scales at s).
template <typename T>
WeightRef weight_at(const void* w, const void* s, int kind, int group, size_t row0, int K) {
  const size_t sb = kind == W_I8 ? sizeof(float)
                                 : (kind == W_I4 ? (size_t)(K / group) * sizeof(T) : 0);
  return {static_cast<const char*>(w) + row0 * weight_row_bytes<T>(kind, K),
          s ? static_cast<const char*>(s) + row0 * sb : nullptr, kind, group};
}

// Byte offset of layer `layer` in a [L, C, W] pane of storage `kind`.
__host__ __device__ inline size_t pane_offset(int kind, size_t item, int layer, int C, int W) {
  const size_t row = kind == 0 ? item * W : (kind == 8 ? W : W / 2);
  return (size_t)layer * C * row;
}

// ------------------------------------------------ batched [L, B, C, W] panes

// What separates slot b from slot 0 in one layer's tensors.
struct SlotStrides {
  size_t k_bytes, v_bytes;  // one slot's [C, W] pane
  int qkv, out, scales;     // elements of q|k|v, of the output, of a scale row (C)
};

// Layer l's attention parameters over [L, B, C, W] panes and [L, B, C] scales.
template <typename T>
void layer_panes(AttnParams& p, SlotStrides& s, void* k, void* v, float* ks, float* vs,
                 int k_kind, int v_kind, int l, int B, int C, int W) {
  p.k = static_cast<char*>(k) + pane_offset(k_kind, sizeof(T), l, B * C, W);
  p.v = static_cast<char*>(v) + pane_offset(v_kind, sizeof(T), l, B * C, W);
  p.ks = ks ? ks + (size_t)l * B * C : nullptr;
  p.vs = vs ? vs + (size_t)l * B * C : nullptr;
  s.k_bytes = pane_offset(k_kind, sizeof(T), 1, C, W);
  s.v_bytes = pane_offset(v_kind, sizeof(T), 1, C, W);
  s.scales = C;
}

}  // namespace
