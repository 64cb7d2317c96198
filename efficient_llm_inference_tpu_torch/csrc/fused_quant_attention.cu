// Fused decode attention over a quantized KV cache, with a small
// full-precision "extra" region merged into the same softmax.
//
// Replaces efficient_llm_inference_tpu/ops/pallas/attention.py:
// fused_quant_attention_batched (the Pallas kernel behind QuantizedKV's
// decode step) and, through a second entry point, fused_quant_attention_decode
// (its batch-1 form: one slot, the current token as the one extra row, which
// is always visible; elit_fused_quant_attention_decode). The TPU's batch-1
// kernel works in deinterleaved D order for int4 (a Mosaic limit) and
// permutes q and the current token to match; this kernel reads both forms in
// natural order. For each (slot b, query head hq), with kv head hk = hq / G:
//
//   s_c = (q . k_c) * ks_c / sqrt(D)       past rows c < lengths[b]
//   s_j = (q . ke_j) / sqrt(D)             extra rows j < n_extra
//   out = (sum_c e^{s_c} vs_c v_c + sum_j e^{s_j} ve_j) / (sum e^{s})
//
// K/V past rows are int8 codes, int4 codes packed two per byte (even element
// in the high nibble, offset +8), or raw fp in the query's type ("16" bits);
// the scales are per row (one float per token, or per (head, token)).
//
// A slot with no visible row (lengths[b] == 0 and n_extra == 0) follows the
// JAX kernel: every score is masked to the same value, so the softmax is
// uniform over all C stored rows and all S extra rows, and the output is
// their plain average (V scales applied).
//
// Bound: bytes. One decode step reads every visible K/V row once and does
// ~4 operations per byte read, far below the ~300 per byte at which the
// H100's compute would limit it. So the kernel reads the codes at their
// compressed size and never writes a dequantized copy: the nibbles are
// unpacked and the scales applied in registers (to the score and to the
// probability that weights the V row), and the softmax is online in fp32.
//
// Design: one block of 8 warps per (query head, slot). A warp takes 4 rows at
// a time (all loads issued before the reductions), each lane holding D/32
// contiguous dimensions of q and of its accumulator; the q.k dot is a warp
// shuffle reduction, so every lane holds the row's score. Each warp keeps its
// own running (max, sum, acc); the 8 partial states are merged through shared
// memory at the end. Output is in natural D order. Only visible rows are read
// (the loop bound is lengths[b]). GQA re-reads the kv head's stripe once per
// query head of its group, which L2 serves; at G = 1 (GPT-2) nothing is
// re-read. Splitting C across blocks (a second combine pass) and Hopper's
// TMA/wgmma are left for later: at the decode shapes of this engine the
// kernel is launch-bound.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch; elit_cuda_error_string names a code. q_dtype: 0 = float32,
// 1 = bfloat16. k_bits, v_bits in {8, 4, 16}, with 16 only together (the fp
// cache). D in {64, 128}. K/V code tensors are
// contiguous [B, Hkv, C, D or D/2]; q, the scales and the extra rows are
// addressed through the strides given (innermost stride 1); out is a
// contiguous [B, Hq, D].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Lane `lane`'s DPL contiguous dims of row `row` of a [rows, D] stripe.
template <int BITS, typename T, int D>
__device__ __forceinline__ void load_row(const void* stripe, long long row, int lane,
                                         float (&out)[D / 32]) {
  constexpr int DPL = D / 32;
  if constexpr (BITS == 8) {
    const int8_t* p = static_cast<const int8_t*>(stripe) + row * D + lane * DPL;
#pragma unroll
    for (int i = 0; i < DPL; ++i) out[i] = (float)p[i];
  } else if constexpr (BITS == 4) {
    const uint8_t* p = static_cast<const uint8_t*>(stripe) + row * (D / 2) + lane * (DPL / 2);
#pragma unroll
    for (int i = 0; i < DPL / 2; ++i) {
      const int byte = p[i];
      out[2 * i] = (float)((byte >> 4) - 8);
      out[2 * i + 1] = (float)((byte & 15) - 8);
    }
  } else {
    const T* p = static_cast<const T*>(stripe) + row * D + lane * DPL;
#pragma unroll
    for (int i = 0; i < DPL; ++i) out[i] = to_f32(p[i]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Online-softmax state of one warp (identical in every lane).
template <int DPL>
struct State {
  float m = -INFINITY;
  float l = 0.0f;
  float acc[DPL] = {};
};

// Folds rows [0, n) of one region into the warp's state, kUnroll rows at a
// time. load_k / load_v fill a lane's dims of row r; k_scale / v_scale give
// row r's scale (1 for fp rows).
template <int DPL, typename LK, typename LV, typename SK, typename SV>
__device__ __forceinline__ void fold_region(State<DPL>& st, const float (&qr)[DPL], int n,
                                            int warp, float sm_scale, LK load_k, LV load_v,
                                            SK k_scale, SV v_scale) {
  for (int r0 = warp * kUnroll; r0 < n; r0 += kWarps * kUnroll) {
    float kk[kUnroll][DPL];
    float s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load_k(min(r0 + u, n - 1), kk[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) dot = fmaf(qr[i], kk[u][i], dot);
      dot = warp_sum(dot);
      const int r = r0 + u;
      s[u] = r < n ? dot * k_scale(r) * sm_scale : -INFINITY;
    }
    float m_new = st.m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) m_new = fmaxf(m_new, s[u]);
    const float alpha = expf(st.m - m_new);  // row r0 is visible: m_new is finite
    float vv[kUnroll][DPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load_v(min(r0 + u, n - 1), vv[u]);
    st.l *= alpha;
#pragma unroll
    for (int i = 0; i < DPL; ++i) st.acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u;
      const float p = expf(s[u] - m_new);  // 0 for rows past n
      st.l += p;
      const float pv = r < n ? p * v_scale(r) : 0.0f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) st.acc[i] = fmaf(pv, vv[u][i], st.acc[i]);
    }
    st.m = m_new;
  }
}

template <typename T, int KB, int VB, int D>
__global__ void __launch_bounds__(32 * kWarps)
fused_quant_attention_kernel(
    const T* __restrict__ q, long long q_sb, long long q_sh,
    const void* __restrict__ kq, const void* __restrict__ vq,
    const float* __restrict__ ks, long long ks_sb, long long ks_sh,
    const float* __restrict__ vs, long long vs_sb, long long vs_sh,
    const T* __restrict__ ke, long long ke_sb, long long ke_sh, long long ke_ss,
    const T* __restrict__ ve, long long ve_sb, long long ve_sh, long long ve_ss,
    const int* __restrict__ lengths, int len_value, int n_extra, int S, int Hq, int Hkv,
    int C, float sm_scale, T* __restrict__ out) {
  constexpr int DPL = D / 32;
  constexpr int KW = KB == 4 ? D / 2 : D;  // elements per stored K row
  constexpr int VW = VB == 4 ? D / 2 : D;
  constexpr int KSZ = KB == 16 ? sizeof(T) : 1;
  constexpr int VSZ = VB == 16 ? sizeof(T) : 1;
  const int hq = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = hq / (Hq / Hkv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float qr[DPL];
  const T* qp = q + b * q_sb + hq * q_sh + lane * DPL;
#pragma unroll
  for (int i = 0; i < DPL; ++i) qr[i] = to_f32(qp[i]);

  State<DPL> st;
  const long long head = (long long)b * Hkv + hk;
  const char* k_stripe = static_cast<const char*>(kq) + head * C * KW * KSZ;
  const char* v_stripe = static_cast<const char*>(vq) + head * C * VW * VSZ;
  const float* ksr = ks + b * ks_sb + hk * ks_sh;
  const float* vsr = vs + b * vs_sb + hk * vs_sh;
  int len = min(max(lengths != nullptr ? lengths[b] : len_value, 0), C);
  int n_ex = n_extra;
  if (len == 0 && n_ex == 0) {  // no visible row: uniform weights, as JAX
    len = C;
    n_ex = S;
    sm_scale = 0.0f;
  }

  fold_region<DPL>(
      st, qr, len, warp, sm_scale,
      [&](int r, float (&o)[DPL]) { load_row<KB, T, D>(k_stripe, r, lane, o); },
      [&](int r, float (&o)[DPL]) { load_row<VB, T, D>(v_stripe, r, lane, o); },
      [&](int r) { return KB == 16 ? 1.0f : ksr[r]; },
      [&](int r) { return VB == 16 ? 1.0f : vsr[r]; });

  const T* ker = ke + b * ke_sb + hk * ke_sh;
  const T* ver = ve + b * ve_sb + hk * ve_sh;
  fold_region<DPL>(
      st, qr, n_ex, warp, sm_scale,
      [&](int r, float (&o)[DPL]) { load_row<16, T, D>(ker + r * ke_ss, 0, lane, o); },
      [&](int r, float (&o)[DPL]) { load_row<16, T, D>(ver + r * ve_ss, 0, lane, o); },
      [](int) { return 1.0f; }, [](int) { return 1.0f; });

  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];
  if (lane == 0) {
    sm_m[warp] = st.m;
    sm_l[warp] = st.l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) sm_acc[warp][lane * DPL + i] = st.acc[i];
  __syncthreads();
  if (threadIdx.x < D) {
    const int d = threadIdx.x;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w]);
    float L = 0.0f, o = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (sm_l[w] > 0.0f) {
        const float f = expf(sm_m[w] - M);
        L += sm_l[w] * f;
        o = fmaf(sm_acc[w][d], f, o);
      }
    }
    // L > 0 always: a slot with no visible row was given uniform weights.
    store(out + ((long long)b * Hq + hq) * D + d, L > 0.0f ? o / L : 0.0f);
  }
}

struct Args {
  const void* q; long long q_sb, q_sh;
  const void* kq; const void* vq;
  const float* ks; long long ks_sb, ks_sh;
  const float* vs; long long vs_sb, vs_sh;
  const void* ke; long long ke_sb, ke_sh, ke_ss;
  const void* ve; long long ve_sb, ve_sh, ve_ss;
  const int* lengths; int len_value, n_extra, S, B, Hq, Hkv, C; float sm_scale; void* out;
};

template <typename T, int KB, int VB, int D>
int launch(const Args& a, cudaStream_t stream) {
  dim3 grid(a.Hq, a.B);
  fused_quant_attention_kernel<T, KB, VB, D><<<grid, 32 * kWarps, 0, stream>>>(
      static_cast<const T*>(a.q), a.q_sb, a.q_sh, a.kq, a.vq, a.ks, a.ks_sb, a.ks_sh,
      a.vs, a.vs_sb, a.vs_sh, static_cast<const T*>(a.ke), a.ke_sb, a.ke_sh, a.ke_ss,
      static_cast<const T*>(a.ve), a.ve_sb, a.ve_sh, a.ve_ss, a.lengths, a.len_value,
      a.n_extra, a.S, a.Hq, a.Hkv, a.C, a.sm_scale, static_cast<T*>(a.out));
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dispatch_bits(int k_bits, int v_bits, const Args& a, cudaStream_t st) {
  if (k_bits == 8 && v_bits == 8) return launch<T, 8, 8, D>(a, st);
  if (k_bits == 8 && v_bits == 4) return launch<T, 8, 4, D>(a, st);
  if (k_bits == 4 && v_bits == 8) return launch<T, 4, 8, D>(a, st);
  if (k_bits == 4 && v_bits == 4) return launch<T, 4, 4, D>(a, st);
  if (k_bits == 16 && v_bits == 16) return launch<T, 16, 16, D>(a, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_d(int D, int k_bits, int v_bits, const Args& a, cudaStream_t st) {
  if (D == 64) return dispatch_bits<T, 64>(k_bits, v_bits, a, st);
  if (D == 128) return dispatch_bits<T, 128>(k_bits, v_bits, a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int elit_fused_quant_attention(
    int q_dtype, int k_bits, int v_bits, int B, int Hq, int Hkv, int C, int D,
    const void* q, long long q_sb, long long q_sh,
    const void* kq, const void* vq,
    const float* ks, long long ks_sb, long long ks_sh,
    const float* vs, long long vs_sb, long long vs_sh,
    const void* ke, long long ke_sb, long long ke_sh, long long ke_ss,
    const void* ve, long long ve_sb, long long ve_sh, long long ve_ss,
    const int* lengths, int n_extra, int S, float sm_scale, void* out, void* stream) {
  if (B == 0 || Hq == 0) return (int)cudaGetLastError();
  const Args a{q, q_sb, q_sh, kq, vq, ks, ks_sb, ks_sh, vs, vs_sb, vs_sh,
               ke, ke_sb, ke_sh, ke_ss, ve, ve_sb, ve_sh, ve_ss,
               lengths, 0, n_extra, S, B, Hq, Hkv, C, sm_scale, out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) return dispatch_d<float>(D, k_bits, v_bits, a, st);
  if (q_dtype == 1) return dispatch_d<__nv_bfloat16>(D, k_bits, v_bits, a, st);
  return (int)cudaErrorInvalidValue;
}

// The batch-1 decode form: q [Hq, D]; codes [Hkv, C, D or D/2] contiguous;
// scales [Hkv, C] (head stride given); the current token's k/v [Hkv, D]
// (head stride given), always visible; past rows t < length visible, with
// length read from *length on the device, or `length_value` when length is
// null. k_bits, v_bits in {8, 4}.
extern "C" int elit_fused_quant_attention_decode(
    int q_dtype, int k_bits, int v_bits, int Hq, int Hkv, int C, int D,
    const void* q, long long q_sh, const void* kq, const void* vq,
    const float* ks, long long ks_sh, const float* vs, long long vs_sh,
    const void* kc, long long kc_sh, const void* vc, long long vc_sh,
    const int* length, int length_value, float sm_scale, void* out, void* stream) {
  if (Hq == 0) return (int)cudaGetLastError();
  if (k_bits == 16 || v_bits == 16) return (int)cudaErrorInvalidValue;
  const Args a{q, 0, q_sh, kq, vq, ks, 0, ks_sh, vs, 0, vs_sh,
               kc, 0, kc_sh, 0, vc, 0, vc_sh, 0,
               length, length_value, 1, 1, 1, Hq, Hkv, C, sm_scale, out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) return dispatch_d<float>(D, k_bits, v_bits, a, st);
  if (q_dtype == 1) return dispatch_d<__nv_bfloat16>(D, k_bits, v_bits, a, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* elit_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
