// One Llama/Qwen decode step (greedy, batch 1) as a fixed chain of kernels.
//
// Replaces efficient_llm_inference_tpu/ops/pallas/megakernel_llama.py:
// _llama_megapass (reached through llama_megastep; the R = 1 decode row) and
// ops/pallas/megakernel_quant.py: llama_megastep_quant, the TPU's whole-step
// decode programs for the Llama family. Entry points: elit_llama_megastep (KV
// panes in the model dtype) and elit_llama_megastep_quant (int8, half-split
// int4 or mixed panes with per-token fp32 scales). Each launches, on the
// stream it is given:
//
//   embed                  x = embed[tok] (or x_emb)
//   per layer l:
//     gemv  RMS1 -> qkv    RMSNorm in the prologue, q|k|v out (+ the Qwen
//                          bias on the fp32 sum), rounded to the model dtype
//     attention            one block per query head over rows t < length of
//                          its K/V head (grouped-query attention), q and the
//                          current k rotated by RoPE at min(length, P-1) as
//                          they are read, the current token merged into the
//                          softmax; one more block writes row `length` of the
//                          layer's panes (the rotated k; quantize-on-write
//                          for quantized panes)
//     gemv  o-proj + x     residual add in place
//     gemv  RMS2 -> gate|up   SwiGLU epilogue: silu in fp32 on the fp32 gate
//     gemv  down + x       residual add in place
//   gemv  RMSf -> LM head  logits over the head's rows (the tied embedding or
//                          the untied lm_head), per-block (max, argmax)
//   argmax                 first maximum over the blocks -> token; with
//                          `advance`, clamp it to [0, V-1] and length += 1
//
// Bound: bytes. A step reads every weight once: for Llama-3.2-1B in bf16,
// 16 x (2048 x 3072 + 2048 x 2048 + 3 x 2048 x 8192) x 2 B of layer weights +
// 128256 x 2048 x 2 B of LM head = 2.47 GB, plus the visible KV rows
// (~10.5 MB at 320 rows), so it cannot take less than ~0.74 ms at
// 3.35 TB/s; at ~2 operations per weight byte it is far below the ~295 per
// byte where compute would bind. The GEMVs are megastep_common.cuh's (16-byte
// streaming loads, prefetch before the prologue, fp32 sums); gate and up are
// packed as interleaved rows (2j = gate j, 2j + 1 = up j) so one pass of a
// block yields whole SwiGLU outputs. The chain is 5 L + 3 kernels, captured
// per generation into one CUDA graph by the engine. Left for later: one
// block per K/V head serving its whole query group (the K/V rows are read
// `group` times, from L2), overlapping kernels, a persistent kernel,
// wgmma/TMA.
//
// Weight tiers (the JAX kernel's "wscale" / "w4scale" modes,
// ops/pallas/megakernel_llama.py:763-790 and megakernel_quant.py:744-745):
// with w_kind 8 every weight (q|k|v, o, gate|up, down and the LM head) is
// int8 rows with fp32 per-row scales (gate and up scales interleaved like
// their rows), with w_kind 4 grouped-int4 rows with per-(row, group) scales
// in the model dtype, the int4w8 group TR/2 (Llama-3.2-1B: 1024) included;
// every GEMV of the chain streams its weight in that tier (megastep_common.cuh
// gemv_kernel W_I8 / W_I4), and the LM head is the quantized copy `head`.
// Bound: bytes, of the codes and scales: for Llama-3.2-1B ~1.24 GB in int8
// (~0.37 ms at 3.35 TB/s) and ~0.64 GB in int4 at G = 128 (~0.19 ms);
// chip_smoke.py computes each from the run's tensors.
//
// Numerics (the JAX kernels' rounding points, megastep_common.cuh): RMSNorm
// with fp32 statistics, the normalised value rounded to the model dtype
// before the gain; q and k rounded to the model dtype, then RoPE in fp32 and
// rounded again; silu on the fp32 gate (the JAX kernel's point; the model
// applies it to the rounded gate), its output and the up projection rounded
// before their product.
//
// C interface (ctypes): both entry points take a LlamaArgs (mirrored by
// ops/megakernel_llama.py) and a stream, check the first error of each launch
// with cudaGetLastError() and return it (0 = success); elit_cuda_error_string
// names a code. dtype: 0 = float32, 1 = bfloat16. k_kind/v_kind: 0 = model
// dtype, 8 = int8, 4 = half-split int4. w_kind: 0 = model dtype, 8 = int8
// (E, QW, I multiples of 16), 4 = grouped int4 (w_group % 32 == 0, dividing
// E, QW and I). head_dim in {64, 128}; capacity up to 8192.

#include "megastep_common.cuh"

// Mirrored field by field by ops/megakernel_llama.py's LlamaStepArgs
// (ctypes): its LlamaArgs, which the batched and verify structs repeat, then
// the weight tier.
struct LlamaArgs {
  int dtype, n_layer, n_embd, n_head, n_kv_head, head_dim, inter, vocab, n_pos, capacity;
  int k_kind, v_kind, advance, lm_blocks;
  float rms_eps, quant_eps;
  const void* qkv_w;   // [L, QW + 2 KW, E]
  const void* o_w;     // [L, E, QW]
  const void* gu_w;    // [L, 2 I, E], gate and up rows interleaved
  const void* down_w;  // [L, E, I]
  const void* embed;   // [V, E]
  const void* head;    // [V, E]: the LM head (the embedding when tied)
  const float* norms;  // [L, 2, E]
  const float* lnf;    // [E]
  const float* qkvb;   // [L, QW + 2 KW] or null (no q/k/v bias)
  const float* cos;    // [P, D] RoPE tables
  const float* sin;
  void* k;             // [L, C, EK]
  void* v;             // [L, C, EV]
  float* ks;           // [L, C] (quantized panes)
  float* vs;
  int* length;         // [1]
  const int* tok_in;   // [1] or null
  const void* x_emb;   // [E] or null
  int* tok_out;        // [1]
  void* x;             // workspace in the model dtype: [E], [QW + 2 KW], [QW], [I]
  void* qkv;
  void* attn;
  void* ffn;
  float* lm_val;       // [lm_blocks]
  int* lm_idx;
  int w_kind, w_group; // weight tier: 0 = model dtype, 8 = int8, 4 = int4
  const void* qkv_s;   // scales: [L, QW + 2 KW] fp32 (int8), [.., E/G] T (int4)
  const void* o_s;     // [L, E] / [L, E, QW/G]
  const void* gu_s;    // [L, 2 I] / [L, 2 I, E/G], interleaved like gu_w
  const void* down_s;  // [L, E] / [L, E, I/G]
  const void* head_s;  // [V] / [V, E/G]
};

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
embed_kernel(const T* __restrict__ embed, const int* __restrict__ tok_in,
             const T* __restrict__ x_emb, int E, int V, T* __restrict__ x) {
  const T* src = x_emb;
  if (tok_in != nullptr) src = embed + (size_t)min(max(*tok_in, 0), V - 1) * E;
  for (int e = threadIdx.x; e < E; e += kThreads) x[e] = src[e];
}

template <typename T>
int run_step(const LlamaArgs& a, cudaStream_t st) {
  const int L = a.n_layer, E = a.n_embd, I = a.inter, V = a.vocab, D = a.head_dim;
  const int QW = a.n_head * D, KW = a.n_kv_head * D, NQKV = QW + 2 * KW;
  const int wk = a.w_kind, G = a.w_group;
  T* x = static_cast<T*>(a.x);
  T* qkv = static_cast<T*>(a.qkv);
  T* attn = static_cast<T*>(a.attn);
  T* ffn = static_cast<T*>(a.ffn);
  auto weight = [&](const void* w, const void* s, int l, int N, int K) {
    return weight_at<T>(w, s, wk, G, (size_t)l * N, K);
  };

  embed_kernel<T><<<1, kThreads, 0, st>>>(static_cast<const T*>(a.embed), a.tok_in,
                                          static_cast<const T*>(a.x_emb), E, V, x);
  LAUNCH_CHECK();
  for (int l = 0; l < L; ++l) {
    const float* nm = a.norms + (size_t)l * 2 * E;
    if (int rc = gemv<T, PRO_RMS, EPI_STORE, 1>(
            weight(a.qkv_w, a.qkv_s, l, NQKV, E), NQKV, E, cdiv(NQKV, kWarps), st, x, nm,
            nullptr, a.rms_eps, a.qkvb ? a.qkvb + (size_t)l * NQKV : nullptr, qkv))
      return rc;
    AttnParams ap{};
    ap.qkv = qkv;
    ap.k = static_cast<char*>(a.k) + pane_offset(a.k_kind, sizeof(T), l, a.capacity, KW);
    ap.v = static_cast<char*>(a.v) + pane_offset(a.v_kind, sizeof(T), l, a.capacity, KW);
    ap.ks = a.ks ? a.ks + (size_t)l * a.capacity : nullptr;
    ap.vs = a.vs ? a.vs + (size_t)l * a.capacity : nullptr;
    ap.length = a.length;
    ap.cos = a.cos;
    ap.sin = a.sin;
    ap.n_pos = a.n_pos;
    ap.capacity = a.capacity;
    ap.n_head = a.n_head;
    ap.q_width = QW;
    ap.kv_width = KW;
    ap.group = a.n_head / a.n_kv_head;
    ap.sm_scale = 1.0f / sqrtf((float)D);
    ap.quant_eps = a.quant_eps;
    ap.out = attn;
    if (int rc = attention<T>(ap, a.k_kind, a.v_kind, D, st)) return rc;
    if (int rc = gemv<T, PRO_VEC, EPI_RESIDUAL, 2>(
            weight(a.o_w, a.o_s, l, E, QW), E, QW, cdiv(E, kWarps / 2), st, attn, nullptr,
            nullptr, 0.0f, nullptr, x))
      return rc;
    if (int rc = gemv<T, PRO_RMS, EPI_SWIGLU, 1>(
            weight(a.gu_w, a.gu_s, l, 2 * I, E), 2 * I, E, cdiv(2 * I, kWarps), st, x, nm + E,
            nullptr, a.rms_eps, nullptr, ffn))
      return rc;
    if (int rc = gemv<T, PRO_VEC, EPI_RESIDUAL, 4>(
            weight(a.down_w, a.down_s, l, E, I), E, I, cdiv(E, kWarps / 4), st, ffn, nullptr,
            nullptr, 0.0f, nullptr, x))
      return rc;
  }
  if (int rc = gemv<T, PRO_RMS, EPI_ARGMAX, 1>(weight(a.head, a.head_s, 0, V, E), V, E,
                                               a.lm_blocks, st, x, a.lnf, nullptr, a.rms_eps,
                                               nullptr, nullptr, a.lm_val, a.lm_idx))
    return rc;
  argmax_kernel<<<1, kThreads, 0, st>>>(a.lm_val, a.lm_idx, a.lm_blocks, V, a.advance,
                                        a.tok_out, a.length);
  LAUNCH_CHECK();
  return 0;
}

int run(const LlamaArgs* a, void* stream, bool quant) {
  if (a == nullptr) return (int)cudaErrorInvalidValue;
  const bool q = a->k_kind != 0 || a->v_kind != 0;
  const int D = a->head_dim, Hq = a->n_head, Hkv = a->n_kv_head;
  const bool int4 = a->k_kind == 4 || a->v_kind == 4;
  // 16-byte weight rows need widths that are multiples of a chunk's inputs
  const int wk = a->w_kind, G = a->w_group;
  const int chunk = wk == W_T ? 8 : (wk == W_I8 ? 16 : G);
  const bool tier_ok =
      wk == W_T || (a->qkv_s && a->o_s && a->gu_s && a->down_s && a->head_s &&
                    (wk == W_I8 || (wk == W_I4 && G > 0 && G % 32 == 0)));
  if (q != quant || (D != 64 && D != 128) || Hkv <= 0 || Hq % Hkv || !tier_ok ||
      a->n_embd % chunk || (Hq * D) % chunk || a->inter % chunk || a->capacity <= 0 ||
      a->capacity > 8192 || a->lm_blocks <= 0 || a->n_pos <= 0 || !a->cos || !a->sin ||
      (q && (!a->ks || !a->vs)) || (int4 && (Hkv * D / 2) % D))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->dtype == 0) return run_step<float>(*a, st);
  if (a->dtype == 1) return run_step<__nv_bfloat16>(*a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int elit_llama_megastep(const LlamaArgs* a, void* stream) {
  return run(a, stream, false);
}

extern "C" int elit_llama_megastep_quant(const LlamaArgs* a, void* stream) {
  return run(a, stream, true);
}

extern "C" const char* elit_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
