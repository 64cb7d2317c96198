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
// Weight tiers (the JAX kernels' "wscale" / "w4scale" modes,
// ops/pallas/megakernel.py:351-358, :470-490): with w_kind 8 the four layer
// weights and the LM head are int8 rows with fp32 per-row scales, with
// w_kind 4 grouped-int4 rows (32 codes a 16-byte load) with per-(row, group)
// scales in the model dtype; every GEMV of the chain streams its weight in
// that tier (megastep_common.cuh gemv_kernel W_I8 / W_I4). The fc_proj rows
// span all 4E inputs, so the int8 tier applies each row's scale once to the
// whole sum (JAX scales each of the four [E, E] partials by the same
// column scale). The LM head is then the quantized copy `head` [V, E]
// (exactly V rows); the embedding stays on wte. Bound: bytes, as above, of
// the codes and scales: for GPT-2 small ~124 MB in int8 (~37 us at
// 3.35 TB/s) and ~64 MB in int4 at G = 128 (~19 us); chip_smoke.py
// computes each from the run's tensors.
//
// Numerics: the JAX kernels' rounding points, as megastep_common.cuh states
// them.
//
// C interface (ctypes): both entry points take a MegaArgs (mirrored by
// ops/megakernel.py) and a stream, check the first error of each launch with
// cudaGetLastError() and return it (0 = success); elit_cuda_error_string
// names a code. dtype: 0 = float32, 1 = bfloat16. k_kind/v_kind: 0 = model
// dtype, 8 = int8, 4 = half-split int4. w_kind: 0 = model dtype, 8 = int8,
// 4 = grouped int4 (w_group % 32 == 0, dividing E). head_dim in {64, 128};
// capacity up to 8192 (one head's scores, 32 KB, in shared memory without an
// opt-in).

#include "megastep_common.cuh"

// Mirrored field by field by ops/megakernel.py's MegaStepArgs (ctypes): its
// MegaArgs, which the batched and verify structs repeat, then the weight tier.
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
  int w_kind, w_group; // weight tier: 0 = model dtype, 8 = int8, 4 = int4
  const void* head;    // [V, E] LM-head codes ([V, E/2] int4), or null: wte
  const void* attn_s;  // scales: [L, 3E] fp32 (int8), [L, 3E, E/G] T (int4)
  const void* proj_s;  // [L, E] / [L, E, E/G]
  const void* fc_s;    // [L, 4E] / [L, 4E, E/G]
  const void* fcp_s;   // [L, E] / [L, E, 4E/G]
  const void* head_s;  // [V] / [V, E/G]
};

namespace {

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

template <typename T>
int run_step(const MegaArgs& a, cudaStream_t st) {
  const int L = a.n_layer, E = a.n_embd, V = a.vocab;
  const int wk = a.w_kind, G = a.w_group;
  T* x = static_cast<T*>(a.x);
  T* qkv = static_cast<T*>(a.qkv);
  T* attn = static_cast<T*>(a.attn);
  T* ffn = static_cast<T*>(a.ffn);
  auto weight = [&](const void* w, const void* s, int l, int N, int K) {
    return weight_at<T>(w, s, wk, G, (size_t)l * N, K);
  };

  embed_kernel<T><<<1, kThreads, 0, st>>>(static_cast<const T*>(a.wte),
                                          static_cast<const T*>(a.wpe), a.tok_in,
                                          static_cast<const T*>(a.x_emb), a.length, E, V,
                                          a.n_pos, x);
  LAUNCH_CHECK();
  for (int l = 0; l < L; ++l) {
    const float* sm = a.smalls + (size_t)l * 13 * E;
    if (int rc = gemv<T, PRO_LN, EPI_STORE, 1>(
            weight(a.attn_w, a.attn_s, l, 3 * E, E), 3 * E, E, cdiv(3 * E, kWarps), st, x, sm,
            sm + E, a.ln_eps, sm + 4 * E, qkv))
      return rc;
    AttnParams ap{};
    ap.qkv = qkv;
    ap.k = static_cast<char*>(a.k) + pane_offset(a.k_kind, sizeof(T), l, a.capacity, E);
    ap.v = static_cast<char*>(a.v) + pane_offset(a.v_kind, sizeof(T), l, a.capacity, E);
    ap.ks = a.ks ? a.ks + (size_t)l * a.capacity : nullptr;
    ap.vs = a.vs ? a.vs + (size_t)l * a.capacity : nullptr;
    ap.length = a.length;
    ap.capacity = a.capacity;
    ap.n_head = a.n_head;
    ap.q_width = ap.kv_width = E;
    ap.group = 1;
    ap.sm_scale = 1.0f / sqrtf((float)(E / a.n_head));
    ap.quant_eps = a.quant_eps;
    ap.out = attn;
    if (int rc = attention<T>(ap, a.k_kind, a.v_kind, E / a.n_head, st)) return rc;
    if (int rc = gemv<T, PRO_VEC, EPI_RESIDUAL, 2>(
            weight(a.proj_w, a.proj_s, l, E, E), E, E, cdiv(E, kWarps / 2), st, attn, nullptr,
            nullptr, 0.0f, sm + 7 * E, x))
      return rc;
    if (int rc = gemv<T, PRO_LN, EPI_GELU, 1>(
            weight(a.fc_w, a.fc_s, l, 4 * E, E), 4 * E, E, cdiv(4 * E, kWarps), st, x,
            sm + 2 * E, sm + 3 * E, a.ln_eps, sm + 8 * E, ffn))
      return rc;
    if (int rc = gemv<T, PRO_VEC, EPI_RESIDUAL, 4>(
            weight(a.fcp_w, a.fcp_s, l, E, 4 * E), E, 4 * E, cdiv(E, kWarps / 4), st, ffn,
            nullptr, nullptr, 0.0f, sm + 12 * E, x))
      return rc;
  }
  const WeightRef head = wk == W_T ? WeightRef{a.wte, nullptr, W_T, 0}
                                   : weight(a.head, a.head_s, 0, V, E);
  if (int rc = gemv<T, PRO_LN, EPI_ARGMAX, 1>(head, V, E, a.lm_blocks, st, x, a.lnf,
                                              a.lnf + E, a.ln_eps, nullptr, nullptr,
                                              a.lm_val, a.lm_idx))
    return rc;
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
  const int wk = a->w_kind, G = a->w_group;
  const bool tier_ok =
      wk == W_T || (a->head && a->attn_s && a->proj_s && a->fc_s && a->fcp_s && a->head_s &&
                    (wk == W_I8 || (wk == W_I4 && G > 0 && G % 32 == 0 && E % G == 0)));
  if (q != quant || H <= 0 || E % H || E % 128 || a->capacity <= 0 ||
      a->capacity > 8192 || a->lm_blocks <= 0 || (q && (!a->ks || !a->vs)) ||
      (int4 && (E / 2) % (E / H)) || !tier_ok)
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
