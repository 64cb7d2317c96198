// One decode step of B independent Llama/Qwen streams (greedy, 1 <= B <=
// 32) as a fixed chain of kernels.
//
// Replaces efficient_llm_inference_tpu/ops/pallas/megakernel_batch.py:
// llama_megabatch (KV panes in the model dtype) and
// ops/pallas/megakernel_batch_quant.py: llama_megabatch_quant (int8,
// half-split int4 or mixed panes with per-(slot, token) fp32 scales), the
// TPU's batched whole-step decode programs. Entry points:
// elit_llama_megabatch(_quant). Each launches, on the stream it is given, the
// chain of its single-stream counterpart (llama_megastep.cu) with a slot
// dimension (GPT-2's batched step is one persistent kernel of its own,
// gpt2_megabatch.cu):
//
//   embed                  one block per slot: x[b] from tok_in[b] or x_emb[b]
//   per layer l:
//     gemv  norm -> qkv    every weight row read once for all B slots
//     attention            grid (H + 1) x B: blocks (h, b) attend slot b's
//                          pane rows t < lengths[b] (GQA: K/V head h / group;
//                          RoPE at min(lengths[b], P-1)); block (H, b)
//                          writes row lengths[b] of slot b's panes
//     gemv  out-proj + x   residual add in place
//     gemv  norm -> MLP    SwiGLU epilogue
//     gemv  MLP-out + x    residual add in place
//   gemv  norm -> LM head  per-block, per-slot (max, argmax) partials
//   argmax                 one block per slot -> tok_out[b]; with `advance`,
//                          clamp to [0, V-1] and lengths[b] += 1
//
// The bf16 chain (#15, #17 in bf16): its GEMVs are gemv_stream_tc.cuh's
// persistent tensor-core stream, one launch a GEMV for every 1 <= B <= 32
// (no groups of 8: every weight is read once a step), and every kernel of
// it (embed, the GEMVs, the attention, the argmax) is launched with
// programmatic dependent launch, so each starts while the one before it ends
// and a GEMV's first weight stages are in flight before its
// griddepcontrol.wait. The fp32 chain keeps gemv_batch.cuh.
//
// Bound: bytes. A step reads every weight once for all B slots
// (Llama-3.2-1B in bf16: 2.47 GB) plus each slot's visible K/V rows, so B
// tokens cost about one single-stream step while the weights dominate (at B
// = 8 and 320 cached rows the panes add 8 x 10.5 MB). The fp32 chain's
// batched GEMV (gemv_batch.cuh) is a skinny GEMM done as a GEMV: a block
// stages the B input rows in shared memory in the model dtype (exact: the
// staged values are the norm outputs rounded to T, or activations already in
// T) with 16-byte loads, once for all its rows when they fit, and each warp
// streams RW = 1 or 4 weight rows with 16-byte non-caching loads, applying
// every chunk to the staged rows (B x RW fp32 accumulators a lane). Above 8
// slots each of its GEMVs is launched once per group of 8 slots, streaming
// the weights again. The norm statistics are computed by warp b for slot b
// of the group in every block that consumes them.
//
// Weight tiers (the JAX kernels' "wscale" / "w4scale" modes,
// ops/pallas/megakernel_batch.py:625-640, megakernel_batch_quant.py:724-735):
// with w_kind 8 or 4 every GEMV streams int8 or grouped-int4 codes
// (gemv_batch.cuh's and gemv_stream_tc.cuh's tiers), the LM head from the
// quantized copy `head`.
//
// Numerics: per slot, the single-stream chain's rounding points
// (megastep_common.cuh); in the fp32 chain the fp32 sums of the norm
// statistics and of a row split over KS warps may be taken in another order
// than in a batch-1 step. In the bf16 chain a slot's sums are in an order
// fixed by the weight's shape (gemv_stream_tc.cuh), so its token and new K/V
// rows are the same bits at any B and beside any other slots.
//
// C interface (ctypes): each entry point takes its args struct (mirrored by
// ops/megakernel_batch.py) and a stream, checks the first error of each
// launch with cudaGetLastError() and returns it (0 = success);
// elit_cuda_error_string names a code. elit_stream_gemv runs one GEMV of the
// bf16 chain alone, for measurement. The struct is the single-stream
// LlamaArgs with `batch` first and the single-stream struct's weight tier
// last, then the bf16 chain's scratch: the split partials and zeroed tile
// counters, ops/_gemv_stream_tc.py; length, tok_in, tok_out are [B], x_emb
// [B, E], the panes [L, B, C, W], the scales [L, B, C], the workspace [B,
// width], lm_val/lm_idx [B, lm_blocks].

#include "gemv_stream_tc.cuh"

namespace {
constexpr int kMaxSlots = 32;  // the largest batch: the JAX server's largest admission wave
long long g_kernels = 0;       // kernels the bf16 Llama chain has launched (elit_megabatch_kernels)
}  // namespace

// Mirrored by ops/megakernel_batch.py's LlamaBatchArgs (ctypes).
struct LlamaBatchArgs {
  int batch;
  int dtype, n_layer, n_embd, n_head, n_kv_head, head_dim, inter, vocab, n_pos, capacity;
  int k_kind, v_kind, advance, lm_blocks;
  float rms_eps, quant_eps;
  const void* qkv_w;
  const void* o_w;
  const void* gu_w;
  const void* down_w;
  const void* embed;
  const void* head;
  const float* norms;
  const float* lnf;
  const float* qkvb;
  const float* cos;
  const float* sin;
  void* k;
  void* v;
  float* ks;
  float* vs;
  int* length;
  const int* tok_in;
  const void* x_emb;
  int* tok_out;
  void* x;
  void* qkv;
  void* attn;
  void* ffn;
  float* lm_val;
  int* lm_idx;
  int w_kind, w_group;  // weight tier: 0 = model dtype, 8 = int8, 4 = int4
  const void* qkv_s;    // scales: [L, QW + 2 KW] fp32 (int8), [.., E/G] T (int4)
  const void* o_s;
  const void* gu_s;     // interleaved like gu_w
  const void* down_s;
  const void* head_s;
  float* tc_part;        // bf16: the tensor-core GEMVs' split partials, tc_part_len floats
  long long tc_part_len;
  int* tc_count;         // bf16: tc_count_len zeroed ints, one a tile of the largest split GEMV
  int tc_count_len;
};

namespace {

// -------------------------------------------------------------- attention

// Slot b's view of a layer's attention parameters.
template <typename T>
__device__ __forceinline__ void slot_params(AttnParams& p, const SlotStrides& s, int b) {
  p.qkv = static_cast<const T*>(p.qkv) + (size_t)b * s.qkv;
  p.k = static_cast<char*>(p.k) + b * s.k_bytes;
  p.v = static_cast<char*>(p.v) + b * s.v_bytes;
  if (p.ks != nullptr) {
    p.ks += (size_t)b * s.scales;
    p.vs += (size_t)b * s.scales;
  }
  p.length += b;
  p.out = static_cast<T*>(p.out) + (size_t)b * s.out;
}

template <typename T, int KK, int VK, int D>
__global__ void __launch_bounds__(kThreads)
attention_batch_kernel(AttnParams p, const SlotStrides s) {
  slot_params<T>(p, s, blockIdx.y);
  attention_block<T, KK, VK, D>(p, blockIdx.x);
}

// The bf16 Llama chain's attention: the same blocks on a flat grid (block
// i: head i % (H + 1) of slot i / (H + 1)), launched with programmatic
// dependent launch.
template <typename T, int KK, int VK, int D>
__global__ void __launch_bounds__(kThreads)
attention_batch_pdl_kernel(AttnParams p, const SlotStrides s) {
  pdl_wait();
  pdl_launch_dependents();  // the o-projection may request its weights
  const int heads = p.n_head + 1;
  slot_params<T>(p, s, blockIdx.x / heads);
  attention_block<T, KK, VK, D>(p, blockIdx.x % heads);
}

// One launch of a layer's batched attention at head dim D: grid (H + 1) x B,
// or with PDL (the bf16 Llama chain) the flat grid of
// attention_batch_pdl_kernel, launched with programmatic dependent launch.
template <typename T, int KK, int VK, int D, bool PDL>
int launch_attention_batch_d(const AttnParams& p, const SlotStrides& s, int B, cudaStream_t st) {
  const int rows = p.cos != nullptr && p.kv_width > p.capacity ? p.kv_width : p.capacity;
  const size_t smem = sizeof(float) * (size_t)rows;
  if constexpr (PDL) {
    return launch_pdl(attention_batch_pdl_kernel<T, KK, VK, D>, (p.n_head + 1) * B, smem, st, p,
                      s);
  } else {
    attention_batch_kernel<T, KK, VK, D><<<dim3(p.n_head + 1, B), kThreads, smem, st>>>(p, s);
    LAUNCH_CHECK();
    return 0;
  }
}

template <typename T, int KK, int VK, bool PDL>
int launch_attention_batch(const AttnParams& p, const SlotStrides& s, int B, int head_dim,
                           cudaStream_t st) {
  if (head_dim == 64) return launch_attention_batch_d<T, KK, VK, 64, PDL>(p, s, B, st);
  if (head_dim == 128) return launch_attention_batch_d<T, KK, VK, 128, PDL>(p, s, B, st);
  return (int)cudaErrorInvalidValue;
}

// The batched attention of one layer over the pane kinds (k_kind, v_kind).
template <typename T, bool PDL = false>
int attention_batch(const AttnParams& p, const SlotStrides& s, int B, int k_kind, int v_kind,
                    int head_dim, cudaStream_t st) {
  if (k_kind == 0 && v_kind == 0)
    return launch_attention_batch<T, 0, 0, PDL>(p, s, B, head_dim, st);
  if (k_kind == 8 && v_kind == 8)
    return launch_attention_batch<T, 8, 8, PDL>(p, s, B, head_dim, st);
  if (k_kind == 4 && v_kind == 4)
    return launch_attention_batch<T, 4, 4, PDL>(p, s, B, head_dim, st);
  if (k_kind == 8 && v_kind == 4)
    return launch_attention_batch<T, 8, 4, PDL>(p, s, B, head_dim, st);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------ embedding, argmax

template <typename T>
__device__ __forceinline__ void llama_embed_slot(const T* __restrict__ embed,
                                                 const int* __restrict__ tok_in,
                                                 const T* __restrict__ x_emb, int E, int V,
                                                 T* __restrict__ x, int b) {
  const T* src = x_emb + (size_t)b * E;
  if (tok_in != nullptr) src = embed + (size_t)min(max(tok_in[b], 0), V - 1) * E;
  for (int e = threadIdx.x; e < E; e += kThreads) x[(size_t)b * E + e] = src[e];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
llama_embed_batch(const T* __restrict__ embed, const int* __restrict__ tok_in,
                  const T* __restrict__ x_emb, int E, int V, T* __restrict__ x) {
  llama_embed_slot(embed, tok_in, x_emb, E, V, x, blockIdx.x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
llama_embed_batch_pdl(const T* __restrict__ embed, const int* __restrict__ tok_in,
                      const T* __restrict__ x_emb, int E, int V, T* __restrict__ x) {
  pdl_wait();
  pdl_launch_dependents();  // the first GEMV may request its weights
  llama_embed_slot(embed, tok_in, x_emb, E, V, x, blockIdx.x);
}

__global__ void __launch_bounds__(kThreads)
argmax_batch_kernel(const float* __restrict__ part_val, const int* __restrict__ part_idx, int n,
                    int V, int advance, int* __restrict__ tok_out, int* __restrict__ lengths) {
  const int b = blockIdx.x;
  argmax_block(part_val + (size_t)b * n, part_idx + (size_t)b * n, n, V, advance, tok_out + b,
               lengths + b);
}

__global__ void __launch_bounds__(kThreads)
argmax_batch_pdl_kernel(const float* __restrict__ part_val, const int* __restrict__ part_idx,
                        int n, int V, int advance, int* __restrict__ tok_out,
                        int* __restrict__ lengths) {
  pdl_wait();
  pdl_launch_dependents();
  const int b = blockIdx.x;
  argmax_block(part_val + (size_t)b * n, part_idx + (size_t)b * n, n, V, advance, tok_out + b,
               lengths + b);
}

// ------------------------------------------------------------------ chains

template <typename T>
int llama_step(const LlamaBatchArgs& a, cudaStream_t st) {
  const int L = a.n_layer, E = a.n_embd, I = a.inter, V = a.vocab, D = a.head_dim;
  const int B = a.batch, C = a.capacity;
  const int QW = a.n_head * D, KW = a.n_kv_head * D, NQKV = QW + 2 * KW;
  auto weight = [&](const void* w, const void* s, int l, int n, int k) {
    return weight_at<T>(w, s, a.w_kind, a.w_group, (size_t)l * n, k);
  };
  T* x = static_cast<T*>(a.x);
  T* qkv = static_cast<T*>(a.qkv);
  T* attn = static_cast<T*>(a.attn);
  T* ffn = static_cast<T*>(a.ffn);

  llama_embed_batch<T><<<B, kThreads, 0, st>>>(static_cast<const T*>(a.embed), a.tok_in,
                                               static_cast<const T*>(a.x_emb), E, V, x);
  LAUNCH_CHECK();
  for (int l = 0; l < L; ++l) {
    const float* nm = a.norms + (size_t)l * 2 * E;
    RETURN_IF((gemv_batch<T, PRO_RMS, EPI_STORE, 1>(
        weight(a.qkv_w, a.qkv_s, l, NQKV, E), NQKV, E, B, x, nm, nullptr, a.rms_eps,
        a.qkvb ? a.qkvb + (size_t)l * NQKV : nullptr, qkv, nullptr, nullptr, 0, nullptr, st)));
    AttnParams ap{};
    SlotStrides ss{};
    layer_panes<T>(ap, ss, a.k, a.v, a.ks, a.vs, a.k_kind, a.v_kind, l, B, C, KW);
    ss.qkv = NQKV;
    ss.out = QW;
    ap.qkv = qkv;
    ap.length = a.length;
    ap.cos = a.cos;
    ap.sin = a.sin;
    ap.n_pos = a.n_pos;
    ap.capacity = C;
    ap.n_head = a.n_head;
    ap.q_width = QW;
    ap.kv_width = KW;
    ap.group = a.n_head / a.n_kv_head;
    ap.sm_scale = 1.0f / sqrtf((float)D);
    ap.quant_eps = a.quant_eps;
    ap.out = attn;
    RETURN_IF(attention_batch<T>(ap, ss, B, a.k_kind, a.v_kind, D, st));
    RETURN_IF((gemv_batch<T, PRO_VEC, EPI_RESIDUAL, 2>(
        weight(a.o_w, a.o_s, l, E, QW), E, QW, B, attn, nullptr, nullptr, 0.0f, nullptr, x, nullptr,
        nullptr, 0, nullptr, st)));
    RETURN_IF((gemv_batch<T, PRO_RMS, EPI_SWIGLU, 1>(
        weight(a.gu_w, a.gu_s, l, 2 * I, E), 2 * I, E, B, x, nm + E, nullptr, a.rms_eps, nullptr,
        ffn, nullptr, nullptr, 0, nullptr, st)));
    RETURN_IF((gemv_batch<T, PRO_VEC, EPI_RESIDUAL, 4>(
        weight(a.down_w, a.down_s, l, E, I), E, I, B, ffn, nullptr, nullptr, 0.0f, nullptr, x,
        nullptr, nullptr, 0, nullptr, st)));
  }
  int lm_grid = 0;
  RETURN_IF((gemv_batch<T, PRO_RMS, EPI_ARGMAX, 1>(
      weight(a.head, a.head_s, 0, V, E), V, E, B, x, a.lnf, nullptr, a.rms_eps, nullptr, nullptr,
      a.lm_val, a.lm_idx, a.lm_blocks, &lm_grid, st)));
  argmax_batch_kernel<<<B, kThreads, 0, st>>>(a.lm_val, a.lm_idx, lm_grid, V, a.advance,
                                              a.tok_out, a.length);
  LAUNCH_CHECK();
  return 0;
}

// The bf16 Llama/Qwen chain: every GEMV one launch of gemv_stream_tc.cuh
// for all B slots, every kernel launched with programmatic dependent launch;
// counts its launches in g_kernels.
int llama_step_tc(const LlamaBatchArgs& a, cudaStream_t st) {
  using T = __nv_bfloat16;
  const int L = a.n_layer, E = a.n_embd, I = a.inter, V = a.vocab, D = a.head_dim;
  const int B = a.batch, C = a.capacity;
  const int QW = a.n_head * D, KW = a.n_kv_head * D, NQKV = QW + 2 * KW;
  auto weight = [&](const void* w, const void* s, int l, int n, int k) {
    return weight_at<T>(w, s, a.w_kind, a.w_group, (size_t)l * n, k);
  };
  const stc::Scratch sc{a.tc_part, a.tc_part_len, a.tc_count, a.tc_count_len};
  T* x = static_cast<T*>(a.x);
  T* qkv = static_cast<T*>(a.qkv);
  T* attn = static_cast<T*>(a.attn);
  T* ffn = static_cast<T*>(a.ffn);
  int n = 0;  // launches

  RETURN_IF(launch_pdl(llama_embed_batch_pdl<T>, B, 0, st, static_cast<const T*>(a.embed),
                       a.tok_in, static_cast<const T*>(a.x_emb), E, V, x));
  ++n;
  for (int l = 0; l < L; ++l) {
    const float* nm = a.norms + (size_t)l * 2 * E;
    RETURN_IF((stc::gemv<PRO_RMS, EPI_STORE>(
        weight(a.qkv_w, a.qkv_s, l, NQKV, E), NQKV, E, B, x, nm, a.rms_eps,
        a.qkvb ? a.qkvb + (size_t)l * NQKV : nullptr, qkv, sc, st)));
    AttnParams ap{};
    SlotStrides ss{};
    layer_panes<T>(ap, ss, a.k, a.v, a.ks, a.vs, a.k_kind, a.v_kind, l, B, C, KW);
    ss.qkv = NQKV;
    ss.out = QW;
    ap.qkv = qkv;
    ap.length = a.length;
    ap.cos = a.cos;
    ap.sin = a.sin;
    ap.n_pos = a.n_pos;
    ap.capacity = C;
    ap.n_head = a.n_head;
    ap.q_width = QW;
    ap.kv_width = KW;
    ap.group = a.n_head / a.n_kv_head;
    ap.sm_scale = 1.0f / sqrtf((float)D);
    ap.quant_eps = a.quant_eps;
    ap.out = attn;
    RETURN_IF((attention_batch<T, true>(ap, ss, B, a.k_kind, a.v_kind, D, st)));
    RETURN_IF((stc::gemv<PRO_VEC, EPI_RESIDUAL>(weight(a.o_w, a.o_s, l, E, QW), E, QW, B, attn,
                                                nullptr, 0.0f, nullptr, x, sc, st)));
    RETURN_IF((stc::gemv<PRO_RMS, EPI_SWIGLU>(weight(a.gu_w, a.gu_s, l, 2 * I, E), 2 * I, E,
                                              B, x, nm + E, a.rms_eps, nullptr, ffn, sc, st)));
    RETURN_IF((stc::gemv<PRO_VEC, EPI_RESIDUAL>(weight(a.down_w, a.down_s, l, E, I), E, I, B,
                                                ffn, nullptr, 0.0f, nullptr, x, sc, st)));
    n += 5;
  }
  int lm_grid = 0;
  RETURN_IF((stc::gemv<PRO_RMS, EPI_ARGMAX>(weight(a.head, a.head_s, 0, V, E), V, E, B, x,
                                            a.lnf, a.rms_eps, nullptr, nullptr, sc, st,
                                            a.lm_blocks, a.lm_val, a.lm_idx, &lm_grid)));
  RETURN_IF(launch_pdl(argmax_batch_pdl_kernel, B, 0, st, static_cast<const float*>(a.lm_val),
                       static_cast<const int*>(a.lm_idx), lm_grid, V, a.advance, a.tok_out,
                       a.length));
  g_kernels += n + 2;
  return 0;
}

int run_llama(const LlamaBatchArgs* a, void* stream, bool quant) {
  if (a == nullptr) return (int)cudaErrorInvalidValue;
  const bool q = a->k_kind != 0 || a->v_kind != 0;
  const int D = a->head_dim, Hq = a->n_head, Hkv = a->n_kv_head;
  const bool int4 = a->k_kind == 4 || a->v_kind == 4;
  // 16-byte weight rows need widths that are multiples of 8 values
  if (q != quant || a->batch < 1 || a->batch > kMaxSlots || (D != 64 && D != 128) ||
      Hkv <= 0 || Hq % Hkv || a->n_embd % 8 || a->inter % 8 || a->capacity <= 0 ||
      (a->dtype == 1 && (a->tc_part == nullptr || a->tc_count == nullptr)) ||
      a->capacity > 8192 || a->lm_blocks <= 0 || a->n_pos <= 0 || !a->cos || !a->sin ||
      (q && (!a->ks || !a->vs)) || (int4 && (Hkv * D / 2) % D) || !llama_tier_ok(*a))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->dtype == 0) return llama_step<float>(*a, st);
  if (a->dtype == 1) return llama_step_tc(*a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int elit_llama_megabatch(const LlamaBatchArgs* a, void* stream) {
  return run_llama(a, stream, false);
}

extern "C" int elit_llama_megabatch_quant(const LlamaBatchArgs* a, void* stream) {
  return run_llama(a, stream, true);
}

// Kernels the bf16 Llama/Qwen chain has launched in this process (a step's
// count is the difference across one step).
extern "C" long long elit_megabatch_kernels() { return g_kernels; }

// One bf16 GEMV of the chain alone, for measurement: x [B, K] bf16 (1 <= B
// <= 32) times the rows of w's tier -> out [B, N] bf16, no prologue or bias;
// part / counters as the chain's scratch (ops/_gemv_stream_tc.py scratch_sizes).
extern "C" int elit_stream_gemv(const void* w, const void* ws, int w_kind, int group, int N,
                                int K, int B, const void* x, float* part, long long part_len,
                                int* counters, int count_len, void* out, void* stream) {
  if (w == nullptr || x == nullptr || out == nullptr ||
      !tier_ok(w_kind, group, w_kind == W_T || ws != nullptr, {K}))
    return (int)cudaErrorInvalidValue;
  return stc::gemv<PRO_VEC, EPI_STORE>(WeightRef{w, ws, w_kind, group}, N, K, B,
                                       static_cast<const __nv_bfloat16*>(x), nullptr, 0.0f,
                                       nullptr, static_cast<__nv_bfloat16*>(out),
                                       stc::Scratch{part, part_len, counters, count_len},
                                       static_cast<cudaStream_t>(stream));
}

extern "C" const char* elit_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
