// One Llama/Qwen decode step (greedy, batch 1) as a fixed chain of kernels.
//
// Replaces efficient_llm_inference_tpu/ops/pallas/megakernel_llama.py:
// _llama_megapass (reached through llama_megastep; the R = 1 decode row) and
// ops/pallas/megakernel_quant.py: llama_megastep_quant, the TPU's whole-step
// decode programs for the Llama family. Entry points: elit_llama_megastep (KV
// panes in the model dtype) and elit_llama_megastep_quant (int8, half-split
// int4 or mixed panes with per-token fp32 scales). Each launches, on the
// stream it is given, every kernel with programmatic dependent launch
// (gemv_stream.cuh launch_pdl):
//
//   embed                  x = embed[tok] (or x_emb); the step's RoPE rows
//                          (position min(length, P-1)) copied for the layers
//   per layer l:
//     gemv  RMS1 -> qkv    RMSNorm in the prologue, q|k|v out (+ the Qwen
//                          bias on the fp32 sum), rounded to the model dtype
//     attention            split-KV grouped-query attention: one block per
//                          K/V head and split of the rows t < length, serving
//                          the head's whole query group, q rotated by RoPE
//                          (the step's rows) as it is read; the last block of
//                          each K/V head combines the splits' partials with
//                          the current token (its k rotated); one more block
//                          writes row `length` of the layer's panes (the
//                          rotated k; quantize-on-write for quantized panes)
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
// byte where compute would bind. The design against that bound:
//   - the GEMVs are gemv_stream.cuh's persistent streaming GEMV: about one
//     block an SM over a contiguous range of rows, the prologue once a
//     block, the rows through a 64 KB shared-memory ring filled by 1-D bulk
//     asynchronous copies; gate and up are packed as interleaved rows
//     (2j = gate j, 2j + 1 = up j) so a block yields whole SwiGLU outputs;
//   - the chain is 5 L + 3 kernels, captured per generation into one CUDA
//     graph by the engine; programmatic dependent launch lets each start
//     while the one before it ends, and a GEMV requests its first weight
//     stages before griddepcontrol.wait (no weight depends on a kernel), so
//     the stream does not drain at the 83 boundaries;
//   - attention reads each K/V row once for its whole query group, on
//     n_kv_head x splits blocks (the split plan, from the capacity and the
//     card's SM count, is ops/megakernel_llama.py `attention_plan`).
//
// Weight tiers (the JAX kernel's "wscale" / "w4scale" modes,
// ops/pallas/megakernel_llama.py:763-790 and megakernel_quant.py:744-745):
// with w_kind 8 every weight (q|k|v, o, gate|up, down and the LM head) is
// int8 rows with fp32 per-row scales (gate and up scales interleaved like
// their rows), with w_kind 4 grouped-int4 rows with per-(row, group) scales
// in the model dtype, the int4w8 group TR/2 (Llama-3.2-1B: 1024) included;
// every GEMV of the chain streams its weight in that tier (gemv_stream W_I8 /
// W_I4, weight_tier.cuh's chunk decode), and the LM head is the quantized
// copy `head`. Bound: bytes, of the codes and scales: for Llama-3.2-1B
// ~1.24 GB in int8 (~0.37 ms at 3.35 TB/s) and ~0.64 GB in int4 at G = 128
// (~0.19 ms); chip_smoke.py computes each from the run's tensors.
//
// Numerics (the JAX kernels' rounding points, megastep_common.cuh): RMSNorm
// with fp32 statistics, the normalised value rounded to the model dtype
// before the gain; q and k rounded to the model dtype, then RoPE in fp32 and
// rounded again; silu on the fp32 gate (the JAX kernel's point; the model
// applies it to the rounded gate), its output and the up projection rounded
// before their product. Attention in fp32: a split's scores, its max m_s,
// exp(s - m_s), their sum l_s and the PV sums acc_s; the combine takes
// M = max(m_s, s_cur) and out = (sum_s acc_s e^(m_s - M) + e^(s_cur - M)
// v_cur) / (sum_s l_s e^(m_s - M) + e^(s_cur - M)), the same softmax as one
// pass in another order of fp32 rounding. Quantized panes: the probabilities
// times the V scales are rounded to the model dtype relative to the split's
// max m_s, then rescaled in fp32 at the combine; this moves the JAX rounding
// point's reference max (the JAX kernel rounds p * v_scale with p relative
// to the row's global max) by the factor e^(m_s - M), a bf16 rounding of a
// different value, held to the same limits (chip_smoke.py, the card tests).
//
// C interface (ctypes): both entry points take a LlamaSingleArgs (mirrored by
// ops/megakernel_llama.py `LlamaSingleArgs`) and a stream, check the first
// error of each launch and return it (0 = success); elit_cuda_error_string
// names a code. dtype: 0 = float32, 1 = bfloat16. k_kind/v_kind: 0 = model
// dtype, 8 = int8, 4 = half-split int4. w_kind: 0 = model dtype, 8 = int8
// (E, QW, I multiples of 16), 4 = grouped int4 (w_group % 32 == 0, dividing
// E, QW and I). head_dim in {64, 128}; capacity up to 8192. Programmatic
// dependent launch needs CUDA 12.3 or later (its capture into a CUDA graph).

#include "gemv_stream.cuh"
#include "split_attention.cuh"

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

// The single-stream step's arguments: LlamaArgs (which the batched and
// verify structs repeat), then the split-KV attention's plan and scratch
// (ops/megakernel_llama.py `attention_plan`, allocated by its launcher).
struct LlamaSingleArgs {
  LlamaArgs a;
  int attn_splits, attn_rows;  // splits of the capacity, rows a split
  float* attn_part;            // [n_head, splits, D + 2]: (m, l, acc[D]) a head and split
  int* attn_count;             // [n_kv_head] finished splits, zero between launches
  float* rope;                 // [2, D]: the step's RoPE rows, cos and sin at min(length, P-1)
};

namespace {

// x = embed[tok] (or x_emb), and the step's RoPE rows: every layer's
// attention reads them from `rope` in the one round trip that brings q.
template <typename T>
__global__ void __launch_bounds__(kThreads)
embed_kernel(const T* __restrict__ embed, const int* __restrict__ tok_in,
             const T* __restrict__ x_emb, int E, int V, T* __restrict__ x,
             const int* __restrict__ length, const float* __restrict__ cos,
             const float* __restrict__ sin, int n_pos, int D, float* __restrict__ rope) {
  pdl_wait();
  pdl_launch_dependents();  // the first GEMV may request its weights
  if (threadIdx.x < 2 * D) {
    const int pos = min(max(*length, 0), n_pos - 1), d = threadIdx.x % D;
    rope[threadIdx.x] = (threadIdx.x < D ? cos : sin)[(size_t)pos * D + d];
  }
  const T* src = x_emb;
  if (tok_in != nullptr) src = embed + (size_t)min(max(*tok_in, 0), V - 1) * E;
  for (int e = threadIdx.x; e < E; e += kThreads) x[e] = src[e];
}

__global__ void __launch_bounds__(kThreads)
argmax_step_kernel(const float* __restrict__ part_val, const int* __restrict__ part_idx, int n,
                   int V, int advance, int* __restrict__ tok_out, int* __restrict__ length) {
  pdl_wait();
  pdl_launch_dependents();
  argmax_block(part_val, part_idx, n, V, advance, tok_out, length);
}

// ------------------------------------------------------ split-KV attention
//
// Block b < n_kv * splits: split_attention.cuh's item b (one K/V head and
// split, serving the head's whole query group, kHeadChunk heads a pass).
// The combine stays in the attention kernel, not in the o-projection's
// prologue, because it reads only its head's splits x (D + 2) floats where
// every o-projection block would read all of them, and it keeps the GEMV's
// prologue the same for every weight. Block n_kv * splits writes row
// `length` of the layer's panes (never read by this step; with RoPE it first
// rotates the whole k row into shared memory).

constexpr int kHeadChunk = 4;  // query heads a pass of phases 1 and 3 holds in registers

template <typename T, int KK, int VK, int D>
__global__ void __launch_bounds__(kThreads) split_attention_kernel(const SplitAttn a) {
  extern __shared__ float sm[];  // the split blocks: q, the current token, scores
  const AttnParams& p = a.p;
  if (blockIdx.x < a.n_kv * a.splits) {
    split_attention_item<T, KK, VK, D, kHeadChunk>(a, blockIdx.x, sm, [&] {
      pdl_wait();
      pdl_launch_dependents();  // the o-projection may request its weights
      return *p.length;
    });
    return;
  }
  __shared__ float red[kWarps];
  pdl_wait();
  pdl_launch_dependents();
  const int raw_len = *p.length, C = p.capacity, KW = p.kv_width;
  const T* kc = static_cast<const T*>(p.qkv) + p.q_width;
  const T* vc = kc + KW;
  if (raw_len >= 0 && raw_len < C) {  // the new row of this layer
    if (p.cos != nullptr) {
      for (int e = threadIdx.x; e < KW; e += kThreads)
        sm[e] = head_value<T>(kc + (e / D) * D, e % D, D, p.cos, p.sin);
      __syncthreads();
      write_row<T, KK>(sm, p.k, p.ks, raw_len, KW, p.quant_eps, red);
    } else {
      write_row<T, KK>(kc, p.k, p.ks, raw_len, KW, p.quant_eps, red);
    }
    write_row<T, VK>(vc, p.v, p.vs, raw_len, KW, p.quant_eps, red);
  }
}

template <typename T, int KK, int VK, int D>
int launch_split_attention_d(const SplitAttn& a, cudaStream_t st) {
  const size_t split_floats = split_item_floats(a.p.group, D, a.rows);
  const size_t writer_floats = a.p.cos != nullptr ? (size_t)a.p.kv_width : 0;
  const size_t smem = sizeof(float) * std::max(split_floats, writer_floats);
  auto kernel = split_attention_kernel<T, KK, VK, D>;
  if (int rc = allow_smem(kernel, smem)) return rc;
  return launch_pdl(kernel, a.n_kv * a.splits + 1, smem, st, a);
}

template <typename T, int KK, int VK>
int launch_split_attention(const SplitAttn& a, int head_dim, cudaStream_t st) {
  if (head_dim == 64) return launch_split_attention_d<T, KK, VK, 64>(a, st);
  if (head_dim == 128) return launch_split_attention_d<T, KK, VK, 128>(a, st);
  return (int)cudaErrorInvalidValue;
}

// The split attention of the panes' storage kinds (0 = T, 8 = int8,
// 4 = half-split int4; K and V both T, or both quantized).
template <typename T>
int split_attention(const SplitAttn& a, int k_kind, int v_kind, int head_dim, cudaStream_t st) {
  if (k_kind == 0 && v_kind == 0) return launch_split_attention<T, 0, 0>(a, head_dim, st);
  if (k_kind == 8 && v_kind == 8) return launch_split_attention<T, 8, 8>(a, head_dim, st);
  if (k_kind == 4 && v_kind == 4) return launch_split_attention<T, 4, 4>(a, head_dim, st);
  if (k_kind == 8 && v_kind == 4) return launch_split_attention<T, 8, 4>(a, head_dim, st);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------------- host

template <typename T>
int run_step(const LlamaSingleArgs& sa, cudaStream_t st) {
  const LlamaArgs& a = sa.a;
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

  if (int rc = launch_pdl(embed_kernel<T>, 1, 0, st, static_cast<const T*>(a.embed), a.tok_in,
                          static_cast<const T*>(a.x_emb), E, V, x,
                          static_cast<const int*>(a.length), a.cos, a.sin, a.n_pos, D, sa.rope))
    return rc;
  for (int l = 0; l < L; ++l) {
    const float* nm = a.norms + (size_t)l * 2 * E;
    if (int rc = gemv_stream<T, PRO_RMS, EPI_STORE>(
            weight(a.qkv_w, a.qkv_s, l, NQKV, E), NQKV, E, st, x, nm, a.rms_eps,
            a.qkvb ? a.qkvb + (size_t)l * NQKV : nullptr, qkv))
      return rc;
    SplitAttn at{};
    AttnParams& ap = at.p;
    ap.qkv = qkv;
    ap.k = static_cast<char*>(a.k) + pane_offset(a.k_kind, sizeof(T), l, a.capacity, KW);
    ap.v = static_cast<char*>(a.v) + pane_offset(a.v_kind, sizeof(T), l, a.capacity, KW);
    ap.ks = a.ks ? a.ks + (size_t)l * a.capacity : nullptr;
    ap.vs = a.vs ? a.vs + (size_t)l * a.capacity : nullptr;
    ap.length = a.length;
    ap.cos = sa.rope;
    ap.sin = sa.rope + D;
    ap.n_pos = a.n_pos;
    ap.capacity = a.capacity;
    ap.n_head = a.n_head;
    ap.q_width = QW;
    ap.kv_width = KW;
    ap.group = a.n_head / a.n_kv_head;
    ap.sm_scale = 1.0f / sqrtf((float)D);
    ap.quant_eps = a.quant_eps;
    ap.out = attn;
    at.n_kv = a.n_kv_head;
    at.splits = sa.attn_splits;
    at.rows = sa.attn_rows;
    at.part = sa.attn_part;
    at.count = sa.attn_count;
    if (int rc = split_attention<T>(at, a.k_kind, a.v_kind, D, st)) return rc;
    if (int rc = gemv_stream<T, PRO_VEC, EPI_RESIDUAL>(weight(a.o_w, a.o_s, l, E, QW), E, QW, st,
                                                       attn, nullptr, 0.0f, nullptr, x))
      return rc;
    if (int rc = gemv_stream<T, PRO_RMS, EPI_SWIGLU>(weight(a.gu_w, a.gu_s, l, 2 * I, E), 2 * I,
                                                     E, st, x, nm + E, a.rms_eps, nullptr, ffn))
      return rc;
    if (int rc = gemv_stream<T, PRO_VEC, EPI_RESIDUAL>(weight(a.down_w, a.down_s, l, E, I), E, I,
                                                       st, ffn, nullptr, 0.0f, nullptr, x))
      return rc;
  }
  int lm_grid = 0;
  if (int rc = gemv_stream<T, PRO_RMS, EPI_ARGMAX>(weight(a.head, a.head_s, 0, V, E), V, E, st, x,
                                                   a.lnf, a.rms_eps, nullptr, nullptr,
                                                   a.lm_blocks, a.lm_val, a.lm_idx, &lm_grid))
    return rc;
  return launch_pdl(argmax_step_kernel, 1, 0, st, static_cast<const float*>(a.lm_val),
                    static_cast<const int*>(a.lm_idx), lm_grid, V, a.advance, a.tok_out,
                    a.length);
}

int run(const LlamaSingleArgs* sa, void* stream, bool quant) {
  if (sa == nullptr) return (int)cudaErrorInvalidValue;
  const LlamaArgs* a = &sa->a;
  const bool q = a->k_kind != 0 || a->v_kind != 0;
  const int D = a->head_dim, Hq = a->n_head, Hkv = a->n_kv_head;
  const bool int4 = a->k_kind == 4 || a->v_kind == 4;
  // 16-byte weight rows need widths that are multiples of a chunk's inputs
  const int wk = a->w_kind, G = a->w_group;
  const int chunk = wk == W_T ? 8 : (wk == W_I8 ? 16 : G);
  const bool tier_ok =
      wk == W_T || (a->qkv_s && a->o_s && a->gu_s && a->down_s && a->head_s &&
                    (wk == W_I8 || (wk == W_I4 && G > 0 && G % 32 == 0)));
  const bool plan_ok = sa->attn_splits >= 1 && sa->attn_rows >= 1 &&
                       (long long)sa->attn_splits * sa->attn_rows >= a->capacity &&
                       sa->attn_part && sa->attn_count && sa->rope;
  if (q != quant || (D != 64 && D != 128) || Hkv <= 0 || Hq % Hkv || !tier_ok || !plan_ok ||
      a->n_embd % chunk || (Hq * D) % chunk || a->inter % chunk || a->capacity <= 0 ||
      a->capacity > 8192 || a->lm_blocks <= 0 || a->n_pos <= 0 || !a->cos || !a->sin ||
      (q && (!a->ks || !a->vs)) || (int4 && (Hkv * D / 2) % D))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->dtype == 0) return run_step<float>(*sa, st);
  if (a->dtype == 1) return run_step<__nv_bfloat16>(*sa, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int elit_llama_megastep(const LlamaSingleArgs* a, void* stream) {
  return run(a, stream, false);
}

extern "C" int elit_llama_megastep_quant(const LlamaSingleArgs* a, void* stream) {
  return run(a, stream, true);
}

extern "C" const char* elit_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
