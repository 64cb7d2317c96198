// The batched speculative verify pass (greedy): R verify rows (1 <= R <= 8)
// for each of B slots, B x R <= 256, as a fixed chain of kernels, for GPT-2
// and for Llama/Qwen, over panes in the model dtype or quantized.
//
// Replaces efficient_llm_inference_tpu/ops/pallas/megakernel_batch_verify.py:
// gpt2_megabatch_verify, gpt2_megabatch_verify_quant, llama_megabatch_verify
// and llama_megabatch_verify_quant, the TPU's B-slot R-row verify programs
// of the continuous-batching server's speculative chunks. Entry points:
// elit_gpt2_megabatch_verify(_quant) and elit_llama_megabatch_verify(_quant).
// Input row i = b * R + t carries slot b's t-th verify token at position
// lengths[b] + t (lengths read on the device). Each launches, on the stream
// it is given, the verify chain of megaverify.cu with the slot dimension of
// megabatch.cu:
//
//   embed                  one block per row: x[i] from x_emb[i] or
//                          tok_in[i] (GPT-2 adds wpe[min(lengths[b] + t, P-1)])
//   per layer l:
//     gemv  norm -> qkv    every weight row read once for all B x R rows
//     write                grid R x B: block (t, b) writes row lengths[b] + t
//                          of slot b's panes (Llama: the k row rotated at
//                          min(lengths[b] + t, P-1); quantized panes:
//                          quantize-on-write with its scale); nothing at or
//                          past capacity
//     attention            grid H x R x B: block (h, t, b) attends slot b's
//                          pane rows c < lengths[b] + t (the cache and the
//                          slot's verify rows j < t, just written) with row
//                          t's own k/v merged into the softmax at full
//                          precision
//     gemv  out-proj + x   residual add in place
//     gemv  norm -> MLP    GELU (GPT-2) or SwiGLU (Llama) epilogue
//     gemv  MLP-out + x    residual add in place
//   gemv  norm -> LM head  per-block, per-row (max, argmax) partials
//   argmax                 one block per row -> tok_out[i]; lengths are not
//                          advanced (the caller keeps the accepted rows)
//
// Numerics: row (b, t) is the single-stream step of slot b at length
// lengths[b] + t, so the pass equals R sequential steps of each slot. Over
// quantized panes that is the JAX kernels' rule exactly: the in-block rows
// j < t are read back through their codes and scales (written before
// attention reads them), the diagonal j == t is the row's own k/v at full
// precision; over fp panes the in-block rows are the model-dtype k/v. Per
// row, the single-stream chains' rounding points (megastep_common.cuh).
//
// Weight tiers (the JAX kernels' "wscale" / "w4scale" modes,
// ops/pallas/megakernel_batch_verify.py:148-158, :637, :1235, :1812): with
// w_kind 8 or 4 every GEMV streams int8 or grouped-int4 codes through
// gemv_batch.cuh's tiers, the LM head from the quantized copy `head`.
//
// Bound: at 16 x 8 rows (GPT-2 small, 16 slots, k = 8) the GEMVs do
// 2 x 124 M x 128 = 32 GFLOP of fp32 FMAs on the CUDA cores against 247 MB
// of weights: operations, not bytes, bound the pass. The GEMVs are
// gemv_batch.cuh's, launched once per group of 8 rows (the weights
// streamed once a group). Left for later: tensor cores (mma.sync m16n8k16
// over the 16-256 rows, one weight stream).
//
// C interface (ctypes): each entry point takes its args struct (mirrored by
// ops/megakernel_batch_verify.py: the single-stream MegaArgs / LlamaArgs with
// `batch` and `rows` first and the weight tier last) and a stream, checks the
// first error of each launch with cudaGetLastError() and returns it (0 =
// success); elit_cuda_error_string names a code. length is [B], tok_in and
// tok_out [B x R], x_emb [B x R, E], the panes [L, B, C, W], the scales [L, B,
// C], the workspace [B x R, width], lm_val/lm_idx [B x R, lm_blocks].

#include "gemv_batch.cuh"

namespace {
constexpr int kMaxVerifyRows = 8;  // the JAX verify kernels' largest R
}  // namespace

// Mirrored by ops/megakernel_batch_verify.py's GPT2BatchVerifyArgs (ctypes).
struct Gpt2BatchVerifyArgs {
  int batch, rows;
  int dtype, n_layer, n_embd, n_head, vocab, n_pos, capacity;
  int k_kind, v_kind, advance, lm_blocks;
  float ln_eps, quant_eps;
  const void* attn_w;
  const void* proj_w;
  const void* fc_w;
  const void* fcp_w;
  const void* wte;
  const void* wpe;
  const float* smalls;
  const float* lnf;
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
  const void* head;     // [V, E] LM-head codes ([V, E/2] int4), or null: wte
  const void* attn_s;   // scales: [L, 3E] fp32 (int8), [L, 3E, E/G] T (int4)
  const void* proj_s;
  const void* fc_s;
  const void* fcp_s;
  const void* head_s;
};

// Mirrored by ops/megakernel_batch_verify.py's LlamaBatchVerifyArgs (ctypes).
struct LlamaBatchVerifyArgs {
  int batch, rows;
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
};

namespace {

// ------------------------------------------------------------- row views

// Row (b, t)'s view of one layer's attention: slot b's panes and scales, its
// q|k|v and output rows (input row b * R + t) and the length lengths[b] + t
// (held in the block's shared `len`).
template <typename T>
__device__ __forceinline__ void slot_row_view(AttnParams& p, const SlotStrides& s, int b, int t,
                                              int R, int* len) {
  if (threadIdx.x == 0) *len = p.length[b] + t;
  __syncthreads();
  const size_t i = (size_t)b * R + t;
  p.qkv = static_cast<const T*>(p.qkv) + i * s.qkv;
  p.out = static_cast<T*>(p.out) + i * s.out;
  p.k = static_cast<char*>(p.k) + b * s.k_bytes;
  p.v = static_cast<char*>(p.v) + b * s.v_bytes;
  if (p.ks != nullptr) {
    p.ks += (size_t)b * s.scales;
    p.vs += (size_t)b * s.scales;
  }
  p.length = len;
}

// Block (t, b) writes row lengths[b] + t of slot b's panes (attention_block's
// writer: quantize-on-write for quantized panes, RoPE for Llama's k).
template <typename T, int KK, int VK, int D>
__global__ void __launch_bounds__(kThreads)
batch_verify_write_kernel(AttnParams p, const SlotStrides s, int R) {
  __shared__ int len;
  slot_row_view<T>(p, s, blockIdx.y, blockIdx.x, R, &len);
  attention_block<T, KK, VK, D>(p, p.n_head);
}

// Block (h, t, b): query head h of slot b's row t over pane rows
// c < lengths[b] + t and row t's own k/v.
template <typename T, int KK, int VK, int D>
__global__ void __launch_bounds__(kThreads)
batch_verify_attention_kernel(AttnParams p, const SlotStrides s, int R) {
  __shared__ int len;
  slot_row_view<T>(p, s, blockIdx.z, blockIdx.y, R, &len);
  attention_block<T, KK, VK, D>(p, blockIdx.x);
}

template <typename T, int KK, int VK, int D>
int launch_verify_attention(const AttnParams& p, const SlotStrides& s, int B, int R,
                            cudaStream_t st) {
  const int rows = p.cos != nullptr && p.kv_width > p.capacity ? p.kv_width : p.capacity;
  const size_t smem = sizeof(float) * (size_t)rows;  // scores; the writer's roped k
  batch_verify_write_kernel<T, KK, VK, D><<<dim3(R, B), kThreads, smem, st>>>(p, s, R);
  LAUNCH_CHECK();
  batch_verify_attention_kernel<T, KK, VK, D>
      <<<dim3(p.n_head, R, B), kThreads, smem, st>>>(p, s, R);
  LAUNCH_CHECK();
  return 0;
}

template <typename T, int KK, int VK>
int verify_attention_kinds(const AttnParams& p, const SlotStrides& s, int B, int R,
                           int head_dim, cudaStream_t st) {
  if (head_dim == 64) return launch_verify_attention<T, KK, VK, 64>(p, s, B, R, st);
  if (head_dim == 128) return launch_verify_attention<T, KK, VK, 128>(p, s, B, R, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int verify_attention(const AttnParams& p, const SlotStrides& s, int B, int R, int k_kind,
                     int v_kind, int head_dim, cudaStream_t st) {
  if (k_kind == 0 && v_kind == 0) return verify_attention_kinds<T, 0, 0>(p, s, B, R, head_dim, st);
  if (k_kind == 8 && v_kind == 8) return verify_attention_kinds<T, 8, 8>(p, s, B, R, head_dim, st);
  if (k_kind == 4 && v_kind == 4) return verify_attention_kinds<T, 4, 4>(p, s, B, R, head_dim, st);
  if (k_kind == 8 && v_kind == 4) return verify_attention_kinds<T, 8, 4>(p, s, B, R, head_dim, st);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------ embedding, argmax

template <typename T>
__global__ void __launch_bounds__(kThreads)
gpt2_embed_slot_rows(const T* __restrict__ wte, const T* __restrict__ wpe,
                     const int* __restrict__ tok_in, const T* __restrict__ x_emb,
                     const int* __restrict__ lengths, int R, int E, int V, int P,
                     T* __restrict__ x) {
  const int i = blockIdx.x, b = i / R, t = i % R;
  T* xi = x + (size_t)i * E;
  if (tok_in == nullptr) {
    for (int e = threadIdx.x; e < E; e += kThreads) xi[e] = x_emb[(size_t)i * E + e];
    return;
  }
  const T* we = wte + (size_t)min(max(tok_in[i], 0), V - 1) * E;
  const T* pe = wpe + (size_t)min(max(lengths[b] + t, 0), P - 1) * E;
  for (int e = threadIdx.x; e < E; e += kThreads)
    xi[e] = from_f32<T>(to_f32(we[e]) + to_f32(pe[e]));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
llama_embed_slot_rows(const T* __restrict__ embed, const int* __restrict__ tok_in,
                      const T* __restrict__ x_emb, int E, int V, T* __restrict__ x) {
  const int i = blockIdx.x;
  const T* src = x_emb + (size_t)i * E;
  if (tok_in != nullptr) src = embed + (size_t)min(max(tok_in[i], 0), V - 1) * E;
  for (int e = threadIdx.x; e < E; e += kThreads) x[(size_t)i * E + e] = src[e];
}

__global__ void __launch_bounds__(kThreads)
argmax_slot_rows_kernel(const float* __restrict__ part_val, const int* __restrict__ part_idx,
                        int n, int V, int* __restrict__ tok_out) {
  const int i = blockIdx.x;
  argmax_block(part_val + (size_t)i * n, part_idx + (size_t)i * n, n, V, 0, tok_out + i,
               nullptr);
}

// ------------------------------------------------------------------ chains

template <typename T>
int gpt2_verify(const Gpt2BatchVerifyArgs& a, cudaStream_t st) {
  const int L = a.n_layer, E = a.n_embd, V = a.vocab, B = a.batch, R = a.rows;
  const int C = a.capacity, N = B * R;
  const T* wte = static_cast<const T*>(a.wte);
  auto weight = [&](const void* w, const void* s, int l, int n, int k) {
    return weight_at<T>(w, s, a.w_kind, a.w_group, (size_t)l * n, k);
  };
  T* x = static_cast<T*>(a.x);
  T* qkv = static_cast<T*>(a.qkv);
  T* attn = static_cast<T*>(a.attn);
  T* ffn = static_cast<T*>(a.ffn);

  gpt2_embed_slot_rows<T><<<N, kThreads, 0, st>>>(wte, static_cast<const T*>(a.wpe), a.tok_in,
                                                  static_cast<const T*>(a.x_emb), a.length, R,
                                                  E, V, a.n_pos, x);
  LAUNCH_CHECK();
  for (int l = 0; l < L; ++l) {
    const float* sm = a.smalls + (size_t)l * 13 * E;
    RETURN_IF((gemv_batch<T, PRO_LN, EPI_STORE, 1>(
        weight(a.attn_w, a.attn_s, l, 3 * E, E), 3 * E, E, N, x, sm, sm + E, a.ln_eps, sm + 4 * E,
        qkv, nullptr, nullptr, 0, nullptr, st)));
    AttnParams ap{};
    SlotStrides ss{};
    layer_panes<T>(ap, ss, a.k, a.v, a.ks, a.vs, a.k_kind, a.v_kind, l, B, C, E);
    ss.qkv = 3 * E;
    ss.out = E;
    ap.qkv = qkv;
    ap.length = a.length;
    ap.capacity = C;
    ap.n_head = a.n_head;
    ap.q_width = ap.kv_width = E;
    ap.group = 1;
    ap.sm_scale = 1.0f / sqrtf((float)(E / a.n_head));
    ap.quant_eps = a.quant_eps;
    ap.out = attn;
    RETURN_IF(verify_attention<T>(ap, ss, B, R, a.k_kind, a.v_kind, E / a.n_head, st));
    RETURN_IF((gemv_batch<T, PRO_VEC, EPI_RESIDUAL, 2>(
        weight(a.proj_w, a.proj_s, l, E, E), E, E, N, attn, nullptr, nullptr, 0.0f, sm + 7 * E, x,
        nullptr, nullptr, 0, nullptr, st)));
    RETURN_IF((gemv_batch<T, PRO_LN, EPI_GELU, 1>(
        weight(a.fc_w, a.fc_s, l, 4 * E, E), 4 * E, E, N, x, sm + 2 * E, sm + 3 * E, a.ln_eps,
        sm + 8 * E, ffn, nullptr, nullptr, 0, nullptr, st)));
    RETURN_IF((gemv_batch<T, PRO_VEC, EPI_RESIDUAL, 4>(
        weight(a.fcp_w, a.fcp_s, l, E, 4 * E), E, 4 * E, N, ffn, nullptr, nullptr, 0.0f,
        sm + 12 * E, x, nullptr, nullptr, 0, nullptr, st)));
  }
  const WeightRef head = a.w_kind == W_T ? WeightRef{a.wte, nullptr, W_T, 0}
                                           : weight(a.head, a.head_s, 0, V, E);
  int lm_grid = 0;
  RETURN_IF((gemv_batch<T, PRO_LN, EPI_ARGMAX, 1>(
      head, V, E, N, x, a.lnf, a.lnf + E, a.ln_eps, nullptr, nullptr, a.lm_val, a.lm_idx,
      a.lm_blocks, &lm_grid, st)));
  argmax_slot_rows_kernel<<<N, kThreads, 0, st>>>(a.lm_val, a.lm_idx, lm_grid, V, a.tok_out);
  LAUNCH_CHECK();
  return 0;
}

template <typename T>
int llama_verify(const LlamaBatchVerifyArgs& a, cudaStream_t st) {
  const int L = a.n_layer, E = a.n_embd, I = a.inter, V = a.vocab, D = a.head_dim;
  const int B = a.batch, R = a.rows, C = a.capacity, N = B * R;
  const int QW = a.n_head * D, KW = a.n_kv_head * D, NQKV = QW + 2 * KW;
  auto weight = [&](const void* w, const void* s, int l, int n, int k) {
    return weight_at<T>(w, s, a.w_kind, a.w_group, (size_t)l * n, k);
  };
  T* x = static_cast<T*>(a.x);
  T* qkv = static_cast<T*>(a.qkv);
  T* attn = static_cast<T*>(a.attn);
  T* ffn = static_cast<T*>(a.ffn);

  llama_embed_slot_rows<T><<<N, kThreads, 0, st>>>(static_cast<const T*>(a.embed), a.tok_in,
                                                   static_cast<const T*>(a.x_emb), E, V, x);
  LAUNCH_CHECK();
  for (int l = 0; l < L; ++l) {
    const float* nm = a.norms + (size_t)l * 2 * E;
    RETURN_IF((gemv_batch<T, PRO_RMS, EPI_STORE, 1>(
        weight(a.qkv_w, a.qkv_s, l, NQKV, E), NQKV, E, N, x, nm, nullptr, a.rms_eps,
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
    RETURN_IF(verify_attention<T>(ap, ss, B, R, a.k_kind, a.v_kind, D, st));
    RETURN_IF((gemv_batch<T, PRO_VEC, EPI_RESIDUAL, 2>(
        weight(a.o_w, a.o_s, l, E, QW), E, QW, N, attn, nullptr, nullptr, 0.0f, nullptr, x, nullptr,
        nullptr, 0, nullptr, st)));
    RETURN_IF((gemv_batch<T, PRO_RMS, EPI_SWIGLU, 1>(
        weight(a.gu_w, a.gu_s, l, 2 * I, E), 2 * I, E, N, x, nm + E, nullptr, a.rms_eps, nullptr,
        ffn, nullptr, nullptr, 0, nullptr, st)));
    RETURN_IF((gemv_batch<T, PRO_VEC, EPI_RESIDUAL, 4>(
        weight(a.down_w, a.down_s, l, E, I), E, I, N, ffn, nullptr, nullptr, 0.0f, nullptr, x,
        nullptr, nullptr, 0, nullptr, st)));
  }
  int lm_grid = 0;
  RETURN_IF((gemv_batch<T, PRO_RMS, EPI_ARGMAX, 1>(
      weight(a.head, a.head_s, 0, V, E), V, E, N, x, a.lnf, nullptr, a.rms_eps, nullptr, nullptr,
      a.lm_val, a.lm_idx, a.lm_blocks, &lm_grid, st)));
  argmax_slot_rows_kernel<<<N, kThreads, 0, st>>>(a.lm_val, a.lm_idx, lm_grid, V, a.tok_out);
  LAUNCH_CHECK();
  return 0;
}

// The shape limits shared by both families: 1 <= R <= 8, B x R rows for the
// batched GEMV, the panes' kinds (both fp or both quantized, as `quant`).
bool rows_ok(int batch, int rows, int k_kind, int v_kind, bool quant, const float* ks,
             const float* vs) {
  const bool q = k_kind != 0 || v_kind != 0;
  return q == quant && rows >= 1 && rows <= kMaxVerifyRows && batch >= 1 &&
         batch * rows <= kMaxRows && (!q || (ks && vs));
}

int run_gpt2(const Gpt2BatchVerifyArgs* a, void* stream, bool quant) {
  if (a == nullptr) return (int)cudaErrorInvalidValue;
  const int E = a->n_embd, H = a->n_head;
  const bool int4 = a->k_kind == 4 || a->v_kind == 4;
  if (!rows_ok(a->batch, a->rows, a->k_kind, a->v_kind, quant, a->ks, a->vs) || H <= 0 ||
      E % H || E % 128 || a->capacity <= 0 || a->capacity > 8192 || a->lm_blocks <= 0 ||
      (int4 && (E / 2) % (E / H)) || !gpt2_tier_ok(*a))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->dtype == 0) return gpt2_verify<float>(*a, st);
  if (a->dtype == 1) return gpt2_verify<__nv_bfloat16>(*a, st);
  return (int)cudaErrorInvalidValue;
}

int run_llama(const LlamaBatchVerifyArgs* a, void* stream, bool quant) {
  if (a == nullptr) return (int)cudaErrorInvalidValue;
  const int D = a->head_dim, Hq = a->n_head, Hkv = a->n_kv_head;
  const bool int4 = a->k_kind == 4 || a->v_kind == 4;
  // 16-byte weight rows need widths that are multiples of 8 values
  if (!rows_ok(a->batch, a->rows, a->k_kind, a->v_kind, quant, a->ks, a->vs) ||
      (D != 64 && D != 128) || Hkv <= 0 || Hq % Hkv || a->n_embd % 8 || a->inter % 8 ||
      a->capacity <= 0 || a->capacity > 8192 || a->lm_blocks <= 0 || a->n_pos <= 0 ||
      !a->cos || !a->sin || (int4 && (Hkv * D / 2) % D) || !llama_tier_ok(*a))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->dtype == 0) return llama_verify<float>(*a, st);
  if (a->dtype == 1) return llama_verify<__nv_bfloat16>(*a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int elit_gpt2_megabatch_verify(const Gpt2BatchVerifyArgs* a, void* stream) {
  return run_gpt2(a, stream, false);
}

extern "C" int elit_gpt2_megabatch_verify_quant(const Gpt2BatchVerifyArgs* a, void* stream) {
  return run_gpt2(a, stream, true);
}

extern "C" int elit_llama_megabatch_verify(const LlamaBatchVerifyArgs* a, void* stream) {
  return run_llama(a, stream, false);
}

extern "C" int elit_llama_megabatch_verify_quant(const LlamaBatchVerifyArgs* a, void* stream) {
  return run_llama(a, stream, true);
}

extern "C" const char* elit_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
