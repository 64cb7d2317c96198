// The speculative verify pass (greedy, one sequence, 1 <= R <= 8 verify
// rows) as a fixed chain of kernels, for GPT-2 and for Llama/Qwen.
//
// Replaces efficient_llm_inference_tpu/ops/pallas/megakernel.py:
// gpt2_megaverify and ops/pallas/megakernel_llama.py: llama_megaverify (the
// R > 1 form of _llama_megapass), the TPU's k-row verify programs. Entry
// points: elit_gpt2_megaverify and elit_llama_megaverify (KV panes in the
// model dtype). Row t carries the t-th verify token at position cur + t
// (cur = *length, read on the device). Each launches, on the stream it is
// given:
//
//   embed                  one block per row: x[t] from x_emb[t] or tok_in[t]
//                          (GPT-2 adds wpe[min(cur + t, P-1)])
//   per layer l:
//     gemv  norm -> qkv    every weight row read once for all R rows
//     write                one block per row: row cur + t of the layer's
//                          panes (Llama: the k row rotated at
//                          min(cur + t, P-1)); nothing at or past capacity
//     attention            grid H x R: block (h, t) attends pane rows
//                          c < cur + t (the cache and verify rows j < t, just
//                          written) with row t's own k/v merged into the
//                          softmax: the in-block causal set
//     gemv  out-proj + x   residual add in place
//     gemv  norm -> MLP    GELU (GPT-2) or SwiGLU (Llama) epilogue
//     gemv  MLP-out + x    residual add in place
//   gemv  norm -> LM head  per-block, per-row (max, argmax) partials
//   argmax                 one block per row -> tok_out[t]; the cache length
//                          is not advanced (the caller keeps the accepted rows)
//
// Bound: bytes. A verify pass reads every weight once for all R rows, the
// same stream as one decode step (GPT-2 small in bf16: 247 MB, 74 us at
// 3.35 TB/s; Llama-3.2-1B: 2.47 GB, 0.74 ms), plus the visible K/V rows, so R
// tokens are checked for about one step while the weights dominate. The
// GEMVs are gemv_batch.cuh's (the static-batch step's: the R input rows
// staged in shared memory, every 16-byte weight chunk applied to all R rows
// from registers); attention is megastep_common.cuh's attention_block with
// per-row views. The chain is 6 L + 3 kernels: the R new rows are written
// before attention reads them, so a row needs no second softmax term per
// earlier verify row. Left for later: tensor cores for the R-row GEMVs,
// merging the writer into the attention launch, the single-stream chain's
// open items.
//
// Weight tiers (the JAX kernels' "wscale" / "w4scale" modes,
// ops/pallas/megakernel.py:714-721, megakernel_llama.py:763-790): with
// w_kind 8 or 4 every GEMV of the chain (q|k|v, proj / o, fc / gate-up,
// fc_proj / down and the LM head, the quantized copy `head`) streams int8
// or grouped-int4 codes through gemv_batch.cuh's tiers, the codes of a
// 16-byte load decoded once for all R rows (weight_tier.cuh); the args end
// with the single-stream structs' tier fields. Bound: the codes and scales
// once for all R rows (GPT-2 small ~124 MB int8, ~64 MB int4 at G = 128).
//
// Numerics: per row, the single-stream chains' rounding points
// (megastep_common.cuh), with fp32 softmax over the cached rows and the
// verify rows j <= t in one softmax (the JAX kernels' in-block causal set;
// the new rows are the model-dtype k/v, or the rotated k, that JAX merges).
//
// C interface (ctypes): each entry point takes its args struct (mirrored by
// ops/megakernel.py's GPT2VerifyArgs and ops/megakernel_llama.py's
// LlamaVerifyArgs: the single-stream MegaArgs / LlamaArgs with `rows` first
// and the weight tier last)
// and a stream, checks the first error of each launch with cudaGetLastError()
// and returns it (0 = success); elit_cuda_error_string names a code. length
// is [1], tok_in and tok_out [R], x_emb [R, E], the panes [L, C, W], the
// workspace [R, width], lm_val/lm_idx [R, lm_blocks].

#include "gemv_batch.cuh"

namespace {
constexpr int kMaxVerifyRows = 8;  // the JAX verify kernels' largest R
}  // namespace

// Mirrored by ops/megakernel.py's GPT2VerifyArgs (ctypes).
struct Gpt2VerifyArgs {
  int rows;
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

// Mirrored by ops/megakernel_llama.py's LlamaVerifyArgs (ctypes).
struct LlamaVerifyArgs {
  int rows;
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

// Row t's view of one layer's attention: its q|k|v and output rows, and the
// length cur + t (held in the block's shared `len`).
template <typename T>
__device__ __forceinline__ void row_view(AttnParams& p, int t, int qkv_stride, int out_stride,
                                         int* len) {
  if (threadIdx.x == 0) *len = *p.length + t;
  __syncthreads();
  p.qkv = static_cast<const T*>(p.qkv) + (size_t)t * qkv_stride;
  p.out = static_cast<T*>(p.out) + (size_t)t * out_stride;
  p.length = len;
}

// Block t writes row cur + t of the layer's panes (attention_block's writer).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
verify_write_kernel(AttnParams p, int qkv_stride, int out_stride) {
  __shared__ int len;
  row_view<T>(p, blockIdx.x, qkv_stride, out_stride, &len);
  attention_block<T, 0, 0, D>(p, p.n_head);
}

// Block (h, t): query head h of row t over pane rows c < cur + t and row t.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
verify_attention_kernel(AttnParams p, int qkv_stride, int out_stride) {
  __shared__ int len;
  row_view<T>(p, blockIdx.y, qkv_stride, out_stride, &len);
  attention_block<T, 0, 0, D>(p, blockIdx.x);
}

template <typename T>
int verify_attention(const AttnParams& p, int R, int head_dim, int qkv_stride, int out_stride,
                     cudaStream_t st) {
  const int rows = p.cos != nullptr && p.kv_width > p.capacity ? p.kv_width : p.capacity;
  const size_t smem = sizeof(float) * (size_t)rows;  // scores; the writer's roped k
  const dim3 grid(p.n_head, R);
  if (head_dim == 64) {
    verify_write_kernel<T, 64><<<R, kThreads, smem, st>>>(p, qkv_stride, out_stride);
    LAUNCH_CHECK();
    verify_attention_kernel<T, 64><<<grid, kThreads, smem, st>>>(p, qkv_stride, out_stride);
  } else if (head_dim == 128) {
    verify_write_kernel<T, 128><<<R, kThreads, smem, st>>>(p, qkv_stride, out_stride);
    LAUNCH_CHECK();
    verify_attention_kernel<T, 128><<<grid, kThreads, smem, st>>>(p, qkv_stride, out_stride);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  LAUNCH_CHECK();
  return 0;
}

// ------------------------------------------------------ embedding, argmax

template <typename T>
__global__ void __launch_bounds__(kThreads)
gpt2_embed_rows(const T* __restrict__ wte, const T* __restrict__ wpe,
                const int* __restrict__ tok_in, const T* __restrict__ x_emb,
                const int* __restrict__ length, int E, int V, int P, T* __restrict__ x) {
  const int t = blockIdx.x;
  T* xt = x + (size_t)t * E;
  if (tok_in == nullptr) {
    for (int e = threadIdx.x; e < E; e += kThreads) xt[e] = x_emb[(size_t)t * E + e];
    return;
  }
  const T* we = wte + (size_t)min(max(tok_in[t], 0), V - 1) * E;
  const T* pe = wpe + (size_t)min(max(*length + t, 0), P - 1) * E;
  for (int e = threadIdx.x; e < E; e += kThreads)
    xt[e] = from_f32<T>(to_f32(we[e]) + to_f32(pe[e]));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
llama_embed_rows(const T* __restrict__ embed, const int* __restrict__ tok_in,
                 const T* __restrict__ x_emb, int E, int V, T* __restrict__ x) {
  const int t = blockIdx.x;
  const T* src = x_emb + (size_t)t * E;
  if (tok_in != nullptr) src = embed + (size_t)min(max(tok_in[t], 0), V - 1) * E;
  for (int e = threadIdx.x; e < E; e += kThreads) x[(size_t)t * E + e] = src[e];
}

__global__ void __launch_bounds__(kThreads)
argmax_rows_kernel(const float* __restrict__ part_val, const int* __restrict__ part_idx, int n,
                   int V, int* __restrict__ tok_out) {
  const int t = blockIdx.x;
  argmax_block(part_val + (size_t)t * n, part_idx + (size_t)t * n, n, V, 0, tok_out + t,
               nullptr);
}

// ------------------------------------------------------------------ chains

template <typename T>
int gpt2_verify(const Gpt2VerifyArgs& a, cudaStream_t st) {
  const int L = a.n_layer, E = a.n_embd, V = a.vocab, R = a.rows, C = a.capacity;
  const T* wte = static_cast<const T*>(a.wte);
  auto weight = [&](const void* w, const void* s, int l, int n, int k) {
    return weight_at<T>(w, s, a.w_kind, a.w_group, (size_t)l * n, k);
  };
  T* x = static_cast<T*>(a.x);
  T* qkv = static_cast<T*>(a.qkv);
  T* attn = static_cast<T*>(a.attn);
  T* ffn = static_cast<T*>(a.ffn);

  gpt2_embed_rows<T><<<R, kThreads, 0, st>>>(wte, static_cast<const T*>(a.wpe), a.tok_in,
                                             static_cast<const T*>(a.x_emb), a.length, E, V,
                                             a.n_pos, x);
  LAUNCH_CHECK();
  for (int l = 0; l < L; ++l) {
    const float* sm = a.smalls + (size_t)l * 13 * E;
    RETURN_IF((gemv_batch<T, PRO_LN, EPI_STORE, 1>(
        weight(a.attn_w, a.attn_s, l, 3 * E, E), 3 * E, E, R, x, sm, sm + E, a.ln_eps, sm + 4 * E,
        qkv, nullptr, nullptr, 0, nullptr, st)));
    AttnParams ap{};
    ap.qkv = qkv;
    ap.k = static_cast<char*>(a.k) + pane_offset(0, sizeof(T), l, C, E);
    ap.v = static_cast<char*>(a.v) + pane_offset(0, sizeof(T), l, C, E);
    ap.length = a.length;
    ap.capacity = C;
    ap.n_head = a.n_head;
    ap.q_width = ap.kv_width = E;
    ap.group = 1;
    ap.sm_scale = 1.0f / sqrtf((float)(E / a.n_head));
    ap.out = attn;
    RETURN_IF(verify_attention<T>(ap, R, E / a.n_head, 3 * E, E, st));
    RETURN_IF((gemv_batch<T, PRO_VEC, EPI_RESIDUAL, 2>(
        weight(a.proj_w, a.proj_s, l, E, E), E, E, R, attn, nullptr, nullptr, 0.0f, sm + 7 * E, x,
        nullptr, nullptr, 0, nullptr, st)));
    RETURN_IF((gemv_batch<T, PRO_LN, EPI_GELU, 1>(
        weight(a.fc_w, a.fc_s, l, 4 * E, E), 4 * E, E, R, x, sm + 2 * E, sm + 3 * E, a.ln_eps,
        sm + 8 * E, ffn, nullptr, nullptr, 0, nullptr, st)));
    RETURN_IF((gemv_batch<T, PRO_VEC, EPI_RESIDUAL, 4>(
        weight(a.fcp_w, a.fcp_s, l, E, 4 * E), E, 4 * E, R, ffn, nullptr, nullptr, 0.0f,
        sm + 12 * E, x, nullptr, nullptr, 0, nullptr, st)));
  }
  const WeightRef head = a.w_kind == W_T ? WeightRef{a.wte, nullptr, W_T, 0}
                                           : weight(a.head, a.head_s, 0, V, E);
  int lm_grid = 0;
  RETURN_IF((gemv_batch<T, PRO_LN, EPI_ARGMAX, 1>(
      head, V, E, R, x, a.lnf, a.lnf + E, a.ln_eps, nullptr, nullptr, a.lm_val, a.lm_idx,
      a.lm_blocks, &lm_grid, st)));
  argmax_rows_kernel<<<R, kThreads, 0, st>>>(a.lm_val, a.lm_idx, lm_grid, V, a.tok_out);
  LAUNCH_CHECK();
  return 0;
}

template <typename T>
int llama_verify(const LlamaVerifyArgs& a, cudaStream_t st) {
  const int L = a.n_layer, E = a.n_embd, I = a.inter, V = a.vocab, D = a.head_dim;
  const int R = a.rows, C = a.capacity;
  const int QW = a.n_head * D, KW = a.n_kv_head * D, NQKV = QW + 2 * KW;
  auto weight = [&](const void* w, const void* s, int l, int n, int k) {
    return weight_at<T>(w, s, a.w_kind, a.w_group, (size_t)l * n, k);
  };
  T* x = static_cast<T*>(a.x);
  T* qkv = static_cast<T*>(a.qkv);
  T* attn = static_cast<T*>(a.attn);
  T* ffn = static_cast<T*>(a.ffn);

  llama_embed_rows<T><<<R, kThreads, 0, st>>>(static_cast<const T*>(a.embed), a.tok_in,
                                              static_cast<const T*>(a.x_emb), E, V, x);
  LAUNCH_CHECK();
  for (int l = 0; l < L; ++l) {
    const float* nm = a.norms + (size_t)l * 2 * E;
    RETURN_IF((gemv_batch<T, PRO_RMS, EPI_STORE, 1>(
        weight(a.qkv_w, a.qkv_s, l, NQKV, E), NQKV, E, R, x, nm, nullptr, a.rms_eps,
        a.qkvb ? a.qkvb + (size_t)l * NQKV : nullptr, qkv, nullptr, nullptr, 0, nullptr, st)));
    AttnParams ap{};
    ap.qkv = qkv;
    ap.k = static_cast<char*>(a.k) + pane_offset(0, sizeof(T), l, C, KW);
    ap.v = static_cast<char*>(a.v) + pane_offset(0, sizeof(T), l, C, KW);
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
    ap.out = attn;
    RETURN_IF(verify_attention<T>(ap, R, D, NQKV, QW, st));
    RETURN_IF((gemv_batch<T, PRO_VEC, EPI_RESIDUAL, 2>(
        weight(a.o_w, a.o_s, l, E, QW), E, QW, R, attn, nullptr, nullptr, 0.0f, nullptr, x, nullptr,
        nullptr, 0, nullptr, st)));
    RETURN_IF((gemv_batch<T, PRO_RMS, EPI_SWIGLU, 1>(
        weight(a.gu_w, a.gu_s, l, 2 * I, E), 2 * I, E, R, x, nm + E, nullptr, a.rms_eps, nullptr,
        ffn, nullptr, nullptr, 0, nullptr, st)));
    RETURN_IF((gemv_batch<T, PRO_VEC, EPI_RESIDUAL, 4>(
        weight(a.down_w, a.down_s, l, E, I), E, I, R, ffn, nullptr, nullptr, 0.0f, nullptr, x,
        nullptr, nullptr, 0, nullptr, st)));
  }
  int lm_grid = 0;
  RETURN_IF((gemv_batch<T, PRO_RMS, EPI_ARGMAX, 1>(
      weight(a.head, a.head_s, 0, V, E), V, E, R, x, a.lnf, nullptr, a.rms_eps, nullptr, nullptr,
      a.lm_val, a.lm_idx, a.lm_blocks, &lm_grid, st)));
  argmax_rows_kernel<<<R, kThreads, 0, st>>>(a.lm_val, a.lm_idx, lm_grid, V, a.tok_out);
  LAUNCH_CHECK();
  return 0;
}

int run_gpt2(const Gpt2VerifyArgs* a, void* stream) {
  if (a == nullptr) return (int)cudaErrorInvalidValue;
  const int E = a->n_embd, H = a->n_head;
  if (a->k_kind != 0 || a->v_kind != 0 || a->rows < 1 || a->rows > kMaxVerifyRows || H <= 0 ||
      E % H || E % 128 || a->capacity <= 0 || a->capacity > 8192 || a->lm_blocks <= 0 ||
      !gpt2_tier_ok(*a))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->dtype == 0) return gpt2_verify<float>(*a, st);
  if (a->dtype == 1) return gpt2_verify<__nv_bfloat16>(*a, st);
  return (int)cudaErrorInvalidValue;
}

int run_llama(const LlamaVerifyArgs* a, void* stream) {
  if (a == nullptr) return (int)cudaErrorInvalidValue;
  const int D = a->head_dim, Hq = a->n_head, Hkv = a->n_kv_head;
  // 16-byte weight rows need widths that are multiples of 8 values
  if (a->k_kind != 0 || a->v_kind != 0 || a->rows < 1 || a->rows > kMaxVerifyRows ||
      (D != 64 && D != 128) || Hkv <= 0 || Hq % Hkv || a->n_embd % 8 || a->inter % 8 ||
      a->capacity <= 0 || a->capacity > 8192 || a->lm_blocks <= 0 || a->n_pos <= 0 ||
      !a->cos || !a->sin || !llama_tier_ok(*a))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->dtype == 0) return llama_verify<float>(*a, st);
  if (a->dtype == 1) return llama_verify<__nv_bfloat16>(*a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int elit_gpt2_megaverify(const Gpt2VerifyArgs* a, void* stream) {
  return run_gpt2(a, stream);
}

extern "C" int elit_llama_megaverify(const LlamaVerifyArgs* a, void* stream) {
  return run_llama(a, stream);
}

extern "C" const char* elit_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
