// The speculative verify pass of Llama/Qwen (greedy, one sequence, 1 <= R
// <= 8 verify rows) as a fixed chain of kernels (GPT-2's is one persistent
// kernel of its own, gpt2_megaverify.cu).
//
// Replaces efficient_llm_inference_tpu/ops/pallas/megakernel_llama.py:
// llama_megaverify (the R > 1 form of _llama_megapass), the TPU's k-row
// verify program. Entry point: elit_llama_megaverify (KV panes in the model
// dtype). Row t carries the t-th verify token at position cur + t (cur =
// *length, read on the device). It launches, on the stream it is given:
//
//   embed                  one block per row: x[t] from x_emb[t] or tok_in[t]
//   per layer l:
//     gemv  RMSNorm -> qkv every weight row read once for all R rows
//     write                one block per row: row cur + t of the layer's
//                          panes, its k rotated at min(cur + t, P-1); nothing
//                          at or past capacity
//     attention            split-KV (split_attention.cuh's staged verify
//                          item): a block a (K/V head, split) for the group's
//                          query heads of all R rows, the split's K and V rows
//                          staged once for them; row t over the pane rows c <
//                          cur + t (the cache and the verify rows j < t, just
//                          written), its own k / v merged by the last split of
//                          the head: the JAX kernel's in-block causal set
//     gemv  o-proj + x     residual add in place
//     gemv  RMSNorm -> MLP SwiGLU over interleaved (gate, up) rows
//     gemv  down + x       residual add in place
//   gemv  RMSNorm -> head  per-block, per-row (max, argmax) partials
//   argmax                 one block per row -> tok_out[t]; the cache length
//                          is not advanced (the caller keeps the accepted rows)
//
// 6 L + 3 kernels, every one launched with programmatic dependent launch, so
// each starts while the one before it ends and a GEMV's first weight stages
// are in flight before its griddepcontrol.wait.
//
// Bound: bytes. A verify pass reads every weight once for all R rows, the
// stream of one decode step (Llama-3.2-1B in bf16: 2.47 GB, 0.74 ms at 3.35
// TB/s), plus the visible K/V rows, so R tokens are checked for about one
// step while the weights dominate. The design:
//   - bf16: every GEMV is gemv_stream_tc.cuh's persistent tensor-core
//     stream, the batched step's (megabatch.cu), with the R rows as its slots:
//     one launch a GEMV for all R rows (one n8 tile), the weights streamed
//     once, the K split a function of the weight's shape alone, so a row's
//     sums do not depend on R or on the rows beside it;
//   - fp32 (the holding dtype): gemv_batch.cuh's CUDA-core GEMVs (the R input
//     rows staged in shared memory, every 16-byte weight chunk applied to all
//     R rows from registers);
//   - the attention reads the one pane once for all R rows and a GQA group's
//     query heads, where the chain before it ran a block a (query head, row),
//     re-reading the cache rows for each; its plan (splits of the capacity)
//     is a function of (C, the heads, the SM count), so row t's bits depend
//     on its own length alone.
//
// Weight tiers (the JAX kernel's "wscale" / "w4scale" modes,
// ops/pallas/megakernel_llama.py:763-790): with w_kind 8 or 4 every GEMV
// (q|k|v, o, gate|up, down and the LM head, the quantized copy `head`)
// streams int8 or grouped-int4 codes (gemv_stream_tc.cuh's and
// gemv_batch.cuh's tiers). Bound: the codes and scales once for all R rows.
//
// Numerics: per row, the single-stream chain's rounding points
// (megastep_common.cuh), the attention's as split_attention.cuh states them.
//
// C interface (ctypes): elit_llama_megaverify takes its args struct
// (mirrored by ops/megakernel_llama.py's LlamaVerifyArgs: the single-stream
// LlamaArgs with `rows` first and the weight tier last, then the split
// attention's plan and scratch, then the bf16 GEMVs' scratch) and a stream,
// checks the first error of each launch with cudaGetLastError() and returns
// it (0 = success); elit_cuda_error_string names a code,
// elit_megaverify_kernels counts the kernels launched. length is [1],
// tok_in and tok_out [R], x_emb [R, E], the panes [L, C, W], the workspace
// [R, width], lm_val/lm_idx [R, lm_blocks], attn_part [R, Hq, splits, D +
// 2], attn_count [Hkv] zeroed.

#include "gemv_stream_tc.cuh"
#include "split_attention.cuh"

namespace {
constexpr int kMaxVerifyRows = 8;  // the JAX verify kernels' largest R
}  // namespace

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
  int attn_splits, attn_rows;  // the split attention's plan (ops/megakernel_llama.py verify_plan)
  float* attn_part;            // [R, n_head, splits, D + 2]
  int* attn_count;             // [n_kv_head] zeroed
  float* tc_part;              // bf16: the tensor-core GEMVs' split partials, tc_part_len floats
  long long tc_part_len;
  int* tc_count;               // bf16: tc_count_len zeroed ints, one a tile of the largest split GEMV
  int tc_count_len;
};

namespace {

// ------------------------------------------------------ embedding, argmax

template <typename T>
__global__ void __launch_bounds__(kThreads)
llama_embed_rows(const T* __restrict__ embed, const int* __restrict__ tok_in,
                 const T* __restrict__ x_emb, int E, int V, T* __restrict__ x) {
  pdl_wait();
  pdl_launch_dependents();  // the first GEMV may request its weights
  const int t = blockIdx.x;
  const T* src = x_emb + (size_t)t * E;
  if (tok_in != nullptr) src = embed + (size_t)min(max(tok_in[t], 0), V - 1) * E;
  for (int e = threadIdx.x; e < E; e += kThreads) x[(size_t)t * E + e] = src[e];
}

__global__ void __launch_bounds__(kThreads)
argmax_rows_kernel(const float* __restrict__ part_val, const int* __restrict__ part_idx, int n,
                   int V, int* __restrict__ tok_out) {
  pdl_wait();
  pdl_launch_dependents();
  const int t = blockIdx.x;
  argmax_block(part_val + (size_t)t * n, part_idx + (size_t)t * n, n, V, 0, tok_out + t,
               nullptr);
}

// ------------------------------------------------ the Llama/Qwen attention

// Block t writes row cur + t of the layer's panes (its k rotated at min(cur +
// t, P - 1) into shared memory first); nothing at or past capacity.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
verify_rows_write_kernel(const AttnParams p, int qkv_stride) {
  extern __shared__ float sm[];  // the rotated k row
  __shared__ float red[kWarps];
  pdl_wait();
  pdl_launch_dependents();  // the attention's blocks may launch
  const int t = blockIdx.x, row = *p.length + t, KW = p.kv_width;
  if (row < 0 || row >= p.capacity) return;
  const T* kc = static_cast<const T*>(p.qkv) + (size_t)t * qkv_stride + p.q_width;
  const int pos = min(row, p.n_pos - 1);
  for (int e = threadIdx.x; e < KW; e += kThreads)
    sm[e] = head_value<T>(kc + (e / D) * D, e % D, D, p.cos + (size_t)pos * D,
                          p.sin + (size_t)pos * D);
  __syncthreads();
  write_row<T, 0>(sm, p.k, nullptr, row, KW, 0.0f, red);
  write_row<T, 0>(kc + KW, p.v, nullptr, row, KW, 0.0f, red);
}

// Block b < n_kv * splits: split_attention.cuh's staged verify item b (a
// K/V head and split for the group's query heads of all R rows).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) verify_split_kernel(const VerifyAttn va) {
  extern __shared__ float sm[];
  verify_attention_item_staged<T, D>(va, blockIdx.x, sm, [&] {
    pdl_wait();
    pdl_launch_dependents();  // the o-projection may request its weights
    return *va.a.p.length;
  });
}

template <typename T, int D>
int launch_verify_split_d(const VerifyAttn& va, cudaStream_t st) {
  const AttnParams& p = va.a.p;
  RETURN_IF(launch_pdl(verify_rows_write_kernel<T, D>, va.R, sizeof(float) * p.kv_width, st, p,
                       va.qkv_stride));
  const size_t smem = sizeof(float) * verify_staged_floats(p.group, va.R, D, va.a.rows);
  auto kernel = verify_split_kernel<T, D>;
  RETURN_IF(allow_smem(kernel, smem));
  return launch_pdl(kernel, va.a.n_kv * va.a.splits, smem, st, va);
}

// Layer l's attention of the Llama/Qwen verify: the R new rows written,
// then the split items (two launches, both with programmatic dependent
// launch).
template <typename T>
int llama_verify_attention(const LlamaVerifyArgs& a, int l, cudaStream_t st) {
  const int D = a.head_dim, QW = a.n_head * D, KW = a.n_kv_head * D, C = a.capacity;
  VerifyAttn va{};
  AttnParams& ap = va.a.p;
  ap.qkv = a.qkv;
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
  ap.out = a.attn;
  va.a.n_kv = a.n_kv_head;
  va.a.splits = a.attn_splits;
  va.a.rows = a.attn_rows;
  va.a.part = a.attn_part;
  va.a.count = a.attn_count;
  va.R = a.rows;
  va.qkv_stride = QW + 2 * KW;
  va.out_stride = QW;
  if (D == 64) return launch_verify_split_d<T, 64>(va, st);
  if (D == 128) return launch_verify_split_d<T, 128>(va, st);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------------ chains

// The fp32 Llama/Qwen chain: gemv_batch.cuh's GEMVs (a launch a GEMV, R <=
// 8 rows a group), the verify attention.
int llama_verify_f32(const LlamaVerifyArgs& a, cudaStream_t st) {
  using T = float;
  const int L = a.n_layer, E = a.n_embd, I = a.inter, V = a.vocab, D = a.head_dim;
  const int R = a.rows;
  const int QW = a.n_head * D, KW = a.n_kv_head * D, NQKV = QW + 2 * KW;
  auto weight = [&](const void* w, const void* s, int l, int n, int k) {
    return weight_at<T>(w, s, a.w_kind, a.w_group, (size_t)l * n, k);
  };
  T* x = static_cast<T*>(a.x);
  T* qkv = static_cast<T*>(a.qkv);
  T* attn = static_cast<T*>(a.attn);
  T* ffn = static_cast<T*>(a.ffn);

  RETURN_IF(launch_pdl(llama_embed_rows<T>, R, 0, st, static_cast<const T*>(a.embed), a.tok_in,
                       static_cast<const T*>(a.x_emb), E, V, x));
  for (int l = 0; l < L; ++l) {
    const float* nm = a.norms + (size_t)l * 2 * E;
    RETURN_IF((gemv_batch<T, PRO_RMS, EPI_STORE, 1>(
        weight(a.qkv_w, a.qkv_s, l, NQKV, E), NQKV, E, R, x, nm, nullptr, a.rms_eps,
        a.qkvb ? a.qkvb + (size_t)l * NQKV : nullptr, qkv, nullptr, nullptr, 0, nullptr, st)));
    RETURN_IF(llama_verify_attention<T>(a, l, st));
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
  RETURN_IF(launch_pdl(argmax_rows_kernel, R, 0, st, static_cast<const float*>(a.lm_val),
                       static_cast<const int*>(a.lm_idx), lm_grid, V, a.tok_out));
  return 0;
}

// The bf16 Llama/Qwen chain: every GEMV one launch of gemv_stream_tc.cuh
// for all R rows (the rows as its slots), every kernel launched with
// programmatic dependent launch.
int llama_verify_tc(const LlamaVerifyArgs& a, cudaStream_t st) {
  using T = __nv_bfloat16;
  const int L = a.n_layer, E = a.n_embd, I = a.inter, V = a.vocab, D = a.head_dim;
  const int R = a.rows;
  const int QW = a.n_head * D, KW = a.n_kv_head * D, NQKV = QW + 2 * KW;
  auto weight = [&](const void* w, const void* s, int l, int n, int k) {
    return weight_at<T>(w, s, a.w_kind, a.w_group, (size_t)l * n, k);
  };
  const stc::Scratch sc{a.tc_part, a.tc_part_len, a.tc_count, a.tc_count_len};
  T* x = static_cast<T*>(a.x);
  T* qkv = static_cast<T*>(a.qkv);
  T* attn = static_cast<T*>(a.attn);
  T* ffn = static_cast<T*>(a.ffn);

  RETURN_IF(launch_pdl(llama_embed_rows<T>, R, 0, st, static_cast<const T*>(a.embed), a.tok_in,
                       static_cast<const T*>(a.x_emb), E, V, x));
  for (int l = 0; l < L; ++l) {
    const float* nm = a.norms + (size_t)l * 2 * E;
    RETURN_IF((stc::gemv<PRO_RMS, EPI_STORE>(
        weight(a.qkv_w, a.qkv_s, l, NQKV, E), NQKV, E, R, x, nm, a.rms_eps,
        a.qkvb ? a.qkvb + (size_t)l * NQKV : nullptr, qkv, sc, st)));
    RETURN_IF(llama_verify_attention<T>(a, l, st));
    RETURN_IF((stc::gemv<PRO_VEC, EPI_RESIDUAL>(weight(a.o_w, a.o_s, l, E, QW), E, QW, R, attn,
                                                nullptr, 0.0f, nullptr, x, sc, st)));
    RETURN_IF((stc::gemv<PRO_RMS, EPI_SWIGLU>(weight(a.gu_w, a.gu_s, l, 2 * I, E), 2 * I, E,
                                              R, x, nm + E, a.rms_eps, nullptr, ffn, sc, st)));
    RETURN_IF((stc::gemv<PRO_VEC, EPI_RESIDUAL>(weight(a.down_w, a.down_s, l, E, I), E, I, R,
                                                ffn, nullptr, 0.0f, nullptr, x, sc, st)));
  }
  int lm_grid = 0;
  RETURN_IF((stc::gemv<PRO_RMS, EPI_ARGMAX>(weight(a.head, a.head_s, 0, V, E), V, E, R, x,
                                            a.lnf, a.rms_eps, nullptr, nullptr, sc, st,
                                            a.lm_blocks, a.lm_val, a.lm_idx, &lm_grid)));
  RETURN_IF(launch_pdl(argmax_rows_kernel, R, 0, st, static_cast<const float*>(a.lm_val),
                       static_cast<const int*>(a.lm_idx), lm_grid, V, a.tok_out));
  return 0;
}

int run_llama(const LlamaVerifyArgs* a, void* stream) {
  if (a == nullptr) return (int)cudaErrorInvalidValue;
  const int D = a->head_dim, Hq = a->n_head, Hkv = a->n_kv_head;
  // 16-byte weight rows need widths that are multiples of 8 values
  if (a->k_kind != 0 || a->v_kind != 0 || a->rows < 1 || a->rows > kMaxVerifyRows ||
      (D != 64 && D != 128) || Hkv <= 0 || Hq % Hkv || a->n_embd % 8 || a->inter % 8 ||
      a->capacity <= 0 || a->capacity > 8192 || a->lm_blocks <= 0 || a->n_pos <= 0 ||
      !a->cos || !a->sin || !llama_tier_ok(*a) || a->attn_splits < 1 || a->attn_rows < 1 ||
      (long long)a->attn_splits * a->attn_rows < a->capacity || !a->attn_part ||
      !a->attn_count || (a->dtype == 1 && (!a->tc_part || !a->tc_count)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->dtype == 0) return llama_verify_f32(*a, st);
  if (a->dtype == 1) return llama_verify_tc(*a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int elit_llama_megaverify(const LlamaVerifyArgs* a, void* stream) {
  return run_llama(a, stream);
}

// Kernels the Llama/Qwen verify has launched in this process, counted at
// each launch (launch_pdl, gemv_batch): a pass's count is the difference
// across one pass.
extern "C" long long elit_megaverify_kernels() { return launches_made(); }

extern "C" const char* elit_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
