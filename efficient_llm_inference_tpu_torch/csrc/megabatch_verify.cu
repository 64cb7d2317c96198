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
// w_kind 8 or 4 every GEMV streams int8 or grouped-int4 codes (in bf16
// through gemm_rows_tc.cuh's tiers, in fp32 through gemv_batch.cuh's), the
// LM head from the quantized copy `head`.
//
// GEMVs (the product of every weight with the B x R rows): in bf16 on the
// tensor cores, gemm_rows_tc.cuh's skinny GEMM: each weight tile goes to
// shared memory once per launch and is applied to all B x R <= 256 rows by
// mma.sync m16n8k16, the K split fixed by the weight's shape, so a row's
// tokens do not depend on the slots launched beside it. A norm prologue
// (LN / RMS) runs first as its own small kernel, one warp a row
// (norm_rows_kernel: gemv_batch's statistics and rounding points, the
// normalised row rounded to T into the workspace `xn`); the epilogues
// (bias, GELU, SwiGLU, residual add, the LM head's per-block argmax
// partials) take the fp32 sums from shared memory with megastep_common's
// rounding points. The weight tiers decode their codes once a tile into
// bf16 (int8 / int4 codes are exact in bf16); W_I8 scales the row's sum,
// W_I4 each group's. In fp32 (the card's token-exact oracle) the GEMVs stay
// on gemv_batch.cuh's CUDA-core kernel, launched once per group of 8 rows.
//
// Bound: bytes. At 8 x 8 rows on Llama-3.2-1B the GEMVs do 2 x 1.24 G x 64
// = 158 GFLOP, 0.16 ms at 989 TFLOP/s, against 0.74 ms to read 2.47 GB of
// weights; at 16 x 8 on GPT-2 small 32 GFLOP (0.03 ms) against 0.074 ms.
//
// C interface (ctypes): each entry point takes its args struct (mirrored by
// ops/megakernel_batch_verify.py: the single-stream MegaArgs / LlamaArgs with
// `batch` and rows first, the weight tier, then the tensor-core scratch) and
// a stream, checks the first error of each launch with cudaGetLastError()
// and returns it (0 = success); elit_cuda_error_string names a code. length
// is [B], tok_in and tok_out [B x R], x_emb [B x R, E], the panes [L, B, C,
// W], the scales [L, B, C], the workspace [B x R, width], lm_val/lm_idx
// [B x R, lm_blocks]; in bf16 xn [B x R, E], tc_part tc_part_len floats
// (the largest split GEMV's tcg::part_floats), tc_count tcg::kCounters
// zeroed ints. elit_verify_gemv runs one bf16 GEMV of the chain alone
// (no prologue, stored), for measurement.

#include <type_traits>

#include "gemm_rows_tc.cuh"
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
  void* xn;               // bf16: the normalised rows, [B x R, E]
  float* tc_part;         // bf16: split-K partials, tc_part_len floats
  long long tc_part_len;
  int* tc_count;          // bf16: tcg::kCounters zeroed ints
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
  void* xn;               // bf16: the normalised rows, [B x R, E]
  float* tc_part;         // bf16: split-K partials, tc_part_len floats
  long long tc_part_len;
  int* tc_count;          // bf16: tcg::kCounters zeroed ints
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

// ------------------------------------------------ bf16 GEMVs, tensor cores

// The bf16 chain's GEMV scratch, from its args struct.
struct TcScratch {
  __nv_bfloat16* xn;
  float* part;
  long long part_len;
  int* count;
};

// Row r of in [R, K] normalised (PRO_LN with g, b; PRO_RMS with g) and
// rounded to bf16 into out[r]: one warp a row, with gemv_batch_kernel's
// statistics (lane-strided 16-byte chunks, then a warp sum) and rounding
// points.
template <int PRO>
__global__ void __launch_bounds__(kThreads)
norm_rows_kernel(const __nv_bfloat16* __restrict__ in, int R, int K,
                 const float* __restrict__ g, const float* __restrict__ b, float eps,
                 __nv_bfloat16* __restrict__ out) {
  using T = __nv_bfloat16;
  constexpr int VN = Vec<T>::N;
  const int lane = threadIdx.x & 31, r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;
  const uint4* xr = reinterpret_cast<const uint4*>(in + (size_t)r * K);
  float s = 0.0f;
  for (int c = lane; c < K / VN; c += 32) {
    float v[VN];
    unpack16(xr[c], v);
#pragma unroll
    for (int i = 0; i < VN; ++i) s += PRO == PRO_LN ? v[i] : v[i] * v[i];
  }
  s = warp_sum(s);
  float mean = 0.0f, rstd;
  if (PRO == PRO_LN) {
    mean = s / (float)K;
    float s2 = 0.0f;
    for (int c = lane; c < K / VN; c += 32) {
      float v[VN];
      unpack16(xr[c], v);
#pragma unroll
      for (int i = 0; i < VN; ++i) s2 += (v[i] - mean) * (v[i] - mean);
    }
    rstd = rsqrtf(warp_sum(s2) / (float)K + eps);
  } else {
    rstd = rsqrtf(s / (float)K + eps);
  }
  uint4* o = reinterpret_cast<uint4*>(out + (size_t)r * K);
  for (int c = lane; c < K / VN; c += 32) {
    float v[VN];
    unpack16(xr[c], v);
    const int e = c * VN;
#pragma unroll
    for (int i = 0; i < VN; ++i) {
      if (PRO == PRO_LN)
        v[i] = (v[i] - mean) * rstd * g[e + i] + b[e + i];
      else
        v[i] = round_to<T>(v[i] * rstd) * round_to<T>(g[e + i]);
    }
    o[c] = pack16<T>(v);  // rounds to T
  }
}

// The chain's epilogues (an EPI_* `kind`) over a tile's fp32 sums, with
// gemv_batch_kernel's rounding points; EPI_ARGMAX keeps thread r's running
// (max, argmax) of input row r over the block's tiles, written by finish().
struct VerifyEpi {
  int kind;
  const float* bias;
  __nv_bfloat16* out;
  float* part_val;
  int* part_idx;
  float best;
  int best_idx;

  __device__ void apply(const float* ys, int ldy, int n0, int N, int R) {
    using T = __nv_bfloat16;
    constexpr int BM = tcg::BM;
    const int t = threadIdx.x;
    if (kind == EPI_ARGMAX) {  // warp w scans rows w, w + 8, ...; thread r keeps row r's
      __shared__ float tv[tcg::kMaxRows];
      __shared__ int ti[tcg::kMaxRows];
      const int lane = t & 31;
      for (int r = t >> 5; r < R; r += kWarps) {
        float v = -INFINITY;
        int i = 0;
        for (int m = lane; m < BM && n0 + m < N; m += 32)
          if (better(ys[r * ldy + m], n0 + m, v, i)) {
            v = ys[r * ldy + m];
            i = n0 + m;
          }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, v, o);
          const int oi = __shfl_xor_sync(0xffffffffu, i, o);
          if (better(ov, oi, v, i)) { v = ov; i = oi; }
        }
        if (lane == 0) { tv[r] = v; ti[r] = i; }
      }
      __syncthreads();
      if (t < R && better(tv[t], ti[t], best, best_idx)) {
        best = tv[t];
        best_idx = ti[t];
      }
      __syncthreads();  // tv is the next tile's
      return;
    }
    if (kind == EPI_SWIGLU) {  // rows 2j, 2j + 1: output j's gate and up
      for (int i = t; i < R * (BM / 2); i += tcg::kThreads) {
        const int r = i / (BM / 2), j = i - r * (BM / 2), o = n0 + 2 * j;
        if (o + 1 < N) {
          const float gate = round_to<T>(silu(ys[r * ldy + 2 * j]));
          const float up = round_to<T>(ys[r * ldy + 2 * j + 1]);
          out[(size_t)r * (N / 2) + o / 2] = from_f32<T>(gate * up);
        }
      }
      return;
    }
    for (int i = t; i < R * BM; i += tcg::kThreads) {
      const int r = i / BM, m = i - r * BM, o = n0 + m;
      if (o >= N) continue;
      const float y = ys[r * ldy + m] + (bias != nullptr ? bias[o] : 0.0f);
      T* ob = out + (size_t)r * N + o;
      if (kind == EPI_STORE)
        *ob = from_f32<T>(y);
      else if (kind == EPI_GELU)
        *ob = from_f32<T>(gelu_tanh(y));
      else  // EPI_RESIDUAL, in place
        *ob = from_f32<T>(to_f32(*ob) + round_to<T>(y));
    }
  }

  __device__ void finish(int R) {
    if (kind == EPI_ARGMAX && (int)threadIdx.x < R) {
      part_val[(size_t)threadIdx.x * gridDim.x + blockIdx.x] = best;
      part_idx[(size_t)threadIdx.x * gridDim.x + blockIdx.x] = best_idx;
    }
  }

  // the epilogue of rows r0.. of a product launched in row groups
  VerifyEpi shifted(int r0, int N, int grid) const {
    VerifyEpi e = *this;
    if (out != nullptr) e.out += (size_t)r0 * (kind == EPI_SWIGLU ? N / 2 : N);
    if (part_val != nullptr) {
      e.part_val += (size_t)r0 * grid;
      e.part_idx += (size_t)r0 * grid;
    }
    return e;
  }
};

// One bf16 GEMV of the chain on the tensor cores: the norm prologue into
// sc.xn (PRO_LN / PRO_RMS), then the product with weight `w`'s tier.
int tc_gemv(const WeightRef& w, int N, int K, int R, const __nv_bfloat16* in, int pro,
            const float* g, const float* beta, float eps, const VerifyEpi& epi,
            const TcScratch& sc, int max_grid, int* grid_used, cudaStream_t st) {
  const __nv_bfloat16* x = in;
  if (pro != PRO_VEC) {
    if (sc.xn == nullptr) return (int)cudaErrorInvalidValue;
    const int grid = cdiv(R, kWarps);
    if (pro == PRO_LN)
      norm_rows_kernel<PRO_LN><<<grid, kThreads, 0, st>>>(in, R, K, g, beta, eps, sc.xn);
    else
      norm_rows_kernel<PRO_RMS><<<grid, kThreads, 0, st>>>(in, R, K, g, beta, eps, sc.xn);
    LAUNCH_CHECK();
    x = sc.xn;
  }
  const tcg::Gemm gm{w.w, w.s, w.group, N, K, R, x, 1, 1, 1, sc.part, sc.count};
  if (w.kind == W_T)
    return tcg::gemm_rows<tcg::LAYOUT_NK, W_T>(gm, sc.part_len, max_grid, grid_used, epi, st);
  if (w.kind == W_I8)
    return tcg::gemm_rows<tcg::LAYOUT_NK, W_I8>(gm, sc.part_len, max_grid, grid_used, epi, st);
  if (w.kind == W_I4)
    return tcg::gemm_rows<tcg::LAYOUT_NK, W_I4>(gm, sc.part_len, max_grid, grid_used, epi, st);
  return (int)cudaErrorInvalidValue;
}

// The chain's GEMV: bf16 on the tensor cores; fp32 on gemv_batch's CUDA
// cores, a launch per group of 8 rows (KS: its warps a row).
template <typename T, int PRO, int EPI, int KS>
int verify_gemv(const WeightRef& w, int N, int K, int B, const T* in, const float* g,
                const float* beta, float eps, const float* bias, T* out, float* pv, int* pi,
                int max_grid, int* grid_used, const TcScratch& sc, cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value)
    return gemv_batch<T, PRO, EPI, KS>(w, N, K, B, in, g, beta, eps, bias, out, pv, pi,
                                       max_grid, grid_used, st);
  else
    return tc_gemv(w, N, K, B, in, PRO, g, beta, eps,
                   VerifyEpi{EPI, bias, out, pv, pi, -INFINITY, 0}, sc, max_grid, grid_used, st);
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
  const TcScratch sc{static_cast<__nv_bfloat16*>(a.xn), a.tc_part, a.tc_part_len, a.tc_count};

  gpt2_embed_slot_rows<T><<<N, kThreads, 0, st>>>(wte, static_cast<const T*>(a.wpe), a.tok_in,
                                                  static_cast<const T*>(a.x_emb), a.length, R,
                                                  E, V, a.n_pos, x);
  LAUNCH_CHECK();
  for (int l = 0; l < L; ++l) {
    const float* sm = a.smalls + (size_t)l * 13 * E;
    RETURN_IF((verify_gemv<T, PRO_LN, EPI_STORE, 1>(
        weight(a.attn_w, a.attn_s, l, 3 * E, E), 3 * E, E, N, x, sm, sm + E, a.ln_eps, sm + 4 * E,
        qkv, nullptr, nullptr, 0, nullptr, sc, st)));
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
    RETURN_IF((verify_gemv<T, PRO_VEC, EPI_RESIDUAL, 2>(
        weight(a.proj_w, a.proj_s, l, E, E), E, E, N, attn, nullptr, nullptr, 0.0f, sm + 7 * E, x,
        nullptr, nullptr, 0, nullptr, sc, st)));
    RETURN_IF((verify_gemv<T, PRO_LN, EPI_GELU, 1>(
        weight(a.fc_w, a.fc_s, l, 4 * E, E), 4 * E, E, N, x, sm + 2 * E, sm + 3 * E, a.ln_eps,
        sm + 8 * E, ffn, nullptr, nullptr, 0, nullptr, sc, st)));
    RETURN_IF((verify_gemv<T, PRO_VEC, EPI_RESIDUAL, 4>(
        weight(a.fcp_w, a.fcp_s, l, E, 4 * E), E, 4 * E, N, ffn, nullptr, nullptr, 0.0f,
        sm + 12 * E, x, nullptr, nullptr, 0, nullptr, sc, st)));
  }
  const WeightRef head = a.w_kind == W_T ? WeightRef{a.wte, nullptr, W_T, 0}
                                           : weight(a.head, a.head_s, 0, V, E);
  int lm_grid = 0;
  RETURN_IF((verify_gemv<T, PRO_LN, EPI_ARGMAX, 1>(
      head, V, E, N, x, a.lnf, a.lnf + E, a.ln_eps, nullptr, nullptr, a.lm_val, a.lm_idx,
      a.lm_blocks, &lm_grid, sc, st)));
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
  const TcScratch sc{static_cast<__nv_bfloat16*>(a.xn), a.tc_part, a.tc_part_len, a.tc_count};

  llama_embed_slot_rows<T><<<N, kThreads, 0, st>>>(static_cast<const T*>(a.embed), a.tok_in,
                                                   static_cast<const T*>(a.x_emb), E, V, x);
  LAUNCH_CHECK();
  for (int l = 0; l < L; ++l) {
    const float* nm = a.norms + (size_t)l * 2 * E;
    RETURN_IF((verify_gemv<T, PRO_RMS, EPI_STORE, 1>(
        weight(a.qkv_w, a.qkv_s, l, NQKV, E), NQKV, E, N, x, nm, nullptr, a.rms_eps,
        a.qkvb ? a.qkvb + (size_t)l * NQKV : nullptr, qkv, nullptr, nullptr, 0, nullptr, sc,
        st)));
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
    RETURN_IF((verify_gemv<T, PRO_VEC, EPI_RESIDUAL, 2>(
        weight(a.o_w, a.o_s, l, E, QW), E, QW, N, attn, nullptr, nullptr, 0.0f, nullptr, x, nullptr,
        nullptr, 0, nullptr, sc, st)));
    RETURN_IF((verify_gemv<T, PRO_RMS, EPI_SWIGLU, 1>(
        weight(a.gu_w, a.gu_s, l, 2 * I, E), 2 * I, E, N, x, nm + E, nullptr, a.rms_eps, nullptr,
        ffn, nullptr, nullptr, 0, nullptr, sc, st)));
    RETURN_IF((verify_gemv<T, PRO_VEC, EPI_RESIDUAL, 4>(
        weight(a.down_w, a.down_s, l, E, I), E, I, N, ffn, nullptr, nullptr, 0.0f, nullptr, x,
        nullptr, nullptr, 0, nullptr, sc, st)));
  }
  int lm_grid = 0;
  RETURN_IF((verify_gemv<T, PRO_RMS, EPI_ARGMAX, 1>(
      weight(a.head, a.head_s, 0, V, E), V, E, N, x, a.lnf, nullptr, a.rms_eps, nullptr, nullptr,
      a.lm_val, a.lm_idx, a.lm_blocks, &lm_grid, sc, st)));
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
      (int4 && (E / 2) % (E / H)) || !gpt2_tier_ok(*a) ||
      (a->dtype == 1 && (!a->xn || !a->tc_count)))
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
      !a->cos || !a->sin || (int4 && (Hkv * D / 2) % D) || !llama_tier_ok(*a) ||
      (a->dtype == 1 && (!a->xn || !a->tc_count)))
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

// One bf16 GEMV of the chain alone: out [R, N] = bf16(x [R, K] . W[N, K]^T)
// over weight tier w_kind (scales ws, int4 group), no prologue, stored.
extern "C" int elit_verify_gemv(const void* w, const void* ws, int w_kind, int group, int N,
                                int K, int R, const void* x, float* part, long long part_len,
                                int* counters, void* out, void* stream) {
  if (w == nullptr || x == nullptr || out == nullptr || N < 1 || K < 8 || K % 8 ||
      !tier_ok(w_kind, group, w_kind == W_T || ws != nullptr, {K}))
    return (int)cudaErrorInvalidValue;
  const TcScratch sc{nullptr, part, part_len, counters};
  const VerifyEpi epi{EPI_STORE, nullptr, static_cast<__nv_bfloat16*>(out), nullptr, nullptr,
                      -INFINITY, 0};
  return tc_gemv(WeightRef{w, ws, w_kind, group}, N, K, R,
                 static_cast<const __nv_bfloat16*>(x), PRO_VEC, nullptr, nullptr, 0.0f, epi, sc,
                 0, nullptr, static_cast<cudaStream_t>(stream));
}

extern "C" const char* elit_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
