// One GPT-2 decode step (greedy, batch 1) as ONE persistent kernel.
//
// Replaces efficient_llm_inference_tpu/ops/pallas/megakernel.py:
// gpt2_megastep and ops/pallas/megakernel_quant.py: gpt2_megastep_quant, the
// TPU's whole-step decode programs. Entry points: elit_gpt2_megastep (KV
// panes in the model dtype) and elit_gpt2_megastep_quant (int8, half-split
// int4 or mixed panes with per-token fp32 scales). Each launches one
// cooperative kernel on the stream it is given; every block of it is resident
// at once, and its phases follow one another across grid barriers:
//
//   embed                  every block: x = wte[tok] + wpe[min(length, P-1)]
//                          (or x_emb) for its own LN1; block 0 stores x
//   per layer l:
//     LN1 -> qkv           LN1 (fp32 statistics) in each block, q|k|v out
//     | barrier
//     attention            split-KV: (head, split) items over the blocks,
//                          the current token merged into the softmax by the
//                          last split of each head; one more item writes row
//                          `length` of layer l's panes (quantize-on-write
//                          for quantized panes)
//     | barrier
//     proj + x             out-projection, bias, residual add in place
//     | barrier
//     LN2 -> fc            tanh-GELU epilogue in fp32
//     | barrier
//     fc_proj + x          bias, residual add in place
//     | barrier
//   LNf -> LM head         logits over wte's rows, per-block (max, argmax);
//                          the last block to take a ticket picks the first
//                          maximum -> token; with `advance`, clamps it to
//                          [0, V-1] and adds 1 to length
//
// Bound: bytes. A step reads every weight once: for GPT-2 small in bf16,
// 12 x 9216 x 768 x 2 B of layer weights + 50257 x 768 x 2 B of LM head =
// 247 MB, plus the visible KV rows (~9.8 MB at 319 rows in bf16), so it
// cannot take less than ~77 us at 3.35 TB/s; it does ~2 operations per
// weight byte. What held the chain of 5 L + 3 kernels this replaces at 4.5x
// that bound was not bytes (over int4 weights it streamed a quarter of them
// in the same time) but each kernel's fixed cost, ~5.5 us of launch, ramp-up,
// a layer norm recomputed by every block and drain, while its 1.2-4.7 MB of
// weights take 0.35-1.4 us. The design here:
//   - one launch a step (cudaLaunchAttributeCooperative: a grid that cannot
//     be resident at once is refused, never deadlocked), one block an SM;
//     the engine captures the N steps of a generation in one CUDA graph;
//   - a grid barrier only where data forces one (5 a layer: 60 for GPT-2
//     small): a counter in device memory, each block's thread 0 adding with
//     release semantics and spinning with acquire loads; block 0 adds
//     2^31 - (grid - 1) and the others 1, so the top bit flips when the last
//     block arrives and the low bits come back to zero: the counter needs no
//     reset between launches, graph replays or generations. Activations
//     written by another block (x, q|k|v, the attention and MLP outputs, the
//     partials) are read with ld.global.cg (L1 is not coherent);
//   - the weight stream runs through the barriers: no weight depends on an
//     activation, so each block streams its rows of every GEMV phase, in
//     phase order, through a ring of up to 64 slots in shared memory (~176
//     KB), each slot one tile (16 items in bf16: 24 KB of bf16 weights at
//     E = 768, 12 KB of int8 codes, 6 KB of int4 ones) filled by
//     one 1-D bulk copy completing on the slot's mbarrier, with an L2
//     evict-first policy (the weights are read once a step; the biases,
//     scales, KV rows and activations stay in L2). A consumed tile's slot is
//     refilled at once with the block's next tile, whatever phase it
//     belongs to, so while a block waits at a barrier its next ~176 KB of
//     weights are in flight (~23 MB across the card, ~7 us at 3.35 TB/s).
//     (Refilling a phase's slots together, or while the block waits at the
//     grid barrier, was slower on the card.);
//   - the plan is fixed: an item is E inputs of one weight row (fc_proj's
//     rows of 4E inputs are 4 items, summed in order), block b of g takes
//     rows [b N / g, (b + 1) N / g) of each phase (qkv 3E, proj E, fc 4E,
//     fc_proj E, the LM head's V = 50257 rows), warp w takes items w, w + 8,
//     ... of each tile, and a phase's epilogue runs once its tiles are in;
//   - what a phase needs besides its weights is requested before its
//     prologue (the bias, the int8 row scales and the residual of each
//     thread's rows), staged in shared memory (the int4 group scales, the LM
//     head's scales) or, for the attention, loaded before the barrier (a
//     block's first item's first K/V rows: no row t < length changes);
//   - attention is split over the grid as the Llama chain's
//     (split_attention.cuh; (head, split) items at a plan fixed by the
//     capacity and the head count, ops/megakernel.py `attention_plan`); the
//     last split of a head combines, so the phase needs no extra barrier;
//   - the LM head's argmax takes no barrier: each block writes its (max,
//     argmax) partial and takes a ticket; the last one reduces.
// Sums: lane l of an item's warp adds its chunks l, l + 32, ... in order and
// the lanes combine by a fixed shuffle tree (gemv_stream.cuh's chunk
// arithmetic); a row of fc_proj adds its four items in order. A row's fp32
// sum depends on (K, its tier) alone, never on the grid or the block that
// took the row, and the attention plan does not depend on the grid either:
// a step's bits are the same at every grid size.
//
// Weight tiers (the JAX kernels' "wscale" / "w4scale" modes,
// ops/pallas/megakernel.py:351-358, :470-490): with w_kind 8 the four layer
// weights and the LM head are int8 rows with fp32 per-row scales, with
// w_kind 4 grouped-int4 rows (32 codes a 16-byte chunk) with per-(row,
// group) scales in the model dtype; the tiles stream the codes, decoded in
// registers by weight_tier.cuh. The fc_proj rows span all 4E inputs, so the
// int8 tier applies each row's scale once to the whole sum (JAX scales each
// of the four [E, E] partials by the same column scale). The LM head is
// then the quantized copy `head` [V, E] (exactly V rows); the embedding
// stays on wte. Bound: bytes, as above, of the codes and scales: for GPT-2
// small ~124 MB in int8 (~37 us at 3.35 TB/s) and ~64 MB in int4 at G = 128
// (~19 us); chip_smoke.py computes each from the run's tensors.
//
// Numerics: the JAX kernels' rounding points, as megastep_common.cuh states
// them; the attention's as split_attention.cuh states them.
//
// What the card showed (PERF.md §6 PR 16; scripts/torch_kernel_compare.py
// --single, scripts/torch_gpt2_step_phases.py): the skeleton of the design
// (the weight stream and the 60 barriers, no arithmetic) takes about twice
// the byte bound; each grid barrier costs ~1-2 us and each GEMV phase ~2 us
// of dependent latency (the inputs' L2 round trip, the norm's block
// reductions, a block barrier and a copy's issue a tile), so the step is
// latency-bound, not byte-bound.
//
// C interface (ctypes): both entry points take a Gpt2StepArgs (mirrored by
// ops/megakernel.py's Gpt2StepArgs: MegaArgs, then the grid, the attention
// plan and the launcher's scratch) and a stream, and return the launch's
// error (0 = success); elit_cuda_error_string names a code,
// elit_gpt2_megastep_grid gives the blocks an SM holds for a configuration
// (the launcher's grid is that times the SM count), elit_gpt2_megastep_kernels
// counts the kernels launched, and elit_gpt2_megastep_skeleton launches the
// step's weight stream and barriers alone (no arithmetic: the floor of the
// design, scripts/torch_kernel_compare.py --single). dtype: 0 = float32,
// 1 = bfloat16. k_kind/v_kind: 0 = model dtype, 8 = int8, 4 = half-split
// int4. w_kind: 0 = model dtype, 8 = int8, 4 = grouped int4 (w_group % 32
// == 0, dividing E). head_dim in {64, 128}; E a multiple of 128 up to 2048;
// capacity up to 8192; a grid of at least 4E / 1024 blocks (a block's rows
// of fc at most 1024). A wait longer than 2 s (a lost barrier arrival or
// copy) prints the block and traps rather than hanging the card.

#include <algorithm>

#include "persistent_step.cuh"

namespace {

constexpr int kMaxPer = 8;              // x values a thread holds in a norm: E <= 2048
constexpr int kRowsPer = 4;             // a phase's rows a thread's epilogue takes
constexpr int kHeadPer = 16;            // LM-head scales a thread stages
constexpr int kScaleSlots = kHeadPer * kThreads;  // fp32 scale slots in shared memory

long long g_kernels = 0;  // kernels launched (elit_gpt2_megastep_kernels)

struct StepParams {
  MegaArgs a;
  int grid, splits, rows, slots, tile_bytes;
  int ys_at, s4_at;  // byte offsets in shared memory of the items' sums, the staged scales
  float* part;
  unsigned* sync;
};

// ------------------------------------------------------------- the GEMVs

// Input e of a GEMV in shared memory (gemv_stream.cuh's layout: chunks of
// VN values of T, a quantized tier's padded by 16 bytes).
template <typename T, int WK>
__device__ __forceinline__ int in_at(int e) {
  constexpr int VN = StreamIn<T, WK>::VN, ST = StreamIn<T, WK>::STRIDE;
  return (e / VN) * ST + e % VN;
}

// LayerNorm of E values x[e] = src(e) into h (fp32 statistics, the output
// rounded to T: megastep_common.cuh's PRO_LN).
template <typename T, int WK, typename Src>
__device__ __forceinline__ void norm_to_h(T* h, Src src, int E, const float* g, const float* b,
                                          float eps, float* red) {
  const int tid = threadIdx.x;
  float v[kMaxPer];
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j) {
    const int e = tid + j * kThreads;
    v[j] = e < E ? src(e) : 0.0f;
    s += v[j];
  }
  const float mean = block_sum(s, red) / (float)E;
  float s2 = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j) {
    const int e = tid + j * kThreads;
    const float d = v[j] - mean;
    if (e < E) s2 += d * d;
  }
  const float r = rsqrtf(block_sum(s2, red) / (float)E + eps);
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j) {
    const int e = tid + j * kThreads;
    if (e < E) h[in_at<T, WK>(e)] = from_f32<T>((v[j] - mean) * r * g[e] + b[e]);
  }
  __syncthreads();
}

// The K values of `in` (written by other blocks) into h, 16 bytes a load.
template <typename T, int WK>
__device__ __forceinline__ void vec_to_h(T* h, const T* in, int K) {
  constexpr int PE = 16 / (int)sizeof(T);
  const uint4* src = reinterpret_cast<const uint4*>(in);
  for (int p = threadIdx.x; p < K / PE; p += kThreads)
    *reinterpret_cast<uint4*>(h + in_at<T, WK>(p * PE)) = __ldcg(src + p);
  __syncthreads();
}

// The epilogue's inputs of one thread's rows t, t + kThreads, ... of a
// block's share of a layer's GEMV phase (at most kRowsPer rows a thread:
// 1024 a block), and one slot a row of its int4 group scales. Requested
// before the phase's prologue, so their latency hides behind it.
struct RowInputs {
  float bias[kRowsPer], scale[kRowsPer], pre[kRowsPer], s4[kRowsPer];
};

template <typename T, int WK, int EPI>
__device__ __forceinline__ RowInputs request_rows(const Stream<T, WK>& S, int kind, int l,
                                                  const void* scales, const float* bias,
                                                  const T* out) {
  const MegaArgs& a = *S.a;
  const PhasePlan& ph = S.plan[kind];
  const int E = a.n_embd, N = kind_rows(kind, E, a.vocab), ks = kind_split(kind);
  const int rows = ph.items / ks, ng = WK == W_I4 ? ks * E / a.w_group : 1;
  const size_t srow = (size_t)l * N + ph.r0;  // the block's first scale row
  RowInputs r;
#pragma unroll
  for (int j = 0; j < kRowsPer; ++j) {
    const int row = threadIdx.x + j * kThreads, o = ph.r0 + row;
    const bool in = row < rows;
    r.bias[j] = in ? bias[o] : 0.0f;
    r.scale[j] = WK == W_I8 && in ? static_cast<const float*>(scales)[srow + row] : 1.0f;
    r.pre[j] = EPI == E_RESIDUAL && in ? ldcg_f32(out + o) : 0.0f;
    r.s4[j] = WK == W_I4 && row < rows * ng
                  ? to_f32(static_cast<const T*>(scales)[srow * ng + row])
                  : 0.0f;
  }
  return r;
}

// One GEMV phase of `kind` in layer l over the inputs in h: each tile of
// the block's rows as it arrives, warp w its item w, the item's sum into
// ys; then, once all of them are in, each thread's rows' epilogue (a row of
// fc_proj adds its four items in order). The int4 group scales of the
// block's rows come from s4s (shared memory), where they fit.
template <typename T, int WK, int EPI>
__device__ __forceinline__ void gemv_phase(Stream<T, WK>& S, const T* h, int kind, int l,
                                           const void* scales, const RowInputs& r, T* out,
                                           float* ys, float* s4s) {
  constexpr int VN = StreamIn<T, WK>::VN, ST = StreamIn<T, WK>::STRIDE;
  constexpr int WI = Tile<T, WK>::per_warp, TI = Tile<T, WK>::items;
  const MegaArgs& a = *S.a;
  const PhasePlan& ph = S.plan[kind];
  const int E = a.n_embd, N = kind_rows(kind, E, a.vocab), ks = kind_split(kind), K = ks * E;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cps = item_bytes<T, WK>(E) / 16;  // chunks an item
  const int r0 = ph.r0, items = ph.items, rows = items / ks;
  const int ng = WK == W_I4 ? K / a.w_group : 1;
  const float chunk_to_group = WK == W_I4 ? (float)VN / (float)a.w_group : 0.0f;
  const T* s4 = static_cast<const T*>(scales) + (size_t)l * N * ng;
  const bool staged = rows * ng <= kRowsPer * kThreads;
  if (WK == W_I4) {
    if (staged) {
#pragma unroll
      for (int j = 0; j < kRowsPer; ++j)
        if (tid + j * kThreads < rows * ng) s4s[tid + j * kThreads] = r.s4[j];
    }
    __syncthreads();
  }
  const int q = warp % ks;  // the part of its row each item of this warp is
  for (int t = 0; t < ph.tiles; ++t) {
    const uint4* w = reinterpret_cast<const uint4*>(S.next());
    int row[WI];  // -1: no item
    float acc[WI];
#pragma unroll
    for (int u = 0; u < WI; ++u) {
      const int i = t * TI + u * kWarps + warp;
      row[u] = i < items ? r0 + i / ks : -1;
      acc[u] = 0.0f;
    }
    for (int c = lane; c < cps; c += 32) {
      const int cg = q * cps + c;  // the chunk's place in the row
      float in[VN];
      load_inputs<T, VN>(h + (size_t)cg * ST, in);
      const int grp = WK == W_I4 ? chunk_group(cg, chunk_to_group) : 0;
#pragma unroll
      for (int u = 0; u < WI; ++u) {
        if (row[u] < 0) continue;
        float gs = 0.0f;
        if (WK == W_I4)
          gs = staged ? s4s[(row[u] - r0) * ng + grp] : to_f32(s4[(size_t)row[u] * ng + grp]);
        acc[u] = chunk_acc<T, WK>(w[(u * kWarps + warp) * cps + c], in, gs, acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < WI; ++u) {
      if (row[u] < 0) continue;
      const float y = warp_sum(acc[u]);
      if (lane == 0) ys[t * TI + u * kWarps + warp] = y;
    }
    S.consumed();  // after the last tile: every item's sum is in ys
  }
#pragma unroll
  for (int j = 0; j < kRowsPer; ++j) {
    const int row = tid + j * kThreads;
    if (row >= rows) break;
    float y = 0.0f;
    for (int q = 0; q < ks; ++q) y += ys[row * ks + q];
    const float z = __fmul_rn(y, r.scale[j]) + r.bias[j];
    out[r0 + row] = from_f32<T>(EPI == E_GELU       ? gelu_tanh(z)
                                : EPI == E_RESIDUAL ? r.pre[j] + round_to<T>(z)
                                                    : z);
  }
}

// The scales of a block's LM-head rows (int8: one a row; int4: one a row
// and group), kHeadPer a thread, requested before the head's prologue; n:
// how many there are.
template <typename T, int WK>
__device__ __forceinline__ int request_head_scales(const Stream<T, WK>& S,
                                                   float (&hs)[kHeadPer]) {
  const MegaArgs& a = *S.a;
  const PhasePlan& ph = S.plan[K_HEAD];
  const int ng = WK == W_I4 ? a.n_embd / a.w_group : 1, n = ph.items * ng;
#pragma unroll
  for (int j = 0; j < kHeadPer; ++j) {
    const int e = threadIdx.x + j * kThreads;
    hs[j] = WK == W_I8 && e < n   ? static_cast<const float*>(a.head_s)[ph.r0 + e]
            : WK == W_I4 && e < n ? to_f32(static_cast<const T*>(a.head_s)[(size_t)ph.r0 * ng + e])
                                  : 0.0f;
  }
  return n;
}

// The LM head's phase over the inputs in h: each tile as it arrives, warp w
// its row w, the first maximum of the block's rows kept by each warp's lane
// 0 in (bv, bi) (the int8 row scale applied before the compare); each
// tile's slot refilled at once. The block's scales (request_head_scales)
// are read from s4s where they fit.
template <typename T, int WK>
__device__ __forceinline__ void head_phase(Stream<T, WK>& S, const T* h,
                                           const float (&hs)[kHeadPer], int n_scales, float* s4s,
                                           float& bv, int& bi) {
  constexpr int VN = StreamIn<T, WK>::VN, ST = StreamIn<T, WK>::STRIDE;
  constexpr int WI = Tile<T, WK>::per_warp, TI = Tile<T, WK>::items;
  const MegaArgs& a = *S.a;
  const PhasePlan& ph = S.plan[K_HEAD];
  const int E = a.n_embd, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cps = item_bytes<T, WK>(E) / 16;
  const int ng = WK == W_I4 ? E / a.w_group : 1;
  const float chunk_to_group = WK == W_I4 ? (float)VN / (float)a.w_group : 0.0f;
  const float* s8 = static_cast<const float*>(a.head_s);
  const T* s4 = static_cast<const T*>(a.head_s);
  const bool staged = n_scales <= kHeadPer * kThreads;
  if (WK != W_T) {
    if (staged) {
#pragma unroll
      for (int j = 0; j < kHeadPer; ++j)
        if (threadIdx.x + j * kThreads < n_scales) s4s[threadIdx.x + j * kThreads] = hs[j];
    }
    __syncthreads();
  }
  for (int t = 0; t < ph.tiles; ++t) {
    int it[WI];  // the warp's items of the tile, -1: none
    float sc[WI], acc[WI];
#pragma unroll
    for (int u = 0; u < WI; ++u) {
      const int i = t * TI + u * kWarps + warp;
      it[u] = i < ph.items ? i : -1;
      sc[u] = WK == W_I8 && it[u] >= 0 && lane == 0 ? (staged ? s4s[i] : s8[ph.r0 + i]) : 1.0f;
      acc[u] = 0.0f;
    }
    const uint4* w = reinterpret_cast<const uint4*>(S.next());
    for (int c = lane; c < cps; c += 32) {
      float in[VN];
      load_inputs<T, VN>(h + (size_t)c * ST, in);
      const int grp = WK == W_I4 ? chunk_group(c, chunk_to_group) : 0;
#pragma unroll
      for (int u = 0; u < WI; ++u) {
        if (it[u] < 0) continue;
        float gs = 0.0f;
        if (WK == W_I4)
          gs = staged ? s4s[it[u] * ng + grp] : to_f32(s4[(size_t)(ph.r0 + it[u]) * ng + grp]);
        acc[u] = chunk_acc<T, WK>(w[(u * kWarps + warp) * cps + c], in, gs, acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < WI; ++u) {
      if (it[u] < 0) continue;
      const float y = __fmul_rn(warp_sum(acc[u]), sc[u]);
      const int row = ph.r0 + it[u];
      if (lane == 0 && better(y, row, bv, bi)) {
        bv = y;
        bi = row;
      }
    }
    S.consumed();
  }
}

// -------------------------------------------------------------- the step

template <typename T, int KK, int VK, int WK, int D, bool SKEL>
__global__ void __launch_bounds__(kThreads, 1)
gpt2_step_kernel(const __grid_constant__ StepParams P) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxSlots];
  __shared__ PhasePlan plan[5];
  __shared__ float red[kWarps];
  __shared__ float bv[kWarps];
  __shared__ int bi[kWarps];
  __shared__ int is_last;
  const MegaArgs& a = P.a;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int E = a.n_embd, L = a.n_layer, C = a.capacity, H = a.n_head;
  // after the ring: the GEMV inputs (or the attention's shared memory), the
  // items' sums, the int4 group scales
  T* h = reinterpret_cast<T*>(smem + (size_t)P.slots * P.tile_bytes);
  float* hf = reinterpret_cast<float*>(h);
  float* ys = reinterpret_cast<float*>(smem + P.ys_at);
  float* s4s = reinterpret_cast<float*>(smem + P.s4_at);
  if (tid == 0) {
    for (int s = 0; s < P.slots; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  Stream<T, WK> S;
  S.init(P.a, P.grid, P.slots, P.tile_bytes, plan, smem,
         full);  // a block barrier: the mbarriers are ready
  S.fill();
  unsigned* bar = P.sync;
  if (SKEL) {  // the weight stream and the barriers alone
    for (int l = 0; l < L; ++l) {
      for (int k = K_QKV; k <= K_FCP; ++k) {
        S.skip(k);
        grid_sync(bar, P.grid);
        if (k == K_QKV) grid_sync(bar, P.grid);  // the attention phase's
      }
    }
    S.skip(K_HEAD);
    return;
  }
  T* x = static_cast<T*>(a.x);
  T* qkv = static_cast<T*>(a.qkv);
  T* attn = static_cast<T*>(a.attn);
  T* ffn = static_cast<T*>(a.ffn);
  const int raw_len = __ldcg(a.length);
  auto x_at = [&](int e) { return ldcg_f32(x + e); };

  for (int l = 0; l < L; ++l) {
    const float* sm = a.smalls + (size_t)l * 13 * E;
    // ---- LN1 -> q|k|v
    RowInputs r = request_rows<T, WK, E_STORE>(S, K_QKV, l, a.attn_s, sm + 4 * E, qkv);
    if (l == 0) {  // the embedding, computed by every block for itself
      const T* xe = static_cast<const T*>(a.x_emb);
      const T* we = nullptr;
      const T* pe = nullptr;
      if (a.tok_in != nullptr) {
        const int tok = min(max(__ldcg(a.tok_in), 0), a.vocab - 1);
        we = static_cast<const T*>(a.wte) + (size_t)tok * E;
        pe = static_cast<const T*>(a.wpe) + (size_t)min(max(raw_len, 0), a.n_pos - 1) * E;
      }
      norm_to_h<T, WK>(h, [&](int e) {
        const float v = xe != nullptr ? ldcg_f32(xe + e)
                                      : round_to<T>(to_f32(we[e]) + to_f32(pe[e]));
        if (blockIdx.x == 0) x[e] = from_f32<T>(v);
        return v;
      }, E, sm, sm + E, a.ln_eps, red);
    } else if (S.plan[K_QKV].tiles > 0) {
      norm_to_h<T, WK>(h, x_at, E, sm, sm + E, a.ln_eps, red);
    }
    gemv_phase<T, WK, E_STORE>(S, h, K_QKV, l, a.attn_s, r, qkv, ys, s4s);
    // ---- attention: (head, split) items, then the new row's writer; the
    // block's first item loads its first pane rows before the barrier
    {
      SplitAttn at{};
      AttnParams& ap = at.p;
      ap.qkv = qkv;
      ap.k = static_cast<char*>(a.k) + pane_offset(a.k_kind, sizeof(T), l, C, E);
      ap.v = static_cast<char*>(a.v) + pane_offset(a.v_kind, sizeof(T), l, C, E);
      ap.ks = a.ks ? a.ks + (size_t)l * C : nullptr;
      ap.vs = a.vs ? a.vs + (size_t)l * C : nullptr;
      ap.length = a.length;
      ap.capacity = C;
      ap.n_head = H;
      ap.q_width = ap.kv_width = E;
      ap.group = 1;
      ap.sm_scale = 1.0f / sqrtf((float)D);
      ap.quant_eps = a.quant_eps;
      ap.out = attn;
      at.n_kv = H;
      at.splits = P.splits;
      at.rows = P.rows;
      at.part = P.part;
      at.count = reinterpret_cast<int*>(P.sync + 2);
      const int n_items = H * P.splits;
      bool met = false;  // the block has passed the qkv phase's barrier
      auto meet = [&] {
        if (!met) grid_sync(bar, P.grid);
        met = true;
        return raw_len;
      };
      for (int item = blockIdx.x; item <= n_items; item += P.grid) {
        if (item < n_items) {
          split_attention_item<T, KK, VK, D, 1>(at, item, hf, meet);
        } else if (meet() >= 0 && raw_len < C) {  // row `length` of the layer's panes
          const T* kc = qkv + E;
          for (int e = tid; e < E; e += kThreads) {
            hf[e] = ldcg_f32(kc + e);
            hf[E + e] = ldcg_f32(kc + E + e);
          }
          __syncthreads();
          write_row<T, KK>(hf, ap.k, ap.ks, raw_len, E, a.quant_eps, red);
          write_row<T, VK>(hf + E, ap.v, ap.vs, raw_len, E, a.quant_eps, red);
        }
        __syncthreads();  // the next item reuses the shared memory
      }
      meet();
    }
    grid_sync(bar, P.grid);
    // ---- proj + x
    r = request_rows<T, WK, E_RESIDUAL>(S, K_PROJ, l, a.proj_s, sm + 7 * E, x);
    if (S.plan[K_PROJ].tiles > 0) vec_to_h<T, WK>(h, attn, E);
    gemv_phase<T, WK, E_RESIDUAL>(S, h, K_PROJ, l, a.proj_s, r, x, ys, s4s);
    grid_sync(bar, P.grid);
    // ---- LN2 -> fc -> GELU
    r = request_rows<T, WK, E_GELU>(S, K_FC, l, a.fc_s, sm + 8 * E, ffn);
    if (S.plan[K_FC].tiles > 0) norm_to_h<T, WK>(h, x_at, E, sm + 2 * E, sm + 3 * E, a.ln_eps, red);
    gemv_phase<T, WK, E_GELU>(S, h, K_FC, l, a.fc_s, r, ffn, ys, s4s);
    grid_sync(bar, P.grid);
    // ---- fc_proj + x
    r = request_rows<T, WK, E_RESIDUAL>(S, K_FCP, l, a.fcp_s, sm + 12 * E, x);
    if (S.plan[K_FCP].tiles > 0) vec_to_h<T, WK>(h, ffn, 4 * E);
    gemv_phase<T, WK, E_RESIDUAL>(S, h, K_FCP, l, a.fcp_s, r, x, ys, s4s);
    grid_sync(bar, P.grid);
  }
  // ---- LNf -> LM head -> this block's (max, argmax)
  float hs[kHeadPer];
  const int n_scales = request_head_scales<T, WK>(S, hs);
  if (S.plan[K_HEAD].tiles > 0) norm_to_h<T, WK>(h, x_at, E, a.lnf, a.lnf + E, a.ln_eps, red);
  float v = -INFINITY;
  int i = 0;
  head_phase<T, WK>(S, h, hs, n_scales, s4s, v, i);
  if (lane == 0) {
    bv[warp] = v;
    bi[warp] = i;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w)
      if (better(bv[w], bi[w], v, i)) { v = bv[w]; i = bi[w]; }
    a.lm_val[blockIdx.x] = v;
    a.lm_idx[blockIdx.x] = i;
    unsigned prev;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(P.sync + 1) : "memory");
    is_last = prev == (unsigned)P.grid - 1;
  }
  __syncthreads();
  if (!is_last) return;
  // the last block: the first maximum over the partials -> the token
  argmax_block(a.lm_val, a.lm_idx, P.grid, a.vocab, a.advance, a.tok_out, a.length);
  if (tid == 0) P.sync[1] = 0;  // the ticket, clean for the next launch
}

// ------------------------------------------------------------------- host

// Shared memory after the ring: fc_proj's 4E inputs in the tier's layout,
// one split item of the attention or the writer's k and v, whichever is
// largest; then the items' sums of a block's largest layer phase; then, for
// a quantized tier, the block's scales of a phase (kScaleSlots fp32).
template <typename T, int WK>
size_t h_bytes(int E, int D, int rows) {
  constexpr int VN = StreamIn<T, WK>::VN, ST = StreamIn<T, WK>::STRIDE;
  const size_t inputs = (size_t)(4 * E / VN) * ST * sizeof(T);
  const size_t attn = split_item_floats(1, D, rows) * sizeof(float);
  const size_t writer = 2 * (size_t)E * sizeof(float);
  return (std::max({inputs, attn, writer}) + 15) / 16 * 16;
}
// The most items a block of `grid` takes in a layer phase, and the least
// grid a launch takes (a block's rows of fc at most kRowsPer * kThreads).
int max_items(int E, int V, int grid) {
  int m = 0;
  for (int k = K_QKV; k <= K_FCP; ++k)
    m = std::max(m, (kind_rows(k, E, V) + grid - 1) / grid * kind_split(k));
  return m;
}
int min_grid(int E) { return (4 * E + kRowsPer * kThreads - 1) / (kRowsPer * kThreads); }

template <typename T, int WK>
void ring_plan(int E, int* slots, int* tile_bytes) {
  *tile_bytes = Tile<T, WK>::items * item_bytes<T, WK>(E);
  *slots = std::min(kMaxSlots, kRingBytes / *tile_bytes);
}

// One configuration's kernel: launched (cooperatively, sa.grid blocks) or,
// with per_sm, its blocks an SM.
struct Launch {
  const Gpt2StepArgs& sa;
  cudaStream_t st;
  int* per_sm;

  template <typename T, int KK, int VK, int WK, int D, bool SKEL = false>
  int run() const {
    const MegaArgs& a = sa.a;
    StepParams P{a, sa.grid, sa.attn_splits, sa.attn_rows, 0, 0, 0, 0, sa.attn_part, sa.sync};
    ring_plan<T, WK>(a.n_embd, &P.slots, &P.tile_bytes);
    if (P.slots < 2) return (int)cudaErrorInvalidValue;
    const size_t ring = (size_t)P.slots * P.tile_bytes;
    P.ys_at = (int)(ring + h_bytes<T, WK>(a.n_embd, D, P.rows));
    // the occupancy query sizes the sums for the least grid: the most
    const int g = per_sm != nullptr ? min_grid(a.n_embd) : P.grid;
    P.s4_at = P.ys_at + (max_items(a.n_embd, a.vocab, g) + 3) / 4 * 16;
    const size_t smem = P.s4_at + (WK != W_T ? kScaleSlots * sizeof(float) : 0);
    auto kernel = gpt2_step_kernel<T, KK, VK, WK, D, SKEL>;
    if (int rc = allow_smem(kernel, smem)) return rc;
    if (per_sm != nullptr)
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, smem);
    const int rc = launch_cooperative(kernel, P.grid, smem, st, P);
    if (rc == 0) ++g_kernels;
    return rc;
  }
};

template <typename T, int KK, int VK, int WK>
int by_head_dim(const Launch& f) {
  const int D = f.sa.a.n_embd / f.sa.a.n_head;
  if (D == 64) return f.run<T, KK, VK, WK, 64>();
  if (D == 128) return f.run<T, KK, VK, WK, 128>();
  return (int)cudaErrorInvalidValue;
}

template <typename T, int KK, int VK>
int by_tier(const Launch& f) {
  const int wk = f.sa.a.w_kind;
  if (wk == W_T) return by_head_dim<T, KK, VK, W_T>(f);
  if (wk == W_I8) return by_head_dim<T, KK, VK, W_I8>(f);
  if (wk == W_I4) return by_head_dim<T, KK, VK, W_I4>(f);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int by_panes(const Launch& f) {
  const int kk = f.sa.a.k_kind, vk = f.sa.a.v_kind;
  if (kk == 0 && vk == 0) return by_tier<T, 0, 0>(f);
  if (kk == 8 && vk == 8) return by_tier<T, 8, 8>(f);
  if (kk == 4 && vk == 4) return by_tier<T, 4, 4>(f);
  if (kk == 8 && vk == 4) return by_tier<T, 8, 4>(f);
  return (int)cudaErrorInvalidValue;
}

int dispatch(const Launch& f) {
  if (f.sa.a.dtype == 0) return by_panes<float>(f);
  if (f.sa.a.dtype == 1) return by_panes<__nv_bfloat16>(f);
  return (int)cudaErrorInvalidValue;
}

// The arguments' checks; `quant`: quantized panes expected. A block's rows
// of a layer phase at most kRowsPer * kThreads (fc: 4E): the least grid.
bool args_ok(const Gpt2StepArgs* sa, bool quant) {
  return sa != nullptr && step_args_ok(sa, quant) && sa->grid >= min_grid(sa->a.n_embd) &&
         sa->a.n_embd <= kMaxPer * kThreads;
}

int run(const Gpt2StepArgs* sa, void* stream, bool quant) {
  if (!args_ok(sa, quant)) return (int)cudaErrorInvalidValue;
  return dispatch(Launch{*sa, static_cast<cudaStream_t>(stream), nullptr});
}

}  // namespace

extern "C" int elit_gpt2_megastep(const Gpt2StepArgs* a, void* stream) {
  return run(a, stream, false);
}

extern "C" int elit_gpt2_megastep_quant(const Gpt2StepArgs* a, void* stream) {
  return run(a, stream, true);
}

// The blocks an SM holds of the kernel the arguments select (*per_sm) and
// the card's SM count (*sms): the launcher's grid is their product.
extern "C" int elit_gpt2_megastep_grid(const Gpt2StepArgs* a, int* per_sm, int* sms) {
  if (a == nullptr || per_sm == nullptr || sms == nullptr) return (int)cudaErrorInvalidValue;
  int dev = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (cudaError_t e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev))
    return (int)e;
  return dispatch(Launch{*a, nullptr, per_sm});
}

// The step's weight stream and barriers without arithmetic (bf16 weights of
// any tier; the arguments of a step, whose outputs it leaves as they are).
extern "C" int elit_gpt2_megastep_skeleton(const Gpt2StepArgs* a, void* stream) {
  if (a == nullptr || a->a.dtype != 1 || a->grid < 1 || a->sync == nullptr)
    return (int)cudaErrorInvalidValue;
  const Launch f{*a, static_cast<cudaStream_t>(stream), nullptr};
  if (a->a.w_kind == W_T) return f.run<__nv_bfloat16, 0, 0, W_T, 64, true>();
  if (a->a.w_kind == W_I8) return f.run<__nv_bfloat16, 0, 0, W_I8, 64, true>();
  if (a->a.w_kind == W_I4) return f.run<__nv_bfloat16, 0, 0, W_I4, 64, true>();
  return (int)cudaErrorInvalidValue;
}

extern "C" long long elit_gpt2_megastep_kernels() { return g_kernels; }

extern "C" const char* elit_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
