// The speculative verify pass of GPT-2 (greedy, one sequence, 1 <= R <= 8
// verify rows) as ONE persistent kernel.
//
// Replaces efficient_llm_inference_tpu/ops/pallas/megakernel.py:
// gpt2_megaverify, the TPU's k-row verify program. Entry point:
// elit_gpt2_megaverify (KV panes in the model dtype). Row t carries the t-th
// verify token at position cur + t (cur = *length, read on the device). One
// cooperative launch on the stream it is given: gpt2_megastep.cu's
// persistent step (persistent_step.cuh: the plan of rows a block, the ring
// of bulk copies, the grid barrier) with a row dimension R, a runtime
// argument:
//
//   embed                  every block: x[t] = wte[tok[t]] + wpe[min(cur + t,
//                          P-1)] (or x_emb[t]) for its own LN1; block 0
//                          stores x
//   per layer l:
//     LN1 -> qkv           the R rows' LN1 staged in shared memory, q|k|v
//                          out; the k and v rows also into rows cur + t of
//                          layer l's panes (none at or past capacity)
//     | barrier
//     attention            split-KV (split_attention.cuh's verify item): a
//                          (head, split) item for all R rows, row t over the
//                          pane rows c < cur + t (the cache and the verify
//                          rows j < t) with its own k / v merged by the last
//                          split of the head: the in-block causal set
//     | barrier
//     proj + x             out-projection, bias, residual add in place
//     | barrier
//     LN2 -> fc            tanh-GELU epilogue in fp32
//     | barrier
//     fc_proj + x          bias, residual add in place
//     | barrier
//   LNf -> LM head         per-block, per-row (max, argmax); the last block
//                          to take a ticket picks each row's first maximum ->
//                          tok_out[t]; the length is not advanced (the
//                          caller keeps the accepted rows)
//
// Bound: bytes. A pass reads every weight once for all R rows, the stream of
// one decode step (GPT-2 small in bf16: 247 MB, 74 us at 3.35 TB/s), plus
// the visible K/V rows, so R tokens are checked for about one step while the
// weights dominate. The chain of 6 L + 3 kernels this replaces (its GEMVs
// gemv_batch.cuh's, its attention one block per (head, row)) paid a
// kernel's fixed cost ~5 us at each boundary; the single stream's
// persistent step (0.275 ms against its 0.077 ms bound) showed that one
// launch and 60 grid barriers cost far less. The design is that step's:
//   - one cooperative launch a pass, one block an SM, 5 grid barriers a
//     layer, each block streaming its rows of every GEMV phase through its
//     ring across the barriers (the same plan of rows a block);
//   - the product on the CUDA cores: each 16-byte weight chunk a lane loads
//     is decoded once (weight_tier.cuh) and applied to the R rows' inputs,
//     staged in shared memory in the model dtype, into R fp32 accumulators
//     an item; the tensor-core tiles of gpt2_megabatch.cu cost ~0.2 us a k16
//     step at few rows (PERF.md). The row slots take no branch (4 slots
//     when R <= 4, else 8; a slot past R reads row R - 1 again, its sums
//     unused), so a chunk's loads of all rows go out together: a branch a
//     row cost ~40% more a tile on the card (PERF.md §6). A row's
//     sum: lane l its chunks l, l + 32, ... in order, the lanes by a fixed
//     tree (a tile's 2 x 8 item x row sums by one reduce-scatter of the
//     warp: 16 shuffles where 16 warp sums take 80), fc_proj's four items
//     in order;
//   - the LayerNorm prologue: warp t loads row t into registers (16 bytes a
//     lane and load), takes its statistics (each lane's sums in order, a
//     shuffle tree) and writes the normalised row: no block barrier and no
//     block-wide reduction a row (the gain and bias held in registers
//     beside the row cost more than their L1 loads); the epilogue's bias
//     and residual are requested before a phase's tiles;
//   - the new K/V rows are written by the qkv phase's epilogue, so the
//     attention reads the pane once for all R rows with no barrier of its
//     own (split_attention.cuh's verify item, kAttnHeads virtual heads a
//     pass): rows at or past cur through ld.global.cg;
//   - the attention plan is the single stream's (ops/megakernel.py
//     `attention_plan`, a function of (C, H)): a row's bits depend on its
//     own length, never on R, the rows after it or the grid;
//   - fp32 (the holding dtype, not a speed target) stages its rows without
//     the quantized tiers' padding and streams tiles of 4 rows, so GPT-2
//     large's R = 8 rows fit a block with two ring slots.
//
// Weight tiers (the JAX kernel's "wscale" / "w4scale" modes,
// ops/pallas/megakernel.py:714-721): w_kind 8 or 4 streams int8 or
// grouped-int4 codes with their scales (int8: a row's fp32 sum times its
// scale; int4: each chunk's sum times its group's scale), the LM head from
// the quantized copy `head`.
//
// Numerics: the JAX kernels' rounding points, as megastep_common.cuh states
// them; the attention's as split_attention.cuh states them.
//
// C interface (ctypes): elit_gpt2_megaverify takes a Gpt2VerifyArgs
// (mirrored by ops/megakernel.py's GPT2VerifyArgs: the single stream's
// Gpt2StepArgs over [R]-row tensors, then R) and a stream and returns the
// launch's error (0 = success); elit_cuda_error_string names a code,
// elit_gpt2_megaverify_grid gives the blocks an SM holds for a
// configuration, elit_gpt2_megaverify_kernels counts the kernels launched.
// The tensors: length [1], tok_in, tok_out [R], x_emb [R, E], the panes
// [L, C, E], the workspace [R, width], lm_val / lm_idx [R, lm_blocks],
// attn_part [R, H, splits, D + 2], sync [2 + H] zeroed. dtype 0 = float32,
// 1 = bfloat16; head_dim 64 or 128; E a multiple of 128 up to 2048;
// capacity up to 8192; any grid of at least one block.

#include <algorithm>
#include <type_traits>

#include "persistent_step.cuh"

// Mirrored by ops/megakernel.py's GPT2VerifyArgs (ctypes).
struct Gpt2VerifyArgs {
  Gpt2StepArgs s;  // over [R]-row tensors; attn_part [R, H, splits, D + 2], sync [2 + H]
  int rows;
};

namespace {

constexpr int kMaxRows = 8;           // the JAX verify kernels' largest R
constexpr int kDynSmem = 208 * 1024;  // a block's dynamic shared memory at most
constexpr int kAttnHeads = 4;         // virtual heads (a row's head) a pass of the attention
constexpr int kScaleSlots = 16 * kThreads;  // fp32 scales a block stages (int4 groups, LM head)

long long g_kernels = 0;  // kernels launched (elit_gpt2_megaverify_kernels)

struct VerifyParams {
  MegaArgs a;
  int R, grid, splits, rows, slots, tile_bytes;
  int rs;             // elements between two rows' staged inputs
  int ys_at, s4_at;   // byte offsets in shared memory: the items' sums, the staged scales
  float* part;
  unsigned* sync;
};

// A ring tile: the single stream's in bf16 (16 rows), 4 rows in fp32.
template <typename T, int WK>
struct VTile {
  static constexpr int items = sizeof(T) == 4 ? 4 : Tile<T, WK>::items;
};
template <typename T, int WK>
using VStream = Stream<T, WK, VTile<T, WK>::items>;

// The staged inputs' chunk stride: gemv_stream.cuh's (a quantized tier's
// chunks padded by 16 bytes against bank conflicts), unpadded in fp32.
template <typename T, int WK>
struct VIn {
  static constexpr int VN = StreamIn<T, WK>::VN;
  static constexpr int ST = sizeof(T) == 4 ? VN : StreamIn<T, WK>::STRIDE;
};
template <typename T, int WK>
__host__ __device__ __forceinline__ int vin_at(int e) {
  return (e / VIn<T, WK>::VN) * VIn<T, WK>::ST + e % VIn<T, WK>::VN;
}

// ------------------------------------------------------------- staging

// 16 bytes of T from PE fp32 values, each rounded to T.
__device__ __forceinline__ uint4 pack_values(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack_values(const float (&f)[8]) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)  // little endian: the lower half first
    w[i] = (unsigned)__bfloat16_as_ushort(__float2bfloat16(f[2 * i])) |
           ((unsigned)__bfloat16_as_ushort(__float2bfloat16(f[2 * i + 1])) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The LayerNorm-ed R rows of a phase into h: warp t loads row t, 16 bytes a
// lane and load (lane l its chunks l, l + 32, ...), into registers: layer
// 0's embedding (x_emb[t], or wte[tok[t]] + wpe[min(cur + t, P - 1)] rounded
// to T, which block 0 also stores in x) or x's row t (written by other
// blocks); its fp32 mean and variance (each lane's sums in order, a shuffle
// tree), then the normalised values rounded to T (PRO_LN's formula). No
// block barrier: the caller's one follows.
template <typename T, int WK>
__device__ void norm_rows(const MegaArgs& a, bool embed, int cur, int R, T* h, int rs,
                          const float* g, const float* b) {
  constexpr int PE = Vec<T>::N;
  constexpr int MC = 2048 / PE / 32;  // chunks a lane holds: E <= 2048
  const int lane = threadIdx.x & 31, t = threadIdx.x >> 5;
  const int E = a.n_embd, nc = E / PE;
  if (t >= R) return;
  const uint4* src = reinterpret_cast<const uint4*>(embed ? a.x_emb : a.x);
  const bool ids = embed && a.x_emb == nullptr;
  const uint4* te = nullptr;
  const uint4* pe = nullptr;
  if (ids) {
    const int tok = min(max(__ldcg(a.tok_in + t), 0), a.vocab - 1);
    const int pos = min(max(cur + t, 0), a.n_pos - 1);
    te = static_cast<const uint4*>(a.wte) + (size_t)tok * nc;
    pe = static_cast<const uint4*>(a.wpe) + (size_t)pos * nc;
  }
  uint4 u[MC];
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < MC; ++k) {
    const int c = lane + 32 * k;
    if (c >= nc) break;
    float f[PE];
    if (ids) {
      float w[PE];
      unpack16(te[c], f);
      unpack16(pe[c], w);
#pragma unroll
      for (int i = 0; i < PE; ++i) f[i] = round_to<T>(f[i] + w[i]);
      u[k] = pack_values(f);
      if (blockIdx.x == 0) reinterpret_cast<uint4*>(a.x)[(size_t)t * nc + c] = u[k];
    } else {
      u[k] = __ldcg(src + (size_t)t * nc + c);
      if (embed && blockIdx.x == 0) reinterpret_cast<uint4*>(a.x)[(size_t)t * nc + c] = u[k];
      unpack16(u[k], f);
    }
#pragma unroll
    for (int i = 0; i < PE; ++i) s += f[i];
  }
  const float mean = warp_sum(s) / (float)E;
  float s2 = 0.0f;
#pragma unroll
  for (int k = 0; k < MC; ++k) {
    if (lane + 32 * k >= nc) break;
    float f[PE];
    unpack16(u[k], f);
#pragma unroll
    for (int i = 0; i < PE; ++i) {
      const float d = f[i] - mean;
      s2 += d * d;
    }
  }
  const float r = rsqrtf(warp_sum(s2) / (float)E + a.ln_eps);
#pragma unroll
  for (int k = 0; k < MC; ++k) {
    const int c = lane + 32 * k;
    if (c >= nc) break;
    float f[PE];
    unpack16(u[k], f);
#pragma unroll
    for (int i = 0; i < PE; ++i) {
      const int e = c * PE + i;
      f[i] = round_to<T>((f[i] - mean) * r * g[e] + b[e]);
    }
    *reinterpret_cast<uint4*>(h + (size_t)t * rs + vin_at<T, WK>(c * PE)) = pack_values(f);
  }
}

// The R rows of `src` (K values apart, written by other blocks) into h, 16
// bytes a load.
template <typename T, int WK>
__device__ void stage_rows(T* h, int rs, const T* src, int R, int K) {
  constexpr int PE = 16 / (int)sizeof(T);
  const int cpr = K / PE;
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  for (int i = threadIdx.x; i < R * cpr; i += kThreads) {
    const int t = i / cpr, c = i - t * cpr;
    *reinterpret_cast<uint4*>(h + (size_t)t * rs + vin_at<T, WK>(c * PE)) = __ldcg(s4 + i);
  }
}

// ------------------------------------------------------------- the product

// acc + the chunk's decoded weights w times one row's inputs a: the
// single stream's chunk_acc on a decoded chunk (gemv_stream.cuh).
template <typename T, int WK>
__device__ __forceinline__ float dec_acc(const float (&w)[WTier<T, WK>::N],
                                         const float (&a)[WTier<T, WK>::N], float s, float acc) {
  if constexpr (WK == W_T) {
#pragma unroll
    for (int i = 0; i < WTier<T, WK>::N; ++i) acc = fmaf(w[i], a[i], acc);
    return acc;
  } else if constexpr (WK == W_I8) {
    return acc + chunk_dot<WK>(w, a);
  } else {
    return fmaf(chunk_dot<WK>(w, a), s, acc);
  }
}

template <typename T, int WK>
__device__ __forceinline__ void decode_w(const uint4& u, float (&w)[WTier<T, WK>::N]) {
  if constexpr (WK == W_T)
    unpack16(u, w);
  else
    decode_chunk<WK>(u, w);
}

// The int4 group scales (int8: row scales) of a block's rows of a phase
// into s4s where they fit (kScaleSlots); returns whether they did.
template <typename T, int WK>
__device__ bool stage_scales(const void* scales, size_t first, int n, float* s4s) {
  if (WK == W_T || n > kScaleSlots) return false;
  for (int i = threadIdx.x; i < n; i += kThreads)
    s4s[i] = WK == W_I8 ? static_cast<const float*>(scales)[first + i]
                        : to_f32(static_cast<const T*>(scales)[first + i]);
  __syncthreads();
  return true;
}

// Each of the NV = 2^m values v[] of every lane summed over the warp's 32
// lanes by a fixed tree, a reduce-scatter: each of the first m steps halves
// the values a lane holds (lane bit 4 - s keeps the upper or the lower half
// and adds its partner's copy of it, lane ^ (16 >> s)), the last 5 - m
// steps add the one value left across the other lanes. Lane l ends holding
// the sum of value (l >> (5 - m)) & (NV - 1): NV + 4 - m shuffles where NV
// warp sums take 5 NV.
template <int NV>
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[NV]) {
  constexpr int M = NV == 16 ? 4 : NV == 8 ? 3 : NV == 4 ? 2 : NV == 2 ? 1 : 0;
  static_assert(NV == 1 << M, "a power of two up to 16");
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < M; ++s) {
    const int half = NV >> (s + 1), off = 16 >> s;
    const bool hi = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = hi ? v[i] : v[i + half];
      const float keep = hi ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
#pragma unroll
  for (int off = 16 >> M; off > 0; off >>= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
  return v[0];
}

// One GEMV phase of `kind` in layer l (the LM head: each row's first
// maximum of each warp into (bv, bi)) over the R staged input rows in h:
// each tile as it arrives, warp w its items w, w + 8, ..., every chunk
// decoded once and applied to the R rows (lane l its chunks l, l + 32, ...
// in order); a tile's item x row sums by one reduce-scatter of the warp
// (value u kMaxRows + r: item u, row r), each sum's lane storing it to ys;
// then, once all are in, the epilogue of every (row, verify row) of the
// block (fc_proj: its four items in order), its first element's bias and
// residual requested before the tiles. The qkv phase also writes its k and
// v rows into rows cur + t of layer l's panes.
template <typename T, int WK>
__device__ __forceinline__ void gemv_phase(VStream<T, WK>& S, const VerifyParams& P, const T* h,
                                        int kind, int l, int cur, float* ys, float* s4s,
                                        float (*bv)[kMaxRows], int (*bi)[kMaxRows]) {
  constexpr int VN = VIn<T, WK>::VN, ST = VIn<T, WK>::ST;
  constexpr int TI = VTile<T, WK>::items, WI = TI >= kWarps ? TI / kWarps : 1;
  constexpr int NV = WI * kMaxRows, SH = NV == 16 ? 1 : 2;  // lane l holds sum (l >> SH)
  const MegaArgs& a = P.a;
  const PhasePlan& ph = S.plan[kind];
  const int E = a.n_embd, N = kind_rows(kind, E, a.vocab), ks = kind_split(kind), K = ks * E;
  const int R = P.R, rs = P.rs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cps = item_bytes<T, WK>(E) / 16;  // chunks an item
  const int r0 = ph.r0, items = ph.items, rows = items / ks;
  const int ng = WK == W_I4 ? K / a.w_group : 1;
  const float chunk_to_group = WK == W_I4 ? (float)VN / (float)a.w_group : 0.0f;
  const bool head = kind == K_HEAD;
  const int epi = kind == K_QKV ? E_STORE : (kind == K_FC ? E_GELU : E_RESIDUAL);
  const float* bias = a.smalls + (size_t)l * 13 * E +
                      (kind == K_QKV ? 4 : kind == K_PROJ ? 7 : kind == K_FC ? 8 : 12) * E;
  T* out = static_cast<T*>(kind == K_QKV ? a.qkv : kind == K_FC ? a.ffn : a.x);
  // the epilogue's first element of this thread: its bias and residual
  float pre_b = 0.0f, pre_x = 0.0f;
  if (!head && tid < rows * R) {
    const int rr = tid / R, t = tid - rr * R;
    pre_b = bias[r0 + rr];
    if (epi == E_RESIDUAL) pre_x = ldcg_f32(out + (size_t)t * N + r0 + rr);
  }
  const void* scales = kind == K_QKV    ? a.attn_s
                       : kind == K_PROJ ? a.proj_s
                       : kind == K_FC   ? a.fc_s
                       : kind == K_FCP  ? a.fcp_s
                                        : a.head_s;
  const size_t srow = (size_t)(head ? 0 : l) * N;  // the layer's first scale row
  const T* s4 = WK == W_I4 ? static_cast<const T*>(scales) + srow * ng : nullptr;
  const float* s8 = WK == W_I8 ? static_cast<const float*>(scales) + srow : nullptr;
  // int4: the block's group scales; int8: its row scales (the LM head reads them a tile)
  const bool staged = WK == W_I4 ? stage_scales<T, WK>(scales, (srow + r0) * ng, rows * ng, s4s)
                                 : stage_scales<T, WK>(scales, srow + r0, rows, s4s);
  const int q = warp % ks;  // the part of its row each item of this warp is
  // the sum this lane holds after a tile's reduce-scatter: item my_u of the
  // warp's, verify row my_r; `owner`: the first of the lanes that hold it
  const int my = (lane >> SH) & (NV - 1), my_u = my / kMaxRows, my_r = my % kMaxRows;
  const bool owner = (lane & ((1 << SH) - 1)) == 0 && my_r < R;
  float best_v = -INFINITY;  // the LM head: the first maximum of row my_r
  int best_i = 0;
  for (int t = 0; t < ph.tiles; ++t) {
    const uint4* w = reinterpret_cast<const uint4*>(S.next());
    int row[WI];  // -1: no item
    float acc[WI][kMaxRows];
#pragma unroll
    for (int u = 0; u < WI; ++u) {
      const int i = t * TI + u * kWarps + warp;
      row[u] = u * kWarps + warp < TI && i < items ? r0 + i / ks : -1;
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) acc[u][r] = 0.0f;
    }
    // the tile's products for RB row slots (4 when R <= 4, else 8): every
    // slot without a branch (a slot past R takes row R - 1's inputs again,
    // its sums unused), so the rows' loads go out together
    auto product = [&](auto rb) {
      constexpr int RB = decltype(rb)::value;
      for (int c = lane; c < cps; c += 32) {
        const int cg = q * cps + c;  // the chunk's place in the row
        const int grp = WK == W_I4 ? chunk_group(cg, chunk_to_group) : 0;
        float wd[WI][VN], gs[WI];
#pragma unroll
        for (int u = 0; u < WI; ++u) {
          gs[u] = 0.0f;
          if (row[u] < 0) {
#pragma unroll
            for (int i = 0; i < VN; ++i) wd[u][i] = 0.0f;
            continue;
          }
          decode_w<T, WK>(w[(u * kWarps + warp) * cps + c], wd[u]);
          if (WK == W_I4)
            gs[u] = staged ? s4s[(row[u] - r0) * ng + grp] : to_f32(s4[(size_t)row[u] * ng + grp]);
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          float in[VN];
          load_inputs<T, VN>(h + (size_t)min(r, R - 1) * rs + (size_t)cg * ST, in);
#pragma unroll
          for (int u = 0; u < WI; ++u) acc[u][r] = dec_acc<T, WK>(wd[u], in, gs[u], acc[u][r]);
        }
      }
    };
    if (R <= 4)
      product(std::integral_constant<int, 4>{});
    else
      product(std::integral_constant<int, kMaxRows>{});
    float v[NV];
#pragma unroll
    for (int u = 0; u < WI; ++u)
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) v[u * kMaxRows + r] = acc[u][r];
    const float y = warp_reduce_scatter<NV>(v);
    const int i = t * TI + my_u * kWarps + warp;  // the lane's item
    if (owner && my_u * kWarps + warp < TI && i < items) {
      if (head) {
        const float sc = WK == W_I8 ? (staged ? s4s[i] : s8[r0 + i]) : 1.0f;
        const float yv = __fmul_rn(y, sc);
        if (better(yv, r0 + i, best_v, best_i)) {
          best_v = yv;
          best_i = r0 + i;
        }
      } else {
        ys[i * R + my_r] = y;
      }
    }
    S.consumed();  // after the last tile: every item's sum is in ys
  }
  if (head) {  // the warp's items of a row: lanes my_u = 0 and 1 (WI = 2)
    if (WI == 2) {
      const float ov = __shfl_xor_sync(0xffffffffu, best_v, 16);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, 16);
      if (better(ov, oi, best_v, best_i)) {
        best_v = ov;
        best_i = oi;
      }
    }
    if (owner && my_u == 0) {
      bv[warp][my_r] = best_v;
      bi[warp][my_r] = best_i;
    }
    return;
  }
  for (int e = tid; e < rows * R; e += kThreads) {
    const int rr = e / R, t = e - rr * R, o = r0 + rr;
    float y = 0.0f;
    for (int qq = 0; qq < ks; ++qq) y += ys[(rr * ks + qq) * R + t];
    const float sc = WK == W_I8 ? (staged ? s4s[rr] : s8[o]) : 1.0f;
    const float z = __fmul_rn(y, sc) + (e == tid ? pre_b : bias[o]);
    T* dst = out + (size_t)t * N + o;
    const T v = from_f32<T>(epi == E_GELU       ? gelu_tanh(z)
                            : epi == E_RESIDUAL ? (e == tid ? pre_x : ldcg_f32(dst)) + round_to<T>(z)
                                                : z);
    *dst = v;
    const int prow = cur + t;
    if (kind == K_QKV && o >= E && prow >= 0 && prow < a.capacity) {
      const size_t at = (size_t)l * a.capacity * E + (size_t)prow * E;
      if (o < 2 * E)
        static_cast<T*>(a.k)[at + o - E] = v;
      else
        static_cast<T*>(a.v)[at + o - 2 * E] = v;
    }
  }
}

// ---------------------------------------------------------- attention

// One layer's attention phase: (head, split) items over the blocks, each
// for all R rows (split_attention.cuh's verify item); the qkv phase's grid
// barrier is met before a block's first item (or once, if it has none).
template <typename T, int D>
__device__ __noinline__ void attention_phase(const VerifyParams& P, int l, int cur, float* hf) {
  const MegaArgs& a = P.a;
  const int E = a.n_embd, H = a.n_head, C = a.capacity;
  VerifyAttn va{};
  AttnParams& ap = va.a.p;
  ap.qkv = a.qkv;
  ap.k = static_cast<char*>(a.k) + pane_offset(0, sizeof(T), l, C, E);
  ap.v = static_cast<char*>(a.v) + pane_offset(0, sizeof(T), l, C, E);
  ap.length = a.length;
  ap.capacity = C;
  ap.n_head = H;
  ap.q_width = ap.kv_width = E;
  ap.group = 1;
  ap.sm_scale = 1.0f / sqrtf((float)D);
  ap.out = a.attn;
  va.a.n_kv = H;
  va.a.splits = P.splits;
  va.a.rows = P.rows;
  va.a.part = P.part;
  va.a.count = reinterpret_cast<int*>(P.sync + 2);
  va.R = P.R;
  va.qkv_stride = 3 * E;
  va.out_stride = E;
  bool met = false;
  auto meet = [&] {
    if (!met) grid_sync(P.sync, P.grid);
    met = true;
    return cur;
  };
  for (int item = blockIdx.x; item < H * P.splits; item += P.grid) {
    verify_attention_item<T, D, kAttnHeads>(va, item, hf, meet);
    __syncthreads();  // the next item reuses the shared memory
  }
  meet();
}

// ------------------------------------------------------------------ pass

template <typename T, int WK, int D>
__global__ void __launch_bounds__(kThreads, 1)
gpt2_verify_kernel(const __grid_constant__ VerifyParams P) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxSlots];
  __shared__ PhasePlan plan[5];
  __shared__ float bv[kWarps][kMaxRows];
  __shared__ int bi[kWarps][kMaxRows];
  __shared__ int is_last;
  const MegaArgs& a = P.a;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int E = a.n_embd, L = a.n_layer, R = P.R;
  T* h = reinterpret_cast<T*>(smem + (size_t)P.slots * P.tile_bytes);
  float* ys = reinterpret_cast<float*>(smem + P.ys_at);
  float* s4s = reinterpret_cast<float*>(smem + P.s4_at);
  if (tid == 0) {
    for (int s = 0; s < P.slots; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  VStream<T, WK> S;
  S.init(a, P.grid, P.slots, P.tile_bytes, plan, smem, full);  // a block barrier
  S.fill();
  const int cur = __ldcg(a.length);
  // The phases in order: per layer qkv (then the attention), proj, fc,
  // fc_proj, each with its prologue; then the LM head. One call site each.
  for (int ph = 0; ph <= 4 * L; ++ph) {
    const int l = ph / 4, kind = ph == 4 * L ? K_HEAD : ph % 4;
    const float* sm = a.smalls + (size_t)min(l, L - 1) * 13 * E;
    const bool rows = S.plan[kind].tiles > 0;
    if (kind == K_QKV || kind == K_FC || kind == K_HEAD) {
      const bool embed = kind == K_QKV && l == 0;  // block 0 also stores x
      const float* gain = kind == K_HEAD ? a.lnf : sm + (kind == K_FC ? 2 * E : 0);
      if (rows || (embed && blockIdx.x == 0))
        norm_rows<T, WK>(a, embed, cur, R, h, P.rs, gain, gain + E);
    } else if (rows) {
      stage_rows<T, WK>(h, P.rs, static_cast<const T*>(kind == K_PROJ ? a.attn : a.ffn), R,
                        kind == K_FCP ? 4 * E : E);
    }
    __syncthreads();
    gemv_phase<T, WK>(S, P, h, kind, l, cur, ys, s4s, bv, bi);
    if (kind == K_QKV) attention_phase<T, D>(P, l, cur, reinterpret_cast<float*>(h));
    if (kind != K_HEAD) grid_sync(P.sync, P.grid);
  }
  __syncthreads();
  if (tid < R) {  // the block's first maximum of each row, over its warps in order
    float v = bv[0][tid];
    int i = bi[0][tid];
    for (int w = 1; w < kWarps; ++w)
      if (better(bv[w][tid], bi[w][tid], v, i)) {
        v = bv[w][tid];
        i = bi[w][tid];
      }
    a.lm_val[(size_t)tid * a.lm_blocks + blockIdx.x] = v;
    a.lm_idx[(size_t)tid * a.lm_blocks + blockIdx.x] = i;
  }
  __syncthreads();
  if (tid == 0) {
    unsigned prev;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(P.sync + 1) : "memory");
    is_last = prev == (unsigned)P.grid - 1;
  }
  __syncthreads();
  if (!is_last) return;
  // the last block: each row's first maximum over the partials -> its token
  for (int t = warp; t < R; t += kWarps) {
    float v = -INFINITY;
    int i = 0;
    for (int p = lane; p < P.grid; p += 32) {
      const float pv = __ldcg(a.lm_val + (size_t)t * a.lm_blocks + p);
      const int pi = __ldcg(a.lm_idx + (size_t)t * a.lm_blocks + p);
      if (better(pv, pi, v, i)) { v = pv; i = pi; }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, o);
      const int oi = __shfl_xor_sync(0xffffffffu, i, o);
      if (better(ov, oi, v, i)) { v = ov; i = oi; }
    }
    if (lane == 0) a.tok_out[t] = i;
  }
  if (tid == 0) P.sync[1] = 0;  // the ticket, clean for the next launch
}

// ------------------------------------------------------------------- host

// A block's shared memory: the ring; the R rows' staged inputs (fc_proj's
// 4E a row in the tier's layout) or one attention item's, whichever is
// larger; the items' sums of the block's largest phase for R rows; for a
// quantized tier, kScaleSlots staged scales. The ring takes what is left of
// kDynSmem, at most kRingBytes; the kernel refuses fewer than two slots.
struct Smem {
  int slots, tile_bytes, rs, ys_at, s4_at;
  size_t total;
};

template <typename T, int WK>
Smem smem_plan(int E, int V, int D, int rows, int R, int grid) {
  constexpr int VN = VIn<T, WK>::VN, ST = VIn<T, WK>::ST;
  Smem m{};
  m.tile_bytes = VTile<T, WK>::items * item_bytes<T, WK>(E);
  m.rs = 4 * E / VN * ST;
  const size_t h = std::max((size_t)R * m.rs * sizeof(T),
                            verify_item_floats(1, R, D, rows) * sizeof(float));
  const size_t h16 = (h + 15) / 16 * 16;
  int items = 0;  // the most items a block takes in a layer phase
  for (int k = K_QKV; k <= K_FCP; ++k)
    items = std::max(items, (kind_rows(k, E, V) + grid - 1) / grid * kind_split(k));
  const size_t ys = ((size_t)items * R * sizeof(float) + 15) / 16 * 16;
  const size_t s4 = WK != W_T ? kScaleSlots * sizeof(float) : 0;
  const long long ring =
      std::min<long long>(kRingBytes, (long long)kDynSmem - (long long)(h16 + ys + s4));
  m.slots = ring > 0 ? (int)std::min<long long>(kMaxSlots, ring / m.tile_bytes) : 0;
  const size_t ring_bytes = (size_t)m.slots * m.tile_bytes;
  m.ys_at = (int)(ring_bytes + h16);
  m.s4_at = (int)(m.ys_at + ys);
  m.total = m.s4_at + s4;
  return m;
}

// One configuration's kernel: launched (cooperatively, `grid` blocks) or,
// with per_sm, its blocks an SM at a plan sized for `grid` blocks.
struct Launch {
  const Gpt2VerifyArgs& va;
  cudaStream_t st;
  int* per_sm;
  int grid;

  template <typename T, int WK, int D>
  int run() const {
    const Gpt2StepArgs& s = va.s;
    const MegaArgs& a = s.a;
    const Smem m = smem_plan<T, WK>(a.n_embd, a.vocab, D, s.attn_rows, va.rows, grid);
    if (m.slots < 2) return (int)cudaErrorInvalidValue;
    const VerifyParams P{a,      va.rows, s.grid, s.attn_splits, s.attn_rows, m.slots,
                         m.tile_bytes, m.rs, m.ys_at, m.s4_at, s.attn_part, s.sync};
    auto kernel = gpt2_verify_kernel<T, WK, D>;
    if (int rc = allow_smem(kernel, m.total)) return rc;
    if (per_sm != nullptr)
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, m.total);
    const int rc = launch_cooperative(kernel, P.grid, m.total, st, P);
    if (rc == 0) ++g_kernels;
    return rc;
  }
};

template <typename T, int WK>
int by_head_dim(const Launch& f) {
  const int D = f.va.s.a.n_embd / f.va.s.a.n_head;
  if (D == 64) return f.run<T, WK, 64>();
  if (D == 128) return f.run<T, WK, 128>();
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int by_tier(const Launch& f) {
  const int wk = f.va.s.a.w_kind;
  if (wk == W_T) return by_head_dim<T, W_T>(f);
  if (wk == W_I8) return by_head_dim<T, W_I8>(f);
  if (wk == W_I4) return by_head_dim<T, W_I4>(f);
  return (int)cudaErrorInvalidValue;
}

int dispatch(const Launch& f) {
  if (f.va.s.a.dtype == 0) return by_tier<float>(f);
  if (f.va.s.a.dtype == 1) return by_tier<__nv_bfloat16>(f);
  return (int)cudaErrorInvalidValue;
}

bool args_ok(const Gpt2VerifyArgs* va) {
  return va != nullptr && step_args_ok(&va->s, false) && va->rows >= 1 &&
         va->rows <= kMaxRows;
}

}  // namespace

extern "C" int elit_gpt2_megaverify(const Gpt2VerifyArgs* a, void* stream) {
  if (!args_ok(a)) return (int)cudaErrorInvalidValue;
  return dispatch(Launch{*a, static_cast<cudaStream_t>(stream), nullptr, a->s.grid});
}

// The blocks an SM holds of the kernel the arguments select (*per_sm) and
// the card's SM count (*sms): the launcher's grid is their product.
extern "C" int elit_gpt2_megaverify_grid(const Gpt2VerifyArgs* a, int* per_sm, int* sms) {
  if (a == nullptr || per_sm == nullptr || sms == nullptr || a->rows < 1 || a->rows > kMaxRows)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (cudaError_t e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev))
    return (int)e;
  return dispatch(Launch{*a, nullptr, per_sm, *sms});
}

extern "C" long long elit_gpt2_megaverify_kernels() { return g_kernels; }

extern "C" const char* elit_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
