// One decode step of B independent GPT-2 streams (greedy, 1 <= B <= 32) as
// ONE persistent kernel.
//
// Replaces efficient_llm_inference_tpu/ops/pallas/megakernel_batch.py:
// gpt2_megabatch and ops/pallas/megakernel_batch_quant.py:
// gpt2_megabatch_quant, the TPU's batched whole-step decode programs. Entry
// points: elit_gpt2_megabatch (KV panes in the model dtype) and
// elit_gpt2_megabatch_quant (int8, half-split int4 or mixed panes with
// per-(slot, token) fp32 scales). Each launches one cooperative kernel on the
// stream it is given: gpt2_megastep.cu's persistent step with a slot
// dimension, its phases following one another across grid barriers:
//
//   embed                  every block: x[b] = wte[tok[b]] + wpe[min(lengths[b],
//                          P-1)] (or x_emb[b]) for its own LN1; block 0 stores x
//   per layer l:
//     LN1 -> qkv           the B slots' LN1 staged in shared memory, q|k|v out
//     | barrier
//     attention            split-KV: (slot, head, split) items over the grid's
//                          warps (the single stream's plan, each slot at its
//                          own length), the current token merged by the last
//                          split of each (slot, head); then a block a slot
//                          writes row lengths[b] of slot b's panes
//                          (quantize-on-write for quantized panes)
//     | barrier
//     proj + x             out-projection, bias, residual add in place
//     | barrier
//     LN2 -> fc            tanh-GELU epilogue in fp32
//     | barrier
//     fc_proj + x          bias, residual add in place
//     | barrier
//   LNf -> LM head         per-block, per-slot (max, argmax); the last block
//                          to take a ticket picks each slot's first maximum ->
//                          tok_out[b]; with `advance`, clamps it to [0, V-1]
//                          and adds 1 to lengths[b]
//
// Bound: bytes. A step reads every weight once for all B slots (GPT-2 small
// in bf16: 247 MB, ~74 us at 3.35 TB/s) plus each slot's visible K/V rows
// (at 320 rows 9.8 MB a slot in bf16), so B tokens cost about one
// single-stream step while the weights dominate. The chain this replaces (5 L
// + 3 = 63 kernels, its GEMVs on CUDA cores launched once per group of 8
// slots) paid ~5 us at each kernel boundary and streamed the weights again
// for each group. The design is gpt2_megastep.cu's, through the same
// persistent_step.cuh machinery:
//   - one cooperative launch a step, one block an SM, the same 60 grid
//     barriers (5 a layer) at every B, the same plan of rows a block and the
//     same weight ring streaming through the barriers: each weight byte is
//     read once a step for all B slots;
//   - the slots' inputs of a GEMV phase are staged in shared memory in the
//     model dtype (exact: norm outputs rounded to T, or activations already
//     in T), a row of B a 16-byte-aligned stride of 2E + 32 bytes (bf16) so
//     a quarter warp's 8-byte fragment loads fall in distinct banks;
//   - the product, bf16: mma.sync m16n8k16 with fp32 sums, a tile's rows
//     (16 of E inputs; fc_proj's tile, 4 rows of 4E) as M, the slots as N in
//     ceil(B / 8) n8 tiles; the 8 warps split K, warp w taking inputs [w E /
//     8, (w + 1) E / 8) of every E-input quarter in k16 steps, lane (g, t)
//     taking inputs 4t .. 4t + 3 of a step as its fragments' columns 2t, 2t
//     + 1, 2t + 8, 2t + 9 for both operands (a permutation of the step's k,
//     the same for both, so the product is unchanged); the warps' sums are
//     added in warp order in shared memory (two buffers, so one barrier a
//     tile: the ring's). fp32 (the holding dtype, not a speed target): the
//     same fragments summed by FMAs in input order;
//   - fc_proj's inputs (4E a slot: 192 KB at B = 32 in bf16) do not fit
//     beside the ring at every B, so its K quarters are staged as many at a
//     time as leave the ring kMinSlots slots (all four up to B = 8, two up
//     to 16, one at 32 for GPT-2 small in bf16): a block holds up to two of
//     its fc_proj tiles in the ring (its 5-6 rows at 132 blocks) and applies
//     each staging to both, the warps' sums carried in the MMA accumulators
//     across the quarters. Sizing the ring from B alone would leave it one
//     24 KB slot at B = 32. The quarters' order is fixed, so the staging
//     does not change a sum;
//   - a block's rows of a phase are its share of N rows, whatever N: proj
//     and fc_proj (768 rows) give each block 5-6 rows as a partly filled m16
//     tile. The tensor cores have the room (the product is ~1/300 of their
//     rate at B = 32), so no K split across blocks is needed;
//   - each tile's epilogue runs once its sums are in (bias, int8 row scale,
//     residual: requested when the tile begins), so nothing grows with a
//     block's rows and any grid takes any B;
//   - the weight tiers decode int8 / int4 codes in registers
//     (weight_tier.cuh's code decode, exact in bf16); int8 scales a row's
//     fp32 sum, int4 keeps JAX's int4w8 form: each group's fp32 sum within a
//     warp's slice (G % 32 == 0: a k16 step lies in one group) times its
//     (row, group) scale, fused into the row's sum;
//   - attention: split_attention.cuh's (head, split) items for every slot at
//     the single stream's plan (ops/megakernel.py `attention_plan`: a
//     function of (C, H) alone), over [L, B, C, W] panes, each item a warp's
//     (split_attention_warp_item): at B = 32 a layer has 3840 items of 32
//     rows, 29 a block, and the block-wide item's fixed cost (its block
//     barriers and dependent round trips) would take them one after another;
//     a block's 8 warps take 8 at once, each with its split's K and V rows
//     in flight together;
//   - the LM head: each thread keeps the first maximum of its slots' rows;
//     the block's per-slot partials, then the single stream's ticket.
// Sums: a (row, slot)'s fp32 sum is taken in an order fixed by (E, its
// tier): the k16 steps of each warp's slice in order, quarter by quarter,
// then the warps in order; an MMA's output column depends on its own slot
// only and its row on its own weight row only. The attention plan depends
// on (C, H) alone. So a slot's token and new K/V rows are the same bits at
// every B, beside any other slots and at every grid.
//
// Numerics: the JAX kernels' rounding points, as megastep_common.cuh states
// them; the attention's as split_attention.cuh states them. The MMA carries
// a sum in its fp32 accumulator (gemv_stream_tc.cuh's note).
//
// What the card showed (PERF.md §6; scripts/torch_kernel_compare.py
// --batch, scripts/torch_gpt2_step_phases.py --batch): faster than the
// chain it replaces from B = 16 on (bf16: 1.08 against 1.17 ms at B = 16,
// 1.70 against 2.17 at B = 32), slower at B <= 8 (0.81 against 0.67 at B =
// 8): each phase pays a block's dependent latency (the slots' rows staged
// from L2 and normalised, a tile's k16 steps at ~0.2 us each with 8 warps
// an SM, the warps' sums added through shared memory, the attention items'
// counter and combine), so the step is latency-bound, far from its bytes.
// The step calls each helper from one place (its phase loop): an inlined
// copy a phase had made a kernel ~500 KB of code and the build longer.
//
// C interface (ctypes): both entry points take a Gpt2BatchArgs (mirrored by
// ops/megakernel_batch.py's GPT2BatchArgs: the single stream's Gpt2StepArgs
// over [B]-row tensors, then B) and a stream, and return the launch's error
// (0 = success); elit_cuda_error_string names a code,
// elit_gpt2_megabatch_grid gives the blocks an SM holds for a configuration,
// elit_gpt2_megabatch_kernels counts the kernels launched, and
// elit_gpt2_megabatch_skeleton launches the step's weight stream, barriers
// and input staging alone (no arithmetic). The tensors: length, tok_in,
// tok_out [B], x_emb [B, E], the panes [L, B, C, W], their scales
// [L, B, C], the workspace [B, width], lm_val / lm_idx [B, lm_blocks],
// attn_part [B, H, splits, D + 2], sync [2 + B H] zeroed. dtype, kinds,
// tiers, head_dim, E and C as gpt2_megastep.cu's; any grid of at least one
// block.

#include <algorithm>

#include "gemv_stream_tc.cuh"  // the MMA and its bf16 pairs
#include "persistent_step.cuh"

// Mirrored by ops/megakernel_batch.py's GPT2BatchArgs (ctypes).
struct Gpt2BatchArgs {
  Gpt2StepArgs s;  // over [B]-row tensors; attn_part [B, H, splits, D + 2], sync [2 + B H]
  int batch;
};

namespace {

constexpr int kMaxBatch = 32;              // the largest batch: the JAX server's admission wave
constexpr int kDynSmem = 216 * 1024;       // a block's dynamic shared memory at most
constexpr int kRowPad = 32;                // bytes after each staged slot row
constexpr int kHold = 2;                   // fc_proj tiles a block holds across its quarters
constexpr int kMinSlots = 5;               // ring slots fc_proj's staged quarters leave at least

long long g_kernels = 0;  // kernels launched (elit_gpt2_megabatch_kernels)

struct BatchParams {
  MegaArgs a;
  int batch, nt, grid, splits, rows, slots, tile_bytes;
  int rs;             // bytes a staged slot row
  int fcp_q;          // fc_proj's E-input quarters staged at once (4, 2 or 1)
  int h_at, red_at;   // byte offsets in shared memory: staged inputs, the warps' sums
  float* part;
  unsigned* sync;
};

// ------------------------------------------------------------- staging

constexpr int kInFlight = 8;  // 16-byte loads a thread issues before it stores any

// The 16-byte chunks i < total of the staged rows: load(i) -> uint4, then
// store(i, u), kInFlight loads of a thread in flight at a time.
template <typename Load, typename Store>
__device__ __forceinline__ void for_chunks(int total, Load load, Store store) {
  for (int i0 = threadIdx.x; i0 < total; i0 += kInFlight * kThreads) {
    uint4 u[kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j)
      if (i0 + j * kThreads < total) u[j] = load(i0 + j * kThreads);
#pragma unroll
    for (int j = 0; j < kInFlight; ++j)
      if (i0 + j * kThreads < total) store(i0 + j * kThreads, u[j]);
  }
}

// Rows b < B of `src` (ld values apart; K values of T, 16-byte aligned,
// written by other blocks) into the staged rows.
template <typename T>
__device__ __forceinline__ void stage_rows(unsigned char* h, int rs, const T* src, size_t ld,
                                           int B, int K) {
  constexpr int PE = 16 / (int)sizeof(T);
  const int cpr = K / PE;
  for_chunks(B * cpr, [&](int i) {
    const int b = i / cpr;
    return __ldcg(reinterpret_cast<const uint4*>(src + (size_t)b * ld) + (i - b * cpr));
  }, [&](int i, const uint4& u) {
    const int b = i / cpr;
    *reinterpret_cast<uint4*>(h + (size_t)b * rs + (i - b * cpr) * 16) = u;
  });
}

// Layer 0's input rows x[b]: x_emb[b], or wte[tok[b]] + wpe[min(lengths[b],
// P - 1)] rounded to T, into the staged rows (`stage`) and, for block 0,
// into x (`store_x`).
template <typename T>
__device__ __forceinline__ void embed_rows(const MegaArgs& a, const int* lens, const int* toks,
                                           unsigned char* h, int rs, int B, bool stage,
                                           bool store_x) {
  constexpr int PE = 16 / (int)sizeof(T);
  const int E = a.n_embd, cpr = E / PE;
  uint4* x = static_cast<uint4*>(a.x);
  auto put = [&](int i, const uint4& u) {
    const int b = i / cpr, c = i - b * cpr;
    if (stage) *reinterpret_cast<uint4*>(h + (size_t)b * rs + c * 16) = u;
    if (store_x) x[(size_t)b * cpr + c] = u;
  };
  if (a.x_emb != nullptr) {
    for_chunks(B * cpr, [&](int i) {
      return __ldcg(static_cast<const uint4*>(a.x_emb) + i);
    }, put);
    return;
  }
  const uint4* wte = static_cast<const uint4*>(a.wte);
  const uint4* wpe = static_cast<const uint4*>(a.wpe);
  for_chunks(B * cpr, [&](int i) {
    const int b = i / cpr, c = i - b * cpr;
    const uint4 w = wte[(size_t)toks[b] * cpr + c];
    const uint4 p = wpe[(size_t)min(max(lens[b], 0), a.n_pos - 1) * cpr + c];
    float wv[PE], pv[PE];
    unpack16(w, wv);
    unpack16(p, pv);
#pragma unroll
    for (int k = 0; k < PE; ++k) wv[k] += pv[k];
    return pack16<T>(wv);  // rounds to T
  }, put);
}

// LayerNorm of the staged rows in place (fp32 statistics, the output rounded
// to T, megastep_common.cuh's PRO_LN): slot b's mean and variance by warp b
// % 8, lanes strided over E in order then a shuffle tree.
template <typename T>
__device__ __forceinline__ void norm_rows(unsigned char* h, int rs, int B, int E, const float* g,
                                          const float* bn, float eps, float (*stat)[kMaxBatch]) {
  constexpr int PE = 16 / (int)sizeof(T);  // values a 16-byte chunk
  constexpr int kUnroll = 4;               // chunks a thread normalizes at a time
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, cpr = E / PE;
  __syncthreads();  // the rows are staged
  for (int b = warp; b < B; b += kWarps) {  // lane l: chunks l, l + 32, ... in order
    const uint4* row = reinterpret_cast<const uint4*>(h + (size_t)b * rs);
    float s = 0.0f;
    for (int c = lane; c < cpr; c += 32) {
      float v[PE];
      unpack16(row[c], v);
#pragma unroll
      for (int i = 0; i < PE; ++i) s += v[i];
    }
    const float mean = warp_sum(s) / (float)E;
    float s2 = 0.0f;
    for (int c = lane; c < cpr; c += 32) {
      float v[PE];
      unpack16(row[c], v);
#pragma unroll
      for (int i = 0; i < PE; ++i) {
        const float d = v[i] - mean;
        s2 += d * d;
      }
    }
    const float r = rsqrtf(warp_sum(s2) / (float)E + eps);
    if (lane == 0) {
      stat[0][b] = mean;
      stat[1][b] = r;
    }
  }
  __syncthreads();
  const int total = B * cpr;
  for (int i0 = threadIdx.x; i0 < total; i0 += kUnroll * kThreads) {
    uint4 u[kUnroll];
    float4 gv[kUnroll][PE / 4], bv[kUnroll][PE / 4];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int i = i0 + j * kThreads;
      if (i >= total) break;
      const int bb = i / cpr, c = i - bb * cpr;
      u[j] = *reinterpret_cast<const uint4*>(h + (size_t)bb * rs + c * 16);
#pragma unroll
      for (int q = 0; q < PE / 4; ++q) {
        gv[j][q] = __ldg(reinterpret_cast<const float4*>(g + c * PE) + q);
        bv[j][q] = __ldg(reinterpret_cast<const float4*>(bn + c * PE) + q);
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int i = i0 + j * kThreads;
      if (i >= total) break;
      const int bb = i / cpr, c = i - bb * cpr;
      float v[PE];
      unpack16(u[j], v);
      const float* gs = reinterpret_cast<const float*>(gv[j]);
      const float* bs = reinterpret_cast<const float*>(bv[j]);
#pragma unroll
      for (int k = 0; k < PE; ++k) v[k] = (v[k] - stat[0][bb]) * stat[1][bb] * gs[k] + bs[k];
      *reinterpret_cast<uint4*>(h + (size_t)bb * rs + c * 16) = pack16<T>(v);  // rounds to T
    }
  }
  __syncthreads();
}

// ------------------------------------------------------------- the product

// Loads from shared memory by its state space (a generic pointer into the
// ring would be read through the generic path).
__device__ __forceinline__ uint2 lds64(const void* p) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(smem_addr(p)));
  return v;
}
__device__ __forceinline__ unsigned lds32(const void* p) {
  unsigned v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(smem_addr(p)));
  return v;
}
__device__ __forceinline__ unsigned lds16(const void* p) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(smem_addr(p)));
  return v;
}

// The four codes / values of one row at input k as fp32 (fp32 model dtype).
template <int WK>
__device__ __forceinline__ void row4(const unsigned char* row, int k, float (&w)[4]) {
  if constexpr (WK == W_T) {
    const float4 v = *reinterpret_cast<const float4*>(row + (size_t)k * 4);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (WK == W_I8) {
    const unsigned u = lds32(row + k) ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = code_i8(u, i);
  } else {
    const unsigned u = lds16(row + k / 2) ^ 0x8888u;
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = code_i4(u, i);
  }
}

// Row `row`'s inputs k .. k + 3 of an MMA's A fragment as loaded (W_T: two
// bf16 pairs; W_I8: four codes in .x; W_I4: four codes in .x's low 16 bits)
// and as two bf16 pairs (lo: k, k + 1; hi: k + 2, k + 3).
template <int WK>
__device__ __forceinline__ uint2 row_raw(const unsigned char* row, int k) {
  if constexpr (WK == W_T) return lds64(row + (size_t)k * 2);
  if constexpr (WK == W_I8) return make_uint2(lds32(row + k), 0u);
  return make_uint2(lds16(row + k / 2), 0u);
}
template <int WK>
__device__ __forceinline__ void row_frag(const uint2& u, unsigned& lo, unsigned& hi) {
  if constexpr (WK == W_T) {
    lo = u.x;
    hi = u.y;
  } else {
    const unsigned x = u.x ^ (WK == W_I8 ? 0x80808080u : 0x8888u);
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = WK == W_I8 ? code_i8(x, i) : code_i4(x, i);
    lo = stc::bf16x2(w[0], w[1]);
    hi = stc::bf16x2(w[2], w[3]);
  }
}

constexpr int kChunk = 4;  // k16 steps whose fragments a warp loads before their MMAs

// The warp's product over its slice, acc[j][2h + e] being (row g + 8h,
// slot 8j + 2t + e), g = lane / 4, t = lane % 4: the staged rows it reads,
// B's last for the n8 tiles' slots past B (their columns are not used).
template <typename T, int WK>
struct Product {
  static constexpr int STEP = sizeof(T) == 2 ? 16 : 4;  // inputs a step
  static constexpr int XR = sizeof(T) == 2 ? 1 : 2;     // staged rows a lane reads a tile
  const unsigned char* x[4][XR];

  __device__ __forceinline__ Product(const unsigned char* h, int rs, int B) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < XR; ++e) {
        const int slot = XR == 1 ? 8 * j + g : 8 * j + 2 * t4 + e;
        x[j][e] = h + (size_t)min(slot, B - 1) * rs + (XR == 1 ? 8 * t4 : 0);
      }
  }

  // Four inputs (fp32) from weight input k of rows ra, rb and staged input ki.
  __device__ __forceinline__ void step32(const unsigned char* ra, const unsigned char* rb, int k,
                                         int ki, int nt, float (&acc)[4][4]) const {
    float wa[4], wb[4];
    row4<WK>(ra, k, wa);
    row4<WK>(rb, k, wb);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 xv = *reinterpret_cast<const float4*>(x[j][e] + (size_t)ki * 4);
          const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[j][e] = fmaf(wa[i], xs[i], acc[j][e]);
            acc[j][2 + e] = fmaf(wb[i], xs[i], acc[j][2 + e]);
          }
        }
      }
    }
  }

  // The warp's slice: weight inputs [kw, kw + kq) of rows ra, rb (their
  // bytes in the ring slot) against staged inputs [ki, ki + kq), added into
  // acc. bf16: kChunk k16 steps at a time, their fragments loaded before
  // their MMAs. W_I4: each group's sum times the rows' scales (s4a, s4b:
  // the rows' group scales in T, requested with the chunk's fragments),
  // fused into acc at the group's end or the slice's.
  __device__ __forceinline__ void slice(const unsigned char* ra, const unsigned char* rb, int kw,
                                        int ki, int kq, int nt, const T* s4a, const T* s4b,
                                        int G, float (&acc)[4][4]) const {
    if constexpr (sizeof(T) == 4) {
      if constexpr (WK != W_I4) {
        for (int k = 0; k < kq; k += STEP) step32(ra, rb, kw + k, ki + k, nt, acc);
      } else {
        for (int k = 0; k < kq;) {
          const int grp = (kw + k) / G, end = min(kq, (grp + 1) * G - kw);
          const float sa = to_f32(s4a[grp]), sb = to_f32(s4b[grp]);
          float ga[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) ga[j][q] = 0.0f;
          for (; k < end; k += STEP) step32(ra, rb, kw + k, ki + k, nt, ga);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[j][0] = fmaf(ga[j][0], sa, acc[j][0]);
            acc[j][1] = fmaf(ga[j][1], sa, acc[j][1]);
            acc[j][2] = fmaf(ga[j][2], sb, acc[j][2]);
            acc[j][3] = fmaf(ga[j][3], sb, acc[j][3]);
          }
        }
      }
    } else {
      const int t4 = threadIdx.x & 3;
      float ga[4][4];  // W_I4: the open group's sums
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) ga[j][q] = 0.0f;
      for (int k0 = 0; k0 < kq; k0 += kChunk * 16) {
        uint2 wa[kChunk], wb[kChunk], xv[kChunk][4];
        float sa[kChunk], sb[kChunk];
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const int k = k0 + 16 * c;
          if (k >= kq) break;
          wa[c] = row_raw<WK>(ra, kw + k + 4 * t4);
          wb[c] = row_raw<WK>(rb, kw + k + 4 * t4);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < nt) xv[c][j] = *reinterpret_cast<const uint2*>(x[j][0] + (size_t)(ki + k) * 2);
          if constexpr (WK == W_I4) {
            sa[c] = to_f32(s4a[(kw + k) / G]);
            sb[c] = to_f32(s4b[(kw + k) / G]);
          }
        }
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const int k = k0 + 16 * c;
          if (k >= kq) break;
          unsigned a[4];
          row_frag<WK>(wa[c], a[0], a[2]);
          row_frag<WK>(wb[c], a[1], a[3]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j >= nt) continue;
            if constexpr (WK == W_I4)
              stc::mma_bf16(ga[j], a, xv[c][j].x, xv[c][j].y);
            else
              stc::mma_bf16(acc[j], a, xv[c][j].x, xv[c][j].y);
          }
          if constexpr (WK == W_I4) {
            if ((kw + k + 16) % G == 0 || k + 16 == kq) {  // the group's (or slice's) end
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                acc[j][0] = fmaf(ga[j][0], sa[c], acc[j][0]);
                acc[j][1] = fmaf(ga[j][1], sa[c], acc[j][1]);
                acc[j][2] = fmaf(ga[j][2], sb[c], acc[j][2]);
                acc[j][3] = fmaf(ga[j][3], sb[c], acc[j][3]);
#pragma unroll
                for (int q = 0; q < 4; ++q) ga[j][q] = 0.0f;
              }
            }
          }
        }
      }
    }
  }
};

// ------------------------------------------------------------- GEMV phases

// A ring tile of the batched step: the single stream's 16 rows in bf16; 4
// rows in fp32 (the single stream's 8 are 40 KB at GPT-2 large, and two such
// slots beside 25 or more staged fp32 rows do not fit a block). A tile's
// rows change no sum: the warps split K.
template <typename T, int WK>
struct BTile {
  static constexpr int items = sizeof(T) == 4 ? 4 : Tile<T, WK>::items;
};
template <typename T, int WK>
using BStream = Stream<T, WK, BTile<T, WK>::items>;

// A sums buffer's stride over a slot's rows: a tile's rows and one more, so
// the lanes of a fragment store fall in distinct banks.
template <typename T, int WK>
__host__ __device__ constexpr int red_rows() {
  return BTile<T, WK>::items + 1;
}

// A thread's running first maximum of the LM head for its (up to two) slots.
struct Best {
  float v[2];
  int i[2];
};

// One GEMV phase of `kind` in layer l (the LM head: l = n_layer) over the
// staged inputs: each of the block's tiles as it arrives, its product by the
// 8 warps' K slices, their sums added in warp order, then the tile's
// epilogue `epi`, thread (r, s) taking row r = tid % RT of the tile and
// slots s = tid / RT, tid / RT + 256 / RT. fc_proj (`src`: its [B, 4E]
// inputs) holds up to kHold tiles and stages its K quarters in turn. The
// step calls it from one place (its phase loop), so its code is one copy
// whatever the phase: a step's code is what the SM's instruction caches keep.
template <typename T, int WK>
__device__ __forceinline__ void gemv_phase(BStream<T, WK>& S, const BatchParams& P, int kind, int l,
                                           int epi, const void* scales, const float* bias,
                                           T* out, const T* src, unsigned char* smem, int& rpar,
                                           Best& best) {
  constexpr int TI = BTile<T, WK>::items, RR = red_rows<T, WK>();
  const MegaArgs& a = P.a;
  const PhasePlan& ph = S.plan[kind];
  const int E = a.n_embd, N = kind_rows(kind, E, a.vocab), ks = kind_split(kind), K = ks * E;
  const int B = P.batch, nt = P.nt, NP = 8 * nt, rs = P.rs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int RT = TI / ks, rows = ph.items / ks, row_bytes = ks * item_bytes<T, WK>(E);
  const int hold = ks > P.fcp_q ? kHold : 1, kq = E / kWarps;  // tiles held across stagings
  const int ng = WK == W_I4 ? K / a.w_group : 1;
  const size_t srow = (size_t)(kind == K_HEAD ? 0 : l) * N;  // the layer's first scale row
  const T* s4 = WK == W_I4 ? static_cast<const T*>(scales) + srow * ng : nullptr;
  const float* s8 = WK == W_I8 ? static_cast<const float*>(scales) + srow : nullptr;
  unsigned char* h = smem + P.h_at;
  float* red = reinterpret_cast<float*>(smem + P.red_at);
  const int red_floats = kWarps * NP * RR;
  const int r = tid % RT, cs = kThreads / RT;
  const Product<T, WK> prod(h, rs, B);
  for (int t0 = 0; t0 < ph.tiles; t0 += hold) {
    const int nh = min(hold, ph.tiles - t0);
    // the epilogue's inputs of this thread's (row, slot)s, requested first
    float pre[kHold][2], bi[kHold][2], sc[kHold][2];
#pragma unroll
    for (int i = 0; i < kHold; ++i) {
      const int row = ph.r0 + (t0 + i) * RT + r;
      const bool rin = i < nh && (t0 + i) * RT + r < rows;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int s = tid / RT + cs * u;
        const bool in = rin && s < B;
        bi[i][u] = in && bias != nullptr ? bias[row] : 0.0f;
        sc[i][u] = WK == W_I8 && in ? s8[row] : 1.0f;
        pre[i][u] = epi == E_RESIDUAL && in ? ldcg_f32(out + (size_t)s * N + row) : 0.0f;
      }
    }
    const unsigned char* tp[kHold];
    int n_rows[kHold];
#pragma unroll
    for (int i = 0; i < kHold; ++i) {
      tp[i] = i < nh ? S.next() : nullptr;
      n_rows[i] = i < nh ? min(RT, rows - (t0 + i) * RT) : 0;
    }
    float acc[kHold][4][4];
#pragma unroll
    for (int i = 0; i < kHold; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
    for (int q = 0; q < ks; ++q) {
      const int qs = q % P.fcp_q;  // the quarter's place among the staged ones
      if (ks > 1 && qs == 0 && (t0 == 0 || hold > 1)) {  // the next staged quarters
        __syncthreads();
        stage_rows<T>(h, rs, src + (size_t)q * E, (size_t)K, B, P.fcp_q * E);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < kHold; ++i) {
        if (i < nh) {
          // rows g, g + 8 of the tile (a row past it: its last row, unused)
          const int ra = min(g, n_rows[i] - 1), rb = min(g + 8, n_rows[i] - 1);
          const int row0 = ph.r0 + (t0 + i) * RT;
          prod.slice(tp[i] + (size_t)ra * row_bytes, tp[i] + (size_t)rb * row_bytes,
                     q * E + warp * kq, qs * E + warp * kq, kq, nt,
                     s4 + (size_t)(row0 + ra) * ng, s4 + (size_t)(row0 + rb) * ng, a.w_group,
                     acc[i]);
        }
      }
    }
    // the warps' sums out: acc[j][2h + e] -> (slot 8j + 2t + e, row g + 8h)
#pragma unroll
    for (int i = 0; i < kHold; ++i) {
      if (i >= nh) continue;
      float* rd = red + ((rpar + i) & 1) * red_floats + warp * NP * RR;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= nt) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = g + 8 * (q >> 1), slot = 8 * j + 2 * t4 + (q & 1);
          if (row < RT) rd[slot * RR + row] = acc[i][j][q];
        }
      }
    }
    for (int i = 0; i < nh; ++i) S.consumed();  // a block barrier: the sums are in
#pragma unroll
    for (int i = 0; i < kHold; ++i) {
      if (i >= nh) continue;
      const float* rd = red + ((rpar + i) & 1) * red_floats;
      const int row = ph.r0 + (t0 + i) * RT + r;
      if ((t0 + i) * RT + r >= rows) continue;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int s = tid / RT + cs * u;
        if (s >= B) continue;
        float y = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) y += rd[(w * NP + s) * RR + r];
        if (epi == E_ARGMAX) {
          const float v = __fmul_rn(y, sc[i][u]);
          if (better(v, row, best.v[u], best.i[u])) {
            best.v[u] = v;
            best.i[u] = row;
          }
        } else {
          const float z = __fmul_rn(y, sc[i][u]) + bi[i][u];
          out[(size_t)s * N + row] = from_f32<T>(epi == E_GELU       ? gelu_tanh(z)
                                                 : epi == E_RESIDUAL ? pre[i][u] + round_to<T>(z)
                                                                     : z);
        }
      }
    }
    rpar ^= nh & 1;
  }
}

// ---------------------------------------------------------- attention

// Slot b's view of layer l's split attention ([L, B, C, W] panes).
template <typename T>
__device__ __forceinline__ SplitAttn slot_attention(const BatchParams& P, int l, int b, int D) {
  const MegaArgs& a = P.a;
  const int E = a.n_embd, H = a.n_head, B = P.batch, C = a.capacity;
  SplitAttn at{};
  AttnParams& ap = at.p;
  ap.qkv = static_cast<const T*>(a.qkv) + (size_t)b * 3 * E;
  ap.k = static_cast<char*>(a.k) + pane_offset(a.k_kind, sizeof(T), l * B + b, C, E);
  ap.v = static_cast<char*>(a.v) + pane_offset(a.v_kind, sizeof(T), l * B + b, C, E);
  ap.ks = a.ks ? a.ks + (size_t)(l * B + b) * C : nullptr;
  ap.vs = a.vs ? a.vs + (size_t)(l * B + b) * C : nullptr;
  ap.length = a.length + b;
  ap.capacity = C;
  ap.n_head = H;
  ap.q_width = ap.kv_width = E;
  ap.group = 1;
  ap.sm_scale = 1.0f / sqrtf((float)D);
  ap.quant_eps = a.quant_eps;
  ap.out = static_cast<T*>(a.attn) + (size_t)b * E;
  at.n_kv = H;
  at.splits = P.splits;
  at.rows = P.rows;
  at.part = P.part + (size_t)b * H * P.splits * (D + 2);
  at.count = reinterpret_cast<int*>(P.sync + 2) + b * H;
  return at;
}

// One layer's attention phase: (slot, head, split) items over the grid's
// warps (split_attention_warp_item: 8 items a block at once), then a writer a
// slot (row lengths[b] of slot b's panes); each warp's first item's rows
// are loaded before the qkv phase's grid barrier, which this function passes.
template <typename T, int KK, int VK, int D>
__device__ __noinline__ void attention_phase(const BatchParams& P, int l, unsigned char* h,
                                             const int* lens, float* red) {
  const MegaArgs& a = P.a;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int E = a.n_embd, H = a.n_head, B = P.batch, C = a.capacity;
  float* hf = reinterpret_cast<float*>(h);
  const int per_slot = H * P.splits, n_items = B * per_slot, stride = P.grid * kWarps;
  float* sc = hf + warp * P.rows;  // this warp's scores
  WarpRows<T, KK, VK, D> r;
  int it = blockIdx.x * kWarps + warp;
  if (it < n_items) {
    const int b = it / per_slot;
    warp_rows<T, KK, VK, D>(slot_attention<T>(P, l, b, D), it - b * per_slot, 0, r);
  }
  grid_sync(P.sync, P.grid);  // the qkv phase's: q|k|v are in
  for (bool first = true; it < n_items; it += stride, first = false) {
    const int b = it / per_slot;
    const SplitAttn at = slot_attention<T>(P, l, b, D);
    if (!first) warp_rows<T, KK, VK, D>(at, it - b * per_slot, 0, r);
    split_attention_warp_item<T, KK, VK, D>(at, it - b * per_slot, sc, lens[b], r);
  }
  __syncthreads();  // the writers reuse the warps' scores
  // row lengths[b] of slot b's panes, by the last blocks (the items fill the first)
  for (int b = P.grid - 1 - blockIdx.x; b < B; b += P.grid) {
    if (lens[b] >= 0 && lens[b] < C) {
      const SplitAttn at = slot_attention<T>(P, l, b, D);
      const T* kc = static_cast<const T*>(at.p.qkv) + E;
      for (int e = tid; e < E; e += kThreads) {
        hf[e] = ldcg_f32(kc + e);
        hf[E + e] = ldcg_f32(kc + E + e);
      }
      __syncthreads();
      write_row<T, KK>(hf, at.p.k, at.p.ks, lens[b], E, a.quant_eps, red);
      write_row<T, VK>(hf + E, at.p.v, at.p.vs, lens[b], E, a.quant_eps, red);
    }
    __syncthreads();  // the next writer reuses the shared memory
  }
}

// ------------------------------------------------------------------ step

template <typename T, int KK, int VK, int WK, bool SKEL>
__global__ void __launch_bounds__(kThreads, 1)
gpt2_batch_kernel(const __grid_constant__ BatchParams P) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxSlots];
  __shared__ PhasePlan plan[5];
  __shared__ float stat[2][kMaxBatch];
  __shared__ float red[kWarps];
  __shared__ int lens[kMaxBatch], toks[kMaxBatch];
  __shared__ int is_last;
  const MegaArgs& a = P.a;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int E = a.n_embd, L = a.n_layer, D = E / a.n_head, B = P.batch;
  unsigned char* h = smem + P.h_at;
  if (tid == 0) {
    for (int s = 0; s < P.slots; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < B) {
    lens[tid] = __ldcg(a.length + tid);
    toks[tid] = a.tok_in != nullptr ? min(max(__ldcg(a.tok_in + tid), 0), a.vocab - 1) : 0;
  }
  BStream<T, WK> S;
  S.init(a, P.grid, P.slots, P.tile_bytes, plan, smem, full);  // a block barrier
  S.fill();
  unsigned* bar = P.sync;
  T* x = static_cast<T*>(a.x);
  T* qkv = static_cast<T*>(a.qkv);
  T* attn = static_cast<T*>(a.attn);
  T* ffn = static_cast<T*>(a.ffn);
  if (SKEL) {  // the weight stream, the barriers and the inputs' staging alone
    for (int l = 0; l < L; ++l) {
      for (int k = K_QKV; k <= K_FCP; ++k) {
        const T* in = k == K_PROJ ? attn : (k == K_FCP ? ffn : x);
        for (int q = 0; q < kind_split(k); ++q) {
          stage_rows<T>(h, P.rs, in + (size_t)q * E, (size_t)kind_split(k) * E, B, E);
          __syncthreads();
        }
        S.skip(k);
        grid_sync(bar, P.grid);
        if (k == K_QKV) grid_sync(bar, P.grid);  // the attention phase's
      }
    }
    stage_rows<T>(h, P.rs, x, (size_t)E, B, E);
    S.skip(K_HEAD);
    return;
  }
  int rpar = 0;
  Best best = {{-INFINITY, -INFINITY}, {0, 0}};
  // The phases in order: per layer qkv (then the attention), proj, fc,
  // fc_proj, each with its prologue; then the LM head. One call site each.
  for (int ph = 0; ph <= 4 * L; ++ph) {
    const int l = ph / 4, kind = ph == 4 * L ? K_HEAD : ph % 4;
    const float* sm = a.smalls + (size_t)min(l, L - 1) * 13 * E;
    const bool rows = S.plan[kind].tiles > 0;
    // the prologue: layer 0's embedding, or the phase's inputs staged (fc_proj
    // stages its own quarters), then the layer norm of qkv, fc and the head
    if (kind == K_QKV && l == 0) {
      if (rows || blockIdx.x == 0) embed_rows<T>(a, lens, toks, h, P.rs, B, rows, blockIdx.x == 0);
    } else if (rows && kind != K_FCP) {
      stage_rows<T>(h, P.rs, kind == K_PROJ ? attn : x, (size_t)E, B, E);
    }
    if (rows && (kind == K_QKV || kind == K_FC || kind == K_HEAD)) {
      const float* gain = kind == K_HEAD ? a.lnf : sm + (kind == K_FC ? 2 * E : 0);
      norm_rows<T>(h, P.rs, B, E, gain, gain + E, a.ln_eps, stat);
    } else if (rows && kind == K_PROJ) {
      __syncthreads();
    }
    const void* scales = kind == K_QKV  ? a.attn_s
                         : kind == K_PROJ ? a.proj_s
                         : kind == K_FC   ? a.fc_s
                         : kind == K_FCP  ? a.fcp_s
                                          : a.head_s;
    const float* bias = kind == K_HEAD ? nullptr : sm + (kind == K_QKV ? 4 : kind == K_PROJ ? 7
                                                         : kind == K_FC ? 8 : 12) * E;
    T* out = kind == K_QKV ? qkv : kind == K_FC ? ffn : kind == K_HEAD ? nullptr : x;
    const int epi = kind == K_QKV ? E_STORE
                    : kind == K_FC ? E_GELU
                    : kind == K_HEAD ? E_ARGMAX : E_RESIDUAL;
    gemv_phase<T, WK>(S, P, kind, l, epi, scales, bias, out, ffn, smem, rpar, best);
    if (kind == K_QKV) {  // its first pane rows loaded before the barrier it passes
      if (D == 64)
        attention_phase<T, KK, VK, 64>(P, l, h, lens, red);
      else
        attention_phase<T, KK, VK, 128>(P, l, h, lens, red);
    }
    if (kind != K_HEAD) grid_sync(bar, P.grid);
  }
  {  // the threads of a slot are RT neighbours (a half or quarter warp)
    constexpr int RT = BTile<T, WK>::items;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float v = best.v[u];
      int i = best.i[u];
#pragma unroll
      for (int o = 1; o < RT; o <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, o);
        const int oi = __shfl_xor_sync(0xffffffffu, i, o);
        if (better(ov, oi, v, i)) { v = ov; i = oi; }
      }
      const int s = tid / RT + kThreads / RT * u;
      if (tid % RT == 0 && s < B) {
        a.lm_val[(size_t)s * a.lm_blocks + blockIdx.x] = v;
        a.lm_idx[(size_t)s * a.lm_blocks + blockIdx.x] = i;
      }
    }
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
  // the last block: each slot's first maximum over the partials -> its token
  for (int s = warp; s < B; s += kWarps) {
    float v = -INFINITY;
    int i = 0;
    for (int p = lane; p < P.grid; p += 32) {
      const float pv = __ldcg(a.lm_val + (size_t)s * a.lm_blocks + p);
      const int pi = __ldcg(a.lm_idx + (size_t)s * a.lm_blocks + p);
      if (better(pv, pi, v, i)) { v = pv; i = pi; }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, o);
      const int oi = __shfl_xor_sync(0xffffffffu, i, o);
      if (better(ov, oi, v, i)) { v = ov; i = oi; }
    }
    if (lane == 0) {
      if (a.advance) {
        i = min(max(i, 0), a.vocab - 1);
        a.length[s] = lens[s] + 1;
      }
      a.tok_out[s] = i;
    }
  }
  if (tid == 0) P.sync[1] = 0;  // the ticket, clean for the next launch
}

// ------------------------------------------------------------------- host

// A block's shared memory after its ring: the B staged slot rows (the 8
// warps' attention scores or the writer's k and v where larger), then two
// buffers of the warps' sums of a tile (for the n8 tiles' slots). A staged
// row holds fcp_q of fc_proj's E-input quarters: all four where the ring
// keeps kMinSlots slots beside them, else two, else one (GPT-2 small in bf16:
// four up to B = 8, two up to 16, one at 32). The sums' order does not
// depend on it.
struct Smem {
  int slots, tile_bytes, rs, fcp_q, h_at, red_at;
  size_t total;
};

template <typename T, int WK>
Smem smem_plan(int E, int rows, int B) {
  Smem m{};
  m.tile_bytes = BTile<T, WK>::items * item_bytes<T, WK>(E);
  const int np = 8 * ((B + 7) / 8);  // the n8 tiles' slots
  const size_t red = 2 * (size_t)kWarps * np * red_rows<T, WK>() * sizeof(float);
  for (m.fcp_q = 4;; m.fcp_q /= 2) {
    m.rs = m.fcp_q * E * (int)sizeof(T) + kRowPad;
    const size_t h = std::max({(size_t)B * m.rs, (size_t)kWarps * rows * sizeof(float),
                               2 * (size_t)E * sizeof(float)});
    const size_t h16 = (h + 15) / 16 * 16;
    const long long ring = std::min<long long>(kRingBytes, (long long)kDynSmem - h16 - red);
    m.slots = ring > 0 ? (int)std::min<long long>(kMaxSlots, ring / m.tile_bytes) : 0;
    m.h_at = m.slots * m.tile_bytes;
    m.red_at = m.h_at + (int)h16;
    m.total = m.red_at + red;
    if (m.slots >= kMinSlots || m.fcp_q == 1) return m;
  }
}

// One configuration's kernel: launched (cooperatively, s.grid blocks) or,
// with per_sm, its blocks an SM.
struct Launch {
  const Gpt2BatchArgs& ba;
  cudaStream_t st;
  int* per_sm;

  template <typename T, int KK, int VK, int WK, bool SKEL = false>
  int run() const {
    const Gpt2StepArgs& s = ba.s;
    const int B = ba.batch;
    const Smem m = smem_plan<T, WK>(s.a.n_embd, s.attn_rows, B);
    if (m.slots < 2) return (int)cudaErrorInvalidValue;
    const BatchParams P{s.a,  B,    (B + 7) / 8, s.grid,  s.attn_splits, s.attn_rows,
                        m.slots, m.tile_bytes, m.rs, m.fcp_q, m.h_at, m.red_at,
                        s.attn_part, s.sync};
    auto kernel = gpt2_batch_kernel<T, KK, VK, WK, SKEL>;
    if (int rc = allow_smem(kernel, m.total)) return rc;
    if (per_sm != nullptr)
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, m.total);
    const int rc = launch_cooperative(kernel, P.grid, m.total, st, P);
    if (rc == 0) ++g_kernels;
    return rc;
  }
};

template <typename T, int KK, int VK>
int by_tier(const Launch& f) {
  const int wk = f.ba.s.a.w_kind;
  if (wk == W_T) return f.run<T, KK, VK, W_T>();
  if (wk == W_I8) return f.run<T, KK, VK, W_I8>();
  if (wk == W_I4) return f.run<T, KK, VK, W_I4>();
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int by_panes(const Launch& f) {
  const int kk = f.ba.s.a.k_kind, vk = f.ba.s.a.v_kind;
  if (kk == 0 && vk == 0) return by_tier<T, 0, 0>(f);
  if (kk == 8 && vk == 8) return by_tier<T, 8, 8>(f);
  if (kk == 4 && vk == 4) return by_tier<T, 4, 4>(f);
  if (kk == 8 && vk == 4) return by_tier<T, 8, 4>(f);
  return (int)cudaErrorInvalidValue;
}

int dispatch(const Launch& f) {
  if (f.ba.s.a.dtype == 0) return by_panes<float>(f);
  if (f.ba.s.a.dtype == 1) return by_panes<__nv_bfloat16>(f);
  return (int)cudaErrorInvalidValue;
}

// The arguments' checks; `quant`: quantized panes expected.
bool args_ok(const Gpt2BatchArgs* ba, bool quant) {
  if (ba == nullptr || !step_args_ok(&ba->s, quant)) return false;
  const int D = ba->s.a.n_embd / ba->s.a.n_head;
  return ba->batch >= 1 && ba->batch <= kMaxBatch && (D == 64 || D == 128);
}

int run(const Gpt2BatchArgs* ba, void* stream, bool quant) {
  if (!args_ok(ba, quant)) return (int)cudaErrorInvalidValue;
  return dispatch(Launch{*ba, static_cast<cudaStream_t>(stream), nullptr});
}

}  // namespace

extern "C" int elit_gpt2_megabatch(const Gpt2BatchArgs* a, void* stream) {
  return run(a, stream, false);
}

extern "C" int elit_gpt2_megabatch_quant(const Gpt2BatchArgs* a, void* stream) {
  return run(a, stream, true);
}

// The blocks an SM holds of the kernel the arguments select (*per_sm) and
// the card's SM count (*sms): the launcher's grid is their product.
extern "C" int elit_gpt2_megabatch_grid(const Gpt2BatchArgs* a, int* per_sm, int* sms) {
  if (a == nullptr || per_sm == nullptr || sms == nullptr || a->batch < 1 ||
      a->batch > kMaxBatch)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (cudaError_t e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev))
    return (int)e;
  return dispatch(Launch{*a, nullptr, per_sm});
}

// The step's weight stream, barriers and the B slots' input staging without
// arithmetic (bf16 weights of any tier; the arguments of a step, whose
// outputs it leaves as they are).
extern "C" int elit_gpt2_megabatch_skeleton(const Gpt2BatchArgs* a, void* stream) {
  if (a == nullptr || a->s.a.dtype != 1 || a->s.grid < 1 || a->s.sync == nullptr ||
      a->batch < 1 || a->batch > kMaxBatch)
    return (int)cudaErrorInvalidValue;
  const Launch f{*a, static_cast<cudaStream_t>(stream), nullptr};
  if (a->s.a.w_kind == W_T) return f.run<__nv_bfloat16, 0, 0, W_T, true>();
  if (a->s.a.w_kind == W_I8) return f.run<__nv_bfloat16, 0, 0, W_I8, true>();
  if (a->s.a.w_kind == W_I4) return f.run<__nv_bfloat16, 0, 0, W_I4, true>();
  return (int)cudaErrorInvalidValue;
}

extern "C" long long elit_gpt2_megabatch_kernels() { return g_kernels; }

extern "C" const char* elit_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
