// Split-KV decode attention of one (K/V head, split) item, shared by the
// single-stream steps: the Llama/Qwen chain's attention kernel
// (llama_megastep.cu, one block an item) and GPT-2's persistent step
// (gpt2_megastep.cu, a block's items of the layer's attention phase); and
// its warp-level form (split_attention_warp_item, below: a warp an item) in
// GPT-2's batched persistent step (gpt2_megabatch.cu); and its verify forms
// (verify_attention_item and verify_attention_item_staged, below: R rows of
// one sequence) in GPT-2's persistent verify (gpt2_megaverify.cu) and the
// Llama/Qwen verify chain (megaverify.cu); all merged by the same combine
// (combine_value).
//
// Item b < n_kv * splits: K/V head hk = b / splits over rows
// [s * rows, min((s + 1) * rows, length)) of the layer's panes (s = b %
// splits), for the `group` query heads hk * group .. (hk + 1) * group - 1.
// Each K and V row is read once for the whole group (HC heads a pass hold
// their q in registers; a group of more reads the rows again from L2).
// Phase 1: the group's scores of the split's rows into shared memory (D/8
// lanes a row, 8 dims each, one shuffle tree a head). Phase 2: a warp a
// head: the split's max m_s, exp(s - m_s) (times the V scale and rounded
// to T for quantized panes) and their sum l_s. Phase 3: PV, summed over a
// warp's row slots by shuffles and over the warps in shared memory, to the
// partial (m_s, l_s, acc_s[D]) of each head. A split past the length writes
// the neutral partial (-inf, 0, 0). The last item of a K/V head to finish
// (a counter the combiner resets to zero, so the next launch or layer finds
// it clean) merges the splits and the current token. The current token's
// q | k | v are read with ld.global.cg: in a persistent kernel another block
// wrote them during the same launch, and L1 is not coherent.
//
// Numerics (megastep_common.cuh's rounding points): in fp32, a split's
// scores, its max m_s, exp(s - m_s), their sum l_s and the PV sums acc_s;
// the combine takes M = max(m_s, s_cur) and out = (sum_s acc_s e^(m_s - M)
// + e^(s_cur - M) v_cur) / (sum_s l_s e^(m_s - M) + e^(s_cur - M)), the
// same softmax as one pass in another order of fp32 rounding. Quantized
// panes: the probabilities times the V scales are rounded to the model dtype
// relative to the split's max m_s, then rescaled in fp32 at the combine.

#pragma once

#include "megastep_common.cuh"

namespace {

constexpr int kCombine = 16;  // splits the combine reads in one round trip

struct SplitAttn {
  AttnParams p;  // cos / sin: the step's RoPE rows, or null (no RoPE)
  int n_kv, splits, rows;
  float* part;  // [n_head, splits, D + 2]: (m, l, acc[D]) a query head and split
  int* count;   // [n_kv] finished splits, zero between uses
};

// Output value d of query head j of the splits' partials merged with the
// current token (score s_cur, value v_cur): M over the splits' maxima and
// s_cur, kCombine splits' (m, l, acc[d]) in one round trip, running sums
// rescaled when a later chunk raises M; a split past the length weighs 0.
__device__ __forceinline__ float combine_value(const SplitAttn& a, int j, int D, int d,
                                               float s_cur, float v_cur) {
  float M = s_cur, L = 0.0f, num = 0.0f;
  for (int t0 = 0; t0 < a.splits; t0 += kCombine) {
    float mv[kCombine], lv[kCombine], av[kCombine];
#pragma unroll
    for (int i = 0; i < kCombine; ++i) {
      const bool in = t0 + i < a.splits;
      const float* pt = a.part + ((size_t)j * a.splits + (in ? t0 + i : 0)) * (D + 2);
      mv[i] = in ? __ldcg(pt) : -INFINITY;
      lv[i] = in ? __ldcg(pt + 1) : 0.0f;
      av[i] = in ? __ldcg(pt + 2 + d) : 0.0f;
    }
    float Mc = M;
#pragma unroll
    for (int i = 0; i < kCombine; ++i) Mc = fmaxf(Mc, mv[i]);
    const float rescale = expf(M - Mc);
    L *= rescale;
    num *= rescale;
#pragma unroll
    for (int i = 0; i < kCombine; ++i) {
      const float w = expf(mv[i] - Mc);
      L = fmaf(lv[i], w, L);
      num = fmaf(av[i], w, num);
    }
    M = Mc;
  }
  const float p_cur = expf(s_cur - M);
  L += p_cur;
  num += p_cur * v_cur;
  return num / L;
}

// Eight values of T at p (16-byte aligned) as fp32, through ld.global.cg.
__device__ __forceinline__ void load8_cg(const __nv_bfloat16* p, float (&o)[8]) {
  unpack16(__ldcg(reinterpret_cast<const uint4*>(p)), o);
}
__device__ __forceinline__ void load8_cg(const float* p, float (&o)[8]) {
  float a[4], b[4];
  unpack16(__ldcg(reinterpret_cast<const uint4*>(p)), a);
  unpack16(__ldcg(reinterpret_cast<const uint4*>(p) + 1), b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[i] = a[i];
    o[i + 4] = b[i];
  }
}

// Shared memory (floats) of one item: the group's q, the current token's k
// and v, its scores, the split's scores.
__host__ __device__ __forceinline__ size_t split_item_floats(int group, int D, int rows) {
  return (size_t)group * D + 2 * (size_t)D + group + (size_t)group * rows;
}

// Item `item` (< n_kv * splits) of a layer's split attention, block-wide;
// sm: split_item_floats(...) floats of shared memory. Before `wait()` it
// loads only pane rows t < length (which no kernel of the step writes) and
// their scales; wait() returns the step's raw length.
template <typename T, int KK, int VK, int D, int HC, typename Wait>
__device__ __forceinline__ void split_attention_item(const SplitAttn& a, const int item, float* sm,
                                                     Wait wait) {
  constexpr int LPR = D / 8;     // lanes a row in phases 1 and 3
  constexpr int RPW = 32 / LPR;  // rows a warp and pass
  constexpr int DPT = D / 32;    // dims a lane of the current token's score
  constexpr bool QUANT = KK != 0;
  __shared__ float pv[kWarps][HC][D];
  __shared__ int last;
  const AttnParams& p = a.p;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = p.capacity, KW = p.kv_width, G = p.group;
  const int hk = item / a.splits, s = item - hk * a.splits;
  const int rows = a.rows, r0 = s * rows;
  const int gi = lane / LPR, d0 = (lane % LPR) * 8;
  const Pane<T, KK> kpane{p.k, KW};
  const Pane<T, VK> vpane{p.v, KW};
  // Before the wait: this lane's row of the warp's first pass (K, V and
  // their scales). No kernel of the step writes a row t < length, which is
  // all that is used of them; a row past it (the new row's included) is
  // read and never used.
  float k0[8], v0[8], ks0 = 0.0f, vs0 = 0.0f;  // vs0: the V scale of row r0 + lane
  {
    const int row = min(r0 + min(warp * RPW + gi, rows - 1), C - 1);
    kpane.template load<8>(row, hk, D, d0, k0);
    vpane.template load<8>(row, hk, D, d0, v0);
    if (QUANT) {
      ks0 = p.ks[row];
      vs0 = p.vs[min(r0 + min(lane, rows - 1), C - 1)];
    }
  }
  const int raw_len = wait();
  const int len = min(max(raw_len, 0), C);
  const T* q = static_cast<const T*>(p.qkv);
  const T* kc = q + p.q_width;
  const T* vc = kc + KW;
  const float* cs = p.cos;  // the step's rows
  const float* sn = p.sin;

  const int n = min(r0 + rows, len) - r0;  // visible rows of this split
  float* qs = sm;                // [G, D] the group's rotated q
  float* cur = qs + G * D;       // [2, D] the current token's rotated k and its v
  float* scur = cur + 2 * D;     // [G] the current token's scores
  float* sc = scur + G;          // [G, rows] scores, then weights
  auto part = [&](int j, int split) {
    return a.part + ((size_t)(hk * G + j) * a.splits + split) * (D + 2);
  };
  for (int e = tid; e < (G + 2) * D; e += kThreads) {
    const int j = e / D, d = e - j * D;
    if (j < G)
      qs[e] = head_value<T>(q + (hk * G + j) * D, d, D, cs, sn);
    else
      cur[e - G * D] =
          j == G ? head_value<T>(kc + hk * D, d, D, cs, sn) : ldcg_f32(vc + hk * D + d);
  }
  __syncthreads();
  // the current token's score for each head (full precision), for the
  // combine of whichever item of this K/V head ends last
  for (int j = warp; j < G; j += kWarps) {
    float dot = 0.0f;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = lane * DPT + i;
      dot = fmaf(qs[j * D + d], cur[d], dot);
    }
    dot = warp_sum(dot);
    if (lane == 0) scur[j] = dot * p.sm_scale;
  }

  if (n > 0) {
    if (warp * RPW + gi >= n) {  // a row past the length: never read, kept finite
#pragma unroll
      for (int i = 0; i < 8; ++i) k0[i] = v0[i] = 0.0f;
    }
    // phase 1: scores
    for (int h0 = 0; h0 < G; h0 += HC) {
      float u[HC][8];
#pragma unroll
      for (int jj = 0; jj < HC; ++jj)
#pragma unroll
        for (int i = 0; i < 8; ++i) u[jj][i] = h0 + jj < G ? qs[(h0 + jj) * D + d0 + i] : 0.0f;
      for (int cb = warp * RPW; cb < n; cb += kWarps * RPW) {
        const int cl = min(cb + gi, n - 1);
        const bool first = cb == warp * RPW;  // the rows loaded before the wait
        float kv[8];
        if (first) {
#pragma unroll
          for (int i = 0; i < 8; ++i) kv[i] = k0[i];
        } else {
          kpane.template load<8>(r0 + cl, hk, D, d0, kv);
        }
        const float ksc = QUANT ? (first ? ks0 : p.ks[r0 + cl]) : 0.0f;
#pragma unroll
        for (int jj = 0; jj < HC; ++jj) {
          float dot = 0.0f;
#pragma unroll
          for (int i = 0; i < 8; ++i) dot = fmaf(u[jj][i], kv[i], dot);
#pragma unroll
          for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
          if (lane % LPR == 0 && cb + gi < n && h0 + jj < G)
            sc[(h0 + jj) * rows + cl] = QUANT ? dot * ksc * p.sm_scale : dot * p.sm_scale;
        }
      }
    }
    __syncthreads();
    // phase 2: a warp a head
    for (int j = warp; j < G; j += kWarps) {
      float* sj = sc + j * rows;
      float m = -INFINITY;
      for (int c = lane; c < n; c += 32) m = fmaxf(m, sj[c]);
      m = warp_max(m);
      float l = 0.0f;
      for (int c = lane; c < n; c += 32) {
        const float pr = expf(sj[c] - m);
        l += pr;
        sj[c] = QUANT ? round_to<T>(pr * (c < 32 ? vs0 : p.vs[r0 + c])) : pr;
      }
      l = warp_sum(l);
      if (lane == 0) {
        part(j, s)[0] = m;
        part(j, s)[1] = l;
      }
    }
    __syncthreads();
    // phase 3: PV
    for (int h0 = 0; h0 < G; h0 += HC) {
      float acc[HC][8];
#pragma unroll
      for (int jj = 0; jj < HC; ++jj)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[jj][i] = 0.0f;
#pragma unroll 2
      for (int cb = warp * RPW; cb < n; cb += kWarps * RPW) {
        const int cl = min(cb + gi, n - 1);
        float vv[8];
        if (cb == warp * RPW) {
#pragma unroll
          for (int i = 0; i < 8; ++i) vv[i] = v0[i];
        } else {
          vpane.template load<8>(r0 + cl, hk, D, d0, vv);
        }
#pragma unroll
        for (int jj = 0; jj < HC; ++jj) {
          const float w = cb + gi < n && h0 + jj < G ? sc[(h0 + jj) * rows + cl] : 0.0f;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[jj][i] = fmaf(w, vv[i], acc[jj][i]);
        }
      }
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
        for (int jj = 0; jj < HC; ++jj)
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[jj][i] += __shfl_xor_sync(0xffffffffu, acc[jj][i], o);
      if (gi == 0) {
#pragma unroll
        for (int jj = 0; jj < HC; ++jj)
#pragma unroll
          for (int i = 0; i < 8; ++i) pv[warp][jj][d0 + i] = acc[jj][i];
      }
      __syncthreads();
      for (int e = tid; e < HC * D; e += kThreads) {
        const int jj = e / D, d = e - jj * D;
        if (h0 + jj < G) {
          float num = 0.0f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) num += pv[w][jj][d];
          part(h0 + jj, s)[2 + d] = num;
        }
      }
      __syncthreads();  // pv is the next chunk's
    }
  } else {  // no visible row in this split
    for (int e = tid; e < G * (D + 2); e += kThreads) {
      const int j = e / (D + 2), i = e - j * (D + 2);
      part(j, s)[i] = i == 0 ? -INFINITY : 0.0f;
    }
  }

  // The last item of this K/V head to finish combines its splits: the
  // count's add is an acquire-release atomic after the block's barrier (its
  // partials are visible before it; the last item's reads come after it).
  // Each output value takes kCombine splits' (m, l, acc[d]) in one round
  // trip: M over them and the current token, e^(m_s - M) weights (a split
  // past the length weighs 0), running sums rescaled when a later chunk
  // raises M (more than kCombine splits only).
  __syncthreads();
  if (tid == 0) {
    unsigned prev;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(a.count + hk) : "memory");
    last = prev == (unsigned)a.splits - 1;
  }
  __syncthreads();
  if (!last) return;
  for (int e = tid; e < G * D; e += kThreads) {
    const int j = e / D, d = e - j * D;
    static_cast<T*>(p.out)[(hk * G + j) * D + d] =
        from_f32<T>(combine_value(a, hk * G + j, D, d, scur[j], cur[D + d]));
  }
  if (tid == 0) a.count[hk] = 0;  // clean for the next use
}

// The verify forms: R rows of one sequence at lengths cur + t (cur = the
// raw length, t < R), over fp panes in which the rows cur .. cur + R - 1
// already hold the verify rows' k (rotated) and v. Item b < n_kv * splits:
// K/V head hk = b / splits over rows [s * rows, ...) of the layer's panes,
// for the group's G query heads of all R rows: G R "virtual heads" j = t G +
// g, row t seeing the pane rows c < min(cur + t, C) (the cache and the verify
// rows j < t: the JAX kernels' in-block causal set) and its own k / v
// merged by the combine (combine_value), as the single stream's current
// token. Each K and V row of the split is read from memory once for all of
// them. A virtual head's sums are taken in an order fixed by (its row's
// length, C, the plan): which other rows or heads share its pass, quad or
// chunk changes nothing (a row past its length adds nothing), so a row's
// bits do not depend on R. The plan (splits, rows) is a function of (C, the
// heads, the card): the verify rows' lengths never change it. Partials:
// [R, n_head, splits, D + 2]; counters: one a K/V head. Rows at or past cur
// were written by another kernel or block of the pass and are read through
// ld.global.cg.
//
// Two layouts of the same item, each the faster where it serves (PERF.md §6,
// timed in one call): verify_attention_item, the single stream's split
// item with HC virtual heads a pass (lanes split a row's dims, the warps
// the split's rows), for GPT-2's persistent verify (G = 1: R virtual heads,
// one or two passes); verify_attention_item_staged, the split's K and V
// rows staged in shared memory and each warp a quad of virtual heads, for
// the Llama/Qwen chain's GQA groups (G R up to 64 virtual heads: the passes
// of the first would repeat their row loads, shuffles and barriers).
struct VerifyAttn {
  SplitAttn a;  // p.qkv / p.out: row 0's; p.cos / p.sin: the [n_pos, D] tables, or null
  int R, qkv_stride, out_stride;  // rows; elements between rows of q|k|v and of the output
};

// Shared memory (floats) of verify_attention_item: the rows' rotated q of
// the group, each row's own k and v, their scores, the split's scores.
__host__ __device__ __forceinline__ size_t verify_item_floats(int group, int R, int D,
                                                              int rows) {
  return (size_t)group * R * D + 2 * (size_t)R * D + (size_t)group * R +
         (size_t)group * R * rows;
}

// HC virtual heads a pass hold their q in registers; the next pass reads the
// split's rows again from L1 / L2.
template <typename T, int D, int HC, typename Wait>
__device__ __forceinline__ void verify_attention_item(const VerifyAttn& va, const int item,
                                                      float* sm, Wait wait) {
  constexpr int LPR = D / 8;     // lanes a row in phases 1 and 3
  constexpr int RPW = 32 / LPR;  // rows a warp and pass
  constexpr int DPT = D / 32;    // dims a lane of an own-row score
  constexpr int PE = 16 / (int)sizeof(T);
  __shared__ float pv[kWarps][HC][D];
  __shared__ int last;
  const SplitAttn& a = va.a;
  const AttnParams& p = a.p;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = p.capacity, KW = p.kv_width, G = p.group, R = va.R, GR = G * R;
  const int hk = item / a.splits, s = item - hk * a.splits;
  const int rows = a.rows, r0 = s * rows;
  const int gi = lane / LPR, d0 = (lane % LPR) * 8;
  const int cur = wait();
  const T* q0 = static_cast<const T*>(p.qkv);
  // visible pane rows of row t in this split
  auto n_of = [&](int t) { return min(r0 + rows, min(max(cur + t, 0), C)) - r0; };
  // lane-values [d0, d0 + 8) of K/V head hk in pane row c: a row at or past
  // cur was written in this pass
  auto row8 = [&](const void* pane, int c, float (&o)[8]) {
    const uint4* src = reinterpret_cast<const uint4*>(static_cast<const T*>(pane) +
                                                      (size_t)c * KW + hk * D + d0);
    uint4 u[8 / PE];
#pragma unroll
    for (int i = 0; i < 8 / PE; ++i) u[i] = c >= cur ? __ldcg(src + i) : src[i];
    if constexpr (PE == 8) {
      unpack16(u[0], o);
    } else {
      float lo[4], hi[4];
      unpack16(u[0], lo);
      unpack16(u[1], hi);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[i] = lo[i];
        o[i + 4] = hi[i];
      }
    }
  };
  float* qs = sm;              // [GR, D] rotated q, virtual head j = t G + g
  float* kcur = qs + GR * D;   // [R, D] each row's own rotated k
  float* vcur = kcur + R * D;  // [R, D] its v
  float* scur = vcur + R * D;  // [GR] own-row scores
  float* sc = scur + GR;       // [GR, rows] scores, then weights
  auto part = [&](int j) {     // virtual head j's partial of this split
    const int t = j / G;
    return a.part + (((size_t)t * p.n_head + hk * G + j - t * G) * a.splits + s) * (D + 2);
  };
  for (int e = tid; e < (GR + 2 * R) * D; e += kThreads) {
    const int j = e / D, d = e - j * D;
    const int t = j < GR ? j / G : (j < GR + R ? j - GR : j - GR - R);
    const T* row = q0 + (size_t)t * va.qkv_stride;
    const float* cs = nullptr;
    const float* sn = nullptr;
    if (p.cos != nullptr) {
      const int pos = min(max(cur + t, 0), p.n_pos - 1);
      cs = p.cos + (size_t)pos * D;
      sn = p.sin + (size_t)pos * D;
    }
    if (j < GR)
      qs[e] = head_value<T>(row + (hk * G + j - t * G) * D, d, D, cs, sn);
    else if (j < GR + R)
      qs[e] = head_value<T>(row + p.q_width + hk * D, d, D, cs, sn);
    else
      qs[e] = ldcg_f32(row + p.q_width + KW + hk * D + d);
  }
  __syncthreads();
  // each virtual head's own-row score (full precision), for the combine
  for (int j = warp; j < GR; j += kWarps) {
    const float* kt = kcur + (j / G) * D;
    float dot = 0.0f;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = lane * DPT + i;
      dot = fmaf(qs[j * D + d], kt[d], dot);
    }
    dot = warp_sum(dot);
    if (lane == 0) scur[j] = dot * p.sm_scale;
  }
  // phase 1: scores, HC virtual heads a pass
  for (int h0 = 0; h0 < GR; h0 += HC) {
    float u[HC][8];
    int nj[HC], nmax = 0;
#pragma unroll
    for (int jj = 0; jj < HC; ++jj) {
      const int j = h0 + jj;
      nj[jj] = j < GR ? n_of(j / G) : 0;
      nmax = max(nmax, nj[jj]);
#pragma unroll
      for (int i = 0; i < 8; ++i) u[jj][i] = j < GR ? qs[j * D + d0 + i] : 0.0f;
    }
    for (int cb = warp * RPW; cb < nmax; cb += kWarps * RPW) {
      const int cl = min(cb + gi, nmax - 1);
      float kv[8];
      row8(p.k, r0 + cl, kv);
#pragma unroll
      for (int jj = 0; jj < HC; ++jj) {
        float dot = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) dot = fmaf(u[jj][i], kv[i], dot);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (lane % LPR == 0 && cb + gi < nj[jj]) sc[(h0 + jj) * rows + cl] = dot * p.sm_scale;
      }
    }
  }
  __syncthreads();
  // phase 2: a warp a virtual head
  for (int j = warp; j < GR; j += kWarps) {
    const int n = n_of(j / G);
    float* sj = sc + j * rows;
    float m = -INFINITY;
    for (int c = lane; c < n; c += 32) m = fmaxf(m, sj[c]);
    m = warp_max(m);
    float l = 0.0f;
    for (int c = lane; c < n; c += 32) {
      const float pr = expf(sj[c] - m);
      l += pr;
      sj[c] = pr;
    }
    l = warp_sum(l);
    if (lane == 0) {
      part(j)[0] = n > 0 ? m : -INFINITY;
      part(j)[1] = l;
    }
  }
  __syncthreads();
  // phase 3: PV (a virtual head without a visible row sums nothing: 0)
  for (int h0 = 0; h0 < GR; h0 += HC) {
    float acc[HC][8];
    int nj[HC], nmax = 0;
#pragma unroll
    for (int jj = 0; jj < HC; ++jj) {
      nj[jj] = h0 + jj < GR ? n_of((h0 + jj) / G) : 0;
      nmax = max(nmax, nj[jj]);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[jj][i] = 0.0f;
    }
#pragma unroll 2
    for (int cb = warp * RPW; cb < nmax; cb += kWarps * RPW) {
      const int cl = min(cb + gi, nmax - 1);
      float vv[8];
      row8(p.v, r0 + cl, vv);
#pragma unroll
      for (int jj = 0; jj < HC; ++jj) {
        const float w = cb + gi < nj[jj] ? sc[(h0 + jj) * rows + cl] : 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[jj][i] = fmaf(w, vv[i], acc[jj][i]);
      }
    }
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
      for (int jj = 0; jj < HC; ++jj)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[jj][i] += __shfl_xor_sync(0xffffffffu, acc[jj][i], o);
    if (gi == 0) {
#pragma unroll
      for (int jj = 0; jj < HC; ++jj)
#pragma unroll
        for (int i = 0; i < 8; ++i) pv[warp][jj][d0 + i] = acc[jj][i];
    }
    __syncthreads();
    for (int e = tid; e < HC * D; e += kThreads) {
      const int jj = e / D, d = e - jj * D;
      if (h0 + jj < GR) {
        float num = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) num += pv[w][jj][d];
        part(h0 + jj)[2 + d] = num;
      }
    }
    __syncthreads();  // pv is the next pass's
  }
  // the last item of this K/V head to finish combines its splits for every
  // virtual head (split_attention_item's counter and combine)
  __syncthreads();
  if (tid == 0) {
    unsigned prev;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(a.count + hk) : "memory");
    last = prev == (unsigned)a.splits - 1;
  }
  __syncthreads();
  if (!last) return;
  for (int e = tid; e < GR * D; e += kThreads) {
    const int j = e / D, d = e - j * D, t = j / G, h = hk * G + j - t * G;
    static_cast<T*>(p.out)[(size_t)t * va.out_stride + h * D + d] = from_f32<T>(
        combine_value(a, t * p.n_head + h, D, d, scur[j], vcur[t * D + d]));
  }
  if (tid == 0) a.count[hk] = 0;  // clean for the next use
}

constexpr int kVerifyChunk = 32;  // pane rows the staged verify item stages at once

// Virtual heads rounded up to whole quads.
__host__ __device__ __forceinline__ int verify_heads_padded(int group, int R) {
  return (group * R + 3) / 4 * 4;
}

// Shared memory (floats) of verify_attention_item_staged: the rows' rotated
// q of the group (transposed, [D, GRp]), each row's own k and v, a chunk's V
// and (padded) K rows, the own-row scores, the split's scores.
__host__ __device__ __forceinline__ size_t verify_staged_floats(int group, int R, int D,
                                                              int rows) {
  const size_t GRp = verify_heads_padded(group, R);
  return GRp * D + 2 * (size_t)R * D + (size_t)kVerifyChunk * D +
         (size_t)kVerifyChunk * (D + 1) + GRp + (size_t)group * R * rows;
}

// The split's K and V rows staged kVerifyChunk at a time; then, block-wide:
//   scores   lane c of a warp one pane row, the warp a quad of virtual
//            heads (q transposed in shared memory: one broadcast load a dim
//            for the four), each dot over d in order;
//   softmax  a warp a virtual head: the split's max m_s, exp(s - m_s), their
//            sum l_s;
//   PV       a warp a quad, lane l dims [l D/32, (l + 1) D/32), the split's
//            rows in order.
template <typename T, int D, typename Wait>
__device__ __forceinline__ void verify_attention_item_staged(const VerifyAttn& va,
                                                             const int item, float* sm,
                                                             Wait wait) {
  constexpr int CH = kVerifyChunk;
  constexpr int DL = D / 32;         // dims a lane of the PV
  constexpr int PE = Vec<T>::N;      // values of T a 16-byte load
  constexpr int LR = D / PE;         // 16-byte loads a pane row of a head
  __shared__ int last;
  const SplitAttn& a = va.a;
  const AttnParams& p = a.p;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = p.capacity, KW = p.kv_width, G = p.group, R = va.R, GR = G * R;
  const int GRp = verify_heads_padded(G, R), NQ = GRp / 4;
  const int hk = item / a.splits, s = item - hk * a.splits;
  const int rows = a.rows, r0 = s * rows;
  const int cur = wait();
  const T* q0 = static_cast<const T*>(p.qkv);
  // visible pane rows of row t in this split
  auto n_of = [&](int t) { return max(0, min(r0 + rows, min(max(cur + t, 0), C)) - r0); };
  const int nall = n_of(R - 1);
  float* qT = sm;                     // [D, GRp] rotated q, virtual head j = t G + g
  float* kcur = qT + GRp * D;         // [R, D] each row's own rotated k
  float* vcur = kcur + R * D;         // [R, D] its v
  float* vbuf = vcur + R * D;         // [CH, D] a chunk's V rows
  float* kbuf = vbuf + CH * D;        // [CH, D + 1] its K rows (lane c reads row c)
  float* scur = kbuf + CH * (D + 1);  // [GRp] own-row scores
  float* sc = scur + GRp;             // [GR, rows] scores, then weights
  auto part = [&](int j) {            // virtual head j's partial of this split
    const int t = j / G;
    return a.part + (((size_t)t * p.n_head + hk * G + j - t * G) * a.splits + s) * (D + 2);
  };
  // q | own k | own v of every row (q, k rotated)
  for (int e = tid; e < (GRp + 2 * R) * D; e += kThreads) {
    const int j = e / D, d = e - j * D;
    if (j >= GR && j < GRp) {  // a padding virtual head
      qT[d * GRp + j] = 0.0f;
      continue;
    }
    const int t = j < GR ? j / G : (j < GRp + R ? j - GRp : j - GRp - R);
    const T* row = q0 + (size_t)t * va.qkv_stride;
    const float* cs = nullptr;
    const float* sn = nullptr;
    if (p.cos != nullptr) {
      const int pos = min(max(cur + t, 0), p.n_pos - 1);
      cs = p.cos + (size_t)pos * D;
      sn = p.sin + (size_t)pos * D;
    }
    if (j < GR)
      qT[d * GRp + j] = head_value<T>(row + (hk * G + j - t * G) * D, d, D, cs, sn);
    else if (j < GRp + R)
      kcur[(j - GRp) * D + d] = head_value<T>(row + p.q_width + hk * D, d, D, cs, sn);
    else
      vcur[(j - GRp - R) * D + d] = ldcg_f32(row + p.q_width + KW + hk * D + d);
  }
  // pane rows [c0, c0 + CH) of the split into kbuf / vbuf, zero past nall
  auto stage = [&](int c0) {
    for (int i = tid; i < 2 * CH * LR; i += kThreads) {
      const int kv = i / (CH * LR), r = i - kv * CH * LR, c = r / LR, d = (r - c * LR) * PE;
      float f[PE];
      if (c0 + c < nall) {
        const T* src = static_cast<const T*>(kv ? p.v : p.k) + (size_t)(r0 + c0 + c) * KW +
                       hk * D + d;
        unpack16(__ldcg(reinterpret_cast<const uint4*>(src)), f);
      } else {
#pragma unroll
        for (int k = 0; k < PE; ++k) f[k] = 0.0f;
      }
      float* dst = kv ? vbuf + c * D + d : kbuf + c * (D + 1) + d;
#pragma unroll
      for (int k = 0; k < PE; ++k) dst[k] = f[k];
    }
  };
  __syncthreads();
  // each virtual head's own-row score (full precision), for the combine
  for (int j = warp; j < GR; j += kWarps) {
    const float* kt = kcur + (j / G) * D;
    float dot = 0.0f;
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      const int d = lane * DL + i;
      dot = fmaf(qT[d * GRp + j], kt[d], dot);
    }
    dot = warp_sum(dot);
    if (lane == 0) scur[j] = dot * p.sm_scale;
  }
  // scores, a chunk of pane rows at a time
  for (int c0 = 0; c0 < nall; c0 += CH) {
    if (c0 > 0) __syncthreads();  // the last chunk's readers are done
    stage(c0);
    __syncthreads();
    const float* kr = kbuf + lane * (D + 1);
    const int c = c0 + lane;
    for (int qd = warp; qd < NQ; qd += kWarps) {
      float dot[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float kd = kr[d];
        const float4 qv = *reinterpret_cast<const float4*>(qT + d * GRp + 4 * qd);
        dot[0] = fmaf(qv.x, kd, dot[0]);
        dot[1] = fmaf(qv.y, kd, dot[1]);
        dot[2] = fmaf(qv.z, kd, dot[2]);
        dot[3] = fmaf(qv.w, kd, dot[3]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * qd + i;
        if (j < GR && c < n_of(j / G)) sc[j * rows + c] = dot[i] * p.sm_scale;
      }
    }
  }
  __syncthreads();
  // softmax: a warp a virtual head (no visible row: the neutral partial)
  for (int j = warp; j < GR; j += kWarps) {
    const int n = n_of(j / G);
    float* sj = sc + j * rows;
    float m = -INFINITY;
    for (int c = lane; c < n; c += 32) m = fmaxf(m, sj[c]);
    m = warp_max(m);
    float l = 0.0f;
    for (int c = lane; c < n; c += 32) {
      const float pr = expf(sj[c] - m);
      l += pr;
      sj[c] = pr;
    }
    l = warp_sum(l);
    if (lane == 0) {
      part(j)[0] = n > 0 ? m : -INFINITY;
      part(j)[1] = l;
    }
  }
  __syncthreads();
  // PV: rounds of kWarps quads; the chunk staged for the scores is still
  // there when there was one
  const bool restage = nall > CH;
  for (int q0 = 0; q0 < NQ; q0 += kWarps) {
    const int qd = q0 + warp;
    int nv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * qd + i;
      nv[i] = qd < NQ && j < GR ? n_of(j / G) : 0;
    }
    float acc[4][DL];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < DL; ++k) acc[i][k] = 0.0f;
    for (int c0 = 0; c0 < nall; c0 += CH) {
      if (restage) {
        __syncthreads();
        stage(c0);
        __syncthreads();
      }
      const int cn = min(CH, nall - c0);
      for (int cc = 0; cc < cn; ++cc) {
        const int c = c0 + cc;
        float v[DL];
#pragma unroll
        for (int k = 0; k < DL; ++k) v[k] = vbuf[cc * D + lane * DL + k];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (c < nv[i]) {
            const float w = sc[(4 * qd + i) * rows + c];
#pragma unroll
            for (int k = 0; k < DL; ++k) acc[i][k] = fmaf(w, v[k], acc[i][k]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * qd + i;
      if (qd < NQ && j < GR) {
#pragma unroll
        for (int k = 0; k < DL; ++k) part(j)[2 + lane * DL + k] = acc[i][k];
      }
    }
  }
  // the last item of this K/V head to finish combines its splits for every
  // virtual head (split_attention_item's counter and combine)
  __syncthreads();
  if (tid == 0) {
    unsigned prev;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(a.count + hk) : "memory");
    last = prev == (unsigned)a.splits - 1;
  }
  __syncthreads();
  if (!last) return;
  for (int e = tid; e < GR * D; e += kThreads) {
    const int j = e / D, d = e - j * D, t = j / G, h = hk * G + j - t * G;
    static_cast<T*>(p.out)[(size_t)t * va.out_stride + h * D + d] = from_f32<T>(
        combine_value(a, t * p.n_head + h, D, d, scur[j], vcur[t * D + d]));
  }
  if (tid == 0) a.count[hk] = 0;  // clean for the next use
}

// The warp-level item of the batched GPT-2 step (gpt2_megabatch.cu: many
// (slot, head, split) items a block and layer, so a block's 8 warps take 8
// at once and a warp keeps a split's rows in flight together): the same
// function as split_attention_item at group 1, lanes laid out as its phases
// 1 and 3 (D/8 lanes a row, 8 dims each), a warp's passes over the split's
// rows in chunks of warp_passes() whose K and V rows are loaded before any is
// used, the scores in `sc` (rows floats of the warp's shared memory), the
// current token's score by the same shuffle tree, and the same combine by
// the last warp of a head to finish. Sums in an order fixed by (rows, D).
// Passes a chunk: 8 (4 in fp32, whose rows take twice the registers).
template <typename T>
__host__ __device__ constexpr int warp_passes() {
  return sizeof(T) == 4 ? 4 : 8;
}

// The first chunk of a warp item's K and V rows and scales, loaded before
// the grid barrier (rows t < length, which no kernel of the step writes).
template <typename T, int KK, int VK, int D>
struct WarpRows {
  static constexpr int N = warp_passes<T>();
  typename Pane<T, KK>::Raw k[N];
  typename Pane<T, VK>::Raw v[N];
  float ks[N], vs;
};

template <typename T, int KK, int VK, int D>
__device__ __forceinline__ void warp_rows(const SplitAttn& a, int item, int p0,
                                          WarpRows<T, KK, VK, D>& r) {
  constexpr int LPR = D / 8, RPW = 32 / LPR;
  const AttnParams& p = a.p;
  const int lane = threadIdx.x & 31, gi = lane / LPR, d0 = (lane % LPR) * 8;
  const int hk = item / a.splits, r0 = (item - hk * a.splits) * a.rows, C = p.capacity;
  const Pane<T, KK> kpane{p.k, p.kv_width};
  const Pane<T, VK> vpane{p.v, p.kv_width};
#pragma unroll
  for (int j = 0; j < warp_passes<T>(); ++j) {
    const int row = min(r0 + min((p0 + j) * RPW + gi, a.rows - 1), C - 1);
    r.k[j] = kpane.raw(row, hk, D, d0);
    r.v[j] = vpane.raw(row, hk, D, d0);
    if (KK != 0) r.ks[j] = p.ks[row];
  }
  if (KK != 0) r.vs = p.vs[min(r0 + min(p0 * RPW + lane, a.rows - 1), C - 1)];
}

template <typename T, int KK, int VK, int D>
__device__ void split_attention_warp_item(const SplitAttn& a, const int item, float* sc,
                                          const int raw_len, WarpRows<T, KK, VK, D>& r) {
  constexpr int LPR = D / 8, RPW = 32 / LPR, NP = warp_passes<T>();
  constexpr bool QUANT = KK != 0;
  const AttnParams& p = a.p;
  const int lane = threadIdx.x & 31, gi = lane / LPR, d0 = (lane % LPR) * 8;
  const int hk = item / a.splits, s = item - hk * a.splits;
  const int C = p.capacity, KW = p.kv_width, r0 = s * a.rows;
  const Pane<T, KK> kpane{p.k, KW};
  const Pane<T, VK> vpane{p.v, KW};
  const int len = min(max(raw_len, 0), C);
  const int n = min(r0 + a.rows, len) - r0;  // visible rows of this split
  const T* kc = static_cast<const T*>(p.qkv) + p.q_width;
  float q[8], kcur[8];  // 16-byte loads through ld.global.cg (another block wrote them)
  load8_cg(static_cast<const T*>(p.qkv) + hk * D + d0, q);
  load8_cg(kc + hk * D + d0, kcur);
  float s_cur = 0.0f;  // the current token's score (full precision)
#pragma unroll
  for (int i = 0; i < 8; ++i) s_cur = fmaf(q[i], kcur[i], s_cur);
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) s_cur += __shfl_xor_sync(0xffffffffu, s_cur, o);
  s_cur *= p.sm_scale;
  float* part = a.part + ((size_t)hk * a.splits + s) * (D + 2);
  const float vs0 = r.vs;  // the V scale of row r0 + lane (first chunk)
  if (n > 0) {
    const int passes = (n + RPW - 1) / RPW;
    const bool one = passes <= NP;  // the first chunk's rows stay loaded
    // scores, NP passes at a time (the first chunk's rows loaded ahead)
    for (int p0 = 0; p0 < passes; p0 += NP) {
      if (p0 > 0) warp_rows<T, KK, VK, D>(a, item, p0, r);
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const int c = (p0 + j) * RPW + gi;
        float kv[8];
        kpane.decode(r.k[j], hk, D, d0, kv);
        float dot = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) dot = fmaf(q[i], kv[i], dot);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (lane % LPR == 0 && c < n) sc[c] = QUANT ? dot * r.ks[j] * p.sm_scale : dot * p.sm_scale;
      }
    }
    __syncwarp();
    float m = -INFINITY;
    for (int c = lane; c < n; c += 32) m = fmaxf(m, sc[c]);
    m = warp_max(m);
    float l = 0.0f;
    for (int c = lane; c < n; c += 32) {
      const float pr = expf(sc[c] - m);
      l += pr;
      sc[c] = QUANT ? round_to<T>(pr * (c < 32 ? vs0 : p.vs[r0 + c])) : pr;
    }
    l = warp_sum(l);
    __syncwarp();
    // PV: the V rows of the chunk in registers (the first chunk's already)
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
    for (int p0 = 0; p0 < passes; p0 += NP) {
      if (!one) warp_rows<T, KK, VK, D>(a, item, p0, r);
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const int c = (p0 + j) * RPW + gi;
        if (c >= n) continue;  // a row past the length: never used (it may be written now)
        float vv[8];
        vpane.decode(r.v[j], hk, D, d0, vv);
        const float w = sc[c];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = fmaf(w, vv[i], acc[i]);
      }
    }
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
    if (lane == 0) {
      part[0] = m;
      part[1] = l;
    }
    if (gi == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) part[2 + d0 + i] = acc[i];
    }
  } else {  // no visible row in this split
    for (int i = lane; i < D + 2; i += 32) part[i] = i == 0 ? -INFINITY : 0.0f;
  }
  // the last warp of this (slot, head) to finish combines its splits
  __syncwarp();
  unsigned last = 0;
  if (lane == 0) {
    unsigned prev;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(a.count + hk) : "memory");
    last = prev == (unsigned)a.splits - 1;
  }
  if (!__shfl_sync(0xffffffffu, last, 0)) return;
  s_cur = __shfl_sync(0xffffffffu, s_cur, 0);
  const T* vc = kc + KW;
  for (int d = lane; d < D; d += 32)
    static_cast<T*>(p.out)[hk * D + d] =
        from_f32<T>(combine_value(a, hk, D, d, s_cur, ldcg_f32(vc + hk * D + d)));
  __syncwarp();
  if (lane == 0) a.count[hk] = 0;  // clean for the next use
}

}  // namespace
