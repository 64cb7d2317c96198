// The batched streaming GEMV of the bf16 batched Llama/Qwen step chain
// (megabatch.cu: #15 llama_megabatch, #17 llama_megabatch_quant), on the
// tensor cores, and for every 1 <= B <= 32 slots in one launch:
//
//   y[b, n] = sum_k in[b, k] * W[n, k]   over the rows n of a row-major
//                                        [N, K] weight, slots b < B,
//
// with gemv_batch.cuh's prologues (PRO_RMS: RMSNorm of x; PRO_VEC: the input
// rows), epilogues (EPI_STORE with the Qwen bias, EPI_RESIDUAL in place,
// EPI_SWIGLU over interleaved (gate, up) rows, EPI_ARGMAX per-block, per-slot
// partials for argmax_batch_kernel) and weight tiers (W_T bf16, W_I8 int8
// codes with fp32 row scales, W_I4 grouped int4 codes with bf16 (row, group)
// scales), at their rounding points. It replaces no TPU kernel of its own: it
// is the product inside the JAX batched step programs
// (ops/pallas/megakernel_batch.py `llama_megabatch`,
// megakernel_batch_quant.py `llama_megabatch_quant`), which gemv_batch.cuh ran
// with CUDA-core FMAs, launched once per group of 8 slots, each launch
// streaming every weight again.
//
// Bound: bytes. A weight element feeds 2 B operations, at most 64 at B = 32:
// across Llama-3.2-1B's 1.24 G weights 79 GFLOP, ~0.16 ms at half the
// mma.sync rate, against the step's 0.74 ms byte bound. The design is
// gemv_stream.cuh's persistent stream with the product on the tensor cores:
//   - Grid: persistent, from the SM count and the kernel's occupancy at
//     launch: two blocks an SM where the items fill them and the staged
//     inputs leave a ring of 4 stages, else one with a ring of up to 12
//     (a block's bytes in flight, not its warps, keep the stream at the
//     rate). A tile is 128 weight rows (a warp's m16 tile each) by one K
//     part; block b keeps part b % S and walks tiles b / S, b / S + grid /
//     S, ... so its prologue runs once.
//   - K split: S parts (split_count) from (N, K) alone: about 132 (tile,
//     part) items, and no part past kMaxPart inputs (Llama's down projection,
//     K = 8192, is 8 parts). A part's fp32 partials go to the scratch; the
//     last block of a tile (a counter a tile, reset by it; the caller
//     provides as many as the largest split GEMV has tiles) adds them in
//     part order and runs the epilogue, whose residual and scale reads were
//     requested when the item began.
//   - Weight ring: each warp streams its own 16 rows through its own ring of
//     `stages` 2 KB stages (16 rows x 128 bytes) by cp.async, 16 bytes a lane,
//     zero-filled past N, K and its part; the first stages are requested
//     before griddepcontrol.wait (no weight depends on a kernel); a warp waits
//     for its own copies only (cp.async.wait_group, __syncwarp): no block
//     barrier a stage.
//   - Inputs: the B slot rows of the block's part, a thread a 16-byte
//     column with 8 loads in flight, RMSNorm applied (the statistics of
//     gemv_batch_kernel: per slot, lane-strided 16-byte chunks then a warp
//     sum, by warp b % 8, from the staged rows when the part is all of K;
//     the normalised value rounded to bf16 before the gain, the gains read
//     before the wait) and staged in shared memory in bf16, rows past B
//     zero.
//   - Product: mma.sync m16n8k16 (bf16 in, fp32 sums): the warp's 16 weight
//     rows are the M operand, the slots the N operand in ceil(B / 8) n8
//     tiles (1, 2 or 4 as instances). The fragments come by plain shared
//     loads instead of ldmatrix: within a segment of 32 inputs (two k16
//     steps) lane (g, t) holds inputs 8t .. 8t + 7 of its rows g, g + 8 and
//     of slot g, and step j takes 8t + 4j .. 8t + 4j + 3 as the k16 columns
//     2t, 2t + 1, 2t + 8, 2t + 9 of both operands (a permutation of the
//     step's k, the same for both, so the product is unchanged). A segment
//     is one 16-byte load of a bf16 row (8 of int8 codes, 4 of int4), the
//     stage's 16-byte chunks XOR-swizzled by row so a load's lanes hit
//     distinct banks; the slots' rows are padded to a 16-byte stride of
//     4 mod 8 for the same reason.
//   - Weight tiers: codes are decoded in registers by weight_tier.cuh's code
//     decode (int8 and int4 codes are exact in bf16) into the same fragments.
//     W_I8 scales a row's fp32 sum; W_I4 keeps the JAX int4w8 form: each
//     group's fp32 sum (a segment lies in one group: G % 32 == 0) times its
//     (row, group) scale, fused into the row's sum at the group's last
//     segment or the part's end.
//   - Fixed summation order: each (output, slot) is summed in k16 steps in
//     order over its part, and the parts are added in part order; the split
//     depends on (N, K) alone and an MMA's output column on its own slot
//     only, so a slot's bits do not depend on B or on the slots beside it.
//     The MMAs carry the part's sum in their fp32 accumulator, which adds a
//     step's products aligned to the largest term and truncated: more bf16
//     outputs land one rounding off the exact product than with
//     round-to-nearest FMAs (scripts/torch_step_drift.py --gemv).
// Programmatic dependent launch: launched with launch_pdl; x, the inputs,
// the outputs, the scratch and the counters are touched only after
// griddepcontrol.wait, and the next kernel may launch once the prologue is
// done.

#pragma once

#include <algorithm>

#include "gemv_batch.cuh"
#include "gemv_stream.cuh"

namespace {
namespace stc {

constexpr int kTileRows = 16 * kWarps;  // weight rows a tile: an m16 tile a warp
constexpr int kSeg = 32;                // inputs of a segment: two k16 steps
constexpr int kStageBytes = 16 * 128;   // a warp's stage: its 16 rows x 128 bytes
constexpr int kMaxPart = 2048;          // inputs a part may stage
constexpr int kSplitItems = 132, kMaxSplits = 32, kMinPartSegs = 4;
constexpr int kBudget2 = 110 * 1024, kBudget1 = 224 * 1024;  // dynamic smem, by blocks an SM
constexpr int kMaxStages2 = 6, kMaxStages1 = 12, kMinStages2 = 4;
constexpr int kMaxSlots = 32;

// 16-byte weight chunks of a row a segment takes: bf16 64 bytes, int8 32,
// int4 16.
__host__ __device__ constexpr int seg_chunks(int wk) {
  return wk == W_T ? 4 : (wk == W_I8 ? 2 : 1);
}
// Bytes of a weight row of K inputs.
__host__ __device__ inline size_t row_bytes(int wk, int K) {
  return wk == W_T ? 2 * (size_t)K : (wk == W_I8 ? (size_t)K : (size_t)K / 2);
}

// K parts of an [N, K] weight (ops/_gemv_stream_tc.py split_count).
inline int split_count(int N, int K) {
  const int tiles = (N + kTileRows - 1) / kTileRows, segs = (K + kSeg - 1) / kSeg;
  int s = std::min(std::min(kSplitItems / tiles, kMaxSplits), segs / kMinPartSegs);
  s = s < 1 ? 1 : s;
  const int s_min = (segs + kMaxPart / kSeg - 1) / (kMaxPart / kSeg);  // parts of <= 64 segments
  return s > s_min ? s : s_min;
}

// A launch's plan (ops/_gemv_stream_tc.py plan, the same rules).
struct Plan {
  int splits, tiles, part_segs, row_stride, stages, blocks_per_sm;
  size_t smem;
  long long part_floats;
};

inline Plan plan_of(int N, int K, int B, int n_sm) {
  Plan p{};
  p.splits = split_count(N, K);
  p.tiles = (N + kTileRows - 1) / kTileRows;
  const int segs = (K + kSeg - 1) / kSeg;
  p.part_segs = (segs + p.splits - 1) / p.splits;
  int rs16 = 4 * p.part_segs;
  rs16 += rs16 % 8 == 0 ? 4 : 8;
  p.row_stride = 16 * rs16;
  const int rows = B <= 8 ? 8 : (B <= 16 ? 16 : 32);
  const int in_bytes = rows * p.row_stride, ring_stage = kWarps * kStageBytes;
  p.stages = (kBudget2 - in_bytes) / ring_stage;
  p.blocks_per_sm = 2;
  if (p.stages < kMinStages2 || p.tiles * p.splits < 2 * n_sm) {
    p.blocks_per_sm = 1;
    p.stages = (kBudget1 - in_bytes) / ring_stage;
  }
  p.stages = std::min(p.stages, p.blocks_per_sm == 2 ? kMaxStages2 : kMaxStages1);
  p.smem = (size_t)in_bytes + (size_t)p.stages * ring_stage;
  p.part_floats = p.splits > 1 ? (long long)p.tiles * p.splits * kThreads * (rows / 2) : 0;
  return p;
}

// The chain's scratch: split partials and zeroed tile counters.
struct Scratch {
  float* part;
  long long part_len;
  int* count;
  int count_len;
};

struct Gemv {
  const void* w;   // [N, K] rows of the tier
  const void* ws;  // W_I8: fp32 [N]; W_I4: bf16 [N, K / group]; W_T: null
  int group, N, K, B;
  const __nv_bfloat16* in;  // [B, K]: x (PRO_RMS) or the input rows (PRO_VEC)
  const float* ln_g;
  float eps;
  const float* bias;    // [N] fp32 or null
  __nv_bfloat16* out;   // [B, N], x in place (EPI_RESIDUAL), [B, N / 2] (EPI_SWIGLU)
  float* part_val;      // EPI_ARGMAX: [B, gridDim.x]
  int* part_idx;
  float* part;          // split partials: [tile][split][thread][NT] float4
  int* count;           // [tiles] zeroed
  int splits, part_segs, row_stride, stages;
};

// 16 bytes global -> shared, or 16 zero bytes when !valid (nothing read).
__device__ __forceinline__ void cp_async16z(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// cp.async.wait_group of a count known at run time (the ring's depth).
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    case 8: cp_async_wait<8>(); break;
    case 9: cp_async_wait<9>(); break;
    default: cp_async_wait<10>(); break;
  }
}

// d += a (16 x 16) . b (16 x 8), bf16 in, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The stage's byte offset of 16-byte chunk c of row r (rows of 128 bytes):
// XOR-swizzled so that a load's lanes (rows g, 8 inputs a lane) fall in
// distinct banks.
template <int WK> __device__ __forceinline__ int stage_at(int r, int c) {
  constexpr int SC = seg_chunks(WK);
  return r * 128 + ((c ^ ((r & (8 / SC - 1)) * SC)) << 4);
}

// The A fragments of segment q of a stage for lane (g, t): inputs 8t .. 8t+7
// of rows g and g + 8, as the two k16 steps' fragments a0, a1.
template <int WK>
__device__ __forceinline__ void load_a(const unsigned char* stg, int q, int g, int t,
                                       unsigned (&a0)[4], unsigned (&a1)[4]) {
  if constexpr (WK == W_T) {
    const uint4 u = *reinterpret_cast<const uint4*>(stg + stage_at<WK>(g, 4 * q + t));
    const uint4 v = *reinterpret_cast<const uint4*>(stg + stage_at<WK>(g + 8, 4 * q + t));
    a0[0] = u.x; a0[1] = v.x; a0[2] = u.y; a0[3] = v.y;
    a1[0] = u.z; a1[1] = v.z; a1[2] = u.w; a1[3] = v.w;
  } else if constexpr (WK == W_I8) {
    const int off = (t & 1) * 8;
    const uint2 u = *reinterpret_cast<const uint2*>(stg + stage_at<WK>(g, 2 * q + (t >> 1)) + off);
    const uint2 v =
        *reinterpret_cast<const uint2*>(stg + stage_at<WK>(g + 8, 2 * q + (t >> 1)) + off);
    const unsigned w[4] = {u.x ^ 0x80808080u, v.x ^ 0x80808080u, u.y ^ 0x80808080u,
                           v.y ^ 0x80808080u};
    // w[0], w[1]: inputs 0-3 of rows g, g + 8 (step 0); w[2], w[3]: 4-7
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned(&a)[4] = h == 0 ? a0 : a1;
      a[0] = bf16x2(code_i8(w[2 * h], 0), code_i8(w[2 * h], 1));
      a[1] = bf16x2(code_i8(w[2 * h + 1], 0), code_i8(w[2 * h + 1], 1));
      a[2] = bf16x2(code_i8(w[2 * h], 2), code_i8(w[2 * h], 3));
      a[3] = bf16x2(code_i8(w[2 * h + 1], 2), code_i8(w[2 * h + 1], 3));
    }
  } else {
    const unsigned u =
        *reinterpret_cast<const unsigned*>(stg + stage_at<WK>(g, q) + 4 * t) ^ 0x88888888u;
    const unsigned v =
        *reinterpret_cast<const unsigned*>(stg + stage_at<WK>(g + 8, q) + 4 * t) ^ 0x88888888u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned(&a)[4] = h == 0 ? a0 : a1;
      a[0] = bf16x2(code_i4(u, 4 * h), code_i4(u, 4 * h + 1));
      a[1] = bf16x2(code_i4(v, 4 * h), code_i4(v, 4 * h + 1));
      a[2] = bf16x2(code_i4(u, 4 * h + 2), code_i4(u, 4 * h + 3));
      a[3] = bf16x2(code_i4(v, 4 * h + 2), code_i4(v, 4 * h + 3));
    }
  }
}

template <int PRO, int EPI, int WK, int NT>
__global__ void __launch_bounds__(kThreads, 2) gemv_tc_kernel(const Gemv g) {
  using T = __nv_bfloat16;
  constexpr int SC = seg_chunks(WK), SPS = 8 / SC;  // segments a stage
  constexpr int NP = 8 * NT;                         // staged slot rows
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float rstd[kMaxSlots];
  __shared__ int last_block;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int N = g.N, K = g.K, B = g.B, S = g.splits, D = g.stages, RS = g.row_stride;
  const int tiles = (N + kTileRows - 1) / kTileRows, segs = (K + kSeg - 1) / kSeg;
  const int Gs = (int)gridDim.x / S, split = (int)blockIdx.x % S, jb = (int)blockIdx.x / S;
  const int seg0 = split * segs / S, nseg = (split + 1) * segs / S - seg0;
  const int nst = (nseg + SPS - 1) / SPS;  // stages an item
  const int my_items = jb < tiles ? (tiles - jb + Gs - 1) / Gs : 0;
  const int total = my_items * nst;
  unsigned char* ring = smem + warp * D * kStageBytes;  // this warp's ring
  unsigned char* xs = smem + kWarps * D * kStageBytes;  // [NP][RS] staged inputs
  const size_t rbytes = row_bytes(WK, K);
  const int row_chunks = (int)(rbytes / 16);
  const int chunk0 = seg0 * SC, part_chunks = nseg * SC;
  const char* W = static_cast<const char*>(g.w);

  // the next stage to fetch: (item, stage of the item, ring slot), in
  // order, 4 chunks a lane; one commit group a call
  int f_item = 0, f_st = 0, f_slot = 0, fetched = 0;
  auto fetch_next = [&]() {
    if (fetched < total) {
      const int row0 = (jb + f_item * Gs) * kTileRows + warp * 16;
      unsigned char* dst = ring + f_slot * kStageBytes;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = i * 32 + lane, r = idx >> 3, c = idx & 7;
        const int pc = f_st * 8 + c, row = row0 + r;
        const bool ok = row < N && pc < part_chunks && chunk0 + pc < row_chunks;
        cp_async16z(dst + stage_at<WK>(r, c),
                    ok ? W + (size_t)row * rbytes + (size_t)(chunk0 + pc) * 16 : g.w, ok);
      }
      ++fetched;
      if (++f_st == nst) {
        f_st = 0;
        ++f_item;
      }
      if (++f_slot == D) f_slot = 0;
    }
    cp_async_commit();
  };
  // before the wait (no weight or gain depends on a kernel): the first
  // stages, and the gains of this thread's input column, rounded to bf16
  for (int s = 0; s < D - 1; ++s) fetch_next();
  const int in_chunks = g.part_segs * 4;   // 16-byte chunks of a staged row
  const int e0 = seg0 * kSeg + tid * 8;    // this thread's column of the part
  const bool col = tid < nseg * 4 && e0 < K;
  float gain[8];
  if (PRO == PRO_RMS && col) {
    const float4 g0 = *reinterpret_cast<const float4*>(g.ln_g + e0);
    const float4 g1 = *reinterpret_cast<const float4*>(g.ln_g + e0 + 4);
    const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) gain[i] = round_to<T>(gv[i]);
  }
  pdl_wait();

  // the prologue: column tid of the B slot rows, 8 loads in flight a thread
  // (columns past the part and rows past B zero); RMSNorm with
  // gemv_batch_kernel's statistics (per slot: lane-strided 16-byte chunks in
  // order, then a warp sum; from the staged rows when the part is all of K)
  // and rounding points, in place
  const T* x = g.in;
  auto load_rows = [&](int b0, uint4 (&u)[8]) {  // slots b0 .. b0 + 7 of column tid
#pragma unroll
    for (int i = 0; i < 8; ++i)
      u[i] = col && b0 + i < B ? *reinterpret_cast<const uint4*>(x + (size_t)(b0 + i) * K + e0)
                               : make_uint4(0u, 0u, 0u, 0u);
  };
  auto stage = [&](const uint4 (&u0)[8]) {  // slots 0-7 loaded in u0, then the rest
    if (tid >= in_chunks) return;
    for (int b0 = 0; b0 < NP; b0 += 8) {
      uint4 u[8];
      if (b0 > 0) load_rows(b0, u);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<uint4*>(xs + (b0 + i) * RS + tid * 16) = b0 == 0 ? u0[i] : u[i];
    }
  };
  uint4 u0[8];
  if (tid < in_chunks) load_rows(0, u0);
  // a split part's statistics read x itself, while u0 is in flight
  const bool stats_first = PRO == PRO_RMS && S > 1;
  if (!stats_first) stage(u0);
  if (PRO == PRO_RMS) {
    if (S == 1) __syncthreads();  // the staged rows are all of K
    for (int b = warp; b < B; b += kWarps) {
      float s = 0.0f;
      if (S == 1) {
        for (int c = lane; c < K / 8; c += 32) {
          float v[8];
          unpack16(*reinterpret_cast<const uint4*>(xs + b * RS + c * 16), v);
#pragma unroll
          for (int i = 0; i < 8; ++i) s += v[i] * v[i];
        }
      } else {
        const uint4* xb = reinterpret_cast<const uint4*>(x + (size_t)b * K);
        for (int c0 = lane; c0 < K / 8; c0 += 8 * 32) {
          uint4 u[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (c0 + 32 * i < K / 8) u[i] = xb[c0 + 32 * i];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (c0 + 32 * i < K / 8) {
              float v[8];
              unpack16(u[i], v);
#pragma unroll
              for (int q = 0; q < 8; ++q) s += v[q] * v[q];
            }
          }
        }
      }
      s = warp_sum(s);
      if (lane == 0) rstd[b] = rsqrtf(s / (float)K + g.eps);
    }
    if (stats_first) stage(u0);
    __syncthreads();
    if (col) {
      for (int b = 0; b < B; ++b) {
        uint4* p = reinterpret_cast<uint4*>(xs + b * RS + tid * 16);
        float v[8];
        unpack16(*p, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = round_to<T>(v[i] * rstd[b]) * gain[i];
        *p = pack16<T>(v);  // rounds to bf16
      }
    }
  }
  __syncthreads();
  pdl_launch_dependents();

  float acc[NT][4];
  float gacc[WK == W_I4 ? NT : 1][4];  // W_I4: the open group's sums
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = gacc[WK == W_I4 ? j : 0][q] = 0.0f;
  float best[NT][2];
  int best_i[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    best[j][0] = best[j][1] = -INFINITY;
    best_i[j][0] = best_i[j][1] = 0;
  }
  const int n_groups = WK == W_I4 ? K / g.group : 1;
  float gs0 = 0.0f, gs1 = 0.0f;  // W_I4: the open group's scales of rows g, g + 8
  float pre[2][2] = {{1.0f, 0.0f}, {1.0f, 0.0f}};  // rows g, g + 8: W_I8 scale, bias
  float res[NT][4];  // EPI_RESIDUAL: the item's residual values, requested early

  // the epilogue of rows r0, r0 + 8 (lane's) and slots 8j + 2t + e
  auto epilogue = [&](const float (&y)[NT][4], int r0) {
    T* out = g.out;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      const bool live = row < N;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int b = 8 * j + 2 * t4 + e;
          float v = y[j][2 * h + e];
          if constexpr (WK == W_I8) v *= pre[h][0];
          if constexpr (EPI == EPI_SWIGLU) {  // gate row 2i (even g), up row 2i + 1 (lane + 4)
            const float up = __shfl_down_sync(0xffffffffu, v, 4);
            if ((gq & 1) == 0 && live && b < B)
              out[(size_t)b * (N / 2) + row / 2] =
                  from_f32<T>(round_to<T>(silu(v)) * round_to<T>(up));
          } else if (live && b < B) {
            if (EPI == EPI_STORE) {
              out[(size_t)b * N + row] = from_f32<T>(v + pre[h][1]);
            } else if (EPI == EPI_RESIDUAL) {
              out[(size_t)b * N + row] = from_f32<T>(res[j][2 * h + e] + round_to<T>(v + pre[h][1]));
            } else if (EPI == EPI_ARGMAX && better(v, row, best[j][e], best_i[j][e])) {
              best[j][e] = v;
              best_i[j][e] = row;
            }
          }
        }
    }
  };

  // the item's sums are whole: unsplit, the epilogue; split, this part's
  // partial out, and the tile's last block adds the parts in order (8
  // partials' loads in flight a thread)
  auto finish = [&](int tile) {
    const int r0 = tile * kTileRows + warp * 16 + gq;
    float y[NT][4];
    if (S == 1) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) y[j][q] = acc[j][q];
    } else {
      float4* P = reinterpret_cast<float4*>(g.part);
      const size_t at = ((size_t)tile * S * kThreads + tid) * NT;
      const size_t per_split = (size_t)kThreads * NT;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        P[at + split * per_split + j] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      __syncthreads();  // the block's partial is written; one fence releases it (cumulative)
      if (tid == 0) {
        __threadfence();
        last_block = atomicAdd(g.count + tile, 1) == S - 1;
      }
      __syncthreads();
      if (!last_block) return;  // uniform
      __threadfence();
      constexpr int GRP = 8 / NT;
      for (int s0 = 0; s0 < S; s0 += GRP) {
        float4 p[GRP][NT];
#pragma unroll
        for (int u = 0; u < GRP; ++u)
#pragma unroll
          for (int j = 0; j < NT; ++j)
            if (s0 + u < S) p[u][j] = __ldcg(P + at + (s0 + u) * per_split + j);
#pragma unroll
        for (int u = 0; u < GRP; ++u)
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if (s0 + u >= S) continue;
            if (s0 + u == 0) {
              y[j][0] = p[u][j].x; y[j][1] = p[u][j].y; y[j][2] = p[u][j].z; y[j][3] = p[u][j].w;
            } else {
              y[j][0] += p[u][j].x; y[j][1] += p[u][j].y; y[j][2] += p[u][j].z;
              y[j][3] += p[u][j].w;
            }
          }
      }
      if (tid == 0) g.count[tile] = 0;  // clean for the next launch
    }
    epilogue(y, r0);
  };

  int item = 0, st = 0, slot = 0;  // the stage consumed
  for (int s = 0; s < total; ++s) {
    cp_async_wait_n(D - 2);  // this lane's copies of stage s
    __syncwarp();            // the warp's; its slot of stage s - 1 is free
    fetch_next();
    const int tile = jb + item * Gs;
    const int r0 = tile * kTileRows + warp * 16 + gq;
    if (st == 0) {  // what the item's epilogue reads, requested early
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = min(r0 + 8 * h, N - 1);
        if constexpr (WK == W_I8) pre[h][0] = static_cast<const float*>(g.ws)[row];
        if (EPI == EPI_STORE || EPI == EPI_RESIDUAL)
          pre[h][1] = g.bias != nullptr ? g.bias[row] : 0.0f;
        if constexpr (EPI == EPI_RESIDUAL) {  // x is read here only by its tile's blocks,
#pragma unroll                                // and written after, by the last of them
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int b = min(8 * j + 2 * t4 + e, B - 1);
              res[j][2 * h + e] = to_f32(g.out[(size_t)b * N + row]);
            }
        }
      }
    }
    const unsigned char* stg = ring + slot * kStageBytes;
#pragma unroll
    for (int q = 0; q < SPS; ++q) {
      const int ls = st * SPS + q;  // segment of the part
      if (ls >= nseg) break;        // uniform
      const int k = (seg0 + ls) * kSeg;
      if constexpr (WK == W_I4) {
        if (k % g.group == 0 || ls == 0) {  // the group's first segment: its scales
          const __nv_bfloat16* sc = static_cast<const __nv_bfloat16*>(g.ws);
          gs0 = __bfloat162float(sc[(size_t)min(r0, N - 1) * n_groups + k / g.group]);
          gs1 = __bfloat162float(sc[(size_t)min(r0 + 8, N - 1) * n_groups + k / g.group]);
        }
      }
      unsigned a0[4], a1[4];
      load_a<WK>(stg, q, gq, t4, a0, a1);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint4 xv = *reinterpret_cast<const uint4*>(xs + (8 * j + gq) * RS + ls * 64 +
                                                         t4 * 16);
        if constexpr (WK == W_I4) {
          mma_bf16(gacc[j], a0, xv.x, xv.y);
          mma_bf16(gacc[j], a1, xv.z, xv.w);
        } else {
          mma_bf16(acc[j], a0, xv.x, xv.y);
          mma_bf16(acc[j], a1, xv.z, xv.w);
        }
      }
      if constexpr (WK == W_I4) {
        if ((k + kSeg) % g.group == 0 || ls == nseg - 1) {  // the group's (or part's) end
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            acc[j][0] = fmaf(gacc[j][0], gs0, acc[j][0]);
            acc[j][1] = fmaf(gacc[j][1], gs0, acc[j][1]);
            acc[j][2] = fmaf(gacc[j][2], gs1, acc[j][2]);
            acc[j][3] = fmaf(gacc[j][3], gs1, acc[j][3]);
#pragma unroll
            for (int q2 = 0; q2 < 4; ++q2) gacc[j][q2] = 0.0f;
          }
        }
      }
    }
    if (++slot == D) slot = 0;
    if (++st == nst) {
      finish(tile);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] = 0.0f;
      st = 0;
      ++item;
    }
  }
  cp_async_wait<0>();

  if constexpr (EPI == EPI_ARGMAX) {  // per slot: the lanes' rows, the warps, in order
    float* bv = reinterpret_cast<float*>(xs);  // [kWarps][NP], the inputs are done
    int* bi = reinterpret_cast<int*>(xs) + kWarps * NP;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = best[j][e];
        int i = best_i[j][e];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, v, o);
          const int oi = __shfl_xor_sync(0xffffffffu, i, o);
          if (better(ov, oi, v, i)) { v = ov; i = oi; }
        }
        best[j][e] = v;
        best_i[j][e] = i;
      }
    __syncthreads();  // every warp is past its reads of xs
    if (gq == 0) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          bv[warp * NP + 8 * j + 2 * t4 + e] = best[j][e];
          bi[warp * NP + 8 * j + 2 * t4 + e] = best_i[j][e];
        }
    }
    __syncthreads();
    if (tid < B) {
      float v = bv[tid];
      int i = bi[tid];
      for (int w = 1; w < kWarps; ++w)
        if (better(bv[w * NP + tid], bi[w * NP + tid], v, i)) {
          v = bv[w * NP + tid];
          i = bi[w * NP + tid];
        }
      g.part_val[(size_t)tid * gridDim.x + blockIdx.x] = v;
      g.part_idx[(size_t)tid * gridDim.x + blockIdx.x] = i;
    }
  }
}

// One GEMV of tier WK over NT n8 tiles of slots: the persistent grid from the
// SM count and the occupancy, a multiple of the splits, at most `max_grid`
// (the ARGMAX partials a slot) and one block an item.
template <int PRO, int EPI, int WK, int NT>
int launch_nt(Gemv g, const Plan& p, int max_grid, int* grid_out, cudaStream_t st) {
  auto kernel = gemv_tc_kernel<PRO, EPI, WK, NT>;
  if (int rc = allow_smem(kernel, p.smem)) return rc;
  int per_sm = 0;
  if (cudaError_t e =
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, p.smem))
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int grid = std::min(sm_count() * std::min(per_sm, p.blocks_per_sm), p.tiles * p.splits);
  grid = std::min(grid, max_grid);
  grid -= grid % p.splits;
  if (grid < p.splits) return (int)cudaErrorInvalidConfiguration;
  if (grid_out != nullptr) *grid_out = grid;
  g.splits = p.splits;
  g.part_segs = p.part_segs;
  g.row_stride = p.row_stride;
  g.stages = p.stages;
  return launch_pdl(kernel, grid, p.smem, st, g);
}

template <int PRO, int EPI, int WK>
int launch_tier(const Gemv& g, const Plan& p, int max_grid, int* grid_out, cudaStream_t st) {
  if (g.B <= 8) return launch_nt<PRO, EPI, WK, 1>(g, p, max_grid, grid_out, st);
  if (g.B <= 16) return launch_nt<PRO, EPI, WK, 2>(g, p, max_grid, grid_out, st);
  return launch_nt<PRO, EPI, WK, 4>(g, p, max_grid, grid_out, st);
}

// The bf16 GEMV of weight `w`'s tier over B slot rows of `in`, one launch
// for every 1 <= B <= 32. Refuses a geometry it cannot take (K % 8, an int4
// group that is not a whole number of segments) and scratch that is too small.
template <int PRO, int EPI>
int gemv(const WeightRef& w, int N, int K, int B, const __nv_bfloat16* in, const float* ln_g,
         float eps, const float* bias, __nv_bfloat16* out, const Scratch& sc,
         cudaStream_t st, int max_grid = 1 << 30, float* part_val = nullptr,
         int* part_idx = nullptr, int* grid_out = nullptr) {
  if (B < 1 || B > kMaxSlots || N < 1 || K < 8 || K % 8 ||
      (w.kind == W_I4 && (w.group <= 0 || w.group % kSeg || K % w.group)) ||
      (w.kind == W_I8 && K % 16) || (EPI == EPI_SWIGLU && N % 2))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_of(N, K, B, sm_count());
  if (p.splits > 1 && (sc.part == nullptr || sc.count == nullptr || p.tiles > sc.count_len ||
                       sc.part_len < p.part_floats))
    return (int)cudaErrorInvalidValue;
  const Gemv g{w.w, w.s, w.group, N, K, B, in, ln_g, eps, bias, out, part_val, part_idx,
               sc.part, sc.count, 0, 0, 0, 0};
  if (w.kind == W_T) return launch_tier<PRO, EPI, W_T>(g, p, max_grid, grid_out, st);
  if (w.kind == W_I8) return launch_tier<PRO, EPI, W_I8>(g, p, max_grid, grid_out, st);
  if (w.kind == W_I4) return launch_tier<PRO, EPI, W_I4>(g, p, max_grid, grid_out, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace stc
}  // namespace
