// The persistent streaming GEMV of the single-stream Llama/Qwen step chain
// (llama_megastep.cu), and programmatic dependent launch for its kernels.
//
// y[row] = sum_k in[k] * W[row, k] over the rows of a row-major [N, K] weight
// for one input row, with megastep_common.cuh's GEMV prologues
// (PRO_RMS: RMSNorm of x, PRO_VEC: the input vector), its epilogues
// (EPI_STORE with the Qwen bias, EPI_RESIDUAL in place, EPI_SWIGLU over
// interleaved (gate, up) rows, EPI_ARGMAX per-block partials) and weight
// tiers (W_T, W_I8, W_I4; weight_tier.cuh's chunk decode and chunk_dot), in
// the same arithmetic.
//
// Bound: bytes (a weight is read once a step; ~2 operations a weight
// element). What held the chains' first GEMV under it: a block per 2-8
// rows, each running the whole prologue (an RMSNorm over E, or all K inputs
// staged) for 8-32 KB of weights, and 3 chunks of 16 bytes requested a lane
// before it.
// The design here:
//   - kStreamBlocksPerSm (2) blocks an SM (the grid from the device's SM
//     count and the kernel's occupancy at launch), persistent: block b takes
//     tiles b, b + grid, ... so the card sweeps the weight in order; the
//     prologue runs once a block;
//   - a tile is 8 (gate, up) pairs, one a warp: a lane's chunk inputs are
//     read once for both rows, and the pair's SwiGLU, residual or argmax
//     epilogue is the warp's own; with few rows of long K (a down
//     projection) `stream_ksplit` warps share a pair, each over a part of K;
//   - the rows stream through a ring of kStages (3) stages in shared memory,
//     a stage one tile by a slice of each row (32 KB), a warp copying 32
//     neighbouring 16-byte chunks of a row at a time with cp.async, the
//     first two stages requested before griddepcontrol.wait; one block
//     barrier a stage;
//   - the inputs sit in shared memory in T (exact: they are values of T),
//     a quantized tier's padded by 16 bytes a chunk so a quarter warp's
//     16-byte reads of its chunks fall in distinct banks.
// What the first versions taught (PERF.md): one block of 8 warps an
// SM, one row a warp, streamed at about half the byte rate whatever filled
// the ring (1-D bulk copies or cp.async); two blocks an SM, a pair a warp
// and 32 KB stages (fewer barriers than 16 KB ones) keep it near the rate.
// Programmatic dependent launch: a weight depends on no kernel, so the
// first stages are requested before griddepcontrol.wait and a kernel
// launched early streams while the one before it ends; x, the
// activations, length and the token are read after the wait, and nothing
// is written before it.
// Sums: lane l of a row's warp adds the row's chunks l, l + 32, ... in order
// (the slices come in order), the lanes' partials by a shuffle tree: a
// row's fp32 sum depends on (K, its tier) alone, not on the block, the grid
// or the slice that brought it.

#pragma once

#include <algorithm>
#include <utility>

#include "megastep_common.cuh"

namespace {

// ------------------------------------------------ programmatic dependent launch

// Waits until the kernels before this one in the stream have completed and
// their writes are visible (a no-op without a programmatic dependency).
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }
// Lets the next kernel of the stream launch once every block of this one has
// called it (or exited); that kernel's griddepcontrol.wait still waits for
// this one to complete.
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// One launch of `kernel` on `st` with programmatic stream serialisation: it
// may start before the kernel before it ends (every kernel of the chain
// calls pdl_wait before it reads or writes what another kernel touches).
template <typename... Params, typename... Args>
int launch_pdl(void (*kernel)(Params...), int grid, size_t smem, cudaStream_t st,
               Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  const cudaError_t last = cudaGetLastError();
  const int rc = (int)(e != cudaSuccess ? e : last);
  if (rc == 0) ++launches_made();
  return rc;
}

// --------------------------------------------------------------- cp.async

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared, through L2 only (a weight is read once a step)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's committed groups are pending.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------ the GEMV

constexpr int kTileRows = 2 * kWarps;  // rows a tile without a K split: a pair a warp
constexpr int kSliceChunks = 128;      // 16-byte chunks of a row a warp takes a stage
constexpr int kStages = 3;
constexpr int kStreamBlocksPerSm = 2;

// A chunk's inputs in shared memory: VN values of T, then 16 bytes of
// padding for the quantized tiers (W_T's 16-byte reads are one a lane).
template <typename T, int WK>
struct StreamIn {
  static constexpr int VN = WTier<T, WK>::N;
  static constexpr int STRIDE = VN + (WK == W_T ? 0 : 16 / (int)sizeof(T));
};

// The K split inside a block: with few rows (a GEMV of under 4096) of long
// K (4096 inputs or more: a down projection) the pairs are too few for
// every warp of two blocks an SM to stream its own, so `ksplit` warps share
// a pair, each over its part of every slice, and a tile holds 16 / ksplit
// rows. A function of the weight's shape alone: a row's sum does not
// depend on the card.
template <typename T, int WK>
__host__ __device__ __forceinline__ int stream_ksplit(int N, int cpr) {
  return N < 4096 && cpr * StreamIn<T, WK>::VN >= 4096 ? 4 : 1;
}

// The chunk inputs hv[0 : N) (N values of T, 16-byte aligned) as fp32.
template <typename T, int N>
__device__ __forceinline__ void load_inputs(const T* hv, float (&a)[N]) {
  const uint4* p = reinterpret_cast<const uint4*>(hv);
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int q = 0; q < N / 8; ++q) {
      const uint4 u = p[q];
      const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[8 * q + 2 * i] = __uint_as_float(w[i] << 16);
        a[8 * q + 2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const uint4 u = p[q];
      a[4 * q] = __uint_as_float(u.x);
      a[4 * q + 1] = __uint_as_float(u.y);
      a[4 * q + 2] = __uint_as_float(u.z);
      a[4 * q + 3] = __uint_as_float(u.w);
    }
  }
}

// acc + one 16-byte chunk u of a row of tier WK times its inputs a, in
// the GEMVs' arithmetic: the model dtype's values by an fmaf chain in
// order (dot16); int8 codes' chunk_dot added; int4 codes' chunk_dot times
// the chunk's group scale s, fused into acc.
template <typename T, int WK>
__device__ __forceinline__ float chunk_acc(const uint4& u, const float (&a)[WTier<T, WK>::N],
                                           float s, float acc) {
  if constexpr (WK == W_T) {
    float w[Vec<T>::N];
    unpack16(u, w);
#pragma unroll
    for (int i = 0; i < Vec<T>::N; ++i) acc = fmaf(w[i], a[i], acc);
    return acc;
  } else {
    float cd[QTier<WK>::N];
    decode_chunk<WK>(u, cd);
    if constexpr (WK == W_I8) return acc + chunk_dot<WK>(cd, a);
    return fmaf(chunk_dot<WK>(cd, a), s, acc);
  }
}

struct StreamGemv {
  const void* w;   // [N, K] rows of tier WK
  const void* ws;  // scales (W_I8: fp32 [N]; W_I4: T [N, K / group]) or null
  int group, N, K;
  const void* in;  // [K] in T: x (PRO_RMS) or the input vector (PRO_VEC)
  const float* ln_g;
  float ln_eps;
  const float* bias;  // [N] fp32 or null
  void* out;          // T: [N], x [N] (EPI_RESIDUAL) or [N / 2] (EPI_SWIGLU)
  float* part_val;    // EPI_ARGMAX: [gridDim.x]
  int* part_idx;
};

// A stage: one tile by `slice` chunks of its rows (ksplit x kSliceChunks,
// 32 KB; half that where the block's inputs take over 16 KB, so two blocks
// still fit an SM). Shared memory of one block: kStages stages, then the
// inputs. Functions of the weight's shape and tier alone.
template <typename T, int WK>
__host__ __device__ __forceinline__ int stream_in_bytes(int cpr) {
  return cpr * StreamIn<T, WK>::STRIDE * (int)sizeof(T);
}
template <typename T, int WK>
__host__ __device__ __forceinline__ int stream_slice(int N, int cpr) {
  const int per_part = stream_in_bytes<T, WK>(cpr) > 16 * 1024 ? kSliceChunks / 2 : kSliceChunks;
  const int sl = stream_ksplit<T, WK>(N, cpr) * per_part;
  return cpr < sl ? cpr : sl;
}
template <typename T, int WK>
__host__ __device__ __forceinline__ size_t stream_ring_bytes(int N, int cpr) {
  const int rows = kTileRows / stream_ksplit<T, WK>(N, cpr);
  return (size_t)kStages * rows * stream_slice<T, WK>(N, cpr) * 16;
}
template <typename T, int WK>
size_t stream_smem_bytes(int N, int K) {
  const int cpr = K / StreamIn<T, WK>::VN;
  return stream_ring_bytes<T, WK>(N, cpr) + (size_t)stream_in_bytes<T, WK>(cpr);
}

template <typename T, int PRO, int EPI, int WK>
__global__ void __launch_bounds__(kThreads, 2) gemv_stream_kernel(const StreamGemv g) {
  constexpr int VN = StreamIn<T, WK>::VN, ST = StreamIn<T, WK>::STRIDE;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[kWarps];
  __shared__ float part[4][kTileRows];  // a split tile's sums of parts 1..ksplit-1
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = g.N, K = g.K, cpr = K / VN;
  const int ks = stream_ksplit<T, WK>(N, cpr), R = kTileRows / ks;  // rows a tile
  const int slice = stream_slice<T, WK>(N, cpr), n_slices = (cpr + slice - 1) / slice;
  const int part_len = (slice + ks - 1) / ks;  // chunks of a slice a warp's part
  const int stage_bytes = R * slice * 16;
  const size_t row_bytes = (size_t)cpr * 16;
  const int tiles = (N + R - 1) / R, grid = gridDim.x;
  const int my_tiles = (int)blockIdx.x < tiles ? (tiles - (int)blockIdx.x + grid - 1) / grid : 0;
  const int total = my_tiles * n_slices;  // stages
  unsigned char* ring = smem;
  T* h = reinterpret_cast<T*>(smem + stream_ring_bytes<T, WK>(N, cpr));  // [cpr, ST]
  const char* W = static_cast<const char*>(g.w);
  auto tile_row0 = [&](int s) { return ((int)blockIdx.x + s / n_slices * grid) * R; };

  // stage s into its slot: a warp copies 32 neighbouring chunks of a row
  // at a time, 16 bytes a lane
  auto fetch = [&](int s) {
    const int row0 = tile_row0(s), rows = min(R, N - row0);
    const int c0 = s % n_slices * slice, nc = min(slice, cpr - c0), segs = (nc + 31) / 32;
    unsigned char* dst = ring + (s % kStages) * stage_bytes;
    for (int u = warp; u < rows * segs; u += kWarps) {
      const int r = u / segs, j = (u - r * segs) * 32 + lane;
      if (j < nc)
        cp_async16(dst + (r * slice + j) * 16,
                   W + (size_t)(row0 + r) * row_bytes + (size_t)(c0 + j) * 16);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {  // before the wait
    if (s < total) fetch(s);
    cp_async_commit();
  }
  pdl_wait();
  // the inputs in T, input e at (e / VN) * ST + e % VN (RMSNorm: the
  // normalised value rounded to T, times the gain rounded to T, rounded)
  const T* x = static_cast<const T*>(g.in);
  auto at = [&](int e) { return (e / VN) * ST + e % VN; };
  if (PRO == PRO_RMS) {
    float ss = 0.0f;
    for (int e = tid; e < K; e += kThreads) {
      const float v = to_f32(x[e]);
      ss += v * v;
    }
    const float r = rsqrtf(block_sum(ss, red) / (float)K + g.ln_eps);
    for (int e = tid; e < K; e += kThreads)
      h[at(e)] = from_f32<T>(round_to<T>(to_f32(x[e]) * r) * round_to<T>(g.ln_g[e]));
  } else {
    for (int e = tid; e < K; e += kThreads) h[at(e)] = x[e];
  }
  __syncthreads();
  pdl_launch_dependents();

  const int n_groups = WK == W_I4 ? K / g.group : 1;
  const float chunk_to_group = WK == W_I4 ? (float)VN / (float)g.group : 0.0f;
  T* out = static_cast<T*>(g.out);
  // the warp's pair of a tile (rows r, r + 1) and its part q of each slice
  const int r = 2 * (warp % (kWarps / ks)), q = warp / (kWarps / ks);
  float acc0 = 0.0f, acc1 = 0.0f;  // lane's partials of the pair's rows
  float pre0 = 0.0f, pre1 = 0.0f;  // what the epilogue reads, requested early:
  float sc0 = 0.0f, sc1 = 0.0f;    // the residual or bias, and the int8 row scales
  float best = -INFINITY;
  int best_idx = 0;
  for (int s = 0; s < total; ++s) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage s
    __syncthreads();               // everyone's; stage s - 1's slot is free
    if (s + kStages - 1 < total) fetch(s + kStages - 1);
    cp_async_commit();
    const int row0 = tile_row0(s), rows = min(R, N - row0);
    const int k = s % n_slices, c0 = k * slice, nc = min(slice, cpr - c0);
    const int o = row0 + r;
    const bool live = r < rows, two = r + 1 < rows;
    if (live && q == 0 && k == 0 && lane == 0) {  // the epilogue's reads, early
      if (EPI == EPI_RESIDUAL) {
        pre0 = to_f32(out[o]);
        pre1 = two ? to_f32(out[o + 1]) : 0.0f;
      } else if (EPI == EPI_STORE && g.bias != nullptr) {
        pre0 = g.bias[o];
        pre1 = two ? g.bias[o + 1] : 0.0f;
      }
      if constexpr (WK == W_I8) {
        sc0 = static_cast<const float*>(g.ws)[o];
        sc1 = two ? static_cast<const float*>(g.ws)[o + 1] : 0.0f;
      }
    }
    if (live) {
      const uint4* w0 =
          reinterpret_cast<const uint4*>(ring + (s % kStages) * stage_bytes) + r * slice;
      const T* s0 = WK == W_I4 ? static_cast<const T*>(g.ws) + (size_t)o * n_groups : nullptr;
      const int j1 = min((q + 1) * part_len, nc);
#pragma unroll 2
      for (int j = q * part_len + lane; j < j1; j += 32) {
        const int c = c0 + j;
        float a[VN];
        load_inputs<T, VN>(h + c * ST, a);
        const int grp = WK == W_I4 ? chunk_group(c, chunk_to_group) : 0;
        acc0 = chunk_acc<T, WK>(w0[j], a, WK == W_I4 ? to_f32(s0[grp]) : 0.0f, acc0);
        if (two)
          acc1 = chunk_acc<T, WK>(w0[slice + j], a,
                                  WK == W_I4 ? to_f32(s0[n_groups + grp]) : 0.0f, acc1);
      }
    }
    if (k != n_slices - 1) continue;  // the tile's rows are not whole yet
    float y0 = warp_sum(acc0), y1 = warp_sum(acc1);
    acc0 = acc1 = 0.0f;
    if (ks > 1) {  // parts 1.. to part 0, added in order
      if (lane == 0 && q > 0) {
        part[q][r] = y0;
        part[q][r + 1] = y1;
      }
      __syncthreads();
      if (q > 0) continue;
      for (int t = 1; t < ks; ++t) {
        y0 += part[t][r];
        y1 += part[t][r + 1];
      }
    }
    if (lane != 0 || !live) continue;
    if constexpr (WK == W_I8) {  // the int8 row scales
      y0 *= sc0;
      y1 *= sc1;
    }
    if (EPI == EPI_SWIGLU) {  // rows 2j (gate), 2j + 1 (up): N is even
      out[o / 2] = from_f32<T>(round_to<T>(silu(y0)) * round_to<T>(y1));
    } else if (EPI == EPI_STORE) {
      out[o] = from_f32<T>(y0 + pre0);
      if (two) out[o + 1] = from_f32<T>(y1 + pre1);
    } else if (EPI == EPI_RESIDUAL) {
      out[o] = from_f32<T>(pre0 + round_to<T>(y0));
      if (two) out[o + 1] = from_f32<T>(pre1 + round_to<T>(y1));
    } else if (EPI == EPI_ARGMAX) {
      if (better(y0, o, best, best_idx)) { best = y0; best_idx = o; }
      if (two && better(y1, o + 1, best, best_idx)) { best = y1; best_idx = o + 1; }
    }
  }
  if (EPI == EPI_ARGMAX) {
    __shared__ float bv[kWarps];
    __shared__ int bi[kWarps];
    if (lane == 0) {
      bv[warp] = best;
      bi[warp] = best_idx;
    }
    __syncthreads();
    if (tid == 0) {
      float v = bv[0];
      int i = bi[0];
      for (int w = 1; w < kWarps; ++w)
        if (better(bv[w], bi[w], v, i)) { v = bv[w]; i = bi[w]; }
      g.part_val[blockIdx.x] = v;
      g.part_idx[blockIdx.x] = i;
    }
  }
}

// One streaming GEMV of tier WK over N rows of K inputs: the grid is the
// device's SM count times the blocks an SM takes (at most
// kStreamBlocksPerSm), at most `max_grid` and one block a tile. The grid
// launched goes to *grid_out (the ARGMAX partials' count).
template <typename T, int PRO, int EPI, int WK>
int launch_stream(const StreamGemv& g, int max_grid, cudaStream_t st, int* grid_out) {
  const size_t smem = stream_smem_bytes<T, WK>(g.N, g.K);
  auto kernel = gemv_stream_kernel<T, PRO, EPI, WK>;
  if (int rc = allow_smem(kernel, smem)) return rc;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return (int)e;
  if (cudaError_t e =
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem))
    return (int)e;
  const int rows = kTileRows / stream_ksplit<T, WK>(g.N, g.K / StreamIn<T, WK>::VN);
  const int tiles = (g.N + rows - 1) / rows;
  const int grid = std::min({sms * std::min(per_sm, kStreamBlocksPerSm), max_grid, tiles});
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  if (grid_out != nullptr) *grid_out = grid;
  return launch_pdl(kernel, grid, smem, st, g);
}

// The streaming GEMV of weight `w`'s tier.
template <typename T, int PRO, int EPI>
int gemv_stream(const WeightRef& w, int N, int K, cudaStream_t st, const T* in,
                const float* ln_g, float ln_eps, const float* bias, T* out,
                int max_grid = 1 << 30, float* part_val = nullptr, int* part_idx = nullptr,
                int* grid_out = nullptr) {
  const StreamGemv g{w.w, w.s, w.group, N, K, in, ln_g, ln_eps, bias, out, part_val, part_idx};
  if (w.kind == W_T) return launch_stream<T, PRO, EPI, W_T>(g, max_grid, st, grid_out);
  if (w.kind == W_I8) return launch_stream<T, PRO, EPI, W_I8>(g, max_grid, st, grid_out);
  if (w.kind == W_I4) return launch_stream<T, PRO, EPI, W_I4>(g, max_grid, st, grid_out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
