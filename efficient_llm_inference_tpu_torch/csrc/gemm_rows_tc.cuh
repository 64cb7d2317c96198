// The tensor-core skinny GEMM shared by #7 pallas_linear (linear.cu, bf16 x
// bf16) and the bf16 batched verify chain (megabatch_verify.cu):
//
//   y[r, n] = sum_k x[r, k] * W[n, k]     for R >= 1 input rows r,
//
// bf16 inputs, fp32 sums, on the tensor cores (mma.sync m16n8k16, bf16 ->
// fp32). It replaces no TPU kernel of its own: it is the product inside the
// JAX kernels' dot_general (ops/pallas/linear.py:35-40) and inside the
// batched verify programs (ops/pallas/megakernel_batch_verify.py), which
// the CUDA-core GEMVs (linear.cu's fp32 kernels, gemv_batch.cuh) ran with
// fp32 FMAs, streaming every weight again for each group of 8 rows.
//
// Bound: bytes up to ~128 rows. Each weight element feeds 2 R operations;
// the H100 does 989 TFLOP/s of bf16 against 3.35 TB/s, ~295 operations a
// byte, so a bf16 weight (2 bytes) is bytes-bound below R ~ 295 (the
// mma.sync path reaches about half that rate). The design reads each weight
// once per launch of up to 256 rows and applies it to all:
//
// * Tiles. A block owns BM = 128 weight rows (outputs; 8 m16 tiles, the
//   MMA's M operand) and all R input rows (ceil(R / 8) n8 tiles, the N
//   operand; 128 input rows a stage cost one stage of weights, from L2),
//   and walks its K range in stages of BK = 64 inputs (4 k16 steps).
// * One weight stream. A stage's weight tile (16 KB of bf16; 8 KB of int8,
//   4 KB of int4 codes) and its input tile (R x 64 bf16) come by the
//   Tensor Memory Accelerator: one 2D tensor-map copy a tile, issued by one
//   thread, completing on the stage's mbarrier, rows and columns past the
//   edges zero-filled, bf16 tiles in the 128-byte swizzle (16-byte chunk c
//   of row r at c ^ (r % 8)) so that ldmatrix's eight rows hit distinct
//   banks. No warp's instruction stream waits on the memory queue, so the
//   MMAs overlap the stream. The ring fills ~200 KB of shared memory
//   (`stages`: 3 to 16 stages, one block an SM): 48-160 KB of weights in
//   flight an SM, what the HBM's latency under load asks at 3.35 TB/s.
//   ldmatrix.trans reads linear.cu's [K, N] weight, whose N is contiguous
//   (two 64-column boxes a stage). A [K, N] weight whose rows are not
//   16-byte aligned (an odd N such as GPT-2's 50257) cannot be a tensor
//   map: its rows' aligned-down 16-byte chunks come by cp.async and are
//   realigned in shared memory a stage at a time.
// * Warps. 8 warps: warp w takes m16 tiles 2 (w % 4) and 2 (w % 4) + 1 and
//   the n8 tiles w / 4, w / 4 + 2, ..., 2 NTW n8 tiles in all (NTW in {1, 2,
//   4, 8, 16}, the one instance that holds R; input rows past R are zero):
//   its 2 x NTW accumulator tiles stay in registers for the whole K range,
//   and a k16 step loads all its fragments (ldmatrix.x4: two n8 tiles a
//   load) before its 2 NTW independent MMAs.
// * Fixed summation order. Every output (n, r) is summed by one warp over
//   its K range in k16 steps in order; the K split (split_count: at most 4)
//   depends on (N, K) alone, and the splits' fp32 partials are added in
//   split order by the last block of the tile to finish (a counter a tile,
//   reset by that block). So a row's result is bitwise the same whether it
//   is launched alone, beside 7 rows or beside 255: the verify-width ladder
//   of the server changes R from burst to burst, never a row's sums.
// * Weight tiers (megabatch_verify.cu; JAX's "wscale" / "w4scale"). The
//   codes' stage is decoded once a tile by weight_tier.cuh's decode_chunk
//   into a bf16 tile (int8 and int4 codes are exact in bf16), then the same
//   MMAs. W_I8 scales a row's fp32 sum before the epilogue; W_I4 keeps the
//   JAX int4w8 form: the fp32 sum of each group of G inputs (G % 32 == 0,
//   so a group is whole k16 steps; a split that ends inside a group closes
//   its part of it) times its (row, group) scale, then added. The open
//   group's sums double the accumulators, so W_I4 launches at most 128 rows
//   at a time (more rows: a launch a group of 128).
//
// The epilogue is the caller's: `Epi::apply(ys, ldy, n0, N, R)` gets the
// tile's final fp32 sums (tier scale applied) in shared memory, ys[r * ldy
// + m] for output n0 + m; `Epi::finish(R)` runs once a block at the end
// (the batched verify's argmax partials); `Epi::shifted(r0, N, grid)` is
// the epilogue of rows r0.. of a product launched in row groups.

#pragma once

#include <cuda.h>  // CUtensorMap (the encoder comes through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "weight_tier.cuh"

namespace {
namespace tcg {

constexpr int kThreads = 256;    // 8 warps
constexpr int BM = 128;          // weight rows (outputs) a tile
constexpr int BK = 64;           // inputs a stage: 128 bytes of bf16 a tile row
constexpr int kMaxRows = 256;    // input rows a launch (W_I4: 128)
constexpr int kLdy = BM + 4;     // fp32 row stride of the staged output tile
constexpr int kCounters = 256;   // tile counters the caller provides (split: <= 66 tiles)
constexpr int kRawRow = 2 * BM + 16;  // bytes of an unaligned [K, N] row's stage
// split_count: a product of at most kSplitItems / 2 tiles splits K in up
// to kMaxSplits parts, aiming at kSplitItems blocks (one an SM) of at least
// kMinSplitChunks stages each
constexpr int kSplitItems = 132, kMaxSplits = 4, kMinSplitChunks = 4;
constexpr int kRingBytes = 200 * 1024;  // shared memory a ring may take

enum { LAYOUT_NK = 0, LAYOUT_KN = 1 };  // W [N, K] (K contiguous) or [K, N]

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// K-splits of an [N, K] product: a function of (N, K) only, never of R.
__host__ __device__ inline int split_count(int N, int K) {
  const int tiles = cdiv(N, BM), chunks = cdiv(K, BK);
  int s = kSplitItems / tiles;
  s = s < 1 ? 1 : (s < kMaxSplits ? s : kMaxSplits);
  const int cap = chunks / kMinSplitChunks > 1 ? chunks / kMinSplitChunks : 1;
  return s < cap ? s : cap;
}

__host__ __device__ constexpr int max_rows(int WK) {
  return WK == W_I4 ? kMaxRows / 2 : kMaxRows;
}

// fp32 scratch of a launch's split partials: [tile][split][R][BM].
__host__ __device__ inline long long part_floats(int N, int K, int R) {
  const int S = split_count(N, K);
  return S > 1 ? (long long)S * R * cdiv(N, BM) * BM : 0;
}

// Bytes of a ring slot's weights: the bf16 tile, a tier's codes, or a
// [K, N] weight's stage (room for an unaligned row's aligned-down chunks).
template <int LAYOUT, int WK> __host__ __device__ constexpr int w_stage_bytes() {
  return LAYOUT == LAYOUT_KN ? BK * kRawRow
                             : (WK == W_T ? BM * BK * 2 : (WK == W_I8 ? BM * BK : BM * BK / 2));
}
// Bytes of the decoded / realigned tile a launch may read instead (0: none).
template <int LAYOUT, int WK> __host__ __device__ constexpr int dec_bytes() {
  return LAYOUT == LAYOUT_KN || WK != W_T ? BM * BK * 2 : 0;
}
__host__ __device__ constexpr int clamp_stages(int s) { return s > 16 ? 16 : (s < 3 ? 3 : s); }
// Stages of the ring: as many as kRingBytes holds beside the decoded tile
// at the instance's largest input tile (16 NTW rows), 3 to 16.
template <int LAYOUT, int WK, int NTW> __host__ __device__ constexpr int stages() {
  return clamp_stages((kRingBytes - dec_bytes<LAYOUT, WK>()) /
                      (w_stage_bytes<LAYOUT, WK>() + 16 * NTW * BK * 2));
}

// Dynamic shared memory of an instance (its 16 NTW input rows, rows past R
// zero): 1 KB for the 1024-byte alignment the swizzled copies ask, the ring
// (and the decoded tile), which the staged output tile (16 NTW x kLdy fp32)
// reuses once it drains.
template <int LAYOUT, int WK, int NTW> __host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + ((size_t)stages<LAYOUT, WK, NTW>() *
                             (w_stage_bytes<LAYOUT, WK>() + 16 * NTW * BK * 2) +
                         dec_bytes<LAYOUT, WK>() >
                     (size_t)16 * NTW * kLdy * 4
                 ? (size_t)stages<LAYOUT, WK, NTW>() *
                           (w_stage_bytes<LAYOUT, WK>() + 16 * NTW * BK * 2) +
                       dec_bytes<LAYOUT, WK>()
                 : (size_t)16 * NTW * kLdy * 4);
}

// One product. W: LAYOUT_NK [N, K] rows of the tier's values or codes
// (scales `ws`: W_I8 fp32 [N], W_I4 bf16 [N, K / group]); LAYOUT_KN [K, N]
// bf16. x [R, K] bf16. part: part_floats(N, K, rows a launch) floats;
// counters: kCounters ints, zero before the launch and after it.
struct Gemm {
  const void* w;
  const void* ws;
  int group;
  int N, K, R;
  const __nv_bfloat16* x;
  int w_aligned, x_aligned;  // 16-byte aligned rows: tensor maps; else realigned / element loads
  int splits;
  float* part;
  int* counters;
};

// ------------------------------------------------------------ primitives

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (nothing read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// mbarriers and the Tensor Memory Accelerator: a stage's tile copies
// complete on its barrier, which the issuing thread arms with their bytes.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\n"
      "bra.uni WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// the box of `map` at (inner coordinate c0, outer c1) -> dst, on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap& map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}
// orders the block's earlier generic shared-memory writes before later
// tensor copies into the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// d += a (16 x 16, row-major) . b (16 x 8, column-major), fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Byte offset of 16-byte chunk c (0..7) of row `row` in a tile of 128-byte
// rows in the 128-byte swizzle (the tensor copies' layout).
__device__ __forceinline__ int swz(int row, int c) { return row * 128 + ((c ^ (row & 7)) << 4); }

__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ void add4(float4& y, const float4& p) {
  y.x += p.x;
  y.y += p.y;
  y.z += p.z;
  y.w += p.w;
}

// ------------------------------------------------------------------ kernel

// One block an SM (its ring fills the shared memory), up to 255 registers.
// wmap / xmap: the weights' and the input rows' tensor maps (unused where
// those rows are not 16-byte aligned).
template <int LAYOUT, int WK, int NTW, class Epi>
__global__ void __launch_bounds__(kThreads, 1)
gemm_rows_kernel(const Gemm g, const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap xmap, Epi epi) {
  static_assert(LAYOUT == LAYOUT_NK || WK == W_T, "codes come as [N, K] rows");
  constexpr int ST = stages<LAYOUT, WK, NTW>();
  constexpr int WSB = w_stage_bytes<LAYOUT, WK>();
  constexpr int WTB = LAYOUT == LAYOUT_KN ? BM * BK * 2 : (WK == W_T ? BM * BK * 2 : WSB);
  constexpr int M4 = BM / 4;  // float4s an output-tile row
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[ST];  // a stage's tensor copies
  __shared__ int last_block;
  // the swizzled copies ask for 1024-byte aligned tiles
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  constexpr int RP = 16 * NTW;  // input rows of the tiles (past R: zero)
  constexpr int xsb = RP * BK * 2;
  const int R = g.R, N = g.N, K = g.K;
  unsigned char* wbuf = smem;
  unsigned char* xbuf = smem + ST * WSB;
  unsigned char* wdec = xbuf + ST * xsb;       // the decoded / realigned stage
  float* ys = reinterpret_cast<float*>(smem);  // the output tile, once the ring drains
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mp = warp & 3, nh = warp >> 2;
  const int gid = lane >> 2, tig = lane & 3;
  const int tiles = cdiv(N, BM), chunks = cdiv(K, BK), S = g.splits;
  const int items = tiles * S;
  const __nv_bfloat16* x = g.x;
  const char* W = static_cast<const char*>(g.w);
  const bool wa = LAYOUT == LAYOUT_NK || g.w_aligned;
  const bool xa = LAYOUT == LAYOUT_NK || g.x_aligned;
  const bool dec = WK != W_T || !wa;  // the MMAs read wdec
  unsigned phases = 0;                // bit s: the parity of slot s's next completion
  Epi e = epi;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int tile = item / S, split = item - tile * S;
    const int n0 = tile * BM;
    const int nv = min(BM, N - n0);
    const int c0 = split * chunks / S, c1 = (split + 1) * chunks / S;
    const int k_end = min(c1 * BK, K);

    // stage st <- chunk c: thread 0 arms full[st] with the tiles' bytes and
    // issues their tensor copies (the input rows' box, the weights' box or
    // boxes); an unaligned [K, N] weight's rows by cp.async, unaligned input
    // rows by element loads
    auto fill = [&](int st, int c) {
      const int k0 = c * BK;
      unsigned char* wst = wbuf + st * WSB;
      unsigned char* xst = xbuf + st * xsb;
      if (tid == 0) {
        mbar_expect_tx(&full[st], (xa ? xsb : 0) + (wa ? WTB : 0));
        if (xa) tma_load(xst, xmap, k0, 0, &full[st]);
        if constexpr (LAYOUT == LAYOUT_KN) {
          if (wa) {  // [64 k][64 n] boxes at n0 and n0 + 64
            tma_load(wst, wmap, n0, k0, &full[st]);
            tma_load(wst + BM * BK, wmap, n0 + BM / 2, k0, &full[st]);
          }
        } else {  // [128 n][64 k] bf16 / [128 n][64 or 32 bytes] codes
          tma_load(wst, wmap, WK == W_I4 ? k0 / 2 : k0, n0, &full[st]);
        }
      }
      if (!xa) {
        for (int i = tid; i < RP * BK; i += kThreads) {
          const int r = i >> 6, kk = i & 63;
          const __nv_bfloat16 v = r < R && k0 + kk < K ? x[(size_t)r * K + k0 + kk]
                                                       : __float2bfloat16(0.0f);
          *reinterpret_cast<__nv_bfloat16*>(xst + swz(r, kk >> 3) + (kk & 7) * 2) = v;
        }
      }
      if constexpr (LAYOUT == LAYOUT_KN) {
        if (!wa) {  // each row's aligned-down 16-byte chunks, kRawRow bytes a row
          const int nk = min(BK, K - k0);
          for (int i = tid; i < BK * (kRawRow / 16); i += kThreads) {
            const int kr = i / (kRawRow / 16), j = i - kr * (kRawRow / 16);
            const uintptr_t a = (uintptr_t)(W + ((size_t)(k0 + kr) * N + n0) * 2);
            const int o = (int)(a & 15) / 2;  // the row's first element within its chunk
            const bool ok = kr < nk && 8 * j < o + nv;
            cp_async16(wst + kr * kRawRow + 16 * j,
                       ok ? reinterpret_cast<const void*>((a & ~(uintptr_t)15) + 16 * j)
                          : static_cast<const void*>(W),
                       ok);
          }
        }
      }
    };
    // stage st of chunk c -> wdec: a tier's codes decoded to bf16, or an
    // unaligned [K, N] stage's rows realigned (laid out as the copies lay a
    // tile: 128-byte rows in the swizzle; [K, N] in two 64-column halves)
    auto decode = [&](int st, int c) {
      const unsigned char* src = wbuf + st * WSB;
      if constexpr (LAYOUT == LAYOUT_KN) {
        const uint16_t* raw = reinterpret_cast<const uint16_t*>(src);
        const int nk = min(BK, K - c * BK);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = tid + q * kThreads, kr = i >> 4, ch = i & 15;
          const uintptr_t a = (uintptr_t)(W + ((size_t)(c * BK + kr) * N + n0) * 2);
          const uint16_t* row = raw + kr * (kRawRow / 2) + (int)(a & 15) / 2 + 8 * ch;
          unsigned v[4];
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const unsigned lo = kr < nk && 8 * ch + 2 * h < nv ? row[2 * h] : 0u;
            const unsigned hi = kr < nk && 8 * ch + 2 * h + 1 < nv ? row[2 * h + 1] : 0u;
            v[h] = lo | (hi << 16);
          }
          *reinterpret_cast<uint4*>(wdec + (ch >> 3) * (BM * BK) + swz(kr, ch & 7)) =
              make_uint4(v[0], v[1], v[2], v[3]);
        }
      } else if constexpr (WK == W_I8) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int i = tid + q * kThreads, m = i >> 2, ch = i & 3;
          float v[16];
          decode_chunk<W_I8>(*reinterpret_cast<const uint4*>(src + m * 64 + ch * 16), v);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint4*>(wdec + swz(m, 2 * ch + h)) = make_uint4(
                bf16x2(v[8 * h], v[8 * h + 1]), bf16x2(v[8 * h + 2], v[8 * h + 3]),
                bf16x2(v[8 * h + 4], v[8 * h + 5]), bf16x2(v[8 * h + 6], v[8 * h + 7]));
        }
      } else if constexpr (WK == W_I4) {
        const int m = tid >> 1, ch = tid & 1;
        float v[32];
        decode_chunk<W_I4>(*reinterpret_cast<const uint4*>(src + m * 32 + ch * 16), v);
#pragma unroll
        for (int h = 0; h < 4; ++h)
          *reinterpret_cast<uint4*>(wdec + swz(m, 4 * ch + h)) = make_uint4(
              bf16x2(v[8 * h], v[8 * h + 1]), bf16x2(v[8 * h + 2], v[8 * h + 3]),
              bf16x2(v[8 * h + 4], v[8 * h + 5]), bf16x2(v[8 * h + 6], v[8 * h + 7]));
      }
    };

    float acc[2][NTW][4];
    float gacc[2][WK == W_I4 ? NTW : 1][4];  // W_I4: the open group's sums
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][j][q] = gacc[mi][WK == W_I4 ? j : 0][q] = 0.0f;

    // stage st of chunk c: every k16 step in order, each tile of the warp
    auto compute = [&](int st, int c) {
      const unsigned char* wt = dec ? wdec : wbuf + st * WSB;
      const unsigned char* xt = xbuf + st * xsb;
      const int nks = (min(BK, k_end - c * BK) + 15) / 16;  // the K tail's empty steps skipped
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        if (ks >= nks) break;  // uniform
        const int k = c * BK + ks * 16;
        unsigned a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if constexpr (LAYOUT == LAYOUT_KN)
            ldsm_x4_trans(a[mi], wt + (mp >> 1) * (BM * BK) +
                                     swz(ks * 16 + (lane & 7) + ((lane >> 4) << 3),
                                         (mp & 1) * 4 + mi * 2 + ((lane >> 3) & 1)));
          else
            ldsm_x4(a[mi], wt + swz(mp * 32 + mi * 16 + (lane & 15), ks * 2 + (lane >> 4)));
        }
        unsigned b[NTW][2];  // n8 tile nh + 2 j
        if constexpr (NTW == 1) {
          ldsm_x2(b[0], xt + swz(nh * 8 + (lane & 7), ks * 2 + ((lane >> 3) & 1)));
        } else {
#pragma unroll
          for (int j = 0; j < NTW; j += 2) {
            unsigned q[4];
            ldsm_x4(q, xt + swz((nh + 2 * (j + (lane >> 4))) * 8 + (lane & 7),
                                ks * 2 + ((lane >> 3) & 1)));
            b[j][0] = q[0];
            b[j][1] = q[1];
            b[j + 1][0] = q[2];
            b[j + 1][1] = q[3];
          }
        }
#pragma unroll
        for (int j = 0; j < NTW; ++j)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            if constexpr (WK == W_I4)
              mma_bf16(gacc[mi][j], a[mi], b[j]);
            else
              mma_bf16(acc[mi][j], a[mi], b[j]);
          }
        if constexpr (WK == W_I4) {
          if ((k + 16) % g.group == 0 || k + 16 >= k_end) {  // the group's (or split's) last step
            const __nv_bfloat16* sc = static_cast<const __nv_bfloat16*>(g.ws);
            const int ng = K / g.group, grp = k / g.group;
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              const int ra = min(n0 + mp * 32 + mi * 16 + gid, N - 1);
              const int rb = min(n0 + mp * 32 + mi * 16 + gid + 8, N - 1);
              const float sa = __bfloat162float(sc[(size_t)ra * ng + grp]);
              const float sb = __bfloat162float(sc[(size_t)rb * ng + grp]);
#pragma unroll
              for (int j = 0; j < NTW; ++j) {
                acc[mi][j][0] = fmaf(gacc[mi][j][0], sa, acc[mi][j][0]);
                acc[mi][j][1] = fmaf(gacc[mi][j][1], sa, acc[mi][j][1]);
                acc[mi][j][2] = fmaf(gacc[mi][j][2], sb, acc[mi][j][2]);
                acc[mi][j][3] = fmaf(gacc[mi][j][3], sb, acc[mi][j][3]);
#pragma unroll
                for (int q = 0; q < 4; ++q) gacc[mi][j][q] = 0.0f;
              }
            }
          }
        }
      }
    };

    // prologue: ST - 1 stages requested
#pragma unroll 1
    for (int s = 0; s < ST - 1; ++s) {
      if (c0 + s < c1) fill(s, c0 + s);
      cp_async_commit();
    }
#pragma unroll 1
    for (int c = c0; c < c1; ++c) {
      const int i = c - c0, st = i % ST;
      cp_async_wait<ST - 2>();
      mbar_wait(&full[st], (phases >> st) & 1u);
      phases ^= 1u << st;
      __syncthreads();  // stage st has landed; every warp is done with stage i - 1
      const int cn = c + ST - 1;
      if (cn < c1) fill((i + ST - 1) % ST, cn);
      cp_async_commit();
      if (dec) {
        decode(st, c);
        __syncthreads();
      }
      compute(st, c);
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free: stage the output tile over it

#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int r = (nh + 2 * j) * 8 + 2 * tig, m = mp * 32 + mi * 16 + gid;
        ys[r * kLdy + m] = acc[mi][j][0];
        ys[(r + 1) * kLdy + m] = acc[mi][j][1];
        ys[r * kLdy + m + 8] = acc[mi][j][2];
        ys[(r + 1) * kLdy + m + 8] = acc[mi][j][3];
      }
    __syncthreads();
    const float* i8s = WK == W_I8 ? static_cast<const float*>(g.ws) : nullptr;
    if (S == 1) {
      if constexpr (WK == W_I8) {
        for (int q = tid; q < R * BM; q += kThreads) {
          const int r = q / BM, m = q - r * BM;
          if (m < nv) ys[r * kLdy + m] *= i8s[n0 + m];
        }
        __syncthreads();
      }
      e.apply(ys, kLdy, n0, N, R);
    } else {
      // this split's partial, [tile][split][r][BM]; the tile's last block
      // adds the splits in order, four float4s of loads in flight a thread
      float4* P = reinterpret_cast<float4*>(g.part) + (size_t)tile * S * R * M4;
      const int n4 = R * M4;
      for (int q = tid; q < n4; q += kThreads) {
        const int r = q / M4, m = (q - r * M4) * 4;
        P[(size_t)split * n4 + q] = *reinterpret_cast<const float4*>(ys + r * kLdy + m);
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) last_block = atomicAdd(g.counters + tile, 1) == S - 1;
      __syncthreads();
      if (last_block) {  // uniform
        __threadfence();
        for (int q0 = tid; q0 < n4; q0 += 4 * kThreads) {
          float4 y[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (q0 + u * kThreads < n4) y[u] = __ldcg(P + q0 + u * kThreads);
          for (int s = 1; s < S; ++s) {
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (q0 + u * kThreads < n4)
                add4(y[u], __ldcg(P + (size_t)s * n4 + q0 + u * kThreads));
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int q = q0 + u * kThreads;
            if (q < n4) {
              const int r = q / M4, m = (q - r * M4) * 4;
              if constexpr (WK == W_I8) {
                y[u].x *= m < nv ? i8s[n0 + m] : 0.0f;
                y[u].y *= m + 1 < nv ? i8s[n0 + m + 1] : 0.0f;
                y[u].z *= m + 2 < nv ? i8s[n0 + m + 2] : 0.0f;
                y[u].w *= m + 3 < nv ? i8s[n0 + m + 3] : 0.0f;
              }
              *reinterpret_cast<float4*>(ys + r * kLdy + m) = y[u];
            }
          }
        }
        if (tid == 0) g.counters[tile] = 0;
        __syncthreads();
        e.apply(ys, kLdy, n0, N, R);
      }
    }
    fence_proxy_async();  // the output tile's writes before the next item's tensor copies
    __syncthreads();      // ys is the next item's ring
  }
  e.finish(R);
}

// ------------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's tensor-map encoder, through the runtime (no libcuda link).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 2D map over rows x cols values of type dt (rows `pitch` bytes apart),
// box box_rows x box_cols, zero-filled past the edges; bf16 tiles in the
// 128-byte swizzle.
inline int make_map(CUtensorMap* m, const void* base, CUtensorMapDataType dt, long long rows,
                    long long cols, long long pitch, int box_rows, int box_cols, bool swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(m, dt, 2, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : (int)cudaErrorInvalidValue;
}

template <int LAYOUT, int WK, int NTW, class Epi>
int launch_ntw(const Gemm& g, int grid, const Epi& epi, cudaStream_t st) {
  auto kernel = gemm_rows_kernel<LAYOUT, WK, NTW, Epi>;
  CUtensorMap wm{}, xm{};
  int rc = 0;
  if (LAYOUT == LAYOUT_NK && WK == W_T)
    rc = make_map(&wm, g.w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, g.N, g.K, 2LL * g.K, BM, BK, true);
  else if (LAYOUT == LAYOUT_NK)  // codes as bytes: [N, K] int8, [N, K / 2] int4
    rc = make_map(&wm, g.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, g.N, WK == W_I8 ? g.K : g.K / 2,
                  WK == W_I8 ? g.K : g.K / 2, BM, WK == W_I8 ? BK : BK / 2, false);
  else if (g.w_aligned)
    rc = make_map(&wm, g.w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, g.K, g.N, 2LL * g.N, BK, BM / 2,
                  true);
  if (rc == 0 && (LAYOUT == LAYOUT_NK || g.x_aligned))
    rc = make_map(&xm, g.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, g.R, g.K, 2LL * g.K, 16 * NTW, BK,
                  true);
  if (rc) return rc;
  const size_t smem = smem_bytes<LAYOUT, WK, NTW>();
  if (smem > 32 * 1024) {  // near 48 KB with the static shared memory: opt in
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kThreads, smem, st>>>(g, wm, xm, epi);
  return (int)cudaGetLastError();
}

template <int LAYOUT, int WK, class Epi>
int launch_rows(const Gemm& g, int grid, const Epi& epi, cudaStream_t st) {
  const int ntw = cdiv(cdiv(g.R, 8), 2);
  if (ntw <= 1) return launch_ntw<LAYOUT, WK, 1>(g, grid, epi, st);
  if (ntw <= 2) return launch_ntw<LAYOUT, WK, 2>(g, grid, epi, st);
  if (ntw <= 4) return launch_ntw<LAYOUT, WK, 4>(g, grid, epi, st);
  if (ntw <= 8) return launch_ntw<LAYOUT, WK, 8>(g, grid, epi, st);
  if constexpr (WK != W_I4) return launch_ntw<LAYOUT, WK, 16>(g, grid, epi, st);
  return (int)cudaErrorInvalidValue;
}

// The product over all g.R >= 1 rows, launched in groups of max_rows(WK)
// rows (each streaming the weights once; a row's sums do not depend on its
// group); fills g.splits. `part_len`: floats at g.part. The grid is one
// block a (tile, split), or at most `max_grid` (> 0) blocks, each then
// walking several (the argmax partials of the batched verify's LM head);
// the grid used goes to *grid_used.
template <int LAYOUT, int WK, class Epi>
int gemm_rows(Gemm g, long long part_len, int max_grid, int* grid_used, const Epi& epi,
              cudaStream_t st) {
  if (g.R < 1 || g.N < 1 || g.K < 1 ||
      (LAYOUT == LAYOUT_NK && (!g.w_aligned || !g.x_aligned)) ||
      (WK == W_I4 && (g.group <= 0 || g.group % 32 || g.K % g.group)))
    return (int)cudaErrorInvalidValue;
  const int rows = g.R < max_rows(WK) ? g.R : max_rows(WK);
  g.splits = split_count(g.N, g.K);
  if (g.splits > 1 && (g.part == nullptr || g.counters == nullptr ||
                       cdiv(g.N, BM) > kCounters || part_len < part_floats(g.N, g.K, rows)))
    return (int)cudaErrorInvalidValue;
  int grid = cdiv(g.N, BM) * g.splits;
  if (max_grid > 0 && max_grid < grid) grid = max_grid;
  if (grid_used != nullptr) *grid_used = grid;
  for (int r0 = 0; r0 < g.R; r0 += rows) {
    Gemm gr = g;
    gr.R = g.R - r0 < rows ? g.R - r0 : rows;
    gr.x = g.x + (size_t)r0 * g.K;
    const int rc = launch_rows<LAYOUT, WK>(gr, grid, epi.shifted(r0, g.N, grid), st);
    if (rc) return rc;
  }
  return 0;
}

}  // namespace tcg
}  // namespace
