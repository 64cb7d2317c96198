// Paged decode attention: each slot attends the pool rows its block table
// names, with an online softmax across the blocks.
//
// Replaces efficient_llm_inference_tpu/ops/pallas/paged.py:
// paged_attention_decode. q [B, Hq, D]; pools [Hkv, n_blocks, bs, D];
// tables [B, max_blocks] int32 (entries >= n_blocks are sentinels, clamped
// to n_blocks - 1, as the JAX wrapper clamps; a negative entry, which the
// JAX kernel would read out of bounds, is clamped to 0); lengths [B]
// exclusive: slot
// b attends walked positions p < lengths[b], position p being row p % bs of
// pool block tables[b, p / bs]. out [B, Hq, D] in q's type.
//
// The JAX kernel masks with finfo(f32).min, not -inf. For a slot with
// lengths[b] == 0 every score is that value, the running max stays there,
// exp(s - m) is 1 at every walked position, and the output is the mean of V
// over all max_blocks x bs walked positions (sentinels clamped): this kernel
// reproduces it by walking every position at score 0. For lengths[b] > 0
// the positions past the last visible one add exactly 0, so the walk stops
// at min(lengths[b], max_blocks x bs).
//
// Bound: bytes. Each visible K/V row is read once and used for G (query
// heads a KV head) dot products and G multiply-adds per element: ~4 G
// operations per 2 D bytes, far below the card's ~300 per byte. The floor
// is (visible K/V bytes + q + out + tables) / 3.35 TB/s.
//
// Design: one block of 8 warps per (KV head, slot) serves the head's G
// query heads, so each K/V row is read once for the group (the TPU program
// fuses all heads of a slot instead; its grid walks blocks in order). The
// block loads its own table row into shared memory, which takes the place
// of the TPU's scalar prefetch. A row of D values is split over D / VEC
// lanes with 16-byte loads (VEC = 8 bf16 or 4 fp32), so one warp load
// covers 32 VEC / D rows; a warp issues kUnroll such loads of K and of V
// before reducing (the q.k partial sums meet by shuffles within the row's
// lanes). Each warp keeps a running max (warp-uniform), per-lane sums and
// accumulators for the G heads in fp32; the groups of lanes and then the 8
// warps are merged at the end. Splitting a slot's rows over several blocks
// (a second combine pass) is left for later.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch; elit_cuda_error_string names a code. q_dtype / pool_dtype:
// 0 = float32, 1 = bfloat16. D in {64, 128}; G = Hq / Hkv <= 8. All tensors
// contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;
constexpr int kMaxG = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// The VEC values of one 16-byte load.
template <typename T, int VEC>
__device__ __forceinline__ void unpack(const uint4& raw, float (&out)[VEC]) {
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f32(v[i]);
}

// GMAX: the register arrays' head count, a power of two >= G.
template <typename TQ, typename TP, int D, int GMAX>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q, const TP* __restrict__ kp,
                       const TP* __restrict__ vp, const int* __restrict__ tables,
                       const int* __restrict__ lengths, int Hq, int Hkv, int n_blocks, int bs,
                       int max_blocks, float sm_scale, TQ* __restrict__ out) {
  constexpr int VEC = 16 / sizeof(TP);   // dims a lane
  constexpr int LPR = D / VEC;           // lanes a row
  constexpr int RPW = 32 / LPR;          // rows a warp load
  constexpr int ROWS = RPW * kUnroll;    // rows a warp iteration
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "row split");
  extern __shared__ int tbl[];           // [max_blocks]
  __shared__ float sm_m[kWarps][GMAX];
  __shared__ float sm_l[kWarps][GMAX];
  __shared__ float sm_acc[kWarps][GMAX][D];

  const int hk = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % LPR;  // this lane's slice of a row
  const int grp = lane / LPR;  // this lane's row within a warp load

  for (int j = threadIdx.x; j < max_blocks; j += kThreads)
    tbl[j] = min(max(tables[(size_t)b * max_blocks + j], 0), n_blocks - 1);

  float qr[GMAX][VEC];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      qr[g][i] = g < G ? to_f32(q[((size_t)b * Hq + hk * G + g) * D + sub * VEC + i]) : 0.0f;
  }
  const int walk = max_blocks * bs;
  int n = min(lengths[b], walk);
  float scale = sm_scale;
  if (n <= 0) {  // no visible position: JAX's uniform weights over the walk
    n = walk;
    scale = 0.0f;
  }
  __syncthreads();

  // per head: the warp-uniform running max, per-lane sums and accumulators
  float mg[GMAX], l[GMAX], acc[GMAX][VEC];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    mg[g] = -INFINITY;
    l[g] = 0.0f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.0f;
  }

  const size_t head = (size_t)hk * n_blocks;
  for (int r0 = warp * ROWS; r0 < n; r0 += kWarps * ROWS) {
    uint4 kraw[kUnroll], vraw[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * RPW + grp;
      ok[u] = r < n;
      const int rr = ok[u] ? r : r0;  // r0 < n: a row that exists
      const size_t off = ((head + tbl[rr / bs]) * bs + rr % bs) * D + sub * VEC;
      kraw[u] = *reinterpret_cast<const uint4*>(kp + off);
      vraw[u] = *reinterpret_cast<const uint4*>(vp + off);
    }
    float kk[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) unpack<TP, VEC>(kraw[u], kk[u]);
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) break;
      float s[kUnroll];
      float mx = mg[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float dot = 0.0f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) dot = fmaf(qr[g][i], kk[u][i], dot);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[u] = ok[u] ? dot * scale : -INFINITY;
        mx = fmaxf(mx, s[u]);
      }
#pragma unroll
      for (int o = 16; o >= LPR; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float alpha = expf(mg[g] - mx);  // row r0 is visible: mx is finite
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[g][i] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = expf(s[u] - mx);  // 0 past n
        float vv[VEC];
        unpack<TP, VEC>(vraw[u], vv);
        l[g] += p;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[g][i] = fmaf(p, vv[i], acc[g][i]);
      }
      mg[g] = mx;
    }
  }

  // merge the row groups of the warp (lanes with equal `sub`), then the warps
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int o = 16; o >= LPR; o >>= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], o);
    }
    if (lane == 0) {
      sm_m[warp][g] = mg[g];
      sm_l[warp][g] = l[g];
    }
    if (grp == 0) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) sm_acc[warp][g][sub * VEC + i] = acc[g][i];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.0f, o = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (sm_l[w][g] > 0.0f) {
        const float f = expf(sm_m[w][g] - M);
        L += sm_l[w][g] * f;
        o = fmaf(sm_acc[w][g][d], f, o);
      }
    }
    // L >= 1: the row at the maximum adds exp(0) = 1
    put(out + ((size_t)b * Hq + hk * G + g) * D + d, o / L);
  }
}

template <typename TQ, typename TP, int D, int GMAX>
int launch(const void* q, const void* kp, const void* vp, const int* tables, const int* lengths,
           int B, int Hq, int Hkv, int n_blocks, int bs, int max_blocks, float sm_scale,
           void* out, cudaStream_t st) {
  const size_t smem = sizeof(int) * (size_t)max_blocks;
  auto kernel = paged_attention_kernel<TQ, TP, D, GMAX>;
  constexpr size_t kStatic = sizeof(float) * kWarps * GMAX * (D + 2);
  if (smem + kStatic > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc) return rc;
  }
  kernel<<<dim3(Hkv, B), kThreads, smem, st>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(kp), static_cast<const TP*>(vp), tables,
      lengths, Hq, Hkv, n_blocks, bs, max_blocks, sm_scale, static_cast<TQ*>(out));
  return (int)cudaGetLastError();
}

template <typename TQ, typename TP>
int dispatch_d(int D, const void* q, const void* kp, const void* vp, const int* tables,
               const int* lengths, int B, int Hq, int Hkv, int n_blocks, int bs, int max_blocks,
               float sm_scale, void* out, cudaStream_t st) {
  const int G = Hq / Hkv;
#define ELIT_G(DD)                                                                        \
  (G <= 1   ? launch<TQ, TP, DD, 1>(q, kp, vp, tables, lengths, B, Hq, Hkv, n_blocks, bs, \
                                    max_blocks, sm_scale, out, st)                        \
   : G <= 2 ? launch<TQ, TP, DD, 2>(q, kp, vp, tables, lengths, B, Hq, Hkv, n_blocks, bs, \
                                    max_blocks, sm_scale, out, st)                        \
   : G <= 4 ? launch<TQ, TP, DD, 4>(q, kp, vp, tables, lengths, B, Hq, Hkv, n_blocks, bs, \
                                    max_blocks, sm_scale, out, st)                        \
            : launch<TQ, TP, DD, 8>(q, kp, vp, tables, lengths, B, Hq, Hkv, n_blocks, bs, \
                                    max_blocks, sm_scale, out, st))
  if (D == 64) return ELIT_G(64);
  if (D == 128) return ELIT_G(128);
#undef ELIT_G
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int elit_paged_attention(int q_dtype, int pool_dtype, int B, int Hq, int Hkv, int D,
                                    int n_blocks, int bs, int max_blocks, const void* q,
                                    const void* kp, const void* vp, const int* tables,
                                    const int* lengths, float sm_scale, void* out,
                                    void* stream) {
  if (B == 0 || Hq == 0) return (int)cudaGetLastError();
  if (Hkv <= 0 || Hq % Hkv || Hq / Hkv > kMaxG || n_blocks <= 0 || bs <= 0 || max_blocks <= 0 ||
      B > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ELIT_ARGS q, kp, vp, tables, lengths, B, Hq, Hkv, n_blocks, bs, max_blocks, sm_scale, out, st
  if (q_dtype == 0 && pool_dtype == 0) return dispatch_d<float, float>(D, ELIT_ARGS);
  if (q_dtype == 0 && pool_dtype == 1) return dispatch_d<float, __nv_bfloat16>(D, ELIT_ARGS);
  if (q_dtype == 1 && pool_dtype == 0) return dispatch_d<__nv_bfloat16, float>(D, ELIT_ARGS);
  if (q_dtype == 1 && pool_dtype == 1)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(D, ELIT_ARGS);
#undef ELIT_ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* elit_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
