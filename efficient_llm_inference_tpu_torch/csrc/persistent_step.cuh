// The machinery of GPT-2's persistent whole-step kernels, shared by the
// single-stream step (gpt2_megastep.cu: #9 gpt2_megastep, #11
// gpt2_megastep_quant) and the batched step (gpt2_megabatch.cu: #14
// gpt2_megabatch, #16 gpt2_megabatch_quant): their argument structs, the
// GEMV phases of a step in stream order and a block's rows of each (the
// plan: rows [b N / g, (b + 1) N / g) of an N-row phase, fc_proj's rows of
// 4E inputs as four items), the ring's tiles, the bounded waits, the
// mbarriers and 1-D bulk copies, the grid barrier and a block's weight
// stream through its ring across the barriers (gpt2_megastep.cu's header
// comment says why each is as it is), and the cooperative launch.

#pragma once

#include <stdio.h>

#include "gemv_stream.cuh"
#include "split_attention.cuh"

// Mirrored field by field by ops/megakernel.py's MegaStepArgs (ctypes): its
// MegaArgs, which the batched and verify structs repeat, then the weight tier.
struct MegaArgs {
  int dtype, n_layer, n_embd, n_head, vocab, n_pos, capacity;
  int k_kind, v_kind, advance, lm_blocks;
  float ln_eps, quant_eps;
  const void* attn_w;  // [L, 3E, E]
  const void* proj_w;  // [L, E, E]
  const void* fc_w;    // [L, 4E, E]
  const void* fcp_w;   // [L, E, 4E]
  const void* wte;     // [V, E], also the LM head
  const void* wpe;     // [P, E]
  const float* smalls; // [L, 13, E]
  const float* lnf;    // [2, E]
  void* k;             // [L, C, EK]
  void* v;             // [L, C, EV]
  float* ks;           // [L, C] (quantized panes)
  float* vs;
  int* length;         // [1]
  const int* tok_in;   // [1] or null
  const void* x_emb;   // [E] or null
  int* tok_out;        // [1]
  void* x;             // workspace: [E], [3E], [E], [4E] in the model dtype
  void* qkv;
  void* attn;
  void* ffn;
  float* lm_val;       // [lm_blocks]: the LM head's per-block partials
  int* lm_idx;
  int w_kind, w_group; // weight tier: 0 = model dtype, 8 = int8, 4 = int4
  const void* head;    // [V, E] LM-head codes ([V, E/2] int4), or null: wte
  const void* attn_s;  // scales: [L, 3E] fp32 (int8), [L, 3E, E/G] T (int4)
  const void* proj_s;  // [L, E] / [L, E, E/G]
  const void* fc_s;    // [L, 4E] / [L, 4E, E/G]
  const void* fcp_s;   // [L, E] / [L, E, 4E/G]
  const void* head_s;  // [V] / [V, E/G]
};

// The single-stream step's arguments (ops/megakernel.py Gpt2StepArgs):
// MegaArgs, then the grid, the split attention's plan and the launcher's
// scratch.
struct Gpt2StepArgs {
  MegaArgs a;
  int grid;                    // blocks: at most lm_blocks and the card's co-resident count
  int attn_splits, attn_rows;  // splits of the capacity, rows a split
  float* attn_part;            // [n_head, splits, D + 2]
  unsigned* sync;              // [2 + n_head] zeroed: the grid barrier, the LM-head
                               // ticket, a finished-split count a head
};

namespace {

constexpr int kMaxSlots = 64;           // ring slots (one mbarrier each)
constexpr int kRingBytes = 176 * 1024;  // the ring's shared memory at most
constexpr long long kSpinNs = 2000000000LL;

// The GEMV phases of a step, in stream order.
enum { K_QKV = 0, K_PROJ = 1, K_FC = 2, K_FCP = 3, K_HEAD = 4 };

__host__ __device__ __forceinline__ int kind_rows(int kind, int E, int V) {
  return kind == K_QKV ? 3 * E : (kind == K_FC ? 4 * E : (kind == K_HEAD ? V : E));
}
// Items a row: its K inputs over E (fc_proj: 4).
__host__ __device__ __forceinline__ int kind_split(int kind) { return kind == K_FCP ? 4 : 1; }

// Bytes of one item (E inputs of a weight row) of tier WK.
template <typename T, int WK>
__host__ __device__ __forceinline__ int item_bytes(int E) {
  return WK == W_T ? E * (int)sizeof(T) : (WK == W_I8 ? E : E / 2);
}

// Rows [*r0, *r0 + n) of an N-row phase that block b of `grid` takes.
__host__ __device__ __forceinline__ int block_rows(int N, int grid, int b, int* r0) {
  const int a = (int)((long long)b * N / grid);
  *r0 = a;
  return (int)((long long)(b + 1) * N / grid) - a;
}
// A tile: `per_warp` items for each of the 8 warps (two in bf16, one in
// fp32: 24 KB of model-dtype weights at E = 768). On the card two items a
// warp beat one (fewer block barriers a phase); more items a warp gained
// nothing over int8 codes and lost over int4 ones.
template <typename T, int WK>
struct Tile {
  static constexpr int per_warp = 4 / (int)sizeof(T);
  static constexpr int items = kWarps * per_warp;
};

// --------------------------------------------- barriers, mbarriers, copies

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// A bounded wait: traps with the block and what it waited for after kSpinNs.
__device__ __forceinline__ void spin_check(long long& t0, const char* what) {
  const long long now = globaltimer();
  if (t0 == 0) {
    t0 = now;
  } else if (now - t0 > kSpinNs) {
    if ((threadIdx.x & 31) == 0)
      printf("persistent step: block %d waited over 2 s for %s\n", (int)blockIdx.x, what);
    __trap();
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}
__device__ __forceinline__ bool mbar_try(uint64_t* bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  long long t0 = 0;
  for (int i = 1; !mbar_try(bar, parity); ++i)
    if ((i & 255) == 0) spin_check(t0, "a weight tile");
}
// `bytes` (a multiple of 16) global -> shared by one bulk copy that
// completes on `bar`, which the call arms with the bytes. The weights are
// read once a step: L2 evicts them first, so the small data every step
// reads again (biases, scales, the KV rows, the activations) stays there.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "{\n.reg .b64 policy;\n"
      "createpolicy.fractional.L2::evict_first.b64 policy, 1.0;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], policy;\n}\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// All blocks of the grid meet; the writes of each before it are visible to
// every block after it (to reads that bypass L1). See the note on top.
__device__ __forceinline__ void grid_sync(unsigned* bar, int grid) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (unsigned)(grid - 1) : 1u;
    unsigned old, now;
    asm volatile("atom.add.release.gpu.global.u32 %0, [%1], %2;\n"
                 : "=r"(old) : "l"(bar), "r"(add) : "memory");
    long long t0 = 0;
    for (int i = 1;; ++i) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(now) : "l"(bar) : "memory");
      if ((now ^ old) & 0x80000000u) break;
      if ((i & 255) == 0) spin_check(t0, "a grid barrier");
    }
  }
  __syncthreads();
}

// ------------------------------------------------------------ the stream

// A block's share of one GEMV phase: its rows [r0, r0 + items / ks) as
// items, their tiles, and where its first item of layer 0 lies (a layer
// further on: + layer_bytes).
struct PhasePlan {
  const char* base;
  size_t layer_bytes;
  int r0, items, tiles;
};

// One block's weight stream: its tiles of every phase, in order, through
// the ring, TI items a tile (the single stream's Tile; the batched step's
// fp32 tile is smaller). Every thread follows the consuming cursor (slot,
// parity); thread 0 alone the issuing one (layer, phase, tile, slot),
// `slots` stages ahead. No division on either path.
template <typename T, int WK, int TI = Tile<T, WK>::items>
struct Stream {
  const MegaArgs* a;
  const PhasePlan* plan;  // [5], shared memory
  unsigned char* ring;
  uint64_t* full;
  int slots, tile_bytes, n_layer;
  int use_slot;         // the next stage's slot and its completion parity
  unsigned use_parity;
  int left;             // stages not yet issued
  int is_layer, is_kind, is_tile, is_slot;  // thread 0: the next stage to issue

  __device__ __forceinline__ void init(const MegaArgs& a, int grid, int n_slots, int t_bytes,
                                       PhasePlan* pl, unsigned char* r, uint64_t* f) {
    const int E = a.n_embd, V = a.vocab, ib = item_bytes<T, WK>(E);
    if (threadIdx.x < 5) {  // this block's share of each phase
      const int kind = threadIdx.x;
      const int N = kind_rows(kind, E, V), ks = kind_split(kind);
      int r0;
      const int items = block_rows(N, grid, blockIdx.x, &r0) * ks;
      const void* w = kind == K_QKV    ? a.attn_w
                      : kind == K_PROJ ? a.proj_w
                      : kind == K_FC   ? a.fc_w
                      : kind == K_FCP  ? a.fcp_w
                                       : (a.w_kind == W_T ? a.wte : a.head);
      pl[kind] = {static_cast<const char*>(w) + (size_t)r0 * ks * ib, (size_t)N * ks * ib, r0,
                  items, (items + TI - 1) / TI};
    }
    __syncthreads();
    this->a = &a;
    plan = pl;
    ring = r;
    full = f;
    slots = n_slots;
    tile_bytes = t_bytes;
    n_layer = a.n_layer;
    use_slot = 0;
    use_parity = 0;
    left = n_layer * (pl[K_QKV].tiles + pl[K_PROJ].tiles + pl[K_FC].tiles + pl[K_FCP].tiles) +
           pl[K_HEAD].tiles;
    is_layer = 0;
    is_kind = K_QKV;
    is_tile = 0;
    is_slot = 0;
  }

  // Thread 0: the next stage into its slot, and the cursor past it.
  __device__ __forceinline__ void issue_next() {
    while (is_tile >= plan[is_kind].tiles) {  // the next phase with tiles
      is_tile = 0;
      if (is_kind == K_FCP) {
        is_kind = ++is_layer < n_layer ? K_QKV : K_HEAD;
      } else {
        ++is_kind;
      }
    }
    const PhasePlan& ph = plan[is_kind];
    const int first = is_tile * TI, n = min(TI, ph.items - first);
    const int seg = tile_bytes / TI;  // bytes an item
    const char* src = ph.base + (is_kind == K_HEAD ? 0 : (size_t)is_layer * ph.layer_bytes) +
                      (size_t)first * seg;
    bulk_load(ring + (size_t)is_slot * tile_bytes, src, (unsigned)(n * seg), &full[is_slot]);
    ++is_tile;
    if (++is_slot == slots) is_slot = 0;
  }
  // The ring's first `slots` stages.
  __device__ __forceinline__ void fill() {
    for (int s = 0; s < slots && left > 0; ++s, --left)
      if (threadIdx.x == 0) issue_next();
  }

  // The next stage: waits for its bytes and returns it.
  __device__ __forceinline__ const unsigned char* next() {
    const int slot = use_slot;
    mbar_wait(&full[slot], use_parity);
    if (++use_slot == slots) {
      use_slot = 0;
      use_parity ^= 1u;
    }
    return ring + (size_t)slot * tile_bytes;
  }
  // The stage just consumed is free once every warp is past it (a block
  // barrier): thread 0 refills its slot at once. (Refilling later, a phase's
  // slots together or while the block waits at the grid barrier, was slower
  // on the card: PERF.md §6.)
  __device__ __forceinline__ void consumed() {
    __syncthreads();
    if (left > 0) {
      if (threadIdx.x == 0) issue_next();
      --left;
    }
  }
  // The tiles of phase `kind`, unused (the skeleton).
  __device__ __forceinline__ void skip(int kind) {
    for (int t = 0; t < plan[kind].tiles; ++t) {
      next();
      consumed();
    }
  }
};

// The epilogues of a step's GEMV phases.
enum { E_STORE = 0, E_GELU = 1, E_RESIDUAL = 2, E_ARGMAX = 3 };

// The checks both steps make of their arguments (`quant`: quantized panes
// expected): the geometry the kernels take (E a multiple of 128 up to 2048,
// whole heads, capacity up to 8192), the panes' scales, the weight tier's
// pointers and int4 group, and a plan that covers the capacity with its
// scratch.
inline bool step_args_ok(const Gpt2StepArgs* sa, bool quant) {
  const MegaArgs* a = &sa->a;
  const bool q = a->k_kind != 0 || a->v_kind != 0;
  const int E = a->n_embd, H = a->n_head;
  const bool int4 = a->k_kind == 4 || a->v_kind == 4;
  const int wk = a->w_kind, G = a->w_group;
  const bool tier_ok =
      wk == W_T || (a->head && a->attn_s && a->proj_s && a->fc_s && a->fcp_s && a->head_s &&
                    (wk == W_I8 || (wk == W_I4 && G > 0 && G % 32 == 0 && E % G == 0)));
  const bool plan_ok = sa->grid >= 1 && sa->grid <= a->lm_blocks && sa->attn_splits >= 1 &&
                       sa->attn_rows >= 1 &&
                       (long long)sa->attn_splits * sa->attn_rows >= a->capacity &&
                       sa->attn_part && sa->sync;
  return q == quant && H > 0 && E % H == 0 && E % 128 == 0 && E <= 2048 && a->capacity > 0 &&
         a->capacity <= 8192 && a->n_layer > 0 && a->vocab > 0 && (!q || (a->ks && a->vs)) &&
         (!int4 || (E / 2) % (E / H) == 0) && tier_ok && plan_ok;
}

// One cooperative launch of `kernel` (every block resident at once, or the
// launch is refused) on `st`; returns the launch's error.
template <typename Params>
int launch_cooperative(void (*kernel)(Params), int grid, size_t smem, cudaStream_t st,
                       const Params& p) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace
