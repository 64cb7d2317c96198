"""Batched whole-step decode: B independent streams, one kernel chain a step.

Port of efficient_llm_inference_tpu/ops/pallas/megakernel_batch.py
(`to_mega_layout_batch`, `from_mega_layout_batch`, `mega_batch_supported`,
`llama_mega_batch_supported`, `gpt2_megabatch`, `llama_megabatch`;
full-precision weights and the int8 / grouped-int4 weight tiers of
ops/megakernel.py's packing). The TPU program streams the weights once per step
for all B slots; on the H100 so does each step: GPT-2's is the single
stream's persistent kernel with a slot dimension (`csrc/gpt2_megabatch.cu`:
one cooperative launch a step for every 1 <= B <= 32, each weight tile's
product with the B slots on the tensor cores in bf16, split-KV attention
items for every slot), Llama/Qwen's the single-stream chain of
ops/megakernel_llama.py with a slot dimension (`csrc/megabatch.cu`: every
weight row read once and applied to the B slots' activations, attention one
block per (query head, slot)). The engine (engine/generate.py
`make_generate_batch`) captures the N steps of a generation in one CUDA
graph (ops/megakernel.py `MegaDecodeGraph` with B rows). The quantized-pane
variant is ops/megakernel_batch_quant.py.

Slots are independent streams: slot b reads only its own pane columns
t < lengths[b] plus its current token, writes its new K/V row at column
lengths[b] (nothing when lengths[b] >= C), and takes its position (GPT-2's
position embedding, which the caller adds, and Llama's RoPE row) at
min(lengths[b], n_positions - 1). Panes are [L, B, C, W]. Per slot, the
numerics are the single-stream step's, so the plain versions here apply the
single-stream plain steps slot by slot.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import _gemv_stream_tc
from . import megakernel as mk
from . import megakernel_llama as ml

# The kernels' largest batch (csrc/megabatch.cu kMaxSlots, csrc/gpt2_megabatch.cu
# kMaxBatch): the JAX server's largest admission wave. The fp32 Llama chain's
# batched GEMV takes up to 256 rows (csrc/gemv_batch.cuh kMaxRows), launched in
# groups of 8; the bf16 Llama chain's (csrc/gemv_stream_tc.cuh) and GPT-2's
# persistent step take all 32 slots in one launch.
MAX_BATCH = 32


def to_mega_layout_batch(buf: torch.Tensor) -> torch.Tensor:
    """[L, B, H, C, D] cache buffer -> [L, B, C, H*D] kernel layout (a copy)."""
    L, B, H, C, D = buf.shape
    return buf.permute(0, 1, 3, 2, 4).reshape(L, B, C, H * D).contiguous()


def from_mega_layout_batch(kb: torch.Tensor, H: int) -> torch.Tensor:
    """[L, B, C, H*D] kernel layout -> [L, B, H, C, D] cache buffer (a view)."""
    L, B, C, HD = kb.shape
    return kb.reshape(L, B, C, H, HD // H).permute(0, 1, 3, 2, 4)


def _batch_ok(batch: int) -> bool:
    return 1 <= batch <= MAX_BATCH


def mega_batch_supported(cfg, capacity: int, params: dict, batch: int) -> bool:
    """Can the batched GPT-2 step run this geometry? The JAX package's
    structure (uniform full-precision weights, E % 128 == 0,
    capacity % 8 == 0, batch >= 1) and the kernel's limits: head_dim 64 or
    128, capacity <= 8192, batch <= MAX_BATCH, and a block's shared memory
    holding the batch's staged rows beside two ring slots (`smem_plan` at
    the weights' dtype and tier: every registry geometry fits at every B;
    a wider fp32 one may not). The JAX package's VMEM budget
    (`_pick_tps_batch`) is a TPU limit and is not carried over. The weight
    gates are the single-stream step's (`mk._weights_ok`: JAX's, and the
    kernels' G % 32 for int4)."""
    return (mk.mega_supported(cfg, capacity, params) and _batch_ok(batch)
            and smem_fits(cfg, capacity, params, batch))


def llama_mega_batch_supported(cfg, capacity: int, params: dict, batch: int) -> bool:
    """Can the batched Llama/Qwen step run this geometry? The JAX package's
    structure (full-precision weights, an lm_head when untied, TC % 128,
    KW % 128, TR % 8, even head_dim, capacity % 8, batch >= 1; the copied
    `_tile_geometry`) and the kernels' limits (`megakernel_llama.
    mega_supported`, batch <= MAX_BATCH). The TPU memory envelopes (the VMEM
    budget `_llama_pick_tps_batch`, the 4 GiB stream cap, the 2048-tile DMA
    gate) are not carried over. The weight gates are the single-stream
    step's (`ml._weights_ok`)."""
    return ml.mega_supported(cfg, capacity, params) and _batch_ok(batch)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (any device): the single-stream plain steps, slot by
# slot, on views of the [L, B, C, W] panes (so the new rows land in place).


def _per_slot(step, k, v, lengths, x_emb, *rest):
    """Run `step(k_b, v_b, *rest_b, length_b, x_b)` for every slot b; returns
    (tokens int32 [B], fp32 logits [B, V])."""
    toks, logits = [], []
    for b, cur in enumerate(mk._length_tensor(lengths, "cpu").tolist()):
        out = step(k[:, b], v[:, b], *(t[:, b] for t in rest), cur, x_emb[b:b + 1])
        toks.append(out[0])
        logits.append(out[-1])
    return torch.stack(toks), torch.stack(logits)


def gpt2_megabatch_plain(packed: dict, k: torch.Tensor, v: torch.Tensor, lengths,
                         x_emb: torch.Tensor, *, cfg, return_logits: bool = False):
    """Plain PyTorch version of `gpt2_megabatch`: returns (tokens int32 [B],
    k, v), every slot's row lengths[b] written in place; with
    `return_logits`, the fp32 logits [B, V] come fourth."""
    def step(kb, vb, cur, x):
        return mk.gpt2_megastep_plain(packed, kb, vb, cur, x, cfg=cfg, return_logits=True)

    toks, logits = _per_slot(step, k, v, lengths, x_emb)
    return (toks, k, v, logits) if return_logits else (toks, k, v)


def llama_megabatch_plain(packed: dict, k: torch.Tensor, v: torch.Tensor, lengths,
                          x_emb: torch.Tensor, *, cfg, return_logits: bool = False):
    """Plain PyTorch version of `llama_megabatch` (as `gpt2_megabatch_plain`)."""
    def step(kb, vb, cur, x):
        return ml.llama_megastep_plain(packed, kb, vb, cur, x, cfg=cfg, return_logits=True)

    toks, logits = _per_slot(step, k, v, lengths, x_emb)
    return (toks, k, v, logits) if return_logits else (toks, k, v)


# ---------------------------------------------------------------------------
# The kernels: the single-stream launchers with a slot dimension.


class GPT2BatchArgs(mk.Gpt2StepArgs):
    """Mirror of `struct Gpt2BatchArgs` in csrc/gpt2_megabatch.cu:
    ops/megakernel.py's `Gpt2StepArgs` (the single-stream step's arguments
    over [B]-row tensors, its scratch sized by `batch_scratch`), then B."""

    _fields_ = [("batch", ctypes.c_int)]


def batch_scratch(cfg, capacity: int, B: int) -> dict:
    """The batched persistent step's plan and scratch sizes: the single
    stream's attention plan (`mk.attention_plan`, a function of the capacity
    and the head count alone, so a slot's bits do not depend on B), its
    partials for every slot (`part` fp32: [B, H, splits, D + 2]) and the
    zeroed counters (`sync` int32: the grid barrier, the LM head's ticket, a
    finished-split count a slot and head)."""
    splits, rows = mk.attention_plan(capacity, cfg.n_head)
    return {"splits": splits, "rows": rows,
            "part": B * cfg.n_head * splits * (cfg.head_dim + 2), "sync": 2 + B * cfg.n_head}


# The batched step's shared memory (csrc/gpt2_megabatch.cu smem_plan, whose
# constants tests/test_torch_gpt2_batch_plan.py holds against these): the
# weight ring of tiles of `batch_tile_items` rows, the B slots' staged input
# rows and two buffers of the warps' sums for the slots' n8 tiles.
MAX_SLOTS, RING_BYTES = 64, 176 * 1024  # persistent_step.cuh kMaxSlots, kRingBytes
DYN_SMEM, ROW_PAD, HOLD, MIN_SLOTS = 216 * 1024, 32, 2, 5  # gpt2_megabatch.cu
WARPS = mk.STEP_THREADS // 32


def _size(dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


def item_bytes(n_embd: int, dtype, wkind: str) -> int:
    """Bytes of one E-input weight row of a tier (item_bytes)."""
    if wkind == "fp":
        return n_embd * _size(dtype)
    return n_embd if wkind == "int8" else n_embd // 2


def tile_items(dtype) -> int:
    """Weight rows of one ring tile (Tile<T, WK>::items): 4 bytes a warp."""
    return WARPS * (4 // _size(dtype))


def batch_tile_items(dtype) -> int:
    """Weight rows of one ring tile of the batched step (BTile<T, WK>::items):
    the single stream's 16 in bf16, 4 in fp32 (so GPT-2 large's fp32 ring
    keeps two slots beside 32 staged fp32 rows)."""
    return 4 if _size(dtype) == 4 else tile_items(dtype)


def red_rows(dtype) -> int:
    """A sums buffer's stride over a slot's rows (red_rows): a tile's rows + 1."""
    return batch_tile_items(dtype) + 1


def smem_plan(cfg, capacity: int, dtype, wkind: str, B: int) -> tuple:
    """(ring slots, tile bytes, staged row bytes, dynamic shared memory,
    fc_proj's quarters staged at once) of the batched step at this
    geometry: the most quarters (4, 2, 1) that leave the ring MIN_SLOTS
    slots. The kernel refuses fewer than two slots."""
    E = cfg.n_embd
    tile = batch_tile_items(dtype) * item_bytes(E, dtype, wkind)
    np_ = 8 * -(-B // 8)
    red = 2 * WARPS * np_ * red_rows(dtype) * 4
    _, rows = mk.attention_plan(capacity, cfg.n_head)
    for fcp_q in (4, 2, 1):
        rs = fcp_q * E * _size(dtype) + ROW_PAD
        h = max(B * rs, WARPS * rows * 4, 2 * E * 4)  # slot rows; warps' scores; k, v
        h16 = -(-h // 16) * 16
        ring = min(RING_BYTES, DYN_SMEM - h16 - red)
        slots = min(MAX_SLOTS, ring // tile) if ring > 0 else 0
        if slots >= MIN_SLOTS or fcp_q == 1:
            return slots, tile, rs, slots * tile + h16 + red, fcp_q


def smem_fits(cfg, capacity: int, params: dict, batch: int) -> bool:
    """Does the batched step's plan at the weights' dtype and tier keep the
    two ring slots the kernel needs (`smem_plan`)? params: weights the
    single-stream gate (`mk.mega_supported`) already takes."""
    mode = mk._gpt2_weight_mode(params["blocks"])
    dtype = mk._full_precision_dtype(params) if mode == "f" else params["wte"].dtype
    wkind = "fp" if mode == "f" else mode
    return smem_plan(cfg, capacity, dtype, wkind, batch)[0] >= 2


# The bf16 Llama chain's tensor-core GEMV scratch, the tail of LlamaBatchArgs.
TC_FIELDS = ml.TC_FIELDS


class LlamaBatchArgs(ctypes.Structure):
    """Mirror of `struct LlamaBatchArgs` in csrc/megabatch.cu: B, then
    ops/megakernel_llama.py's `LlamaStepArgs`, then `TC_FIELDS`."""

    _fields_ = [("batch", ctypes.c_int)] + ml.LlamaStepArgs._fields_ + TC_FIELDS


_lib = None
_gpt2_lib = None


def gpt2_kernels() -> ctypes.CDLL:
    """The library of GPT-2's batched persistent step (csrc/gpt2_megabatch.cu)."""
    global _gpt2_lib
    if _gpt2_lib is None:
        lib = _build.load("gpt2_megabatch")
        for fn in (lib.elit_gpt2_megabatch, lib.elit_gpt2_megabatch_quant,
                   lib.elit_gpt2_megabatch_skeleton):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(GPT2BatchArgs), ctypes.c_void_p]
        lib.elit_gpt2_megabatch_grid.restype = ctypes.c_int
        lib.elit_gpt2_megabatch_grid.argtypes = [
            ctypes.POINTER(GPT2BatchArgs), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.elit_gpt2_megabatch_kernels.restype = ctypes.c_longlong
        lib.elit_gpt2_megabatch_kernels.argtypes = []
        _gpt2_lib = lib
    return _gpt2_lib


def step_kernels() -> int:
    """Kernels GPT-2's batched step has launched in this process
    (csrc/gpt2_megabatch.cu counts each launch): one a step at every B."""
    return int(gpt2_kernels().elit_gpt2_megabatch_kernels())


def kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("megabatch")
        for fn in (lib.elit_llama_megabatch, lib.elit_llama_megabatch_quant):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(LlamaBatchArgs), ctypes.c_void_p]
        lib.elit_megabatch_kernels.restype = ctypes.c_longlong
        lib.elit_megabatch_kernels.argtypes = []
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.elit_stream_gemv.restype = i
        # w, ws, w_kind, group, N, K, B, x, part, part_len, counters, count_len, out, stream
        lib.elit_stream_gemv.argtypes = [p, p, i, i, i, i, i, p, p, ctypes.c_longlong, p, i, p, p]
        _lib = lib
    return _lib


def chain_kernels() -> int:
    """Kernels the bf16 Llama/Qwen batched chain has launched in this
    process: a step's launches are the difference across the step."""
    return int(kernels().elit_megabatch_kernels())


def stream_gemv_plain(x: torch.Tensor, w: torch.Tensor, scales=None) -> torch.Tensor:
    """Plain PyTorch version of `stream_gemv`: bf16(x @ W^T) with fp32 sums,
    W in its tier's arithmetic (int8: each row's fp32 sum times its scale;
    int4: each group's fp32 sum times its scale, summed)."""
    if scales is None:
        y = x.float() @ w.float().t()
    elif w.dtype == torch.int8:
        y = (x.float() @ w.float().t()) * scales.float()
    else:
        y = torch.stack([mk.int4_rows_dot(r, w, scales) for r in x])
    return y.to(torch.bfloat16)


def stream_gemv(x: torch.Tensor, w: torch.Tensor, scales=None) -> torch.Tensor:
    """One GEMV of the bf16 batched Llama/Qwen chain alone, on its
    tensor-core route (csrc/gemv_stream_tc.cuh): x [B, K] bf16 (1 <= B <=
    32) times weight rows W [N, K] -> bf16 [B, N], no prologue or bias. W:
    bf16 [N, K], int8 codes [N, K] with fp32 row scales [N], or packed int4
    rows uint8 [N, K/2] with bf16 scales [N, K/G]. On a CUDA tensor it
    launches `elit_stream_gemv` of `csrc/megabatch.cu` and counts one launch
    in `stream_gemv.launches`; on a CPU tensor it runs `stream_gemv_plain`."""
    if x.device.type == "cpu":
        return stream_gemv_plain(x, w, scales)
    B, K = x.shape
    N = w.shape[0]
    tier = "fp" if scales is None else ("int8" if w.dtype == torch.int8 else "int4")
    if x.dtype != torch.bfloat16 or not 1 <= B <= MAX_BATCH or not x.is_contiguous() \
            or not w.is_contiguous() or (scales is not None and not scales.is_contiguous()):
        raise ValueError(f"stream_gemv: x {x.dtype} {tuple(x.shape)}: expected contiguous "
                         f"bf16 [1..{MAX_BATCH}, K] and contiguous weights")
    n_part, n_count = _gemv_stream_tc.scratch_sizes_of([(N, K)], B)
    part = torch.empty(n_part, dtype=torch.float32, device=x.device)
    count = torch.zeros(n_count, dtype=torch.int32, device=x.device)
    out = torch.empty((B, N), dtype=torch.bfloat16, device=x.device)
    lib = kernels()
    rc = lib.elit_stream_gemv(w.data_ptr(), None if scales is None else scales.data_ptr(),
                              mk.WEIGHT_CODE[tier],
                              K // scales.shape[-1] if tier == "int4" else 0, N, K, B,
                              x.data_ptr(), part.data_ptr(), n_part, count.data_ptr(), n_count,
                              out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "stream_gemv")
    stream_gemv.launches += 1
    return out


stream_gemv.launches = 0


class GPT2BatchLauncher(mk.StepLauncher):
    """The prepared arguments of one configuration's batched GPT-2 step
    ([L, B, C, W] panes, [B] tokens and lengths): one cooperative kernel of
    `grid` blocks a step, as the single stream's (any grid of at least one
    block; tests: a slot's bits do not depend on it), with its scratch for
    B slots (`batch_scratch`)."""

    entry = {False: "elit_gpt2_megabatch", True: "elit_gpt2_megabatch_quant"}
    grid_entry = "elit_gpt2_megabatch_grid"
    args_type = GPT2BatchArgs
    batched = True
    max_rows = MAX_BATCH
    lead_field = "batch"

    def layout(self, k, rows) -> tuple:
        B, lead = mk._slots(self, k)
        return B, lead, B, ()  # B is the struct's last field

    def scratch(self, cfg, capacity: int, B: int) -> dict:
        return batch_scratch(cfg, capacity, B)

    def least_grid(self, n_embd: int) -> int:
        return 1

    def library(self) -> ctypes.CDLL:
        return gpt2_kernels()


class LlamaBatchLauncher(ml.LlamaStepLauncher):
    """The prepared arguments of one configuration's batched Llama/Qwen
    step; in bf16 with the tensor-core GEMVs' scratch (`TC_FIELDS`: the
    split partials and zeroed tile counters, ops/_gemv_stream_tc.py
    `scratch_sizes` at this B), allocated once per launcher so a captured
    step allocates nothing and no two launchers share counters."""

    entry = {False: "elit_llama_megabatch", True: "elit_llama_megabatch_quant"}
    args_type = LlamaBatchArgs
    batched = True
    max_rows = MAX_BATCH

    def __init__(self, packed: dict, cfg, k, *args, **kw):
        super().__init__(packed, cfg, k, *args, **kw)
        a = self.args
        if a.dtype != mk._DTYPE_CODE[torch.bfloat16]:
            return
        n_part, n_count = _gemv_stream_tc.scratch_sizes(cfg, a.batch)
        part = torch.empty(n_part, dtype=torch.float32, device=self.device)
        count = torch.zeros(n_count, dtype=torch.int32, device=self.device)
        self._refs = self._refs + (part, count)
        a.tc_part, a.tc_part_len = part.data_ptr(), n_part
        a.tc_count, a.tc_count_len = count.data_ptr(), n_count

    def library(self) -> ctypes.CDLL:
        return kernels()


def launch_batch(launcher, counter, packed, cfg, k, v, lengths, x_emb, **kw):
    """One launch of a batched chain on CUDA tensors; returns tokens [B]."""
    tok = torch.empty(k.shape[1], dtype=torch.int32, device=k.device)
    launcher(packed, cfg, k, v, mk._length_tensor(lengths, k.device), tok,
             x_emb=x_emb.contiguous(), **kw).launch()
    mk.launch_counter(counter, packed).launches += 1
    return tok


def gpt2_megabatch(packed: dict, k: torch.Tensor, v: torch.Tensor, lengths,
                   x_emb: torch.Tensor, *, cfg):
    """One decode step of B independent GPT-2 streams (greedy). Returns
    (tokens int32 [B], k, v).

    packed: ops.megakernel.pack_gpt2_mega(params, cfg), of full-precision
    or quantized weights; k, v: [L, B, C, E] panes in the model dtype, slot
    b's row lengths[b] written in place; lengths: int32 [B] (tensor or
    ints); x_emb: [B, E] token + position embeddings in the model dtype. On
    a CUDA tensor it launches the persistent kernel of
    `csrc/gpt2_megabatch.cu` (one kernel a step) and counts one launch in
    `gpt2_megabatch.launches` (full-precision weights)
    or `gpt2_megabatch.tiers["int8" | "int4"].launches`; on a CPU tensor it
    runs `gpt2_megabatch_plain`.
    """
    if k.device.type == "cpu":
        return gpt2_megabatch_plain(packed, k, v, lengths, x_emb, cfg=cfg)
    return launch_batch(GPT2BatchLauncher, gpt2_megabatch, packed, cfg, k, v,
                        lengths, x_emb), k, v


gpt2_megabatch.launches = 0
gpt2_megabatch.tiers = mk.tier_counts()


def llama_megabatch(packed: dict, k: torch.Tensor, v: torch.Tensor, lengths,
                    x_emb: torch.Tensor, *, cfg):
    """One decode step of B independent Llama/Qwen streams (greedy). Returns
    (tokens int32 [B], k, v).

    packed: ops.megakernel_llama.pack_llama_mega(params, cfg); k, v:
    [L, B, C, KW] panes; x_emb: [B, E] token embeddings; slot b's RoPE row is
    min(lengths[b], P - 1) of the packed tables. On a CUDA tensor it launches
    the Llama chain of `csrc/megabatch.cu` and counts one launch in
    `llama_megabatch.launches` or its weight tier's
    `llama_megabatch.tiers[...]`; on a CPU tensor it runs
    `llama_megabatch_plain`.
    """
    if k.device.type == "cpu":
        return llama_megabatch_plain(packed, k, v, lengths, x_emb, cfg=cfg)
    return launch_batch(LlamaBatchLauncher, llama_megabatch, packed, cfg, k, v,
                        lengths, x_emb), k, v


llama_megabatch.launches = 0
llama_megabatch.tiers = mk.tier_counts()
