"""Batched speculative verify: R rows for each of B slots, one kernel chain.

Port of efficient_llm_inference_tpu/ops/pallas/megakernel_batch_verify.py
(`mega_batch_verify_supported`, `mega_batch_verify_quant_supported`,
`llama_mega_batch_verify_supported`, `llama_mega_batch_verify_quant_supported`,
`gpt2_megabatch_verify`, `gpt2_megabatch_verify_quant`,
`llama_megabatch_verify`, `llama_megabatch_verify_quant`; full-precision
weights and the int8 / grouped-int4 weight tiers). The TPU program
verifies every slot's R-row block on one weight pass; on the H100 the pass
is the verify chain of ops/megakernel.py's `gpt2_megaverify` with the slot
dimension of ops/megakernel_batch.py, `csrc/megabatch_verify.cu`: in bf16
every weight is read once for all B x R rows by the tensor cores
(`csrc/gemm_rows_tc.cuh`, the K split fixed by the weight's shape, so a
row's tokens do not depend on the slots beside it; `verify_gemv` runs one
such GEMV alone), in fp32 once per group of 8 rows on the CUDA cores; a
writer stores each slot's R new K/V rows at lengths[b] .. lengths[b] + R - 1
before attention, and attention runs one block per (query head, row, slot).
The continuous-batching server's speculative chunks
(engine/megaserver.py) launch it once a round.

Row (b, t) of x is slot b's t-th verify token at position lengths[b] + t
(GPT-2's position embedding, Llama's RoPE row: min(lengths[b] + t, P - 1)).
Per slot the pass equals R sequential steps of the single-stream plain step
at lengths[b] .. lengths[b] + R - 1, which is what the plain versions here
run:

* fp panes: the in-block rows j <= t are the model-dtype k/v (the JAX
  kernel's `kc16`);
* quantized panes: all R new rows are quantized on write; row t reads the
  in-block rows j < t back through their codes and scales and its own row
  j == t at full precision (JAX `megakernel_batch_verify.py:607-622`), so
  the result equals R sequential quantized steps, not a full-precision
  verify.

The JAX kernels' window rule is kept: slot b's block must fit the 16-row
window at floor8(lengths[b]), floor8(lengths[b]) + 16 <= capacity (the
server clamps its cursors to C - 8).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from . import _gemm_rows
from . import megakernel as mk
from . import megakernel_llama as ml
from . import megakernel_quant as mq
from .megakernel_batch_quant import _quant_kw

# B x R: the batched GEMV's largest row count (csrc/gemv_batch.cuh kMaxRows),
# the JAX server's largest wave (32 slots) times its largest verify (8 rows).
MAX_ROWS = 256


def _rows_ok(capacity: int, batch: int, rows: int) -> bool:
    """The JAX structure (1 <= R <= 8, capacity % 8 == 0, capacity >= 16,
    batch >= 1) and the kernel's B x R <= MAX_ROWS (the weight gates are
    the single-stream step's, `mk._weights_ok` / `ml._weights_ok`)."""
    return (1 <= rows <= mk.MAX_VERIFY_ROWS and capacity >= 16 and capacity % 8 == 0
            and batch >= 1 and batch * rows <= MAX_ROWS)


def mega_batch_verify_supported(cfg, capacity: int, params: dict, batch: int,
                                rows: int) -> bool:
    """The batched GPT-2 verify's eligibility: the JAX package's structure
    (uniform full-precision weights, E % 128, capacity % 8, capacity >= 16,
    1 <= rows <= 8, batch >= 1), the step kernels' limits (head_dim 64 or
    128, capacity <= 8192) and B x R <= MAX_ROWS. The VMEM envelope
    (`_pick_tps_batch_verify`) is a TPU limit and is not carried over."""
    return mk.mega_supported(cfg, capacity, params) and _rows_ok(capacity, batch, rows)


def mega_batch_verify_quant_supported(cfg, capacity: int, params: dict, batch: int,
                                      rows: int, kv_mode: str) -> bool:
    """As `mega_batch_verify_supported` over quantized panes: (E/2) % 128
    for an int4 pane, as in the JAX package (`mq.mega_quant_supported`)."""
    return (mq.mega_quant_supported(cfg, capacity, params, kv_mode)
            and _rows_ok(capacity, batch, rows))


def llama_mega_batch_verify_supported(cfg, capacity: int, params: dict, batch: int,
                                      rows: int) -> bool:
    """The batched Llama/Qwen verify's eligibility: the batched step's
    structure (`megakernel_llama.mega_supported`), 1 <= rows <= 8,
    capacity >= 16 and B x R <= MAX_ROWS. The TPU envelopes
    (`_llama_pick_tps_verify`) are not carried over."""
    return ml.mega_supported(cfg, capacity, params) and _rows_ok(capacity, batch, rows)


def llama_mega_batch_verify_quant_supported(cfg, capacity: int, params: dict, batch: int,
                                            rows: int, kv_mode: str) -> bool:
    """As `llama_mega_batch_verify_supported` over quantized panes whose
    widths are multiples of 128 lanes (`mq.llama_mega_quant_supported`)."""
    return (mq.llama_mega_quant_supported(cfg, capacity, params, kv_mode)
            and _rows_ok(capacity, batch, rows))


# ---------------------------------------------------------------------------
# Plain PyTorch versions (any device): per slot, R sequential plain steps on
# views of the [L, B, C, W] panes (so the new rows land in place).


def _slot_blocks(k, lengths, x):
    """(B, R, the slots' lengths as ints), after the window rule."""
    B = k.shape[1]
    if x.shape[0] % B:
        raise ValueError(f"{x.shape[0]} verify rows for {B} slots")
    R = x.shape[0] // B
    if not 1 <= R <= mk.MAX_VERIFY_ROWS:
        raise NotImplementedError(f"verify of {R} rows: the kernels take "
                                  f"1..{mk.MAX_VERIFY_ROWS}")
    curs = mk._length_tensor(lengths, "cpu").tolist()
    C = k.shape[2]
    for b, cur in enumerate(curs):
        if cur // 8 * 8 + 16 > C:
            raise ValueError(f"slot {b}: a verify block at length {cur} needs capacity "
                             f">= floor8({cur}) + 16, got {C}")
    return B, R, curs


def _verify_slots(step, rows_of, k, v, lengths, x, *scales):
    """Per slot b: `step(k_b, v_b, *scales_b, length, x_row)` at lengths[b] + t
    for its rows t (embedded by `rows_of(x_block, length)`). Returns (tokens
    int32 [B, R], fp32 logits [B, R, V])."""
    B, R, curs = _slot_blocks(k, lengths, x)
    toks, logits = [], []
    for b, cur in enumerate(curs):
        rows = rows_of(x[b * R:(b + 1) * R], cur)
        panes = (k[:, b], v[:, b], *(t[:, b] for t in scales))
        for t in range(R):
            out = step(*panes, cur + t, rows[t:t + 1])
            toks.append(out[0])
            logits.append(out[-1])
    return (torch.stack(toks).reshape(B, R),
            torch.stack(logits).reshape(B, R, -1))


def _gpt2_rows(packed, cfg):
    return lambda xb, cur: mk._verify_rows(packed, xb, cur, cfg.n_positions)


def _llama_rows(packed):
    return lambda xb, cur: xb if xb.is_floating_point() else packed["embed"][xb.long()]


def gpt2_megabatch_verify_plain(packed: dict, k, v, lengths, x, *, cfg,
                                return_logits: bool = False):
    """Plain PyTorch version of `gpt2_megabatch_verify`: returns (tokens
    int32 [B, R], k, v), slot b's rows lengths[b] .. lengths[b] + R - 1
    written in place; with `return_logits`, the fp32 logits [B, R, V] come
    fourth."""
    def step(kb, vb, cur, xr):
        return mk.gpt2_megastep_plain(packed, kb, vb, cur, xr, cfg=cfg, return_logits=True)

    toks, logits = _verify_slots(step, _gpt2_rows(packed, cfg), k, v, lengths, x)
    return (toks, k, v, logits) if return_logits else (toks, k, v)


def gpt2_megabatch_verify_quant_plain(packed: dict, k, v, ks, vs, lengths, x, *, cfg,
                                      kv_mode: str, eps: float = 1e-8,
                                      return_logits: bool = False):
    """Plain PyTorch version of `gpt2_megabatch_verify_quant`: R sequential
    plain quantized steps a slot. Returns (tokens int32 [B, R], k, v, ks,
    vs); with `return_logits`, the fp32 logits [B, R, V] come sixth."""
    def step(kb, vb, ksb, vsb, cur, xr):
        return mq.gpt2_megastep_quant_plain(packed, kb, vb, ksb, vsb, cur, xr, cfg=cfg,
                                            kv_mode=kv_mode, eps=eps, return_logits=True)

    toks, logits = _verify_slots(step, _gpt2_rows(packed, cfg), k, v, lengths, x, ks, vs)
    out = (toks, k, v, ks, vs)
    return out + (logits,) if return_logits else out


def llama_megabatch_verify_plain(packed: dict, k, v, lengths, x, *, cfg,
                                 return_logits: bool = False):
    """Plain PyTorch version of `llama_megabatch_verify` (as
    `gpt2_megabatch_verify_plain`; row t of slot b rotated at
    min(lengths[b] + t, P - 1))."""
    def step(kb, vb, cur, xr):
        return ml.llama_megastep_plain(packed, kb, vb, cur, xr, cfg=cfg, return_logits=True)

    toks, logits = _verify_slots(step, _llama_rows(packed), k, v, lengths, x)
    return (toks, k, v, logits) if return_logits else (toks, k, v)


def llama_megabatch_verify_quant_plain(packed: dict, k, v, ks, vs, lengths, x, *, cfg,
                                       kv_mode: str, eps: float = 1e-8,
                                       return_logits: bool = False):
    """Plain PyTorch version of `llama_megabatch_verify_quant` (as
    `gpt2_megabatch_verify_quant_plain`)."""
    def step(kb, vb, ksb, vsb, cur, xr):
        return mq.llama_megastep_quant_plain(packed, kb, vb, ksb, vsb, cur, xr, cfg=cfg,
                                             kv_mode=kv_mode, eps=eps, return_logits=True)

    toks, logits = _verify_slots(step, _llama_rows(packed), k, v, lengths, x, ks, vs)
    out = (toks, k, v, ks, vs)
    return out + (logits,) if return_logits else out


# ---------------------------------------------------------------------------
# The kernels: the single-stream launchers with a slot and a row dimension.


# The bf16 chain's tensor-core scratch, after the weight tier: the
# normalised rows, the split GEMVs' fp32 partials and their tile counters.
TC_FIELDS = [("xn", ctypes.c_void_p), ("tc_part", ctypes.c_void_p),
             ("tc_part_len", ctypes.c_longlong), ("tc_count", ctypes.c_void_p)]


class GPT2BatchVerifyArgs(ctypes.Structure):
    """Mirror of `struct Gpt2BatchVerifyArgs` in csrc/megabatch_verify.cu: B,
    R, then ops/megakernel.py's `MegaStepArgs`, then `TC_FIELDS`."""

    _fields_ = ([("batch", ctypes.c_int), ("rows", ctypes.c_int)] + mk.MegaStepArgs._fields_
                + TC_FIELDS)


class LlamaBatchVerifyArgs(ctypes.Structure):
    """Mirror of `struct LlamaBatchVerifyArgs` in csrc/megabatch_verify.cu:
    B, R, then ops/megakernel_llama.py's `LlamaStepArgs`, then `TC_FIELDS`."""

    _fields_ = ([("batch", ctypes.c_int), ("rows", ctypes.c_int)] + ml.LlamaStepArgs._fields_
                + TC_FIELDS)


_lib = None


def kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("megabatch_verify")
        for fn, args in ((lib.elit_gpt2_megabatch_verify, GPT2BatchVerifyArgs),
                         (lib.elit_gpt2_megabatch_verify_quant, GPT2BatchVerifyArgs),
                         (lib.elit_llama_megabatch_verify, LlamaBatchVerifyArgs),
                         (lib.elit_llama_megabatch_verify_quant, LlamaBatchVerifyArgs)):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(args), ctypes.c_void_p]
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.elit_verify_gemv.restype = i
        # w, ws, w_kind, group, N, K, R, x, part, part_len, counters, out, stream
        lib.elit_verify_gemv.argtypes = [p, p, i, i, i, i, i, p, p, ctypes.c_longlong, p, p, p]
        _lib = lib
    return _lib


def tc_scratch_floats(gemvs, rows: int) -> int:
    """fp32 partials the bf16 chain's split GEMVs take: the largest of
    `_gemm_rows.part_floats` over its [N, K] weights `gemvs` at `rows`."""
    return max(_gemm_rows.part_floats(N, K, rows) for N, K in gemvs)


class BatchVerifyLayout:
    """The batched verify launchers' layout: [L, B, C, W] panes, R rows a
    slot (B x R token rows), B lengths, (B, R) first in the args struct;
    in bf16 the tensor-core GEMVs' scratch (`TC_FIELDS`) last."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        a = self.args
        if a.dtype != mk._DTYPE_CODE[torch.bfloat16]:
            return
        rows = a.batch * a.rows
        dev = self.device
        n = tc_scratch_floats(self.gemvs(a), rows)
        xn = torch.empty(rows * a.n_embd, dtype=torch.bfloat16, device=dev)
        part = torch.empty(max(n, 1), dtype=torch.float32, device=dev)
        count = torch.zeros(_gemm_rows.COUNTERS, dtype=torch.int32, device=dev)
        self._refs = self._refs + (xn, part, count)
        a.xn, a.tc_part, a.tc_part_len, a.tc_count = (xn.data_ptr(), part.data_ptr(), n,
                                                      count.data_ptr())

    def layout(self, k, rows: Optional[int]) -> tuple:
        if k.dim() != 4:
            raise ValueError(f"k: {k.dim()}-d panes for a batched verify pass")
        B = k.shape[1]
        if rows is None or not 1 <= rows <= mk.MAX_VERIFY_ROWS or B * rows > MAX_ROWS:
            raise NotImplementedError(f"batched verify of {B} x {rows} rows: the kernels "
                                      f"take 1..{mk.MAX_VERIFY_ROWS} rows a slot and "
                                      f"{MAX_ROWS} in all")
        return B * rows, (B,), B, (B, rows)

    def library(self) -> ctypes.CDLL:
        return kernels()


class GPT2BatchVerifyLauncher(BatchVerifyLayout, mk.StepLauncher):
    """The prepared arguments of one batched GPT-2 verify pass."""

    entry = {False: "elit_gpt2_megabatch_verify", True: "elit_gpt2_megabatch_verify_quant"}
    args_type = GPT2BatchVerifyArgs

    @staticmethod
    def gemvs(a) -> list:
        """The chain's GEMV weights as [N, K]: qkv, out-proj, fc, fc-proj,
        the LM head."""
        E = a.n_embd
        return [(3 * E, E), (E, E), (4 * E, E), (E, 4 * E), (a.vocab, E)]


class LlamaBatchVerifyLauncher(BatchVerifyLayout, ml.LlamaStepLauncher):
    """The prepared arguments of one batched Llama/Qwen verify pass."""

    entry = {False: "elit_llama_megabatch_verify", True: "elit_llama_megabatch_verify_quant"}
    args_type = LlamaBatchVerifyArgs

    @staticmethod
    def gemvs(a) -> list:
        """The chain's GEMV weights as [N, K]: q|k|v, o, gate|up, down, the
        LM head."""
        E, QW, KW = a.n_embd, a.n_head * a.head_dim, a.n_kv_head * a.head_dim
        return [(QW + 2 * KW, E), (E, QW), (2 * a.inter, E), (E, a.inter), (a.vocab, E)]


def launch_batch_verify(launcher, counter, packed, cfg, k, v, lengths, x, **kw):
    """One batched verify launch on CUDA tensors; returns the tokens [B, R].
    `x`: [B x R, E] embeddings, or [B x R] integer token ids embedded on the
    device."""
    B = k.shape[1]
    if x.shape[0] % B:
        raise ValueError(f"{x.shape[0]} verify rows for {B} slots")
    R = x.shape[0] // B
    tok = torch.empty(B * R, dtype=torch.int32, device=k.device)
    rows = ({"x_emb": x.contiguous()} if x.is_floating_point()
            else {"tok_in": x.to(torch.int32).contiguous()})
    launcher(packed, cfg, k, v, mk._length_tensor(lengths, k.device), tok, rows=R,
             **rows, **kw).launch()
    mk.launch_counter(counter, packed).launches += 1
    return tok.reshape(B, R)


def gpt2_megabatch_verify(packed: dict, k, v, lengths, x, *, cfg):
    """Verify R <= 8 rows for each of B GPT-2 slots in one weight-streaming
    pass (greedy). Returns (tokens int32 [B, R], k, v).

    k, v: [L, B, C, E] panes in the model dtype; lengths: int32 [B] (tensor
    or ints); x: [B x R, E] token + position embeddings (slot-major: slot
    b's rows are x[b R : (b + 1) R], row t at wpe[min(lengths[b] + t,
    P - 1)]) in the model dtype, or [B x R] token ids embedded on the
    device. Slot b's row t is written to column lengths[b] + t of its panes
    (in place) and attends its columns < lengths[b] plus its rows j <= t;
    tokens[b, t] is its greedy argmax. packed: of full-precision or
    quantized weights. On a CUDA tensor it launches the GPT-2 chain of
    `csrc/megabatch_verify.cu` and counts one launch in
    `gpt2_megabatch_verify.launches` (full-precision weights) or
    `gpt2_megabatch_verify.tiers["int8" | "int4"].launches`; on a CPU tensor
    it runs `gpt2_megabatch_verify_plain`.
    """
    if k.device.type == "cpu":
        return gpt2_megabatch_verify_plain(packed, k, v, lengths, x, cfg=cfg)
    return launch_batch_verify(GPT2BatchVerifyLauncher, gpt2_megabatch_verify, packed, cfg,
                               k, v, lengths, x), k, v


gpt2_megabatch_verify.launches = 0
gpt2_megabatch_verify.tiers = mk.tier_counts()


def gpt2_megabatch_verify_quant(packed: dict, k, v, ks, vs, lengths, x, *, cfg,
                                kv_mode: str, eps: float = 1e-8):
    """`gpt2_megabatch_verify` over quantized panes (int8 [L, B, C, E] or
    half-split int4 [L, B, C, E/2], kinds from `kv_mode`; scales fp32
    [L, B, C]): the R new rows of every slot are quantized on write, the
    in-block rows j < t read back through their codes, row t's own at full
    precision. Returns (tokens int32 [B, R], k, v, ks, vs). On a CUDA tensor
    it launches `csrc/megabatch_verify.cu` and counts one launch in
    `gpt2_megabatch_verify_quant.launches` or its weight tier's
    `gpt2_megabatch_verify_quant.tiers[...]`; on a CPU tensor it runs
    `gpt2_megabatch_verify_quant_plain`.
    """
    if k.device.type == "cpu":
        return gpt2_megabatch_verify_quant_plain(packed, k, v, ks, vs, lengths, x, cfg=cfg,
                                                 kv_mode=kv_mode, eps=eps)
    tok = launch_batch_verify(GPT2BatchVerifyLauncher, gpt2_megabatch_verify_quant, packed,
                              cfg, k, v, lengths, x, **_quant_kw(ks, vs, kv_mode, eps))
    return tok, k, v, ks, vs


gpt2_megabatch_verify_quant.launches = 0
gpt2_megabatch_verify_quant.tiers = mk.tier_counts()


def llama_megabatch_verify(packed: dict, k, v, lengths, x, *, cfg):
    """Verify R <= 8 rows for each of B Llama/Qwen slots in one
    weight-streaming pass (greedy). Returns (tokens int32 [B, R], k, v).

    As `gpt2_megabatch_verify`: x is [B x R, E] token embeddings or [B x R]
    token ids; row t of slot b is rotated at min(lengths[b] + t, P - 1)
    from the packed RoPE tables (the JAX kernel takes the same rows as
    cos_q/sin_q inputs). k, v: [L, B, C, KW] panes. On a CUDA tensor it
    launches the Llama chain of `csrc/megabatch_verify.cu` and counts one
    launch in `llama_megabatch_verify.launches` or its weight tier's
    `llama_megabatch_verify.tiers[...]`; on a CPU tensor it runs
    `llama_megabatch_verify_plain`.
    """
    if k.device.type == "cpu":
        return llama_megabatch_verify_plain(packed, k, v, lengths, x, cfg=cfg)
    return launch_batch_verify(LlamaBatchVerifyLauncher, llama_megabatch_verify, packed,
                               cfg, k, v, lengths, x), k, v


llama_megabatch_verify.launches = 0
llama_megabatch_verify.tiers = mk.tier_counts()


def llama_megabatch_verify_quant(packed: dict, k, v, ks, vs, lengths, x, *, cfg,
                                 kv_mode: str, eps: float = 1e-8):
    """`llama_megabatch_verify` over quantized panes ([L, B, C, KW(/2)],
    scales [L, B, C]), as `gpt2_megabatch_verify_quant`. Returns (tokens
    int32 [B, R], k, v, ks, vs). On a CUDA tensor it launches
    `csrc/megabatch_verify.cu` and counts one launch in
    `llama_megabatch_verify_quant.launches` or its weight tier's
    `llama_megabatch_verify_quant.tiers[...]`; on a CPU tensor it runs
    `llama_megabatch_verify_quant_plain`.
    """
    if k.device.type == "cpu":
        return llama_megabatch_verify_quant_plain(packed, k, v, ks, vs, lengths, x, cfg=cfg,
                                                  kv_mode=kv_mode, eps=eps)
    tok = launch_batch_verify(LlamaBatchVerifyLauncher, llama_megabatch_verify_quant, packed,
                              cfg, k, v, lengths, x, **_quant_kw(ks, vs, kv_mode, eps))
    return tok, k, v, ks, vs


llama_megabatch_verify_quant.launches = 0
llama_megabatch_verify_quant.tiers = mk.tier_counts()


# ---------------------------------------------------------------------------
# One GEMV of the bf16 chain alone (measurement and the card's tests).


def _tier_of(w: torch.Tensor, scales) -> str:
    if w.dtype == torch.bfloat16:
        return "fp"
    if scales is None:
        raise ValueError("quantized rows need their scales")
    return "int8" if w.dtype == torch.int8 else "int4"


def verify_gemv_plain(x: torch.Tensor, w: torch.Tensor,
                      scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of `verify_gemv`: bf16(x @ W^T) with fp32 sums,
    W in its tier's arithmetic (ops/megakernel.py `wmv` for every row of x:
    int8 the row's fp32 sum times its scale, int4 each group's fp32 sum
    times its scale, summed)."""
    tier = _tier_of(w, scales)
    if tier == "fp":
        return (x.float() @ w.float().t()).to(torch.bfloat16)
    if tier == "int8":
        return ((x.float() @ w.float().t()) * scales.float()).to(torch.bfloat16)
    N, K = w.shape[0], 2 * w.shape[1]
    ng = scales.shape[-1]
    v = torch.stack(mk._unpack_nibbles(w), dim=-1).reshape(N, ng, K // ng).float()
    sums = torch.einsum("rgk,ngk->rng", x.float().reshape(-1, ng, K // ng), v)
    return (sums * scales.float()).sum(-1).to(torch.bfloat16)


def verify_gemv(x: torch.Tensor, w: torch.Tensor,
                scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One GEMV of the bf16 batched verify chain alone, on its tensor-core
    route: x [R, K] bf16 (1 <= R <= 256) times weight rows W [N, K] ->
    bf16 [R, N], no prologue or bias. W: bf16 [N, K], int8 codes [N, K] with
    fp32 row scales [N], or packed int4 rows uint8 [N, K/2] with bf16 scales
    [N, K/G]. On a CUDA tensor it launches `elit_verify_gemv` of
    `csrc/megabatch_verify.cu` and counts one launch in
    `verify_gemv.launches`; on a CPU tensor it runs `verify_gemv_plain`."""
    if x.device.type == "cpu":
        return verify_gemv_plain(x, w, scales)
    tier = _tier_of(w, scales)
    R, K = x.shape
    N = w.shape[0]
    group = K // scales.shape[-1] if tier == "int4" else 0
    if x.dtype != torch.bfloat16 or not 1 <= R <= MAX_ROWS or not x.is_contiguous() \
            or not w.is_contiguous() or (scales is not None and not scales.is_contiguous()):
        raise ValueError(f"verify_gemv: x {x.dtype} {tuple(x.shape)}: expected contiguous "
                         f"bf16 [1..{MAX_ROWS}, K] and contiguous weights")
    n = _gemm_rows.part_floats(N, K, R)
    part = torch.empty(max(n, 1), dtype=torch.float32, device=x.device)
    out = torch.empty((R, N), dtype=torch.bfloat16, device=x.device)
    lib = kernels()
    rc = lib.elit_verify_gemv(w.data_ptr(), None if scales is None else scales.data_ptr(),
                              mk.WEIGHT_CODE[tier], group, N, K, R, x.data_ptr(),
                              part.data_ptr(), n, _gemm_rows.tile_counters(x.device).data_ptr(),
                              out.data_ptr(),
                              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "verify_gemv")
    verify_gemv.launches += 1
    return out


verify_gemv.launches = 0
