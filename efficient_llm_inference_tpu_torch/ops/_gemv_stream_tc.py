"""Host-side plan of `csrc/gemv_stream_tc.cuh`, the persistent streaming
GEMV of the bf16 batched Llama/Qwen step (#15 `llama_megabatch`, #17
`llama_megabatch_quant`) on the tensor cores: its tiles, the K split of an
[N, K] weight, the ring's stages, the blocks an SM and the scratch the
splits take (partials and a counter a tile). The C side applies the same
rules (`stc::plan_of`) and refuses scratch that is too small.

A tile is 128 weight rows (one m16 tile a warp) by one K part. The split is
a function of (N, K) alone, never of the slot count B or of the card, so a
slot's sums are the same bits whatever slots run beside it and on whatever
card; B sets only how many slot rows are staged (8, 16 or 32) and so the
stages and blocks an SM.
"""

from __future__ import annotations

import torch

TILE_ROWS = 128  # weight rows a tile: 8 warps x one m16 tile
SEG = 32  # inputs of a segment: two k16 steps
STAGE_BYTES = 16 * 128  # a warp's stage: its 16 rows x 128 bytes
WARPS = 8
MAX_PART = 2048  # inputs a K part may stage (32 slots x 2048 x 2 bytes: 128 KB)
_SPLIT_ITEMS, _MAX_SPLITS, _MIN_PART_SEGS = 132, 32, 4
_BUDGET = {2: 110 * 1024, 1: 224 * 1024}  # dynamic shared memory a block, by blocks an SM
_MAX_STAGES = {2: 6, 1: 12}
_MIN_STAGES_2 = 4  # fewer at two blocks an SM: one block an SM and a deeper ring


def slot_rows(batch: int) -> int:
    """Slot rows staged (the MMAs' n8 tiles x 8): 8, 16 or 32."""
    if not 1 <= batch <= 32:
        raise ValueError(f"batch {batch}: the tensor-core GEMV takes 1..32 slots")
    return 8 if batch <= 8 else (16 if batch <= 16 else 32)


def split_count(N: int, K: int) -> int:
    """K parts of an [N, K] weight: for about 132 (tile, part) items, at
    most 32 parts, each at least 4 segments of 32 inputs, and enough parts
    that none stages more than MAX_PART inputs (64 segments: a thread of
    the block's 256 stages one 16-byte column)."""
    tiles, segs = -(-N // TILE_ROWS), -(-K // SEG)
    s = max(1, min(_SPLIT_ITEMS // tiles, _MAX_SPLITS, segs // _MIN_PART_SEGS))
    return max(s, -(-segs // (MAX_PART // SEG)))


def plan(N: int, K: int, batch: int, n_sm: int = 132, max_grid: int = 1 << 30) -> dict:
    """The launch of one GEMV of B = `batch` slots over an [N, K] weight
    (any tier: a stage is 2 KB of a warp's rows) on `n_sm` SMs, at most
    `max_grid` blocks (the LM head's argmax partials a slot): splits, tiles,
    the largest part in segments, the staged inputs' row stride (bytes;
    16-byte units = 4 mod 8 so a quarter warp's input reads fall in
    distinct banks), the stages of each warp's ring, blocks an SM (two
    while the staged rows leave 4 stages and the items fill two an SM,
    else one with a deeper ring), dynamic
    shared memory, the grid (`launch_nt`'s, where the occupancy reaches the
    blocks an SM: a multiple of the splits, so a block keeps one part) and
    the partials' floats (0 unsplit)."""
    S = split_count(N, K)
    tiles, segs = -(-N // TILE_ROWS), -(-K // SEG)
    part_segs = -(-segs // S)
    rs16 = 4 * part_segs
    rs16 += 4 if rs16 % 8 == 0 else 8
    rows = slot_rows(batch)
    in_bytes = rows * rs16 * 16
    ring_stage = WARPS * STAGE_BYTES
    stages = (_BUDGET[2] - in_bytes) // ring_stage
    items = tiles * S
    per_sm = 2
    if stages < _MIN_STAGES_2 or items < 2 * n_sm:
        per_sm, stages = 1, (_BUDGET[1] - in_bytes) // ring_stage
    stages = min(stages, _MAX_STAGES[per_sm])
    grid = min(n_sm * per_sm, items, max_grid)
    grid -= grid % S
    return {"splits": S, "tiles": tiles, "part_segs": part_segs, "row_stride": rs16 * 16,
            "stages": stages, "blocks_per_sm": per_sm,
            "smem": in_bytes + stages * ring_stage, "grid": grid,
            "part_floats": tiles * S * 256 * rows // 2 if S > 1 else 0}


def chain_gemvs(cfg) -> list:
    """(name, N, K) of the batched Llama/Qwen step's GEMVs."""
    E, I, D = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    QW, KW = cfg.n_head * D, cfg.n_kv_head * D
    return [("qkv", QW + 2 * KW, E), ("o", E, QW), ("gate_up", 2 * I, E), ("down", E, I),
            ("head", cfg.vocab_size, E)]


def scratch_sizes(cfg, batch: int) -> tuple:
    """(fp32 partials, tile counters) a launcher of `cfg` at `batch` slots
    allocates: `scratch_sizes_of` its chain's GEMVs."""
    return scratch_sizes_of([(N, K) for _, N, K in chain_gemvs(cfg)], batch)


def scratch_sizes_of(gemvs, batch: int) -> tuple:
    """(fp32 partials, tile counters) of the [N, K] weights `gemvs` at
    `batch` slots: the largest split GEMV's partials, a counter for each
    tile of the split GEMV with the most tiles (at least one of each)."""
    plans = [plan(N, K, batch) for N, K in gemvs]
    split = [p for p in plans if p["splits"] > 1]
    return (max([1] + [p["part_floats"] for p in split]),
            max([1] + [p["tiles"] for p in split]))


def part_bounds(N: int, K: int) -> list:
    """[k0, k1) of each K part, in part order: segments split as evenly as
    whole segments allow (the last part may run past K; the kernel
    zero-fills it)."""
    S, segs = split_count(N, K), -(-K // SEG)
    return [(p * segs // S * SEG, (p + 1) * segs // S * SEG) for p in range(S)]


def split_gemv_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The split-K sum of the kernel in plain PyTorch: y [B, N] = x [B, K] .
    w [N, K]^T as the fp32 partial of each K part (`part_bounds`), added in
    part order. No main path calls it: the CPU tests hold it against the
    one-pass product."""
    N, K = w.shape
    y = None
    for k0, k1 in part_bounds(N, K):
        part = x[:, k0:k1].float() @ w[:, k0:k1].float().t()
        y = part if y is None else y + part
    return y
