"""Host-side plan of `csrc/gemm_rows_tc.cuh`, the tensor-core skinny GEMM
of the bf16 routes (#7 `pallas_linear` on two bf16 operands, the batched
verify's GEMVs): its tile shape, the K-split count of an [N, K] product and
the fp32 scratch its splits' partials take. The split count is a function
of (N, K) alone, never of the row count, so a row's sums are the same
whatever rows are launched beside it. The C side applies the same rule and
refuses scratch that is too small.
"""

from __future__ import annotations

import torch

BM, BK = 128, 64  # weight rows (outputs) a tile, inputs a stage
MAX_ROWS = 256  # input rows a launch (the int4 tier: 128)
COUNTERS = 256  # zeroed tile counters a launch is given (left zeroed)
_SPLIT_ITEMS, _MAX_SPLITS, _MIN_SPLIT_CHUNKS = 132, 4, 4


def split_count(N: int, K: int) -> int:
    """K-splits of an [N, K] product: for about 132 blocks (one an SM) over
    its tiles of 128 outputs, 1 from 67 tiles up, at most 4, each split at
    least 4 stages of 64 inputs."""
    tiles, chunks = -(-N // BM), -(-K // BK)
    return min(max(1, _SPLIT_ITEMS // tiles), _MAX_SPLITS, max(1, chunks // _MIN_SPLIT_CHUNKS))


def part_floats(N: int, K: int, rows: int) -> int:
    """fp32 scratch of one product over `rows` input rows (launched in
    groups of at most MAX_ROWS): [tile][split][rows][BM], or 0 unsplit."""
    s = split_count(N, K)
    return s * min(rows, MAX_ROWS) * -(-N // BM) * BM if s > 1 else 0


_counters: dict = {}


def tile_counters(device) -> torch.Tensor:
    """The zeroed tile counters of the standalone launches on `device`
    (#7's route, `verify_gemv`): zeroed once, left zeroed by every launch,
    shared by the launches of one stream. A batched verify launcher keeps
    its own."""
    if device not in _counters:
        _counters[device] = torch.zeros(COUNTERS, dtype=torch.int32, device=device)
    return _counters[device]
