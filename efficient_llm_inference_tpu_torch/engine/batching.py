"""Serving requests (PyTorch port of efficient_llm_inference_tpu/engine/
batching.py: the `Request` record; `ContinuousBatchingEngine` and
`PoolConfig` are ROADMAP.md Queue 1 item 8)."""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class Request:
    """One request of a serving run: its prompt token ids and budget; the
    server appends the generated ids to `out_ids` and sets `done`."""

    rid: int
    prompt_ids: List[int]
    max_new_tokens: int
    out_ids: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
