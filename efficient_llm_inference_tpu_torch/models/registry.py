"""Model registry: a uniform functional interface over model families
(port of efficient_llm_inference_tpu/models/registry.py, GPT-2 family)."""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable

from . import gpt2 as gpt2_mod


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    config: Any
    # forward(params, tokens, positions, cache, strategy, seq_mask)
    #   -> (logits fp32 [B,T,V], cache)
    forward: Callable
    vocab_size: int
    n_positions: int
    n_layer: int
    n_head: int
    head_dim: int
    n_kv_head: int  # == n_head for multi-head attention


def gpt2_spec(cfg: gpt2_mod.GPT2Config) -> ModelSpec:
    return ModelSpec(
        name="gpt2",
        config=cfg,
        forward=partial(_gpt2_forward, cfg),
        vocab_size=cfg.vocab_size,
        n_positions=cfg.n_positions,
        n_layer=cfg.n_layer,
        n_head=cfg.n_head,
        head_dim=cfg.head_dim,
        n_kv_head=cfg.n_head,
    )


def _gpt2_forward(cfg, params, tokens, positions, cache, strategy, seq_mask=None):
    return gpt2_mod.gpt2_forward(params, cfg, tokens, positions, cache, strategy,
                                 seq_mask)


GPT2_SIZES = {
    "gpt2": gpt2_mod.GPT2Config.small,
    "gpt2-medium": gpt2_mod.GPT2Config.medium,
    "gpt2-large": gpt2_mod.GPT2Config.large,
    "gpt2-tiny": gpt2_mod.GPT2Config.tiny,
}


def spec_by_name(name: str) -> ModelSpec:
    if name in GPT2_SIZES:
        return gpt2_spec(GPT2_SIZES[name]())
    if name.startswith(("llama", "qwen", "Qwen", "mixtral")):
        raise NotImplementedError(
            f"{name}: the Llama/Qwen/Mixtral families are not ported yet "
            "(ROADMAP.md, Queue 1 item 7)")
    raise ValueError(f"Unknown model: {name}")
