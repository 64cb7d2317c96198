"""Model registry: a uniform functional interface over model families
(port of efficient_llm_inference_tpu/models/registry.py: the GPT-2 and
Llama/Qwen families)."""

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
    n_kv_head: int  # == n_head for multi-head attention; < n_head for GQA


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


def spec_with_config(spec: ModelSpec, cfg) -> ModelSpec:
    """Rebuild a spec after a dataclasses.replace on its model config (e.g.
    a truncated self-draft's n_layer)."""
    if spec.name == "gpt2":
        return gpt2_spec(cfg)
    if spec.name == "llama":
        from . import llama as llama_mod

        return llama_mod.llama_spec(cfg)
    raise ValueError(f"Unknown model family: {spec.name}")


def spec_by_name(name: str) -> ModelSpec:
    if name in GPT2_SIZES:
        return gpt2_spec(GPT2_SIZES[name]())
    if name.startswith("llama") or name.lower().startswith("qwen"):
        from . import llama as llama_mod

        return llama_mod.llama_spec(llama_mod.LlamaConfig.by_name(name))
    if name.startswith("mixtral"):
        raise NotImplementedError(
            f"{name}: the Mixtral family is not ported yet (ROADMAP.md, "
            "Queue 1 item 10)")
    raise ValueError(f"Unknown model: {name}")
