"""Prefill and greedy decode loops (PyTorch port of
efficient_llm_inference_tpu/engine/generate.py, without the megakernel).

The decode loop is a Python loop over steps. Tokens stay on the device
between steps (argmax feeds the next embedding lookup), so a generation
synchronises with the host only when its caller reads the tokens.

Positional quirk kept for parity: the new token's position is the current
cache length.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..models.registry import ModelSpec


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Decode-time sampling. Only greedy decoding (temperature 0) is ported;
    sampled decoding is ROADMAP.md Queue 1 item 5's follow-up."""

    temperature: float = 0.0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def make_prefill(model: ModelSpec, strategy):
    """prefill(params, tokens [B, Tpad], true_len) -> (cache, last_logits [B, V])."""

    def prefill(params, tokens: torch.Tensor, true_len: int):
        B, Tpad = tokens.shape
        cache = strategy.init()
        idx = torch.arange(Tpad, device=tokens.device)
        pos = torch.clamp(idx, max=model.n_positions - 1).expand(B, Tpad)
        seq_mask = (idx < true_len).expand(B, Tpad)
        logits, cache = model.forward(params, tokens, pos, cache, strategy, seq_mask)
        cache = strategy.set_length(cache, true_len)
        return cache, logits[:, true_len - 1]

    return prefill


def make_decode(model: ModelSpec, strategy, max_new_tokens: int):
    """decode(params, cache, last_logits, forced=None)
    -> (tokens [B, N], cache, step_logits: N tensors [B, V]).

    Greedy argmax with a vocab clamp every step, no EOS check (as every
    cached path of the reference). step_logits[i] is the distribution that
    chose token i. With `forced` [B, N], token i is forced[:, i] instead of
    the argmax (teacher forcing), so two implementations can be compared
    step by step on the same sequence.
    """

    def decode(params, cache, last_logits, forced: Optional[torch.Tensor] = None):
        B = last_logits.shape[0]
        logits = last_logits
        toks: List[torch.Tensor] = []
        step_logits: List[torch.Tensor] = []
        for i in range(max_new_tokens):
            if forced is None:
                tok = torch.argmax(logits, dim=-1).clamp(0, model.vocab_size - 1)
            else:
                tok = forced[:, i].to(logits.device)
            toks.append(tok)
            step_logits.append(logits)
            pos = min(cache["length"], model.n_positions - 1)
            positions = torch.full((B, 1), pos, dtype=torch.long,
                                   device=logits.device)
            out, cache = model.forward(params, tok[:, None], positions, cache,
                                       strategy, None)
            cache = strategy.set_length(cache, cache["length"] + 1)
            logits = out[:, 0]
        return torch.stack(toks, dim=1), cache, step_logits

    return decode


def make_generate(model: ModelSpec, strategy, max_new_tokens: int):
    """generate(params, tokens, true_len, forced=None)
    -> (tokens [B, N], final cache length, step_logits)."""
    prefill = make_prefill(model, strategy)
    decode = make_decode(model, strategy, max_new_tokens)

    def generate(params, tokens, true_len: int, forced=None):
        cache, last = prefill(params, tokens, true_len)
        toks, cache, step_logits = decode(params, cache, last, forced)
        return toks, cache["length"], step_logits

    return generate


def bucket_for(
    length: int, buckets=(16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
) -> int:
    """Smallest bucket >= length: prompts pad to a few lengths, so cache
    capacities (and the shapes the kernels see) take few values."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]
