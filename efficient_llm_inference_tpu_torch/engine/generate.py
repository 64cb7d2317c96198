"""Prefill and greedy decode loops (PyTorch port of
efficient_llm_inference_tpu/engine/generate.py).

Two decode loops, as in the JAX package:

* the model's forward pass step by step (`make_decode`), a Python loop
  whose tokens stay on the device between steps (argmax feeds the next
  embedding lookup);
* the whole-step megakernel (`make_generate(..., mega=...)`, JAX
  `_mega_decode_body` / `_mega_quant_decode_body` and their Llama forms):
  after the prefill the cache converts once to the kernels' [L, C, W]
  panes, and each step is one launch of the model's kernel chain
  (ops/megakernel.py for GPT-2, ops/megakernel_llama.py for Llama/Qwen)
  that embeds the token (GPT-2 adds the position embedding of
  min(length, n_positions - 1); Llama reads the RoPE tables' row of that
  position), runs the step, clamps the token to [0, V-1] and increments
  `length`, all on the device. On a card the N steps
  are captured once per built configuration as a CUDA graph and replayed
  per generation (the port's counterpart of the JAX `jax.lax.scan` under
  `jax.jit`); on the CPU the steps run the plain versions in a loop.

Static-batch generation (`make_generate_batch`, JAX `make_generate_batch` /
`_make_generate_batch_quant`) runs B prompts together: one batched eager
prefill with per-row lengths, the panes converted once ([L, B, C, W], or
quantized by `quantize_panes_batch`), and N steps of the batched chains
(ops/megakernel_batch.py, ops/megakernel_batch_quant.py) replayed from one
CUDA graph per built configuration.

Either way a generation synchronises with the host only when its caller
reads the tokens. Positional quirk kept for parity: the new token's
position is the current cache length.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..models.registry import ModelSpec
from ..ops import megakernel_llama as ml
from ..ops import megakernel_quant as mq
from ..ops.megakernel import (
    MegaDecodeGraph,
    StepLauncher,
    gpt2_megastep,
    gpt2_megastep_plain,
    to_mega_layout,
)
from ..ops.megakernel_batch import (
    GPT2BatchLauncher,
    LlamaBatchLauncher,
    gpt2_megabatch,
    llama_megabatch,
    to_mega_layout_batch,
)
from ..ops.megakernel_batch_quant import (
    gpt2_megabatch_quant,
    llama_megabatch_quant,
    quantize_panes_batch,
)
from ..ops.megakernel_quant import _kv_kinds, to_mega_quant_layout


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Decode-time sampling. Only greedy decoding (temperature 0) is ported;
    sampled decoding is ROADMAP.md Queue 1 item 6."""

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


def make_generate(model: ModelSpec, strategy, max_new_tokens: int,
                  mega: Optional[dict] = None):
    """generate(params, tokens, true_len, forced=None)
    -> (tokens [B, N], final cache length, step_logits).

    With `mega` (engine._mega_spec / _mega_quant_spec: "packed" weights,
    "cfg", "capacity", the model "kind" ("gpt2" or "llama"), and "kv_mode" +
    "eps" for quantized panes) the decode
    runs the whole-step megakernel, which returns no logits: step_logits is
    empty and teacher forcing (`forced`) is refused.
    """
    prefill = make_prefill(model, strategy)
    if mega is not None:
        decode = _mega_decode(model, max_new_tokens, mega)

        def generate(params, tokens, true_len: int, forced=None):
            if forced is not None:
                raise ValueError("the megakernel decode takes no forced "
                                 "tokens; use the megakernel-off path")
            cache, last = prefill(params, tokens, true_len)
            toks = decode(params, cache, last)
            return toks[None, :], cache["length"] + max_new_tokens, []

        return generate

    decode = make_decode(model, strategy, max_new_tokens)

    def generate(params, tokens, true_len: int, forced=None):
        cache, last = prefill(params, tokens, true_len)
        toks, cache, step_logits = decode(params, cache, last, forced)
        return toks, cache["length"], step_logits

    return generate


def _mega_panes(cache: dict, kv_mode: Optional[str]) -> dict:
    """The prefill's cache in the kernels' layout: K/V panes converted, the
    per-token scale tables ([L, C]) as they are."""
    if not kv_mode:
        return {"k": to_mega_layout(cache["k"]), "v": to_mega_layout(cache["v"])}
    k_kind, v_kind = _kv_kinds(kv_mode)
    return {
        "k": to_mega_quant_layout(cache["k"], k_kind),
        "v": to_mega_quant_layout(cache["v"], v_kind),
        "ks": cache["k_scale"],
        "vs": cache["v_scale"],
    }


# Per model kind: the step's launcher, its fp and quantized-pane wrappers
# (each counts its launches) and their plain versions.
_MEGA_STEPS = {
    "gpt2": (StepLauncher, gpt2_megastep, mq.gpt2_megastep_quant,
             gpt2_megastep_plain, mq.gpt2_megastep_quant_plain),
    "llama": (ml.LlamaStepLauncher, ml.llama_megastep, mq.llama_megastep_quant,
              ml.llama_megastep_plain, mq.llama_megastep_quant_plain),
}


def _embed(model: ModelSpec, params: dict, tok: torch.Tensor, length: int):
    """[1, E] input of the plain step: GPT-2 adds the position embedding of
    min(length, n_positions - 1); Llama takes the token's row (its step
    applies RoPE at that position)."""
    if model.name == "llama":
        return params["embed"][tok.long()][None]
    wte, wpe = params["wte"], params["wpe"]
    pos = min(length, model.n_positions - 1)
    return (wte[tok.long()] + wpe[pos])[None].to(wte.dtype)


def _mega_decode(model: ModelSpec, max_new_tokens: int, mega: dict):
    """decode(params, cache, last_logits) -> tokens [N] over megakernel
    steps (greedy, batch 1). The tokens emitted are the prefill's argmax and
    the N - 1 that follow, as the JAX scan emits them; N steps run, so the
    cache ends at length + N."""
    cfg, packed = mega["cfg"], mega["packed"]
    kv_mode = mega.get("kv_mode")
    eps = mega.get("eps", 1e-8)
    V = model.vocab_size
    launcher, fp_step, quant_step, fp_plain, quant_plain = _MEGA_STEPS[mega["kind"]]
    graph = None  # the captured loop (the configuration's device is fixed)

    def step_plain(panes, length, x):
        if kv_mode:
            return quant_plain(packed, panes["k"], panes["v"], panes["ks"],
                               panes["vs"], length, x, cfg=cfg, kv_mode=kv_mode,
                               eps=eps)[0]
        return fp_plain(packed, panes["k"], panes["v"], length, x, cfg=cfg)[0]

    def decode(params, cache, last_logits):
        nonlocal graph
        tok0 = torch.argmax(last_logits[0]).clamp(0, V - 1).to(torch.int32)
        length = cache["length"]
        panes = _mega_panes(cache, kv_mode)
        if tok0.device.type == "cuda":
            if graph is None:
                k_kind, v_kind = _kv_kinds(kv_mode) if kv_mode else ("fp", "fp")
                static = {n: torch.empty_like(t) for n, t in panes.items()}
                graph = MegaDecodeGraph(
                    packed, cfg, max_new_tokens, static,
                    quant_step if kv_mode else fp_step, launcher=launcher,
                    k_kind=k_kind, v_kind=v_kind, quant_eps=eps)
            for name, t in panes.items():
                graph.panes[name].copy_(t)
            return graph.run(tok0, length)[:, 0].clone()
        toks, tok = [], tok0
        for _ in range(max_new_tokens):
            toks.append(tok)
            tok = step_plain(panes, length, _embed(model, params, tok, length))
            tok = tok.clamp(0, V - 1)
            length += 1
        return torch.stack(toks)

    return decode


def prefill_batch(model: ModelSpec, strategy, params: dict, tokens: torch.Tensor,
                  lens: torch.Tensor):
    """One right-padded batched prefill: tokens [B, Tpad] with per-row
    lengths lens (int64 [B], on the tokens' device) through one forward pass
    with a per-row `seq_mask` into `strategy` (a DenseKV of batch B).
    Returns (cache, each row's first token: the argmax of its logits at
    lens[b] - 1, clamped to [0, V-1], int32 [B])."""
    B, Tpad = tokens.shape
    dev = tokens.device
    idx = torch.arange(Tpad, device=dev)
    pos = torch.clamp(idx, max=model.n_positions - 1).expand(B, Tpad)
    seq_mask = idx[None, :] < lens[:, None]
    logits, cache = model.forward(params, tokens, pos, strategy.init(), strategy, seq_mask)
    last = logits[torch.arange(B, device=dev), lens - 1]  # [B, V]
    return cache, torch.argmax(last, dim=-1).clamp(0, model.vocab_size - 1).to(torch.int32)


# Per model kind: the batched step's launcher and its fp and quantized-pane
# wrappers (each counts its launches; on the CPU each runs its plain version).
_BATCH_STEPS = {
    "gpt2": (GPT2BatchLauncher, gpt2_megabatch, gpt2_megabatch_quant),
    "llama": (LlamaBatchLauncher, llama_megabatch, llama_megabatch_quant),
}


def make_generate_batch(model: ModelSpec, strategy, max_new_tokens: int,
                        mega: dict):
    """generate(params, tokens [B, Tpad], true_lens [B]) -> (tokens [B, N],
    final lengths [B]): B prompts decoded together, greedy.

    `strategy` is a DenseKV of batch B at `mega["capacity"]` (engine
    `_mega_batch_spec`: "packed", "cfg", "capacity", "kind", and "kv_mode"
    for quantized panes, whose scales take eps = mega.get("eps", 1e-8), as
    the JAX engine's). The prefill is one batched forward pass
    with a per-row `seq_mask`; row b's first token is the argmax of its
    logits at true_lens[b] - 1. The panes convert once; each of the N steps
    embeds every slot's token at its own position, runs the batched chain,
    clamps the tokens to [0, V-1] and increments every slot's length on the
    device.
    """
    cfg, packed = mega["cfg"], mega["packed"]
    kv_mode = mega.get("kv_mode")
    eps = mega.get("eps", 1e-8)
    V, P = model.vocab_size, model.n_positions
    launcher, fp_step, quant_step = _BATCH_STEPS[mega["kind"]]
    graph = None  # the captured loop (the configuration's device is fixed)

    def embed(params, toks, lengths):  # [B] tokens and lengths -> [B, E]
        if model.name == "llama":
            return params["embed"][toks.long()]
        wte, wpe = params["wte"], params["wpe"]
        return (wte[toks.long()] + wpe[lengths.clamp(max=P - 1).long()]).to(wte.dtype)

    def step(panes, lengths, x):
        if kv_mode:
            return quant_step(packed, panes["k"], panes["v"], panes["ks"], panes["vs"],
                              lengths, x, cfg=cfg, kv_mode=kv_mode, eps=eps)[0]
        return fp_step(packed, panes["k"], panes["v"], lengths, x, cfg=cfg)[0]

    def generate(params, tokens: torch.Tensor, true_lens):
        nonlocal graph
        dev = tokens.device
        lens = torch.as_tensor(true_lens, dtype=torch.long).to(dev)
        cache, tok0 = prefill_batch(model, strategy, params, tokens, lens)
        kb, vb = to_mega_layout_batch(cache["k"]), to_mega_layout_batch(cache["v"])
        if kv_mode:
            panes = dict(zip(("k", "v", "ks", "vs"),
                             quantize_panes_batch(kb, vb, kv_mode, eps)))
        else:
            panes = {"k": kb, "v": vb}
        lengths = lens.to(torch.int32)
        if dev.type == "cuda":
            if graph is None:
                k_kind, v_kind = _kv_kinds(kv_mode) if kv_mode else ("fp", "fp")
                static = {n: torch.empty_like(t) for n, t in panes.items()}
                graph = MegaDecodeGraph(
                    packed, cfg, max_new_tokens, static,
                    quant_step if kv_mode else fp_step, launcher=launcher,
                    k_kind=k_kind, v_kind=v_kind, quant_eps=eps)
            for name, t in panes.items():
                graph.panes[name].copy_(t)
            toks = graph.run(tok0, lengths).t().clone()
            return toks, lengths + max_new_tokens
        toks, tok = [], tok0
        for _ in range(max_new_tokens):
            toks.append(tok)
            tok = step(panes, lengths, embed(params, tok, lengths)).clamp(0, V - 1)
            lengths = lengths + 1
        return torch.stack(toks, dim=1), lengths

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
