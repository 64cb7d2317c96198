"""Batched whole-step decode over QUANTIZED KV panes.

Port of efficient_llm_inference_tpu/ops/pallas/megakernel_batch_quant.py
(`_quant_pane_tokens`, `quantize_panes_batch`, `mega_batch_quant_supported`,
`llama_mega_batch_quant_supported`, `gpt2_megabatch_quant`,
`llama_megabatch_quant`; every weight tier): the batched chains of
ops/megakernel_batch.py over int8, half-split int4 or mixed (K int8, V int4)
panes [L, B, C, W(/2)] with per-(slot, token) fp32 scales [L, B, C]. Per
slot the step is the single-stream quantized step (ops/megakernel_quant.py):
past rows scored as (q . codes) * k_scale, the probabilities times the V
scales rounded to the model dtype before the PV product, the current token
full-precision in the same softmax, and slot b's new K/V rows quantized on
write at column lengths[b].

`quantize_panes_batch` converts the dense prefill panes once per generation
(plain PyTorch: XLA code outside any Pallas kernel in the JAX package), with
the jitted JAX scale math bit for bit: scale = max(max|x| * f32(1/qmax), eps)
per (slot, token) row, codes = clip(round_half_even(x / scale)).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import megakernel as mk
from . import megakernel_quant as mq
from .megakernel_batch import (
    GPT2BatchLauncher,
    LlamaBatchLauncher,
    _batch_ok,
    _per_slot,
    launch_batch,
    smem_fits,
)
from .quantize import scale_rows


def _quant_pane_tokens(x: torch.Tensor, kind: str, eps: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[L, B, C, W] model-dtype pane -> (codes int8 [L, B, C, W] for int8 or
    half-split bytes [L, B, C, W/2] for int4, scales fp32 [L, B, C])."""
    qmax, lo = (127.0, -127.0) if kind == "int8" else (7.0, -8.0)
    x32, s = scale_rows(x, qmax, eps)
    q = torch.clamp(torch.round(x32 / s), lo, qmax)
    codes = q.to(torch.int8) if kind == "int8" else mq.pack_halves(q)
    return codes, s[..., 0]


def quantize_panes_batch(kb: torch.Tensor, vb: torch.Tensor, kv_mode: str,
                         eps: float = 1e-8):
    """Dense [L, B, C, W] K/V panes -> (k codes, v codes, ks [L, B, C],
    vs [L, B, C]), the kinds from `kv_mode`."""
    k_kind, v_kind = mq._kv_kinds(kv_mode)
    k8, ks = _quant_pane_tokens(kb, k_kind, eps)
    v8, vs = _quant_pane_tokens(vb, v_kind, eps)
    return k8, v8, ks, vs


def mega_batch_quant_supported(cfg, capacity: int, params: dict, batch: int,
                               kv_mode: str) -> bool:
    """The batched quantized-pane GPT-2 step's eligibility: the JAX
    package's structure (`megakernel_quant.mega_quant_supported`: uniform
    full-precision weights, E % 128, capacity % 8, (E/2) % 128 for an int4
    pane), batch >= 1, and the kernel's limits (batch <= MAX_BATCH, and
    the shared memory of `smem_fits`, which the pane kind does not
    change). The VMEM budget (`_pick_tps_batch_quant`) is not carried over.
    The weight gates are the single-stream step's."""
    return (mq.mega_quant_supported(cfg, capacity, params, kv_mode) and _batch_ok(batch)
            and smem_fits(cfg, capacity, params, batch))


def llama_mega_batch_quant_supported(cfg, capacity: int, params: dict, batch: int,
                                     kv_mode: str) -> bool:
    """The batched quantized-pane Llama/Qwen step's eligibility: the
    single-stream one (`megakernel_quant.llama_mega_quant_supported`: the fp
    step's structure and 128-lane pane widths), batch >= 1, and
    batch <= MAX_BATCH. The TPU memory envelopes are not carried over."""
    return (mq.llama_mega_quant_supported(cfg, capacity, params, kv_mode)
            and _batch_ok(batch))


def gpt2_megabatch_quant_plain(packed: dict, k, v, ks, vs, lengths, x_emb, *, cfg,
                               kv_mode: str, eps: float = 1e-8,
                               return_logits: bool = False):
    """Plain PyTorch version of `gpt2_megabatch_quant`: the single-stream
    plain step slot by slot. Returns (tokens int32 [B], k, v, ks, vs); with
    `return_logits`, the fp32 logits [B, V] come sixth."""
    def step(kb, vb, ksb, vsb, cur, x):
        return mq.gpt2_megastep_quant_plain(packed, kb, vb, ksb, vsb, cur, x, cfg=cfg,
                                            kv_mode=kv_mode, eps=eps, return_logits=True)

    toks, logits = _per_slot(step, k, v, lengths, x_emb, ks, vs)
    out = (toks, k, v, ks, vs)
    return out + (logits,) if return_logits else out


def llama_megabatch_quant_plain(packed: dict, k, v, ks, vs, lengths, x_emb, *, cfg,
                                kv_mode: str, eps: float = 1e-8,
                                return_logits: bool = False):
    """Plain PyTorch version of `llama_megabatch_quant` (as
    `gpt2_megabatch_quant_plain`)."""
    def step(kb, vb, ksb, vsb, cur, x):
        return mq.llama_megastep_quant_plain(packed, kb, vb, ksb, vsb, cur, x, cfg=cfg,
                                             kv_mode=kv_mode, eps=eps, return_logits=True)

    toks, logits = _per_slot(step, k, v, lengths, x_emb, ks, vs)
    out = (toks, k, v, ks, vs)
    return out + (logits,) if return_logits else out


def _quant_kw(ks, vs, kv_mode: str, eps: float) -> dict:
    k_kind, v_kind = mq._kv_kinds(kv_mode)
    return dict(ks=ks, vs=vs, k_kind=k_kind, v_kind=v_kind, quant_eps=eps)


def gpt2_megabatch_quant(packed: dict, k, v, ks, vs, lengths, x_emb, *, cfg,
                         kv_mode: str, eps: float = 1e-8):
    """One decode step of B independent GPT-2 streams over quantized panes.
    Returns (tokens int32 [B], k, v, ks, vs).

    k, v: int8 [L, B, C, E] or half-split int4 [L, B, C, E/2] panes (kinds
    from `kv_mode`); ks, vs: fp32 [L, B, C]; slot b's row lengths[b] is
    quantized and written in place. On a CUDA tensor it launches the
    persistent kernel of `csrc/gpt2_megabatch.cu` and counts one launch in
    `gpt2_megabatch_quant.launches` or its weight tier's
    `gpt2_megabatch_quant.tiers[...]`; on a CPU tensor it runs
    `gpt2_megabatch_quant_plain`.
    """
    if k.device.type == "cpu":
        return gpt2_megabatch_quant_plain(packed, k, v, ks, vs, lengths, x_emb,
                                          cfg=cfg, kv_mode=kv_mode, eps=eps)
    tok = launch_batch(GPT2BatchLauncher, gpt2_megabatch_quant, packed, cfg, k, v,
                       lengths, x_emb, **_quant_kw(ks, vs, kv_mode, eps))
    return tok, k, v, ks, vs


gpt2_megabatch_quant.launches = 0
gpt2_megabatch_quant.tiers = mk.tier_counts()


def llama_megabatch_quant(packed: dict, k, v, ks, vs, lengths, x_emb, *, cfg,
                          kv_mode: str, eps: float = 1e-8):
    """One decode step of B independent Llama/Qwen streams over quantized
    panes ([L, B, C, KW(/2)], scales [L, B, C]). Returns (tokens int32 [B],
    k, v, ks, vs). On a CUDA tensor it launches the Llama chain of
    `csrc/megabatch.cu` and counts one launch in
    `llama_megabatch_quant.launches` or its weight tier's
    `llama_megabatch_quant.tiers[...]`; on a CPU tensor it runs
    `llama_megabatch_quant_plain`.
    """
    if k.device.type == "cpu":
        return llama_megabatch_quant_plain(packed, k, v, ks, vs, lengths, x_emb,
                                           cfg=cfg, kv_mode=kv_mode, eps=eps)
    tok = launch_batch(LlamaBatchLauncher, llama_megabatch_quant, packed, cfg, k, v,
                       lengths, x_emb, **_quant_kw(ks, vs, kv_mode, eps))
    return tok, k, v, ks, vs


llama_megabatch_quant.launches = 0
llama_megabatch_quant.tiers = mk.tier_counts()
