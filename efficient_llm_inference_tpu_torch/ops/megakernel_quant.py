"""Whole-step GPT-2 and Llama/Qwen decode over QUANTIZED KV panes.

Port of efficient_llm_inference_tpu/ops/pallas/megakernel_quant.py
(gpt2_megastep_quant, llama_megastep_quant, _kv_kinds, unpack_halves,
to_mega_quant_layout, mega_quant_supported, llama_mega_quant_supported).
Each step is its model's kernel chain (ops/megakernel.py,
ops/megakernel_llama.py) with int8, packed-int4 or mixed (K int8, V int4)
panes and per-token fp32 scales [L, C]: the attention kernel reads the codes
at their stored size and folds the scales into the scores and the
probabilities, and the new token's K/V rows are quantized on write.

* int4 panes use the JAX kernel's HALF-SPLIT pairing: pane byte j of a row
  packs lane j (high nibble, two's complement) with lane j + W/2 (low
  nibble, biased +8; W = E for GPT-2, n_kv_head * head_dim for Llama), stored as int8 = 16 * q_hi + q_lo + 8. This is not the
  even/odd-in-D layout of QuantizedKV; `to_mega_quant_layout` repacks once
  per generation and preserves every value.
* Quantize-on-write is the reference math exactly: scale =
  max(max|x| * f32(1/qmax), eps) in fp32 (the form XLA compiles the JAX
  division to), codes = clip(round_half_even(x / scale)).
* As in the JAX kernel, past rows are scored as (u . codes) * k_scale and
  the probabilities are multiplied by the V scales and rounded to the model
  dtype before the PV product (exact in fp32); the current token stays
  full-precision and merges into the same softmax.
* The weights may be quantized too (the JAX kernels' "wscale" /
  "w4scale" modes, `Config.weight_quant`): the steps take the packed
  dict's weight tier as ops/megakernel.py describes it, and count those
  launches in `<wrapper>.tiers["int8" | "int4"]`.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from . import megakernel_llama as ml
from .megakernel import (
    NEG_INF,
    StepLauncher,
    _length_tensor,
    launch_counter,
    mega_supported,
    plain_step,
    tier_counts,
)
from .quantization import unpack_int4
from .quantize import quantize_int8_rows_plain, scale_rows


def _kv_kinds(kv_mode: str) -> Tuple[str, str]:
    """(k_kind, v_kind), as QuantizedKV stores them."""
    if kv_mode not in ("int8", "int4", "mixed"):
        raise ValueError(f"kv_mode {kv_mode!r}")
    k_kind = "int8" if kv_mode in ("int8", "mixed") else "int4"
    v_kind = "int8" if kv_mode == "int8" else "int4"
    return k_kind, v_kind


def _pane_width(kind: str, E: int) -> int:
    return E if kind == "int8" else E // 2


def unpack_halves(pk: torch.Tensor, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Half-split pane byte (int8) = 16*q_hi + (q_lo + 8) -> (q_hi, q_lo)
    values in `dtype`; the byte's own sign extends the high nibble."""
    lo_b = torch.bitwise_and(pk, 0xF).to(dtype)  # q_lo + 8, exact
    hi = (pk.to(dtype) - lo_b) * 0.0625  # q_hi, exact
    return hi, lo_b - 8.0


def pack_halves(q: torch.Tensor) -> torch.Tensor:
    """Int values [..., E] in [-8, 7] -> half-split bytes [..., E/2] int8."""
    E = q.shape[-1]
    hi = q[..., :E // 2].to(torch.int32)
    lo = q[..., E // 2:].to(torch.int32)
    return (16 * hi + lo + 8).to(torch.int8)


def to_mega_quant_layout(buf: torch.Tensor, kind: str) -> torch.Tensor:
    """QuantizedKV buffer [L, 1, H, C, D(/2)] -> kernel pane (a copy):
    int8 [L, C, E], or int4 repacked to half-split [L, C, E/2] int8."""
    L, B, H, C, Dp = buf.shape
    if B != 1:
        raise ValueError("the megakernel is single-stream (batch 1)")
    if kind == "int8":
        return buf[:, 0].permute(0, 2, 1, 3).reshape(L, C, H * Dp)
    q = unpack_int4(buf)  # [L, 1, H, C, D] int8 in [-8, 7]
    q = q[:, 0].permute(0, 2, 1, 3).reshape(L, C, H * q.shape[-1])
    return pack_halves(q)


def mega_quant_supported(cfg, capacity: int, params: dict, kv_mode: str) -> bool:
    """Engine-side eligibility (per_token scales only): the JAX package's
    (the weight gates and geometry of `ops.megakernel.mega_supported`, and
    (E/2) % 128 == 0 when a pane is int4) plus the kernels' limits there.
    The VMEM budget is not carried over."""
    if not mega_supported(cfg, capacity, params):
        return False
    k_kind, v_kind = _kv_kinds(kv_mode)
    return "int4" not in (k_kind, v_kind) or (cfg.n_embd // 2) % 128 == 0


def quantize_row(x: torch.Tensor, kind: str, eps: float):
    """One token's [E] row (model dtype) -> (pane row, fp32 scale []):
    int8 codes [E], or half-split int4 bytes [E/2]; the rows kernels' math
    (ops/quantize.py), with the kernel pane's int4 pairing."""
    if kind == "int8":
        q, s = quantize_int8_rows_plain(x[None], eps)
        return q[0], s[0, 0]
    x32, s = scale_rows(x[None], 7.0, eps)
    return pack_halves(torch.clamp(torch.round(x32 / s), -8, 7)[0]), s[0, 0]


def pane_values(pane: torch.Tensor, kind: str) -> torch.Tensor:
    """Kernel pane -> its int values as fp32 [..., E]."""
    if kind == "int8":
        return pane.float()
    hi, lo = unpack_halves(pane, torch.float32)
    return torch.cat([hi, lo], dim=-1)


def attend_quant_plain(q, kc, vc, k_l, v_l, ks_l, vs_l, length: int,
                       n_kv_head: int, k_kind: str, v_kind: str):
    """Decode attention of one layer over quantized panes, in fp32: the
    query heads q [Hq*D] (grouped onto n_kv_head K/V heads) over the rows
    t < length of the panes k_l/v_l with their per-token scales ks_l/vs_l
    [C], and the current token's full-precision kc/vc [Hkv*D] merged into
    the same softmax. The probabilities times the V scales round to q's
    dtype before the PV product, as the kernels' PV inputs do. Returns
    [Hq*D] fp32."""
    C = k_l.shape[0]
    G, D = q.numel() // kc.numel(), kc.numel() // n_kv_head
    scale = 1.0 / math.sqrt(D)
    u = q.float().reshape(n_kv_head, G, D)
    visible = torch.arange(C, device=k_l.device) < length
    kval = pane_values(k_l, k_kind).reshape(C, n_kv_head, D)
    raw = torch.einsum("kgd,ckd->kgc", u, kval)
    st = torch.where(visible, raw * ks_l * scale, NEG_INF)
    s_cur = (u * kc.float().reshape(n_kv_head, 1, D)).sum(-1, keepdim=True) * scale
    mx = torch.maximum(st.amax(-1, keepdim=True), s_cur)
    p = torch.exp(st - mx)
    p_cur = torch.exp(s_cur - mx)
    denom = p.sum(-1, keepdim=True) + p_cur
    ps = (p * vs_l).to(q.dtype).float()  # the PV product's input dtype
    vval = pane_values(v_l, v_kind).reshape(C, n_kv_head, D)
    num = torch.einsum("kgc,ckd->kgd", ps, vval)
    num = num + p_cur * vc.float().reshape(n_kv_head, 1, D)
    return (num / denom).reshape(-1)


def write_quant_rows(k, v, ks, vs, length: int, new_k, new_v, kv_mode: str,
                     eps: float) -> None:
    """Quantize-on-write of the new K/V rows [L, W] into row `length` of
    every layer's panes and scales (nothing when length >= C)."""
    if length >= k.shape[1]:
        return
    k_kind, v_kind = _kv_kinds(kv_mode)
    for layer in range(k.shape[0]):
        k[layer, length], ks[layer, length] = quantize_row(new_k[layer], k_kind, eps)
        v[layer, length], vs[layer, length] = quantize_row(new_v[layer], v_kind, eps)


def gpt2_megastep_quant_plain(packed: dict, k, v, ks, vs, length, x_emb, *,
                              cfg, kv_mode: str, eps: float = 1e-8,
                              return_logits: bool = False):
    """Plain PyTorch version of `gpt2_megastep_quant`, the same function on
    any device: returns (token int32 [], k, v, ks, vs) with row `length` of
    every layer's panes and scales written in place; with `return_logits`
    the fp32 logits [V] come sixth."""
    k_kind, v_kind = _kv_kinds(kv_mode)
    cur = int(length)

    def attend(layer, q, kc, vc):
        return attend_quant_plain(q, kc, vc, k[layer], v[layer], ks[layer],
                                  vs[layer], cur, cfg.n_head, k_kind, v_kind)

    logits, new_k, new_v = plain_step(packed, cfg, x_emb, attend)
    write_quant_rows(k, v, ks, vs, cur, new_k, new_v, kv_mode, eps)
    tok = torch.argmax(logits).to(torch.int32)
    out = (tok, k, v, ks, vs)
    return out + (logits,) if return_logits else out


def gpt2_megastep_quant(packed: dict, k, v, ks, vs, length, x_emb, *, cfg,
                        kv_mode: str, eps: float = 1e-8):
    """One whole decode step over quantized KV panes. Returns (token int32
    [], k, v, ks, vs).

    k, v: int8 [L, C, E] or half-split int4 [L, C, E/2] panes (kinds from
    `kv_mode`); ks, vs: fp32 [L, C] per-token scales. Row `length` of every
    layer is quantized and written in place (the JAX kernel aliases them the
    same way). On a CUDA tensor it launches the persistent kernel of
    `csrc/gpt2_megastep.cu` (one kernel a step) and counts one launch in
    `gpt2_megastep_quant.launches` (or, over quantized weights, its tier's
    `gpt2_megastep_quant.tiers[...]`); on a CPU tensor it runs
    `gpt2_megastep_quant_plain`.
    """
    if k.device.type == "cpu":
        return gpt2_megastep_quant_plain(packed, k, v, ks, vs, length, x_emb,
                                         cfg=cfg, kv_mode=kv_mode, eps=eps)
    k_kind, v_kind = _kv_kinds(kv_mode)
    tok = torch.empty(1, dtype=torch.int32, device=k.device)
    StepLauncher(packed, cfg, k, v, _length_tensor(length, k.device), tok,
                 x_emb=x_emb.contiguous(), ks=ks, vs=vs, k_kind=k_kind,
                 v_kind=v_kind, quant_eps=eps).launch()
    launch_counter(gpt2_megastep_quant, packed).launches += 1
    return tok[0], k, v, ks, vs


gpt2_megastep_quant.launches = 0
gpt2_megastep_quant.tiers = tier_counts()


def llama_mega_quant_supported(cfg, capacity: int, params: dict, kv_mode: str) -> bool:
    """Engine-side eligibility of the Llama quantized-KV step (per_token
    scales only): the fp step's (`megakernel_llama.mega_supported`) and
    128-lane pane widths (KW, or KW / 2 for an int4 pane), as in the JAX
    package, whose VMEM envelope is not carried over."""
    if not ml.mega_supported(cfg, capacity, params):
        return False
    KW = cfg.n_kv_head * cfg.head_dim
    return all(_pane_width(kind, KW) % 128 == 0 for kind in _kv_kinds(kv_mode))


def llama_megastep_quant_plain(packed: dict, k, v, ks, vs, length, x_emb, *,
                               cfg, kv_mode: str, eps: float = 1e-8,
                               return_logits: bool = False):
    """Plain PyTorch version of `llama_megastep_quant`, the same function on
    any device: returns (token int32 [], k, v, ks, vs) with row `length` of
    every layer's panes and scales written in place; with `return_logits`
    the fp32 logits [V] come sixth."""
    k_kind, v_kind = _kv_kinds(kv_mode)
    cur = int(length)

    def attend(layer, q, kc, vc):
        return attend_quant_plain(q, kc, vc, k[layer], v[layer], ks[layer],
                                  vs[layer], cur, cfg.n_kv_head, k_kind, v_kind)

    logits, new_k, new_v = ml.llama_plain_step(packed, cfg, x_emb,
                                               ml.rope_position(cur, cfg), attend)
    write_quant_rows(k, v, ks, vs, cur, new_k, new_v, kv_mode, eps)
    tok = torch.argmax(logits).to(torch.int32)
    out = (tok, k, v, ks, vs)
    return out + (logits,) if return_logits else out


def llama_megastep_quant(packed: dict, k, v, ks, vs, length, x_emb, *, cfg,
                         kv_mode: str, eps: float = 1e-8):
    """One whole Llama/Qwen decode step over quantized KV panes. Returns
    (token int32 [], k, v, ks, vs).

    k, v: int8 [L, C, KW] or half-split int4 [L, C, KW/2] panes (kinds from
    `kv_mode`); ks, vs: fp32 [L, C] per-token scales. Row `length` of every
    layer is quantized and written in place. On a CUDA tensor it launches
    the kernel chain of `csrc/llama_megastep.cu` and counts one launch in
    `llama_megastep_quant.launches` (or its weight tier's
    `llama_megastep_quant.tiers[...]`); on a CPU tensor it runs
    `llama_megastep_quant_plain`.
    """
    if k.device.type == "cpu":
        return llama_megastep_quant_plain(packed, k, v, ks, vs, length, x_emb,
                                          cfg=cfg, kv_mode=kv_mode, eps=eps)
    k_kind, v_kind = _kv_kinds(kv_mode)
    tok = torch.empty(1, dtype=torch.int32, device=k.device)
    ml.LlamaStepLauncher(packed, cfg, k, v, _length_tensor(length, k.device), tok,
                         x_emb=x_emb.contiguous(), ks=ks, vs=vs, k_kind=k_kind,
                         v_kind=v_kind, quant_eps=eps).launch()
    launch_counter(llama_megastep_quant, packed).launches += 1
    return tok[0], k, v, ks, vs


llama_megastep_quant.launches = 0
llama_megastep_quant.tiers = tier_counts()
