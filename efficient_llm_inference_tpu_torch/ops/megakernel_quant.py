"""Whole-step GPT-2 decode over QUANTIZED KV panes.

Port of efficient_llm_inference_tpu/ops/pallas/megakernel_quant.py
(gpt2_megastep_quant, _kv_kinds, unpack_halves, to_mega_quant_layout,
mega_quant_supported). The step is ops/megakernel.py's kernel chain with
int8, packed-int4 or mixed (K int8, V int4) panes and per-token fp32
scales [L, C]: the attention kernel reads the codes at their stored size and
folds the scales into the scores and the probabilities, and the new token's
K/V rows are quantized on write.

* int4 panes use the JAX kernel's HALF-SPLIT pairing: pane byte j of a row
  packs lane j (high nibble, two's complement) with lane j + E/2 (low
  nibble, biased +8), stored as int8 = 16 * q_hi + q_lo + 8. This is not the
  even/odd-in-D layout of QuantizedKV; `to_mega_quant_layout` repacks once
  per generation and preserves every value.
* Quantize-on-write is the reference math exactly: scale =
  max(max|x| * f32(1/qmax), eps) in fp32 (the form XLA compiles the JAX
  division to), codes = clip(round_half_even(x / scale)).
* As in the JAX kernel, past rows are scored as (u . codes) * k_scale and
  the probabilities are multiplied by the V scales and rounded to the model
  dtype before the PV product (exact in fp32); the current token stays
  full-precision and merges into the same softmax.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .megakernel import (
    NEG_INF,
    StepLauncher,
    _full_precision_dtype,
    _geometry_ok,
    _length_tensor,
    plain_step,
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
    (uniform full-precision weights, E % 128 == 0, capacity % 8 == 0, and
    (E/2) % 128 == 0 when a pane is int4) plus the kernels' limits of
    `ops.megakernel.mega_supported`. The VMEM budget is not carried over."""
    if _full_precision_dtype(params) is None or not _geometry_ok(cfg, capacity):
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


def gpt2_megastep_quant_plain(packed: dict, k, v, ks, vs, length, x_emb, *,
                              cfg, kv_mode: str, eps: float = 1e-8,
                              return_logits: bool = False):
    """Plain PyTorch version of `gpt2_megastep_quant`, the same function on
    any device: returns (token int32 [], k, v, ks, vs) with row `length` of
    every layer's panes and scales written in place; with `return_logits`
    the fp32 logits [V] come sixth."""
    E, H, D = cfg.n_embd, cfg.n_head, cfg.head_dim
    C = k.shape[1]
    dt = x_emb.dtype
    k_kind, v_kind = _kv_kinds(kv_mode)
    cur = int(length)
    scale = 1.0 / math.sqrt(D)
    visible = torch.arange(C, device=k.device) < cur

    def attend(layer, q, kc, vc):
        u = q.float().reshape(H, D)
        kval = pane_values(k[layer], k_kind).reshape(C, H, D)
        raw = torch.einsum("hd,chd->hc", u, kval)
        st = torch.where(visible, raw * ks[layer] * scale, NEG_INF)
        s_cur = (u * kc.float().reshape(H, D)).sum(-1, keepdim=True) * scale
        mx = torch.maximum(st.amax(-1, keepdim=True), s_cur)
        p = torch.exp(st - mx)
        p_cur = torch.exp(s_cur - mx)
        denom = p.sum(-1, keepdim=True) + p_cur
        ps = (p * vs[layer]).to(dt).float()  # the PV product's input dtype
        vval = pane_values(v[layer], v_kind).reshape(C, H, D)
        num = torch.einsum("hc,chd->hd", ps, vval) + p_cur * vc.float().reshape(H, D)
        return (num / denom).reshape(E)

    logits, new_k, new_v = plain_step(packed, cfg, x_emb, attend)
    if cur < C:
        for layer in range(cfg.n_layer):
            k[layer, cur], ks[layer, cur] = quantize_row(new_k[layer], k_kind, eps)
            v[layer, cur], vs[layer, cur] = quantize_row(new_v[layer], v_kind, eps)
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
    same way). On a CUDA tensor it launches the kernel chain of
    `csrc/gpt2_megastep.cu` and counts one launch in
    `gpt2_megastep_quant.launches`; on a CPU tensor it runs
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
    gpt2_megastep_quant.launches += 1
    return tok[0], k, v, ks, vs


gpt2_megastep_quant.launches = 0
