"""Symmetric INT8 / packed-INT4 quantization (PyTorch port of
efficient_llm_inference_tpu/ops/quantization.py).

Codes and scales are bit-exact to the JAX functions:

* scale = max(max|x| * (1/qmax), eps) in float32, qmax = 127 (int8) or 7
  (int4), with 1/qmax rounded to float32: the JAX package runs these
  functions under jit, where XLA turns the division by the constant qmax into
  this multiply, and the two differ in the last bit of some scales;
* q = clamp(round_half_even(x / scale), -127..127) for int8, or
  clamp(..., -8..7) + 8 packed two per byte along the last axis with the
  EVEN element in the HIGH nibble for int4 (an odd last dim is zero-padded);
* dequant = q * scale in float32, cast to the output dtype.

`axes` names the axes the scale reduces over; e.g. for x=[B,H,T,D],
axes=(0,1,3) gives one scale per token.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def _scale(x32: torch.Tensor, qmax: float, axes: Tuple[int, ...], eps: float):
    max_abs = x32.abs()
    if axes:  # amax over an empty dim tuple would reduce over everything
        max_abs = torch.amax(max_abs, dim=axes, keepdim=True)
    return torch.clamp(max_abs * (1.0 / qmax), min=eps)


def _squeeze(scale: torch.Tensor, axes: Tuple[int, ...]) -> torch.Tensor:
    return scale.squeeze(axes) if axes else scale


def quantize_int8(
    x: torch.Tensor, axes: Sequence[int] = (), eps: float = 1e-8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (q int8 with x's shape, scale fp32 with `axes` squeezed)."""
    axes = tuple(a % x.dim() for a in axes)
    x32 = x.float()
    scale = _scale(x32, 127.0, axes, eps)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, _squeeze(scale, axes)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    out_dtype=torch.float32) -> torch.Tensor:
    """q * scale in fp32, cast to out_dtype; `scale` broadcasts against q."""
    return (q.float() * scale.float()).to(out_dtype)


def quantize_int4_packed(
    x: torch.Tensor, axes: Sequence[int] = (), eps: float = 1e-8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (packed uint8 [..., ceil(D/2)], scale fp32, `axes` squeezed)."""
    axes = tuple(a % x.dim() for a in axes)
    x32 = x.float()
    scale = _scale(x32, 7.0, axes, eps)
    q = torch.clamp(torch.round(x32 / scale), -8, 7).to(torch.int8)
    if x.shape[-1] % 2 == 1:
        q = F.pad(q, (0, 1))  # the pad quantizes to 0 -> nibble 8
    q_u = (q + 8).to(torch.uint8)
    packed = (q_u[..., 0::2] << 4) | q_u[..., 1::2]
    return packed, _squeeze(scale, axes)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 nibbles -> int8 in [-8, 7], interleaved (hi = even, lo = odd)."""
    hi = (packed >> 4) & 0x0F
    lo = packed & 0x0F
    q_u = torch.stack([hi, lo], dim=-1).reshape(*packed.shape[:-1], -1)
    return q_u.to(torch.int8) - 8


def dequantize_int4_packed(
    packed: torch.Tensor,
    scale: torch.Tensor,
    out_dtype=torch.float32,
    orig_last_dim: Optional[int] = None,
) -> torch.Tensor:
    """Packed int4 dequantize; `scale` broadcasts against the unpacked shape,
    and `orig_last_dim` slices off the pad lane of an odd last dim."""
    q = unpack_int4(packed)
    if orig_last_dim is not None and orig_last_dim != q.shape[-1]:
        q = q[..., :orig_last_dim]
    return (q.float() * scale.float()).to(out_dtype)
