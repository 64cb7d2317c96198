"""KV-cache strategies over static-capacity buffers (PyTorch port of
efficient_llm_inference_tpu/cache/kvcache.py: DenseKV and QuantizedKV).

The cache is a dict of preallocated tensors

    {"k": [L, B, H, C, D], "v": [L, B, H, C, D], "length": int, ...}

that the strategy updates in place (the JAX package returns new arrays;
here writing in place saves a copy of the cache per layer and step).
`length` is a host integer: the decode loop runs on the host, so the counter
needs no device round trip. Append writes the new block at `length`,
attention is a masked softmax over the full capacity C, and the new token's
position is the cache length (the positional quirk of docs/ARCHITECTURE.md).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from ..ops.attention import fused_quant_attention_batched
from ..ops.quantization import dequantize_int4_packed, dequantize_int8
from ..ops.quantize import quantize_int4_rows, quantize_int8_rows

NEG_INF = float(torch.finfo(torch.float32).min)


def _attend(
    q: torch.Tensor,  # [B, Hq, T, D] query block
    k_buf: torch.Tensor,  # [B, Hkv, C, D] full-capacity key buffer
    v_buf: torch.Tensor,  # [B, Hkv, C, D]
    length: int,  # tokens cached before this block
) -> torch.Tensor:
    """Masked causal attention over a static-capacity buffer, in fp32.

    Query row i (global position length + i) sees key slot j iff
    j <= length + i; right-padded prefill needs nothing more, since pad keys
    sit after every real query's horizon. Grouped-query attention groups
    the query heads onto shared KV heads without repeating K/V.
    """
    B, Hq, T, D = q.shape
    Hkv, C = k_buf.shape[1], k_buf.shape[2]
    G = Hq // Hkv
    qg = q.float().reshape(B, Hkv, G, T, D)
    scores = torch.einsum("bkgtd,bkcd->bkgtc", qg, k_buf.float())
    scores = scores * (1.0 / math.sqrt(D))
    col = torch.arange(C, device=q.device)
    row = torch.arange(T, device=q.device)
    mask = col[None, :] <= length + row[:, None]  # [T, C]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgtc,bkcd->bkgtd", probs, v_buf.float())
    return out.reshape(B, Hq, T, D)


def _start(length: int, T: int, capacity: int) -> int:
    """Write offset of a T-row block: `length`, clamped so the block fits
    (what lax.dynamic_update_slice does in the JAX package)."""
    return max(0, min(length, capacity - T))


@dataclasses.dataclass(frozen=True)
class DenseKV:
    """Full-precision static-capacity KV cache (full_cache)."""

    n_layer: int
    n_head: int
    head_dim: int
    capacity: int
    batch: int = 1
    dtype: Any = torch.float32
    device: Any = "cuda"

    def init(self) -> dict:
        shape = (self.n_layer, self.batch, self.n_head, self.capacity, self.head_dim)
        return {
            "k": torch.zeros(shape, dtype=self.dtype, device=self.device),
            "v": torch.zeros(shape, dtype=self.dtype, device=self.device),
            "length": 0,
        }

    def set_length(self, cache: dict, length: int) -> dict:
        cache["length"] = int(length)
        return cache

    def layer_attend(self, cache: dict, layer: int, q, k_new, v_new,
                     seq_mask: Optional[torch.Tensor]):
        length = cache["length"]
        s = _start(length, k_new.shape[2], self.capacity)
        k_l, v_l = cache["k"][layer], cache["v"][layer]
        k_l[:, :, s:s + k_new.shape[2]] = k_new
        v_l[:, :, s:s + v_new.shape[2]] = v_new
        return _attend(q, k_l, v_l, length)

    def est_bytes(self, length: int) -> float:
        per_tok = self.batch * self.n_head * self.head_dim
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return 2.0 * self.n_layer * length * per_tok * itemsize


@dataclasses.dataclass(frozen=True)
class QuantizedKV:
    """Quantized KV cache: int8, packed int4, or mixed (K int8, V int4).

    Storage and scale math match the JAX package's QuantizedKV bit for bit:
    `granularity="per_token"` keeps one scale per appended token over all
    heads, `"per_head"` one per (head, token). Past tokens are read
    quantized, the current block stays full-precision, and the current block
    is quantized on write.

    Batch 1 only: a token's per_token row is its [H*D] values and its
    per_head rows are its H rows of [D], which is what the rows kernels take.
    A T==1 decode step attends through the fused kernel; prefill (T>1)
    dequantizes, overlays the fp block and runs `_attend`, the reference
    numerics.
    """

    n_layer: int
    n_head: int
    head_dim: int
    capacity: int
    batch: int = 1
    dtype: Any = torch.float32  # compute dtype of dequantized values
    device: Any = "cuda"
    mode: str = "int8"  # "int8" | "int4" | "mixed"
    granularity: str = "per_token"  # "per_token" | "per_head"
    eps: float = 1e-8

    def __post_init__(self):
        if self.mode not in ("int8", "int4", "mixed"):
            raise ValueError(f"mode {self.mode!r}")
        if self.granularity not in ("per_token", "per_head"):
            raise ValueError(f"granularity {self.granularity!r}")
        if self.head_dim % 2:
            raise ValueError("int4 packing needs an even head_dim")
        if self.batch != 1:
            raise NotImplementedError(
                "QuantizedKV takes batch 1; batched serving is ROADMAP.md "
                "Queue 1 item 8")

    def _k_kind(self) -> str:
        return "int8" if self.mode in ("int8", "mixed") else "int4"

    def _v_kind(self) -> str:
        return "int8" if self.mode == "int8" else "int4"

    def _store(self, kind: str) -> torch.Tensor:
        L, B, H, C, D = (self.n_layer, self.batch, self.n_head, self.capacity,
                         self.head_dim)
        if kind == "int8":
            return torch.zeros((L, B, H, C, D), dtype=torch.int8, device=self.device)
        return torch.zeros((L, B, H, C, D // 2), dtype=torch.uint8, device=self.device)

    def _scales(self) -> torch.Tensor:
        shape = ((self.n_layer, self.capacity) if self.granularity == "per_token"
                 else (self.n_layer, self.n_head, self.capacity))
        return torch.ones(shape, dtype=torch.float32, device=self.device)

    def init(self) -> dict:
        return {
            "k": self._store(self._k_kind()),
            "v": self._store(self._v_kind()),
            "k_scale": self._scales(),
            "v_scale": self._scales(),
            "length": 0,
            "lengths": torch.zeros((self.batch,), dtype=torch.int32,
                                   device=self.device),
        }

    def set_length(self, cache: dict, length: int) -> dict:
        cache["length"] = int(length)
        cache["lengths"] = torch.full((self.batch,), int(length),
                                      dtype=torch.int32, device=self.device)
        return cache

    def _quantize_block(self, x: torch.Tensor, kind: str):
        """x [1, H, T, D] -> (codes [1, H, T, D or D/2], scales [T] or [H, T])."""
        _, H, T, D = x.shape
        if self.granularity == "per_token":
            rows = x[0].transpose(0, 1).reshape(T, H * D)
        else:
            rows = x[0].reshape(H * T, D)
        quantize = quantize_int8_rows if kind == "int8" else quantize_int4_rows
        codes, scale = quantize(rows, self.eps)
        if self.granularity == "per_token":
            return codes.reshape(T, H, -1).transpose(0, 1)[None], scale.reshape(T)
        return codes.reshape(H, T, -1)[None], scale.reshape(H, T)

    def _dequant_buf(self, buf, scale_l, kind: str):
        # scale_l: [C] (per_token) or [H, C] (per_head) -> broadcast [1,.,C,1]
        if self.granularity == "per_token":
            s = scale_l[None, None, :, None]
        else:
            s = scale_l[None, :, :, None]
        if kind == "int8":
            return dequantize_int8(buf, s, self.dtype)
        return dequantize_int4_packed(buf, s, self.dtype)

    def layer_attend(self, cache: dict, layer: int, q, k_new, v_new,
                     seq_mask: Optional[torch.Tensor]):
        length = cache["length"]
        T = q.shape[2]
        s = _start(length, T, self.capacity)
        k_l, v_l = cache["k"][layer], cache["v"][layer]
        ks_l, vs_l = cache["k_scale"][layer], cache["v_scale"][layer]

        kq, k_scale = self._quantize_block(k_new, self._k_kind())
        vq, v_scale = self._quantize_block(v_new, self._v_kind())
        k_l[:, :, s:s + T] = kq
        v_l[:, :, s:s + T] = vq
        ks_l[..., s:s + T] = k_scale
        vs_l[..., s:s + T] = v_scale

        if T == 1:
            B, H, C = self.batch, self.n_head, self.capacity
            out = fused_quant_attention_batched(
                q[:, :, 0],  # [B, Hq, D]
                k_l, ks_l.expand(B, H, C), v_l, vs_l.expand(B, H, C),
                k_new, v_new,  # the current token, full-precision
                cache["lengths"], 1,
                k_bits=8 if self._k_kind() == "int8" else 4,
                v_bits=8 if self._v_kind() == "int8" else 4,
            )
            return out[:, :, None, :]

        # Prefill: dequantize the buffer, overlay the fp block (the in-flight
        # tokens stay full-precision), attend.
        k_fp = self._dequant_buf(k_l, ks_l, self._k_kind())
        v_fp = self._dequant_buf(v_l, vs_l, self._v_kind())
        k_fp[:, :, s:s + T] = k_new
        v_fp[:, :, s:s + T] = v_new
        return _attend(q, k_fp, v_fp, length)

    def est_bytes(self, length: int) -> float:
        """Stored bytes at `length` tokens: codes plus fp32 scales."""
        B, H, D, L = self.batch, self.n_head, self.head_dim, self.n_layer
        per_tok_store = {"int8": B * H * D, "int4": B * H * (D // 2)}
        n_scales = 1 if self.granularity == "per_token" else H
        k_b = per_tok_store[self._k_kind()] + n_scales * 4
        v_b = per_tok_store[self._v_kind()] + n_scales * 4
        return float(L * length * (k_b + v_b))
