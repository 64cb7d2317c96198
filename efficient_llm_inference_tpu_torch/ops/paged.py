"""Paged decode attention: block-table indexed decode over a shared pool.

Port of efficient_llm_inference_tpu/ops/pallas/paged.py
(`paged_attention_decode`). On a CUDA tensor the wrapper launches the kernel
of `csrc/paged_attention.cu`; on a CPU tensor it runs the plain PyTorch
version beside it (a gather of the table's blocks, then a masked softmax).
Launches are counted in `paged_attention_decode.launches`.

Pool layout per layer: [Hkv, n_blocks, block_size, D]. Masking is exclusive,
as every mask of the repo: slot b attends walked positions p < lengths[b].
A slot with lengths[b] == 0 gets the JAX kernel's result: its scores are all
finfo(f32).min, so the softmax is uniform and the output is the mean of V
over all max_blocks x block_size walked positions (sentinel entries clamped
to the last block), not zero.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = float(torch.finfo(torch.float32).min)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GROUP = 8  # query heads a KV head (csrc/paged_attention.cu kMaxG)
_lib = None


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("paged_attention")
        fn = lib.elit_paged_attention
        fn.restype = ctypes.c_int
        i, p = ctypes.c_int, ctypes.c_void_p
        # q_dtype, pool_dtype, B, Hq, Hkv, D, n_blocks, bs, max_blocks,
        # q, k_pool, v_pool, tables, lengths, sm_scale, out, stream
        fn.argtypes = [i, i, i, i, i, i, i, i, i, p, p, p, p, p, ctypes.c_float, p, p]
        _lib = lib
    return _lib


def paged_attention_decode_plain(q, k_pool, v_pool, tables, lengths):
    """Plain PyTorch version: gather each slot's walked rows through its
    clamped table, masked softmax in fp32 (finfo.min, as JAX), [B, Hq, D]
    in q.dtype."""
    B, Hq, D = q.shape
    Hkv, n_blocks, bs, _ = k_pool.shape
    G = Hq // Hkv
    T = tables.shape[1] * bs
    t = tables.long().clamp(0, n_blocks - 1).to(k_pool.device)  # sentinels: the last block
    k = k_pool[:, t].reshape(Hkv, B, T, D).transpose(0, 1).float()  # [B, Hkv, T, D]
    v = v_pool[:, t].reshape(Hkv, B, T, D).transpose(0, 1).float()
    qg = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bhtd->bhgt", qg, k) * (1.0 / math.sqrt(D))
    pos = torch.arange(T, device=q.device)
    visible = pos[None, :] < lengths.to(q.device).long()[:, None]  # [B, T]
    s = torch.where(visible[:, None, None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.einsum("bhgt,bhtd->bhgd", p, v) / p.sum(-1, keepdim=True)
    return out.to(q.dtype).reshape(B, Hq, D)


def paged_attention_decode(
    q,  # [B, Hq, D]
    k_pool,  # [Hkv, n_blocks, bs, D]
    v_pool,
    tables,  # [B, max_blocks] int32 (entries may be a >= n_blocks sentinel)
    lengths,  # [B] int32: exclusive visible count, p < lengths[b] attends
):
    """Returns [B, Hq, D] in q.dtype: slot b attends pool positions
    p < lengths[b] along its block table. On a CUDA tensor it launches
    `csrc/paged_attention.cu` (one block per (KV head, slot), the walk
    stopping at the last visible position) and counts one launch in
    `paged_attention_decode.launches`; on a CPU tensor it runs
    `paged_attention_decode_plain`."""
    if q.device.type == "cpu":
        return paged_attention_decode_plain(q, k_pool, v_pool, tables, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, Hq, D = q.shape
    Hkv, n_blocks, bs, Dk = k_pool.shape
    if q.dtype not in _DTYPE_CODE or k_pool.dtype not in _DTYPE_CODE \
            or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"no kernel for q {q.dtype}, pools {k_pool.dtype}/{v_pool.dtype}")
    if D not in (64, 128) or Dk != D or tuple(v_pool.shape) != tuple(k_pool.shape):
        raise NotImplementedError(f"head dim {D}, pools {tuple(k_pool.shape)} (the kernel "
                                  "takes D in {64, 128} and equal K/V pools)")
    if Hq % Hkv or Hq // Hkv > _MAX_GROUP:
        raise NotImplementedError(f"{Hq} query heads on {Hkv} KV heads (the kernel takes "
                                  f"groups of at most {_MAX_GROUP})")
    if tables.dtype != torch.int32 or tables.dim() != 2 or tables.shape[0] != B \
            or tables.shape[1] < 1 or lengths.dtype != torch.int32 \
            or tuple(lengths.shape) != (B,):
        raise ValueError("tables: expected int32 [B, max_blocks >= 1]; lengths: int32 [B]")
    tensors = (q, k_pool, v_pool, tables, lengths)
    if any(t.device != q.device or not t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous and on one device")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("pools must be 16-byte aligned")
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    lib = _kernel()
    rc = lib.elit_paged_attention(
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pool.dtype], B, Hq, Hkv, D, n_blocks, bs,
        tables.shape[1], q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), 1.0 / math.sqrt(D), out.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "paged_attention_decode")
    paged_attention_decode.launches += 1
    return out


paged_attention_decode.launches = 0
