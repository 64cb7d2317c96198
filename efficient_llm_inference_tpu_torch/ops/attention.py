"""Fused decode attention over a quantized KV cache.

Port of efficient_llm_inference_tpu/ops/pallas/attention.py:
fused_quant_attention_batched and its batch-1 form
fused_quant_attention_decode. On a CUDA tensor each wrapper launches its
entry point of `csrc/fused_quant_attention.cu`; on a CPU tensor it runs the
plain PyTorch version beside it. Launches are counted in
`<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .quantization import unpack_int4

NEG_INF = float(torch.finfo(torch.float32).min)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("fused_quant_attention")
        fn = lib.elit_fused_quant_attention
        fn.restype = ctypes.c_int
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        fn.argtypes = [
            i, i, i, i, i, i, i, i,  # q_dtype, k_bits, v_bits, B, Hq, Hkv, C, D
            p, ll, ll,  # q, strides b, h
            p, p,  # k codes, v codes
            p, ll, ll,  # k scales, strides b, h
            p, ll, ll,  # v scales
            p, ll, ll, ll,  # k extra, strides b, h, s
            p, ll, ll, ll,  # v extra
            p, i, i, ctypes.c_float, p, p,  # lengths, n_extra, S, sm_scale, out, stream
        ]
        fn = lib.elit_fused_quant_attention_decode
        fn.restype = ctypes.c_int
        fn.argtypes = [
            i, i, i, i, i, i, i,  # q_dtype, k_bits, v_bits, Hq, Hkv, C, D
            p, ll, p, p,  # q, its head stride, k codes, v codes
            p, ll, p, ll,  # k scales, head stride, v scales, head stride
            p, ll, p, ll,  # current k, head stride, current v, head stride
            p, i, ctypes.c_float, p, p,  # length (device) or value, sm_scale, out, stream
        ]
        _lib = lib
    return _lib


def _codes_as_float(x: torch.Tensor, bits: int) -> torch.Tensor:
    return unpack_int4(x).float() if bits == 4 else x.float()


def fused_quant_attention_batched_plain(
    q, k_q, k_scale, v_q, v_scale, k_extra, v_extra, lengths, n_extra: int,
    k_bits: int = 8, v_bits: int = 8,
):
    """Plain PyTorch version: the same function in fp32 on any device."""
    B, Hq, D = q.shape
    Hkv, C = k_q.shape[1], k_q.shape[2]
    S = k_extra.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, Hkv, G, D)

    s_past = torch.einsum("bhgd,bhcd->bhgc", qg, _codes_as_float(k_q, k_bits))
    if k_bits != 16:
        s_past = s_past * k_scale.float()[:, :, None, :]
    t = torch.arange(C, device=q.device)
    visible = t[None, :] < lengths.to(q.device)[:, None]  # [B, C]
    s_past = torch.where(visible[:, None, None, :], s_past * scale, NEG_INF)

    s_ex = torch.einsum("bhgd,bhsd->bhgs", qg, k_extra.float()) * scale
    j = torch.arange(S, device=q.device)
    s_ex = torch.where(j < n_extra, s_ex, NEG_INF)

    m = torch.maximum(s_past.amax(-1, keepdim=True), s_ex.amax(-1, keepdim=True))
    p_past = torch.exp(s_past - m)
    p_ex = torch.exp(s_ex - m)
    denom = p_past.sum(-1, keepdim=True) + p_ex.sum(-1, keepdim=True)
    if v_bits != 16:
        p_past = p_past * v_scale.float()[:, :, None, :]
    out = torch.einsum("bhgc,bhcd->bhgd", p_past, _codes_as_float(v_q, v_bits))
    out = out + torch.einsum("bhgs,bhsd->bhgd", p_ex, v_extra.float())
    return (out / denom).to(q.dtype).reshape(B, Hq, D)


def _check_inner(name: str, x: torch.Tensor, ndim: int):
    if x.dim() != ndim or x.stride(-1) != 1:
        raise ValueError(f"{name}: expected {ndim} dims with unit inner stride, "
                         f"got shape {tuple(x.shape)} strides {x.stride()}")


def fused_quant_attention_batched(
    q,  # [B, Hq, D] fp queries (one decode row per slot)
    k_q,  # [B, Hkv, C, D] int8, [B, Hkv, C, D//2] uint8, or fp (16 bits)
    k_scale,  # [B, Hkv, C] f32 (ignored at 16 bits)
    v_q,
    v_scale,
    k_extra,  # [B, Hkv, S, D] fp region (the current token at decode)
    v_extra,
    lengths,  # [B] int32: past rows t < lengths[b] are visible
    n_extra: int,  # extra rows j < n_extra are visible
    k_bits: int = 8,
    v_bits: int = 8,
):
    """Returns [B, Hq, D] in q's dtype: softmax attention of each query over
    the visible quantized past rows and the visible extra rows together.

    k_bits/v_bits: 8 = int8 codes with per-row scales, 4 = packed int4 codes
    with per-row scales, 16 = raw fp rows in q's dtype (both or neither).
    The quantized rows are read at their compressed size; no dequantized
    copy is made. A slot with no visible row (lengths[b] == 0 and
    n_extra == 0) gets the JAX kernel's result: the uniform average of all
    C stored rows and all S extra rows.
    """
    if q.device.type == "cpu":
        return fused_quant_attention_batched_plain(
            q, k_q, k_scale, v_q, v_scale, k_extra, v_extra, lengths, n_extra,
            k_bits, v_bits)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, Hq, D = q.shape
    Hkv, C = k_q.shape[1], k_q.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported query dtype {q.dtype}")
    if (k_bits == 16) != (v_bits == 16) or k_bits not in (4, 8, 16) \
            or v_bits not in (4, 8, 16):
        raise NotImplementedError(f"k_bits={k_bits}, v_bits={v_bits}")
    if D not in (64, 128):
        raise NotImplementedError(f"head dim {D} (the kernel takes 64 or 128)")
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group onto {Hkv} kv heads")
    want = {8: (torch.int8, D), 4: (torch.uint8, D // 2), 16: (q.dtype, D)}
    for name, codes, bits in (("k_q", k_q, k_bits), ("v_q", v_q, v_bits)):
        dt, width = want[bits]
        if codes.dtype != dt or tuple(codes.shape) != (B, Hkv, C, width) \
                or not codes.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dt} "
                             f"{(B, Hkv, C, width)}, got {codes.dtype} "
                             f"{tuple(codes.shape)}")
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        _check_inner(name, s, 3)
        if s.dtype != torch.float32 or tuple(s.shape) != (B, Hkv, C):
            raise ValueError(f"{name}: expected float32 {(B, Hkv, C)}")
    for name, x in (("k_extra", k_extra), ("v_extra", v_extra)):
        _check_inner(name, x, 4)
        if x.dtype != q.dtype or tuple(x.shape[:2]) != (B, Hkv) \
                or x.shape[3] != D or not 0 <= n_extra <= x.shape[2]:
            raise ValueError(f"{name}: expected {q.dtype} [{B}, {Hkv}, S, {D}] "
                             f"with n_extra={n_extra} <= S")
    _check_inner("q", q, 3)
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,) \
            or not lengths.is_contiguous():
        raise ValueError("lengths: expected contiguous int32 [B]")
    tensors = (q, k_q, k_scale, v_q, v_scale, k_extra, v_extra, lengths)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one device")

    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = _kernel()
    rc = lib.elit_fused_quant_attention(
        _DTYPE_CODE[q.dtype], k_bits, v_bits, B, Hq, Hkv, C, D,
        q.data_ptr(), q.stride(0), q.stride(1),
        k_q.data_ptr(), v_q.data_ptr(),
        k_scale.data_ptr(), k_scale.stride(0), k_scale.stride(1),
        v_scale.data_ptr(), v_scale.stride(0), v_scale.stride(1),
        k_extra.data_ptr(), k_extra.stride(0), k_extra.stride(1), k_extra.stride(2),
        v_extra.data_ptr(), v_extra.stride(0), v_extra.stride(1), v_extra.stride(2),
        lengths.data_ptr(), n_extra, k_extra.shape[2], 1.0 / math.sqrt(D),
        out.data_ptr(), stream)
    _build.check(lib, rc, "fused_quant_attention_batched")
    fused_quant_attention_batched.launches += 1
    return out


fused_quant_attention_batched.launches = 0


def fused_quant_attention_decode_plain(q, k_q, k_scale, v_q, v_scale, k_cur, v_cur,
                                       length, k_bits: int = 8, v_bits: int = 8):
    """Plain PyTorch version: the batched plain version at B = 1 with the
    current token as the one visible extra row."""
    lengths = torch.as_tensor(length, dtype=torch.int32).reshape(1).to(q.device)
    return fused_quant_attention_batched_plain(
        q[None], k_q[None], k_scale[None], v_q[None], v_scale[None],
        k_cur[None, :, None], v_cur[None, :, None], lengths, 1, k_bits, v_bits)[0]


def fused_quant_attention_decode(
    q,  # [Hq, D] fp queries for the new token
    k_q,  # [Hkv, C, D] int8 or [Hkv, C, D//2] uint8
    k_scale,  # [Hkv, C] f32 (per_token scales broadcast over heads upstream)
    v_q,
    v_scale,
    k_cur,  # [Hkv, D] fp current-token K
    v_cur,  # [Hkv, D] fp current-token V
    length,  # int, or an int32 tensor of one element: valid past tokens
    k_bits: int = 8,
    v_bits: int = 8,
):
    """Returns [Hq, D] in q's dtype: each query head's softmax attention
    over its KV head's past rows t < length (quantized, read at their
    compressed size) and the current token's full-precision k/v, which is
    always visible (so length 0 gives v_cur). k_bits/v_bits: 8 (int8 codes)
    or 4 (packed int4, the even element in the high nibble), independently.
    On a CUDA tensor it launches the batch-1 entry point of
    `csrc/fused_quant_attention.cu` (a device tensor `length` is read on the
    device, so the call can be captured) and counts one launch in
    `fused_quant_attention_decode.launches`; on a CPU tensor it runs
    `fused_quant_attention_decode_plain`."""
    if q.device.type == "cpu":
        return fused_quant_attention_decode_plain(q, k_q, k_scale, v_q, v_scale, k_cur,
                                                  v_cur, length, k_bits, v_bits)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    Hq, D = q.shape
    Hkv, C = k_q.shape[0], k_q.shape[1]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported query dtype {q.dtype}")
    if k_bits not in (4, 8) or v_bits not in (4, 8):
        raise NotImplementedError(f"k_bits={k_bits}, v_bits={v_bits} (8 or 4)")
    if D not in (64, 128):
        raise NotImplementedError(f"head dim {D} (the kernel takes 64 or 128)")
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group onto {Hkv} kv heads")
    want = {8: (torch.int8, D), 4: (torch.uint8, D // 2)}
    for name, codes, bits in (("k_q", k_q, k_bits), ("v_q", v_q, v_bits)):
        dt, width = want[bits]
        if codes.dtype != dt or tuple(codes.shape) != (Hkv, C, width) \
                or not codes.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dt} {(Hkv, C, width)}, got "
                             f"{codes.dtype} {tuple(codes.shape)}")
    for name, s_ in (("k_scale", k_scale), ("v_scale", v_scale)):
        _check_inner(name, s_, 2)
        if s_.dtype != torch.float32 or tuple(s_.shape) != (Hkv, C):
            raise ValueError(f"{name}: expected float32 {(Hkv, C)}")
    for name, x in (("q", q), ("k_cur", k_cur), ("v_cur", v_cur)):
        _check_inner(name, x, 2)
        if x.dtype != q.dtype or x.shape[1] != D:
            raise ValueError(f"{name}: expected {q.dtype} [., {D}]")
    if tuple(k_cur.shape) != (Hkv, D) or tuple(v_cur.shape) != (Hkv, D):
        raise ValueError(f"k_cur, v_cur: expected [{Hkv}, {D}]")
    if isinstance(length, torch.Tensor):
        if length.dtype != torch.int32 or length.numel() != 1 or length.device != q.device:
            raise ValueError(f"length: expected one int32 on {q.device}")
        len_ptr, len_value = length.data_ptr(), 0
    else:
        len_ptr, len_value = None, int(length)
    tensors = (k_q, k_scale, v_q, v_scale, k_cur, v_cur)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one device")

    out = torch.empty((Hq, D), dtype=q.dtype, device=q.device)
    lib = _kernel()
    rc = lib.elit_fused_quant_attention_decode(
        _DTYPE_CODE[q.dtype], k_bits, v_bits, Hq, Hkv, C, D,
        q.data_ptr(), q.stride(0), k_q.data_ptr(), v_q.data_ptr(),
        k_scale.data_ptr(), k_scale.stride(0), v_scale.data_ptr(), v_scale.stride(0),
        k_cur.data_ptr(), k_cur.stride(0), v_cur.data_ptr(), v_cur.stride(0),
        len_ptr, len_value, 1.0 / math.sqrt(D), out.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "fused_quant_attention_decode")
    fused_quant_attention_decode.launches += 1
    return out


fused_quant_attention_decode.launches = 0
