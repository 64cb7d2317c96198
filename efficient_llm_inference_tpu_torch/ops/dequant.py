"""Elementwise dequantization of int8 and packed-int4 codes.

Port of efficient_llm_inference_tpu/ops/pallas/dequant.py (`dequant_int8`,
`dequant_int4_packed`). On a CUDA tensor each wrapper launches its kernel of
`csrc/dequant.cu`; on a CPU tensor it runs the plain PyTorch version beside
it, which computes the same values bit for bit (one fp32 multiply, one
rounding to the output type). Launches are counted in `<wrapper>.launches`.

The engine's paths never materialize a dequantized cache (the fused
attention kernels read the codes); these serve callers of the kernel API
that want a dense copy.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from . import _build
from .quantization import dequantize_int4_packed, dequantize_int8

_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_DIMS = 4  # collapsed leading dims of a scale the kernel indexes
_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("dequant")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.elit_dequant_int8.restype = i
        # q, rows, D, scale, nd, sizes, strides, col_stride, out_dtype, vec, out, stream
        lib.elit_dequant_int8.argtypes = [p, ll, i, p, i, p, p, ll, i, i, p, p]
        lib.elit_dequant_int4.restype = i
        # packed, rows, Dp, orig, scale, nd, sizes, strides, out_dtype, vec, out, stream
        lib.elit_dequant_int4.argtypes = [p, ll, i, i, p, i, p, p, i, i, p, p]
        _lib = lib
    return _lib


def _scale_tensor(scale, device) -> torch.Tensor:
    """The scale as fp32 on `device` (JAX: jnp.asarray(scale, float32))."""
    if isinstance(scale, torch.Tensor):
        return scale.to(device=device, dtype=torch.float32)
    return torch.tensor(float(scale), dtype=torch.float32, device=device)


def _collapse(shape, strides) -> Tuple[List[int], List[int]]:
    """Leading dims of a broadcast scale view, size-1 dims dropped and
    neighbours merged where one stride walks both; inner first."""
    dims: List[List[int]] = []
    for n, st in zip(shape, strides):
        if n == 1:
            continue
        if dims and dims[-1][1] == st * n:  # the outer dim steps over this one
            dims[-1] = [dims[-1][0] * n, st]
        else:
            dims.append([n, st])
    dims = dims[::-1] or [[1, 0]]
    return [d[0] for d in dims], [d[1] for d in dims]


def _scale_index(s: torch.Tensor, lead: tuple):
    """(scale tensor, nd, sizes, strides) of `s` read per row of the leading
    dims `lead` ([..., 1] view: the strides of a broadcast, 0 where the scale
    is shared). More than 4 dims after collapsing: a contiguous copy."""
    view = torch.broadcast_to(s, (*lead, 1))
    sizes, strides = _collapse(view.shape[:-1], view.stride()[:-1])
    if len(sizes) > _MAX_DIMS:
        view = view.contiguous()
        sizes, strides = _collapse(view.shape[:-1], view.stride()[:-1])
    nd = len(sizes)
    arr = ctypes.c_longlong * _MAX_DIMS
    return view, nd, arr(*sizes, *[1] * (_MAX_DIMS - nd)), arr(*strides, *[0] * (_MAX_DIMS - nd))


def _check_codes(name: str, x: torch.Tensor, dtype, out_dtype) -> None:
    if x.dtype != dtype or not x.is_contiguous() or x.dim() < 1:
        raise ValueError(f"{name}: expected contiguous {dtype} [..., D], got {x.dtype} "
                         f"{tuple(x.shape)} (contiguous: {x.is_contiguous()})")
    if out_dtype not in _OUT_CODE:
        raise TypeError(f"unsupported out_dtype {out_dtype}")


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def dequant_int8_plain(q: torch.Tensor, scale, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version: q * scale in fp32, cast to out_dtype."""
    return dequantize_int8(q, _scale_tensor(scale, q.device), out_dtype)


def dequant_int4_packed_plain(packed: torch.Tensor, scale, orig_last_dim: int,
                              out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version: unpack (high nibble = even element), code - 8,
    cut to orig_last_dim, times scale in fp32, cast to out_dtype."""
    return dequantize_int4_packed(packed, _scale_tensor(scale, packed.device), out_dtype,
                                  orig_last_dim)


def dequant_int8(q: torch.Tensor, scale, out_dtype=torch.bfloat16) -> torch.Tensor:
    """q: [..., D] int8; scale: a scalar, or a tensor broadcastable to q
    (per row [..., 1], per token broadcast over heads, or per element) ->
    [..., D] in out_dtype: f32(q) * f32(scale), rounded once. On a CUDA
    tensor it launches `csrc/dequant.cu` (the scale is read in place through
    its broadcast strides) and counts one launch in `dequant_int8.launches`;
    on a CPU tensor it runs `dequant_int8_plain`."""
    if q.device.type == "cpu":
        return dequant_int8_plain(q, scale, out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_codes("q", q, torch.int8, out_dtype)
    s = _scale_tensor(scale, q.device)
    D = q.shape[-1]
    full = torch.broadcast_to(s, q.shape)
    col_stride = full.stride(-1) if D > 1 else 0  # != 0: varies along the row
    view, nd, sizes, strides = _scale_index(full[..., :1], q.shape[:-1])
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    rows = q.numel() // D if D else 0
    lib = _kernels()
    rc = lib.elit_dequant_int8(
        q.data_ptr(), rows, D, view.data_ptr(), nd, sizes, strides, col_stride,
        _OUT_CODE[out_dtype], int(D % 16 == 0 and _aligned(q, out)), out.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "dequant_int8")
    dequant_int8.launches += 1
    return out


def dequant_int4_packed(packed: torch.Tensor, scale, orig_last_dim: int,
                        out_dtype=torch.bfloat16) -> torch.Tensor:
    """packed: [..., D//2] uint8 (two codes a byte, the even element in the
    high nibble, code = nibble - 8) -> [..., orig_last_dim] in out_dtype
    (an odd dim's pad lane cut off). `scale` is a scalar or broadcastable
    as [..., 1]: constant along the last axis, as the JAX function requires.
    On a CUDA tensor it launches `csrc/dequant.cu` (natural element order,
    no deinterleave) and counts one launch in `dequant_int4_packed.launches`;
    on a CPU tensor it runs `dequant_int4_packed_plain`."""
    Dp = packed.shape[-1]
    if not 0 <= orig_last_dim <= 2 * Dp:
        raise ValueError(f"orig_last_dim {orig_last_dim} outside 0..{2 * Dp}")
    s = _scale_tensor(scale, packed.device)
    if s.dim() and s.shape[-1] != 1:
        raise ValueError(f"scale {tuple(s.shape)}: must be constant along the last axis "
                         "(a scalar or [..., 1])")
    if packed.device.type == "cpu":
        return dequant_int4_packed_plain(packed, s, orig_last_dim, out_dtype)
    if packed.device.type != "cuda":
        raise ValueError(f"no kernel for device {packed.device}")
    _check_codes("packed", packed, torch.uint8, out_dtype)
    lead = packed.shape[:-1]
    view, nd, sizes, strides = _scale_index(s, lead)
    out = torch.empty((*lead, orig_last_dim), dtype=out_dtype, device=packed.device)
    rows = packed.numel() // Dp if Dp else 0
    vec = Dp % 16 == 0 and orig_last_dim == 2 * Dp and _aligned(packed, out)
    lib = _kernels()
    rc = lib.elit_dequant_int4(
        packed.data_ptr(), rows, Dp, orig_last_dim, view.data_ptr(), nd, sizes, strides,
        _OUT_CODE[out_dtype], int(vec), out.data_ptr(),
        torch.cuda.current_stream(packed.device).cuda_stream)
    _build.check(lib, rc, "dequant_int4_packed")
    dequant_int4_packed.launches += 1
    return out


dequant_int8.launches = 0
dequant_int4_packed.launches = 0
