"""Per-row symmetric quantization: int8, or int4 packed two per byte.

Port of efficient_llm_inference_tpu/ops/pallas/quantize.py. On a CUDA tensor
the wrappers launch the kernels of `csrc/quantize_rows.cu`; on a CPU tensor
they run the plain PyTorch versions beside them, which compute the same
codes and scales bit for bit. Each wrapper counts its launches in
`<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("quantize_rows")
        for fn in (lib.elit_quantize_int8_rows, lib.elit_quantize_int4_rows):
            fn.restype = ctypes.c_int
            # x, x_dtype, rows, n, row_stride, eps, codes, scales, stream
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _lib = lib
    return _lib


def scale_rows(x: torch.Tensor, qmax: float, eps: float):
    """(x in fp32, per-row scale [rows, 1]) of x [rows, n]."""
    x32 = x.float()
    max_abs = torch.amax(x32.abs(), dim=-1, keepdim=True)
    # max|x| * f32(1/qmax), as the jitted JAX kernels compute it
    return x32, torch.clamp(max_abs * (1.0 / qmax), min=eps)


def quantize_int8_rows_plain(x: torch.Tensor, eps: float = 1e-8):
    """x [rows, n] -> (q int8 [rows, n], scale f32 [rows, 1])."""
    x32, scale = scale_rows(x, 127.0, eps)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_int4_rows_plain(x: torch.Tensor, eps: float = 1e-8):
    """x [rows, n] (even n) -> (packed uint8 [rows, n/2], scale f32 [rows, 1])."""
    x32, scale = scale_rows(x, 7.0, eps)
    q = (torch.clamp(torch.round(x32 / scale), -8, 7) + 8).to(torch.uint8)
    return (q[:, 0::2] << 4) | q[:, 1::2], scale


def _launch(fn, x: torch.Tensor, out: torch.Tensor, eps: float):
    if x.dim() != 2 or x.stride(1) != 1:
        raise ValueError(f"expected [rows, n] with unit inner stride, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {x.dtype}")
    rows, n = x.shape
    scale = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), _DTYPE_CODE[x.dtype], rows, n, x.stride(0), eps,
            out.data_ptr(), scale.data_ptr(), stream)
    _build.check(_kernels(), rc, fn.__name__)
    return out, scale


def quantize_int8_rows(x: torch.Tensor, eps: float = 1e-8
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [rows, n] -> (q int8 [rows, n], scale f32 [rows, 1]): one symmetric
    scale max|x|/127 per row (see ops/quantization.py for the exact math)."""
    if x.device.type == "cpu":
        return quantize_int8_rows_plain(x, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    out = _launch(_kernels().elit_quantize_int8_rows, x, q, eps)
    quantize_int8_rows.launches += 1
    return out


def quantize_int4_rows(x: torch.Tensor, eps: float = 1e-8
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [rows, n] (even n) -> (packed uint8 [rows, n/2], scale f32
    [rows, 1]): scale max|x|/7, codes +8, even element in the high nibble."""
    if x.shape[-1] % 2:
        raise ValueError("int4 rows need an even row length")
    if x.device.type == "cpu":
        return quantize_int4_rows_plain(x, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    p = torch.empty((x.shape[0], x.shape[1] // 2), dtype=torch.uint8,
                    device=x.device)
    out = _launch(_kernels().elit_quantize_int4_rows, x, p, eps)
    quantize_int4_rows.launches += 1
    return out


quantize_int8_rows.launches = 0
quantize_int4_rows.launches = 0
