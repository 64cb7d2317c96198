"""Weight-streaming linear (GEMV / skinny GEMM) for a few rows.

Port of efficient_llm_inference_tpu/ops/pallas/linear.py (`pallas_linear`,
`pallas_linear_int8`, `quantize_weight_int8`). On a CUDA tensor each linear
wrapper launches its kernel of `csrc/linear.cu`: two bf16 operands go to
the tensor cores (`csrc/gemm_rows_tc.cuh`: every weight read once for up to
256 rows, the K split fixed by (E, F)); a pair with an fp32 operand and the
int8 codes to the CUDA cores (a partial pass over column strips and slices
of E, then an ordered sum of the partials). `launch_plan` says which. On a
CPU tensor each runs the plain PyTorch version beside it. Launches are
counted in `<wrapper>.launches`. The layout is JAX's: x [B, E], w [E, F]
(the port's own [L, E, F] parameters, one layer sliced, are in it too).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from . import _gemm_rows

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_WARPS, _STRIP = 8, 256  # csrc/linear.cu: warps a block, columns a block
_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("linear")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.elit_linear.restype = i
        # x_dtype, w_dtype, x, B, E, w, F, ec, vec, part, out, stream
        lib.elit_linear.argtypes = [i, i, p, i, i, p, i, i, i, p, p, p]
        lib.elit_linear_int8.restype = i
        # x_dtype, x, B, E, w_q, F, scale, ec, vec, part, out, stream
        lib.elit_linear_int8.argtypes = [i, p, i, i, p, i, p, i, i, p, p, p]
        lib.elit_linear_bf16.restype = i
        # x, B, E, w, F, x_aligned, w_aligned, part, part_len, counters, out, stream
        lib.elit_linear_bf16.argtypes = [p, i, i, p, i, i, i, p, ctypes.c_longlong, p, p, p]
        _lib = lib
    return _lib


def _rows_a_warp(E: int, F: int, device) -> int:
    """ec, the rows of E a warp walks: 64, halved (down to 8) while the grid
    has fewer than two blocks an SM."""
    strips = -(-F // _STRIP)
    target = 2 * torch.cuda.get_device_properties(device).multi_processor_count
    ec = 64
    while ec > 8 and strips * -(-E // (_WARPS * ec)) < target:
        ec //= 2
    return ec


def _check(x: torch.Tensor, w: torch.Tensor, w_dtypes) -> Tuple[int, int, int]:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)}: expected [B, E] "
                         "and [E, F]")
    if x.dtype not in _DTYPE_CODE or w.dtype not in w_dtypes:
        raise TypeError(f"no kernel for x {x.dtype}, w {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()) or x.device != w.device:
        raise ValueError("x and w must be contiguous and on one device")
    return x.shape[0], x.shape[1], w.shape[1]


def _launch(fn, x, w, scale, B, E, F, elem, extra):
    """One kernel call: the partials' scratch, ec, the 16-byte row path
    (F % 8 == 0 and an aligned w) and the output in x's dtype."""
    out = torch.empty((B, F), dtype=x.dtype, device=x.device)
    if B == 0 or F == 0:
        return out
    ec = _rows_a_warp(E, F, x.device)
    ks = max(1, -(-E // (_WARPS * ec)))
    part = torch.empty(ks * B * F, dtype=torch.float32, device=x.device)
    vec = int(F % 8 == 0 and w.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(*extra, x.data_ptr(), B, E, w.data_ptr(), F,
            *([scale.data_ptr()] if scale is not None else []), ec, vec, part.data_ptr(),
            out.data_ptr(), stream)
    _build.check(_kernels(), rc, elem)
    return out


def launch_plan(B: int, E: int, F: int, x_dtype: torch.dtype,
                w_dtype: torch.dtype) -> dict:
    """How `pallas_linear` computes [B, E] x [E, F] on the card: the route
    ("tensor_cores" for two bf16 operands, else "cuda_cores"), and for the
    tensor cores the K-split count (a function of (E, F) alone) and the fp32
    scratch floats of its partials (rows in groups of 256)."""
    if x_dtype == torch.bfloat16 and w_dtype == torch.bfloat16:
        return {"route": "tensor_cores", "splits": _gemm_rows.split_count(F, E),
                "part_floats": _gemm_rows.part_floats(F, E, B)}
    return {"route": "cuda_cores"}


def _launch_bf16(x, w, B, E, F):
    """The tensor-core route: bf16 out, the split partials' scratch, and
    whether the rows of x and w are 16-byte aligned (cp.async) or not
    (element loads)."""
    out = torch.empty((B, F), dtype=x.dtype, device=x.device)
    if B == 0 or F == 0:
        return out
    n = _gemm_rows.part_floats(F, E, B)
    part = torch.empty(max(n, 1), dtype=torch.float32, device=x.device)
    x_al = int(E % 8 == 0 and x.data_ptr() % 16 == 0)
    w_al = int(F % 8 == 0 and w.data_ptr() % 16 == 0)
    lib = _kernels()
    rc = lib.elit_linear_bf16(x.data_ptr(), B, E, w.data_ptr(), F, x_al, w_al, part.data_ptr(),
                              n, _gemm_rows.tile_counters(x.device).data_ptr(), out.data_ptr(),
                              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "pallas_linear")
    return out


def pallas_linear_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x @ w with both promoted to fp32 and the sum
    in fp32 (JAX's dot_general with preferred fp32), cast to x.dtype."""
    return (x.float() @ w.float()).to(x.dtype)


def pallas_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [B, E]; w: [E, F] -> [B, F] in x.dtype, fp32 accumulation. x and w
    may each be fp32 or bf16 (a mixed pair computes in fp32). On a CUDA
    tensor it launches `csrc/linear.cu` (two bf16 operands on the tensor
    cores, else the CUDA cores: `launch_plan`) and counts one launch in
    `pallas_linear.launches`; on a CPU tensor it runs `pallas_linear_plain`."""
    if x.device.type == "cpu":
        return pallas_linear_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    B, E, F = _check(x, w, _DTYPE_CODE)
    if launch_plan(B, E, F, x.dtype, w.dtype)["route"] == "tensor_cores":
        out = _launch_bf16(x, w, B, E, F)
    else:
        out = _launch(_kernels().elit_linear, x, w, None, B, E, F, "pallas_linear",
                      (_DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype]))
    pallas_linear.launches += 1
    return out


def pallas_linear_int8_plain(x: torch.Tensor, w_q: torch.Tensor,
                             w_scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, at the JAX kernel's rounding points: x rounded
    to bf16, the codes exact, an fp32 sum, times the column scales in fp32,
    cast to x.dtype."""
    xb = x.to(torch.bfloat16).float()
    return ((xb @ w_q.float()) * w_scale.float()).to(x.dtype)


def pallas_linear_int8(x: torch.Tensor, w_q: torch.Tensor,
                       w_scale: torch.Tensor) -> torch.Tensor:
    """x: [B, E]; w_q: [E, F] int8; w_scale: [1, F] fp32 -> [B, F] in
    x.dtype (the rounding points of `pallas_linear_int8_plain`). On a CUDA
    tensor it launches `csrc/linear.cu` and counts one launch in
    `pallas_linear_int8.launches`; on a CPU tensor it runs
    `pallas_linear_int8_plain`."""
    if x.device.type == "cpu":
        return pallas_linear_int8_plain(x, w_q, w_scale)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    B, E, F = _check(x, w_q, (torch.int8,))
    if w_scale.dtype != torch.float32 or w_scale.numel() != F \
            or not w_scale.is_contiguous() or w_scale.device != x.device:
        raise ValueError(f"w_scale: expected contiguous float32 [1, {F}] on {x.device}")
    lib = _kernels()
    out = _launch(lib.elit_linear_int8, x, w_q, w_scale, B, E, F, "pallas_linear_int8",
                  (_DTYPE_CODE[x.dtype],))
    pallas_linear_int8.launches += 1
    return out


def quantize_weight_int8(w: torch.Tensor, axis: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 weight quantization: w [E, F] ->
    (w_q int8 [E, F], scale fp32 [1, F]), reducing over `axis` (the
    contraction axis): scale = max(max|w| / 127, 1e-8), w_q =
    clamp(round_half_even(w / scale), -127, 127).

    Bit-exact in codes and scales with the JAX function called op by op (as
    the JAX tests call it), which divides by 127. Under jax.jit, XLA turns
    that division into max|w| * f32(1/127), which differs in the last bit of
    some scales (and then, rarely, in a code); this function does not follow
    the jitted form (ops/quantization.py does, for the KV cache's scales).
    A plain PyTorch function: it runs on the tensor's device.
    """
    w32 = w.float()
    max_abs = torch.amax(w32.abs(), dim=axis, keepdim=True)
    scale = torch.clamp(max_abs / 127.0, min=1e-8)
    w_q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return w_q, scale


pallas_linear.launches = 0
pallas_linear_int8.launches = 0
