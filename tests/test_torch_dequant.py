"""The port's dequant kernels' wrappers (#5 `dequant_int8`, #6
`dequant_int4_packed`; ops/dequant.py) against the JAX package's Pallas
kernels in interpret mode, on the CPU (where the wrappers run their plain
versions), and the port's kernel API against the JAX one.

Bit-exact: both compute f32(code) * f32(scale) and round once to the output
type. Shapes: the JAX tests' (test_pallas_kernels.py: [6, 64] with a scalar
and a per-row scale, int4 at orig_last 64 and 63), a per-token scale
broadcast over heads as the KV cache keeps it ([L, 1, H, C, D] codes,
scales [L, C]), per-element int8 scales, and bf16/fp16/fp32 outputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efficient_llm_inference_tpu.ops import pallas as jpallas
from efficient_llm_inference_tpu.ops import quantization as jq
from efficient_llm_inference_tpu.ops.pallas import dequant as jdq
from efficient_llm_inference_tpu_torch import ops as tops
from efficient_llm_inference_tpu_torch.ops import dequant as tdq

OUT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16),
       "float16": (jnp.float16, torch.float16)}


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _codes8(rng, shape):
    return rng.integers(-127, 128, size=shape, dtype=np.int8)


@pytest.mark.parametrize("out", list(OUT))
@pytest.mark.parametrize("scale_kind", ["scalar", "per_row", "per_element"])
def test_dequant_int8_matches_jax(out, scale_kind):
    rng = np.random.default_rng(0)
    q = _codes8(rng, (6, 64))
    scale = {"scalar": np.float32(0.0123),
             "per_row": rng.uniform(0.001, 0.1, size=(6, 1)).astype(np.float32),
             "per_element": rng.uniform(0.001, 0.1, size=(6, 64)).astype(np.float32)
             }[scale_kind]
    jdt, tdt = OUT[out]
    want = jdq.dequant_int8(jnp.asarray(q), jnp.asarray(scale), jdt, interpret=True)
    got = tdq.dequant_int8(_t(q), _t(scale), tdt)
    assert got.dtype == tdt
    _same(got, want)
    # a Python float as the scale, as the JAX test passes it
    if scale_kind == "scalar":
        _same(tdq.dequant_int8(_t(q), float(scale), tdt), want)


@pytest.mark.parametrize("bits", [8, 4])
def test_dequant_matches_jax_on_a_cache_with_per_token_scales(bits):
    """The KV cache's layout: codes [L, 1, H, C, D(/2)], one scale per token
    [L, C] broadcast over the heads ([L, 1, 1, C, 1])."""
    rng = np.random.default_rng(1)
    L, H, C, D = 2, 3, 40, 64
    x = rng.normal(size=(L, 1, H, C, D)).astype(np.float32)
    quant = jq.quantize_int8 if bits == 8 else jq.quantize_int4_packed
    codes, scale = quant(jnp.asarray(x), axes=(1, 2, 4))  # one scale per (layer, token)
    s5 = jnp.asarray(scale)[:, None, None, :, None]
    if bits == 8:
        want = jdq.dequant_int8(codes, s5, jnp.bfloat16, interpret=True)
        got = tops.dequant_int8(_t(codes), _t(s5))
        ref = jq.dequantize_int8(codes, s5, jnp.bfloat16)
    else:
        want = jdq.dequant_int4_packed(codes, s5, D, jnp.bfloat16, interpret=True)
        got = tops.dequant_int4_packed(_t(codes), _t(s5), D)
        ref = jq.dequantize_int4_packed(codes, s5, jnp.bfloat16)
    _same(got, want)
    _same(got, ref)  # and the package's own dequantize


@pytest.mark.parametrize("out", list(OUT))
@pytest.mark.parametrize("orig_last", [64, 63, 5])
def test_dequant_int4_matches_jax(out, orig_last):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, orig_last)).astype(np.float32)
    packed, scale = jq.quantize_int4_packed(
        jnp.asarray(np.pad(x, ((0, 0), (0, orig_last % 2)))), axes=(1,))
    jdt, tdt = OUT[out]
    s = jnp.asarray(scale)[:, None]
    want = jdq.dequant_int4_packed(packed, s, orig_last, jdt, interpret=True)
    got = tdq.dequant_int4_packed(_t(packed), _t(s), orig_last, tdt)
    assert got.shape == (5, orig_last) and got.dtype == tdt
    _same(got, want)


def test_dequant_int4_scalar_scale_and_natural_order():
    """A scalar scale (the reference's semantics); element 2j is the high
    nibble of byte j, element 2j + 1 the low one."""
    packed = np.array([[0x0F, 0x80, 0x7A]], dtype=np.uint8)
    want = jdq.dequant_int4_packed(jnp.asarray(packed), 0.5, 6, jnp.float32, interpret=True)
    got = tdq.dequant_int4_packed(_t(packed), 0.5, 6, torch.float32)
    _same(got, want)
    assert got.tolist() == [[-4.0, 3.5, 0.0, -4.0, -0.5, 1.0]]


def test_dequant_int4_refuses_a_scale_along_the_last_axis():
    packed = torch.zeros((2, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="constant along the last axis"):
        tdq.dequant_int4_packed(packed, torch.ones(2, 16), 16)
    with pytest.raises(ValueError, match="orig_last_dim"):
        tdq.dequant_int4_packed(packed, 1.0, 17)


@pytest.mark.parametrize("lead,scale_shape", [
    ((2, 1, 3, 40), (2, 1, 1, 40, 1)),  # per token, broadcast over heads
    ((6,), (6, 1)), ((6,), ()), ((4, 5), (1, 5, 1)), ((4, 5), (4, 1, 1)),
    ((2, 3, 4, 5, 6), (2, 1, 4, 1, 6, 1)),  # five dims: collapsed, or copied
])
def test_scale_index_addresses_every_row(lead, scale_shape):
    """The kernel's row -> scale address (sizes and strides of the scale's
    collapsed leading dims, inner first) reproduces the broadcast."""
    s = torch.arange(1, 1 + int(np.prod(scale_shape)), dtype=torch.float32).reshape(scale_shape)
    view, nd, sizes, strides = tdq._scale_index(s, lead)
    assert 1 <= nd <= 4
    flat = view.as_strided((view.untyped_storage().nbytes() // 4,), (1,), 0)
    want = torch.broadcast_to(s, (*lead, 1)).reshape(-1)
    for r in range(want.numel()):
        off, rr = view.storage_offset(), r
        for i in range(nd - 1):
            off += (rr % sizes[i]) * strides[i]
            rr //= sizes[i]
        off += rr * strides[nd - 1]
        assert flat[off] == want[r], (r, off)


def test_kernel_api_exports_the_jax_names():
    """efficient_llm_inference_tpu_torch.ops exports the names of the JAX
    package's ops.pallas (its __init__.py), each beside a plain version."""
    want = {n for n in vars(jpallas) if not n.startswith("_") and callable(getattr(jpallas, n))}
    got = {n for n in vars(tops) if not n.startswith("_") and callable(getattr(tops, n))}
    assert want == {"fused_quant_attention_decode", "dequant_int8", "dequant_int4_packed",
                    "pallas_linear", "pallas_linear_int8", "quantize_weight_int8",
                    "paged_attention_decode", "quantize_int8_rows", "quantize_int4_rows"}
    assert want <= got
    for name in want - {"quantize_weight_int8"}:  # a plain function in both packages
        fn = getattr(tops, name)
        module = __import__(fn.__module__, fromlist=["_"])
        assert hasattr(module, f"{name}_plain"), name
        assert isinstance(fn.launches, int), name
