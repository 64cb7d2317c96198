"""The port's ops/quantization.py against the JAX package's: codes and
scales bit-exact, dequantized values identical.

The JAX functions run under jit, as the JAX engine runs them: there XLA
turns the division by the constant qmax into a multiply by its float32
reciprocal, which the port reproduces (op-by-op JAX divides, and differs in
the last bit of some scales)."""

import functools

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efficient_llm_inference_tpu.ops import quantization as jq
from efficient_llm_inference_tpu_torch.ops import quantization as tq

CASES = [
    ((2, 3, 5, 16), (0, 1, 3)),  # one scale per token over [B, H, D]
    ((2, 3, 5, 16), (0, 3)),  # per (head, token)
    ((1, 4, 7, 15), (0, 1, 3)),  # odd D: int4 pads one lane
    ((6, 9), (-1,)),  # per row
    ((3, 8), ()),  # per element
]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.1, 4.0)).astype(np.float32)
    x.reshape(-1)[0] = 0.0
    return x


@pytest.mark.parametrize("shape,axes", CASES)
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_matches_jax_bit_exact(shape, axes, bits):
    x = _inputs(shape, seed=len(shape) * 10 + bits)
    jfn, tfn = ((jq.quantize_int8, tq.quantize_int8) if bits == 8 else
                (jq.quantize_int4_packed, tq.quantize_int4_packed))
    jcodes, jscale = jax.jit(functools.partial(jfn, axes=axes))(jnp.asarray(x))
    tcodes, tscale = tfn(torch.from_numpy(x), axes=axes)
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    assert tcodes.dtype == (torch.int8 if bits == 8 else torch.uint8)
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))


@pytest.mark.parametrize("shape,axes", CASES)
@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_matches_jax(shape, axes, bits):
    x = _inputs(shape, seed=7 + bits)
    jfn = jq.quantize_int8 if bits == 8 else jq.quantize_int4_packed
    codes, scale = jax.jit(functools.partial(jfn, axes=axes))(jnp.asarray(x))
    # re-insert the reduced axes so the scale broadcasts
    s = np.asarray(scale)
    for a in sorted(a % len(shape) for a in axes):
        s = np.expand_dims(s, a)
    if bits == 8:
        want = jq.dequantize_int8(codes, jnp.asarray(s))
        got = tq.dequantize_int8(torch.tensor(np.asarray(codes)),
                                 torch.tensor(s))
    else:
        want = jq.dequantize_int4_packed(codes, jnp.asarray(s),
                                         orig_last_dim=shape[-1])
        got = tq.dequantize_int4_packed(torch.tensor(np.asarray(codes)),
                                        torch.tensor(s),
                                        orig_last_dim=shape[-1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unpack_int4_matches_jax():
    packed = np.arange(256, dtype=np.uint8).reshape(4, 64)
    want = jq.unpack_int4(jnp.asarray(packed))
    got = tq.unpack_int4(torch.from_numpy(packed))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int8


def test_round_half_to_even_at_ties():
    # max|x| = 127 -> scale 1, so x / scale lands exactly on .5 ties
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]], np.float32)
    jcodes, _ = jax.jit(functools.partial(jq.quantize_int8, axes=(-1,)))(
        jnp.asarray(x))
    tcodes, _ = tq.quantize_int8(torch.from_numpy(x), axes=(-1,))
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    assert tcodes.tolist() == [[127, 0, 2, 2, 0, -2, -2, 4]]
