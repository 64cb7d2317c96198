"""The port's batch-1 fused decode attention wrapper (#4
`fused_quant_attention_decode`; ops/attention.py) against the JAX package's
Pallas kernel in interpret mode, on the CPU, where the wrapper runs its plain
version, and against the port's batched form (#1) at B = 1.

Tolerance 2e-5 in fp32 (absolute and relative): the JAX kernel dequantizes
K before the dot product (q . (k * s)) where the port scales the dot
((q . k) * s), and the sums run in another order. Cases: the JAX test's
(C = 48, D = 64, length 37) for every k/v bits pair, GQA (8, 2), length 0
(the current token alone: its V), a length past C, and per-token scales
broadcast over the heads as the cache keeps them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efficient_llm_inference_tpu.ops import quantization as jq
from efficient_llm_inference_tpu.ops.pallas import attention as jattn
from efficient_llm_inference_tpu_torch.ops import attention as tattn

TOL = 2e-5
BITS = [(8, 8), (4, 4), (8, 4), (4, 8)]


def _case(k_bits, v_bits, Hq, Hkv, C=48, D=64, seed=5, per_token=False):
    rng = np.random.default_rng(seed)
    k_fp = rng.normal(size=(Hkv, C, D)).astype(np.float32)
    v_fp = rng.normal(size=(Hkv, C, D)).astype(np.float32)

    def quant(x, bits):
        fn = jq.quantize_int8 if bits == 8 else jq.quantize_int4_packed
        if per_token:  # one scale per token over the heads, broadcast back
            q_, s = fn(jnp.asarray(x), axes=(0, 2))
            return q_, jnp.broadcast_to(s[None], (Hkv, C))
        return fn(jnp.asarray(x), axes=(2,))

    k_q, k_s = quant(k_fp, k_bits)
    v_q, v_s = quant(v_fp, v_bits)
    q = rng.normal(size=(Hq, D)).astype(np.float32)
    k_cur = rng.normal(size=(Hkv, D)).astype(np.float32)
    v_cur = rng.normal(size=(Hkv, D)).astype(np.float32)
    return [np.array(a) for a in (q, k_q, k_s, v_q, v_s, k_cur, v_cur)]


def _run(case, length, k_bits, v_bits):
    want = jattn.fused_quant_attention_decode(
        *(jnp.asarray(a) for a in case), length, k_bits=k_bits, v_bits=v_bits,
        interpret=True)
    got = tattn.fused_quant_attention_decode(*(torch.from_numpy(a) for a in case), length,
                                             k_bits=k_bits, v_bits=v_bits)
    return got, np.asarray(want)


@pytest.mark.parametrize("length", [37, 0, 48, 60])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("k_bits,v_bits", BITS)
def test_decode_attention_matches_jax(k_bits, v_bits, Hq, Hkv, length):
    case = _case(k_bits, v_bits, Hq, Hkv)
    got, want = _run(case, length, k_bits, v_bits)
    assert got.dtype == torch.float32 and got.shape == (Hq, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    if length == 0:  # the current token alone
        v_cur = np.repeat(case[6], Hq // Hkv, axis=0)
        np.testing.assert_allclose(got.numpy(), v_cur, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("k_bits,v_bits", BITS)
def test_decode_attention_per_token_scales_and_tensor_length(k_bits, v_bits):
    case = _case(k_bits, v_bits, 8, 2, per_token=True, seed=9)
    want = jattn.fused_quant_attention_decode(
        *(jnp.asarray(a) for a in case), jnp.int32(21), k_bits=k_bits, v_bits=v_bits,
        interpret=True)
    got = tattn.fused_quant_attention_decode(
        *(torch.from_numpy(a) for a in case), torch.tensor([21], dtype=torch.int32),
        k_bits=k_bits, v_bits=v_bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("length", [0, 19, 48])
@pytest.mark.parametrize("k_bits,v_bits", BITS)
def test_decode_attention_is_the_batched_form_at_batch_one(k_bits, v_bits, length):
    """#4 equals #1 at B = 1 with the current token as the one extra row."""
    q, k_q, k_s, v_q, v_s, k_cur, v_cur = (torch.from_numpy(a) for a in
                                           _case(k_bits, v_bits, 8, 2, seed=13))
    got = tattn.fused_quant_attention_decode(q, k_q, k_s, v_q, v_s, k_cur, v_cur, length,
                                             k_bits=k_bits, v_bits=v_bits)
    batched = tattn.fused_quant_attention_batched(
        q[None], k_q[None], k_s[None], v_q[None], v_s[None], k_cur[None, :, None],
        v_cur[None, :, None], torch.tensor([length], dtype=torch.int32), 1,
        k_bits=k_bits, v_bits=v_bits)[0]
    assert torch.equal(got, batched)
