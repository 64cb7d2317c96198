"""The port's plain fused_quant_attention_batched against the JAX package's
Pallas kernel in interpret mode (fp32, atol 1e-5: the two sum the same
terms in a different order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efficient_llm_inference_tpu.ops.pallas.attention import (
    fused_quant_attention_batched as jax_attention,
)
from efficient_llm_inference_tpu.ops.quantization import (
    quantize_int4_packed,
    quantize_int8,
)
from efficient_llm_inference_tpu_torch.ops import attention as tattn


def _quantized(x, bits):
    """Codes and per-(slot, head, token) scales of x [B, Hkv, C, D]."""
    if bits == 16:
        return x, np.ones(x.shape[:3], np.float32)
    fn = quantize_int8 if bits == 8 else quantize_int4_packed
    codes, scale = fn(jnp.asarray(x), axes=(3,))
    return np.asarray(codes), np.asarray(scale)


def _case(k_bits, v_bits, B, G, seed, C=16, S=2, Hkv=2, D=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hkv * G, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Hkv, C, D)).astype(np.float32)
            for _ in range(2))
    k_ex, v_ex = (rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
                  for _ in range(2))
    kq, ks = _quantized(k, k_bits)
    vq, vs = _quantized(v, v_bits)
    lengths = np.array([0, C - 1, 5, C][:B], np.int32)
    return q, kq, ks, vq, vs, k_ex, v_ex, lengths


@pytest.mark.parametrize("k_bits,v_bits", [(8, 8), (4, 4), (8, 4), (16, 16)])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("n_extra", [1, 2])
def test_plain_matches_pallas(k_bits, v_bits, B, G, n_extra):
    args = _case(k_bits, v_bits, B, G, seed=k_bits * 7 + v_bits + B + G)
    want = jax_attention(*(jnp.asarray(a) for a in args), jnp.int32(n_extra),
                         k_bits=k_bits, v_bits=v_bits, interpret=True)
    got = tattn.fused_quant_attention_batched_plain(
        *(torch.tensor(a) for a in args), n_extra,
        k_bits=k_bits, v_bits=v_bits)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("k_bits,v_bits", [(8, 8), (4, 4)])
def test_wrapper_takes_plain_version_on_cpu(k_bits, v_bits):
    args = [torch.tensor(a) for a in _case(k_bits, v_bits, 2, 2, seed=5)]
    before = tattn.fused_quant_attention_batched.launches
    got = tattn.fused_quant_attention_batched(*args, 1, k_bits=k_bits,
                                              v_bits=v_bits)
    assert tattn.fused_quant_attention_batched.launches == before
    want = tattn.fused_quant_attention_batched_plain(*args, 1, k_bits=k_bits,
                                                     v_bits=v_bits)
    assert torch.equal(got, want)


def test_zero_length_slot_attends_extra_only():
    """With no past row visible, the output is the softmax over the extra
    rows alone, whatever the past rows hold."""
    q, kq, ks, vq, vs, k_ex, v_ex, _ = _case(8, 8, 1, 1, seed=9)
    lengths = np.zeros(1, np.int32)
    got = tattn.fused_quant_attention_batched_plain(
        *(torch.tensor(a) for a in (q, kq, ks, vq, vs, k_ex, v_ex, lengths)),
        2).numpy()
    s = np.einsum("bhd,bhsd->bhs", q, k_ex) / np.sqrt(q.shape[-1])
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    np.testing.assert_allclose(got, np.einsum("bhs,bhsd->bhd", p, v_ex),
                               atol=1e-6)
