"""The port's per-row quantize (ops/quantize.py) against the JAX package's
Pallas kernels in interpret mode, and QuantizedKV's write-side quantize
against the JAX cache's: codes and scales bit-exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficient_llm_inference_tpu.cache.kvcache import QuantizedKV as JaxQuantizedKV
from efficient_llm_inference_tpu.ops.pallas import quantize as jrows
from efficient_llm_inference_tpu_torch.cache.kvcache import QuantizedKV
from efficient_llm_inference_tpu_torch.ops import quantize as trows


def _rows(rows, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, n)).astype(np.float32)
    x *= rng.uniform(0.01, 8.0, (rows, 1)).astype(np.float32)
    x[0] = 0.0  # an all-zero row takes the eps scale
    return x


@pytest.mark.parametrize("rows,n", [(1, 768), (12, 64), (37, 48), (8, 2)])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_plain_matches_pallas(rows, n, bits, dtype):
    x = _rows(rows, n, seed=rows + n + bits)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    if bits == 8:
        jcodes, jscale = jrows.quantize_int8_rows(jx, interpret=True)
        tcodes, tscale = trows.quantize_int8_rows_plain(tx)
    else:
        jcodes, jscale = jrows.quantize_int4_rows(jx, interpret=True)
        tcodes, tscale = trows.quantize_int4_rows_plain(tx)
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))


@pytest.mark.parametrize("bits", [8, 4])
def test_wrapper_takes_plain_version_on_cpu(bits):
    wrapper = trows.quantize_int8_rows if bits == 8 else trows.quantize_int4_rows
    plain = (trows.quantize_int8_rows_plain if bits == 8
             else trows.quantize_int4_rows_plain)
    # rows of a wider buffer (row stride 3n), as the engine passes them
    x = torch.from_numpy(_rows(5, 96, seed=3))[:, 32:64]
    before = wrapper.launches
    got, want = wrapper(x), plain(x.contiguous())
    assert wrapper.launches == before  # no kernel ran
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("granularity", ["per_token", "per_head"])
@pytest.mark.parametrize("T", [1, 5])
def test_cache_write_matches_jax(kind, granularity, T):
    """QuantizedKV quantizes a [1, H, T, D] block through the rows path; the
    JAX cache (under jit, as its engine runs it) quantizes it with reduction
    axes. Same codes and scales."""
    H, D = 3, 16
    x = np.random.default_rng(T).standard_normal((1, H, T, D)).astype(np.float32)
    kw = dict(n_layer=1, n_head=H, head_dim=D, capacity=8,
              granularity=granularity)
    jkv = JaxQuantizedKV(**kw, fused=False)
    tkv = QuantizedKV(**kw, device="cpu")
    jcodes, jscale = jax.jit(lambda a: jkv._quantize_block(a, kind))(
        jnp.asarray(x))
    tcodes, tscale = tkv._quantize_block(torch.from_numpy(x), kind)
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
