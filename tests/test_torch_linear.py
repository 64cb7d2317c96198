"""The port's weight-streaming linear wrappers (#7 `pallas_linear`, #8
`pallas_linear_int8`; ops/linear.py) and `quantize_weight_int8` against the
JAX package's (Pallas kernels in interpret mode), on the CPU, where the
wrappers run their plain versions.

Tolerances: `quantize_weight_int8` is bit-exact in codes and scales with the
JAX function called op by op (the JAX tests' form); under jax.jit the JAX
scales are max|w| * f32(1/127), which the test checks apart. The linears
agree within 2e-5 (relative to the output's largest value, at least 1) in
fp32: both sum fp32 products of the same values, in another order (the
int8 form's products bf16(x) * code are exact in fp32). Shapes: the JAX
tests' ([1, 64] x [64, 256], [4, 128] x [128, 512], int8 [2, 64] x
[64, 256]), a ragged F (the JAX kernel takes it as one tile), B past 8 rows,
and the mixed fp32/bf16 pairs, which JAX computes in fp32. The card route's
host plan (`launch_plan`: the tensor cores for two bf16 operands, their
K-split count and scratch) is held to a table: the split count depends on
(E, F) alone, never on B.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficient_llm_inference_tpu.ops.pallas import linear as jlin
from efficient_llm_inference_tpu_torch.ops import _gemm_rows
from efficient_llm_inference_tpu_torch.ops import linear as tlin

SHAPES = [(1, 64, 256), (4, 128, 512), (3, 96, 77), (9, 64, 200)]


def _close(got: torch.Tensor, want, tol: float = 2e-5) -> None:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def _inputs(B, E, F, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, E)).astype(np.float32),
            rng.normal(size=(E, F)).astype(np.float32))


@pytest.mark.parametrize("B,E,F", SHAPES)
def test_pallas_linear_matches_jax(B, E, F):
    x, w = _inputs(B, E, F, seed=B + E)
    want = jlin.pallas_linear(jnp.asarray(x), jnp.asarray(w), interpret=True)
    got = tlin.pallas_linear(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("x_dt,w_dt", [("float32", "bfloat16"), ("bfloat16", "float32"),
                                       ("bfloat16", "bfloat16")])
def test_pallas_linear_dtypes_match_jax(x_dt, w_dt):
    """bf16 operands: JAX promotes a mixed pair to fp32 and returns x's
    dtype; the same bf16 values go to both sides, so the fp32 sums agree to
    2e-5 before the output's rounding, and a bf16 output within one ulp."""
    x, w = _inputs(4, 128, 512, seed=7)
    jx = jnp.asarray(x).astype(getattr(jnp, x_dt))
    jw = jnp.asarray(w).astype(getattr(jnp, w_dt))
    want = jlin.pallas_linear(jx, jw, interpret=True)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, x_dt))
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(getattr(torch, w_dt))
    got = tlin.pallas_linear(tx, tw)
    assert got.dtype == getattr(torch, x_dt) and str(want.dtype) == x_dt
    _close(got, want, tol=2e-5 if x_dt == "float32" else 2 ** -8)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,E,F", [(16, 96, 77), (64, 100, 200), (16, 200, 136),
                                   (64, 48, 50)])
def test_pallas_linear_rows_and_ragged_edges_match_jax(B, E, F, dt):
    """B past the tensor-core route's n8 tiles (16, 64 rows), a ragged F and
    an E that is not a multiple of 16, for the pairs of each route (bf16 x
    bf16: tensor cores; fp32: CUDA cores), against JAX's kernel in
    interpret mode."""
    x, w = _inputs(B, E, F, seed=B + E + F)
    jx, jw = (jnp.asarray(a).astype(getattr(jnp, dt)) for a in (x, w))
    want = jlin.pallas_linear(jx, jw, interpret=True)
    tx, tw = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dt))
              for a in (jx, jw))
    got = tlin.pallas_linear(tx, tw)
    assert got.dtype == getattr(torch, dt)
    _close(got, want, tol=2e-5 if dt == "float32" else 2 ** -8)


# (E, F) -> the tensor-core route's K splits: about 132 blocks over tiles of
# 128 outputs (1 from 67 tiles: GPT-2's LM head, Llama's gate/up), at most 4
# splits of at least 4 stages of 64 inputs
SPLITS = {(2048, 8192): 2, (768, 50257): 1, (96, 77): 1, (100, 200): 1, (8192, 2048): 4,
          (3072, 768): 4, (768, 3072): 3, (2048, 16384): 1, (2048, 3072): 4}


@pytest.mark.parametrize("E,F", list(SPLITS))
def test_launch_plan_table(E, F):
    """The route per dtype pair, and the tensor cores' split count and
    scratch floats: the same split count at every B (a row's sums do not
    depend on the rows beside it), scratch for at most 256 rows a launch."""
    for B in (1, 2, 8, 9, 64, 256, 300):
        plan = tlin.launch_plan(B, E, F, torch.bfloat16, torch.bfloat16)
        S = SPLITS[(E, F)]
        tiles = -(-F // 128)
        assert plan == {"route": "tensor_cores", "splits": S,
                        "part_floats": S * min(B, 256) * tiles * 128 if S > 1 else 0}
        assert _gemm_rows.split_count(F, E) == S
        for pair in ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                     (torch.bfloat16, torch.float32)):
            assert tlin.launch_plan(B, E, F, *pair) == {"route": "cuda_cores"}


@pytest.mark.parametrize("B,E,F", SHAPES)
def test_pallas_linear_int8_matches_jax(B, E, F):
    x, w = _inputs(B, E, F, seed=B * E)
    w_q, w_s = jlin.quantize_weight_int8(jnp.asarray(w))
    want = jlin.pallas_linear_int8(jnp.asarray(x), w_q, w_s, interpret=True)
    got = tlin.pallas_linear_int8(torch.from_numpy(x), torch.from_numpy(np.array(w_q)),
                                  torch.from_numpy(np.array(w_s)))
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("shape,axis", [((64, 256), 0), ((96, 77), 0), ((64, 128), 1)])
def test_quantize_weight_int8_bit_exact(shape, axis):
    rng = np.random.default_rng(sum(shape) + axis)
    w = rng.normal(size=shape).astype(np.float32)
    w[:, 3 if axis == 0 else 0] = 0.0  # an all-zero channel: the 1e-8 floor
    if axis == 1:
        w[3] = 0.0
    jq_, js = jlin.quantize_weight_int8(jnp.asarray(w), axis=axis)
    tq, ts = tlin.quantize_weight_int8(torch.from_numpy(w), axis=axis)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_weight_int8_jitted_form():
    """Under jax.jit the JAX scale is max|w| * f32(1/127): the port follows
    the op-by-op division, and the two differ in the last bit of some
    scales; each form's codes follow from its own scales."""
    rng = np.random.default_rng(11)
    w = rng.normal(size=(64, 512)).astype(np.float32)
    jit_q, jit_s = jax.jit(jlin.quantize_weight_int8)(jnp.asarray(w))
    w32 = torch.from_numpy(w)
    mul_s = torch.clamp(w32.abs().amax(0, keepdim=True) * np.float32(1 / 127), min=1e-8)
    np.testing.assert_array_equal(np.asarray(jit_s), mul_s.numpy())
    mul_q = torch.clamp(torch.round(w32 / mul_s), -127, 127).to(torch.int8)
    np.testing.assert_array_equal(np.asarray(jit_q), mul_q.numpy())
    _, ts = tlin.quantize_weight_int8(w32)
    differ = int((ts != mul_s).sum())
    assert 0 < differ < ts.numel(), differ  # some scales, never most
    np.testing.assert_allclose(ts.numpy(), mul_s.numpy(), rtol=2 ** -23, atol=0)
