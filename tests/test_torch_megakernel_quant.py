"""The port's quantized-KV megakernel (ops/megakernel_quant.py) against the
JAX package's, on the CPU in fp32, at the JAX tests' geometry (E=256, L=2,
H=2, V=300, C=48) for int8, int4 and mixed panes.

* The port's plain step against the JAX kernel (Pallas interpret mode under
  jit) on the same numpy-made weights, panes, scales and embedding: the
  token is equal and every row but the new one is bit-identical. The new
  row's scales agree to rtol 1e-6 and its codes to one step: the K/V
  projection is an fp32 sum of E terms taken in another order, which can
  move max|x| by a few ulp.
* Quantize-on-write bit for bit: with the K and V projection weights zeroed,
  the new K/V rows are the biases exactly on both sides, and the written
  codes (half-split int4 bytes included) and scales are bit-exact.
* The layout helpers (`to_mega_quant_layout`, `unpack_halves`) round-trip
  bit-exact against JAX, and a port engine with megakernel=True gives the
  JAX engine's greedy tokens.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efficient_llm_inference_tpu.core.config import Config as JaxConfig
from efficient_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine
from efficient_llm_inference_tpu.models import gpt2 as jgpt2
from efficient_llm_inference_tpu.models.registry import gpt2_spec as jax_gpt2_spec
from efficient_llm_inference_tpu.ops.pallas import megakernel as jmk
from efficient_llm_inference_tpu.ops.pallas import megakernel_quant as jmq
from efficient_llm_inference_tpu_torch import Config, InferenceEngine
from efficient_llm_inference_tpu_torch.models import gpt2 as tgpt2
from efficient_llm_inference_tpu_torch.models.registry import gpt2_spec
from efficient_llm_inference_tpu_torch.ops import megakernel as tmk
from efficient_llm_inference_tpu_torch.ops import megakernel_quant as tmq
from torch_port_helpers import np_gpt2_params, to_jax

CFG_KW = dict(vocab_size=300, n_positions=256, n_embd=256, n_layer=2, n_head=2)
E, L, C = CFG_KW["n_embd"], CFG_KW["n_layer"], 48
MODES = ["int8", "int4", "mixed"]


@pytest.fixture(scope="module")
def cfgs():
    return jgpt2.GPT2Config(**CFG_KW), tgpt2.GPT2Config(**CFG_KW)


@pytest.fixture(scope="module")
def np_params(cfgs):
    return np_gpt2_params(cfgs[1], seed=21, std=0.1)


def _packed(np_params, cfgs):
    jcfg, tcfg = cfgs
    tparams = tgpt2.params_from_jax(np_params, tcfg, torch.float32, "cpu")
    return (jmk.pack_gpt2_mega(to_jax(np_params), jcfg),
            tmk.pack_gpt2_mega(tparams, tcfg))


def _state(mode: str, seed: int):
    """Random panes (valid codes), per-token scales and an embedding."""
    rng = np.random.default_rng(seed)
    k_kind, v_kind = tmq._kv_kinds(mode)

    def pane(kind):
        lo = -127 if kind == "int8" else -128
        return rng.integers(lo, 128, (L, C, tmq._pane_width(kind, E))).astype(np.int8)

    def scales():
        return (rng.random((L, C)) * 0.02 + 1e-3).astype(np.float32)

    x = (rng.standard_normal((1, E)) * 0.5).astype(np.float32)
    return [pane(k_kind), pane(v_kind), scales(), scales()], x


def _steps(mode, length, packed, cfgs, state, x):
    jcfg, tcfg = cfgs
    jp, tp = packed
    j = jmq.gpt2_megastep_quant(
        jp, *(jnp.asarray(a) for a in state), jnp.int32(length), jnp.asarray(x),
        cfg=jcfg, capacity=C, kv_mode=mode, interpret=True)
    t_in = [torch.tensor(a) for a in state]
    t = tmq.gpt2_megastep_quant(tp, *t_in, length, torch.tensor(x), cfg=tcfg,
                                kv_mode=mode)
    assert all(a is b for a, b in zip(t[1:], t_in))  # written in place
    return [np.asarray(a) for a in j], [a.numpy() for a in t]


@pytest.mark.parametrize("length", [0, 7, C - 1])
@pytest.mark.parametrize("mode", MODES)
def test_megastep_quant_matches_jax(np_params, cfgs, mode, length):
    state, x = _state(mode, seed=length + 3)
    j, t = _steps(mode, length, _packed(np_params, cfgs), cfgs, state, x)
    assert int(t[0]) == int(j[0])
    others = np.arange(C) != length
    for got, want, before in zip(t[1:], j[1:], state):
        np.testing.assert_array_equal(got[:, others], want[:, others])
        np.testing.assert_array_equal(got[:, others], before[:, others])
    for kind, got, want in zip(tmq._kv_kinds(mode), t[1:3], j[1:3]):
        g = tmq.pane_values(torch.tensor(got[:, length]), kind).numpy()
        w = tmq.pane_values(torch.tensor(want[:, length]), kind).numpy()
        assert np.abs(g - w).max() <= 1 and (g != w).mean() < 0.02
    for got, want in zip(t[3:], j[3:]):
        np.testing.assert_allclose(got[:, length], want[:, length], rtol=1e-6, atol=0)


@pytest.mark.parametrize("mode", MODES)
def test_quantize_on_write_bit_exact(np_params, cfgs, mode):
    """K/V projection weights zeroed: the new rows are the K/V biases
    exactly, so the written codes and scales must agree bit for bit."""
    p = {k: (dict(v) if isinstance(v, dict) else v) for k, v in np_params.items()}
    w = p["blocks"]["attn_w"].copy()
    w[:, :, E:] = 0.0
    p["blocks"]["attn_w"] = w
    b = p["blocks"]["attn_b"].copy()
    b[:, E:] = np.random.default_rng(4).standard_normal((L, 2 * E)) * 0.7
    p["blocks"]["attn_b"] = b.astype(np.float32)
    length = 19
    state, x = _state(mode, seed=9)
    j, t = _steps(mode, length, _packed(p, cfgs), cfgs, state, x)
    assert int(t[0]) == int(j[0])
    for got, want in zip(t[1:], j[1:]):
        np.testing.assert_array_equal(got, want)
    # and they are the reference quantization of the biases
    for kind, pane, scales, bias in zip(tmq._kv_kinds(mode), t[1:3], t[3:],
                                        (b[:, E:2 * E], b[:, 2 * E:])):
        for layer in range(L):
            codes, s = tmq.quantize_row(torch.tensor(bias[layer]), kind, 1e-8)
            np.testing.assert_array_equal(pane[layer, length], codes.numpy())
            assert scales[layer, length] == s.item()


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_to_mega_quant_layout_matches_jax(kind):
    """QuantizedKV storage -> kernel pane, bit-exact; every value kept."""
    rng = np.random.default_rng(7)
    H, D = 4, 64
    if kind == "int8":
        buf = rng.integers(-127, 128, (2, 1, H, 16, D)).astype(np.int8)
    else:
        buf = rng.integers(0, 256, (2, 1, H, 16, D // 2)).astype(np.uint8)
    want = np.asarray(jmq.to_mega_quant_layout(jnp.asarray(buf), kind))
    got = tmq.to_mega_quant_layout(torch.tensor(buf), kind)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "int4":  # the values survive the repacking
        from efficient_llm_inference_tpu_torch.ops.quantization import unpack_int4
        vals = tmq.pane_values(got, kind).numpy()
        ref = unpack_int4(torch.tensor(buf))[:, 0].permute(0, 2, 1, 3).reshape(
            2, 16, H * D).numpy()
        np.testing.assert_array_equal(vals, ref)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_unpack_halves_matches_jax(dtype):
    pk = np.arange(-128, 128, dtype=np.int8).reshape(4, 64)
    jhi, jlo = jmq.unpack_halves(jnp.asarray(pk), dtype)
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    thi, tlo = tmq.unpack_halves(torch.tensor(pk), tdt)
    np.testing.assert_array_equal(thi.float().numpy(), np.asarray(jhi, np.float32))
    np.testing.assert_array_equal(tlo.float().numpy(), np.asarray(jlo, np.float32))
    # and pack_halves inverts it
    q = torch.cat([thi, tlo], dim=-1).float()
    np.testing.assert_array_equal(tmq.pack_halves(q).numpy(), pk)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cfg_kw,capacity", [
    (CFG_KW, 48), (CFG_KW, 44),
    (dict(CFG_KW, n_embd=128), 48),  # (E/2) % 128 != 0: int4 panes refused
    (dict(CFG_KW, n_embd=384, n_head=3), 48),
])
def test_mega_quant_supported_matches_jax(mode, cfg_kw, capacity):
    jcfg, tcfg = jgpt2.GPT2Config(**cfg_kw), tgpt2.GPT2Config(**cfg_kw)
    np_p = np_gpt2_params(tcfg, seed=0)
    want = jmq.mega_quant_supported(jcfg, capacity, to_jax(np_p), mode)
    got = tmq.mega_quant_supported(
        tcfg, capacity, tgpt2.params_from_jax(np_p, tcfg, device="cpu"), mode)
    assert got == want


@pytest.fixture(scope="module")
def engines(np_params, cfgs):
    jcfg, tcfg = cfgs
    jeng = JaxEngine(jax_gpt2_spec(jcfg), to_jax(np_params),
                     config=JaxConfig(model_name="t", device="cpu",
                                      dtype=jnp.float32, megakernel=False))
    teng = InferenceEngine(
        gpt2_spec(tcfg), tgpt2.params_from_jax(np_params, tcfg, torch.float32, "cpu"),
        config=Config(model_name="t", device="cpu", dtype=torch.float32,
                      megakernel=True))
    return jeng, teng


@pytest.mark.parametrize("mode", MODES)
def test_engine_quant_megakernel_tokens_match_jax(engines, mode):
    jeng, teng = engines
    prompts = ["the quick brown fox", "Quantized panes, fused dequant."]
    jres = jeng.benchmark_method(prompts, method=f"quant_{mode}", max_new_tokens=12)
    tres = teng.benchmark_method(prompts, method=f"quant_{mode}", max_new_tokens=12)
    assert teng.last_generation_ids == jeng.last_generation_ids
    assert len(set(teng.last_generation_ids[-12:])) > 1
    assert tres["est_kv_cache_mb_avg"] == pytest.approx(jres["est_kv_cache_mb_avg"],
                                                        rel=1e-12)
    built = [b for key, b in teng._fns.items()
             if key[0] == f"quant_{mode}" and key[-1]]
    assert built and all(b[1].capacity % 8 == 0 for b in built)
    assert teng._mega_quant_spec(60, None, mode, {}) is not None


def test_per_head_keeps_the_megakernel_off_path(engines):
    jeng, teng = engines
    assert teng._mega_quant_spec(64, None, "int8", {"granularity": "per_head"}) is None
    want = jeng.generate_ids("per head scales", "quant_int8", 8, granularity="per_head")
    assert teng.generate_ids("per head scales", "quant_int8", 8,
                             granularity="per_head") == want
