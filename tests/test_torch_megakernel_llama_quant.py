"""The port's Llama/Qwen quantized-KV whole-step decode
(ops/megakernel_quant.py `llama_megastep_quant`, #12) against the JAX
package's, on the CPU in fp32, at the JAX tests' geometry (E=512, Hq=8,
Hkv=4, V=300, C=48; KW=256, so int4 panes are eligible) for int8, int4 and
mixed panes, with a Qwen-bias and an untied-head variant.

* The port's plain step against the JAX kernel (Pallas interpret mode under
  jit) on the same numpy-made weights, panes, scales and embedding, at
  lengths 0, 7, 47 and at C=1024 (several attention chunks of the JAX
  kernel): the token is equal and every row but the new one is
  bit-identical. The new row's scales agree to rtol 1e-6 and its codes to one
  step: the K/V projections are fp32 sums taken in another order, which can
  move max|x| by a few ulp.
* Quantize-on-write bit for bit: with the K and V projection weights zeroed
  and random q/k/v biases, the new K/V rows are the biases exactly on both
  sides (at length 0 RoPE is the identity), and the written codes
  (half-split int4 bytes included) and scales are bit-exact.
* A port engine with megakernel=True gives the JAX engine's greedy tokens,
  and per_head scales keep the megakernel-off path.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efficient_llm_inference_tpu.core.config import Config as JaxConfig
from efficient_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine
from efficient_llm_inference_tpu.models import llama as jllama
from efficient_llm_inference_tpu.ops.pallas import megakernel_llama as jml
from efficient_llm_inference_tpu.ops.pallas import megakernel_quant as jmq
from efficient_llm_inference_tpu_torch import Config, InferenceEngine
from efficient_llm_inference_tpu_torch.models import llama as tllama
from efficient_llm_inference_tpu_torch.ops import megakernel_llama as tml
from efficient_llm_inference_tpu_torch.ops import megakernel_quant as tmq
from torch_port_helpers import jax_rope_rows, np_llama_params, to_jax

LCFG_KW = dict(vocab_size=300, hidden_size=512, intermediate_size=1024, n_layer=2,
               n_head=8, n_kv_head=4, n_positions=512, rope_theta=10000.0,
               tie_embeddings=True)
VARIANTS = {
    "tied": {},
    "qwen_bias": dict(qkv_bias=True, rms_eps=1e-6),
    "untied": dict(tie_embeddings=False),
}
L, KW, C = LCFG_KW["n_layer"], 256, 48
MODES = ["int8", "int4", "mixed"]


def _cfgs(**over):
    kw = dict(LCFG_KW, **over)
    return jllama.LlamaConfig(**kw), tllama.LlamaConfig(**kw)


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request):
    cfgs = _cfgs(**VARIANTS[request.param])
    return cfgs, np_llama_params(cfgs[1], seed=21, std=0.15)


def _packed(np_params, cfgs):
    jcfg, tcfg = cfgs
    tparams = tllama.params_from_jax(np_params, tcfg, torch.float32, "cpu")
    return (jml.pack_llama_mega(to_jax(np_params), jcfg),
            tml.pack_llama_mega(tparams, tcfg))


def _state(mode: str, seed: int, capacity: int = C):
    """Random panes (valid codes), per-token scales and an embedding."""
    rng = np.random.default_rng(seed)
    k_kind, v_kind = tmq._kv_kinds(mode)

    def pane(kind):
        lo = -127 if kind == "int8" else -128
        return rng.integers(lo, 128, (L, capacity, tmq._pane_width(kind, KW))).astype(np.int8)

    def scales():
        return (rng.random((L, capacity)) * 0.02 + 1e-3).astype(np.float32)

    x = (rng.standard_normal((1, LCFG_KW["hidden_size"])) * 0.5).astype(np.float32)
    return [pane(k_kind), pane(v_kind), scales(), scales()], x


def _steps(mode, length, packed, cfgs, state, x, capacity=C):
    jcfg, tcfg = cfgs
    jp, tp = packed
    cos_q, sin_q = jax_rope_rows(jcfg, length)
    j = jmq.llama_megastep_quant(
        jp, *(jnp.asarray(a) for a in state), jnp.int32(length), jnp.asarray(x),
        cos_q, sin_q, cfg=jcfg, capacity=capacity, kv_mode=mode, interpret=True)
    t_in = [torch.tensor(a) for a in state]
    t = tmq.llama_megastep_quant(tp, *t_in, length, torch.tensor(x), cfg=tcfg,
                                 kv_mode=mode)
    assert all(a is b for a, b in zip(t[1:], t_in))  # written in place
    return [np.asarray(a) for a in j], [a.numpy() for a in t]


@pytest.mark.parametrize("length,capacity", [(0, C), (7, C), (C - 1, C), (700, 1024)])
@pytest.mark.parametrize("mode", MODES)
def test_megastep_quant_matches_jax(variant, mode, length, capacity):
    cfgs, np_params = variant
    state, x = _state(mode, seed=length + 3, capacity=capacity)
    j, t = _steps(mode, length, _packed(np_params, cfgs), cfgs, state, x, capacity)
    assert int(t[0]) == int(j[0])
    others = np.arange(capacity) != length
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
def test_quantize_on_write_bit_exact(mode):
    """wk and wv zeroed, random q/k/v biases, length 0 (RoPE is the
    identity there): the new rows are the K/V biases exactly, so the written
    codes and scales must agree bit for bit, and be the reference
    quantization of the biases."""
    cfgs = _cfgs(qkv_bias=True)
    p = np_llama_params(cfgs[1], seed=4, std=0.15)
    p["blocks"]["wk"][:] = 0.0
    p["blocks"]["wv"][:] = 0.0
    rng = np.random.default_rng(8)
    for name in ("bk", "bv"):
        p["blocks"][name] = (rng.standard_normal((L, KW)) * 0.7).astype(np.float32)
    state, x = _state(mode, seed=9)
    j, t = _steps(mode, 0, _packed(p, cfgs), cfgs, state, x)
    assert int(t[0]) == int(j[0])
    for got, want in zip(t[1:], j[1:]):
        np.testing.assert_array_equal(got, want)
    for kind, pane, scales, bias in zip(tmq._kv_kinds(mode), t[1:3], t[3:],
                                        (p["blocks"]["bk"], p["blocks"]["bv"])):
        for layer in range(L):
            codes, s = tmq.quantize_row(torch.tensor(bias[layer]), kind, 1e-8)
            np.testing.assert_array_equal(pane[layer, 0], codes.numpy())
            assert scales[layer, 0] == s.item()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("capacity", [48, 44])
@pytest.mark.parametrize("over", [
    {},
    dict(n_kv_head=2),  # KW = 128: int4 panes are 64 lanes wide, refused
    dict(hidden_size=256, n_head=4, n_kv_head=2),
])
def test_llama_mega_quant_supported_matches_jax(mode, capacity, over):
    jcfg, tcfg = _cfgs(**over)
    np_p = np_llama_params(tcfg, seed=0)
    want = jmq.llama_mega_quant_supported(jcfg, capacity, to_jax(np_p), mode)
    got = tmq.llama_mega_quant_supported(
        tcfg, capacity, tllama.params_from_jax(np_p, tcfg, device="cpu"), mode)
    assert got == want


@pytest.fixture(scope="module")
def engines(variant):
    (jcfg, tcfg), np_params = variant
    jeng = JaxEngine(jllama.llama_spec(jcfg), to_jax(np_params),
                     config=JaxConfig(model_name="t", device="cpu",
                                      dtype=jnp.float32, megakernel=False))
    teng = InferenceEngine(
        tllama.llama_spec(tcfg),
        tllama.params_from_jax(np_params, tcfg, torch.float32, "cpu"),
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
    assert teng._mega_quant_spec(60, None, mode, {})["kind"] == "llama"


def test_per_head_keeps_the_megakernel_off_path(engines):
    jeng, teng = engines
    assert teng._mega_quant_spec(64, None, "int8", {"granularity": "per_head"}) is None
    want = jeng.generate_ids("per head scales", "quant_int8", 8, granularity="per_head")
    assert teng.generate_ids("per head scales", "quant_int8", 8,
                             granularity="per_head") == want
