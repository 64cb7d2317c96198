"""The port's slice end to end: InferenceEngine greedy tokens identical to
the JAX engine's (megakernel off, fp32, CPU) on the same numpy-made params,
for full_cache and quant_int8/int4/mixed, at per_token granularity through
benchmark_method and at per_head through generate(..., granularity=...)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efficient_llm_inference_tpu.core.config import Config as JaxConfig
from efficient_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine
from efficient_llm_inference_tpu.models import gpt2 as jgpt2
from efficient_llm_inference_tpu.models.registry import gpt2_spec as jax_gpt2_spec
from efficient_llm_inference_tpu_torch import Config, InferenceEngine
from efficient_llm_inference_tpu_torch.models import gpt2 as tgpt2
from efficient_llm_inference_tpu_torch.models.registry import gpt2_spec
from torch_port_helpers import np_gpt2_params, to_jax

CFG_KW = dict(vocab_size=256, n_positions=128, n_embd=64, n_layer=2, n_head=4)
PROMPTS = ["The quick brown fox jumps.", "Caches trade memory for time!"]
N_NEW = 12
METHODS = ["full_cache", "quant_int8", "quant_int4", "quant_mixed"]


@pytest.fixture(scope="module")
def engines():
    np_params = np_gpt2_params(tgpt2.GPT2Config(**CFG_KW), seed=3, std=0.1)
    jeng = JaxEngine(
        jax_gpt2_spec(jgpt2.GPT2Config(**CFG_KW)), to_jax(np_params),
        config=JaxConfig(model_name="t", device="cpu", dtype=jnp.float32,
                         megakernel=False))
    cfg = tgpt2.GPT2Config(**CFG_KW)
    teng = InferenceEngine(
        gpt2_spec(cfg), tgpt2.params_from_jax(np_params, cfg, torch.float32, "cpu"),
        config=Config(model_name="t", device="cpu", dtype=torch.float32))
    return jeng, teng


@pytest.mark.parametrize("method", METHODS)
def test_benchmark_method_tokens_match_jax(engines, method):
    jeng, teng = engines
    jres = jeng.benchmark_method(PROMPTS, method=method, max_new_tokens=N_NEW)
    tres = teng.benchmark_method(PROMPTS, method=method, max_new_tokens=N_NEW)
    assert tres.keys() == jres.keys()
    assert tres["total_new_tokens"] == jres["total_new_tokens"] == 2 * N_NEW
    assert teng.last_generation_ids == jeng.last_generation_ids
    if method != "full_cache":
        assert tres["est_kv_cache_mb_avg"] == pytest.approx(
            jres["est_kv_cache_mb_avg"], rel=1e-12)
    for p in PROMPTS:
        want = jeng.generate_ids(p, method, N_NEW)
        assert teng.generate_ids(p, method, N_NEW) == want
        assert len(set(want[-N_NEW:])) > 1  # not a degenerate repeat


@pytest.mark.parametrize("method", METHODS[1:])
def test_per_head_granularity_tokens_match_jax(engines, method):
    jeng, teng = engines
    prompt = PROMPTS[1]
    want = jeng.generate(prompt, method, N_NEW, granularity="per_head")
    assert teng.generate(prompt, method, N_NEW, granularity="per_head") == want
    assert teng.last_generation_ids == jeng.last_generation_ids


def test_estimate_kv_bytes_matches_jax(engines):
    jeng, teng = engines
    for method in METHODS:
        assert teng.estimate_kv_bytes(method, 77) == jeng.estimate_kv_bytes(method, 77)


def test_unported_method_names_its_roadmap_item(engines):
    _, teng = engines
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        teng.benchmark_method(PROMPTS, method="sliding_window")
    with pytest.raises(AssertionError, match="Invalid method"):  # as the JAX engine
        teng.benchmark_method(PROMPTS, method="nope")


def test_teacher_forced_logits_replay_greedy(engines):
    """generate_logits with the greedy tokens forced gives back the same
    logits, and each token is the argmax of the logits that chose it."""
    _, teng = engines
    toks, logits = teng.generate_logits(PROMPTS[0], "quant_int4", N_NEW)
    assert logits.shape == (N_NEW, CFG_KW["vocab_size"])
    assert toks == logits.argmax(-1).tolist()
    toks2, logits2 = teng.generate_logits(PROMPTS[0], "quant_int4", N_NEW,
                                          forced=toks)
    assert toks2 == toks and torch.equal(logits2, logits)


def test_from_model_name_defaults_to_cuda_bf16():
    cfg = Config()
    assert cfg.device == "cuda" and cfg.dtype == torch.bfloat16
    assert Config(device="cpu").dtype == torch.float32
    eng = InferenceEngine.from_model_name(
        "gpt2-tiny", config=Config(model_name="gpt2-tiny", device="cpu"))
    assert eng.params["wte"].device.type == "cpu"
    assert eng.model.n_layer == 2 and eng.model.head_dim == 16


@pytest.mark.parametrize("shape,dtype", [((3, 5), "float32"), ((2, 4, 6), "bfloat16"),
                                          ((7,), "int8")])
def test_memory_helpers_match_jax(shape, dtype):
    from efficient_llm_inference_tpu.core import utils as jutils
    from efficient_llm_inference_tpu_torch.core import utils as tutils

    j = jnp.zeros(shape, getattr(jnp, dtype))
    t = torch.zeros(shape, dtype=getattr(torch, dtype))
    assert tutils.tensor_bytes(t) == jutils.tensor_bytes(j)
    assert tutils.kv_bytes_fp(t, t) == jutils.kv_bytes_fp(j, j)
    assert tutils.mb(tutils.tensor_bytes(t)) == jutils.mb(jutils.tensor_bytes(j))


def test_generate_logits_rejects_wrong_forced_length(engines):
    _, teng = engines
    with pytest.raises(ValueError, match="forced tokens"):
        teng.generate_logits(PROMPTS[0], "full_cache", 4, forced=[1, 2])


def test_benchmark_method_defaults_are_jax():
    """Every default of the port's benchmark_method signature is the JAX
    engine's, `method` ("no_cache") included."""
    import inspect

    want = inspect.signature(JaxEngine.benchmark_method).parameters
    got = inspect.signature(InferenceEngine.benchmark_method).parameters
    assert list(got) == list(want)
    for name, p in want.items():
        assert got[name].default == p.default, name


def test_benchmark_method_bare_call_selects_no_cache(engines):
    """Without `method` the port selects JAX's default, no_cache, which is
    not ported yet: it raises naming its ROADMAP item instead of measuring
    another method."""
    _, teng = engines
    with pytest.raises(NotImplementedError, match="'no_cache'.*Queue 1 item 5"):
        teng.benchmark_method(PROMPTS, max_new_tokens=2)
