"""Serving over quantized weights (`Config.weight_quant`) on every route of
the port's engine against the JAX engine, on the CPU in fp32.

The port's engines come from `InferenceEngine.from_model_name` with
full-precision numpy params and `weight_quant` (megakernel on: the plain
versions of the verify, batched and batched-verify kernels' weight tiers;
the registry returns the small test geometry for the name); the oracle is
the JAX engine (megakernel off, XLA) on the same quantized tree at JAX's own
spec (the int4w8 padded FFN), its `generate_ids(prompt, method, n)`. The
tokens must be equal exactly, for GPT-2 int8 and int4 (G = 128) and
Llama int8 and int4w8 at a Qwen shape whose FFN the int4w8 group pads
(I 704 -> 768, G = 128):

* `generate_speculative` "ngram", "self_draft" (its quantized draft takes
  the whole-step tier steps: the JAX engine packs a burst only for a
  full-precision draft) and "draft" with the full-precision model as the
  draft (its burst), and `generate_speculative_auto`: plain full_cache
  greedy;
* `generate_batch` over 3 prompts of different lengths (the batched tier
  steps, KV in the model dtype and int8): each row the full_cache /
  quant_int8 greedy of its prompt;
* `MegaBatchServer` plain and spec="ngram", pools in the model dtype and
  int8: each request the full_cache / quant_int8 greedy of its prompt.
"""

import jax.numpy as jnp
import pytest
import torch

import efficient_llm_inference_tpu.engine.engine as jengine_mod
import efficient_llm_inference_tpu_torch.engine.engine as tengine_mod
from efficient_llm_inference_tpu.core.config import Config as JaxConfig
from efficient_llm_inference_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from efficient_llm_inference_tpu.models import gpt2 as jgpt2
from efficient_llm_inference_tpu.models import llama as jllama
from efficient_llm_inference_tpu.models import registry as jregistry
from efficient_llm_inference_tpu_torch import (
    Config,
    InferenceEngine,
    MegaBatchServer,
    MegaPoolConfig,
    Request,
)
from efficient_llm_inference_tpu_torch.data.tokenizer import ByteTokenizer
from efficient_llm_inference_tpu_torch.engine import speculative as tspec
from efficient_llm_inference_tpu_torch.models import gpt2 as tgpt2
from efficient_llm_inference_tpu_torch.models import llama as tllama
from efficient_llm_inference_tpu_torch.models import registry as tregistry
from efficient_llm_inference_tpu_torch.ops import megakernel as tmk
from torch_port_helpers import np_gpt2_params, np_llama_params, to_jax, to_numpy

GPT2_KW = dict(vocab_size=300, n_positions=256, n_embd=256, n_layer=2, n_head=2)
LLAMA_KW = dict(vocab_size=300, hidden_size=256, intermediate_size=512, n_layer=2,
                n_head=4, n_kv_head=2, n_positions=512, rope_theta=10000.0,
                tie_embeddings=True)
QWEN_KW = dict(LLAMA_KW, intermediate_size=704, qkv_bias=True, rms_eps=1e-6)
# full-precision drafts small enough for the burst (tests/test_torch_speculative.py's)
DRAFT_KW = {"gpt2": dict(GPT2_KW, n_embd=128, n_head=4),
            "llama": dict(LLAMA_KW, n_layer=1, n_positions=256)}
CASES = {"gpt2-int8": ("gpt2", "int8"), "gpt2-int4": ("gpt2", "int4"),
         "llama-int8": ("llama", "int8"), "qwen-int4w8-padded": ("qwen", "int4w8")}
PROMPT = "the cat sat on the mat; the cat sat on the hat; the dog sat on the"
PROMPTS = ["the quick brown fox jumps over the lazy dog", "a b a b a", PROMPT]
N, K = 10, 4


@pytest.fixture(scope="module", params=list(CASES))
def engines(request):
    """(JAX engine, port engine, a full-precision draft (spec, params)):
    the port's engine through from_model_name(weight_quant=...), the JAX
    engine's on the port's quantized tree at JAX's spec."""
    family, wq = CASES[request.param]
    if family == "gpt2":
        cfgs = (jgpt2.GPT2Config(**GPT2_KW), tgpt2.GPT2Config(**GPT2_KW))
        np_p = np_gpt2_params(cfgs[1], seed=71, std=0.1)
        specs = (jregistry.gpt2_spec(cfgs[0]), tregistry.gpt2_spec(cfgs[1]))
        name, mod = "gpt2", tgpt2
        dcfg = tgpt2.GPT2Config(**DRAFT_KW["gpt2"])
        draft = (tregistry.gpt2_spec(dcfg), tgpt2.params_from_jax(
            np_gpt2_params(dcfg, seed=75), dcfg, torch.float32, "cpu"))
    else:
        kw = LLAMA_KW if family == "llama" else QWEN_KW
        cfgs = (jllama.LlamaConfig(**kw), tllama.LlamaConfig(**kw))
        np_p = np_llama_params(cfgs[1], seed=73, std=0.15)
        specs = (jllama.llama_spec(cfgs[0]), tllama.llama_spec(cfgs[1]))
        name, mod = "llama-3-1b", tllama
        if wq == "int4w8":
            specs = (jengine_mod._int4w8_llama_spec(specs[0], True)[0], specs[1])
        dcfg = tllama.LlamaConfig(**DRAFT_KW["llama"])
        draft = (tllama.llama_spec(dcfg), tllama.params_from_jax(
            np_llama_params(dcfg, seed=77), dcfg, torch.float32, "cpu"))
    fp = mod.params_from_jax(np_p, cfgs[1], torch.float32, "cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tengine_mod, "spec_by_name", lambda _: specs[1])
        teng = InferenceEngine.from_model_name(
            name, tokenizer=ByteTokenizer(), params=fp,
            config=Config(model_name=name, device="cpu", dtype=torch.float32,
                          megakernel=True, weight_quant=wq))
    assert tmk.weight_kind(teng._packed()) == wq[:4]
    assert teng.model.config == specs[1].config or family == "qwen"  # qwen: padded
    assert getattr(teng.model.config, "intermediate_size", 0) == getattr(
        specs[0].config, "intermediate_size", 0)
    jeng = jengine_mod.InferenceEngine(
        specs[0], to_jax(to_numpy(teng.params)), tokenizer=JaxByteTokenizer(),
        config=JaxConfig(model_name=name, device="cpu", dtype=jnp.float32,
                         megakernel=False))
    return jeng, teng, draft


@pytest.fixture
def one_thread():
    """The port's CPU ops on one thread for the test: a generation is
    thousands of small ops, and their thread pools stall for tens of
    seconds when other test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_thread")
def test_speculative_matches_jax(engines):
    """ngram, self_draft (the tier steps: no burst for a quantized draft)
    and a full-precision draft (its burst) over the quantized target's
    verify tier: the JAX engine's full_cache greedy."""
    jeng, teng, draft = engines
    want = jeng.generate_ids(PROMPT, "full_cache", N)
    assert len(set(want[-N:])) > 1  # not one repeated token
    for mode, kw, route in (("ngram", {}, None), ("self_draft", {}, "step"),
                            ("draft", {"draft": draft}, "burst")):
        teng.generate_speculative(PROMPT, N, mode=mode, k=K, **kw)
        assert teng.last_generation_ids == want, mode
        key = next(k for k in teng._fns if k[:2] == ("speculative", mode))
        mega = teng._fns[key][-1]
        assert mega is not None and mega["packed"] is teng._packed()  # the verify tier
        if route is not None:
            dspec, dparams = kw.get("draft") or tspec.make_self_draft(
                teng.model, teng.params, 1)
            dmega = teng._draft_mega_spec(dspec, dparams, mega)
            cap = tspec.spec_capacity(64, N, K, True)
            assert tspec.draft_route(dspec, dmega, cap, torch.float32) == route, mode


@pytest.mark.usefixtures("one_thread")
def test_speculative_auto_matches_jax(engines):
    jeng, teng, _ = engines
    want = jeng.generate_ids(PROMPT, "full_cache", N)
    for _ in range(3):
        _, n, s = teng.generate_speculative_auto(PROMPT, N, stats=True)
        assert n == N and teng.last_generation_ids == want, s


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("kv_mode", [None, "int8"])
def test_generate_batch_matches_jax(engines, kv_mode):
    jeng, teng, _ = engines
    method = f"quant_{kv_mode}" if kv_mode else "full_cache"
    teng.generate_batch(PROMPTS, N, kv_mode=kv_mode)
    assert any(k[0] == "batch" and k[-1] == kv_mode for k in teng._fns)  # batched
    assert teng.last_batch_ids == [jeng.generate_ids(p, method, N) for p in PROMPTS]


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("spec", [None, "ngram"])
@pytest.mark.parametrize("kv_mode", [None, "int8"])
def test_server_matches_jax(engines, kv_mode, spec):
    """Every request fits its pane (prompt + 1 + N <= C - 8): the tokens are
    the greedy decode of the pool's KV kind."""
    jeng, teng, _ = engines
    method = f"quant_{kv_mode}" if kv_mode else "full_cache"
    srv = MegaBatchServer(teng.model, teng.params,
                          pool=MegaPoolConfig(n_slots=4, capacity=96, max_chunk=8),
                          kv_mode=kv_mode, spec=spec, spec_k=K, dtype=torch.float32)
    assert tmk.weight_kind(srv.packed) != "fp"
    reqs = [Request(i, list(p.encode()), N) for i, p in enumerate(PROMPTS)]
    srv.run(reqs)
    for p, r in zip(PROMPTS, reqs):
        assert list(p.encode()) + r.out_ids == jeng.generate_ids(p, method, N), p
