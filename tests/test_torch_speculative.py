"""The port's speculative decoding (engine/speculative.py, the engine's
`generate_speculative` and `generate_speculative_auto`) against the JAX
engine's, on the CPU in fp32.

* For GPT-2 and Llama, megakernel on (the plain verifies, bursts and steps;
  JAX: the Pallas kernels in interpret mode) and off (the k-row forward
  pass), modes "ngram", "self_draft" and "draft": the output ids, n and the
  round count are equal to the JAX engine's, and the ids equal plain
  full_cache greedy. The drafts are the repo's byte-vocab geometries
  (examples/train_scale_models.py draft_gpt2, with head_dim 32, and
  draft_llama) at the targets' vocabulary, and the target itself (every
  proposal accepted, ceil((N - 1) / k) rounds).
* `generate_speculative_auto` picks the JAX engine's candidates, call by
  call, over 10 calls.
* The routes (verify kernel or forward pass; draft burst, whole-step draft
  or eager draft) over the registry names and the two draft geometries,
  over full-precision and quantized weights (a quantized target verifies
  on its tier; its self-draft takes the whole-step tier steps, since JAX
  packs a burst only for a full-precision draft), against the JAX
  engine's; the differences are named.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efficient_llm_inference_tpu.core.config import Config as JaxConfig
from efficient_llm_inference_tpu.engine import speculative as jspec
from efficient_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine
from efficient_llm_inference_tpu.models import gpt2 as jgpt2
from efficient_llm_inference_tpu.models import llama as jllama
from efficient_llm_inference_tpu.models import registry as jreg
from efficient_llm_inference_tpu.ops.pallas import megakernel_draft as jmd
from efficient_llm_inference_tpu_torch import Config, InferenceEngine
from efficient_llm_inference_tpu_torch.engine import speculative as tspec
from efficient_llm_inference_tpu_torch.models import gpt2 as tgpt2
from efficient_llm_inference_tpu_torch.models import llama as tllama
from efficient_llm_inference_tpu_torch.models import registry as treg
from torch_port_helpers import (
    fake_params,
    np_gpt2_params,
    np_llama_params,
    served_configs,
    to_jax,
)

PROMPT = "the cat sat on the mat; the cat sat on the hat; the dog sat on the"
N, K = 12, 4
FAMILIES = {
    "gpt2": (dict(vocab_size=300, n_positions=256, n_embd=128, n_layer=2, n_head=2),
             dict(vocab_size=300, n_positions=256, n_embd=128, n_layer=2, n_head=4)),
    "llama": (dict(vocab_size=300, hidden_size=256, intermediate_size=512, n_layer=2,
                   n_head=4, n_kv_head=2, n_positions=512, rope_theta=10000.0,
                   tie_embeddings=True),
              dict(vocab_size=300, hidden_size=256, intermediate_size=512, n_layer=1,
                   n_head=4, n_kv_head=2, n_positions=256, rope_theta=10000.0,
                   tie_embeddings=True)),
}


def _models(family: str, kw: dict, seed: int):
    """(JAX spec, JAX params, port spec, port params) over one numpy draw."""
    if family == "gpt2":
        jcfg, tcfg = jgpt2.GPT2Config(**kw), tgpt2.GPT2Config(**kw)
        np_p = np_gpt2_params(tcfg, seed=seed, std=0.15)
        return (jreg.gpt2_spec(jcfg), to_jax(np_p), treg.gpt2_spec(tcfg),
                tgpt2.params_from_jax(np_p, tcfg, torch.float32, "cpu"))
    jcfg, tcfg = jllama.LlamaConfig(**kw), tllama.LlamaConfig(**kw)
    np_p = np_llama_params(tcfg, seed=seed, std=0.15)
    return (jllama.llama_spec(jcfg), to_jax(np_p), tllama.llama_spec(tcfg),
            tllama.params_from_jax(np_p, tcfg, torch.float32, "cpu"))


@pytest.fixture(scope="module", params=[(f, m) for f in FAMILIES for m in (False, True)],
                ids=lambda p: f"{p[0]}-mega_{'on' if p[1] else 'off'}")
def engines(request):
    family, mega = request.param
    tkw, dkw = FAMILIES[family]
    jspec_t, jp, tspec_t, tp = _models(family, tkw, seed=41)
    jspec_d, jdp, tspec_d, tdp = _models(family, dkw, seed=43)
    jeng = JaxEngine(jspec_t, jp, config=JaxConfig(model_name="t", device="cpu",
                                                   dtype=jnp.float32, megakernel=mega))
    teng = InferenceEngine(tspec_t, tp, config=Config(model_name="t", device="cpu",
                                                      dtype=torch.float32, megakernel=mega))
    return jeng, teng, (jspec_d, jdp), (tspec_d, tdp), mega


@pytest.mark.parametrize("mode", ["ngram", "self_draft", "draft", "target_as_draft"])
def test_generate_speculative_matches_jax(engines, mode):
    """"target_as_draft": the target as its own draft accepts every proposal,
    k tokens a round (the full-acceptance path)."""
    jeng, teng, jdraft, tdraft, mega = engines
    jkw = {"draft": jdraft} if mode == "draft" else {}
    tkw = {"draft": tdraft} if mode == "draft" else {}
    if mode == "target_as_draft":
        mode = "draft"
        jkw = {"draft": (jeng.model, jeng.params)}
        tkw = {"draft": (teng.model, teng.params)}
    jtext, jn, jst = jeng.generate_speculative(PROMPT, N, mode=mode, k=K, stats=True, **jkw)
    ttext, tn, tst = teng.generate_speculative(PROMPT, N, mode=mode, k=K, stats=True, **tkw)
    assert teng.last_generation_ids == jeng.last_generation_ids
    assert (tn, tst, ttext) == (jn, jst, jtext)
    assert teng.last_generation_ids == teng.generate_ids(PROMPT, "full_cache", N)
    if tkw.get("draft", (None,))[0] is teng.model:
        assert tst["n_rounds"] == -(-(N - 1) // K)
    key = next(k for k in teng._fns if k[:2] == ("speculative", mode)
               and k[-1] == (id(tkw["draft"][1]) if tkw else None))
    spec_mega = teng._fns[key][-1]
    assert (spec_mega is not None) == mega
    assert teng.last_spec_host_syncs >= 1
    if mega and mode != "ngram":  # the drafts take the burst, as in JAX
        dspec, dparams = tkw["draft"] if tkw else tspec.make_self_draft(
            teng.model, teng.params, 1)
        dmega = teng._draft_mega_spec(dspec, dparams, spec_mega)
        cap = tspec.spec_capacity(64, N, K, True)
        assert tspec.draft_route(dspec, dmega, cap, torch.float32) == "burst"


def test_generate_speculative_auto_matches_jax():
    """10 calls: the same candidate each call, the same ids as full_cache."""
    jspec_t, jp, tspec_t, tp = _models("gpt2", FAMILIES["gpt2"][0], seed=47)
    jspec_d, jdp, tspec_d, tdp = _models("gpt2", FAMILIES["gpt2"][1], seed=49)
    jeng = JaxEngine(jspec_t, jp, config=JaxConfig(model_name="t", device="cpu",
                                                   dtype=jnp.float32, megakernel=False))
    teng = InferenceEngine(tspec_t, tp, config=Config(model_name="t", device="cpu",
                                                      dtype=torch.float32, megakernel=False))
    want = teng.generate_ids(PROMPT, "full_cache", N)
    for i in range(10):
        jdraft, tdraft = ((jspec_d, jdp), (tspec_d, tdp)) if i >= 2 else (None, None)
        jt, jn, js = jeng.generate_speculative_auto(PROMPT, N, draft=jdraft, stats=True)
        tt, tn, ts = teng.generate_speculative_auto(PROMPT, N, draft=tdraft, stats=True)
        assert (tn, ts, tt) == (jn, js, jt), i
        assert teng.last_generation_ids == want
    assert set(teng._spec_auto["acc"]) == set(jeng._spec_auto["acc"])


# ------------------------------------------------------------------ routes

DRAFT_KW = {"draft_gpt2": dict(FAMILIES["gpt2"][1], vocab_size=256),
            "draft_llama": dict(FAMILIES["llama"][1], vocab_size=256)}
TARGET_KW = {  # the byte-vocab speculation targets (examples/train_scale_models.py)
    "scale_gpt2_big": dict(vocab_size=256, n_positions=256, n_embd=768, n_layer=12,
                           n_head=12),
    "gpt2_e256": dict(vocab_size=256, n_positions=256, n_embd=256, n_layer=4, n_head=4),
    "scale_llama_big": dict(vocab_size=256, n_positions=256, hidden_size=1024,
                            intermediate_size=2048, n_layer=8, n_head=16, n_kv_head=4,
                            rope_theta=10000.0, tie_embeddings=True),
}
V, F, B, S, E = "verify", "forward", "burst", "step", "eager"
# (target, bucket) at n = 64 (bucket 256) or 512 (bucket 1024), k = 8, bf16:
# (JAX route, port route). The differences are TPU envelopes the port leaves
# out: the JAX step's VMEM budget at capacity 1552 (GPT-2), the 2048-tile DMA
# gate (Qwen2.5-0.5B, as in test_torch_megakernel_llama.py).
TARGET_ROUTES = {
    ("gpt2", 256): (V, V), ("gpt2", 1024): (F, V),
    ("gpt2-medium", 256): (V, V), ("gpt2-medium", 1024): (F, V),
    ("gpt2-tiny", 256): (F, F), ("llama-tiny", 256): (F, F), ("qwen-tiny", 256): (F, F),
    ("llama-3-1b", 256): (V, V), ("llama-3-1b", 1024): (V, V),
    ("qwen2.5-0.5b", 256): (F, V), ("qwen2.5-0.5b", 1024): (F, V),
    # quantized targets (weight_quant at the engine's group): the verify's
    # weight tier; the JAX step's VMEM budget at capacity 1552 (GPT-2
    # medium) and Qwen2.5-0.5B's 2048-tile DMA gate as above
    ("gpt2", 256, "int8"): (V, V), ("gpt2", 1024, "int4"): (V, V),
    ("gpt2-medium", 1024, "int4w8"): (F, V), ("llama-3-1b", 256, "int8"): (V, V),
    ("llama-3-1b", 1024, "int4w8"): (V, V), ("llama-3-1b", 256, "int4"): (V, V),
    ("qwen2.5-0.5b", 256, "int8"): (F, V), ("qwen2.5-0.5b", 256, "int4w8"): (F, V),
}
# (target, draft, dtype, n) at bucket 128, k = 4: ((JAX target, JAX draft),
# (port target, port draft)). Past the 6 MB burst budget a draft takes its
# whole-step kernel; draft_gpt2's head_dim 32 is outside the port's step
# kernels (HEAD_DIMS), so there the port runs it eagerly where JAX runs
# gpt2_megastep; and where the JAX target is refused by its VMEM budget, JAX
# runs the draft eagerly too.
DRAFT_ROUTES = {
    ("scale_gpt2_big", "draft_gpt2", "float32", 64): ((V, B), (V, B)),
    ("scale_gpt2_big", "draft_gpt2", "float32", 1536): ((F, E), (V, B)),
    ("scale_gpt2_big", "draft_gpt2", "float32", 2048): ((F, E), (V, E)),
    ("scale_gpt2_big", "draft_gpt2", "bfloat16", 1024): ((V, B), (V, B)),
    ("scale_gpt2_big", "draft_gpt2", "bfloat16", 6000): ((F, E), (V, E)),
    ("gpt2_e256", "draft_gpt2", "float32", 2048): ((V, S), (V, E)),
    ("gpt2_e256", "draft_gpt2", "bfloat16", 4500): ((V, B), (V, B)),
    ("scale_llama_big", "draft_llama", "float32", 64): ((V, B), (V, B)),
    ("scale_llama_big", "draft_llama", "float32", 4500): ((V, S), (V, S)),
    ("scale_llama_big", "draft_llama", "bfloat16", 6000): ((V, B), (V, B)),
    # a quantized target (int8; int4 at G = 128) with a full-precision draft:
    # the draft keeps its burst
    ("scale_gpt2_big", "draft_gpt2", "bfloat16", 1024, "int8"): ((V, B), (V, B)),
    ("scale_llama_big", "draft_llama", "float32", 64, "int4"): ((V, B), (V, B)),
    # the 1-layer self-draft of a quantized registry target: no burst for a
    # quantized draft, its whole-step tier steps
    ("gpt2", "self", "bfloat16", 64, "int8"): ((V, S), (V, S)),
    ("gpt2", "self", "bfloat16", 64, "int4w8"): ((V, S), (V, S)),
    ("llama-3-1b", "self", "bfloat16", 64, "int4"): ((V, S), (V, S)),
    ("llama-3-1b", "self", "float32", 64, "int4w8"): ((V, S), (V, S)),
}


def _shape_params(spec, dtype, lib, quant=("fp", 0)):
    """Parameter stand-ins with the types the eligibility checks read (one
    tensor per leaf; shapes do not enter them, but an int4 leaf's group);
    `quant` = (mode, group): full precision, or int8 / int4 block weights
    with the LM head's quantized copy (torch_port_helpers.fake_params)."""
    gpt2 = spec.name == "gpt2"
    names = (("attn_w", "attn_proj_w", "fc_w", "fc_proj_w") if gpt2 else
             ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"))
    return fake_params(names, lib == "jax", "wte" if gpt2 else "embed",
                       gpt2 or spec.config.tie_embeddings, *quant, dtype=dtype)


def _jax_routes(spec, dtype, bucket, n, k, draft=None, quant=("fp", 0), dquant=("fp", 0)):
    """(target route, draft route) as the JAX engine decides them: its
    `_mega_spec` at bucket + n + k + 1, `_draft_mega_spec`, and
    make_speculative_generate's burst gate at roundup8(...) + 8."""
    from efficient_llm_inference_tpu.ops.pallas import megakernel as jmk
    from efficient_llm_inference_tpu.ops.pallas import megakernel_llama as jml

    eng = JaxEngine(spec, _shape_params(spec, dtype, "jax", quant), config=JaxConfig(
        model_name="t", device="tpu", dtype=dtype, megakernel=True))
    eng._mega_packed = {}  # packing is not a routing question
    mega = eng._mega_spec(bucket + n + k + 1, None)
    target = V if mega is not None else F
    if draft is None:
        return target
    if mega is None:
        return target, E
    sup = jmk.mega_supported if draft.name == "gpt2" else jml.mega_supported
    if not sup(draft.config, mega["capacity"], _shape_params(draft, dtype, "jax", dquant)):
        return target, E
    gate = (jmd.gpt2_draft_burst_supported if draft.name == "gpt2"
            else jmd.llama_draft_burst_supported)
    burst = dquant[0] == "fp" and (draft.name == "gpt2" or draft.config.tie_embeddings)
    return target, B if burst and gate(draft.config, mega["capacity"] + 8, dtype) else S


def _port_routes(spec, dtype, bucket, n, k, draft=None, quant=("fp", 0), dquant=("fp", 0)):
    """The same through the port engine's `_spec_mega`, `_draft_kernels` and
    engine/speculative.py `draft_route`."""
    eng = InferenceEngine(spec, _shape_params(spec, dtype, "torch", quant), config=Config(
        model_name="t", device="cpu", dtype=dtype, megakernel=True))
    eng._mega_packed = {}
    mega = eng._spec_mega(bucket, n, k)
    target = V if mega is not None else F
    if draft is None:
        return target
    kernels = eng._draft_kernels(draft, _shape_params(draft, dtype, "torch", dquant), mega)
    if kernels is None:
        return target, E
    dmega = {"cfg": draft.config, "kind": draft.name,
             "packed": {} if kernels[0] else None, "burst_packed": {} if kernels[1] else None}
    return target, tspec.draft_route(draft, dmega, tspec.spec_capacity(bucket, n, k, True),
                                     dtype)


def _spec_pair(kw):
    if "n_embd" in kw:
        return jreg.gpt2_spec(jgpt2.GPT2Config(**kw)), treg.gpt2_spec(tgpt2.GPT2Config(**kw))
    return (jllama.llama_spec(jllama.LlamaConfig(**kw)),
            tllama.llama_spec(tllama.LlamaConfig(**kw)))


def _served(name: str, wq):
    """(JAX spec, port spec, (mode, group)) of registry `name` at
    weight_quant `wq` (None: full precision), as the engines serve it."""
    if wq is None:
        return jreg.spec_by_name(name), treg.spec_by_name(name), ("fp", 0)
    jcfg, tcfg, mode, group = served_configs(name, wq)
    if name.startswith("gpt2"):
        return jreg.gpt2_spec(jcfg), treg.gpt2_spec(tcfg), (mode, group)
    return jllama.llama_spec(jcfg), tllama.llama_spec(tcfg), (mode, group)


def _quant_of(wq):
    """(mode, group) of a weight_quant for a byte-vocab target (int4 at the
    engine's group 128)."""
    return ("fp", 0) if wq is None else (("int8", 0) if wq == "int8" else ("int4", 128))


def test_routes_match_the_table():
    """The routing table over registry names and the two draft geometries
    (draft_gpt2's head_dim 32 included), full-precision and quantized
    targets: JAX's and the port's routes, each difference named above."""
    for key, want in TARGET_ROUTES.items():
        name, bucket, wq = (*key, None)[:3]
        n = 64 if bucket == 256 else 512
        js, ts, quant = _served(name, wq)
        got = (_jax_routes(js, jnp.bfloat16, bucket, n, 8, quant=quant),
               _port_routes(ts, torch.bfloat16, bucket, n, 8, quant=quant))
        assert got == want, (key, got)
    for key, want in DRAFT_ROUTES.items():
        target, draft, dt, n, wq = (*key, None)[:5]
        if draft == "self":  # the 1-layer self-draft of a registry target
            jt, tt, quant = _served(target, wq)
            jd, _ = jspec.make_self_draft(jt, {"blocks": {}}, 1)
            td, _ = tspec.make_self_draft(tt, {"blocks": {}}, 1)
            dquant = quant
        else:
            (jt, tt), quant = _spec_pair(TARGET_KW[target]), _quant_of(wq)
            (jd, td), dquant = _spec_pair(DRAFT_KW[draft]), ("fp", 0)
        got = (_jax_routes(jt, getattr(jnp, dt), 128, n, 4, draft=jd, quant=quant,
                           dquant=dquant),
               _port_routes(tt, getattr(torch, dt), 128, n, 4, draft=td, quant=quant,
                            dquant=dquant))
        assert got == want, (key, got)


def test_self_draft_shares_the_target():
    jspec_t, _, tspec_t, tp = _models("llama", FAMILIES["llama"][0], seed=3)
    dspec, dparams = tspec.make_self_draft(tspec_t, tp, 1)
    assert dspec.n_layer == 1 and dspec.config == dataclasses.replace(tspec_t.config,
                                                                      n_layer=1)
    assert dparams["embed"] is tp["embed"]
    assert all(t.data_ptr() == tp["blocks"][n].data_ptr() and t.shape[0] == 1
               for n, t in dparams["blocks"].items())
    jd, _ = jspec.make_self_draft(jspec_t, to_jax(np_llama_params(tspec_t.config, 3)), 1)
    assert jd.n_layer == dspec.n_layer and jd.head_dim == dspec.head_dim
