"""The port's weight quantization (`Config.weight_quant`, the JAX engine's
serving mode) against the JAX package's, on the CPU in fp32.

* The quantizers (`quantize_int8_weights`, `quantize_int4_weights`,
  `quantize_gpt2_weights`, `quantize_llama_weights`, `pad_llama_ffn`) are
  bit-exact with JAX's called op by op, as the JAX engine calls them;
  `init_quantized_llama_params` equals quantize-after-init.
* `params_from_jax` carries a quantized tree: integer codes, fp32 scales.
* The models' forward on quantized weights gives JAX's logits within 1e-5
  of their largest value (prefill of 9 tokens).
* `InferenceEngine.from_model_name` with `weight_quant` int8 / int4 /
  int4w8 (megakernel on: the plain steps; and off) makes the tree JAX's
  from_model_name makes (its group and FFN pad) and gives the JAX engine's
  greedy tokens on it (megakernel off, XLA) for full_cache and a quant_*
  method, GPT-2 and Llama, and a Qwen-shaped model served at the int4w8
  padded FFN.
* Speculation, generate_batch, MegaBatchServer and the verify and batched
  launchers serve quantized weights (the four tests that pinned their
  raises, rewritten in place; tests/test_torch_weight_quant_serving.py
  holds them to the JAX engine); the `ops` / `ops.pallas` namespaces hold
  JAX's names.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import efficient_llm_inference_tpu.engine.engine as jengine_mod
import efficient_llm_inference_tpu.ops as jops
import efficient_llm_inference_tpu.ops.pallas as jpallas
import efficient_llm_inference_tpu_torch.engine.engine as tengine_mod
import efficient_llm_inference_tpu_torch.ops as tops
import efficient_llm_inference_tpu_torch.ops.pallas as tpallas
from efficient_llm_inference_tpu.cache import kvcache as jkv
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
from efficient_llm_inference_tpu_torch.cache import kvcache as tkv
from efficient_llm_inference_tpu_torch.data.tokenizer import ByteTokenizer
from efficient_llm_inference_tpu_torch.models import gpt2 as tgpt2
from efficient_llm_inference_tpu_torch.models import llama as tllama
from efficient_llm_inference_tpu_torch.models import registry as tregistry
from efficient_llm_inference_tpu_torch.ops import megakernel as tmk
from torch_port_helpers import np_gpt2_params, np_llama_params, to_jax, to_numpy

GPT2_KW = dict(vocab_size=300, n_positions=256, n_embd=128, n_layer=2, n_head=2)
# The engine's GPT-2: E = 256, so that int4 at the engine's group 128 is
# megakernel-eligible ((E/2) % G == 0; at E = 128 both packages refuse it).
GPT2_ENGINE_KW = dict(GPT2_KW, n_embd=256)
LLAMA_KW = dict(vocab_size=300, hidden_size=256, intermediate_size=512, n_layer=2,
                n_head=4, n_kv_head=2, n_positions=512, rope_theta=10000.0,
                tie_embeddings=True)
# A Qwen shape whose FFN the int4w8 group does not divide: tile geometry
# (TR, TC, Ip) = (256, 128, 768), group TR/2 = 128, I 704 -> 768.
QWEN_KW = dict(LLAMA_KW, intermediate_size=704, qkv_bias=True, rms_eps=1e-6)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_equal(got: dict, want: dict, path=""):
    """Port tree (tensors) == JAX tree (arrays), bit for bit, keys, dtypes
    (int8 codes, uint8 nibbles, fp32 scales) and all."""
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_trees_equal(got[k], w, f"{path}{k}.")
            continue
        g, w = got[k].numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (path + k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=path + k)


# ------------------------------------------------------------- namespaces


def _public(module) -> set:
    return {n for n in dir(module) if not n.startswith("_")
            and not isinstance(getattr(module, n), types.ModuleType)}


def test_ops_namespaces_hold_the_jax_names():
    assert _public(jops) <= _public(tops), _public(jops) - _public(tops)
    assert _public(tpallas) == _public(jpallas)
    assert _public(tpallas) <= _public(tops)


def test_config_takes_the_jax_weight_quant_values():
    for wq in (None, "int8", "int4", "int4w8"):
        assert Config(device="cpu", weight_quant=wq).weight_quant == wq
    with pytest.raises(ValueError, match="weight_quant"):
        Config(device="cpu", weight_quant="int2")


# -------------------------------------------------------------- quantizers

QUANT_CASES = {  # name: (shape [..., K, F], mode, group)
    "int8-stacked": ((2, 96, 40), "int8", None),
    "int8-head": ((64, 300), "int8", None),
    "int4-g128": ((2, 256, 40), "int4", 128),
    "int4-g128-K96": ((96, 30), "int4", 128),  # K % group: one group of K
    "int4-odd-group": ((2, 30, 8), "int4", 15),  # odd group: one group of K
    "int4-g64": ((512, 24), "int4", 64),
}


@pytest.mark.parametrize("case", list(QUANT_CASES))
def test_weight_quantizers_bit_exact(case):
    shape, mode, group = QUANT_CASES[case]
    rng = np.random.default_rng(len(case))
    w = (rng.standard_normal(shape) * rng.random(shape[-1]) * 0.3).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero column: the 1e-8 scale floor
    if mode == "int8":
        got = tgpt2.quantize_int8_weights(torch.tensor(w))
        want = jgpt2.quantize_int8_weights(jnp.asarray(w))
    else:
        got = tgpt2.quantize_int4_weights(torch.tensor(w), group)
        want = jgpt2.quantize_int4_weights(jnp.asarray(w), group)
    _assert_trees_equal(got, _np(want))
    if mode == "int4":  # _int4_dot on these codes, as the model's _mm runs it
        x = rng.standard_normal((3, shape[-2])).astype(np.float32)
        q4, s = got["q4"], got["s"]
        if q4.dim() == 4:
            q4, s, want = q4[1], s[1], {k: v[1] for k, v in want.items()}
        np.testing.assert_allclose(
            tgpt2._int4_dot(torch.tensor(x), q4, s).numpy(),
            np.asarray(jgpt2._int4_dot(jnp.asarray(x), want["q4"], want["s"])),
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("family", ["gpt2", "llama-tied", "llama-untied"])
def test_model_quantizers_bit_exact(family, mode):
    """quantize_gpt2_weights / quantize_llama_weights: every matmul weight,
    the LM-head copy (from wte.T, embed.T or lm_head) and the untouched
    rest; `lm_head` is dropped."""
    if family == "gpt2":
        np_p = np_gpt2_params(tgpt2.GPT2Config(**GPT2_KW), seed=3)
        tq, jq = tgpt2.quantize_gpt2_weights, jgpt2.quantize_gpt2_weights
        convert = tgpt2.params_from_jax
        cfg = tgpt2.GPT2Config(**GPT2_KW)
    else:
        cfg = tllama.LlamaConfig(**dict(LLAMA_KW, tie_embeddings=family == "llama-tied"))
        np_p = np_llama_params(cfg, seed=3)
        tq, jq = tllama.quantize_llama_weights, jllama.quantize_llama_weights
        convert = tllama.params_from_jax
    got = tq(convert(np_p, cfg, torch.float32, "cpu"), mode=mode, group=64)
    want = _np(jq(to_jax(np_p), mode=mode, group=64))
    assert "lm_head" not in got
    _assert_trees_equal(got, want)
    # params_from_jax carries JAX's quantized tree as it is
    _assert_trees_equal(convert(want, cfg, torch.float32, "cpu"), want)


def test_params_from_jax_rejects_a_malformed_quantized_weight():
    cfg = tgpt2.GPT2Config(**GPT2_KW)
    tree = _np(jgpt2.quantize_gpt2_weights(to_jax(np_gpt2_params(cfg, seed=3))))
    tree["blocks"]["fc_w"] = {"q": tree["blocks"]["fc_w"]["q"]}
    with pytest.raises(ValueError, match="fc_w"):
        tgpt2.params_from_jax(tree, cfg, torch.float32, "cpu")


def test_init_quantized_llama_params_equals_quantize_after_init():
    cfg = tllama.LlamaConfig(**dict(LLAMA_KW, tie_embeddings=False))
    for mode in ("int8", "int4"):
        got = tllama.init_quantized_llama_params(torch.Generator().manual_seed(4), cfg,
                                                 mode, torch.float32, "cpu", group=64)
        want = tllama.quantize_llama_weights(tllama.init_llama_params(
            torch.Generator().manual_seed(4), cfg, torch.float32, "cpu"), mode, 64)
        _assert_trees_equal(got, to_numpy(want))


def test_pad_llama_ffn_exact():
    cfg = tllama.LlamaConfig(**QWEN_KW)
    np_p = np_llama_params(cfg, seed=6)
    got = tllama.pad_llama_ffn(tllama.params_from_jax(np_p, cfg, torch.float32, "cpu"), 768)
    _assert_trees_equal(got, _np(jllama.pad_llama_ffn(to_jax(np_p), 768)))


@pytest.mark.parametrize("name,group,inter", [("llama-3-1b", 1024, 8192),
                                              ("qwen2.5-0.5b", 448, 5376)])
def test_int4w8_llama_spec_matches_jax(name, group, inter):
    """The engine's int4w8 plan (group, padded FFN) is JAX's
    `_int4w8_llama_spec` with padding allowed, the only form the port
    serves; the other weight_quant values keep the spec at group 128."""
    spec = tregistry.spec_by_name(name)
    t_spec, mode, t_group = tengine_mod.weight_quant_plan(spec, "int4w8")
    j_spec, j_group = jengine_mod._int4w8_llama_spec(jregistry.spec_by_name(name), True)
    assert (mode, t_group, t_spec.config.intermediate_size) == ("int4", group, inter)
    assert (j_group, j_spec.config.intermediate_size) == (group, inter)
    assert (t_spec is spec) == (inter == spec.config.intermediate_size)
    for wq in ("int8", "int4"):
        assert tengine_mod.weight_quant_plan(spec, wq) == (spec, wq, 128)


def test_int4w8_gpt2_plan_is_half_width():
    spec = tregistry.spec_by_name("gpt2")
    assert tengine_mod.weight_quant_plan(spec, "int4w8") == (spec, "int4", 384)
    assert tengine_mod.weight_quant_plan(spec, None) == (spec, None, 128)


# ------------------------------------------------------------------ forward


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_forward_logits_match_jax(family, mode):
    """Prefill of 9 tokens over carried quantized params: the logits within
    1e-5 of their largest value (fp32 sums in another order)."""
    if family == "gpt2":
        tcfg, jcfg = tgpt2.GPT2Config(**GPT2_KW), jgpt2.GPT2Config(**GPT2_KW)
        np_p = np_gpt2_params(tcfg, seed=7, std=0.1)
        jq = jgpt2.quantize_gpt2_weights(to_jax(np_p), mode=mode, group=64)
        tp = tgpt2.params_from_jax(_np(jq), tcfg, torch.float32, "cpu")
        tfwd, jfwd, H = tgpt2.gpt2_forward, jgpt2.gpt2_forward, tcfg.n_head
    else:
        kw = dict(LLAMA_KW, tie_embeddings=False)
        tcfg, jcfg = tllama.LlamaConfig(**kw), jllama.LlamaConfig(**kw)
        np_p = np_llama_params(tcfg, seed=7, std=0.15)
        jq = jllama.quantize_llama_weights(to_jax(np_p), mode=mode, group=64)
        tp = tllama.params_from_jax(_np(jq), tcfg, torch.float32, "cpu")
        tfwd, jfwd, H = tllama.llama_forward, jllama.llama_forward, tcfg.n_kv_head
    kw = dict(n_layer=tcfg.n_layer, n_head=H, head_dim=tcfg.head_dim, capacity=16)
    js, ts = jkv.DenseKV(**kw), tkv.DenseKV(**kw, device="cpu")
    tokens = np.random.default_rng(8).integers(0, 300, (1, 9))
    pos = np.arange(9)[None]
    jl, _ = jfwd(jq, jcfg, jnp.asarray(tokens, jnp.int32), jnp.asarray(pos, jnp.int32),
                 js.init(), js)
    tl, _ = tfwd(tp, tcfg, torch.tensor(tokens), torch.tensor(pos), ts.init(), ts)
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, atol=1e-5 * np.abs(jl).max(), rtol=0)


# ------------------------------------------------------------------- engine

ENGINE_CASES = {  # (family, weight_quant)
    **{f"gpt2-{wq}": ("gpt2", wq) for wq in ("int8", "int4", "int4w8")},
    **{f"llama-{wq}": ("llama", wq) for wq in ("int8", "int4", "int4w8")},
    "qwen-int4w8-padded": ("qwen", "int4w8"),
}
PROMPT, N_NEW = "the quick brown fox jumps over", 8


def _engines(monkeypatch, family, wq):
    """The port's engines through from_model_name with full-precision numpy
    params and `weight_quant` (megakernel on and off; the registry returns
    the small test geometry for the name), and the JAX engine (megakernel
    off, XLA) on the same quantized tree at JAX's own spec (the int4w8
    padded FFN). The tree is the one JAX's from_model_name makes: the
    port's quantizers are bit-exact with JAX's (the tests above), and the
    port's params are checked against them at JAX's group and pad."""
    if family == "gpt2":
        cfgs = (jgpt2.GPT2Config(**GPT2_ENGINE_KW), tgpt2.GPT2Config(**GPT2_ENGINE_KW))
        np_p = np_gpt2_params(cfgs[1], seed=9, std=0.1)
        specs = (jregistry.gpt2_spec(cfgs[0]), tregistry.gpt2_spec(cfgs[1]))
        name, mod, quantize = "gpt2", tgpt2, tgpt2.quantize_gpt2_weights
        group = cfgs[1].n_embd // 2 if wq == "int4w8" else 128
    else:
        kw = LLAMA_KW if family == "llama" else QWEN_KW
        cfgs = (jllama.LlamaConfig(**kw), tllama.LlamaConfig(**kw))
        np_p = np_llama_params(cfgs[1], seed=9, std=0.15)
        specs = (jllama.llama_spec(cfgs[0]), tllama.llama_spec(cfgs[1]))
        name, mod, quantize = "llama-3-1b", tllama, tllama.quantize_llama_weights
        group = 128
        if wq == "int4w8":  # JAX's choice of group and FFN width
            jspec, group = jengine_mod._int4w8_llama_spec(specs[0], True)
            specs = (jspec, specs[1])
    monkeypatch.setattr(tengine_mod, "spec_by_name", lambda _: specs[1])
    tengs = {mega: InferenceEngine.from_model_name(
        name, tokenizer=ByteTokenizer(),
        params=mod.params_from_jax(np_p, cfgs[1], torch.float32, "cpu"),
        config=Config(model_name=name, device="cpu", dtype=torch.float32,
                      megakernel=mega, weight_quant=wq)) for mega in (True, False)}
    fp = mod.params_from_jax(np_p, cfgs[1], torch.float32, "cpu")
    if family != "gpt2":
        fp = tllama.pad_llama_ffn(fp, specs[0].config.intermediate_size)
    want = quantize(fp, mode="int8" if wq == "int8" else "int4", group=group)
    _assert_trees_equal(tengs[True].params, to_numpy(want))
    jeng = jengine_mod.InferenceEngine(
        specs[0], to_jax(to_numpy(want)), tokenizer=JaxByteTokenizer(),
        config=JaxConfig(model_name=name, device="cpu", dtype=jnp.float32,
                         megakernel=False))
    return jeng, tengs


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
@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_weight_quant_tokens_match_jax(monkeypatch, case):
    family, wq = ENGINE_CASES[case]
    jeng, tengs = _engines(monkeypatch, family, wq)
    if family == "qwen":  # both serve the padded FFN
        assert jeng.model.config.intermediate_size == 768
        assert tengs[True].model.config.intermediate_size == 768
    for method in ("full_cache", "quant_int8" if wq == "int4" else "quant_mixed"):
        want = jeng.generate_ids(PROMPT, method, N_NEW)
        for mega, teng in tengs.items():
            assert teng.generate_ids(PROMPT, method, N_NEW) == want, (method, mega)
        assert len(set(want[-N_NEW:])) > 1  # not one repeated token
    assert tengs[True]._mega_packed is not None  # the megakernel path ran
    assert tmk.weight_kind(tengs[True]._mega_packed) == wq[:4]
    assert tengs[False]._mega_packed is None


def test_engine_refuses_to_quantize_quantized_params():
    """weight_quant over params that are already quantized: the JAX engine
    would quantize them again and fail; the port says so."""
    cfg = tgpt2.GPT2Config(**GPT2_KW)
    q = tgpt2.quantize_gpt2_weights(tgpt2.init_gpt2_params(
        torch.Generator().manual_seed(0), cfg, torch.float32, "cpu"))
    with pytest.raises(ValueError, match="already quantized"):
        InferenceEngine.from_model_name("gpt2", params=q, config=Config(
            device="cpu", weight_quant="int8"))


# ------------------------------------------------------------------- routes


@pytest.fixture(scope="module")
def quantized_engine():
    cfg = tgpt2.GPT2Config(**GPT2_KW)
    q = tgpt2.quantize_gpt2_weights(tgpt2.params_from_jax(
        np_gpt2_params(cfg, seed=9), cfg, torch.float32, "cpu"), "int4", 64)
    return InferenceEngine(tregistry.gpt2_spec(cfg), q, config=Config(
        device="cpu", dtype=torch.float32, megakernel=True))


@pytest.mark.usefixtures("one_thread")
def test_speculation_on_quantized_weights_raises(quantized_engine):
    """Formerly the raise of speculation on quantized weights: the route now
    serves, through the verify's weight tier (the engine's int4 pack), with
    the tokens of plain greedy (the JAX engine's, tests/
    test_torch_weight_quant_serving.py)."""
    eng = quantized_engine
    want = eng.generate_ids(PROMPT, "full_cache", 8)
    eng.generate_speculative(PROMPT, 8, mode="ngram", k=4)
    assert eng.last_generation_ids == want
    key = next(k for k in eng._fns if k[:2] == ("speculative", "ngram"))
    assert tmk.weight_kind(eng._fns[key][-1]["packed"]) == "int4"
    eng.generate_speculative_auto(PROMPT, 8)
    assert eng.last_generation_ids == want


@pytest.mark.usefixtures("one_thread")
def test_generate_batch_on_quantized_weights_raises(quantized_engine):
    """Formerly the raise of generate_batch on quantized weights: the batched
    tier steps now serve it, each row its prompt's greedy decode."""
    eng = quantized_engine
    prompts = [PROMPT, "a"]
    eng.generate_batch(prompts, 8, kv_mode="int8")
    assert any(k[0] == "batch" and k[-1] == "int8" for k in eng._fns)
    assert eng.last_batch_ids == [eng.generate_ids(p, "quant_int8", 8) for p in prompts]


@pytest.mark.usefixtures("one_thread")
def test_server_on_quantized_weights_raises(quantized_engine):
    """Formerly the raise of MegaBatchServer on quantized weights: the server
    now packs the tiers and serves its requests' greedy decodes."""
    eng = quantized_engine
    srv = MegaBatchServer(eng.model, eng.params,
                          pool=MegaPoolConfig(n_slots=2, capacity=64, max_chunk=8),
                          dtype=torch.float32)
    assert tmk.weight_kind(srv.packed) == "int4"
    reqs = [Request(0, list(PROMPT.encode()), 8), Request(1, [97], 8)]
    srv.run(reqs)
    for r in reqs:
        assert r.prompt_ids + r.out_ids == eng.generate_ids(
            bytes(r.prompt_ids).decode(), "full_cache", 8)


def test_verify_and_batched_launchers_refuse_weight_tiers(quantized_engine):
    """Formerly the launchers' refusal of a weight tier: they now take a
    packed dict that has one (and stop only at the device, before any
    kernel), and the batched gates take the weights."""
    from efficient_llm_inference_tpu_torch.ops import megakernel_batch as tmb
    from efficient_llm_inference_tpu_torch.ops import megakernel_batch_verify as tbv

    cfg = quantized_engine.model.config
    packed = tmk.pack_gpt2_mega(quantized_engine.params, cfg)
    L, E = cfg.n_layer, cfg.n_embd
    k1, k2 = torch.zeros(L, 64, E), torch.zeros(L, 2, 64, E)
    n1, n2 = torch.zeros(1, dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
    for launcher, k, n, kw in (
            (tmk.GPT2VerifyLauncher, k1, n1, dict(rows=4, tok_in=torch.zeros(4))),
            (tmb.GPT2BatchLauncher, k2, n2, dict(tok_in=n2)),
            (tbv.GPT2BatchVerifyLauncher, k2, n2, dict(rows=2, tok_in=torch.zeros(4)))):
        with pytest.raises(ValueError, match="no kernel for device cpu"):
            launcher(packed, cfg, k, k, n, n, **kw)
    assert tmk.mega_supported(cfg, 64, quantized_engine.params)
    assert tmb.mega_batch_supported(cfg, 64, quantized_engine.params, 2)
    assert tbv.mega_batch_verify_supported(cfg, 64, quantized_engine.params, 2, 4)
    for wrapper in (tmk.gpt2_megaverify, tmb.gpt2_megabatch, tbv.gpt2_megabatch_verify):
        assert tmk.launch_counter(wrapper, packed) is wrapper.tiers["int4"]
