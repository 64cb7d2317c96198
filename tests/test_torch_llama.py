"""The port's Llama/Qwen family (models/llama.py, the registry's llama
branch, the engine's megakernel-off path) against the JAX package's, on the
CPU in fp32, on numpy-made params.

* `LlamaConfig.by_name` gives the JAX package's geometry for every name;
  `rope_cos_sin` its jitted tables within 1e-6 up to position 8191.
* `params_from_jax` and `params_from_hf_state_dict` give the JAX converter's
  arrays, bit for bit.
* `llama_forward` (a prefill and a decode step) gives the JAX logits within
  1e-5 with DenseKV and QuantizedKV, at query groups G = 2, 4 and 7, with the
  Qwen bias and an untied head; QuantizedKV's codes and scales are
  bit-exact against the JAX forward under jit.
* The engine (megakernel off) gives the JAX engine's greedy tokens for
  full_cache and quant_int8/int4/mixed.
* The repairs of the port's Config and error messages.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficient_llm_inference_tpu.cache import kvcache as jkv
from efficient_llm_inference_tpu.core.config import Config as JaxConfig
from efficient_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine
from efficient_llm_inference_tpu.models import llama as jllama
from efficient_llm_inference_tpu_torch import Config, InferenceEngine
from efficient_llm_inference_tpu_torch.cache import kvcache as tkv
from efficient_llm_inference_tpu_torch.engine.engine import _check_method
from efficient_llm_inference_tpu_torch.engine.generate import SamplingParams
from efficient_llm_inference_tpu_torch.models import llama as tllama
from efficient_llm_inference_tpu_torch.models.registry import spec_by_name
from torch_port_helpers import np_llama_params, to_jax

NAMES = ("llama-3-8b", "llama3-8b", "llama-3-1b", "llama-3-3b", "llama-tiny",
         "qwen2.5-7b", "qwen/qwen2.5-7b", "Qwen2.5-1.5b", "qwen2.5-0.5b",
         "qwen-tiny")
BASE = dict(vocab_size=300, hidden_size=256, intermediate_size=512, n_layer=2,
            n_head=4, n_kv_head=2, n_positions=512, rope_theta=10000.0,
            tie_embeddings=True)
GEOMETRIES = {
    "g2": {},
    "g4-qwen": dict(n_head=8, n_kv_head=2, hidden_size=512, qkv_bias=True,
                    rms_eps=1e-6, rope_theta=1e6),
    "g7-untied": dict(n_head=7, n_kv_head=1, hidden_size=448,
                      tie_embeddings=False),
}


def _cfgs(**over):
    kw = dict(BASE, **over)
    return jllama.LlamaConfig(**kw), tllama.LlamaConfig(**kw)


@pytest.mark.parametrize("name", NAMES)
def test_by_name_matches_jax(name):
    want = dataclasses.asdict(jllama.LlamaConfig.by_name(name))
    got = dataclasses.asdict(tllama.LlamaConfig.by_name(name))
    want.pop("scan_unroll")  # a TPU compile knob (Config.scan_unroll)
    assert got == want
    assert tllama.LlamaConfig.by_name(name).head_dim == jllama.LlamaConfig.by_name(name).head_dim
    spec = spec_by_name(name.lower() if name.startswith("Q") else name)
    assert spec.name == "llama" and spec.n_kv_head == got["n_kv_head"]


@pytest.mark.parametrize("name", ["llama-3-1b", "qwen2.5-0.5b"])
def test_param_bytes_estimate_matches_jax(name):
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        assert tllama.param_bytes_estimate(tllama.LlamaConfig.by_name(name), tdt) == \
            jllama.param_bytes_estimate(jllama.LlamaConfig.by_name(name), jdt)


def test_registry_errors():
    with pytest.raises(ValueError, match="Unknown llama variant"):
        spec_by_name("llama-99b")
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        spec_by_name("mixtral-tiny")
    with pytest.raises(ValueError, match="Unknown model"):
        spec_by_name("bert")


@pytest.mark.parametrize("head_dim,theta", [(64, 500000.0), (128, 1e6), (64, 1e6),
                                            (16, 10000.0), (64, 10000.0)])
def test_rope_cos_sin_matches_jax(head_dim, theta):
    pos = np.arange(8192, dtype=np.int32)[None]
    cj, sj = jax.jit(jllama.rope_cos_sin, static_argnums=(1, 2))(
        jnp.asarray(pos), head_dim, theta)
    ct, st = tllama.rope_cos_sin(torch.tensor(pos), head_dim, theta)
    assert ct.dtype == torch.float32 and ct.shape == (1, 8192, head_dim)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6, rtol=0)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6, rtol=0)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_params_from_jax_and_hf_match_jax(geometry):
    jcfg, tcfg = _cfgs(**GEOMETRIES[geometry])
    np_p = np_llama_params(tcfg, seed=1)
    tp = tllama.params_from_jax(np_p, tcfg, torch.float32, "cpu")
    L = tcfg.n_layer
    hf_names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
                "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
                "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
                "w_down": "mlp.down_proj"}
    sd = {"model.embed_tokens.weight": torch.tensor(np_p["embed"]),
          "model.norm.weight": torch.tensor(np_p["ln_f"])}
    b = np_p["blocks"]
    for i in range(L):
        pre = f"model.layers.{i}."
        sd[pre + "input_layernorm.weight"] = torch.tensor(b["ln1"][i])
        sd[pre + "post_attention_layernorm.weight"] = torch.tensor(b["ln2"][i])
        for short, hf in hf_names.items():
            sd[pre + hf + ".weight"] = torch.tensor(b[short][i].T.copy())
        if tcfg.qkv_bias:
            for short, proj in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
                sd[pre + f"self_attn.{proj}.bias"] = torch.tensor(b[short][i])
    if not tcfg.tie_embeddings:
        sd["lm_head.weight"] = torch.tensor(np_p["lm_head"].T.copy())
    want = jax.tree.map(np.asarray, jllama.params_from_hf_state_dict(sd, jcfg))
    got = tllama.params_from_hf_state_dict(sd, tcfg, torch.float32, "cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_w) == len(jax.tree.leaves(to_jax(np_p)))
    for path, w in flat_w:
        keys = [p.key for p in path]
        g, t = got, tp
        for k in keys:
            g, t = g[k], t[k]
        np.testing.assert_array_equal(g.numpy(), w, err_msg=str(keys))
        np.testing.assert_array_equal(t.numpy(), w, err_msg=str(keys))
    with pytest.raises(ValueError, match="shape"):
        bad = dict(np_p, embed=np_p["embed"][:-1])
        tllama.params_from_jax(bad, tcfg, device="cpu")


def test_init_llama_params_shapes_and_scale():
    cfg = dataclasses.replace(tllama.LlamaConfig.qwen_tiny(), tie_embeddings=False)
    p = tllama.init_llama_params(torch.Generator().manual_seed(0), cfg,
                                 torch.bfloat16, "cpu")
    shapes = tllama.param_shapes(cfg)
    assert p["lm_head"].shape == shapes["lm_head"] and "bq" in p["blocks"]
    for k, shape in shapes["blocks"].items():
        assert p["blocks"][k].shape == shape and p["blocks"][k].dtype == torch.bfloat16
    std = p["blocks"]["wq"].float().std().item()
    assert 0.015 < std < 0.025
    assert p["blocks"]["w_down"].float().std().item() < std / 1.5  # 1/sqrt(2L)
    same = tllama.init_llama_params(torch.Generator().manual_seed(0), cfg,
                                    torch.bfloat16, "cpu")
    assert torch.equal(same["embed"], p["embed"])


# ------------------------------------------------------------------ forward

KV_KINDS = ["dense", "int8", "int4", "mixed"]


def _strategies(kind, cfg, capacity):
    kw = dict(n_layer=cfg.n_layer, n_head=cfg.n_kv_head, head_dim=cfg.head_dim,
              capacity=capacity, batch=1)
    if kind == "dense":
        return (jkv.DenseKV(**kw, dtype=jnp.float32),
                tkv.DenseKV(**kw, dtype=torch.float32, device="cpu"))
    return (jkv.QuantizedKV(**kw, dtype=jnp.float32, mode=kind),
            tkv.QuantizedKV(**kw, dtype=torch.float32, device="cpu", mode=kind))


def _forward_both(jcfg, tcfg, np_p, kind):
    """A 13-token prefill (right-padded to 16) then one decode step through
    both packages (JAX under jit); returns (JAX, port) pairs of the logits
    and the caches."""
    jp, tp = to_jax(np_p), tllama.params_from_jax(np_p, tcfg, torch.float32, "cpu")
    js, ts = _strategies(kind, tcfg, 32)
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size, (1, 16))
    T0 = 13
    pos = np.arange(16)[None]
    mask = (np.arange(16) < T0)[None]

    @jax.jit
    def jfwd(params, tokens, positions, cache, seq_mask):
        return jllama.llama_forward(params, jcfg, tokens, positions, cache, js, seq_mask)

    @jax.jit
    def jstep(params, tokens, positions, cache):
        return jllama.llama_forward(params, jcfg, tokens, positions, cache, js)

    jl0, jc = jfwd(jp, jnp.asarray(toks), jnp.asarray(pos), js.init(), jnp.asarray(mask))
    jc = js.set_length(jc, T0)
    tl0, tc = tllama.llama_forward(tp, tcfg, torch.tensor(toks), torch.tensor(pos),
                                   ts.init(), ts, torch.tensor(mask))
    tc = ts.set_length(tc, T0)
    nxt = int(np.asarray(jl0)[0, T0 - 1].argmax())
    assert int(tl0[0, T0 - 1].argmax()) == nxt
    jl1, jc = jstep(jp, jnp.asarray([[nxt]]), jnp.asarray([[T0]]), jc)
    tl1, tc = tllama.llama_forward(tp, tcfg, torch.tensor([[nxt]]), torch.tensor([[T0]]),
                                   tc, ts, None)
    logits = [(np.asarray(jl0)[0, :T0], tl0[0, :T0].numpy()),
              (np.asarray(jl1), tl1.numpy())]
    return logits, jc, tc


def _codes(cache, name, n):
    """The first n cached tokens of a cache tensor ([L, 1, H, C, D(/2)]
    codes, [L, C] scales), as numpy."""
    a = np.asarray(cache[name]) if not isinstance(cache[name], torch.Tensor) \
        else cache[name].numpy()
    return a[..., :n, :] if a.ndim == 5 else a[..., :n]


@pytest.mark.parametrize("kind", KV_KINDS)
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_forward_matches_jax(geometry, kind):
    """Logits within 1e-5 (weights at std 0.05, logits up to ~4); the
    quantized cache's codes within one step and scales to rtol 1e-6 (the K/V
    projections are fp32 sums in another order than XLA's)."""
    jcfg, tcfg = _cfgs(**GEOMETRIES[geometry])
    np_p = np_llama_params(tcfg, seed=2, std=0.05, embed_std=0.05)
    logits, jc, tc = _forward_both(jcfg, tcfg, np_p, kind)
    for want, got in logits:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if kind == "dense":
        return
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(_codes(tc, name, 14), _codes(jc, name, 14),
                                   rtol=1e-6, atol=0, err_msg=name)
    for name in ("k", "v"):
        pk = "int8" if (kind == "int8" or (kind == "mixed" and name == "k")) else "int4"
        got, want = (torch.tensor(_codes(c, name, 14)) for c in (tc, jc))
        if pk == "int4":
            from efficient_llm_inference_tpu_torch.ops.quantization import unpack_int4
            got, want = unpack_int4(got), unpack_int4(want)
        assert (got.int() - want.int()).abs().max() <= 1, name


@pytest.mark.parametrize("kind", KV_KINDS[1:])
def test_quantized_cache_bit_exact_with_kv_reduced_to_bias(kind):
    """wk and wv zeroed, random q/k/v biases (the Qwen geometry): the cached
    V rows are the biases on both sides, and their codes and scales are
    bit-exact for all 14 cached tokens; so are the K codes, and the K scales
    at position 0, where RoPE is the identity. Elsewhere the cached K rows
    are the roped biases, and the RoPE tables differ by up to one fp32 ulp
    (XLA's fp32 cos/sin against the port's float64 ones rounded), which
    moves 2 of the 28 K scales by one ulp (rtol 1.2e-7)."""
    jcfg, tcfg = _cfgs(**GEOMETRIES["g4-qwen"])
    np_p = np_llama_params(tcfg, seed=2, std=0.05, embed_std=0.05)
    rng = np.random.default_rng(9)
    for name in ("wk", "wv"):
        np_p["blocks"][name][:] = 0.0
    for name in ("bk", "bv"):
        np_p["blocks"][name] = (rng.standard_normal(np_p["blocks"][name].shape)
                                * 0.7).astype(np.float32)
    _, jc, tc = _forward_both(jcfg, tcfg, np_p, kind)
    for name in ("k", "v", "v_scale"):
        np.testing.assert_array_equal(_codes(tc, name, 14), _codes(jc, name, 14),
                                      err_msg=name)
    got, want = _codes(tc, "k_scale", 14), _codes(jc, "k_scale", 14)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got, want, rtol=1.2e-7, atol=0)


# ------------------------------------------------------------------- engine

METHODS = ["full_cache", "quant_int8", "quant_int4", "quant_mixed"]
PROMPTS = ["The quick brown fox jumps.", "Caches trade memory for time!"]
N_NEW = 12


@pytest.fixture(scope="module", params=list(GEOMETRIES))
def engines(request):
    jcfg, tcfg = _cfgs(**GEOMETRIES[request.param])
    np_p = np_llama_params(tcfg, seed=7, std=0.15)
    jeng = JaxEngine(jllama.llama_spec(jcfg), to_jax(np_p), config=JaxConfig(
        model_name="t", device="cpu", dtype=jnp.float32, megakernel=False))
    teng = InferenceEngine(
        tllama.llama_spec(tcfg), tllama.params_from_jax(np_p, tcfg, torch.float32, "cpu"),
        config=Config(model_name="t", device="cpu", dtype=torch.float32))
    return jeng, teng


@pytest.mark.parametrize("method", METHODS)
def test_engine_tokens_match_jax(engines, method):
    jeng, teng = engines
    jres = jeng.benchmark_method(PROMPTS, method=method, max_new_tokens=N_NEW)
    tres = teng.benchmark_method(PROMPTS, method=method, max_new_tokens=N_NEW)
    assert tres.keys() == jres.keys()
    assert teng.last_generation_ids == jeng.last_generation_ids
    assert len(set(teng.last_generation_ids[-N_NEW:])) > 1
    assert teng._mega_packed is None  # the megakernel is off on the CPU by default
    if method != "full_cache":
        assert tres["est_kv_cache_mb_avg"] == pytest.approx(
            jres["est_kv_cache_mb_avg"], rel=1e-12)


def test_from_model_name_llama_tiny():
    cfg = Config(model_name="llama-tiny", device="cpu", megakernel=True)
    eng = InferenceEngine.from_model_name("llama-tiny", config=cfg)
    assert eng.model.name == "llama" and eng.params["embed"].shape == (256, 64)
    # E = 64 is not eligible for the megakernel: the off path serves
    assert eng._mega_spec(32, None) is None
    ids = eng.generate_ids("Hello", "quant_int8", 4)
    assert len(ids) == 5 + 4


# ------------------------------------------------------------------ repairs


def test_config_takes_the_jax_fields():
    """JAX `Config(max_new_tokens=..., scan_unroll=...)` carries over;
    scan_unroll is accepted and ignored."""
    cfg = Config(device="cpu", max_new_tokens=16, scan_unroll=4)
    assert cfg.max_new_tokens == 16 and cfg.scan_unroll == 4
    assert Config(device="cpu").max_new_tokens == JaxConfig(device="cpu").max_new_tokens == 64


@pytest.mark.parametrize("case", ["method", "sampling", "batch", "sampling_doc",
                                  "mixtral"])
def test_messages_cite_the_current_queue_items(case):
    """ROADMAP Queue 1: item 5 the 12-method registry, 6 sampling, 8
    batched serving, 10 Mixtral."""
    if case == "method":
        with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
            _check_method("sliding_window")
    elif case == "sampling":
        eng = InferenceEngine.from_model_name(
            "gpt2-tiny", config=Config(model_name="gpt2-tiny", device="cpu"))
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            eng.generate("Hi", max_new_tokens=2, sampling=SamplingParams(temperature=1.0))
    elif case == "batch":
        with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
            tkv.QuantizedKV(n_layer=1, n_head=1, head_dim=4, capacity=8, batch=2,
                            device="cpu")
    elif case == "sampling_doc":
        assert "Queue 1 item 6" in SamplingParams.__doc__
    else:
        with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
            spec_by_name("mixtral")
