"""The port's Llama whole-step decode (ops/megakernel_llama.py, #13 at R = 1)
against the JAX package's, on the CPU in fp32.

* The port's plain step against the JAX kernel (`llama_megastep`, Pallas
  interpret mode under jit, as the JAX engine runs it) at the JAX tests'
  geometry (E=256, Hq=4, Hkv=2, V=300, C=48), with tied, Qwen-bias and
  untied-head variants, and at C=1024 (several attention chunks of the JAX
  kernel): the token is equal, the new K/V rows agree within 1e-5 of the
  row's largest value (at least 1e-5; fp32 sums in another order, which at
  700 cached rows moves a layer-1 value of ~6 by ~1.2e-5) and every other
  row is bit-identical.
* The eligibility of every registry Llama/Qwen geometry for fp, int8 and
  int4 panes against the JAX package's; the differences are the TPU memory
  envelopes the port leaves out, each named.
* A port engine with megakernel=True gives the JAX engine's greedy tokens.
* bf16: the number of leading greedy tokens on which the port's plain steps
  and the JAX kernels agree in bf16 (interpret mode), stated as the bf16
  tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficient_llm_inference_tpu.core.config import Config as JaxConfig
from efficient_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine
from efficient_llm_inference_tpu.models import gpt2 as jgpt2
from efficient_llm_inference_tpu.models import llama as jllama
from efficient_llm_inference_tpu.ops.pallas import megakernel as jmk
from efficient_llm_inference_tpu.ops.pallas import megakernel_llama as jml
from efficient_llm_inference_tpu.ops.pallas import megakernel_quant as jmq
from efficient_llm_inference_tpu_torch import Config, InferenceEngine
from efficient_llm_inference_tpu_torch.models import gpt2 as tgpt2
from efficient_llm_inference_tpu_torch.models import llama as tllama
from efficient_llm_inference_tpu_torch.ops import megakernel as tmk
from efficient_llm_inference_tpu_torch.ops import megakernel_llama as tml
from efficient_llm_inference_tpu_torch.ops import megakernel_quant as tmq
from torch_port_helpers import jax_rope_rows, np_gpt2_params, np_llama_params, to_jax

CFG_KW = dict(vocab_size=300, hidden_size=256, intermediate_size=512, n_layer=2,
              n_head=4, n_kv_head=2, n_positions=512, rope_theta=10000.0,
              tie_embeddings=True)
VARIANTS = {
    "tied": {},
    "qwen_bias": dict(qkv_bias=True, rms_eps=1e-6),
    "untied": dict(tie_embeddings=False),
}
C = 48


def _cfgs(**over):
    kw = dict(CFG_KW, **over)
    return jllama.LlamaConfig(**kw), tllama.LlamaConfig(**kw)


@pytest.fixture(scope="module", params=list(VARIANTS))
def setup(request):
    jcfg, tcfg = _cfgs(**VARIANTS[request.param])
    np_params = np_llama_params(tcfg, seed=11, std=0.15)
    tparams = tllama.params_from_jax(np_params, tcfg, torch.float32, "cpu")
    return {
        "jcfg": jcfg, "tcfg": tcfg, "np": np_params, "tparams": tparams,
        "jpacked": jml.pack_llama_mega(to_jax(np_params), jcfg),
        "tpacked": tml.pack_llama_mega(tparams, tcfg),
    }


def _state(seed: int, KW: int, E: int, capacity: int):
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal((CFG_KW["n_layer"], capacity, KW)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((CFG_KW["n_layer"], capacity, KW)) * 0.5).astype(np.float32)
    x = (rng.standard_normal((1, E)) * 0.5).astype(np.float32)
    return k, v, x


def _kv_width(cfg):
    return cfg.n_kv_head * cfg.head_dim


@pytest.mark.parametrize("length,capacity", [(0, C), (7, C), (C - 1, C), (700, 1024)])
def test_megastep_matches_jax(setup, length, capacity):
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    k, v, x = _state(length, _kv_width(tcfg), tcfg.hidden_size, capacity)
    cos_q, sin_q = jax_rope_rows(jcfg, length)
    tok_j, k_j, v_j = jml.llama_megastep(
        setup["jpacked"], jnp.asarray(k), jnp.asarray(v), jnp.int32(length),
        jnp.asarray(x), cos_q, sin_q, cfg=jcfg, capacity=capacity, interpret=True)
    kt, vt = torch.tensor(k), torch.tensor(v)
    tok_t, k_t, v_t = tml.llama_megastep(setup["tpacked"], kt, vt, length,
                                         torch.tensor(x), cfg=tcfg)
    assert k_t is kt and v_t is vt  # written in place
    assert int(tok_t) == int(tok_j)
    k_j, v_j = np.asarray(k_j), np.asarray(v_j)
    others = np.arange(capacity) != length
    for got, want, before in ((k_t.numpy(), k_j, k), (v_t.numpy(), v_j, v)):
        atol = 1e-5 * max(1.0, np.abs(want[:, length]).max())
        np.testing.assert_allclose(got[:, length], want[:, length], atol=atol, rtol=0)
        assert not np.array_equal(got[:, length], before[:, length])
        np.testing.assert_array_equal(got[:, others], want[:, others])
        np.testing.assert_array_equal(got[:, others], before[:, others])


def test_plain_logits_choose_the_token(setup):
    tcfg = setup["tcfg"]
    k, v, x = _state(5, _kv_width(tcfg), tcfg.hidden_size, C)
    tok, _, _, logits = tml.llama_megastep_plain(
        setup["tpacked"], torch.tensor(k), torch.tensor(v), 9, torch.tensor(x),
        cfg=tcfg, return_logits=True)
    assert logits.shape == (tcfg.vocab_size,) and logits.dtype == torch.float32
    assert int(tok) == int(torch.argmax(logits))


def test_pack_layout(setup):
    """[out, in] rows: q|k|v stacked, gate and up interleaved, the head the
    embedding itself when tied; RoPE tables of every position."""
    tcfg, tp, pk = setup["tcfg"], setup["tparams"], setup["tpacked"]
    b = tp["blocks"]
    QW, KW, I = tcfg.n_head * tcfg.head_dim, _kv_width(tcfg), tcfg.intermediate_size
    torch.testing.assert_close(pk["qkv_w"][1, QW:QW + KW], b["wk"][1].t(), rtol=0, atol=0)
    torch.testing.assert_close(pk["gu_w"][0, 2 * 5], b["w_gate"][0][:, 5], rtol=0, atol=0)
    torch.testing.assert_close(pk["gu_w"][0, 2 * 5 + 1], b["w_up"][0][:, 5], rtol=0, atol=0)
    torch.testing.assert_close(pk["down_w"][1], b["w_down"][1].t(), rtol=0, atol=0)
    if tcfg.tie_embeddings:
        assert pk["head"].data_ptr() == tp["embed"].data_ptr()
    else:
        torch.testing.assert_close(pk["head"], tp["lm_head"].t(), rtol=0, atol=0)
    assert ("qkvb" in pk) == tcfg.qkv_bias
    assert pk["cos"].shape == (tcfg.n_positions, tcfg.head_dim)


# --------------------------------------------------------------- eligibility

REGISTRY = ("llama-3-8b", "llama3-8b", "llama-3-1b", "llama-3-3b", "llama-tiny",
            "qwen2.5-7b", "qwen/qwen2.5-7b", "qwen2.5-1.5b", "qwen2.5-0.5b",
            "qwen-tiny")
KV = ("fp", "int8", "int4")
# Where the JAX package refuses only because of a TPU memory envelope, the
# port accepts: the card streams the weights from its own 80 GB, and no
# VMEM-sized tile stream is involved. These are the cells, with the JAX
# condition that refuses them (ops/pallas/megakernel_llama.py
# mega_supported); every other cell must agree.
_STREAM_CAP = "packed tile stream over the 4 GiB cap (16 GiB chip)"
_DMA_GATE = "more than 2048 tiles of under 256 KB (4595 tiles of 224 KB)"
ENVELOPE_ONLY = {
    **{(name, kv): _STREAM_CAP
       for name in ("llama-3-8b", "llama3-8b", "llama-3-3b", "qwen2.5-7b",
                    "qwen/qwen2.5-7b")
       for kv in KV},
    ("qwen2.5-0.5b", "fp"): _DMA_GATE,
    ("qwen2.5-0.5b", "int8"): _DMA_GATE,
}


def _fake_params(cfg, jax_side: bool):
    """Full-precision bf16 params in name only (the eligibility reads the
    weight kinds and dtypes, not the values), as the JAX tests fake them."""
    names = tllama.WEIGHT_NAMES
    if jax_side:
        p = {"embed": jnp.zeros((1,), jnp.bfloat16),
             "blocks": {n: jnp.zeros((1,), jnp.bfloat16) for n in names}}
        if not cfg.tie_embeddings:
            p["lm_head"] = jnp.zeros((1,), jnp.bfloat16)
        return p
    t = torch.zeros(1, dtype=torch.bfloat16)
    p = {"embed": t, "blocks": {n: t for n in names}}
    if not cfg.tie_embeddings:
        p["lm_head"] = t
    return p


def _decisions(capacity):
    table = {}
    for name in REGISTRY:
        jcfg, tcfg = jllama.LlamaConfig.by_name(name), tllama.LlamaConfig.by_name(name)
        jp, tp = _fake_params(jcfg, True), _fake_params(tcfg, False)
        for kv in KV:
            if kv == "fp":
                want = jml.mega_supported(jcfg, capacity, jp)
                got = tml.mega_supported(tcfg, capacity, tp)
            else:
                want = jmq.llama_mega_quant_supported(jcfg, capacity, jp, kv)
                got = tmq.llama_mega_quant_supported(tcfg, capacity, tp, kv)
            table[(name, kv)] = (want, got)
    return table


@pytest.mark.parametrize("capacity", [320, 1024])
def test_eligibility_table_matches_jax(capacity):
    table = _decisions(capacity)
    differ = {key for key, (want, got) in table.items() if want != got}
    assert differ == set(ENVELOPE_ONLY), sorted(differ ^ set(ENVELOPE_ONLY))
    for key in differ:  # the port is only ever the more permissive
        assert table[key] == (False, True), (key, table[key])
    # the slice's model takes both kernels on both sides
    for kv in KV:
        assert table[("llama-3-1b", kv)] == (True, True)
    # Qwen2.5-0.5B: KW = 128, so int4 panes (KW / 2 = 64 lanes) are refused
    assert table[("qwen2.5-0.5b", "int4")] == (False, False)
    assert table[("qwen2.5-1.5b", "int4")] == (True, True)
    # the tiny models fail the 128-lane widths on both sides
    assert table[("llama-tiny", "fp")] == (False, False)


def test_registry_geometries_meet_the_kernel_limits():
    """Every registry geometry the JAX package's structural conditions
    admit is within the CUDA kernels' limits (head_dim 64 or 128, whole
    heads per int4 half), so the port refuses no geometry silently."""
    for name in REGISTRY:
        cfg = tllama.LlamaConfig.by_name(name)
        KW = _kv_width(cfg)
        if tml._tile_geometry(cfg)[1] % 128 or KW % 128:
            continue
        assert cfg.head_dim in tmk.HEAD_DIMS, name
        assert (KW // 2) % cfg.head_dim == 0, name
        assert tml._geometry_ok(cfg, 1024), name
    cfg = tllama.LlamaConfig.by_name("llama-3-1b")
    assert not tml._geometry_ok(cfg, tmk.MAX_CAPACITY + 8)


# -------------------------------------------------------------------- engine


@pytest.fixture(scope="module")
def engines(setup):
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    jeng = JaxEngine(jllama.llama_spec(jcfg), to_jax(setup["np"]),
                     config=JaxConfig(model_name="t", device="cpu",
                                      dtype=jnp.float32, megakernel=False))
    teng = InferenceEngine(tllama.llama_spec(tcfg), setup["tparams"], config=Config(
        model_name="t", device="cpu", dtype=torch.float32, megakernel=True))
    return jeng, teng


PROMPTS = ["the quick brown fox jumps over", "Megakernels stream weights."]


@pytest.mark.parametrize("prompt", PROMPTS)
def test_engine_megakernel_tokens_match_jax(engines, prompt):
    jeng, teng = engines
    want = jeng.generate_ids(prompt, "full_cache", 12)
    assert teng.generate_ids(prompt, "full_cache", 12) == want
    assert len(set(want[-12:])) > 1  # not a degenerate repeat
    assert teng._mega_packed is not None  # the megakernel path was built
    mega_keys = [k for k in teng._fns if k[0] == "full_cache" and k[-1]]
    assert mega_keys and all(teng._fns[k][1].capacity % 8 == 0 for k in mega_keys)


# ---------------------------------------------------------------------- bf16

# Leading greedy tokens (of N_BF16) on which the port's plain steps and the
# JAX kernels agree in bf16 on the CPU, from the same panes and first token.
# Both round at the same points; their fp32 sums run in other orders, so a
# bf16 rounding can flip and the two decodes part. Measured: all 24 agree in
# each case below; the stated tolerance is that count.
N_BF16 = 24
BF16_AGREE = 24


def _bf16_tokens_llama(length0: int):
    jcfg, tcfg = _cfgs()
    np_params = np_llama_params(tcfg, seed=5, std=0.15)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), np_params)
    jpacked = jml.pack_llama_mega(jp, jcfg)
    tpacked = tml.pack_llama_mega(
        tllama.params_from_jax(np_params, tcfg, torch.bfloat16, "cpu"), tcfg)
    cap = 64
    k, v, _ = _state(3, _kv_width(tcfg), tcfg.hidden_size, cap)
    kj, vj = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    kt, vt = torch.tensor(k).bfloat16(), torch.tensor(v).bfloat16()
    step_j = jax.jit(lambda kk, vv, n, x, c, s: jml.llama_megastep(
        jpacked, kk, vv, n, x, c, s, cfg=jcfg, capacity=cap, interpret=True))
    tj = tt = 17
    out_j, out_t = [], []
    for i in range(N_BF16):
        n = length0 + i
        cos_q, sin_q = jax_rope_rows(jcfg, n)
        tj, kj, vj = step_j(kj, vj, jnp.int32(n), jp["embed"][tj][None], cos_q, sin_q)
        tj = int(tj)
        tt = int(tml.llama_megastep(tpacked, kt, vt, n, tpacked["embed"][tt][None],
                                    cfg=tcfg)[0])
        out_j.append(tj)
        out_t.append(tt)
    return out_j, out_t


def _bf16_tokens_gpt2(length0: int):
    kw = dict(vocab_size=300, n_positions=256, n_embd=128, n_layer=2, n_head=2)
    jcfg, tcfg = jgpt2.GPT2Config(**kw), tgpt2.GPT2Config(**kw)
    np_params = np_gpt2_params(tcfg, seed=5, std=0.1)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), np_params)
    jpacked = jmk.pack_gpt2_mega(jp, jcfg)
    tp = tgpt2.params_from_jax(np_params, tcfg, torch.bfloat16, "cpu")
    tpacked = tmk.pack_gpt2_mega(tp, tcfg)
    cap = 64
    rng = np.random.default_rng(3)
    k = (rng.standard_normal((2, cap, 128)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((2, cap, 128)) * 0.5).astype(np.float32)
    kj, vj = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    kt, vt = torch.tensor(k).bfloat16(), torch.tensor(v).bfloat16()
    step_j = jax.jit(lambda kk, vv, n, x: jmk.gpt2_megastep(
        jpacked, kk, vv, n, x, cfg=jcfg, capacity=cap, interpret=True))
    tj = tt = 17
    out_j, out_t = [], []
    for i in range(N_BF16):
        n = length0 + i
        xj = (jp["wte"][tj] + jp["wpe"][n])[None].astype(jnp.bfloat16)
        tj, kj, vj = step_j(kj, vj, jnp.int32(n), xj)
        tj = int(tj)
        xt = (tp["wte"][tt] + tp["wpe"][n])[None]
        tt = int(tmk.gpt2_megastep(tpacked, kt, vt, n, xt, cfg=tcfg)[0])
        out_j.append(tj)
        out_t.append(tt)
    return out_j, out_t


@pytest.mark.parametrize("model", ["llama", "gpt2"])
def test_bf16_tokens_against_jax(model):
    want, got = (_bf16_tokens_llama if model == "llama" else _bf16_tokens_gpt2)(20)
    agree = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), N_BF16)
    assert len(set(want)) > 1
    assert agree >= BF16_AGREE, (agree, want, got)
