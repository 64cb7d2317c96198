"""The port's batched decode over quantized KV panes
(ops/megakernel_batch_quant.py) and `generate_batch(kv_mode=...)` against
the JAX package's, on the CPU in fp32, for int8, int4 and mixed panes.

* `quantize_panes_batch` against JAX's under jit: codes (half-split int4
  bytes included) and per-(slot, token) scales bit-exact, in fp32 and bf16,
  all-zero rows (the eps scale) included.
* The plain batched steps against JAX's `gpt2_megabatch_quant` and
  `llama_megabatch_quant` (Pallas interpret mode, under jit), B = 3 slots at
  lengths 0, 7 and C - 1: per-slot tokens equal; every pane column and scale
  but a slot's lengths[b] bit-identical and unchanged; the new rows' codes
  within one step and scales within rtol 1e-5, the fp rows' bound of
  test_torch_megakernel_batch.py (a scale is max|x| times a constant; the
  K/V projection is an fp32 sum taken in another order, and Llama's K is
  roped with tables that may differ from XLA's by an ulp: measured up to
  1.2e-6 at position 7).
* Quantize-on-write bit for bit: with the K/V projection reduced to its bias
  the new rows are exact on both sides (GPT-2: K and V; Llama: V, since the
  port's RoPE tables may differ from XLA's by an fp32 ulp and K is roped).
* `generate_batch` for both families and the three kinds: token-exact
  against the JAX engine's and the port's per-prompt `generate`, and the
  prompt_cap rule (the quant methods do not truncate).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficient_llm_inference_tpu.models import gpt2 as jgpt2
from efficient_llm_inference_tpu.models import llama as jllama
from efficient_llm_inference_tpu.models.registry import gpt2_spec as jax_gpt2_spec
from efficient_llm_inference_tpu.ops.pallas import megakernel as jmk
from efficient_llm_inference_tpu.ops.pallas import megakernel_batch_quant as jmbq
from efficient_llm_inference_tpu.ops.pallas import megakernel_llama as jml
from efficient_llm_inference_tpu_torch import Config, InferenceEngine
from efficient_llm_inference_tpu_torch.models import gpt2 as tgpt2
from efficient_llm_inference_tpu_torch.models import llama as tllama
from efficient_llm_inference_tpu_torch.models.registry import gpt2_spec
from efficient_llm_inference_tpu_torch.ops import megakernel as tmk
from efficient_llm_inference_tpu_torch.ops import megakernel_batch_quant as tmbq
from efficient_llm_inference_tpu_torch.ops import megakernel_llama as tml
from efficient_llm_inference_tpu_torch.ops import megakernel_quant as tmq
from torch_port_helpers import (
    check_generate_batch,
    engine_pair,
    jax_rope_rows,
    np_gpt2_params,
    np_llama_params,
    to_jax,
)

MODES = ["int8", "int4", "mixed"]
GPT2_KW = dict(vocab_size=300, n_positions=256, n_embd=256, n_layer=2, n_head=2)
LLAMA_KW = dict(vocab_size=300, hidden_size=512, intermediate_size=1024, n_layer=2,
                n_head=8, n_kv_head=4, n_positions=512, rope_theta=10000.0,
                tie_embeddings=True, qkv_bias=True)  # KW = 256: int4 panes eligible
C = 48
LENGTHS = [0, 7, C - 1]
B = len(LENGTHS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_quantize_panes_batch_matches_jax(mode, dtype):
    rng = np.random.default_rng(3)
    shape = (2, 3, 16, 256)
    x = rng.standard_normal(shape) * rng.random((2, 3, 16, 1)) * 4
    x[0, 1, 5] = 0.0  # the eps scale
    kx, vx = jnp.asarray(x, dtype), jnp.asarray(x[::-1].copy(), dtype)
    want = jax.jit(jmbq.quantize_panes_batch, static_argnums=(2, 3))(kx, vx, mode, 1e-8)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    got = tmbq.quantize_panes_batch(torch.tensor(np.asarray(kx, np.float32)).to(tdt),
                                    torch.tensor(np.asarray(vx, np.float32)).to(tdt), mode)
    for g, w in zip(got, want):
        assert g.dtype == (torch.int8 if w.dtype == jnp.int8 else torch.float32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _state(mode: str, seed: int, L: int, W: int, E: int):
    rng = np.random.default_rng(seed)
    k_kind, v_kind = tmq._kv_kinds(mode)

    def pane(kind):
        lo = -127 if kind == "int8" else -128
        return rng.integers(lo, 128, (L, B, C, tmq._pane_width(kind, W))).astype(np.int8)

    def scales():
        return (rng.random((L, B, C)) * 0.02 + 1e-3).astype(np.float32)

    x = (rng.standard_normal((B, E)) * 0.5).astype(np.float32)
    return [pane(k_kind), pane(v_kind), scales(), scales()], x


def _check(mode, tok_t, tok_j, got, want, before, exact=()):
    """Tokens equal, other columns untouched and equal, the new rows within
    one code step and rtol 1e-5 (bit-exact for the panes in `exact`)."""
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    kinds = tmq._kv_kinds(mode)
    for i, (g, w, b0) in enumerate(zip(got, want, before)):
        for b, length in enumerate(LENGTHS):
            others = np.arange(C) != length
            np.testing.assert_array_equal(g[:, b, others], w[:, b, others])
            np.testing.assert_array_equal(g[:, b, others], b0[:, b, others])
            gn, wn = g[:, b, length], w[:, b, length]
            if i % 2 in exact:
                np.testing.assert_array_equal(gn, wn)
            elif i < 2:
                gv = tmq.pane_values(torch.tensor(gn), kinds[i]).numpy()
                wv = tmq.pane_values(torch.tensor(wn), kinds[i]).numpy()
                assert np.abs(gv - wv).max() <= 1 and (gv != wv).mean() < 0.02
            else:
                np.testing.assert_allclose(gn, wn, rtol=1e-5, atol=0)


def _gpt2_step(mode, np_p, seed):
    jcfg, tcfg = jgpt2.GPT2Config(**GPT2_KW), tgpt2.GPT2Config(**GPT2_KW)
    tp = tgpt2.params_from_jax(np_p, tcfg, torch.float32, "cpu")
    state, x = _state(mode, seed, tcfg.n_layer, tcfg.n_embd, tcfg.n_embd)
    j = jmbq.gpt2_megabatch_quant(
        jmk.pack_gpt2_mega(to_jax(np_p), jcfg), *(jnp.asarray(a) for a in state),
        jnp.asarray(LENGTHS, jnp.int32), jnp.asarray(x), cfg=jcfg, capacity=C,
        kv_mode=mode, interpret=True)
    t_in = [torch.tensor(a) for a in state]
    t = tmbq.gpt2_megabatch_quant(tmk.pack_gpt2_mega(tp, tcfg), *t_in, LENGTHS,
                                  torch.tensor(x), cfg=tcfg, kv_mode=mode)
    assert all(a is b for a, b in zip(t[1:], t_in))  # written in place
    return t[0], j[0], [a.numpy() for a in t[1:]], [np.asarray(a) for a in j[1:]], state


@pytest.fixture(scope="module")
def gpt2_np():
    return np_gpt2_params(tgpt2.GPT2Config(**GPT2_KW), seed=21, std=0.1)


@pytest.mark.parametrize("mode", MODES)
def test_gpt2_megabatch_quant_matches_jax(gpt2_np, mode):
    tok_t, tok_j, got, want, before = _gpt2_step(mode, gpt2_np, seed=4)
    _check(mode, tok_t, tok_j, got, want, before)


@pytest.mark.parametrize("mode", MODES)
def test_gpt2_quantize_on_write_bit_exact(gpt2_np, mode):
    """K/V projection weights zeroed: the new rows are the K/V biases
    exactly, so codes and scales agree bit for bit, and are the reference
    quantization of the biases."""
    E, L = GPT2_KW["n_embd"], GPT2_KW["n_layer"]
    p = {k: (dict(v) if isinstance(v, dict) else v) for k, v in gpt2_np.items()}
    w = p["blocks"]["attn_w"].copy()
    w[:, :, E:] = 0.0
    p["blocks"]["attn_w"] = w
    bias = p["blocks"]["attn_b"].copy()
    bias[:, E:] = np.random.default_rng(4).standard_normal((L, 2 * E)) * 0.7
    p["blocks"]["attn_b"] = bias.astype(np.float32)
    tok_t, tok_j, got, want, before = _gpt2_step(mode, p, seed=9)
    _check(mode, tok_t, tok_j, got, want, before, exact=(0, 1))
    for kind, pane, scales, rows in zip(tmq._kv_kinds(mode), got[:2], got[2:],
                                        (bias[:, E:2 * E], bias[:, 2 * E:])):
        for layer in range(L):
            codes, s = tmq.quantize_row(torch.tensor(rows[layer]), kind, 1e-8)
            for b, length in enumerate(LENGTHS):
                np.testing.assert_array_equal(pane[layer, b, length], codes.numpy())
                assert scales[layer, b, length] == s.item()


def _llama_step(mode, np_p, seed):
    jcfg, tcfg = jllama.LlamaConfig(**LLAMA_KW), tllama.LlamaConfig(**LLAMA_KW)
    tp = tllama.params_from_jax(np_p, tcfg, torch.float32, "cpu")
    KW = tcfg.n_kv_head * tcfg.head_dim
    state, x = _state(mode, seed, tcfg.n_layer, KW, tcfg.hidden_size)
    rows = [jax_rope_rows(jcfg, n) for n in LENGTHS]
    j = jmbq.llama_megabatch_quant(
        jml.pack_llama_mega(to_jax(np_p), jcfg), *(jnp.asarray(a) for a in state),
        jnp.asarray(LENGTHS, jnp.int32), jnp.asarray(x),
        jnp.concatenate([r[0] for r in rows]), jnp.concatenate([r[1] for r in rows]),
        cfg=jcfg, capacity=C, kv_mode=mode, interpret=True)
    t_in = [torch.tensor(a) for a in state]
    t = tmbq.llama_megabatch_quant(tml.pack_llama_mega(tp, tcfg), *t_in,
                                   torch.tensor(LENGTHS, dtype=torch.int32),
                                   torch.tensor(x), cfg=tcfg, kv_mode=mode)
    return t[0], j[0], [a.numpy() for a in t[1:]], [np.asarray(a) for a in j[1:]], state


@pytest.fixture(scope="module")
def llama_np():
    return np_llama_params(tllama.LlamaConfig(**LLAMA_KW), seed=11, std=0.15)


@pytest.mark.parametrize("mode", MODES)
def test_llama_megabatch_quant_matches_jax(llama_np, mode):
    tok_t, tok_j, got, want, before = _llama_step(mode, llama_np, seed=5)
    _check(mode, tok_t, tok_j, got, want, before)


def test_llama_quantize_on_write_bit_exact(llama_np):
    """V projection weights zeroed: the new V rows are the V biases exactly,
    so their codes and scales agree bit for bit (mixed: int4 V panes)."""
    p = {k: (dict(v) if isinstance(v, dict) else v) for k, v in llama_np.items()}
    p["blocks"]["wv"] = np.zeros_like(p["blocks"]["wv"])
    tok_t, tok_j, got, want, before = _llama_step("mixed", p, seed=6)
    _check("mixed", tok_t, tok_j, got, want, before, exact=(1,))
    bv = p["blocks"]["bv"]
    for layer in range(LLAMA_KW["n_layer"]):
        codes, s = tmq.quantize_row(torch.tensor(bv[layer]), "int4", 1e-8)
        for b, length in enumerate(LENGTHS):
            np.testing.assert_array_equal(got[1][layer, b, length], codes.numpy())
            assert got[3][layer, b, length] == s.item()


# ------------------------------------------------------------------ engines


@pytest.fixture(scope="module")
def gpt2_engines(gpt2_np):
    jcfg, tcfg = jgpt2.GPT2Config(**GPT2_KW), tgpt2.GPT2Config(**GPT2_KW)
    return engine_pair(jax_gpt2_spec(jcfg), gpt2_spec(tcfg), gpt2_np,
                       tgpt2.params_from_jax(gpt2_np, tcfg, torch.float32, "cpu"))


@pytest.fixture(scope="module")
def llama_engines(llama_np):
    jcfg, tcfg = jllama.LlamaConfig(**LLAMA_KW), tllama.LlamaConfig(**LLAMA_KW)
    return engine_pair(jllama.llama_spec(jcfg), tllama.llama_spec(tcfg), llama_np,
                       tllama.params_from_jax(llama_np, tcfg, torch.float32, "cpu"))


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("mode", MODES)
def test_generate_batch_quant_matches_jax(request, family, mode):
    check_generate_batch(request.getfixturevalue(f"{family}_engines"), mode)


def test_generate_batch_encode_cap_matches_quant_method(gpt2_np):
    """Prompts longer than prompt_cap: the batch with a kv_mode encodes as
    the quant_* method it emulates (no truncation), as the JAX engine."""
    tcfg = tgpt2.GPT2Config(**GPT2_KW)
    eng = InferenceEngine(gpt2_spec(tcfg), tgpt2.params_from_jax(gpt2_np, tcfg,
                                                                 torch.float32, "cpu"),
                          config=Config(model_name="t", device="cpu", dtype=torch.float32,
                                        megakernel=True, prompt_cap=16))
    long_prompt = "counting words over and over " * 4
    ids = eng.tokenizer.encode(long_prompt)
    assert len(ids) > 16
    got = eng.generate_batch([long_prompt], max_new_tokens=5, kv_mode="int8")
    assert any(k[0] == "batch" for k in eng._fns)
    assert got == [eng.generate(long_prompt, "quant_int8", max_new_tokens=5)]
    assert eng.last_batch_ids[0][:-5] == list(ids)[:tcfg.n_positions]
    # full_cache truncates at prompt_cap, in the batch as per prompt
    eng.generate_batch([long_prompt], max_new_tokens=5)
    assert eng.last_batch_ids[0][:-5] == list(ids)[:16]
