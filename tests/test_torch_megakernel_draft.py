"""The port's draft bursts (ops/megakernel_draft.py, #22 `gpt2_draft_burst`
and #23 `llama_draft_burst`) against the JAX package's, on the CPU in fp32.

* The plain bursts (k plain steps with token feedback) against the JAX
  one-program bursts (Pallas interpret mode under jit) at
  tests/test_megakernel_draft.py's geometries (GPT-2: E=128, L=2, 4 heads of
  D=32, V=256; Llama: E=256, I=512, L=1, 4 query heads on 2, tied), C=64,
  k=5, from the same panes, length and current token: the proposals are
  equal, the k appended pane rows agree within 1e-5 of their largest value
  (at least 1) and every other row is bit-identical.
* The burst gates against the JAX package's over draft and target
  geometries, capacities and dtypes: equal, because the port copies the
  JAX byte budget; the kernel's own limits (head_dim 32, 64 or 128; 48 KB
  of scores) refuse nothing that the budget admits here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efficient_llm_inference_tpu.models import gpt2 as jgpt2
from efficient_llm_inference_tpu.models import llama as jllama
from efficient_llm_inference_tpu.ops.pallas import megakernel_draft as jmd
from efficient_llm_inference_tpu_torch.models import gpt2 as tgpt2
from efficient_llm_inference_tpu_torch.models import llama as tllama
from efficient_llm_inference_tpu_torch.ops import megakernel_draft as tmd
from torch_port_helpers import np_gpt2_params, np_llama_params, to_jax

C, K = 64, 5
GCFG_KW = dict(vocab_size=256, n_positions=256, n_embd=128, n_layer=2, n_head=4)
LCFG_KW = dict(vocab_size=256, n_positions=256, hidden_size=256, intermediate_size=512,
               n_layer=1, n_head=4, n_kv_head=2, rope_theta=10000.0, tie_embeddings=True)


def _panes(seed, L, W):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((L, C, W)) * 0.5).astype(np.float32) for _ in range(2)]


def _check(dlen, got, want, before):
    (p_t, k_t, v_t), (p_j, k_j, v_j) = got, want
    assert p_t.dtype == torch.int32
    assert p_t.tolist() == np.asarray(p_j).tolist()
    assert len(set(p_t.tolist())) > 1  # the feedback is exercised
    rows = np.arange(dlen, dlen + K)
    others = np.ones(C, bool)
    others[rows] = False
    for g_, w_, b_ in ((k_t.numpy(), np.asarray(k_j), before[0]),
                       (v_t.numpy(), np.asarray(v_j), before[1])):
        atol = 1e-5 * max(1.0, np.abs(w_[:, rows]).max())
        np.testing.assert_allclose(g_[:, rows], w_[:, rows], atol=atol, rtol=0)
        np.testing.assert_array_equal(g_[:, others], w_[:, others])
        np.testing.assert_array_equal(g_[:, others], b_[:, others])


@pytest.mark.parametrize("dlen,cur", [(9, 17), (40, 200)])
def test_gpt2_draft_burst_matches_jax(dlen, cur):
    jcfg, tcfg = jgpt2.GPT2Config(**GCFG_KW), tgpt2.GPT2Config(**GCFG_KW)
    assert tcfg.head_dim == 32  # outside the step kernels' head templates
    np_p = np_gpt2_params(tcfg, seed=31, std=0.15)
    tpk = tmd.pack_gpt2_draft(tgpt2.params_from_jax(np_p, tcfg, torch.float32, "cpu"), tcfg)
    k, v = _panes(dlen, tcfg.n_layer, tcfg.n_embd)
    want = jmd.gpt2_draft_burst(jmd.pack_gpt2_draft(to_jax(np_p), jcfg), jnp.asarray(k),
                                jnp.asarray(v), jnp.int32(dlen), jnp.int32(cur), cfg=jcfg,
                                capacity=C, k=K, interpret=True)
    got = tmd.gpt2_draft_burst(tpk, torch.tensor(k), torch.tensor(v), dlen, cur, cfg=tcfg,
                               k=K)
    _check(dlen, got, want, (k, v))


@pytest.mark.parametrize("dlen,cur", [(11, 5), (40, 131)])
def test_llama_draft_burst_matches_jax(dlen, cur):
    jcfg, tcfg = jllama.LlamaConfig(**LCFG_KW), tllama.LlamaConfig(**LCFG_KW)
    np_p = np_llama_params(tcfg, seed=33, std=0.15)
    tpk = tmd.pack_llama_draft(tllama.params_from_jax(np_p, tcfg, torch.float32, "cpu"),
                               tcfg)
    k, v = _panes(dlen + 1, tcfg.n_layer, tcfg.n_kv_head * tcfg.head_dim)
    want = jmd.llama_draft_burst(jmd.pack_llama_draft(to_jax(np_p), jcfg), jnp.asarray(k),
                                 jnp.asarray(v), jnp.int32(dlen), jnp.int32(cur), cfg=jcfg,
                                 capacity=C, k=K, interpret=True)
    got = tmd.llama_draft_burst(tpk, torch.tensor(k), torch.tensor(v), dlen, cur, cfg=tcfg,
                                k=K)
    _check(dlen, got, want, (k, v))


GATE_GPT2 = [GCFG_KW, dict(GCFG_KW, n_layer=1, n_head=2),
             dict(vocab_size=256, n_positions=256, n_embd=768, n_layer=12, n_head=12),
             dict(vocab_size=50257, n_positions=1024, n_embd=768, n_layer=12, n_head=12),
             dict(GCFG_KW, n_embd=256, n_layer=4, n_head=8),
             dict(GCFG_KW, vocab_size=4096), dict(GCFG_KW, n_embd=192, n_head=3)]
GATE_LLAMA = [LCFG_KW, dict(LCFG_KW, tie_embeddings=False),
              dict(LCFG_KW, hidden_size=1024, intermediate_size=2048, n_layer=8,
                   n_head=16, n_kv_head=4),
              dict(LCFG_KW, n_kv_head=1), dict(LCFG_KW, vocab_size=4096),
              dict(LCFG_KW, n_layer=4, qkv_bias=True), dict(LCFG_KW, hidden_size=512,
                                                             n_head=8, n_kv_head=4)]


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_burst_gates_match_jax(family):
    """The port's gates against JAX's: every geometry x capacity x dtype."""
    configs = GATE_GPT2 if family == "gpt2" else GATE_LLAMA
    jmod, tmod = (jgpt2.GPT2Config, tgpt2.GPT2Config) if family == "gpt2" else (
        jllama.LlamaConfig, tllama.LlamaConfig)
    jgate, tgate = ((jmd.gpt2_draft_burst_supported, tmd.gpt2_draft_burst_supported)
                    if family == "gpt2" else
                    (jmd.llama_draft_burst_supported, tmd.llama_draft_burst_supported))
    seen = set()
    for kw in configs:
        for cap in (64, 208, 336, 1024, 2048, 4104):
            for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
                want = jgate(jmod(**kw), cap, jdt)
                assert tgate(tmod(**kw), cap, tdt) == want, (kw, cap, tdt)
                seen.add(want)
    assert seen == {True, False}
