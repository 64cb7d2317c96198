"""The port's speculative verify passes (#10 `gpt2_megaverify`, #13 at R > 1
`llama_megaverify`) against the JAX package's, on the CPU in fp32.

The port's plain verify (R plain steps at lengths cur .. cur + R - 1, the
in-block causal set) against the JAX kernels (Pallas interpret mode under
jit, as the JAX engine runs them), at R in {1, 4, 8}, cur in {0, 7, 47} and
a block that crosses an 8-row boundary (cur = 5, R = 4), C = 64 (>=
roundup8(cur + R) + 8, the JAX rule): the R tokens are equal, the R new K/V
rows agree within 1e-5 of the rows' largest value (at least 1; fp32 sums in
another order) and every other row is bit-identical. Llama at query groups
G = 2 and 4 and with the Qwen q/k/v bias; the JAX kernel gets the RoPE rows
min(cur + t, P - 1) as the JAX engine builds them, the port reads them from
its packed tables (which differ from XLA's by up to one fp32 ulp, ROADMAP
Queue 3).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficient_llm_inference_tpu.models import gpt2 as jgpt2
from efficient_llm_inference_tpu.models import llama as jllama
from efficient_llm_inference_tpu.models.llama import rope_cos_sin
from efficient_llm_inference_tpu.ops.pallas import megakernel as jmk
from efficient_llm_inference_tpu.ops.pallas import megakernel_llama as jml
from efficient_llm_inference_tpu_torch.models import gpt2 as tgpt2
from efficient_llm_inference_tpu_torch.models import llama as tllama
from efficient_llm_inference_tpu_torch.ops import megakernel as tmk
from efficient_llm_inference_tpu_torch.ops import megakernel_llama as tml
from torch_port_helpers import np_gpt2_params, np_llama_params, to_jax

C = 64
# every R in {1, 4, 8} and cur in {0, 7, 47}; (4, 5) crosses an 8-row boundary
CASES = [(1, 0), (1, 47), (4, 7), (4, 5), (8, 0), (8, 47)]
LLAMA_CASES = [("g2", 1, 0), ("g2", 4, 5), ("g4", 8, 47), ("g4", 4, 7),
               ("qwen_bias", 8, 7)]
GPT2_KW = dict(vocab_size=300, n_positions=256, n_embd=128, n_layer=2, n_head=2)
LLAMA_KW = dict(vocab_size=300, hidden_size=256, intermediate_size=512, n_layer=2,
                n_head=4, n_kv_head=2, n_positions=512, rope_theta=10000.0,
                tie_embeddings=True)
LLAMA_VARIANTS = {
    "g2": {},
    "g4": dict(hidden_size=512, n_head=8, n_kv_head=2),
    "qwen_bias": dict(qkv_bias=True, rms_eps=1e-6),
}


@pytest.fixture(scope="module")
def gpt2():
    jcfg, tcfg = jgpt2.GPT2Config(**GPT2_KW), tgpt2.GPT2Config(**GPT2_KW)
    np_p = np_gpt2_params(tcfg, seed=21)
    tparams = tgpt2.params_from_jax(np_p, tcfg, torch.float32, "cpu")
    return jcfg, tcfg, jmk.pack_gpt2_mega(to_jax(np_p), jcfg), tmk.pack_gpt2_mega(tparams, tcfg)


@functools.lru_cache(maxsize=None)
def _llama(variant: str):
    kw = dict(LLAMA_KW, **LLAMA_VARIANTS[variant])
    jcfg, tcfg = jllama.LlamaConfig(**kw), tllama.LlamaConfig(**kw)
    np_p = np_llama_params(tcfg, seed=23, std=0.15)
    tparams = tllama.params_from_jax(np_p, tcfg, torch.float32, "cpu")
    return (jcfg, tcfg, jml.pack_llama_mega(to_jax(np_p), jcfg),
            tml.pack_llama_mega(tparams, tcfg))


def _state(seed: int, L: int, W: int, E: int, R: int):
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal((L, C, W)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((L, C, W)) * 0.5).astype(np.float32)
    x = (rng.standard_normal((R, E)) * 0.5).astype(np.float32)
    return k, v, x


def _check(cur, R, state, got, want):
    """Tokens equal, new rows within 1e-5 of their largest value, every
    other row bit-identical (to JAX's and to the state before)."""
    (tok_t, k_t, v_t), (tok_j, k_j, v_j) = got, want
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    rows = np.arange(cur, cur + R)
    others = np.ones(C, bool)
    others[rows] = False
    for g_, w_, before in ((k_t.numpy(), np.asarray(k_j), state[0]),
                           (v_t.numpy(), np.asarray(v_j), state[1])):
        atol = 1e-5 * max(1.0, np.abs(w_[:, rows]).max())
        np.testing.assert_allclose(g_[:, rows], w_[:, rows], atol=atol, rtol=0)
        np.testing.assert_array_equal(g_[:, others], w_[:, others])
        np.testing.assert_array_equal(g_[:, others], before[:, others])


@pytest.mark.parametrize("R,cur", CASES)
def test_gpt2_megaverify_matches_jax(gpt2, R, cur):
    jcfg, tcfg, jpk, tpk = gpt2
    state = _state(R * 100 + cur, tcfg.n_layer, tcfg.n_embd, tcfg.n_embd, R)
    k, v, x = state
    want = jmk.gpt2_megaverify(jpk, jnp.asarray(k), jnp.asarray(v), jnp.int32(cur),
                               jnp.asarray(x), cfg=jcfg, capacity=C, interpret=True)
    kt, vt = torch.tensor(k), torch.tensor(v)
    got = tmk.gpt2_megaverify(tpk, kt, vt, cur, torch.tensor(x), cfg=tcfg)
    assert got[1] is kt and got[2] is vt  # written in place
    _check(cur, R, state, got, want)


def _jax_rope(jcfg, cur: int, R: int):
    """cos_q/sin_q [R, Hq*D] of positions min(cur + t, P - 1), as the JAX
    engine's verify builds them (under jit)."""
    @jax.jit
    def rows(c):
        pos = jnp.minimum(c + jnp.arange(R, dtype=jnp.int32), jcfg.n_positions - 1)
        cos, sin = rope_cos_sin(pos[None], jcfg.head_dim, jcfg.rope_theta)
        return jnp.tile(cos[0], (1, jcfg.n_head)), jnp.tile(sin[0], (1, jcfg.n_head))

    return rows(jnp.int32(cur))


@pytest.mark.parametrize("variant,R,cur", LLAMA_CASES)
def test_llama_megaverify_matches_jax(variant, R, cur):
    jcfg, tcfg, jpk, tpk = _llama(variant)
    W = tcfg.n_kv_head * tcfg.head_dim
    state = _state(R * 100 + cur + 1, tcfg.n_layer, W, tcfg.hidden_size, R)
    k, v, x = state
    cos_q, sin_q = _jax_rope(jcfg, cur, R)
    want = jml.llama_megaverify(jpk, jnp.asarray(k), jnp.asarray(v), jnp.int32(cur),
                                jnp.asarray(x), cos_q, sin_q, cfg=jcfg, capacity=C,
                                interpret=True)
    got = tml.llama_megaverify(tpk, torch.tensor(k), torch.tensor(v), cur,
                               torch.tensor(x), cfg=tcfg)
    _check(cur, R, state, got, want)


def test_verify_token_ids_embed_as_the_engine(gpt2):
    """Token ids are embedded on the device as the JAX engine's glue embeds
    them (GPT-2 adds wpe[min(cur + t, P - 1)]): the same tokens and rows as
    the embeddings given directly."""
    ids = torch.tensor([3, 250, 17, 99], dtype=torch.int32)
    cur = 254  # rows 2 and 3 past GPT-2's P - 1 = 255
    for (_, tcfg, _, tpk), fn, emb in (
            (gpt2, tmk.gpt2_megaverify,
             lambda pk: pk["wte"][ids.long()] + pk["wpe"][torch.clamp(
                 torch.arange(4) + cur, max=255)]),
            (_llama("g4"), tml.llama_megaverify, lambda pk: pk["embed"][ids.long()])):
        W = tcfg.n_kv_head * tcfg.head_dim if hasattr(tcfg, "n_kv_head") else tcfg.n_embd
        rng = np.random.default_rng(5)
        k = torch.tensor(rng.standard_normal((tcfg.n_layer, 272, W)).astype(np.float32))
        a = fn(tpk, k.clone(), k.clone(), cur, ids, cfg=tcfg)
        b = fn(tpk, k.clone(), k.clone(), cur, emb(tpk), cfg=tcfg)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


def test_verify_limits():
    """R <= 8, and capacity >= roundup8(cur + R) + 8 where the length is on
    the host (the JAX kernels' write window)."""
    tcfg = tgpt2.GPT2Config(**GPT2_KW)
    pk = tmk.pack_gpt2_mega(tgpt2.init_gpt2_params(torch.Generator().manual_seed(0), tcfg,
                                                   torch.float32, "cpu"), tcfg)
    k = torch.zeros(2, C, 128)
    with pytest.raises(NotImplementedError):
        tmk.gpt2_megaverify(pk, k, k.clone(), 0, torch.zeros(9, 128), cfg=tcfg)
    with pytest.raises(ValueError):
        tmk.gpt2_megaverify(pk, k, k.clone(), C - 15, torch.zeros(8, 128), cfg=tcfg)
    tmk.gpt2_megaverify(pk, k, k.clone(), C - 16, torch.zeros(8, 128), cfg=tcfg)
