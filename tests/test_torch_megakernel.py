"""The port's whole-step decode megakernel (ops/megakernel.py) against the
JAX package's, on the CPU in fp32.

The port's plain step is held against the JAX kernel (Pallas interpret mode
under jit, as the JAX engine runs it) at the JAX tests' geometry (E=128, L=2,
H=2, V=300, C=48) on the same numpy-made weights, cache and embedding: the
token is equal, the new K/V rows agree within 1e-5 (fp32 sums in another
order) and every other row is untouched. A port engine with megakernel=True
(plain steps on the CPU) gives the JAX engine's greedy tokens.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efficient_llm_inference_tpu.core.config import Config as JaxConfig
from efficient_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine
from efficient_llm_inference_tpu.models import gpt2 as jgpt2
from efficient_llm_inference_tpu.models.registry import gpt2_spec as jax_gpt2_spec
from efficient_llm_inference_tpu.ops.pallas import megakernel as jmk
from efficient_llm_inference_tpu_torch import Config, InferenceEngine
from efficient_llm_inference_tpu_torch.models import gpt2 as tgpt2
from efficient_llm_inference_tpu_torch.models.registry import gpt2_spec
from efficient_llm_inference_tpu_torch.ops import megakernel as tmk
from torch_port_helpers import np_gpt2_params, to_jax

CFG_KW = dict(vocab_size=300, n_positions=256, n_embd=128, n_layer=2, n_head=2)
C = 48


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jgpt2.GPT2Config(**CFG_KW), tgpt2.GPT2Config(**CFG_KW)
    np_params = np_gpt2_params(tcfg, seed=11, std=0.1)
    tparams = tgpt2.params_from_jax(np_params, tcfg, torch.float32, "cpu")
    return {
        "jcfg": jcfg, "tcfg": tcfg, "np": np_params, "tparams": tparams,
        "jpacked": jmk.pack_gpt2_mega(to_jax(np_params), jcfg),
        "tpacked": tmk.pack_gpt2_mega(tparams, tcfg),
    }


def _state(seed: int, E: int):
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal((CFG_KW["n_layer"], C, E)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((CFG_KW["n_layer"], C, E)) * 0.5).astype(np.float32)
    x = (rng.standard_normal((1, E)) * 0.5).astype(np.float32)
    return k, v, x


@pytest.mark.parametrize("length", [0, 7, 30, C - 1])
def test_megastep_matches_jax(setup, length):
    k, v, x = _state(length, CFG_KW["n_embd"])
    tok_j, k_j, v_j = jmk.gpt2_megastep(
        setup["jpacked"], jnp.asarray(k), jnp.asarray(v), jnp.int32(length),
        jnp.asarray(x), cfg=setup["jcfg"], capacity=C, interpret=True)
    kt, vt = torch.tensor(k), torch.tensor(v)
    tok_t, k_t, v_t = tmk.gpt2_megastep(setup["tpacked"], kt, vt, length,
                                        torch.tensor(x), cfg=setup["tcfg"])
    assert k_t is kt and v_t is vt  # written in place
    assert int(tok_t) == int(tok_j)
    k_j, v_j = np.asarray(k_j), np.asarray(v_j)
    for got, want, before in ((k_t.numpy(), k_j, k), (v_t.numpy(), v_j, v)):
        np.testing.assert_allclose(got[:, length], want[:, length], atol=1e-5, rtol=0)
        assert not np.array_equal(got[:, length], before[:, length])
        others = np.arange(C) != length
        np.testing.assert_array_equal(got[:, others], want[:, others])
        np.testing.assert_array_equal(got[:, others], before[:, others])


def test_plain_logits_choose_the_token(setup):
    k, v, x = _state(5, CFG_KW["n_embd"])
    tok, _, _, logits = tmk.gpt2_megastep_plain(
        setup["tpacked"], torch.tensor(k), torch.tensor(v), 9, torch.tensor(x),
        cfg=setup["tcfg"], return_logits=True)
    assert logits.shape == (CFG_KW["vocab_size"],) and logits.dtype == torch.float32
    assert int(tok) == int(torch.argmax(logits))


def test_to_mega_layout_matches_jax():
    rng = np.random.default_rng(2)
    buf = rng.standard_normal((2, 1, 3, 8, 4)).astype(np.float32)
    want = np.asarray(jmk.to_mega_layout(jnp.asarray(buf)))
    got = tmk.to_mega_layout(torch.tensor(buf)).numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="batch 1"):
        tmk.to_mega_layout(torch.zeros((2, 2, 3, 8, 4)))


@pytest.mark.parametrize("cfg_kw,capacity", [
    (CFG_KW, 48), (CFG_KW, 47), (CFG_KW, 8),
    (dict(CFG_KW, n_embd=256), 64),  # head_dim 128
    (dict(CFG_KW, n_embd=64, n_head=1), 48),  # E not a multiple of 128
    (dict(CFG_KW, n_embd=192, n_head=3), 48),
])
def test_mega_supported_matches_jax(cfg_kw, capacity):
    jcfg, tcfg = jgpt2.GPT2Config(**cfg_kw), tgpt2.GPT2Config(**cfg_kw)
    np_params = np_gpt2_params(tcfg, seed=0)
    want = jmk.mega_supported(jcfg, capacity, to_jax(np_params))
    got = tmk.mega_supported(tcfg, capacity,
                             tgpt2.params_from_jax(np_params, tcfg, device="cpu"))
    assert got == want


def test_mega_supported_kernel_limits():
    """The port's own limits: the kernels' head dims and shared memory."""
    cfg = tgpt2.GPT2Config(**dict(CFG_KW, n_head=4))  # head_dim 32
    params = tgpt2.init_gpt2_params(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")
    assert not tmk.mega_supported(cfg, 48, params)
    cfg = tgpt2.GPT2Config(**CFG_KW)
    params = tgpt2.init_gpt2_params(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")
    assert tmk.mega_supported(cfg, tmk.MAX_CAPACITY, params)
    assert not tmk.mega_supported(cfg, tmk.MAX_CAPACITY + 8, params)


def test_resolved_megakernel_follows_the_device():
    assert Config(device="cuda").resolved_megakernel()
    assert not Config(device="cpu").resolved_megakernel()
    assert Config(device="cpu", megakernel=True).resolved_megakernel()
    assert not Config(device="cuda", megakernel=False).resolved_megakernel()


@pytest.fixture(scope="module")
def engines(setup):
    cfg_j, cfg_t = setup["jcfg"], setup["tcfg"]
    jeng = JaxEngine(jax_gpt2_spec(cfg_j), to_jax(setup["np"]),
                     config=JaxConfig(model_name="t", device="cpu",
                                      dtype=jnp.float32, megakernel=False))
    teng = InferenceEngine(gpt2_spec(cfg_t), setup["tparams"], config=Config(
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


def test_generate_logits_keeps_the_megakernel_off_path(engines):
    """Teacher forcing needs logits: generate_logits takes the off path, and
    its greedy tokens equal the megakernel path's."""
    _, teng = engines
    ids = teng.generate_ids(PROMPTS[0], "full_cache", 10)
    toks, logits = teng.generate_logits(PROMPTS[0], "full_cache", 10)
    assert toks == ids[-10:] and logits.shape == (10, CFG_KW["vocab_size"])
    with pytest.raises(ValueError, match="forced"):
        teng._build("full_cache", 32, 10, {})[0](
            teng.params, torch.zeros((1, 32), dtype=torch.long), 5,
            forced=torch.zeros((1, 10), dtype=torch.long))
