"""The port's GPT-2 (models/gpt2.py) and KV strategies (cache/kvcache.py)
against the JAX package's on the same numpy-made params, fp32 on the CPU:
logits within atol 1e-5 (the two frameworks sum in different orders)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efficient_llm_inference_tpu.cache import kvcache as jkv
from efficient_llm_inference_tpu.models import gpt2 as jgpt2
from efficient_llm_inference_tpu_torch.cache import kvcache as tkv
from efficient_llm_inference_tpu_torch.models import gpt2 as tgpt2
from torch_port_helpers import np_gpt2_params, to_jax

CFG_KW = dict(vocab_size=256, n_positions=64, n_embd=64, n_layer=2, n_head=4)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_params_from_jax_round_trip():
    cfg = tgpt2.GPT2Config(**CFG_KW)
    np_params = np_gpt2_params(cfg, seed=0)
    params = tgpt2.params_from_jax(np_params, cfg, torch.float32, "cpu")
    got = dict(_flat(params))
    want = dict(_flat(np_params))
    assert got.keys() == want.keys()
    for name, arr in want.items():
        assert got[name].dtype == torch.float32
        np.testing.assert_array_equal(got[name].numpy(), arr, err_msg=name)
    bf16 = tgpt2.params_from_jax(np_params, cfg, torch.bfloat16, "cpu")
    assert bf16["blocks"]["attn_w"].dtype == torch.bfloat16


def test_params_from_jax_rejects_wrong_shapes():
    cfg = tgpt2.GPT2Config(**CFG_KW)
    np_params = np_gpt2_params(cfg, seed=0)
    np_params["blocks"]["fc_w"] = np_params["blocks"]["fc_w"][:, :, :-1]
    with pytest.raises(ValueError, match="fc_w"):
        tgpt2.params_from_jax(np_params, cfg, torch.float32, "cpu")


def test_tiny_config_matches_jax():
    assert tgpt2.GPT2Config.tiny() == tgpt2.GPT2Config(
        **{f: getattr(jgpt2.GPT2Config.tiny(), f)
           for f in tgpt2.GPT2Config.__dataclass_fields__})


STRATEGIES = [("dense", None, None)] + [
    ("quant", mode, gran)
    for mode in ("int8", "int4", "mixed")
    for gran in ("per_token", "per_head")
]


@pytest.mark.parametrize("kind,mode,granularity", STRATEGIES)
def test_forward_logits_match_jax(kind, mode, granularity):
    """Prefill a padded prompt, then decode three forced tokens, through the
    same strategy in both packages; compare every step's logits."""
    cfg_t = tgpt2.GPT2Config(**CFG_KW)
    cfg_j = jgpt2.GPT2Config(**CFG_KW)
    np_params = np_gpt2_params(cfg_t, seed=1)
    tparams = tgpt2.params_from_jax(np_params, cfg_t, torch.float32, "cpu")
    jparams = to_jax(np_params)
    kw = dict(n_layer=cfg_t.n_layer, n_head=cfg_t.n_head,
              head_dim=cfg_t.head_dim, capacity=24)
    if kind == "dense":
        js, ts = jkv.DenseKV(**kw), tkv.DenseKV(**kw, device="cpu")
    else:
        qkw = dict(mode=mode, granularity=granularity)
        js = jkv.QuantizedKV(**kw, **qkw, fused=False)
        ts = tkv.QuantizedKV(**kw, **qkw, device="cpu")

    rng = np.random.default_rng(2)
    true_len, pad = 11, 16
    tokens = np.zeros((1, pad), np.int64)
    tokens[0, :true_len] = rng.integers(0, 256, true_len)
    pos = np.arange(pad)[None]
    mask = pos < true_len
    jcache, tcache = js.init(), ts.init()
    jl, jcache = jgpt2.gpt2_forward(jparams, cfg_j, jnp.asarray(tokens, jnp.int32),
                                    jnp.asarray(pos, jnp.int32), jcache, js,
                                    jnp.asarray(mask))
    tl, tcache = tgpt2.gpt2_forward(tparams, cfg_t, torch.tensor(tokens),
                                    torch.tensor(pos), tcache, ts,
                                    torch.tensor(mask))
    np.testing.assert_allclose(tl.numpy()[:, :true_len],
                               np.asarray(jl)[:, :true_len], atol=1e-5, rtol=0)
    jcache = js.set_length(jcache, true_len)
    tcache = ts.set_length(tcache, true_len)

    for step, tok in enumerate(rng.integers(0, 256, 3)):
        p = true_len + step
        jl, jcache = jgpt2.gpt2_forward(
            jparams, cfg_j, jnp.full((1, 1), tok, jnp.int32),
            jnp.full((1, 1), p, jnp.int32), jcache, js)
        tl, tcache = tgpt2.gpt2_forward(
            tparams, cfg_t, torch.full((1, 1), int(tok)),
            torch.full((1, 1), p), tcache, ts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                                   rtol=0, err_msg=f"decode step {step}")
        jcache = js.set_length(jcache, jcache["length"] + 1)
        tcache = ts.set_length(tcache, tcache["length"] + 1)
