"""The port's continuous-batching server (`MegaBatchServer`,
engine/megaserver.py) against the JAX package's, on the CPU in fp32.

* The port's server against the JAX `MegaBatchServer` (interpret=True) on
  the same numpy-made weights, GPT-2 (the Llama family's cases:
  tests/test_torch_megaserver_llama.py) and Llama, plain and spec="ngram",
  panes in the model dtype and int8, 3 slots of C = 48 (five requests: two
  admission waves), each pair with an eos_id taken from a request's own
  stream (GPT-2 spec also without): every request's `out_ids` are equal,
  and so are `spec_stats` and the verify width R after every burst (the
  ladder from spec_k = 8 for Llama's model-dtype pool, else from 4). Each
  run carries
  a request past the pane (prompt + 1 + max_new > C - 8 in spec mode,
  > C - 1 plain), whose tokens past the clamp are the JAX server's
  frozen-context tokens, and one whose budget the prefill token meets.
* The port's server against the port's own per-prompt `generate_ids` for
  the requests that fit the pane (plain greedy of the pool's KV kind).
* The JAX server's argument checks and messages, the exports, and
  `enable_prefix_cache=True` raising NotImplementedError.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efficient_llm_inference_tpu.engine.batching import Request as JaxRequest
from efficient_llm_inference_tpu.engine.megaserver import MegaBatchServer as JaxServer
from efficient_llm_inference_tpu.engine.megaserver import MegaPoolConfig as JaxPool
from efficient_llm_inference_tpu.models import gpt2 as jgpt2
from efficient_llm_inference_tpu.models import llama as jllama
from efficient_llm_inference_tpu.models.registry import gpt2_spec as jax_gpt2_spec
from efficient_llm_inference_tpu_torch import (
    Config,
    InferenceEngine,
    MegaBatchServer,
    MegaPoolConfig,
    Request,
)
from efficient_llm_inference_tpu_torch.data.tokenizer import ByteTokenizer
from efficient_llm_inference_tpu_torch.models import gpt2 as tgpt2
from efficient_llm_inference_tpu_torch.models import llama as tllama
from efficient_llm_inference_tpu_torch.models.registry import gpt2_spec
from torch_port_helpers import np_gpt2_params, np_llama_params, to_jax

C = 48
POOL = dict(n_slots=3, capacity=C, max_chunk=3, prompt_bucket=32)
GPT2_KW = dict(vocab_size=300, n_positions=256, n_embd=128, n_layer=2, n_head=2)
LLAMA_KW = dict(vocab_size=300, hidden_size=256, intermediate_size=512, n_layer=2,
                n_head=4, n_kv_head=2, n_positions=512, rope_theta=10000.0,
                tie_embeddings=True)
# repetitive prompts give n-gram hits, "x" none; the fourth request runs past
# the pane (20 + 1 + 30 > C - 1), the fifth is met by its prefill token
PROMPTS = ["the cat sat on the cat sat", "a b a b a b a b", "x",
           "twenty bytes of text", "to be or not to be"]
BUDGETS = [9, 12, 8, 30, 1]
FITS = [0, 1, 2, 4]


def _family(name: str):
    """(JAX spec, port spec, JAX params, port params), fp32 on the CPU."""
    if name == "gpt2":
        jcfg, tcfg = jgpt2.GPT2Config(**GPT2_KW), tgpt2.GPT2Config(**GPT2_KW)
        np_p = np_gpt2_params(tcfg, seed=41, std=0.1)
        return (jax_gpt2_spec(jcfg), gpt2_spec(tcfg), to_jax(np_p),
                tgpt2.params_from_jax(np_p, tcfg, torch.float32, "cpu"))
    jcfg, tcfg = jllama.LlamaConfig(**LLAMA_KW), tllama.LlamaConfig(**LLAMA_KW)
    np_p = np_llama_params(tcfg, seed=43, std=0.15)
    return (jllama.llama_spec(jcfg), tllama.llama_spec(tcfg), to_jax(np_p),
            tllama.params_from_jax(np_p, tcfg, torch.float32, "cpu"))


_FAMILIES = {}


def family(name: str):
    if name not in _FAMILIES:
        _FAMILIES[name] = _family(name)
    return _FAMILIES[name]


def jax_kw(kw):
    """The port server's keywords for the JAX server (its dtype a jnp one)."""
    return dict(kw, dtype={torch.float32: jnp.float32,
                           torch.bfloat16: jnp.bfloat16}[kw.get("dtype", torch.bfloat16)])


def _serve(server, request_type):
    """Run the five requests; returns (requests, R after each burst)."""
    tok = ByteTokenizer()
    reqs = [request_type(rid=i, prompt_ids=tok.encode(p), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(PROMPTS, BUDGETS))]
    widths = []
    server.run(reqs, progress=lambda steps, srv: widths.append(srv._spec_R))
    assert all(r.done for r in reqs)
    return reqs, widths


# the Llama cases run in tests/test_torch_megaserver_llama.py (a file each
# family, so that one xdist worker does not carry both)
CASES = [("gpt2", None, None), ("gpt2", "ngram", None), ("gpt2", None, "int8"),
         ("gpt2", "ngram", "int8")]
LLAMA_CASES = [("llama", None, None), ("llama", "ngram", None), ("llama", None, "int8"),
               ("llama", "ngram", "int8")]


@pytest.mark.parametrize("name,spec,kv_mode", CASES)
def test_server_matches_jax_server(name, spec, kv_mode):
    check_server_matches_jax_server(name, spec, kv_mode)


def check_server_matches_jax_server(name, spec, kv_mode):
    jspec, tspec, jp, tp = family(name)
    kw = dict(spec=spec, spec_k=8 if name == "llama" and kv_mode is None else 4,
              kv_mode=kv_mode)
    # the eos: a token inside request 0's own stream, so it truncates there
    kw["dtype"] = torch.float32  # beside JAX's dtype=jnp.float32 (the pools' dtype)
    free, _ = _serve(MegaBatchServer(tspec, tp, pool=MegaPoolConfig(**POOL), **kw), Request)
    eos = free[0].out_ids[len(free[0].out_ids) // 2]
    for eos_id in (None, eos) if (name, spec, kv_mode) == ("gpt2", "ngram", None) else (eos,):
        want, want_r = _serve(JaxServer(jspec, jp, pool=JaxPool(**POOL), eos_id=eos_id,
                                        interpret=True, **jax_kw(kw)), JaxRequest)
        srv = MegaBatchServer(tspec, tp, pool=MegaPoolConfig(**POOL), eos_id=eos_id, **kw)
        got, got_r = _serve(srv, Request)
        assert [r.out_ids for r in got] == [r.out_ids for r in want], (eos_id,)
        assert got_r == want_r
        if eos_id is not None:  # the eos truncates the free run's streams
            for g, f in zip(got, free):
                cut = f.out_ids.index(eos_id) + 1 if eos_id in f.out_ids else None
                assert g.out_ids == f.out_ids[:cut]
    if spec is not None:
        assert srv.spec_stats["tokens"] >= srv.spec_stats["rounds"] > 0
    assert len(free[3].out_ids) == 30 and len(free[4].out_ids) == 1


@pytest.mark.parametrize("name,spec,kv_mode", [("gpt2", "ngram", None),
                                               ("gpt2", None, "int8"),
                                               ("llama", "ngram", "int8"),
                                               ("llama", None, None)])
def test_server_matches_per_prompt_generate(name, spec, kv_mode):
    """Requests that fit the pane get the port's own greedy tokens of the
    pool's KV kind (generate_ids, megakernel on: the plain steps)."""
    _, tspec, _, tp = family(name)
    eng = InferenceEngine(tspec, tp, config=Config(model_name="t", device="cpu",
                                                   dtype=torch.float32, megakernel=True))
    reqs, _ = _serve(MegaBatchServer(tspec, tp, pool=MegaPoolConfig(**POOL), spec=spec,
                                     kv_mode=kv_mode, dtype=torch.float32), Request)
    method = f"quant_{kv_mode}" if kv_mode else "full_cache"
    for i in FITS:
        want = eng.generate_ids(PROMPTS[i], method, BUDGETS[i])
        assert reqs[i].prompt_ids + reqs[i].out_ids == want, i
    assert any(len(set(reqs[i].out_ids)) > 1 for i in FITS)  # not one repeated token


def test_server_arguments_match_jax():
    """The JAX server's defaults, checks and messages; the port's own: pools
    in bf16 or fp32 only (the kernels' dtypes), and no shared-prefix cache
    yet. The pools' dtype is JAX's default, bf16, over fp32 weights too."""
    assert dataclasses.asdict(MegaPoolConfig()) == dataclasses.asdict(JaxPool())
    jspec, tspec, jp, tp = family("gpt2")
    tiny_j = jax_gpt2_spec(jgpt2.GPT2Config.tiny())
    tiny_t = gpt2_spec(tgpt2.GPT2Config.tiny())
    tiny_np = np_gpt2_params(tgpt2.GPT2Config.tiny(), seed=1)
    tiny_tp = tgpt2.params_from_jax(tiny_np, tgpt2.GPT2Config.tiny(), torch.float32, "cpu")
    cases = [
        ((jspec, jp, JaxPool(**POOL)), (tspec, tp, MegaPoolConfig(**POOL)),
         dict(spec="tree")),
        ((jspec, jp, JaxPool(**POOL)), (tspec, tp, MegaPoolConfig(**POOL)),
         dict(spec="ngram", spec_k=9)),
        ((jspec, jp, JaxPool(**dict(POOL, capacity=8))),
         (tspec, tp, MegaPoolConfig(**dict(POOL, capacity=8))), dict(spec="ngram")),
        ((tiny_j, to_jax(tiny_np), JaxPool(**POOL)), (tiny_t, tiny_tp, MegaPoolConfig(**POOL)),
         {}),
    ]
    for (js, jpar, jpool), (ts, tpar, tpool), kw in cases:
        with pytest.raises(ValueError) as want:
            JaxServer(js, jpar, pool=jpool, dtype=jnp.float32, **kw)
        with pytest.raises(ValueError) as got:
            MegaBatchServer(ts, tpar, pool=tpool, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(AssertionError, match="8-aligned"):
        MegaBatchServer(tspec, tp, pool=MegaPoolConfig(**dict(POOL, capacity=44)))
    import inspect
    default = inspect.signature(MegaBatchServer).parameters["dtype"].default
    assert default == torch.bfloat16
    assert inspect.signature(JaxServer).parameters["dtype"].default == jnp.bfloat16
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        MegaBatchServer(tspec, tp, pool=MegaPoolConfig(**POOL), dtype=torch.float16)
    for dtype in (torch.float32, torch.bfloat16):
        srv = MegaBatchServer(tspec, tp, pool=MegaPoolConfig(**POOL), dtype=dtype)
        assert srv.k_pool.dtype == srv.v_pool.dtype == dtype
        assert srv.packed["attn_w"].dtype == dtype and srv.packed["smalls"].dtype == torch.float32
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        MegaBatchServer(tspec, tp, pool=MegaPoolConfig(**POOL), enable_prefix_cache=True)
    srv = MegaBatchServer(tspec, tp, pool=MegaPoolConfig(**POOL), kv_mode="int8",
                          interpret=True)
    assert srv.k_pool.shape == srv.v_pool.shape == (2, 3, C, 128)
    assert srv.k_pool.dtype == torch.int8 and torch.equal(srv.ks_pool, torch.ones(2, 3, C))
    with pytest.raises(ValueError, match="batched megakernel unsupported"):  # (E/2) % 128
        MegaBatchServer(tspec, tp, pool=MegaPoolConfig(**POOL), kv_mode="mixed")


def test_ladder_policy():
    """The verify width follows the acceptance EMA: low acceptance walks
    8 -> 4 -> 2 and floors, saturation climbs a rung, mid-band holds."""
    _, tspec, _, tp = family("gpt2")
    srv = MegaBatchServer(tspec, tp, pool=MegaPoolConfig(**POOL), spec="ngram", spec_k=8)
    steps = []
    for acc, r in ((1.0, 8), (1.0, 4), (1.0, 2), (1.9, 2), (3.2, 4), (2.0, 4)):
        srv._acc_est = acc
        steps.append(srv._ladder_next(r))
    assert steps == [4, 2, 2, 4, 8, 4]
    np.testing.assert_array_equal(srv.slen, np.ones(3, np.int32))


def test_spec_server_of_32_slots_matches_jax():
    """32 slots at spec_k = 8 (B x R = 256 verify rows, the JAX server's
    largest wave) over an int8 pool at C = 128: the port builds the server
    the JAX package builds, and serves the same tokens."""
    jspec, tspec, jp, tp = family("gpt2")
    pool = dict(POOL, n_slots=32, capacity=128)
    kw = dict(spec="ngram", spec_k=8, kv_mode="int8")
    want, want_r = _serve(JaxServer(jspec, jp, pool=JaxPool(**pool), dtype=jnp.float32,
                                    interpret=True, **kw), JaxRequest)
    srv = MegaBatchServer(tspec, tp, pool=MegaPoolConfig(**pool), dtype=torch.float32, **kw)
    got, got_r = _serve(srv, Request)
    assert [r.out_ids for r in got] == [r.out_ids for r in want]
    assert got_r == want_r and srv.spec_stats["rounds"] > 0
