"""The port's batched speculative verify (#18 `gpt2_megabatch_verify`, #19
`gpt2_megabatch_verify_quant`, #20 `llama_megabatch_verify`, #21
`llama_megabatch_verify_quant`; ops/megakernel_batch_verify.py) against the
JAX package's, on the CPU in fp32.

* The plain versions against JAX's kernels (Pallas interpret mode, under
  jit) on the same numpy-made weights, [L, B, C, W] panes (B = 3 slots at
  lengths 0, 7 and 23, C = 48) and [B x R, E] rows, R in {1, 2, 4, 8}: the
  tokens [B, R] are equal; every pane column and scale outside a slot's
  R new columns is bit-identical to JAX's and unchanged; the new fp rows
  agree within 1e-5 of the rows' largest value (at least 1), the new
  quantized rows' codes within one step and their scales within rtol 1e-5
  (the batched steps' tolerance: the K/V projection is an fp32 sum in
  another order, and Llama's RoPE tables may differ from XLA's by an ulp).
  Quantized panes cover int8, int4 and mixed; the JAX kernels read the
  in-block rows j < t through their codes and the diagonal at full
  precision, which the plain versions reproduce as R sequential quantized
  steps.
* The plain versions against the port's own R sequential batched steps
  (the same function by construction), token ids against embeddings, and
  the limits (R <= 8, the 16-row window at floor8(length)).
* The eligibility of every registry GPT-2 and Llama/Qwen name x {fp, int8,
  int4, mixed} x B in {1, 8, 16} x R in {2, 8} at capacity 128 against the
  JAX gates; the differences are the TPU memory envelopes the port leaves
  out, each named. Past 128 rows: GPT-2 small and Llama-3.2-1B at B in
  {24, 32} x R = 8 against the JAX gates, and a 17 x 8-row plain pass
  against the JAX kernel.
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
from efficient_llm_inference_tpu.ops.pallas import megakernel_batch_verify as jbv
from efficient_llm_inference_tpu.ops.pallas import megakernel_llama as jml
from efficient_llm_inference_tpu_torch.models import gpt2 as tgpt2
from efficient_llm_inference_tpu_torch.models import llama as tllama
from efficient_llm_inference_tpu_torch.ops import megakernel as tmk
from efficient_llm_inference_tpu_torch.ops import megakernel_batch as tmb
from efficient_llm_inference_tpu_torch.ops import megakernel_batch_quant as tmbq
from efficient_llm_inference_tpu_torch.ops import megakernel_batch_verify as tbv
from efficient_llm_inference_tpu_torch.ops import megakernel_llama as tml
from efficient_llm_inference_tpu_torch.ops import megakernel_quant as tmq
from torch_port_helpers import (
    DMA_GATE,
    STREAM_CAP,
    VMEM,
    fake_params,
    jax_envelope,
    np_gpt2_params,
    np_llama_params,
    served_configs,
    to_jax,
)

C = 48
LENGTHS = [0, 7, 23]
B = len(LENGTHS)
GPT2_KW = {
    "fp": dict(vocab_size=300, n_positions=256, n_embd=128, n_layer=2, n_head=2),
    "quant": dict(vocab_size=300, n_positions=256, n_embd=256, n_layer=2, n_head=2),
}
LLAMA_KW = {  # quant: KW = 256, so int4 panes are eligible; with the Qwen bias
    "fp": dict(vocab_size=300, hidden_size=256, intermediate_size=512, n_layer=2,
               n_head=4, n_kv_head=2, n_positions=512, rope_theta=10000.0,
               tie_embeddings=True),
    "quant": dict(vocab_size=300, hidden_size=512, intermediate_size=1024, n_layer=2,
                  n_head=8, n_kv_head=4, n_positions=512, rope_theta=10000.0,
                  tie_embeddings=True, qkv_bias=True),
}


@functools.lru_cache(maxsize=None)
def _model(family: str, kind: str):
    """(jax cfg, port cfg, jax packed, port packed, pane width, E)."""
    if family == "gpt2":
        kw = GPT2_KW[kind]
        jcfg, tcfg = jgpt2.GPT2Config(**kw), tgpt2.GPT2Config(**kw)
        np_p = np_gpt2_params(tcfg, seed=31, std=0.1)
        tp = tgpt2.params_from_jax(np_p, tcfg, torch.float32, "cpu")
        return (jcfg, tcfg, jmk.pack_gpt2_mega(to_jax(np_p), jcfg),
                tmk.pack_gpt2_mega(tp, tcfg), tcfg.n_embd, tcfg.n_embd)
    kw = LLAMA_KW[kind]
    jcfg, tcfg = jllama.LlamaConfig(**kw), tllama.LlamaConfig(**kw)
    np_p = np_llama_params(tcfg, seed=33, std=0.15)
    tp = tllama.params_from_jax(np_p, tcfg, torch.float32, "cpu")
    return (jcfg, tcfg, jml.pack_llama_mega(to_jax(np_p), jcfg),
            tml.pack_llama_mega(tp, tcfg), tcfg.n_kv_head * tcfg.head_dim,
            tcfg.hidden_size)


def _state(mode: str, seed: int, L: int, W: int, E: int, R: int):
    """Panes [L, B, C, W] (codes and [L, B, C] scales for quantized modes)
    and verify rows [B x R, E]."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B * R, E)) * 0.5).astype(np.float32)
    if mode == "fp":
        return [(rng.standard_normal((L, B, C, W)) * 0.5).astype(np.float32)
                for _ in range(2)], x

    def pane(kind):
        lo = -127 if kind == "int8" else -128
        return rng.integers(lo, 128, (L, B, C, tmq._pane_width(kind, W))).astype(np.int8)

    def scales():
        return (rng.random((L, B, C)) * 0.02 + 1e-3).astype(np.float32)

    k_kind, v_kind = tmq._kv_kinds(mode)
    return [pane(k_kind), pane(v_kind), scales(), scales()], x


def _jax_rope(jcfg, R: int):
    """cos_q/sin_q [B x R, Hq*D] of positions min(lengths[b] + t, P - 1), as
    the JAX server builds them (under jit)."""
    @jax.jit
    def rows(lens):
        pos = jnp.minimum(lens[:, None] + jnp.arange(R, dtype=jnp.int32)[None],
                          jcfg.n_positions - 1)
        cos, sin = rope_cos_sin(pos, jcfg.head_dim, jcfg.rope_theta)  # [B, R, D]
        shape = (B * R, jcfg.n_head * jcfg.head_dim)
        return (jnp.tile(cos, (1, 1, jcfg.n_head)).reshape(shape),
                jnp.tile(sin, (1, 1, jcfg.n_head)).reshape(shape))

    return rows(jnp.asarray(LENGTHS, jnp.int32))


def _run_pair(family: str, mode: str, R: int, seed: int):
    """(port tokens, JAX tokens, port panes, JAX panes, the panes before)."""
    kind = "fp" if mode == "fp" else "quant"
    jcfg, tcfg, jpk, tpk, W, E = _model(family, kind)
    state, x = _state(mode, seed, tcfg.n_layer, W, E, R)
    jin = [jnp.asarray(a) for a in state]
    jl, jx = jnp.asarray(LENGTHS, jnp.int32), jnp.asarray(x)
    kw = dict(cfg=jcfg, capacity=C, rows=R, interpret=True)
    if mode != "fp":
        kw["kv_mode"] = mode
    if family == "gpt2":
        jfn = jbv.gpt2_megabatch_verify if mode == "fp" else jbv.gpt2_megabatch_verify_quant
        j = jfn(jpk, *jin, jl, jx, **kw)
        tfn = tbv.gpt2_megabatch_verify if mode == "fp" else tbv.gpt2_megabatch_verify_quant
    else:
        jfn = jbv.llama_megabatch_verify if mode == "fp" else jbv.llama_megabatch_verify_quant
        j = jfn(jpk, *jin, jl, jx, *_jax_rope(jcfg, R), **kw)
        tfn = tbv.llama_megabatch_verify if mode == "fp" else tbv.llama_megabatch_verify_quant
    t_in = [torch.tensor(a) for a in state]
    t = tfn(tpk, *t_in, torch.tensor(LENGTHS, dtype=torch.int32), torch.tensor(x), cfg=tcfg,
            **({} if mode == "fp" else {"kv_mode": mode}))
    assert all(a is b for a, b in zip(t[1:], t_in))  # written in place
    return t[0], j[0], [a.numpy() for a in t[1:]], [np.asarray(a) for a in j[1:]], state


def _check(mode, R, tok_t, tok_j, got, want, before):
    """Tokens equal; columns outside each slot's R new ones bit-identical and
    unchanged; new fp rows within 1e-5 of their largest value, new codes
    within one step, new scales within rtol 1e-5."""
    assert tok_t.shape == (B, R) and tok_t.dtype == torch.int32
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    kinds = ("fp", "fp") if mode == "fp" else tmq._kv_kinds(mode)
    for i, (g, w, b0) in enumerate(zip(got, want, before)):
        for b, cur in enumerate(LENGTHS):
            new = np.zeros(C, bool)
            new[cur:cur + R] = True
            np.testing.assert_array_equal(g[:, b, ~new], w[:, b, ~new])
            np.testing.assert_array_equal(g[:, b, ~new], b0[:, b, ~new])
            gn, wn = g[:, b, new], w[:, b, new]
            if mode == "fp":
                atol = 1e-5 * max(1.0, np.abs(wn).max())
                np.testing.assert_allclose(gn, wn, atol=atol, rtol=0)
            elif i < 2:
                gv = tmq.pane_values(torch.tensor(gn), kinds[i]).numpy()
                wv = tmq.pane_values(torch.tensor(wn), kinds[i]).numpy()
                assert np.abs(gv - wv).max() <= 1 and (gv != wv).mean() < 0.02
            else:
                np.testing.assert_allclose(gn, wn, rtol=1e-5, atol=0)


@pytest.mark.parametrize("R", [1, 4, 8])
def test_gpt2_megabatch_verify_matches_jax(R):
    _check("fp", R, *_run_pair("gpt2", "fp", R, seed=R))


@pytest.mark.parametrize("mode,R", [("int8", 8), ("int4", 4), ("mixed", 2)])
def test_gpt2_megabatch_verify_quant_matches_jax(mode, R):
    _check(mode, R, *_run_pair("gpt2", mode, R, seed=10 + R))


@pytest.mark.parametrize("R", [2, 8])
def test_llama_megabatch_verify_matches_jax(R):
    _check("fp", R, *_run_pair("llama", "fp", R, seed=20 + R))


@pytest.mark.parametrize("mode,R", [("int8", 4), ("int4", 8), ("mixed", 1)])
def test_llama_megabatch_verify_quant_matches_jax(mode, R):
    _check(mode, R, *_run_pair("llama", mode, R, seed=30 + R))


# ------------------------------------------------- the port's own semantics


@pytest.mark.parametrize("family,mode", [("gpt2", "fp"), ("gpt2", "int4"),
                                         ("llama", "fp"), ("llama", "mixed")])
def test_verify_equals_sequential_batched_steps(family, mode):
    """One R-row pass is R sequential batched steps of every slot, fed the
    verify rows: the same tokens, panes and scales, bit for bit."""
    R = 4
    kind = "fp" if mode == "fp" else "quant"
    _, tcfg, _, tpk, W, E = _model(family, kind)
    state, x = _state(mode, 7, tcfg.n_layer, W, E, R)
    got = [torch.tensor(a) for a in state]
    want = [torch.tensor(a) for a in state]
    qkw = {} if mode == "fp" else {"kv_mode": mode}
    llama = family == "llama"
    verify = {("fp", False): tbv.gpt2_megabatch_verify,
              ("fp", True): tbv.llama_megabatch_verify}.get(
        (mode, llama), tbv.llama_megabatch_verify_quant if llama
        else tbv.gpt2_megabatch_verify_quant)
    step = {("fp", False): tmb.gpt2_megabatch, ("fp", True): tmb.llama_megabatch}.get(
        (mode, llama), tmbq.llama_megabatch_quant if llama else tmbq.gpt2_megabatch_quant)
    toks = verify(tpk, *got, LENGTHS, torch.tensor(x), cfg=tcfg, **qkw)[0]
    xs = torch.tensor(x).reshape(B, R, E)
    seq = [step(tpk, *want, [n + t for n in LENGTHS], xs[:, t], cfg=tcfg, **qkw)[0]
           for t in range(R)]
    assert torch.equal(toks, torch.stack(seq, dim=1))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_token_ids_embed_as_the_server():
    """Token ids are embedded per slot as the server's glue would: GPT-2
    adds wpe[min(lengths[b] + t, P - 1)], Llama takes the embedding row."""
    R = 2
    ids = torch.tensor([3, 250, 17, 99, 5, 0], dtype=torch.int32)
    lens = [0, 254, 9]  # slot 1's second row past GPT-2's P - 1 = 255
    for family, fn in (("gpt2", tbv.gpt2_megabatch_verify),
                       ("llama", tbv.llama_megabatch_verify)):
        _, tcfg, _, tpk, W, _ = _model(family, "fp")
        if family == "gpt2":
            pos = torch.clamp(torch.tensor(lens)[:, None] + torch.arange(R), max=255)
            emb = tpk["wte"][ids.long()] + tpk["wpe"][pos.reshape(-1)]
        else:
            emb = tpk["embed"][ids.long()]
        rng = np.random.default_rng(5)
        k = torch.tensor(rng.standard_normal((tcfg.n_layer, B, 272, W)).astype(np.float32))
        a = fn(tpk, k.clone(), k.clone(), lens, ids, cfg=tcfg)
        b = fn(tpk, k.clone(), k.clone(), lens, emb, cfg=tcfg)
        assert all(torch.equal(p, q) for p, q in zip(a, b))


def test_verify_limits():
    """R <= 8 rows a slot, and each slot's block inside the 16-row window at
    floor8(length) (the JAX kernels' rule; the server clamps at C - 8)."""
    _, tcfg, _, tpk, W, E = _model("gpt2", "fp")
    k = torch.zeros(tcfg.n_layer, B, C, W)
    with pytest.raises(NotImplementedError):
        tbv.gpt2_megabatch_verify(tpk, k, k.clone(), LENGTHS, torch.zeros(B * 9, E), cfg=tcfg)
    with pytest.raises(ValueError):
        tbv.gpt2_megabatch_verify(tpk, k, k.clone(), LENGTHS, torch.zeros(7, E), cfg=tcfg)
    with pytest.raises(ValueError):  # floor8(33) + 16 = 48 + 8 > C
        tbv.gpt2_megabatch_verify(tpk, k, k.clone(), [0, 7, 40], torch.zeros(B, E), cfg=tcfg)
    tbv.gpt2_megabatch_verify(tpk, k, k.clone(), [0, 7, C - 9], torch.zeros(B * 8, E),
                              cfg=tcfg)


# -------------------------------------------------------------- eligibility

_GPT2_SIZE = {"gpt2": "small", "gpt2-medium": "medium", "gpt2-large": "large",
              "gpt2-tiny": "tiny"}
LLAMA_NAMES = ("llama-3-8b", "llama3-8b", "llama-3-1b", "llama-3-3b", "llama-tiny",
               "qwen2.5-7b", "qwen/qwen2.5-7b", "qwen2.5-1.5b", "qwen2.5-0.5b",
               "qwen-tiny")
KV = (None, "int8", "int4", "mixed")
BATCHES, ROWS = (1, 8, 16), (2, 8)
# Where the JAX package refuses only because of a TPU memory envelope, the
# port accepts: the cells, with the JAX condition that refuses them
# (ops/pallas/megakernel_batch_verify.py).
_VMEM = "VMEM budget of the verify rings (44 MB)"
_STREAM_CAP = "packed tile stream over the 4 GiB cap (the batched step's gate)"
_DMA_GATE = "more than 2048 tiles of under 256 KB (the batched step's gate)"
ENVELOPE_ONLY = {
    **{("gpt2-medium", None, 16, r): _VMEM for r in ROWS},
    **{("gpt2-large", kv, bs, r): _VMEM for kv in (None, "int8") for bs in (8, 16)
       for r in ROWS if kv is None or bs == 16},
    ("gpt2-large", "mixed", 16, 8): _VMEM,
    **{(name, kv, bs, r): _STREAM_CAP
       for name in ("llama-3-8b", "llama3-8b", "llama-3-3b", "qwen2.5-7b",
                    "qwen/qwen2.5-7b")
       for kv in KV for bs in BATCHES for r in ROWS},
    **{("qwen2.5-0.5b", kv, bs, r): _DMA_GATE for kv in (None, "int8") for bs in BATCHES
       for r in ROWS},
}


_fake = fake_params  # bf16 params in name only (the gates read kinds, dtypes, groups)


# Over quantized weights, the (model, weight_quant) pairs a JAX envelope
# refuses in some cell, and the envelope (named by JAX's own tile math,
# torch_port_helpers.jax_envelope): the port accepts every such cell.
WEIGHT_ENVELOPE = {
    **{(name, wq): VMEM for name in ("gpt2-medium", "gpt2-large", "llama-3-3b")
       for wq in ("int8", "int4", "int4w8")},
    **{(name, wq): VMEM for name in ("llama-3-8b", "llama3-8b") for wq in ("int4", "int4w8")},
    **{(name, "int8"): STREAM_CAP for name in ("llama-3-8b", "llama3-8b", "qwen2.5-7b",
                                               "qwen/qwen2.5-7b")},
    ("qwen2.5-0.5b", "int8"): DMA_GATE, ("qwen2.5-0.5b", "int4w8"): DMA_GATE,
    ("qwen2.5-1.5b", "int4"): DMA_GATE, ("qwen2.5-1.5b", "int4w8"): DMA_GATE,
}


def _decisions(capacity: int = 128, names=tuple(_GPT2_SIZE) + LLAMA_NAMES, kvs=KV,
               batches=BATCHES, rows=ROWS, wq=None) -> dict:
    """(name, kv, B, R) -> (JAX, port), over full-precision weights or those
    of weight_quant `wq` (the engine's plan on both sides)."""
    table = {}
    for name in names:
        if name in _GPT2_SIZE:
            size = _GPT2_SIZE[name]
            jcfg, tcfg = getattr(jgpt2.GPT2Config, size)(), getattr(tgpt2.GPT2Config, size)()
            names, embed, tied = tmk.WEIGHT_NAMES, "wte", True
            jfp, jq = jbv.mega_batch_verify_supported, jbv.mega_batch_verify_quant_supported
            tfp, tq = tbv.mega_batch_verify_supported, tbv.mega_batch_verify_quant_supported
        else:
            jcfg, tcfg = jllama.LlamaConfig.by_name(name), tllama.LlamaConfig.by_name(name)
            names, embed, tied = tllama.WEIGHT_NAMES, "embed", tcfg.tie_embeddings
            jfp = jbv.llama_mega_batch_verify_supported
            jq = jbv.llama_mega_batch_verify_quant_supported
            tfp = tbv.llama_mega_batch_verify_supported
            tq = tbv.llama_mega_batch_verify_quant_supported
        mode, group = "fp", 0
        if wq is not None:
            jcfg, tcfg, mode, group = served_configs(name, wq)
        jp = _fake(names, True, embed, tied, mode, group)
        tp = _fake(names, False, embed, tied, mode, group)
        for kv in kvs:
            for bs in batches:
                for r in rows:
                    if kv is None:
                        pair = (jfp(jcfg, capacity, jp, bs, r), tfp(tcfg, capacity, tp, bs, r))
                    else:
                        pair = (jq(jcfg, capacity, jp, bs, r, kv),
                                tq(tcfg, capacity, tp, bs, r, kv))
                    table[(name, kv, bs, r)] = pair
    return table


def test_batch_verify_eligibility_table_matches_jax():
    table = _decisions()
    differ = {key for key, (want, got) in table.items() if want != got}
    assert differ == set(ENVELOPE_ONLY), sorted(differ ^ set(ENVELOPE_ONLY), key=str)
    for key in differ:  # the port is only ever the more permissive
        assert table[key] == (False, True), (key, table[key])
    # the slice's two models take every pane kind, B and R on both sides
    for name in ("gpt2", "llama-3-1b"):
        for kv in KV:
            for bs in BATCHES:
                for r in ROWS:
                    assert table[(name, kv, bs, r)] == (True, True), (name, kv, bs, r)
    assert table[("gpt2-tiny", None, 1, 2)] == (False, False)  # E % 128
    assert table[("qwen2.5-0.5b", "int4", 8, 2)] == (False, False)  # KW / 2 = 64 lanes
    # the weight tiers: every difference is a JAX envelope of WEIGHT_ENVELOPE
    # (the port only the more permissive), named by JAX's own tile math
    envelopes = set()
    for wq in ("int8", "int4", "int4w8"):
        table = _decisions(wq=wq)
        for key, (want, got) in table.items():
            if want != got:
                assert (want, got) == (False, True), (key, wq)
                jcfg, _, mode, group = served_configs(key[0], wq)
                assert jax_envelope(jcfg, mode, group) == WEIGHT_ENVELOPE[(key[0], wq)]
                envelopes.add((key[0], wq))
        for key in (k for k in table if k[0] in ("gpt2", "llama-3-1b")):
            assert table[key] == (True, True), (key, wq)
    assert envelopes == set(WEIGHT_ENVELOPE)


def test_batch_verify_gates_port_limits():
    """Beyond the JAX structure, the port refuses B x R > 256 (the batched
    GEMV's rows: 32 slots of 8 verify rows), R > 8 and capacity < 16, as
    the JAX gates refuse the last two."""
    tcfg = tgpt2.GPT2Config(**GPT2_KW["fp"])
    tp = _fake(tmk.WEIGHT_NAMES, False, "wte")
    assert tbv.mega_batch_verify_supported(tcfg, 128, tp, 32, 8)
    assert not tbv.mega_batch_verify_supported(tcfg, 128, tp, 33, 8)
    assert not tbv.mega_batch_verify_supported(tcfg, 128, tp, 1, 9)
    assert not tbv.mega_batch_verify_supported(tcfg, 8, tp, 1, 2)
    assert tbv.MAX_ROWS == 256 and tmb.MAX_BATCH == 32


@pytest.mark.parametrize("name", ["gpt2", "llama-3-1b"])
@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("bs", [24, 32])
def test_batch_verify_gates_match_jax_past_128_rows(name, kv, bs):
    """The servers of 24 and 32 slots at spec_k = 8 (192 and 256 rows, C =
    128) for GPT-2 small and Llama-3.2-1B: the port accepts every point the
    JAX gates accept, and also the 32 x 8-row pass over a model-dtype pool,
    which the JAX gates refuse only for their VMEM budget (_VMEM)."""
    want = (False, True) if (kv, bs) == (None, 32) else (True, True)
    assert _decisions(128, names=(name,), kvs=(kv,), batches=(bs,), rows=(8,))[
        (name, kv, bs, 8)] == want


def test_batch_verify_plain_at_136_rows_matches_jax():
    """17 slots x 8 rows = 136 rows (past the old 128-row limit) through the
    plain GPT-2 verify against the JAX kernel in interpret mode: the tokens
    equal, new rows within 1e-5 of their largest value, the other columns
    bit-identical."""
    R, lengths = 8, [LENGTHS[i % len(LENGTHS)] for i in range(17)]
    jcfg, tcfg, jpk, tpk, W, E = _model("gpt2", "fp")
    rng = np.random.default_rng(136)
    x = (rng.standard_normal((len(lengths) * R, E)) * 0.5).astype(np.float32)
    k, v = [(rng.standard_normal((tcfg.n_layer, len(lengths), C, W)) * 0.5).astype(np.float32)
            for _ in range(2)]
    j = jbv.gpt2_megabatch_verify(jpk, jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(lengths, jnp.int32), jnp.asarray(x), cfg=jcfg,
                                  capacity=C, rows=R, interpret=True)
    t = tbv.gpt2_megabatch_verify(tpk, torch.tensor(k), torch.tensor(v),
                                  torch.tensor(lengths, dtype=torch.int32), torch.tensor(x),
                                  cfg=tcfg)
    assert t[0].shape == (17, R)
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    for got, want, before in zip(t[1:], j[1:], (k, v)):
        got, want = got.numpy(), np.asarray(want)
        for b, cur in enumerate(lengths):
            new = np.zeros(C, bool)
            new[cur:cur + R] = True
            np.testing.assert_array_equal(got[:, b, ~new], before[:, b, ~new])
            np.testing.assert_array_equal(want[:, b, ~new], before[:, b, ~new])
            atol = 1e-5 * max(1.0, np.abs(want[:, b, new]).max())
            np.testing.assert_allclose(got[:, b, new], want[:, b, new], atol=atol, rtol=0)
