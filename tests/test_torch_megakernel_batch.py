"""The port's batched whole-step decode (ops/megakernel_batch.py) and
static-batch serving (`InferenceEngine.generate_batch`) against the JAX
package's, on the CPU in fp32.

* The plain batched steps against JAX's `gpt2_megabatch` and
  `llama_megabatch` (Pallas interpret mode, under jit) on the same
  numpy-made weights, [L, B, C, W] panes, per-slot lengths (B = 3, lengths
  0, 7 and C - 1) and embeddings: per-slot tokens equal, every pane column
  but a slot's lengths[b] bit-identical and unchanged, the new rows within
  1e-5 (relative to the row's largest value for Llama).
* The batch layout helpers against JAX's, bit-exact.
* The batched eager prefill (DenseKV at B = 3, right-padded rows of unequal
  lengths) against JAX's: each row's last logits and its cached rows.
* `generate_batch` without kv_mode for both families: token-exact against
  the JAX engine's `generate_batch` and against the port's per-prompt
  `generate`; the per-prompt fallback for an ineligible model (gpt2-tiny,
  E = 64) and for a batch beyond the kernels' largest (MAX_BATCH = 32).
* The eligibility of `generate_batch` for every registry GPT-2 and
  Llama/Qwen name x {fp, int8, int4, mixed} x B in {1, 8} at capacity 320,
  against the JAX package's, over full-precision weights and each
  weight_quant (int8, int4, int4w8 at the engine's groups); the differences
  are the TPU memory envelopes the port leaves out, each named.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efficient_llm_inference_tpu.cache.kvcache import DenseKV as JaxDenseKV
from efficient_llm_inference_tpu.models import gpt2 as jgpt2
from efficient_llm_inference_tpu.models import llama as jllama
from efficient_llm_inference_tpu.models.registry import gpt2_spec as jax_gpt2_spec
from efficient_llm_inference_tpu.ops.pallas import megakernel as jmk
from efficient_llm_inference_tpu.ops.pallas import megakernel_batch as jmb
from efficient_llm_inference_tpu.ops.pallas import megakernel_batch_quant as jmbq
from efficient_llm_inference_tpu.ops.pallas import megakernel_llama as jml
from efficient_llm_inference_tpu_torch import Config, InferenceEngine
from efficient_llm_inference_tpu_torch.cache.kvcache import DenseKV
from efficient_llm_inference_tpu_torch.models import gpt2 as tgpt2
from efficient_llm_inference_tpu_torch.models import llama as tllama
from efficient_llm_inference_tpu_torch.models.registry import gpt2_spec
from efficient_llm_inference_tpu_torch.ops import megakernel as tmk
from efficient_llm_inference_tpu_torch.ops import megakernel_batch as tmb
from efficient_llm_inference_tpu_torch.ops import megakernel_batch_quant as tmbq
from efficient_llm_inference_tpu_torch.ops import megakernel_llama as tml
from torch_port_helpers import (
    DMA_GATE,
    PROMPTS,
    STREAM_CAP,
    VMEM,
    check_generate_batch,
    engine_pair,
    fake_params,
    jax_envelope,
    jax_rope_rows,
    np_gpt2_params,
    np_llama_params,
    served_configs,
    to_jax,
)

GPT2_KW = dict(vocab_size=300, n_positions=256, n_embd=128, n_layer=2, n_head=2)
LLAMA_KW = dict(vocab_size=300, hidden_size=256, intermediate_size=512, n_layer=2,
                n_head=4, n_kv_head=2, n_positions=512, rope_theta=10000.0,
                tie_embeddings=True)
LLAMA_VARIANTS = {"tied": {}, "qwen_bias": dict(qkv_bias=True, rms_eps=1e-6),
                  "untied": dict(tie_embeddings=False)}
C = 48
LENGTHS = [0, 7, C - 1]  # a slot with no visible row, and one writing the last column
B = len(LENGTHS)


def _panes(seed: int, L: int, W: int, E: int):
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal((L, B, C, W)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((L, B, C, W)) * 0.5).astype(np.float32)
    x = (rng.standard_normal((B, E)) * 0.5).astype(np.float32)
    return k, v, x


def _check_step(tok_t, tok_j, got, want, before):
    """Per-slot tokens equal; row lengths[b] of slot b within 1e-5 of JAX's
    (relative to its largest value), every other column untouched."""
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    for g, w, b0 in zip(got, want, before):
        for b, length in enumerate(LENGTHS):
            others = np.arange(C) != length
            np.testing.assert_array_equal(g[:, b][:, others], w[:, b][:, others])
            np.testing.assert_array_equal(g[:, b][:, others], b0[:, b][:, others])
            atol = 1e-5 * max(1.0, np.abs(w[:, b, length]).max())
            np.testing.assert_allclose(g[:, b, length], w[:, b, length], atol=atol, rtol=0)
            assert not np.array_equal(g[:, b, length], b0[:, b, length])


def test_gpt2_megabatch_matches_jax():
    jcfg, tcfg = jgpt2.GPT2Config(**GPT2_KW), tgpt2.GPT2Config(**GPT2_KW)
    np_p = np_gpt2_params(tcfg, seed=5, std=0.1)
    tp = tgpt2.params_from_jax(np_p, tcfg, torch.float32, "cpu")
    k, v, x = _panes(1, tcfg.n_layer, tcfg.n_embd, tcfg.n_embd)
    tok_j, k_j, v_j = jmb.gpt2_megabatch(
        jmk.pack_gpt2_mega(to_jax(np_p), jcfg), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(LENGTHS, jnp.int32), jnp.asarray(x), cfg=jcfg, capacity=C,
        interpret=True)
    kt, vt = torch.tensor(k), torch.tensor(v)
    tok_t, k_t, v_t = tmb.gpt2_megabatch(tmk.pack_gpt2_mega(tp, tcfg), kt, vt,
                                         torch.tensor(LENGTHS), torch.tensor(x), cfg=tcfg)
    assert k_t is kt and v_t is vt and tok_t.dtype == torch.int32
    _check_step(tok_t, tok_j, (k_t.numpy(), v_t.numpy()),
                (np.asarray(k_j), np.asarray(v_j)), (k, v))


@pytest.fixture(scope="module", params=list(LLAMA_VARIANTS))
def llama_setup(request):
    kw = dict(LLAMA_KW, **LLAMA_VARIANTS[request.param])
    jcfg, tcfg = jllama.LlamaConfig(**kw), tllama.LlamaConfig(**kw)
    np_p = np_llama_params(tcfg, seed=11, std=0.15)
    return jcfg, tcfg, np_p, tllama.params_from_jax(np_p, tcfg, torch.float32, "cpu")


def test_llama_megabatch_matches_jax(llama_setup):
    jcfg, tcfg, np_p, tp = llama_setup
    KW = tcfg.n_kv_head * tcfg.head_dim
    k, v, x = _panes(2, tcfg.n_layer, KW, tcfg.hidden_size)
    rows = [jax_rope_rows(jcfg, n) for n in LENGTHS]  # each slot's RoPE phase
    cos_q = jnp.concatenate([r[0] for r in rows])
    sin_q = jnp.concatenate([r[1] for r in rows])
    tok_j, k_j, v_j = jmb.llama_megabatch(
        jml.pack_llama_mega(to_jax(np_p), jcfg), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(LENGTHS, jnp.int32), jnp.asarray(x), cos_q, sin_q, cfg=jcfg,
        capacity=C, interpret=True)
    kt, vt = torch.tensor(k), torch.tensor(v)
    tok_t, _, _ = tmb.llama_megabatch(tml.pack_llama_mega(tp, tcfg), kt, vt, LENGTHS,
                                      torch.tensor(x), cfg=tcfg)
    _check_step(tok_t, tok_j, (kt.numpy(), vt.numpy()),
                (np.asarray(k_j), np.asarray(v_j)), (k, v))


def test_plain_batch_is_the_single_stream_step_per_slot():
    """Slot b of the plain batched step is the single-stream plain step on
    slot b's panes: the same token, logits and written rows."""
    cfg = tgpt2.GPT2Config(**GPT2_KW)
    tp = tgpt2.params_from_jax(np_gpt2_params(cfg, seed=6), cfg, torch.float32, "cpu")
    packed = tmk.pack_gpt2_mega(tp, cfg)
    k, v, x = (torch.tensor(a) for a in _panes(3, cfg.n_layer, cfg.n_embd, cfg.n_embd))
    kb, vb = k.clone(), v.clone()
    toks, _, _, logits = tmb.gpt2_megabatch_plain(packed, kb, vb, LENGTHS, x, cfg=cfg,
                                                  return_logits=True)
    for b, length in enumerate(LENGTHS):
        k1, v1 = k[:, b].clone(), v[:, b].clone()
        tok, _, _, lg = tmk.gpt2_megastep_plain(packed, k1, v1, length, x[b:b + 1],
                                                cfg=cfg, return_logits=True)
        assert int(toks[b]) == int(tok)
        assert torch.equal(logits[b], lg)
        assert torch.equal(kb[:, b], k1) and torch.equal(vb[:, b], v1)


def test_batch_layout_matches_jax():
    rng = np.random.default_rng(4)
    buf = rng.standard_normal((2, 3, 4, 16, 8)).astype(np.float32)
    want = np.asarray(jmb.to_mega_layout_batch(jnp.asarray(buf)))
    got = tmb.to_mega_layout_batch(torch.tensor(buf))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    back = np.asarray(jmb.from_mega_layout_batch(jnp.asarray(want), 4))
    np.testing.assert_array_equal(tmb.from_mega_layout_batch(got, 4).numpy(), back)
    np.testing.assert_array_equal(back, buf)


def test_dense_prefill_right_padded_rows_match_jax():
    """DenseKV at B = 3 with right-padded rows of unequal lengths: each
    row's logits at its own last token and its cached rows t < length agree
    with the JAX model's batched prefill."""
    jcfg, tcfg = jgpt2.GPT2Config(**GPT2_KW), tgpt2.GPT2Config(**GPT2_KW)
    np_p = np_gpt2_params(tcfg, seed=8)
    lens = np.array([5, 16, 1])
    rng = np.random.default_rng(9)
    toks = rng.integers(0, 300, (3, 16))
    toks[np.arange(16)[None, :] >= lens[:, None]] = 0
    mask = np.arange(16)[None, :] < lens[:, None]
    pos = np.broadcast_to(np.arange(16), (3, 16))
    kw = dict(n_layer=2, n_head=2, head_dim=64, capacity=C, batch=3)
    jstrat = JaxDenseKV(**kw, dtype=jnp.float32)
    jl, jc = jgpt2.gpt2_forward(to_jax(np_p), jcfg, jnp.asarray(toks), jnp.asarray(pos),
                                jstrat.init(), jstrat, jnp.asarray(mask))
    tstrat = DenseKV(**kw, dtype=torch.float32, device="cpu")
    tl, tc = tgpt2.gpt2_forward(tgpt2.params_from_jax(np_p, tcfg, torch.float32, "cpu"),
                                tcfg, torch.tensor(toks), torch.tensor(pos), tstrat.init(),
                                tstrat, torch.tensor(mask))
    for b, n in enumerate(lens):
        np.testing.assert_allclose(tl[b, n - 1].numpy(), np.asarray(jl)[b, n - 1],
                                   atol=1e-4, rtol=0)
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[name][:, b, :, :n].numpy(),
                                       np.asarray(jc[name])[:, b, :, :n], atol=1e-5, rtol=0)


# ------------------------------------------------------------------ engines

@pytest.fixture(scope="module")
def gpt2_engines():
    jcfg, tcfg = jgpt2.GPT2Config(**GPT2_KW), tgpt2.GPT2Config(**GPT2_KW)
    np_p = np_gpt2_params(tcfg, seed=12, std=0.1)
    return engine_pair(jax_gpt2_spec(jcfg), gpt2_spec(tcfg), np_p,
                       tgpt2.params_from_jax(np_p, tcfg, torch.float32, "cpu"))


@pytest.fixture(scope="module")
def llama_engines():
    jcfg, tcfg = jllama.LlamaConfig(**LLAMA_KW), tllama.LlamaConfig(**LLAMA_KW)
    np_p = np_llama_params(tcfg, seed=13, std=0.15)
    return engine_pair(jllama.llama_spec(jcfg), tllama.llama_spec(tcfg), np_p,
                       tllama.params_from_jax(np_p, tcfg, torch.float32, "cpu"))


def test_generate_batch_gpt2_matches_jax(gpt2_engines):
    check_generate_batch(gpt2_engines, None)


def test_generate_batch_llama_matches_jax(llama_engines):
    check_generate_batch(llama_engines, None)


def test_generate_batch_falls_back_per_prompt():
    """gpt2-tiny (E = 64) fails E % 128 on both sides: the port generates
    prompt by prompt, as the JAX engine does; so does a batch above
    MAX_BATCH, which the JAX package would batch."""
    cfg = tgpt2.GPT2Config.tiny()
    np_p = np_gpt2_params(cfg, seed=3, std=0.1)
    jeng, teng = engine_pair(jax_gpt2_spec(jgpt2.GPT2Config.tiny()), gpt2_spec(cfg),
                             np_p, tgpt2.params_from_jax(np_p, cfg, torch.float32, "cpu"))
    assert teng._mega_batch_spec(64, 3) is None
    got = teng.generate_batch(PROMPTS, max_new_tokens=5)
    assert not any(k[0] == "batch" for k in teng._fns)
    assert got == jeng.generate_batch(PROMPTS, max_new_tokens=5)
    assert teng.last_batch_ids == [teng.generate_ids(p, "full_cache", 5) for p in PROMPTS]

    wide = tgpt2.GPT2Config(**GPT2_KW)
    params = tgpt2.init_gpt2_params(torch.Generator().manual_seed(0), wide,
                                    torch.float32, "cpu")
    assert tmb.mega_batch_supported(wide, 64, params, tmb.MAX_BATCH)
    assert not tmb.mega_batch_supported(wide, 64, params, tmb.MAX_BATCH + 1)
    assert not tmbq.mega_batch_quant_supported(wide, 64, params, tmb.MAX_BATCH + 1, "int8")
    eng = InferenceEngine(gpt2_spec(wide), params, config=Config(
        model_name="t", device="cpu", dtype=torch.float32, megakernel=True))
    assert eng._mega_batch_spec(64, tmb.MAX_BATCH) is not None
    assert eng._mega_batch_spec(64, tmb.MAX_BATCH + 1) is None


def test_generate_batch_refuses_a_mesh(gpt2_engines):
    _, teng = gpt2_engines
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        teng.generate_batch(PROMPTS, 4, mesh=object())
    with pytest.raises(ValueError):
        teng.generate_batch([], 4)


# -------------------------------------------------------------- eligibility

_GPT2_SIZE = {"gpt2": "small", "gpt2-medium": "medium", "gpt2-large": "large",
              "gpt2-tiny": "tiny"}
GPT2_NAMES = tuple(_GPT2_SIZE)
LLAMA_NAMES = ("llama-3-8b", "llama3-8b", "llama-3-1b", "llama-3-3b", "llama-tiny",
               "qwen2.5-7b", "qwen/qwen2.5-7b", "qwen2.5-1.5b", "qwen2.5-0.5b",
               "qwen-tiny")
KV = (None, "int8", "int4", "mixed")
BATCHES = (1, 8)
# Where the JAX package refuses only because of a TPU memory envelope, the
# port accepts (the card streams weights and panes from its own 80 GB; the
# GEMVs stage their inputs in K-chunks): the cells, with the JAX condition
# that refuses them (ops/pallas/megakernel_batch.py, megakernel_batch_quant.py).
_VMEM = "VMEM budget of the batch rings (40 MB)"
_STREAM_CAP = "packed tile stream over the 4 GiB cap (16 GiB chip)"
_DMA_GATE = "more than 2048 tiles of under 256 KB (4595 tiles of 224 KB)"
ENVELOPE_ONLY = {
    ("gpt2-large", None, 8): _VMEM,  # 4 x 8 x 320 x 1280 x 2 B of K/V ring
    **{(name, kv, bs): _STREAM_CAP
       for name in ("llama-3-8b", "llama3-8b", "llama-3-3b", "qwen2.5-7b",
                    "qwen/qwen2.5-7b")
       for kv in KV for bs in BATCHES},
    **{("qwen2.5-0.5b", kv, bs): _DMA_GATE for kv in (None, "int8") for bs in BATCHES},
}


_fake = fake_params  # bf16 params in name only (the gates read kinds, dtypes, groups)


# Over quantized weights (bf16 scales and embeddings), the (model,
# weight_quant) pairs a JAX envelope refuses in some cell, and the envelope
# (torch_port_helpers.jax_envelope names it from JAX's own tile math): the
# port accepts every such cell.
WEIGHT_ENVELOPE = {
    **{("gpt2-large", wq): VMEM for wq in ("int8", "int4", "int4w8")},
    ("llama-3-3b", "int8"): VMEM,
    **{(name, "int8"): STREAM_CAP for name in ("llama-3-8b", "llama3-8b", "qwen2.5-7b",
                                               "qwen/qwen2.5-7b")},
    ("qwen2.5-0.5b", "int8"): DMA_GATE, ("qwen2.5-0.5b", "int4w8"): DMA_GATE,
    ("qwen2.5-1.5b", "int4"): DMA_GATE, ("qwen2.5-1.5b", "int4w8"): DMA_GATE,
}


def _decisions(capacity: int = 320, weights=(None,)) -> dict:
    """(name, kv, B) -> (JAX, port) over full-precision weights; with
    `weights` naming weight_quant values, (name, kv, B, wq) too."""
    table = {}
    for name, wq in ((n, w) for n in GPT2_NAMES + LLAMA_NAMES for w in weights):
        llama = name not in GPT2_NAMES
        if llama:
            jcfg, tcfg = jllama.LlamaConfig.by_name(name), tllama.LlamaConfig.by_name(name)
            names, embed, tied = tllama.WEIGHT_NAMES, "embed", tcfg.tie_embeddings
            jfp, jq = jmb.llama_mega_batch_supported, jmbq.llama_mega_batch_quant_supported
            tfp, tq = tmb.llama_mega_batch_supported, tmbq.llama_mega_batch_quant_supported
        else:
            jcfg = getattr(jgpt2.GPT2Config, _GPT2_SIZE[name])()
            tcfg = getattr(tgpt2.GPT2Config, _GPT2_SIZE[name])()
            names, embed, tied = tmk.WEIGHT_NAMES, "wte", True
            jfp, jq = jmb.mega_batch_supported, jmbq.mega_batch_quant_supported
            tfp, tq = tmb.mega_batch_supported, tmbq.mega_batch_quant_supported
        mode, group = "fp", 0
        if wq is not None:
            jcfg, tcfg, mode, group = served_configs(name, wq)
        jp = _fake(names, True, embed, tied, mode, group)
        tp = _fake(names, False, embed, tied, mode, group)
        for kv in KV:
            for bs in BATCHES:
                if kv is None:
                    pair = (jfp(jcfg, capacity, jp, bs), tfp(tcfg, capacity, tp, bs))
                else:
                    pair = (jq(jcfg, capacity, jp, bs, kv), tq(tcfg, capacity, tp, bs, kv))
                table[(name, kv, bs) + ((wq,) if wq else ())] = pair
    return table


def test_batch_eligibility_table_matches_jax():
    table = _decisions()
    differ = {key for key, (want, got) in table.items() if want != got}
    assert differ == set(ENVELOPE_ONLY), sorted(differ ^ set(ENVELOPE_ONLY), key=str)
    for key in differ:  # the port is only ever the more permissive
        assert table[key] == (False, True), (key, table[key])
    # the slice's two models take every pane kind at B = 1 and 8 on both sides
    for name in ("gpt2", "llama-3-1b"):
        for kv in KV:
            for bs in BATCHES:
                assert table[(name, kv, bs)] == (True, True), (name, kv, bs)
    assert table[("gpt2-tiny", None, 1)] == (False, False)  # E % 128
    assert table[("qwen2.5-0.5b", "int4", 8)] == (False, False)  # KW / 2 = 64 lanes
    # the weight tiers: every difference is a JAX envelope of WEIGHT_ENVELOPE
    # (the port only the more permissive), named by JAX's own tile math
    table = _decisions(weights=("int8", "int4", "int4w8"))
    differ = {key for key, (want, got) in table.items() if want != got}
    assert {(k[0], k[3]) for k in differ} == set(WEIGHT_ENVELOPE), sorted(differ, key=str)
    for name, kv, bs, wq in differ:
        assert table[(name, kv, bs, wq)] == (False, True)
        jcfg, _, mode, group = served_configs(name, wq)
        assert jax_envelope(jcfg, mode, group) == WEIGHT_ENVELOPE[(name, wq)], (name, wq)
    # the slice's two models take every weight tier and pane kind at B = 1, 8
    for name in ("gpt2", "llama-3-1b"):
        for key in (k for k in table if k[0] == name):
            assert table[key] == (True, True), key
