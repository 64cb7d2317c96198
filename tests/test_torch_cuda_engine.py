"""The engine's paths on the card against the same engine's plain steps on
the CPU: the decode through the fused attention kernels, the CUDA-graph
decode of each family and KV kind (megakernel on), generate_batch,
generate_speculative (ngram, self_draft, draft) and the continuous-batching
server, over model-dtype and quantized weights, with the launch counts of
each.

CUDA kernels have no CPU mode, so every test here needs an NVIDIA GPU: it is
marked `cuda` and skips without one. This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_engine.py

Tolerances, fp32: the greedy tokens agree while the plain logits' top-2 gap
stays at least 1e-4.
"""

import dataclasses

import pytest
import torch

from efficient_llm_inference_tpu_torch import (
    Config,
    InferenceEngine,
    MegaBatchServer,
    MegaPoolConfig,
    Request,
)
from efficient_llm_inference_tpu_torch.engine.engine import (
    quantize_weights,
    weight_quant_plan,
)
from efficient_llm_inference_tpu_torch.models import gpt2 as tgpt2
from efficient_llm_inference_tpu_torch.models import llama as tllama
from efficient_llm_inference_tpu_torch.models.registry import gpt2_spec
from efficient_llm_inference_tpu_torch.ops import attention as tattn
from efficient_llm_inference_tpu_torch.ops import megakernel as tmk
from efficient_llm_inference_tpu_torch.ops import megakernel_batch as tmb
from efficient_llm_inference_tpu_torch.ops import megakernel_batch_quant as tmbq
from efficient_llm_inference_tpu_torch.ops import megakernel_batch_verify as tbv
from efficient_llm_inference_tpu_torch.ops import megakernel_llama as tml
from efficient_llm_inference_tpu_torch.ops import megakernel_quant as tmq
from torch_cuda_cases import (  # noqa: F401 (cuda: the fixture)
    DRAFT_CFGS,
    _llama_cfg,
    _llama_params,
    _tree_to,
    cuda,
    server_plain_logits,
)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("method", ["quant_int8", "quant_int4", "quant_mixed"])
@pytest.mark.parametrize("granularity", ["per_token", "per_head"])
def test_engine_decode_through_kernels_matches_cpu(cuda, method, granularity):
    """A small GPT-2 (D = 64) in fp32: the card's greedy tokens, decoded
    through the kernels, teacher-forced through the CPU's plain versions give
    the same logits within 1e-3 at every step."""
    cfg = tgpt2.GPT2Config(vocab_size=256, n_positions=128, n_embd=128,
                           n_layer=2, n_head=2)
    params = tgpt2.init_gpt2_params(torch.Generator().manual_seed(0), cfg,
                                    torch.float32, "cpu")
    engines = {}
    for dev in ("cpu", "cuda"):
        p = {k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict)
                 else v.to(dev)) for k, v in params.items()}
        engines[dev] = InferenceEngine(gpt2_spec(cfg), p, config=Config(
            model_name="t", device=dev, dtype=torch.float32))
    prompt, n = "Kernels on the card.", 16
    before = tattn.fused_quant_attention_batched.launches
    toks, logits = engines["cuda"].generate_logits(prompt, method, n,
                                                   granularity=granularity)
    assert tattn.fused_quant_attention_batched.launches == before + cfg.n_layer * n
    _, want = engines["cpu"].generate_logits(prompt, method, n, forced=toks,
                                             granularity=granularity)
    torch.testing.assert_close(logits.cpu(), want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("method", ["full_cache", "quant_int8", "quant_int4",
                                    "quant_mixed"])
def test_engine_megakernel_graph_matches_plain_steps(cuda, method):
    """The engine's CUDA-graph decode (megakernel on, the default on a card)
    against the same engine's plain steps on the CPU, fp32: the greedy
    tokens agree while the plain logits' top-2 gap stays at least 1e-4, and
    every step is one launch of the kernel chain. E = 256, so that int4
    panes are eligible ((E/2) % 128 == 0)."""
    cfg = tgpt2.GPT2Config(vocab_size=256, n_positions=128, n_embd=256,
                           n_layer=2, n_head=4)
    params = tgpt2.init_gpt2_params(torch.Generator().manual_seed(0), cfg,
                                    torch.float32, "cpu")
    engines = {}
    for dev in ("cpu", "cuda"):
        p = {k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict)
                 else v.to(dev)) for k, v in params.items()}
        engines[dev] = InferenceEngine(gpt2_spec(cfg), p, config=Config(
            model_name="t", device=dev, dtype=torch.float32, megakernel=True))
    counter = tmk.gpt2_megastep if method == "full_cache" else tmq.gpt2_megastep_quant
    prompt, n = "Graphs replay the decode loop.", 16
    for _ in range(2):  # the second call replays the captured graph
        before = counter.launches
        got = engines["cuda"].generate_ids(prompt, method, n)
        assert counter.launches == before + n
    want = engines["cpu"].generate_ids(prompt, method, n)
    _, logits = engines["cpu"].generate_logits(prompt, method, n, forced=want[-n:])
    top2 = logits.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) >= 1e-4
    first_unclear = int((~clear).nonzero()[0]) if not bool(clear.all()) else n
    assert got[:len(got) - n + first_unclear] == want[:len(want) - n + first_unclear]


@pytest.mark.parametrize("method", ["full_cache", "quant_int8", "quant_int4",
                                    "quant_mixed"])
def test_engine_llama_megakernel_graph_matches_plain_steps(cuda, method):
    """The engine's CUDA-graph decode of a small Llama (G = 2, KW = 256, so
    int4 panes are eligible) against the same engine's plain steps on the
    CPU, fp32, as the GPT-2 test above."""
    cfg = _llama_cfg("g2")
    engines = {}
    for dev in ("cpu", "cuda"):
        engines[dev] = InferenceEngine(tllama.llama_spec(cfg), _llama_params(cfg, dev),
                                       config=Config(model_name="t", device=dev,
                                                     dtype=torch.float32,
                                                     megakernel=True))
    counter = tml.llama_megastep if method == "full_cache" else tmq.llama_megastep_quant
    prompt, n = "Graphs replay the decode loop.", 16
    for _ in range(2):  # the second call replays the captured graph
        before = counter.launches
        got = engines["cuda"].generate_ids(prompt, method, n)
        assert counter.launches == before + n
    want = engines["cpu"].generate_ids(prompt, method, n)
    _, logits = engines["cpu"].generate_logits(prompt, method, n, forced=want[-n:])
    top2 = logits.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) >= 1e-4
    first_unclear = int((~clear).nonzero()[0]) if not bool(clear.all()) else n
    assert got[:len(got) - n + first_unclear] == want[:len(want) - n + first_unclear]


@pytest.mark.parametrize("kv_mode", [None, "int8", "int4", "mixed"])
@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_engine_generate_batch_graph_matches_plain(cuda, family, kv_mode):
    """generate_batch on the card (the batched chain replayed from one CUDA
    graph) against the same engine's plain batched steps on the CPU, fp32:
    each row's tokens agree while the plain logits' top-2 gap stays at least
    1e-4; every step is one launch of the batched chain and the
    single-stream counters stay at 0."""
    if family == "gpt2":
        cfg = tgpt2.GPT2Config(vocab_size=256, n_positions=128, n_embd=256,
                               n_layer=2, n_head=4)
        spec = gpt2_spec(cfg)
        make = lambda dev: tgpt2.init_gpt2_params(  # noqa: E731
            torch.Generator().manual_seed(0), cfg, torch.float32, dev)
    else:
        cfg = _llama_cfg("g2")
        spec = tllama.llama_spec(cfg)
        make = lambda dev: _llama_params(cfg, dev)  # noqa: E731
    engines = {dev: InferenceEngine(spec, make(dev), config=Config(
        model_name="t", device=dev, dtype=torch.float32, megakernel=True))
        for dev in ("cpu", "cuda")}
    counter = {("gpt2", False): tmb.gpt2_megabatch, ("gpt2", True): tmbq.gpt2_megabatch_quant,
               ("llama", False): tmb.llama_megabatch,
               ("llama", True): tmbq.llama_megabatch_quant}[(family, kv_mode is not None)]
    singles = (tmk.gpt2_megastep, tmq.gpt2_megastep_quant, tml.llama_megastep,
               tmq.llama_megastep_quant)
    prompts = ["Graphs replay the decode loop.", "Batched slots", "x",
               "Every slot has its own length and position."]
    n = 16
    for _ in range(2):  # the second call replays the captured graph
        before = counter.launches
        single_before = [f.launches for f in singles]
        engines["cuda"].generate_batch(prompts, n, kv_mode=kv_mode)
        assert counter.launches == before + n
        assert [f.launches for f in singles] == single_before
    got = engines["cuda"].last_batch_ids
    engines["cpu"].generate_batch(prompts, n, kv_mode=kv_mode)
    want = engines["cpu"].last_batch_ids
    method = f"quant_{kv_mode}" if kv_mode else "full_cache"
    for p, g_, w_ in zip(prompts, got, want):
        _, logits = engines["cpu"].generate_logits(p, method, n, forced=w_[-n:])
        top2 = logits.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) >= 1e-4
        first = int((~clear).nonzero()[0]) if not bool(clear.all()) else n
        assert g_[:len(g_) - n + first] == w_[:len(w_) - n + first]


@pytest.mark.parametrize("spec,kv_mode", [(None, None), ("ngram", None), (None, "int8"),
                                          ("ngram", "mixed")])
def test_server_graph_matches_cpu_server(cuda, spec, kv_mode):
    """MegaBatchServer on the card (chunks replayed from CUDA graphs) against
    the same server on the CPU (plain steps and verifies), fp32, 4 slots of
    C = 128, six requests (two waves), one past the pane: every request's
    tokens equal while the top-2 gap of the port's per-prompt logits stays
    at least 1e-4; the batched chain (plain) or the batched verify (spec)
    launches once a step or round dispatched and no other kernel runs."""
    cfg = tgpt2.GPT2Config(vocab_size=256, n_positions=128, n_embd=256, n_layer=2, n_head=4)
    spec_m = gpt2_spec(cfg)
    params = {dev: tgpt2.init_gpt2_params(torch.Generator().manual_seed(0), cfg,
                                          torch.float32, dev) for dev in ("cpu", "cuda")}
    pool = MegaPoolConfig(n_slots=4, capacity=128, max_chunk=8, prompt_bucket=64)
    prompts = ["the cat sat on the cat sat on the", "a b a b a b", "x",
               "Every slot has its own length.", "abcabcabcabc", "y" * 60]
    budgets = [20, 33, 9, 17, 25, 80]
    counters = (tmb.gpt2_megabatch, tmbq.gpt2_megabatch_quant, tbv.gpt2_megabatch_verify,
                tbv.gpt2_megabatch_verify_quant, tmk.gpt2_megastep, tmq.gpt2_megastep_quant,
                tmk.gpt2_megaverify)
    runs = {}
    for dev in ("cpu", "cuda"):
        srv = MegaBatchServer(spec_m, params[dev], pool=pool, spec=spec, kv_mode=kv_mode,
                              dtype=torch.float32)
        reqs = [Request(rid=i, prompt_ids=list(p.encode()), max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, budgets))]
        before = [f.launches for f in counters]
        steps = []
        srv.run(reqs, progress=lambda n, _: steps.append(n))
        runs[dev] = ([r.out_ids for r in reqs], [f.launches - b for f, b in
                                                  zip(counters, before)], steps, srv)
    got, counts, steps, srv = runs["cuda"]
    want = runs["cpu"][0]
    main = {(None, False): 0, (None, True): 1, ("ngram", False): 2,
            ("ngram", True): 3}[(spec, kv_mode is not None)]
    assert counts[main] == steps[-1] > 0
    assert all(n == 0 for i, n in enumerate(counts) if i != main)
    eng = InferenceEngine(spec_m, params["cpu"], config=Config(
        model_name="t", device="cpu", dtype=torch.float32, megakernel=True))
    method = f"quant_{kv_mode}" if kv_mode else "full_cache"
    for p, n, g_, w_ in zip(prompts, budgets, got, want):
        if g_ == w_:
            continue
        _, logits = eng.generate_logits(p, method, n, forced=w_)
        top2 = logits.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) >= 1e-4
        first = int((~clear).nonzero()[0]) if not bool(clear.all()) else n
        assert g_[:first] == w_[:first], (p, first)
    if spec:
        assert runs["cpu"][3].spec_stats["rounds"] > 0


@pytest.mark.parametrize("spec", [None, "ngram"])
def test_server_bf16_pools_match_cpu_server(cuda, spec):
    """MegaBatchServer at its default pool dtype, bf16, over fp32 weights
    (the decode kernels over the weights cast once to bf16, GPT-2's rows
    embedded in fp32 and rounded once) on the card against the same server
    on the CPU (the plain batched step or verify over the same cast
    weights), 4 slots of C = 128, the five requests of
    test_server_graph_matches_cpu_server that fit the pane (the reference
    below is the single-stream plain step): every request's tokens equal up
    to its first parting, and there the CPU's token is the argmax of the
    plain bf16 logits (server_plain_logits) and the card's is within 2e-2
    of their maximum, the bf16 limit of the card tests; the batched step
    (verify) launches once a step (round) dispatched."""
    cfg = tgpt2.GPT2Config(vocab_size=256, n_positions=128, n_embd=256, n_layer=2, n_head=4)
    spec_m = gpt2_spec(cfg)
    params = {dev: tgpt2.init_gpt2_params(torch.Generator().manual_seed(0), cfg,
                                          torch.float32, dev) for dev in ("cpu", "cuda")}
    pool = MegaPoolConfig(n_slots=4, capacity=128, max_chunk=8, prompt_bucket=64)
    prompts = ["the cat sat on the cat sat on the", "a b a b a b", "x",
               "Every slot has its own length.", "abcabcabcabc"]
    budgets = [20, 33, 9, 17, 25]
    counter = tbv.gpt2_megabatch_verify if spec else tmb.gpt2_megabatch
    runs = {}
    for dev in ("cpu", "cuda"):
        srv = MegaBatchServer(spec_m, params[dev], pool=pool, spec=spec)
        assert srv.k_pool.dtype == srv.packed["attn_w"].dtype == torch.bfloat16
        reqs = [Request(rid=i, prompt_ids=list(p.encode()), max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, budgets))]
        before = counter.launches
        steps = []
        srv.run(reqs, progress=lambda n, _: steps.append(n))
        runs[dev] = ([r.out_ids for r in reqs], counter.launches - before, steps, srv)
    got, count, steps, _ = runs["cuda"]
    want, _, _, srv = runs["cpu"]
    assert count == steps[-1] > 0
    for p, g_, w_ in zip(prompts, got, want):
        if g_ == w_:
            continue
        i = next(j for j, (a, b) in enumerate(zip(g_, w_)) if a != b)
        logits = server_plain_logits(spec_m, params["cpu"], srv.packed, list(p.encode()),
                                     w_[:i + 1], pool.capacity, torch.bfloat16)[i]
        assert int(torch.argmax(logits)) == w_[i], (p, i)
        assert float(logits[g_[i]]) >= float(logits.max()) - 2e-2, (p, i)


@pytest.mark.parametrize("mode", ["ngram", "self_draft", "draft"])
@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_engine_generate_speculative_graph(cuda, family, mode):
    """generate_speculative on the card (one captured round replayed; fp32)
    equals the CPU engine's full_cache greedy up to the first step whose
    plain top-2 gap is under 1e-4; the verify kernel launches once a round,
    the burst once a round (mode "draft": draft_gpt2 / draft_llama), the
    1-layer self-draft's whole-step kernel k times a round (its vocabulary
    of 4096 is past the burst's 2048)."""
    from efficient_llm_inference_tpu_torch.ops import megakernel_draft as tmd

    V = 4096 if mode == "self_draft" else 256
    if family == "gpt2":
        cfg = tgpt2.GPT2Config(vocab_size=V, n_positions=256, n_embd=256, n_layer=2,
                               n_head=4)
        spec = gpt2_spec(cfg)
        make = lambda dev: tgpt2.init_gpt2_params(  # noqa: E731
            torch.Generator().manual_seed(0), cfg, torch.float32, dev)
        dcfg = DRAFT_CFGS["draft_gpt2"]()
        dspec = gpt2_spec(dcfg)
        dmake = lambda dev: tgpt2.init_gpt2_params(  # noqa: E731
            torch.Generator().manual_seed(5), dcfg, torch.float32, dev)
        verify, burst, step = tmk.gpt2_megaverify, tmd.gpt2_draft_burst, tmk.gpt2_megastep
    else:
        cfg = dataclasses.replace(_llama_cfg("g2"), vocab_size=V)
        spec = tllama.llama_spec(cfg)
        make = lambda dev: _llama_params(cfg, dev)  # noqa: E731
        dcfg = DRAFT_CFGS["draft_llama"]()
        dspec = tllama.llama_spec(dcfg)
        dmake = lambda dev: _llama_params(dcfg, dev)  # noqa: E731
        verify, burst, step = tml.llama_megaverify, tmd.llama_draft_burst, tml.llama_megastep
    engines = {dev: InferenceEngine(spec, make(dev), config=Config(
        model_name="t", device=dev, dtype=torch.float32, megakernel=True))
        for dev in ("cpu", "cuda")}
    kw = {"draft": (dspec, dmake("cuda"))} if mode == "draft" else {}
    prompt, n, k = "the cat sat on the mat and the cat sat on the hat", 24, 4
    counters = (verify, burst, step)
    for _ in range(2):  # the second call replays the captured round
        before = [c.launches for c in counters]
        _, got_n, st = engines["cuda"].generate_speculative(prompt, n, mode=mode, k=k,
                                                            stats=True, **kw)
        rounds = st["n_rounds"]
        added = [c.launches - b for c, b in zip(counters, before)]
        assert got_n == n and added[0] == rounds
        assert added[1] == (rounds if mode == "draft" else 0)
        assert added[2] == (k * rounds if mode == "self_draft" else 0)
    got = engines["cuda"].last_generation_ids
    want = engines["cpu"].generate_ids(prompt, "full_cache", n)
    _, logits = engines["cpu"].generate_logits(prompt, "full_cache", n, forced=want[-n:])
    top2 = logits.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) >= 1e-4
    first = int((~clear).nonzero()[0]) if not bool(clear.all()) else n
    assert got[:len(got) - n + first] == want[:len(want) - n + first]


@pytest.mark.parametrize("wq", ["int8", "int4", "int4w8"])
@pytest.mark.parametrize("method", ["full_cache", "quant_mixed"])
@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_engine_weight_quant_graph_matches_plain_steps(cuda, family, method, wq):
    """Config(weight_quant=...) through the engine's CUDA-graph decode against
    the same quantized weights' plain steps on the CPU, fp32: the greedy
    tokens agree while the plain logits' top-2 gap stays at least 1e-4, and
    every step is one launch of the chain's weight tier (no fp-tier
    launch)."""
    if family == "gpt2":
        cfg = tgpt2.GPT2Config(vocab_size=256, n_positions=128, n_embd=256, n_layer=2,
                               n_head=4)
        spec = gpt2_spec(cfg)
        params = tgpt2.init_gpt2_params(torch.Generator().manual_seed(0), cfg,
                                        torch.float32, "cpu")
        step = tmk.gpt2_megastep if method == "full_cache" else tmq.gpt2_megastep_quant
    else:
        cfg = _llama_cfg("g2")
        spec = tllama.llama_spec(cfg)
        params = _llama_params(cfg, "cpu")
        step = tml.llama_megastep if method == "full_cache" else tmq.llama_megastep_quant
    qspec, mode, G = weight_quant_plan(spec, wq)  # as from_model_name quantizes
    assert qspec is spec
    q = quantize_weights(spec, params, mode, G)
    engines = {dev: InferenceEngine(spec, _tree_to(q, dev), config=Config(
        model_name="t", device=dev, dtype=torch.float32, megakernel=True))
        for dev in ("cpu", "cuda")}
    tier = step.tiers[wq[:4]]
    prompt, n = "Quantized weights stream as codes.", 16
    for _ in range(2):  # the second call replays the captured graph
        before = (step.launches, tier.launches)
        got = engines["cuda"].generate_ids(prompt, method, n)
        assert (step.launches, tier.launches) == (before[0], before[1] + n)
    want = engines["cpu"].generate_ids(prompt, method, n)
    _, logits = engines["cpu"].generate_logits(prompt, method, n, forced=want[-n:])
    top2 = logits.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) >= 1e-4
    first_unclear = int((~clear).nonzero()[0]) if not bool(clear.all()) else n
    assert got[:len(got) - n + first_unclear] == want[:len(want) - n + first_unclear]
