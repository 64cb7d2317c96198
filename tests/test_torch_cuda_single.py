"""The single-stream whole-step kernels against their plain steps, on the
card: GPT-2's persistent step (#9 gpt2_megastep, #11 gpt2_megastep_quant)
and the Llama/Qwen chain (#13 at R = 1, #12), every pane kind, both dtypes
and every weight tier (int8, grouped int4, int4w8).

CUDA kernels have no CPU mode, so every test here needs an NVIDIA GPU: it is
marked `cuda` and skips without one. This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_single.py

Tolerances, in fp32: the token equal wherever the plain top-2 logit gap is
at least 1e-4, new K/V rows within 1e-5 (of the row's largest value, at
least 1e-5, for the Llama step; codes within one step, scales within 1e-5
relative, for quantized panes), every other row untouched; in bf16,
chip_smoke.py's (a token within 2e-2 of the plain maximum logit, fp rows
within 1.6e-2 of their largest value, quantized rows within two steps).
GPT-2's persistent step is also held at lengths 0, 1, C - 1 and 8191 at
C = 8192, its bits the same at two grid sizes, and 64 replays of a captured
graph then a second generation on the same launcher bit-identical to 64
eager launches. The Llama chain at Llama-3.2-1B's width cut to 2 layers, a
Qwen group of 7 and head_dim 128, at C = 320 on the lengths where the
attention's splits change and at C = 8192, length 8191; two replays of one
captured graph of 6 steps give identical bits, equal to the same steps
launched eagerly.
"""

import pytest
import torch

from efficient_llm_inference_tpu_torch.models import gpt2 as tgpt2
from efficient_llm_inference_tpu_torch.ops import megakernel as tmk
from efficient_llm_inference_tpu_torch.ops import megakernel_llama as tml
from efficient_llm_inference_tpu_torch.ops import megakernel_quant as tmq
from torch_cuda_cases import (  # noqa: F401 (cuda: the fixture)
    LLAMA_CFGS,
    MEGA_CFGS,
    SPLIT_CFGS,
    SPLIT_WHERE,
    TIER_CFGS,
    _check_llama_split_step,
    _llama_cfg,
    _llama_inputs,
    _llama_params,
    _mega_inputs,
    _split_length,
    _split_packed,
    _tier_packed,
    cuda,
)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("mode", ["fp", "int8", "int4", "mixed"])
@pytest.mark.parametrize("cfg_name", list(MEGA_CFGS))
@pytest.mark.parametrize("length", [0, 37, 127])
def test_megastep_matches_plain(cuda, mode, cfg_name, length):
    cfg = tgpt2.GPT2Config(**MEGA_CFGS[cfg_name])
    C = 128
    params = tgpt2.init_gpt2_params(torch.Generator().manual_seed(1), cfg,
                                    torch.float32, cuda)
    packed = tmk.pack_gpt2_mega(params, cfg)
    state, x = _mega_inputs(cfg, mode, C, seed=length, device=cuda)
    got = [t.clone() for t in state]
    want = [t.clone() for t in state]
    if mode == "fp":
        before = tmk.gpt2_megastep.launches
        tok = tmk.gpt2_megastep(packed, *got, length, x, cfg=cfg)[0]
        assert tmk.gpt2_megastep.launches == before + 1
        logits = tmk.gpt2_megastep_plain(packed, *want, length, x, cfg=cfg,
                                         return_logits=True)[-1]
    else:
        before = tmq.gpt2_megastep_quant.launches
        tok = tmq.gpt2_megastep_quant(packed, *got, length, x, cfg=cfg,
                                      kv_mode=mode)[0]
        assert tmq.gpt2_megastep_quant.launches == before + 1
        logits = tmq.gpt2_megastep_quant_plain(packed, *want, length, x, cfg=cfg,
                                               kv_mode=mode, return_logits=True)[-1]
    torch.cuda.synchronize()
    top2 = logits.topk(2).values
    if float(top2[0] - top2[1]) >= 1e-4:
        assert int(tok) == int(logits.argmax())
    others = torch.arange(C, device=cuda) != length
    for g_, w_, b_ in zip(got, want, state):
        assert torch.equal(g_[:, others], b_[:, others])
        assert torch.equal(w_[:, others], b_[:, others])
    if mode == "fp":
        for g_, w_ in zip(got, want):
            torch.testing.assert_close(g_[:, length], w_[:, length], atol=1e-5, rtol=0)
        return
    for kind, g_, w_ in zip(tmq._kv_kinds(mode), got[:2], want[:2]):
        gv = tmq.pane_values(g_[:, length], kind)
        wv = tmq.pane_values(w_[:, length], kind)
        assert (gv - wv).abs().max() <= 1
    for g_, w_ in zip(got[2:], want[2:]):
        torch.testing.assert_close(g_[:, length], w_[:, length], rtol=1e-5, atol=0)


@pytest.mark.parametrize("mode", ["fp", "int8", "int4", "mixed"])
@pytest.mark.parametrize("cfg_name", list(LLAMA_CFGS))
@pytest.mark.parametrize("length", [0, 37, 127])
def test_llama_megastep_matches_plain(cuda, mode, cfg_name, length):
    cfg = _llama_cfg(cfg_name)
    C = 128
    packed = tml.pack_llama_mega(_llama_params(cfg, cuda), cfg)
    state, x = _llama_inputs(cfg, mode, C, seed=length, device=cuda)
    got = [t.clone() for t in state]
    want = [t.clone() for t in state]
    if mode == "fp":
        before = tml.llama_megastep.launches
        tok = tml.llama_megastep(packed, *got, length, x, cfg=cfg)[0]
        assert tml.llama_megastep.launches == before + 1
        logits = tml.llama_megastep_plain(packed, *want, length, x, cfg=cfg,
                                          return_logits=True)[-1]
    else:
        before = tmq.llama_megastep_quant.launches
        tok = tmq.llama_megastep_quant(packed, *got, length, x, cfg=cfg,
                                       kv_mode=mode)[0]
        assert tmq.llama_megastep_quant.launches == before + 1
        logits = tmq.llama_megastep_quant_plain(packed, *want, length, x, cfg=cfg,
                                                kv_mode=mode, return_logits=True)[-1]
    torch.cuda.synchronize()
    top2 = logits.topk(2).values
    if float(top2[0] - top2[1]) >= 1e-4:
        assert int(tok) == int(logits.argmax())
    others = torch.arange(C, device=cuda) != length
    for g_, w_, b_ in zip(got, want, state):
        assert torch.equal(g_[:, others], b_[:, others])
        assert torch.equal(w_[:, others], b_[:, others])
    if mode == "fp":
        for g_, w_ in zip(got, want):
            atol = 1e-5 * max(1.0, w_[:, length].abs().max().item())
            torch.testing.assert_close(g_[:, length], w_[:, length], atol=atol, rtol=0)
        return
    for kind, g_, w_ in zip(tmq._kv_kinds(mode), got[:2], want[:2]):
        gv = tmq.pane_values(g_[:, length], kind)
        wv = tmq.pane_values(w_[:, length], kind)
        assert (gv - wv).abs().max() <= 1
    for g_, w_ in zip(got[2:], want[2:]):
        torch.testing.assert_close(g_[:, length], w_[:, length], rtol=1e-5, atol=0)


@pytest.mark.parametrize("length", [0, 127])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["fp", "int8", "int4", "mixed"])
@pytest.mark.parametrize("wq", ["int8", "int4", "int4w8"])
@pytest.mark.parametrize("cfg_name", list(TIER_CFGS))
def test_weight_tier_step_matches_plain(cuda, cfg_name, wq, mode, dtype, length):
    """#9 / #11 (GPT-2) and #13 at R = 1 / #12 (Llama/Qwen) over quantized
    weights against their plain steps, C = 128, lengths 0 and C - 1: fp32
    as the fp-weight tests above (the token where the top-2 gap is at least
    1e-4, new rows within 1e-5 of their largest value, codes within one
    step, scales within 1e-5); bf16 with chip_smoke.py's tolerances (a
    token within 2e-2 of the plain maximum, fp rows within 1.6e-2 of their
    largest value, quantized rows within two steps). The launch lands in
    the wrapper's tier count, not its full-precision one."""
    family, cfg, packed = _tier_packed(cfg_name, wq, dtype, cuda)
    C = 128
    inputs = _mega_inputs if family == "gpt2" else _llama_inputs
    state, x = inputs(cfg, mode, C, seed=length + 5, device=cuda)
    state = [t.to(dtype) if t.is_floating_point() and t.dim() == 3 else t for t in state]
    x = x.to(dtype)
    got = [t.clone() for t in state]
    want = [t.clone() for t in state]
    step = {("gpt2", "fp"): tmk.gpt2_megastep, ("gpt2", "q"): tmq.gpt2_megastep_quant,
            ("llama", "fp"): tml.llama_megastep,
            ("llama", "q"): tmq.llama_megastep_quant}[(family, "fp" if mode == "fp" else "q")]
    plain = {tmk.gpt2_megastep: tmk.gpt2_megastep_plain,
             tmq.gpt2_megastep_quant: tmq.gpt2_megastep_quant_plain,
             tml.llama_megastep: tml.llama_megastep_plain,
             tmq.llama_megastep_quant: tmq.llama_megastep_quant_plain}[step]
    kw = {} if mode == "fp" else {"kv_mode": mode}
    tier = step.tiers[wq[:4]]
    before = (step.launches, tier.launches)
    tok = int(step(packed, *got, length, x, cfg=cfg, **kw)[0])
    assert (step.launches, tier.launches) == (before[0], before[1] + 1)
    logits = plain(packed, *want, length, x, cfg=cfg, return_logits=True, **kw)[-1]
    torch.cuda.synchronize()
    top2 = logits.topk(2).values
    if dtype == torch.float32:
        if float(top2[0] - top2[1]) >= 1e-4:
            assert tok == int(logits.argmax())
    else:
        assert float(logits[tok]) >= float(top2[0]) - 2e-2
    others = torch.arange(C, device=cuda) != length
    for g_, w_, b_ in zip(got, want, state):
        assert torch.equal(g_[:, others], b_[:, others])
        assert torch.equal(w_[:, others], b_[:, others])
    if mode == "fp":
        rel = 1e-5 if dtype == torch.float32 else 1.6e-2
        for g_, w_ in zip(got, want):
            atol = rel * max(1.0, w_[:, length].float().abs().max().item())
            torch.testing.assert_close(g_[:, length].float(), w_[:, length].float(),
                                       atol=atol, rtol=0)
        return
    steps = 1 if dtype == torch.float32 else 2
    for kind, g_, w_, gs, ws in zip(tmq._kv_kinds(mode), got[:2], want[:2], got[2:],
                                    want[2:]):
        gv = tmq.pane_values(g_[:, length], kind) * gs[:, length, None]
        wv = tmq.pane_values(w_[:, length], kind) * ws[:, length, None]
        tol = steps * max(gs[:, length].max().item(), ws[:, length].max().item()) * 1.01
        assert (gv - wv).abs().max() <= tol
        if dtype == torch.float32:
            torch.testing.assert_close(gs[:, length], ws[:, length], rtol=1e-5, atol=0)


@pytest.mark.parametrize("where", SPLIT_WHERE)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["fp", "int8", "int4", "mixed"])
@pytest.mark.parametrize("wq", [None, "int8", "int4", "int4w8"])
@pytest.mark.parametrize("cfg_name", list(SPLIT_CFGS))
def test_llama_split_step_matches_plain(cuda, cfg_name, wq, mode, dtype, where):
    """#13 at R = 1 and #12 over every pane kind and weight tier, fp32 and
    bf16, C = 320, at the lengths where the split-KV attention changes: no
    visible row, one, the last row of a split and the first of the next
    visible last, and C - 1."""
    cfg, _ = _split_packed(cfg_name, wq, dtype, cuda)
    _check_llama_split_step(cuda, cfg_name, wq, mode, dtype, 320, _split_length(cfg, 320, where))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["fp", "int8", "int4", "mixed"])
@pytest.mark.parametrize("wq", [None, "int8", "int4", "int4w8"])
@pytest.mark.parametrize("cfg_name", list(SPLIT_CFGS))
def test_llama_split_step_at_the_capacity_limit(cuda, cfg_name, wq, mode, dtype):
    """The same at C = 8192 (the kernels' capacity limit), length C - 1:
    every split full."""
    _check_llama_split_step(cuda, cfg_name, wq, mode, dtype, 8192, 8191)


@pytest.mark.parametrize("wq", [None, "int4"])
@pytest.mark.parametrize("mode", ["fp", "int8"])
def test_llama_step_graph_replays_bit_identical(cuda, mode, wq):
    """Two replays of one captured CUDA graph of 6 advancing steps
    (MegaDecodeGraph, programmatic dependent launch inside) give identical
    bits (tokens, panes, scales), and equal the same 6 steps launched
    eagerly; bf16 at Llama-3.2-1B's width, 2 layers, C = 320, length 100."""
    cfg, packed = _split_packed("llama-3-1b-L2", wq, torch.bfloat16, cuda)
    C, n, length = 320, 6, 100
    state, _ = _llama_inputs(cfg, mode, C, seed=3, device=cuda)
    state = [t.to(torch.bfloat16) if t.is_floating_point() and t.dim() == 3 else t
             for t in state]
    names = ["k", "v", "ks", "vs"][:len(state)]
    kinds = ("fp", "fp") if mode == "fp" else tmq._kv_kinds(mode)
    kw = dict(k_kind=kinds[0], v_kind=kinds[1], quant_eps=1e-8)
    counter = tml.llama_megastep if mode == "fp" else tmq.llama_megastep_quant
    tok0 = torch.tensor([17], dtype=torch.int32, device=cuda)
    graph = tmk.MegaDecodeGraph(packed, cfg, n, {nm: torch.empty_like(t) for nm, t in
                                                 zip(names, state)}, counter,
                                launcher=tml.LlamaStepLauncher, **kw)
    runs = []
    for _ in range(2):
        for nm, t in zip(names, state):
            graph.panes[nm].copy_(t)
        toks = graph.run(tok0, length).clone()
        torch.cuda.synchronize()
        runs.append([toks] + [graph.panes[nm].clone() for nm in names])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    eager = [t.clone() for t in state]
    toks = torch.zeros(n + 1, 1, dtype=torch.int32, device=cuda)
    toks[0] = tok0
    lengths = torch.tensor([length], dtype=torch.int32, device=cuda)
    panes = dict(zip(names, eager))
    step = tml.LlamaStepLauncher(packed, cfg, panes["k"], panes["v"], lengths, toks[1],
                                 tok_in=toks[0], ks=panes.get("ks"), vs=panes.get("vs"),
                                 advance=True, **kw)
    for i in range(n):
        step.set_tokens(toks[i], toks[i + 1])
        step.launch()
    torch.cuda.synchronize()
    assert torch.equal(toks[:n], runs[0][0])
    for a, b in zip(eager, runs[0][1:]):
        assert torch.equal(a, b)


# ------------------------------------- GPT-2's persistent step (#9, #11)

_GPT2_PACKED = {}


def _gpt2_packed(cfg_name, wq, dtype, device):
    """(cfg, packed) of GPT-2 at MEGA_CFGS[cfg_name] (the card tests' random
    weights) in `dtype`, or its weight tier `wq` (cached per case)."""
    key = (cfg_name, wq, dtype)
    if key not in _GPT2_PACKED:
        if wq is None:
            cfg = tgpt2.GPT2Config(**MEGA_CFGS[cfg_name])
            params = tgpt2.init_gpt2_params(torch.Generator().manual_seed(1), cfg, dtype, device)
            _GPT2_PACKED[key] = (cfg, tmk.pack_gpt2_mega(params, cfg))
        else:
            tier = "gpt2-full" if cfg_name == "gpt2" else "gpt2-" + cfg_name
            _, cfg, packed = _tier_packed(tier, wq, dtype, device)
            _GPT2_PACKED[key] = (cfg, packed)
    return _GPT2_PACKED[key]


def _gpt2_state(cfg, mode, dtype, C, seed, device):
    state, x = _mega_inputs(cfg, mode, C, seed=seed, device=device)
    return ([t.to(dtype) if t.is_floating_point() and t.dim() == 3 else t for t in state],
            x.to(dtype))


def _check_gpt2_step(device, cfg_name, wq, mode, dtype, C, length):
    """#9 / #11 against their plain steps with _check_llama_split_step's
    checks: fp32 tokens equal where the top-2 gap is at least 1e-4, bf16
    within 2e-2 of the plain maximum; new rows within 1e-5 (fp32) / 1.6e-2
    (bf16) of their largest value, quantized rows within one (fp32) / two
    (bf16) steps, fp32 scales within 1e-5; every other row untouched; one
    launch counted where it belongs and one kernel a step."""
    cfg, packed = _gpt2_packed(cfg_name, wq, dtype, device)
    state, x = _gpt2_state(cfg, mode, dtype, C, length + 5, device)
    got = [t.clone() for t in state]
    want = [t.clone() for t in state]
    step, plain = ((tmk.gpt2_megastep, tmk.gpt2_megastep_plain) if mode == "fp" else
                   (tmq.gpt2_megastep_quant, tmq.gpt2_megastep_quant_plain))
    kw = {} if mode == "fp" else {"kv_mode": mode}
    counter = step if wq is None else step.tiers[wq[:4]]
    before, kernels = counter.launches, tmk.step_kernels()
    tok = int(step(packed, *got, length, x, cfg=cfg, **kw)[0])
    assert counter.launches == before + 1 and tmk.step_kernels() == kernels + 1
    logits = plain(packed, *want, length, x, cfg=cfg, return_logits=True, **kw)[-1]
    torch.cuda.synchronize()
    top2 = logits.topk(2).values
    if dtype == torch.float32:
        if float(top2[0] - top2[1]) >= 1e-4:
            assert tok == int(logits.argmax())
    else:
        assert float(logits[tok]) >= float(top2[0]) - 2e-2
    others = torch.arange(C, device=device) != length
    for g_, w_, b_ in zip(got, want, state):
        assert torch.equal(g_[:, others], b_[:, others])
        assert torch.equal(w_[:, others], b_[:, others])
    if mode == "fp":
        rel = 1e-5 if dtype == torch.float32 else 1.6e-2
        for g_, w_ in zip(got, want):
            atol = rel * max(1.0, w_[:, length].float().abs().max().item())
            torch.testing.assert_close(g_[:, length].float(), w_[:, length].float(),
                                       atol=atol, rtol=0)
        return
    steps = 1 if dtype == torch.float32 else 2
    for kind, g_, w_, gs, ws in zip(tmq._kv_kinds(mode), got[:2], want[:2], got[2:],
                                    want[2:]):
        gv = tmq.pane_values(g_[:, length], kind) * gs[:, length, None]
        wv = tmq.pane_values(w_[:, length], kind) * ws[:, length, None]
        tol = steps * max(gs[:, length].max().item(), ws[:, length].max().item()) * 1.01
        assert (gv - wv).abs().max() <= tol
        if dtype == torch.float32:
            torch.testing.assert_close(gs[:, length], ws[:, length], rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["fp", "int8", "int4", "mixed"])
@pytest.mark.parametrize("length_at", ["zero", "one", "last"])
@pytest.mark.parametrize("C", [320, 8192])
@pytest.mark.parametrize("cfg_name", list(MEGA_CFGS))
def test_gpt2_step_lengths(cuda, cfg_name, C, length_at, mode, dtype):
    """#9 / #11 at lengths 0, 1 and C - 1 (8191 at the kernels' capacity
    limit C = 8192, every attention split full) for every pane kind, both
    dtypes and both head dims (small-test: 128, GPT-2 small: 64)."""
    length = {"zero": 0, "one": 1, "last": C - 1}[length_at]
    _check_gpt2_step(cuda, cfg_name, None, mode, dtype, C, length)


def _gpt2_launch(packed, cfg, state, x, mode, length, grid=None):
    """One launch of the step on copies of `state`; returns (token, panes)."""
    panes = [t.clone() for t in state]
    kinds = ("fp", "fp") if mode == "fp" else tmq._kv_kinds(mode)
    tok = torch.zeros(1, dtype=torch.int32, device=x.device)
    lengths = torch.tensor([length], dtype=torch.int32, device=x.device)
    step = tmk.StepLauncher(packed, cfg, panes[0], panes[1], lengths, tok, x_emb=x,
                            ks=panes[2] if mode != "fp" else None,
                            vs=panes[3] if mode != "fp" else None,
                            k_kind=kinds[0], v_kind=kinds[1], grid=grid)
    step.launch()
    torch.cuda.synchronize()
    return tok, panes, step.args.grid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wq", [None, "int8", "int4"])
@pytest.mark.parametrize("mode", ["fp", "int8", "int4", "mixed"])
def test_gpt2_step_bits_independent_of_grid(cuda, mode, wq, dtype):
    """The same step at the full grid and at 37 and 5 blocks gives the same
    bits (token, panes, scales): a row's sum and the attention's splits do
    not depend on the plan's grid. GPT-2 small, C = 320, length 100."""
    cfg, packed = _gpt2_packed("gpt2", wq, dtype, cuda)
    state, x = _gpt2_state(cfg, mode, dtype, 320, 3, cuda)
    tok, panes, full = _gpt2_launch(packed, cfg, state, x, mode, 100)
    assert full > 37
    for grid in (37, 5):
        tok_g, panes_g, used = _gpt2_launch(packed, cfg, state, x, mode, 100, grid=grid)
        assert used == grid and torch.equal(tok_g, tok)
        for a, b in zip(panes_g, panes):
            assert torch.equal(a, b)


@pytest.mark.parametrize("wq", [None, "int4"])
@pytest.mark.parametrize("mode", ["fp", "int8"])
def test_gpt2_step_graph_replays_bit_identical(cuda, mode, wq):
    """A captured graph of 64 advancing steps (MegaDecodeGraph: 64
    cooperative launches), replayed for one generation and again for a
    second on the same launcher, gives identical bits (tokens, panes,
    scales), equal to the same 64 steps launched eagerly: the grid
    barrier's counter and the tickets come back clean after every launch.
    bf16 GPT-2 small, C = 320, length 100."""
    cfg, packed = _gpt2_packed("gpt2", wq, torch.bfloat16, cuda)
    C, n, length = 320, 64, 100
    state, _ = _gpt2_state(cfg, mode, torch.bfloat16, C, 7, cuda)
    names = ["k", "v", "ks", "vs"][:len(state)]
    kinds = ("fp", "fp") if mode == "fp" else tmq._kv_kinds(mode)
    kw = dict(k_kind=kinds[0], v_kind=kinds[1], quant_eps=1e-8)
    counter = tmk.gpt2_megastep if mode == "fp" else tmq.gpt2_megastep_quant
    tok0 = torch.tensor([17], dtype=torch.int32, device=cuda)
    graph = tmk.MegaDecodeGraph(packed, cfg, n, {nm: torch.empty_like(t) for nm, t in
                                                 zip(names, state)}, counter,
                                launcher=tmk.StepLauncher, **kw)
    assert graph.per_replay == n
    runs = []
    for _ in range(2):
        for nm, t in zip(names, state):
            graph.panes[nm].copy_(t)
        kernels = tmk.step_kernels()
        toks = graph.run(tok0, length).clone()
        torch.cuda.synchronize()
        assert tmk.step_kernels() == kernels  # a replay issues no host launch
        runs.append([toks] + [graph.panes[nm].clone() for nm in names])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    eager = [t.clone() for t in state]
    toks = torch.zeros(n + 1, 1, dtype=torch.int32, device=cuda)
    toks[0] = tok0
    lengths = torch.tensor([length], dtype=torch.int32, device=cuda)
    panes = dict(zip(names, eager))
    step = tmk.StepLauncher(packed, cfg, panes["k"], panes["v"], lengths, toks[1],
                            tok_in=toks[0], ks=panes.get("ks"), vs=panes.get("vs"),
                            advance=True, **kw)
    for i in range(n):
        step.set_tokens(toks[i], toks[i + 1])
        step.launch()
    torch.cuda.synchronize()
    assert int(lengths) == length + n
    assert torch.equal(toks[:n], runs[0][0])
    for a, b in zip(eager, runs[0][1:]):
        assert torch.equal(a, b)
