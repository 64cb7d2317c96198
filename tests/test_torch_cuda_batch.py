"""The batched whole-step kernels (#14-#17) against their plain versions,
per slot, on the card: B in {1, 3, 8, 9, 16, 32}, every pane kind, both
dtypes and the weight tiers. GPT-2's batched step (#14 / #16, one persistent
kernel a step, csrc/gpt2_megabatch.cu): every pane kind x weight tier x
dtype at head_dim 64 and 128, mixed per-slot lengths with 0, 1 and C - 1 at
C = 320 and 8192, a slot's token and new K/V bytes the same at B = 1, 8, 9,
16 and 32, beside other slots and at the full grid, 37 and 5 blocks, two
replays of a captured 32-step graph equal to eager launches, one kernel a
step. The bf16 batched Llama chain (#15 / #17 on
csrc/gemv_stream_tc.cuh): a slot's token and new K/V row bytes are the same
at B = 1, 8, 9, 16 and 32 for every pane kind and the int8 / int4 weights,
a step launches 5 L + 3 kernels at every B, the chain holds at Qwen2.5-7B's
and Llama-3-8B's widths (one layer), and one of its GEMVs alone
(`stream_gemv`) is within one bf16 rounding of its plain version in every
weight tier.

CUDA kernels have no CPU mode, so every test here needs an NVIDIA GPU: it is
marked `cuda` and skips without one. This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_batch.py

Tolerances: the single-stream steps' (tests/test_torch_cuda_single.py), per
slot.
"""

import pytest
import torch

from efficient_llm_inference_tpu_torch.models import gpt2 as tgpt2
from efficient_llm_inference_tpu_torch.ops import megakernel as tmk
from efficient_llm_inference_tpu_torch.ops import megakernel_batch as tmb
from efficient_llm_inference_tpu_torch.ops import megakernel_batch_quant as tmbq
from efficient_llm_inference_tpu_torch.ops import megakernel_quant as tmq
from torch_cuda_cases import (  # noqa: F401 (cuda: the fixture)
    BATCH_LENGTHS,
    MEGA_CFGS,
    _batch_case,
    _check_megabatch,
    _tier_packed,
    cuda,
)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("B", [1, 3, 8, 9, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["fp", "int8", "int4", "mixed"])
@pytest.mark.parametrize("family", ["gpt2", "gpt2-full", "llama"])
def test_megabatch_matches_plain(cuda, family, mode, dtype, B):
    """#14-#17 against their plain versions, B slots at mixed lengths. fp32:
    tokens equal where the plain top-2 gap is at least 1e-4, new fp rows
    within 1e-5 of the row's largest value (at least 1e-5), codes within one
    step, scales within rtol 1e-5. bf16: a token whose plain logit is within
    2e-2 of the maximum, fp rows within 1.6e-2 of the row's largest value,
    dequantized rows within two steps (chip_smoke.py's tolerances)."""
    _check_megabatch(cuda, family, mode, dtype, B)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["fp", "mixed"])
@pytest.mark.parametrize("wq", ["int8", "int4", "int4w8"])
@pytest.mark.parametrize("family", ["gpt2", "gpt2-full", "llama"])
def test_tier_megabatch_matches_plain(cuda, family, wq, mode, dtype):
    """#14-#17 over quantized weights, B = 9 slots (two groups of 8 rows),
    with test_megabatch_matches_plain's checks and tolerances."""
    _check_megabatch(cuda, family, mode, dtype, 9, wq)


@pytest.mark.parametrize("B", [8, 16, 32])
@pytest.mark.parametrize("mode", ["fp", "mixed"])
@pytest.mark.parametrize("wq", ["int8", "int4", "int4w8"])
@pytest.mark.parametrize("family", ["llama", "llama-3-1b-L2"])
def test_tier_llama_megabatch_wide(cuda, family, wq, mode, B):
    """#15 / #17 over quantized weights in bf16 at B = 8, 16 and 32 (each
    GEMV one launch for all slots, csrc/gemv_stream_tc.cuh; Llama-3.2-1B's
    widths at 2 layers included), with test_megabatch_matches_plain's checks
    and tolerances."""
    _check_megabatch(cuda, family, mode, torch.bfloat16, B, wq)


@pytest.mark.parametrize("wq", [None, "int8", "int4"])
@pytest.mark.parametrize("mode", ["fp", "int8", "int4", "mixed"])
def test_llama_megabatch_rows_independent(cuda, mode, wq):
    """In bf16 the Llama chain (#15 / #17) gives slot b's token and its new
    K/V row bytes (codes and scales for quantized panes) bit for bit the same
    at B = 1, 8, 9, 16 and 32, and with its neighbours in another order: a
    slot's sums do not depend on B or on the slots beside it."""
    packed, cfg, state, x = _batch_case("llama", mode, torch.bfloat16, 32, cuda, wq)
    lengths = [BATCH_LENGTHS[b % len(BATCH_LENGTHS)] for b in range(32)]
    kern = tmb.llama_megabatch if mode == "fp" else tmbq.llama_megabatch_quant
    kw = {} if mode == "fp" else {"kv_mode": mode}

    def run(slots):
        st = [t[:, slots].contiguous() for t in state]
        dev_len = torch.tensor([lengths[b] for b in slots], dtype=torch.int32, device=cuda)
        toks = kern(packed, *st, dev_len, x[slots].contiguous(), cfg=cfg, **kw)[0]
        torch.cuda.synchronize()
        return {b: (int(toks[i]), [t[:, i, lengths[b]].clone() for t in st])
                for i, b in enumerate(slots)}

    want = run(list(range(32)))
    runs = [list(range(B)) for B in (16, 9, 8)] + [[b] for b in (0, 3, 8, 17, 31)]
    runs.append(list(reversed(range(32))))
    for slots in runs:
        for b, (tok, rows) in run(slots).items():
            assert tok == want[b][0], (slots, b)
            assert all(torch.equal(r, w) for r, w in zip(rows, want[b][1])), (slots, b)


@pytest.mark.parametrize("B", [8, 32])
@pytest.mark.parametrize("mode", ["fp", "int8"])
@pytest.mark.parametrize("family", ["qwen2.5-7b-L1", "llama-3-8b-L1"])
def test_llama_megabatch_wide_geometry(cuda, family, mode, B):
    """#15 / #17 in bf16 at the widths of the registry's largest Llama/Qwen
    geometries, one layer: Qwen2.5-7B (LM head 152064 x 3584, 1188 tiles of
    two K parts, the largest count of tile counters) and Llama-3-8B, with
    test_megabatch_matches_plain's checks and tolerances."""
    _check_megabatch(cuda, family, mode, torch.bfloat16, B)
    torch.cuda.empty_cache()


@pytest.mark.parametrize("B", [1, 9, 32])
@pytest.mark.parametrize("tier", ["fp", "int8", "int4"])
@pytest.mark.parametrize("N,K", [(3072, 2048), (2048, 8192), (152064, 3584), (130, 96)])
def test_stream_gemv_matches_plain(cuda, N, K, tier, B):
    """One GEMV of the bf16 batched Llama chain alone (`stream_gemv`,
    csrc/gemv_stream_tc.cuh) against its plain version: every output within
    one bf16 rounding (2^-7 of its value, or 1e-4 of the largest output),
    at Llama-3.2-1B's qkv and down, Qwen2.5-7B's LM head and an edge shape
    (int4 at G = 32);
    one launch counted."""
    g = torch.Generator(device=cuda).manual_seed(N + K + B)
    x = torch.randn((B, K), generator=g, device=cuda).bfloat16()
    if tier == "fp":
        w, s = (torch.randn((N, K), generator=g, device=cuda) / K ** 0.5).bfloat16(), None
    elif tier == "int8":
        w = torch.randint(-127, 128, (N, K), generator=g, device=cuda,
                          dtype=torch.int32).to(torch.int8)
        s = torch.rand((N,), generator=g, device=cuda) / (64 * K ** 0.5)
    else:
        w = torch.randint(0, 256, (N, K // 2), generator=g, device=cuda,
                          dtype=torch.int32).to(torch.uint8)
        s = (torch.rand((N, K // 32), generator=g, device=cuda) / (4 * K ** 0.5)).bfloat16()
    before = tmb.stream_gemv.launches
    got = tmb.stream_gemv(x, w, s).float()
    assert tmb.stream_gemv.launches == before + 1
    want = tmb.stream_gemv_plain(x, w, s).float()
    tol = torch.maximum(want.abs() * 2 ** -7, want.abs().max() * 1e-4)
    assert bool(((got - want).abs() <= tol).all())


def test_llama_megabatch_one_launch_a_gemv(cuda):
    """In bf16 the Llama chain launches 5 L + 3 kernels a step (embed; per
    layer qkv, attention, o, gate|up, down; LM head, argmax) at every B:
    no GEMV is launched once per group of 8 slots."""
    packed, cfg, state, x = _batch_case("llama", "fp", torch.bfloat16, 32, cuda)
    counts = {}
    for B in (1, 8, 9, 16, 32):
        st = [t[:, :B].contiguous() for t in state]
        dev_len = torch.tensor(BATCH_LENGTHS * 4, dtype=torch.int32, device=cuda)[:B]
        before = tmb.chain_kernels()
        tmb.llama_megabatch(packed, *st, dev_len, x[:B].contiguous(), cfg=cfg)
        counts[B] = tmb.chain_kernels() - before
    assert set(counts.values()) == {5 * cfg.n_layer + 3}, counts


# ------------------------------------- GPT-2's batched persistent step (#14 / #16)

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wq", ["int8", "int4", "int4w8"])
@pytest.mark.parametrize("mode", ["fp", "int8", "int4", "mixed"])
@pytest.mark.parametrize("family", ["gpt2", "gpt2-full"])
def test_gpt2_megabatch_every_kind(cuda, family, mode, wq, dtype):
    """#14 / #16 over every pane kind x weight tier x dtype at head_dim 128
    ("gpt2", E = 256) and 64 (GPT-2 small), B = 9 (two n8 slot tiles), with
    test_megabatch_matches_plain's checks and tolerances (the fp weights'
    cases are test_megabatch_matches_plain's)."""
    _check_megabatch(cuda, family, mode, dtype, 9, wq)


def _gpt2_batch_packed(family, wq, dtype, device):
    """(cfg, packed) of the card tests' GPT-2 (`family` as _batch_case's),
    full-precision in `dtype` or its weight tier `wq`."""
    if wq is not None:
        _, cfg, packed = _tier_packed("gpt2-full" if family == "gpt2-full"
                                      else "gpt2-small-test", wq, dtype, device)
        return cfg, packed
    cfg = tgpt2.GPT2Config(**MEGA_CFGS["gpt2" if family == "gpt2-full" else "small-test"])
    params = tgpt2.init_gpt2_params(torch.Generator().manual_seed(1), cfg, dtype, device)
    return cfg, tmk.pack_gpt2_mega(params, cfg)


def _gpt2_batch_state(cfg, mode, dtype, B, C, seed, device):
    """[L, B, C, W] panes (codes and scales for quantized ones) and x [B, E]."""
    g = torch.Generator(device=device).manual_seed(seed)
    L, E = cfg.n_layer, cfg.n_embd
    x = (torch.randn((B, E), generator=g, device=device) * 0.5).to(dtype)
    if mode == "fp":
        return [(torch.randn((L, B, C, E), generator=g, device=device) * 0.5).to(dtype)
                for _ in range(2)], x
    panes = [torch.randint(-127 if kind == "int8" else -128, 128,
                           (L, B, C, E if kind == "int8" else E // 2), generator=g,
                           device=device, dtype=torch.int32).to(torch.int8)
             for kind in tmq._kv_kinds(mode)]
    return panes + [torch.rand((L, B, C), generator=g, device=device) * 0.02 + 1e-3
                    for _ in range(2)], x


def _gpt2_batch_launch(packed, cfg, state, x, mode, lengths, grid=None):
    """One launch of the batched step on copies of `state` ([L, B, C, W]);
    returns (tokens [B], panes, the launcher's grid)."""
    panes = [t.clone() for t in state]
    kinds = ("fp", "fp") if mode == "fp" else tmq._kv_kinds(mode)
    tok = torch.zeros(len(lengths), dtype=torch.int32, device=x.device)
    dev_len = torch.tensor(lengths, dtype=torch.int32, device=x.device)
    step = tmb.GPT2BatchLauncher(packed, cfg, panes[0], panes[1], dev_len, tok,
                                 x_emb=x.contiguous(),
                                 ks=panes[2] if mode != "fp" else None,
                                 vs=panes[3] if mode != "fp" else None,
                                 k_kind=kinds[0], v_kind=kinds[1], grid=grid)
    kernels = tmb.step_kernels()
    step.launch()
    torch.cuda.synchronize()
    assert tmb.step_kernels() == kernels + 1  # one kernel a step
    return tok, panes, step.args.grid


@pytest.mark.parametrize("mode", ["fp", "int8"])
@pytest.mark.parametrize("B", [25, 32])
def test_gpt2_large_fp32_past_24_slots(cuda, B, mode):
    """GPT-2 large's width (2 layers) in fp32 at 25 and 32 slots, which the
    batched step takes since its fp32 ring tile is 4 rows (the gates accept
    it: tests/test_torch_gpt2_batch_plan.py): every slot's token is the plain
    step's (or within a top-2 gap under 1e-4), its new rows within 1e-5."""
    _check_megabatch(cuda, "gpt2-large-L2", mode, torch.float32, B)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wq", [None, "int8", "int4"])
@pytest.mark.parametrize("mode", ["fp", "int8", "int4", "mixed"])
def test_gpt2_megabatch_slot_bits(cuda, mode, wq, dtype):
    """Slot b's token and new K/V row bytes (codes and scales for quantized
    panes) are bit for bit the same run among 32 slots, 16, 9, 8, alone
    (B = 1) and with its neighbours reversed, and at the full grid, 37 and 5
    blocks: a (row, slot)'s sums and the attention's splits depend on
    neither B, the slots beside it nor the grid. GPT-2 small, C = 128."""
    cfg, packed = _gpt2_batch_packed("gpt2-full", wq, dtype, cuda)
    B, C = 32, 128
    state, x = _gpt2_batch_state(cfg, mode, dtype, B, C, 11, cuda)
    lengths = [BATCH_LENGTHS[b % len(BATCH_LENGTHS)] for b in range(B)]

    def run(slots, grid=None):
        st = [t[:, slots].contiguous() for t in state]
        toks, panes, used = _gpt2_batch_launch(packed, cfg, st, x[slots], mode,
                                               [lengths[b] for b in slots], grid)
        assert grid is None or used == grid
        return {b: (int(toks[i]), [t[:, i, lengths[b]] for t in panes])
                for i, b in enumerate(slots)}, used

    want, full = run(list(range(B)))
    assert full > 37
    runs = [(list(range(n)), None) for n in (16, 9, 8)]
    runs += [([b], None) for b in (0, 3, 8, 17, 31)]
    runs += [(list(reversed(range(B))), None), (list(range(B)), 37), (list(range(B)), 5),
             ([2, 5, 30], 5)]
    for slots, grid in runs:
        for b, (tok, rows) in run(slots, grid)[0].items():
            assert tok == want[b][0], (slots, grid, b)
            assert all(torch.equal(r, w) for r, w in zip(rows, want[b][1])), (slots, grid, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["fp", "int8", "int4", "mixed"])
@pytest.mark.parametrize("C", [320, 8192])
@pytest.mark.parametrize("family", ["gpt2", "gpt2-full"])
def test_gpt2_megabatch_lengths(cuda, family, C, mode, dtype):
    """#14 / #16 at mixed per-slot lengths 0, 1, C - 1 and between (every
    attention split of the last full) at C = 320 and the kernels' capacity
    limit 8192, with test_megabatch_matches_plain's checks and tolerances
    per slot; every other column untouched."""
    cfg, packed = _gpt2_batch_packed(family, None, dtype, cuda)
    lengths = [0, 1, C - 1, C // 2 + 3, 33]
    state, x = _gpt2_batch_state(cfg, mode, dtype, len(lengths), C, C + len(mode), cuda)
    got = [t.clone() for t in state]
    want = [t.clone() for t in state]
    kern, plain = ((tmb.gpt2_megabatch, tmb.gpt2_megabatch_plain) if mode == "fp" else
                   (tmbq.gpt2_megabatch_quant, tmbq.gpt2_megabatch_quant_plain))
    kw = {} if mode == "fp" else {"kv_mode": mode}
    kernels = tmb.step_kernels()
    toks = kern(packed, *got, torch.tensor(lengths, dtype=torch.int32, device=cuda), x,
                cfg=cfg, **kw)[0]
    assert tmb.step_kernels() == kernels + 1
    logits = plain(packed, *want, lengths, x, cfg=cfg, return_logits=True, **kw)[-1]
    torch.cuda.synchronize()
    for b, length in enumerate(lengths):
        top2 = logits[b].topk(2).values
        tok = int(toks[b])
        if dtype == torch.float32:
            assert tok == int(logits[b].argmax()) or float(top2[0] - top2[1]) < 1e-4
        else:
            assert float(logits[b, tok]) >= float(top2[0]) - 2e-2
        others = torch.arange(C, device=cuda) != length
        for g_, w_, s_ in zip(got, want, state):
            assert torch.equal(g_[:, b][:, others], s_[:, b][:, others])
        if mode == "fp":
            for g_, w_ in zip(got, want):
                gn, wn = g_[:, b, length].float(), w_[:, b, length].float()
                rel = 1e-5 if dtype == torch.float32 else 1.6e-2
                assert (gn - wn).abs().max() <= rel * max(1.0, wn.abs().max().item())
            continue
        steps = 1 if dtype == torch.float32 else 2
        for kind, g_, w_, gs, ws in zip(tmq._kv_kinds(mode), got[:2], want[:2], got[2:],
                                        want[2:]):
            gv = tmq.pane_values(g_[:, b, length], kind) * gs[:, b, length, None]
            wv = tmq.pane_values(w_[:, b, length], kind) * ws[:, b, length, None]
            step = max(gs[:, b, length].max().item(), ws[:, b, length].max().item())
            assert (gv - wv).abs().max() <= steps * step * 1.01
    torch.cuda.empty_cache()


@pytest.mark.parametrize("wq", [None, "int4"])
@pytest.mark.parametrize("mode", ["fp", "int8"])
def test_gpt2_megabatch_graph_replays_bit_identical(cuda, mode, wq):
    """A captured graph of 32 advancing steps of 16 slots (MegaDecodeGraph
    over GPT2BatchLauncher: 32 cooperative launches), replayed for one
    generation and again for a second on the same launcher, gives identical
    bits (tokens, panes, scales), equal to the same 32 steps launched
    eagerly. bf16 GPT-2 small, C = 128, slots at mixed lengths."""
    cfg, packed = _gpt2_batch_packed("gpt2-full", wq, torch.bfloat16, cuda)
    B, C, n = 16, 128, 32
    lengths = torch.tensor([BATCH_LENGTHS[b % 8] % (C - n) for b in range(B)],
                           dtype=torch.int32, device=cuda)
    state, _ = _gpt2_batch_state(cfg, mode, torch.bfloat16, B, C, 5, cuda)
    names = ["k", "v", "ks", "vs"][:len(state)]
    kinds = ("fp", "fp") if mode == "fp" else tmq._kv_kinds(mode)
    kw = dict(k_kind=kinds[0], v_kind=kinds[1], quant_eps=1e-8)
    counter = tmb.gpt2_megabatch if mode == "fp" else tmbq.gpt2_megabatch_quant
    tok0 = torch.arange(17, 17 + B, dtype=torch.int32, device=cuda)
    graph = tmk.MegaDecodeGraph(packed, cfg, n, {nm: torch.empty_like(t) for nm, t in
                                                 zip(names, state)}, counter,
                                launcher=tmb.GPT2BatchLauncher, **kw)
    assert graph.per_replay == n
    runs = []
    for _ in range(2):
        for nm, t in zip(names, state):
            graph.panes[nm].copy_(t)
        kernels = tmb.step_kernels()
        toks = graph.run(tok0, lengths).clone()
        torch.cuda.synchronize()
        assert tmb.step_kernels() == kernels  # a replay issues no host launch
        runs.append([toks] + [graph.panes[nm].clone() for nm in names])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    eager = [t.clone() for t in state]
    toks = torch.zeros(n + 1, B, dtype=torch.int32, device=cuda)
    toks[0] = tok0
    dev_len = lengths.clone()
    panes = dict(zip(names, eager))
    step = tmb.GPT2BatchLauncher(packed, cfg, panes["k"], panes["v"], dev_len, toks[1],
                                 tok_in=toks[0], ks=panes.get("ks"), vs=panes.get("vs"),
                                 advance=True, **kw)
    for i in range(n):
        step.set_tokens(toks[i], toks[i + 1])
        step.launch()
    torch.cuda.synchronize()
    assert torch.equal(dev_len, lengths + n)
    assert torch.equal(toks[:n], runs[0][0])
    for a, b in zip(eager, runs[0][1:]):
        assert torch.equal(a, b)


def test_gpt2_megabatch_one_kernel_a_step(cuda):
    """GPT-2's batched step launches one kernel a step at every B (1, 8, 9,
    16, 32), fp and quantized panes; the skeleton (the weight stream, the
    barriers and the slots' input staging) launches and leaves the tokens."""
    cfg, packed = _gpt2_batch_packed("gpt2", None, torch.bfloat16, cuda)
    for mode in ("fp", "int8"):
        state, x = _gpt2_batch_state(cfg, mode, torch.bfloat16, 32, 128, 3, cuda)
        for B in (1, 8, 9, 16, 32):
            st = [t[:, :B].contiguous() for t in state]
            _gpt2_batch_launch(packed, cfg, st, x[:B], mode, (BATCH_LENGTHS * 4)[:B])
    state, x = _gpt2_batch_state(cfg, "fp", torch.bfloat16, 8, 128, 4, cuda)
    tok = torch.full((8,), -1, dtype=torch.int32, device=cuda)
    step = tmb.GPT2BatchLauncher(packed, cfg, state[0], state[1],
                                 torch.tensor(BATCH_LENGTHS, dtype=torch.int32, device=cuda),
                                 tok, x_emb=x)
    step.launch("elit_gpt2_megabatch_skeleton")
    torch.cuda.synchronize()
    assert bool((tok == -1).all())
