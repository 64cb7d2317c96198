"""The single-sequence verify kernels' host plans, on the CPU (no card):
the Llama/Qwen verify chain's split attention (csrc/megaverify.cu, the
verify item of csrc/split_attention.cuh) and GPT-2's persistent verify
(csrc/gpt2_megaverify.cu), modelled from their C constants.

* Every registry geometry fits at every R = 2-8 and every capacity the
  kernels take: the attention's shared memory (the verify item's floats and
  its static PV sums) within a block, GPT-2's ring of at least two slots
  beside the R staged rows, the sums and the scales within its dynamic
  budget; the scratch the launchers allocate covers the items.
* The plans depend on the capacity (and the heads and SM count), never on
  R, so a row's bits do not depend on R.
* The verify attention's arithmetic (per row, the split-KV partials over
  the pane rows c < cur + t and the row's own k / v in the combine) in
  plain PyTorch equals one softmax over the in-block causal set.
"""

import math
import pathlib
import re

import pytest
import torch

import torch_port_helpers  # noqa: F401 (torch on one thread)
from efficient_llm_inference_tpu_torch.models import gpt2 as tgpt2
from efficient_llm_inference_tpu_torch.models.llama import LlamaConfig
from efficient_llm_inference_tpu_torch.ops import _gemv_stream_tc as stc
from efficient_llm_inference_tpu_torch.ops import megakernel as tmk
from efficient_llm_inference_tpu_torch.ops import megakernel_llama as tml

CSRC = pathlib.Path(tmk.__file__).resolve().parent.parent / "csrc"
SMEM_LIMIT = 232448  # a block's shared memory on the H100 (227 KB)
THREADS, WARPS, N_SM = 256, 8, 132
CAPACITIES = (8, 128, 320, 1024, 4096, 8192)
ROWS = range(2, 9)

LLAMAS = {n: LlamaConfig.by_name(n) for n in (
    "llama-3-8b", "llama-3-1b", "llama-3-3b", "qwen2.5-7b", "qwen2.5-1.5b", "qwen2.5-0.5b")}
GPT2S = {"gpt2": tgpt2.GPT2Config.small(), "gpt2-medium": tgpt2.GPT2Config.medium(),
         "gpt2-large": tgpt2.GPT2Config.large(),
         "small-test": tgpt2.GPT2Config(vocab_size=300, n_positions=256, n_embd=256, n_layer=2,
                                        n_head=2)}


def _c_const(name: str, text: str):
    m = re.search(rf"constexpr int {name} = ([^;]+);", text)
    assert m, name
    return eval(m.group(1).replace("kThreads", str(THREADS)))


def verify_item_floats(group, R, D, rows):
    """split_attention.cuh verify_item_floats (GPT-2's verify item): the
    group's q of every row, each row's own k and v, their scores, the
    split's scores."""
    return group * R * D + 2 * R * D + group * R + group * R * rows


def item_static_bytes(D, heads):
    """GPT-2's verify item's static shared memory: the warps' PV sums of a
    pass and a flag."""
    return WARPS * heads * D * 4 + 4


def verify_staged_floats(group, R, D, rows):
    """split_attention.cuh verify_staged_floats (the Llama/Qwen verify's
    staged item): q of the group's padded virtual heads, each row's own k and
    v, a chunk's V and padded K rows, the own-row scores, the split's
    scores."""
    chunk = _c_const("kVerifyChunk", (CSRC / "split_attention.cuh").read_text())
    padded = -(-group * R // 4) * 4
    return (padded * D + 2 * R * D + chunk * D + chunk * (D + 1) + padded
            + group * R * rows)


STAGED_STATIC_BYTES = 4  # the staged item's static shared memory: the combiner's flag


# ---------------------------------------------------------------- Llama / Qwen

@pytest.mark.parametrize("name", list(LLAMAS))
def test_llama_verify_plan_fits(name):
    cfg = LLAMAS[name]
    G, D = cfg.n_head // cfg.n_kv_head, cfg.head_dim
    for C in CAPACITIES:
        plans = {R: tml.verify_scratch(cfg, C, R, N_SM) for R in ROWS}
        for R, p in plans.items():
            assert (p["splits"], p["rows"]) == (plans[8]["splits"], plans[8]["rows"])
            assert p["splits"] * p["rows"] >= C and p["rows"] % 8 == 0
            assert (p["splits"] - 1) * p["rows"] < C  # no split past the capacity
            assert p["part"] == R * cfg.n_head * p["splits"] * (D + 2)
            assert p["count"] == cfg.n_kv_head
            smem = 4 * verify_staged_floats(G, R, D, p["rows"])
            assert smem + STAGED_STATIC_BYTES <= SMEM_LIMIT, (C, R)
            assert 4 * cfg.n_kv_head * D <= 48 * 1024  # the writer's rotated k row
        assert plans[8]["rows"] * G * 8 <= tml.ATTN_SCORES or plans[8]["rows"] == 8


@pytest.mark.parametrize("name", list(LLAMAS))
def test_llama_verify_gemv_scratch(name):
    """The bf16 chain's GEMVs at B = R: one launch for the R rows (one n8
    tile of staged rows), their scratch the launcher's."""
    cfg = LLAMAS[name]
    for R in ROWS:
        assert stc.slot_rows(R) == 8
        n_part, n_count = stc.scratch_sizes(cfg, R)
        for _, N, K in stc.chain_gemvs(cfg):
            p = stc.plan(N, K, R)
            assert p["part_floats"] <= n_part and (p["splits"] == 1 or p["tiles"] <= n_count)
            assert p["smem"] <= SMEM_LIMIT


def test_llama_verify_args_mirror_the_c_struct():
    src = (CSRC / "megaverify.cu").read_text()
    body = re.search(r"struct LlamaVerifyArgs {(.*?)\n};", src, re.S).group(1)
    names = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if decl:
            names += [re.findall(r"(\w+)\s*$", part)[0] for part in decl.split(",")]
    assert names == [f[0] for f in tml.LlamaVerifyArgs._fields_]


# ---------------------------------------------------------------------- GPT-2

def gpt2_verify_smem(cfg, C, dtype, wkind, R, grid):
    """csrc/gpt2_megaverify.cu smem_plan: (ring slots, total dynamic bytes)."""
    src = (CSRC / "gpt2_megaverify.cu").read_text()
    shared = (CSRC / "persistent_step.cuh").read_text()
    dyn, scale_slots = _c_const("kDynSmem", src), _c_const("kScaleSlots", src)
    ring_max, max_slots = _c_const("kRingBytes", shared), _c_const("kMaxSlots", shared)
    size = 4 if dtype == torch.float32 else 2
    E, V, D = cfg.n_embd, cfg.vocab_size, cfg.head_dim
    vn = {"fp": 16 // size, "int8": 16, "int4": 32}[wkind]
    st = vn if size == 4 or wkind == "fp" else vn + 16 // size
    tile_items = 4 if size == 4 else 16
    tile = tile_items * {"fp": E * size, "int8": E, "int4": E // 2}[wkind]
    rs = 4 * E // vn * st
    _, rows = tmk.attention_plan(C, cfg.n_head)
    h = max(R * rs * size, 4 * verify_item_floats(1, R, D, rows))
    h16 = -(-h // 16) * 16
    items = max(-(-n // grid) * ks for n, ks in ((3 * E, 1), (E, 1), (4 * E, 1), (E, 4)))
    ys = -(-items * R * 4 // 16) * 16
    s4 = 4 * scale_slots if wkind != "fp" else 0
    ring = min(ring_max, dyn - (h16 + ys + s4))
    slots = min(max_slots, ring // tile) if ring > 0 else 0
    return slots, slots * tile + h16 + ys + s4


@pytest.mark.parametrize("wkind", ["fp", "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(GPT2S))
def test_gpt2_verify_plan_fits(name, dtype, wkind):
    """Two ring slots at least, the dynamic shared memory within kDynSmem and,
    with the static (the verify item's PV sums, the mbarriers, the rows'
    statistics and maxima), within a block, at every R and capacity, at the
    full grid of the card and a grid of 32 blocks."""
    cfg = GPT2S[name]
    src = (CSRC / "gpt2_megaverify.cu").read_text()
    heads = _c_const("kAttnHeads", src)
    static = item_static_bytes(cfg.head_dim, heads) + 64 * 8 + 5 * 32 + 3 * 8 * 8 * 4 + 64
    for grid in (N_SM, 32):
        for C in CAPACITIES:
            for R in ROWS:
                slots, total = gpt2_verify_smem(cfg, C, dtype, wkind, R, grid)
                assert slots >= 2, (grid, C, R)
                assert total <= _c_const("kDynSmem", src) and total + static <= SMEM_LIMIT


@pytest.mark.parametrize("name", list(GPT2S))
def test_gpt2_verify_scratch(name):
    """The single stream's attention plan (a function of (C, H)), R rows'
    partials, the barrier, the ticket and a count a head; the items (head,
    split) over the grid's blocks each once."""
    cfg = GPT2S[name]
    for C in CAPACITIES:
        splits, rows = tmk.attention_plan(C, cfg.n_head)
        for R in ROWS:
            assert tmk.verify_scratch(cfg, C, R) == {
                "splits": splits, "rows": rows,
                "part": R * cfg.n_head * splits * (cfg.head_dim + 2), "sync": 2 + cfg.n_head}
        n = cfg.n_head * splits
        for grid in (1, 5, N_SM):
            taken = sorted(i for b in range(grid) for i in range(b, n, grid))
            assert taken == list(range(n))


def test_gpt2_verify_args_mirror_the_c_struct():
    """GPT2VerifyArgs is Gpt2StepArgs followed by R, as `struct
    Gpt2VerifyArgs { Gpt2StepArgs s; int rows; }`; its launcher is the
    persistent one (grid entry, R set last)."""
    import ctypes
    src = (CSRC / "gpt2_megaverify.cu").read_text()
    body = re.search(r"struct Gpt2VerifyArgs {(.*?)\n};", src, re.S).group(1)
    members = [line.split("//")[0].strip().rstrip(";").split()
               for line in body.splitlines() if line.split("//")[0].strip()]
    assert members == [["Gpt2StepArgs", "s"], ["int", "rows"]]
    assert tmk.GPT2VerifyArgs.rows.offset == ctypes.sizeof(tmk.Gpt2StepArgs)
    assert issubclass(tmk.GPT2VerifyArgs, tmk.Gpt2StepArgs)
    L = tmk.GPT2VerifyLauncher
    assert (L.grid_entry, L.lead_field, L.entry[False]) == (
        "elit_gpt2_megaverify_grid", "rows", "elit_gpt2_megaverify")
    assert _c_const("kMaxRows", src) == tmk.MAX_VERIFY_ROWS


# ------------------------------------------------------ the verify attention

@pytest.mark.parametrize("cur", [0, 5, 37, 60])
@pytest.mark.parametrize("G,D,Hkv", [(1, 64, 3), (4, 64, 2), (7, 128, 1)])
def test_verify_attention_arithmetic(G, D, Hkv, cur):
    """Row t of the verify item: the split partials of the pane rows c <
    min(cur + t, C) (the cache and the verify rows j < t, written before the
    attention reads them) merged with the row's own k / v equal attend_plain
    over the same rows, at the verify plan's splits (fp32, 1e-5)."""
    g = torch.Generator().manual_seed(G * 1000 + cur)
    C, R = 64, 8
    cfg = LlamaConfig(vocab_size=10, hidden_size=G * Hkv * D, intermediate_size=64, n_layer=1,
                      n_head=G * Hkv, n_kv_head=Hkv, n_positions=128)
    splits, rows = tml.verify_scratch(cfg, C, R, N_SM)["splits"], \
        tml.verify_scratch(cfg, C, R, N_SM)["rows"]
    KW = Hkv * D
    k_pane = torch.randn(C, KW, generator=g)
    v_pane = torch.randn(C, KW, generator=g)
    q = torch.randn(R, G * KW, generator=g)
    kr = torch.randn(R, KW, generator=g)
    vr = torch.randn(R, KW, generator=g)
    for t in range(R):  # the writer: rows cur + t < C
        if cur + t < C:
            k_pane[cur + t], v_pane[cur + t] = kr[t], vr[t]
    for t in range(R):
        n = min(cur + t, C)
        got = tml.split_attention_plain(q[t], kr[t], vr[t], k_pane, v_pane, n, Hkv, splits, rows)
        want = tmk.attend_plain(q[t], kr[t], vr[t], k_pane, v_pane, n, Hkv)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert splits * rows >= C and math.isfinite(float(got.sum()))
