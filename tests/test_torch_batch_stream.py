"""The bf16 batched Llama/Qwen step's tensor-core streaming GEMV
(csrc/gemv_stream_tc.cuh) on the CPU: its host plan (ops/_gemv_stream_tc.py)
against a table and its invariants, the C side's constants and the args
struct's ctypes mirror against the sources, the kernel's fragment order and
shared-memory layout as index arithmetic, and a plain model of its split-K
sum against the one-pass product. The kernel itself runs on the card
(tests/test_torch_cuda_batch.py, chip_smoke.py)."""

import ctypes
import pathlib
import re

import pytest
import torch

from efficient_llm_inference_tpu_torch.models.llama import LlamaConfig
from efficient_llm_inference_tpu_torch.ops import _gemv_stream_tc as stc
from efficient_llm_inference_tpu_torch.ops import megakernel_batch as tmb
from efficient_llm_inference_tpu_torch.ops import megakernel_batch_verify as tbv

CSRC = pathlib.Path(stc.__file__).resolve().parent.parent / "csrc"
SMALL = LlamaConfig(vocab_size=300, hidden_size=512, intermediate_size=1024, n_layer=2,
                    n_head=8, n_kv_head=4, n_positions=512)  # the card tests' small Llama
CFGS = {"llama-3-1b": LlamaConfig.by_name("llama-3-1b"),
        "qwen2.5-0.5b": LlamaConfig.by_name("qwen2.5-0.5b"), "small": SMALL,
        "qwen2.5-7b": LlamaConfig.by_name("qwen2.5-7b"),
        "llama-3-8b": LlamaConfig.by_name("llama-3-8b")}
# every Llama/Qwen geometry of the registry (the names' distinct configs)
REGISTRY = ("llama-3-8b", "llama-3-1b", "llama-3-3b", "llama-tiny", "qwen2.5-7b",
            "qwen2.5-1.5b", "qwen2.5-0.5b", "qwen-tiny")
SHAPES = sorted({(N, K) for cfg in CFGS.values() for _, N, K in stc.chain_gemvs(cfg)}
                | {(2048, 2056), (8, 8), (130, 72), (4096, 4104)})
BATCHES = (1, 8, 9, 16, 32)

# (model, GEMV, SMs, B) -> (splits, tiles, part_segs, row_stride, stages,
# blocks an SM, smem, grid, part_floats)
TABLE = {
    ("llama-3-1b", "qkv", 132, 1): (5, 24, 13, 960, 12, 1, 204288, 120, 122880),
    ("llama-3-1b", "qkv", 132, 32): (5, 24, 13, 960, 12, 1, 227328, 120, 491520),
    ("llama-3-1b", "o", 132, 8): (8, 16, 8, 576, 12, 1, 201216, 128, 131072),
    ("llama-3-1b", "o", 78, 9): (8, 16, 8, 576, 12, 1, 205824, 72, 262144),
    ("llama-3-1b", "gate_up", 132, 8): (1, 128, 64, 4160, 11, 1, 213504, 128, 0),
    ("llama-3-1b", "gate_up", 132, 16): (1, 128, 64, 4160, 9, 1, 214016, 128, 0),
    ("llama-3-1b", "gate_up", 78, 32): (1, 128, 64, 4160, 5, 1, 215040, 78, 0),
    ("llama-3-1b", "down", 132, 8): (8, 16, 32, 2112, 12, 1, 213504, 128, 131072),
    ("llama-3-1b", "down", 132, 32): (8, 16, 32, 2112, 9, 1, 215040, 128, 524288),
    ("llama-3-1b", "head", 132, 8): (1, 1002, 64, 4160, 4, 2, 98816, 264, 0),
    ("llama-3-1b", "head", 78, 16): (1, 1002, 64, 4160, 9, 1, 214016, 78, 0),
    ("qwen2.5-0.5b", "qkv", 132, 8): (7, 9, 4, 320, 12, 1, 199168, 63, 64512),
    ("qwen2.5-0.5b", "o", 78, 16): (7, 7, 4, 320, 12, 1, 201728, 49, 100352),
    ("qwen2.5-0.5b", "gate_up", 132, 32): (1, 76, 28, 1856, 10, 1, 223232, 76, 0),
    ("qwen2.5-0.5b", "down", 132, 9): (18, 7, 9, 704, 12, 1, 207872, 126, 258048),
    ("qwen2.5-0.5b", "head", 78, 1): (1, 1187, 28, 1856, 5, 2, 96768, 156, 0),
    ("small", "qkv", 132, 8): (4, 8, 4, 320, 12, 1, 199168, 32, 32768),
    ("small", "down", 78, 16): (8, 4, 4, 320, 12, 1, 201728, 32, 65536),
    ("small", "head", 132, 32): (4, 3, 4, 320, 12, 1, 206848, 12, 49152),
    ("qwen2.5-7b", "qkv", 78, 16): (3, 36, 38, 2496, 11, 1, 220160, 78, 221184),
    ("qwen2.5-7b", "gate_up", 132, 8): (2, 296, 56, 3648, 5, 2, 111104, 264, 606208),
    ("qwen2.5-7b", "down", 132, 32): (10, 28, 60, 3904, 6, 1, 223232, 130, 1146880),
    ("qwen2.5-7b", "head", 132, 8): (2, 1188, 56, 3648, 5, 2, 111104, 264, 2433024),
    ("qwen2.5-7b", "head", 132, 32): (2, 1188, 56, 3648, 6, 1, 215040, 132, 9732096),
    ("llama-3-8b", "o", 132, 32): (4, 32, 32, 2112, 9, 1, 215040, 128, 524288),
    ("llama-3-8b", "down", 78, 16): (7, 32, 64, 4160, 9, 1, 214016, 77, 458752),
    ("llama-3-8b", "head", 132, 8): (2, 1002, 64, 4160, 4, 2, 98816, 264, 2052096),
}
KEYS = ("splits", "tiles", "part_segs", "row_stride", "stages", "blocks_per_sm", "smem",
        "grid", "part_floats")


def _gemv(model, name):
    return next((N, K) for n, N, K in stc.chain_gemvs(CFGS[model]) if n == name)


@pytest.mark.parametrize("case", sorted(TABLE), ids=lambda c: "-".join(map(str, c)))
def test_plan_table(case):
    model, name, n_sm, B = case
    p = stc.plan(*_gemv(model, name), B, n_sm)
    assert tuple(p[k] for k in KEYS) == TABLE[case]


@pytest.mark.parametrize("N,K", SHAPES)
def test_split_depends_on_the_weight_alone(N, K):
    """The split, the parts and the largest part are the same for every B
    and card; only the staged rows, the ring and the grid move with them."""
    plans = [stc.plan(N, K, B, n_sm) for B in BATCHES for n_sm in (78, 132)]
    assert {(p["splits"], p["tiles"], p["part_segs"]) for p in plans} == {
        (stc.split_count(N, K), -(-N // stc.TILE_ROWS),
         max(k1 - k0 for k0, k1 in stc.part_bounds(N, K)) // stc.SEG)}


@pytest.mark.parametrize("N,K", SHAPES)
def test_parts_cover_every_k16_step_once(N, K):
    """The parts cover K's k16 steps in order, each once, each part whole
    segments (two steps) and at most MAX_PART inputs; steps past K are the
    last part's zero-filled tail."""
    bounds = stc.part_bounds(N, K)
    steps = [k // 16 for k0, k1 in bounds for k in range(k0, k1, 16)]
    assert steps == list(range(-(-K // 32) * 2))
    assert all(0 < k1 - k0 <= stc.MAX_PART and k0 % stc.SEG == 0 for k0, k1 in bounds)
    assert len(bounds) <= 32 and bounds[-1][1] - K < stc.SEG


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("N,K", SHAPES)
def test_plan_fits_shared_memory(N, K, B):
    """The ring and the staged rows fit what the kernel opts into: at most
    227 KB a block, two blocks' worth (with the static shared memory and
    the 1 KB the card reserves a block) within an SM's 228 KB; the staged
    rows hold the argmax's per-warp partials; the row stride is 4 mod 8
    16-byte units and holds the largest part."""
    p = stc.plan(N, K, B)
    rows = stc.slot_rows(B)
    assert rows >= B and p["smem"] == rows * p["row_stride"] + p["stages"] * 8 * 2048
    assert 2 <= p["stages"] <= (6 if p["blocks_per_sm"] == 2 else 12)
    static = 32 * 4 + 4 + 1024  # rstd, the last-block flag, headroom
    assert p["blocks_per_sm"] * (p["smem"] + static + 1024) <= 228 * 1024
    assert p["smem"] <= 227 * 1024
    assert (p["row_stride"] // 16) % 8 == 4 and p["row_stride"] >= p["part_segs"] * 64
    assert 8 * rows * 8 <= rows * p["row_stride"]
    assert p["grid"] % p["splits"] == 0 and p["grid"] <= p["tiles"] * p["splits"]


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("model", sorted(CFGS))
def test_scratch_is_the_launchers(model, B):
    """The launcher's scratch (`scratch_sizes`, what LlamaBatchLauncher
    allocates and passes) holds every split GEMV's partials ([tile][part]
    [thread][n8 tiles] float4) and a counter for each of its tiles."""
    cfg = CFGS[model]
    n_part, n_count = stc.scratch_sizes(cfg, B)
    split = []
    for _, N, K in stc.chain_gemvs(cfg):
        p = stc.plan(N, K, B)
        assert p["part_floats"] == (p["tiles"] * p["splits"] * 256 * 4 * (stc.slot_rows(B) // 8)
                                    if p["splits"] > 1 else 0)
        if p["splits"] > 1:
            split.append(p)
    assert n_part == max([1] + [p["part_floats"] for p in split])
    assert n_count == max([1] + [p["tiles"] for p in split])


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("model", REGISTRY)
def test_counters_cover_every_registered_geometry(model, B):
    """Every registered Llama/Qwen geometry's split GEMVs (Qwen2.5-7B's LM
    head: 1188 tiles of 2 parts) find a counter for each tile and room for
    their partials in the launcher's scratch, and the plan fits the shared
    memory; the C side refuses a GEMV whose tiles pass the counters."""
    cfg = LlamaConfig.by_name(model)
    n_part, n_count = stc.scratch_sizes(cfg, B)
    for _, N, K in stc.chain_gemvs(cfg):
        p = stc.plan(N, K, B)
        assert p["splits"] == 1 or (p["tiles"] <= n_count and p["part_floats"] <= n_part)
        assert p["smem"] <= 227 * 1024 and p["stages"] >= 2
    src = (CSRC / "gemv_stream_tc.cuh").read_text()
    assert "p.tiles > sc.count_len" in src and "kCounters" not in src


def test_c_constants_mirror_the_plan():
    """csrc/gemv_stream_tc.cuh's constants are the plan's."""
    src = (CSRC / "gemv_stream_tc.cuh").read_text()

    def const(name):
        m = re.search(rf"\b{name} = ([0-9* ]+)[,;]", src)
        assert m, name
        return eval(m.group(1))  # noqa: S307 - integer products of the source

    assert re.search(r"kTileRows = 16 \* kWarps", src) and stc.TILE_ROWS == 16 * stc.WARPS
    assert const("kSeg") == stc.SEG and const("kStageBytes") == stc.STAGE_BYTES
    assert const("kMaxPart") == stc.MAX_PART
    assert (const("kSplitItems"), const("kMaxSplits"), const("kMinPartSegs")) == (
        stc._SPLIT_ITEMS, stc._MAX_SPLITS, stc._MIN_PART_SEGS)
    assert (const("kBudget2"), const("kBudget1")) == (stc._BUDGET[2], stc._BUDGET[1])
    assert (const("kMaxStages2"), const("kMaxStages1"), const("kMinStages2")) == (
        stc._MAX_STAGES[2], stc._MAX_STAGES[1], stc._MIN_STAGES_2)


_CTYPE = {"int": ctypes.c_int, "float": ctypes.c_float, "long long": ctypes.c_longlong}


def _c_struct(name: str) -> list:
    """[(field, ctypes type)] of `struct name` in csrc/megabatch.cu."""
    src = (CSRC / "megabatch.cu").read_text()
    body = re.search(rf"struct {name} \{{(.*?)\n\}};", src, re.S).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        m = re.match(r"(const )?(void|float|int|long long)\s*(\*?)\s*(.*)", decl)
        base, ptr, names = m.group(2), m.group(3), m.group(4)
        for n in names.split(","):
            n = n.strip()
            star = ptr or n.startswith("*")
            fields.append((n.lstrip("* "), ctypes.c_void_p if star else _CTYPE[base]))
    return fields


def test_batch_args_mirror_the_c_struct():
    """LlamaBatchArgs lists struct LlamaBatchArgs' fields in order and type,
    the bf16 chain's scratch (TC_FIELDS) last."""
    assert [(n, t) for n, t in tmb.LlamaBatchArgs._fields_] == _c_struct("LlamaBatchArgs")
    assert tmb.LlamaBatchArgs._fields_[-4:] == tmb.TC_FIELDS
    assert [f[0] for f in tmb.TC_FIELDS] == ["tc_part", "tc_part_len", "tc_count",
                                             "tc_count_len"]


# ------------------------------------------------- the kernel's index arithmetic


def _step_columns(t: int, j: int) -> list:
    """Inputs of a segment that lane column t feeds to k16 step j as the
    MMA's k = 2t, 2t + 1, 2t + 8, 2t + 9 (gemv_stream_tc.cuh load_a and the
    slot fragments: inputs 8t + 4j .. 8t + 4j + 3)."""
    return [8 * t + 4 * j + i for i in range(4)]


def test_fragment_order_covers_each_segment_once():
    """Each k16 step takes 16 distinct inputs of its segment, the two steps
    all 32: the same permutation of k for both operands, so the product is
    the segment's dot product."""
    seen = []
    for j in range(2):
        cols = [c for t in range(4) for c in _step_columns(t, j)]
        assert len(set(cols)) == 16
        seen += cols
    assert sorted(seen) == list(range(32))


def _stage_at(wk: str, r: int, c: int) -> int:
    sc = {"fp": 4, "int8": 2, "int4": 1}[wk]
    return r * 128 + ((c ^ ((r & (8 // sc - 1)) * sc)) << 4)


@pytest.mark.parametrize("wk", ["fp", "int8", "int4"])
def test_weight_loads_hit_distinct_banks(wk):
    """A warp's weight loads of a segment (rows g and g + 8, lane (g, t)):
    16-byte loads (bf16) in quarter warps, 8-byte (int8) in half warps,
    4-byte (int4) in whole warps, each group of lanes on distinct banks of
    the swizzled stage; and the fetch's 16-byte chunks land once each."""
    width = {"fp": 16, "int8": 8, "int4": 4}[wk]
    lanes_per_phase = 128 // width
    segs = {"fp": 2, "int8": 4, "int4": 8}[wk]
    for q in range(segs):
        for row_off in (0, 8):
            addr = []
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                if wk == "fp":
                    a = _stage_at(wk, g + row_off, 4 * q + t)
                elif wk == "int8":
                    a = _stage_at(wk, g + row_off, 2 * q + (t >> 1)) + (t & 1) * 8
                else:
                    a = _stage_at(wk, g + row_off, q) + 4 * t
                addr.append(a)
            for p0 in range(0, 32, lanes_per_phase):
                banks = [(a // 4 + i) % 32 for a in addr[p0:p0 + lanes_per_phase]
                         for i in range(width // 4)]
                assert len(set(banks)) == len(banks), (wk, q, row_off, p0)
    slots = {_stage_at(wk, r, c) for r in range(16) for c in range(8)}
    assert slots == set(range(0, 2048, 16))


@pytest.mark.parametrize("part_segs", [1, 2, 4, 7, 13, 32, 64, 65])
def test_input_loads_hit_distinct_banks(part_segs):
    """The slot fragments' 16-byte loads (slot g of an n8 tile, inputs
    8t .. 8t + 7 of segment s) of each quarter warp fall in distinct banks
    at the plan's row stride."""
    rs = stc.plan(2048, part_segs * 32, 8)["row_stride"] if part_segs <= 64 else None
    if rs is None:
        rs16 = 4 * part_segs
        rs = 16 * (rs16 + (4 if rs16 % 8 == 0 else 8))
    for s in range(part_segs):
        for n8 in range(4):
            addr = [(8 * n8 + (lane >> 2)) * rs + s * 64 + (lane & 3) * 16 for lane in range(32)]
            for p0 in range(0, 32, 8):
                banks = [(a // 4 + i) % 32 for a in addr[p0:p0 + 8] for i in range(4)]
                assert len(set(banks)) == 32


@pytest.mark.parametrize("N,K", [(2048, 8192), (3072, 2048), (896, 4864), (2048, 2056),
                                 (16384, 2048), (130, 72)])
def test_split_sum_matches_one_pass(N, K):
    """The kernel's split-K sum (fp32 partials of each part added in part
    order) against the one-pass fp32 product, within 2e-6, on bf16 values
    from a seed."""
    g = torch.Generator().manual_seed(N + K)
    x = torch.randn((32, K), generator=g).bfloat16().float()
    w = (torch.randn((N, K), generator=g) / K ** 0.5).bfloat16().float()
    got = stc.split_gemv_plain(x, w)
    assert got.shape == (32, N)
    assert (got - x @ w.t()).abs().max().item() <= 2e-6


@pytest.mark.parametrize("tier", ["fp", "int8", "int4"])
def test_stream_gemv_plain_is_the_tier_arithmetic(tier):
    """`stream_gemv` on CPU tensors (its plain version, which the card test
    holds the kernel against) is the batched verify's plain GEMV of the same
    tier: bf16 of the fp32 sums, int8 a row's sum times its scale, int4 each
    group's sum times its scale."""
    g = torch.Generator().manual_seed(5)
    N, K, B = 40, 256, 9
    x = torch.randn((B, K), generator=g).bfloat16()
    if tier == "fp":
        w, s = (torch.randn((N, K), generator=g) / 16).bfloat16(), None
    elif tier == "int8":
        w = torch.randint(-127, 128, (N, K), generator=g, dtype=torch.int32).to(torch.int8)
        s = torch.rand((N,), generator=g) * 0.01
    else:
        w = torch.randint(0, 256, (N, K // 2), generator=g, dtype=torch.int32).to(torch.uint8)
        s = (torch.rand((N, K // 64), generator=g) * 0.01).bfloat16()
    got = tmb.stream_gemv(x, w, s)
    assert got.dtype == torch.bfloat16 and got.shape == (B, N)
    assert torch.equal(got, tbv.verify_gemv_plain(x, w, s))
