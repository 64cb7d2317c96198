"""The persistent GPT-2 step's plan (csrc/gpt2_megastep.cu over
csrc/persistent_step.cuh; the launcher's part in ops/megakernel.py, the
rest modelled here) on the CPU: the split attention's plan at GPT-2's 12
heads and at head_dim 128, every weight row of every phase streamed once
whatever the grid, the ring and its shared memory within a block's limit,
the scratch sizes, the C constants and the args struct, and the split-KV
arithmetic at GPT-2's plan against the one-pass attention."""

import math
import pathlib
import re

import pytest
import torch

from efficient_llm_inference_tpu_torch.models import gpt2 as tgpt2
from efficient_llm_inference_tpu_torch.ops import megakernel as tmk
from efficient_llm_inference_tpu_torch.ops import megakernel_llama as tml

CSRC = pathlib.Path(tmk.__file__).resolve().parent.parent / "csrc"
SMEM_LIMIT = 232448  # shared memory a block may use on the H100 (227 KB)
STATIC_SMEM = 8 * 1024  # at least the kernel's static shared memory (~5 KB at D = 128)

CFGS = {
    "gpt2": tgpt2.GPT2Config.small(),
    "small-test": tgpt2.GPT2Config(vocab_size=300, n_positions=256, n_embd=256, n_layer=2,
                                   n_head=2),  # head_dim 128
    "gpt2-medium": tgpt2.GPT2Config.medium(),
    "gpt2-large": tgpt2.GPT2Config.large(),
}


# ---------------------------------------------------------------------------
# A model of the C plan (csrc/gpt2_megastep.cu: Tile, ring_plan, h_bytes,
# max_items, block_rows, the Stream's order), held against the C constants
# by test_c_constants_mirror_the_plan.

MAX_SLOTS = 64  # kMaxSlots
RING_BYTES = 176 * 1024  # kRingBytes
SCALE_SLOTS = 16 * tmk.STEP_THREADS  # kScaleSlots = kHeadPer * kThreads


def _size(dtype):
    return torch.tensor([], dtype=dtype).element_size()


def item_bytes(n_embd, dtype, wkind):
    """Bytes of one item (E inputs of a weight row) in a weight tier."""
    if wkind == "fp":
        return n_embd * _size(dtype)
    return n_embd if wkind == "int8" else n_embd // 2


def tile_items(dtype):
    """Items a tile: 8 warps, each two in bf16 and one in fp32."""
    return tmk.STEP_THREADS // 32 * (4 // _size(dtype))


def ring_plan(n_embd, dtype, wkind):
    """(slots, tile bytes) of a block's weight ring."""
    tile = tile_items(dtype) * item_bytes(n_embd, dtype, wkind)
    return min(MAX_SLOTS, RING_BYTES // tile), tile


def phase_rows(cfg):
    """(rows, items a row) of the GEMV phases in stream order: qkv, proj,
    fc, fc_proj (4 items a row of 4E inputs), the LM head."""
    E = cfg.n_embd
    return ((3 * E, 1), (E, 1), (4 * E, 1), (E, 4), (cfg.vocab_size, 1))


def step_smem_bytes(cfg, capacity, dtype, wkind, grid):
    """Dynamic shared memory of a block at `grid` blocks: the ring; fc_proj's
    4E inputs in the tier's layout, one attention item or the writer's k
    and v, whichever is largest; the items' sums of the largest layer
    phase; for a quantized tier, SCALE_SLOTS fp32 scales."""
    E, D = cfg.n_embd, cfg.head_dim
    slots, tile = ring_plan(E, dtype, wkind)
    size = _size(dtype)
    vn = 16 // size if wkind == "fp" else (16 if wkind == "int8" else 32)
    stride = vn if wkind == "fp" else vn + 16 // size
    _, rows = tmk.attention_plan(capacity, cfg.n_head)
    need = max(4 * E // vn * stride * size, (3 * D + 1 + rows) * 4, 2 * E * 4)
    items = max(-(-n // grid) * k for n, k in phase_rows(cfg)[:4])
    s4 = SCALE_SLOTS * 4 if wkind != "fp" else 0
    return slots * tile + -(-need // 16) * 16 + -(-items // 4) * 16 + s4


def block_rows(n_rows, grid, block):
    """The rows of an n_rows-row phase that `block` of `grid` takes."""
    return range(block * n_rows // grid, (block + 1) * n_rows // grid)


def block_stream(cfg, grid, block, per_tile):
    """A block's weight stream in order: (layer, phase, first item, items)
    a tile of `per_tile` items; the LM head's layer is n_layer."""
    tiles = []
    for layer in range(cfg.n_layer + 1):
        for kind, (n, k) in enumerate(phase_rows(cfg)):
            if (kind == 4) != (layer == cfg.n_layer):
                continue
            rows = block_rows(n, grid, block)
            items = len(rows) * k
            for first in range(0, items, per_tile):
                tiles.append((layer, kind, rows.start * k + first,
                              min(per_tile, items - first)))
    return tiles


@pytest.mark.parametrize("capacity,n_head,plan", [
    (320, 12, (10, 32)), (344, 12, (9, 40)), (128, 12, (4, 32)), (8192, 12, (11, 768)),
    (128, 2, (4, 32)), (320, 2, (10, 32)), (8192, 2, (64, 128)), (1024, 16, (8, 128)),
])
def test_attention_plan_table(capacity, n_head, plan):
    assert tmk.attention_plan(capacity, n_head) == plan


@pytest.mark.parametrize("n_head", [2, 12, 16, 20])
def test_attention_plan_covers_the_capacity(n_head):
    """Splits of whole multiples of 8 rows (at least ATTN_MIN_ROWS) that
    cover the capacity with no empty split, about ATTN_ITEMS items a layer
    or fewer."""
    for C in list(range(8, 1025, 8)) + [2048, 4096, 8000, 8192]:
        splits, rows = tmk.attention_plan(C, n_head)
        assert rows % 8 == 0 and rows >= tmk.ATTN_MIN_ROWS
        assert splits * rows >= C > (splits - 1) * rows
        assert n_head * splits <= tmk.ATTN_ITEMS + n_head


@pytest.mark.parametrize("per_tile", [8, 16, 32, 64])
@pytest.mark.parametrize("grid", [3, 5, 37, 132, 264])
@pytest.mark.parametrize("cfg_name", ["gpt2", "small-test"])
def test_every_row_streamed_once(cfg_name, grid, per_tile):
    """The blocks' streams together hold every item of every phase exactly
    once (fc_proj's rows as four items each), each tile at most `per_tile`
    items of one phase, a block's tiles in layer and phase order, and the
    blocks' rows of a phase within one of each other."""
    cfg = CFGS[cfg_name]
    kinds = phase_rows(cfg)
    seen = {}
    for block in range(grid):
        order = []
        for layer, kind, first, n in block_stream(cfg, grid, block, per_tile):
            assert 1 <= n <= per_tile
            order.append((layer, kind))
            for item in range(first, first + n):
                key = (layer, kind, item)
                assert key not in seen
                seen[key] = block
        assert order == sorted(order)
    for layer in range(cfg.n_layer + 1):
        for kind, (rows, k) in enumerate(kinds):
            if (kind == 4) != (layer == cfg.n_layer):
                continue
            assert all((layer, kind, i) in seen for i in range(rows * k))
            sizes = [len(block_rows(rows, grid, b)) for b in range(grid)]
            assert max(sizes) - min(sizes) <= 1 and sum(sizes) == rows
    assert len(seen) == sum(n * k for n, k in kinds[:4]) * cfg.n_layer + kinds[4][0]


@pytest.mark.parametrize("wkind", ["fp", "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cfg_name", list(CFGS))
def test_ring_fits_a_block(cfg_name, dtype, wkind):
    """At least two ring slots, the ring within STEP_RING_BYTES, and the
    ring with the GEMV inputs / attention scratch within a block's shared
    memory at every capacity the kernels take."""
    cfg = CFGS[cfg_name]
    slots, tile = ring_plan(cfg.n_embd, dtype, wkind)
    assert 2 <= slots <= MAX_SLOTS and slots * tile <= RING_BYTES
    assert tile % 16 == 0
    assert tile == tile_items(dtype) * item_bytes(cfg.n_embd, dtype, wkind)
    for C in (8, 128, 320, 8192):
        for grid in (tmk.min_grid(cfg.n_embd), 37, 132, 264):
            smem = step_smem_bytes(cfg, C, dtype, wkind, grid)
            assert smem % 16 == 0 and smem + STATIC_SMEM <= SMEM_LIMIT


def test_ring_table():
    """GPT-2 small's rings (slots, tile bytes) and shared memory at C = 320
    and 132 blocks (the fc phase's 24 items a block the largest)."""
    cfg = CFGS["gpt2"]
    want = {(torch.bfloat16, "fp"): (7, 24576, 172032 + 6144 + 96),
            (torch.bfloat16, "int8"): (14, 12288, 172032 + 9216 + 96 + 16384),
            (torch.bfloat16, "int4"): (29, 6144, 178176 + 7680 + 96 + 16384),
            (torch.float32, "fp"): (7, 24576, 172032 + 12288 + 96)}
    for (dtype, wkind), (slots, tile, smem) in want.items():
        assert ring_plan(768, dtype, wkind) == (slots, tile)
        assert step_smem_bytes(cfg, 320, dtype, wkind, 132) == smem
    assert tmk.min_grid(768) == 3 and tmk.min_grid(2048) == 8


def test_step_scratch():
    cfg = CFGS["gpt2"]
    assert tmk.step_scratch(cfg, 320) == {"splits": 10, "rows": 32,
                                          "part": 12 * 10 * 66, "sync": 14}
    small = CFGS["small-test"]
    assert tmk.step_scratch(small, 8192) == {"splits": 64, "rows": 128,
                                             "part": 2 * 64 * 130, "sync": 4}
    ws = tmk.Workspace(torch.float32, "cpu", x=768, qkv=2304, attn=768, ffn=3072,
                       part=7920, count=14)
    assert ws.attn_count.dtype == torch.int32 and int(ws.attn_count.abs().sum()) == 0
    assert ws.lm_val.numel() == tmk.LM_PARTS >= 132 * 2


def _c_int(name: str, text: str) -> str:
    m = re.search(rf"constexpr int {name} = ([^;]+);", text)
    assert m, name
    return m.group(1).strip()


def _step_source() -> str:
    """The single-stream step's source and the persistent-step header it
    shares with the batched step (the structs, Tile, the ring's constants)."""
    return (CSRC / "gpt2_megastep.cu").read_text() + (CSRC / "persistent_step.cuh").read_text()


def test_c_constants_mirror_the_plan():
    src = _step_source()
    common = (CSRC / "megastep_common.cuh").read_text()
    assert re.search(r"per_warp = (.*?);", src).group(1) == "4 / (int)sizeof(T)"
    assert (tile_items(torch.bfloat16), tile_items(torch.float32)) == (16, 8)
    assert _c_int("kThreads", common) == str(tmk.STEP_THREADS)
    assert _c_int("kMaxSlots", src) == str(MAX_SLOTS)
    assert eval(_c_int("kRingBytes", src)) == RING_BYTES  # "176 * 1024"
    assert _c_int("kMaxPer", src) == "8"  # E <= 8 x 256, as args_ok checks
    assert _c_int("kRowsPer", src) == str(tmk.STEP_ROWS_PER)
    assert _c_int("kScaleSlots", src) == "kHeadPer * kThreads"
    assert int(_c_int("kHeadPer", src)) * tmk.STEP_THREADS == SCALE_SLOTS


def test_step_args_mirror_the_c_struct():
    """Gpt2StepArgs is MegaStepArgs (struct MegaArgs) followed by the C
    struct Gpt2StepArgs's own fields, in order."""
    src = _step_source()

    def fields(struct):
        body = re.search(rf"struct {struct} {{(.*?)\n}};", src, re.S).group(1)
        names = []
        for line in body.splitlines():
            line = line.split("//")[0].strip()
            if line:
                names += [n.strip().lstrip("*") for n in line.rstrip(";").split(" ", 1)[1]
                          .split(",")]
        return [n.split()[-1].lstrip("*") for n in names]

    mega = fields("MegaArgs")
    assert [n for n, _ in tmk.MegaStepArgs._fields_] == mega
    step = fields("Gpt2StepArgs")
    assert step[0] == "a"
    own = [n for n, _ in tmk.Gpt2StepArgs._fields_]
    assert own == step[1:]
    assert tmk.StepLauncher.args_type is tmk.Gpt2StepArgs


@pytest.mark.parametrize("length", [0, 1, 31, 32, 33, 200, 319])
@pytest.mark.parametrize("head_dim,n_head", [(64, 12), (128, 2)])
def test_split_attention_at_the_step_plan(head_dim, n_head, length):
    """The split-KV arithmetic (ops/megakernel_llama.py
    `split_attention_plain`, group 1) at the persistent step's plan for
    C = 320 against the one-pass attention of the plain step, fp32: the
    same softmax in another order of rounding."""
    C = 320
    splits, rows = tmk.attention_plan(C, n_head)
    g = torch.Generator().manual_seed(length + head_dim)
    W = n_head * head_dim
    q, kc, vc = (torch.randn(3, W, generator=g) * 0.8)
    k_l, v_l = torch.randn(2, C, W, generator=g) * 0.8
    got = tml.split_attention_plain(q, kc, vc, k_l, v_l, length, n_head, splits, rows)
    want = tmk.attend_plain(q, kc, vc, k_l, v_l, length, n_head)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert math.isfinite(float(got.abs().max()))
