"""GPT-2's batched persistent step's plan (csrc/gpt2_megabatch.cu over
csrc/persistent_step.cuh; the launcher's part in ops/megakernel_batch.py,
the rest modelled here) on the CPU at B in {1, 2, 8, 9, 16, 32}: every
(weight row, slot) of every GEMV phase is computed once, by one thread's
epilogue, at five grids; the MMA fragments cover a tile's (row, slot)s once
and the warps' K slices every input once, a k16 step in one int4 group;
every (slot, head, split) attention item and every slot's writer is taken
once; the ring, the staged slot rows and the sums fit a block's shared
memory at every B and capacity; the scratch sizes, the C constants and the
args struct mirror C."""

import pathlib
import re

import numpy as np
import pytest
import torch

from efficient_llm_inference_tpu_torch.models import gpt2 as tgpt2
from efficient_llm_inference_tpu_torch.ops import megakernel as tmk
from efficient_llm_inference_tpu_torch.ops import megakernel_batch as tmb

CSRC = pathlib.Path(tmk.__file__).resolve().parent.parent / "csrc"
SMEM_LIMIT = 232448  # shared memory a block may use on the H100 (227 KB)
STATIC_SMEM = 8 * 1024  # at least the kernel's static shared memory (~5.5 KB at D = 128)
THREADS, WARPS = tmk.STEP_THREADS, tmb.WARPS
BATCHES = (1, 2, 8, 9, 16, 32)
GRIDS = (1, 5, 37, 132, 264)

CFGS = {
    "gpt2": tgpt2.GPT2Config.small(),
    "small-test": tgpt2.GPT2Config(vocab_size=300, n_positions=256, n_embd=256, n_layer=2,
                                   n_head=2),  # head_dim 128
    "gpt2-medium": tgpt2.GPT2Config.medium(),
    "gpt2-large": tgpt2.GPT2Config.large(),
}

# ---------------------------------------------------------------------------
# A model of the C plan (csrc/gpt2_megabatch.cu: gemv_phase's tiles, holds
# and thread mapping, Product's fragments, the attention loop; its shared
# memory plan is the launcher's gate's, ops/megakernel_batch.py smem_plan),
# held against the C constants by test_c_constants_mirror_the_plan.

MAX_SLOTS, RING_BYTES = tmb.MAX_SLOTS, tmb.RING_BYTES
DYN_SMEM, ROW_PAD, HOLD, MIN_SLOTS = tmb.DYN_SMEM, tmb.ROW_PAD, tmb.HOLD, tmb.MIN_SLOTS
tile_items, red_rows, smem_plan = tmb.batch_tile_items, tmb.red_rows, tmb.smem_plan


def phases(cfg):
    """(rows, items a row) of the GEMV phases in stream order."""
    E = cfg.n_embd
    return ((3 * E, 1), (E, 1), (4 * E, 1), (E, 4), (cfg.vocab_size, 1))


def block_rows(n_rows, grid, block):
    return range(block * n_rows // grid, (block + 1) * n_rows // grid)


def thread_cells(RT, B):
    """(row in the tile, slot) of each thread's epilogue outputs: thread tid
    takes row tid % RT and slots tid // RT + (THREADS // RT) u, u < 2."""
    tid = np.arange(THREADS)
    cells = [(tid % RT, tid // RT + THREADS // RT * u) for u in range(2)]
    r = np.concatenate([c[0] for c in cells])
    s = np.concatenate([c[1] for c in cells])
    keep = s < B
    return r[keep], s[keep]


def phase_counts(n_rows, ks, grid, B, dtype):
    """How many times each (row, slot) of one phase gets an epilogue: block
    b's rows cut into tiles of RT rows (fc_proj's in groups of HOLD tiles,
    which changes no tile's rows), each tile's threads as thread_cells."""
    RT = tile_items(dtype) // ks
    r, s = thread_cells(RT, B)
    count = np.zeros((n_rows, B), dtype=np.int64)
    for block in range(grid):
        rows = block_rows(n_rows, grid, block)
        tiles = -(-len(rows) * ks // tile_items(dtype))
        for t in range(tiles):
            live = t * RT + r < len(rows)
            np.add.at(count, (rows.start + t * RT + r[live], s[live]), 1)
    return count


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_every_row_and_slot_once(dtype, B, grid):
    """Every (weight row, slot) of each GEMV phase of GPT-2 small (qkv,
    proj, fc, fc_proj as four items a row, the LM head) has exactly one
    thread's epilogue, whatever the grid; a tile's threads take each of its
    (row, slot)s once."""
    cfg = CFGS["gpt2"]
    for n_rows, ks in phases(cfg):
        assert (phase_counts(n_rows, ks, grid, B, dtype) == 1).all()
        RT = tile_items(dtype) // ks
        r, s = thread_cells(RT, B)
        assert sorted(zip(r.tolist(), s.tolist())) == [(i, j) for i in range(RT)
                                                       for j in range(B)]


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fragments_cover_a_tile(dtype, B):
    """A warp's fragments (lane (g, t): rows g, g + 8 x slots 8j + 2t + e of
    its n8 tiles) hold each (row < RT, slot < 8 ceil(B / 8)) of a tile once,
    for the E-input tiles and fc_proj's; the sums buffer's index of each is
    distinct and within the warp's share."""
    nt = -(-B // 8)
    for ks in (1, 4):
        RT = tile_items(dtype) // ks
        cells = []
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for j in range(nt):
                for q in range(4):
                    row, slot = g + 8 * (q >> 1), 8 * j + 2 * t + (q & 1)
                    if row < RT:
                        cells.append((row, slot))
        assert sorted(cells) == [(r, s) for r in range(RT) for s in range(8 * nt)]
        index = [slot * red_rows(dtype) + row for row, slot in cells]
        assert len(set(index)) == len(index) and max(index) < 8 * nt * red_rows(dtype)


@pytest.mark.parametrize("cfg_name", list(CFGS))
def test_k_slices_cover_the_inputs(cfg_name):
    """Warp w takes inputs [q E + w E / 8, q E + (w + 1) E / 8) of each
    E-input quarter q: together every input of K = E or 4E once, each slice
    a whole number of k16 steps (and of fp32 steps of 4), and a k16 step in
    one int4 group at every G the kernels take (G % 32 == 0, E % G == 0)."""
    E = CFGS[cfg_name].n_embd
    kq = E // WARPS
    assert kq % 16 == 0
    for ks in (1, 4):
        got = sorted(q * E + w * kq + i for q in range(ks) for w in range(WARPS)
                     for i in range(kq))
        assert got == list(range(ks * E))
    for G in (g for g in range(32, ks * E + 1, 32) if E % g == 0):
        for q in range(4):
            for w in range(WARPS):
                for k in range(q * E + w * kq, q * E + (w + 1) * kq, 16):
                    assert k // G == (k + 15) // G


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("C", [128, 320, 8192])
def test_attention_items_once(C, B):
    """The attention phase takes every (slot, head, split) item once over
    the grid's warps (warp w of block b: items 8 b + w, 8 b + w + 8 grid,
    ...) and every slot's writer once (block grid - 1 - b % grid: the last
    blocks, which the items fill last) at every grid; the plan is the
    single stream's, a function of (C, H) alone."""
    cfg = CFGS["gpt2"]
    splits, rows = tmk.attention_plan(C, cfg.n_head)
    per_slot = cfg.n_head * splits
    n_items = B * per_slot
    for grid in GRIDS:
        taken = [it for block in range(grid) for w in range(WARPS)
                 for it in range(block * WARPS + w, n_items, grid * WARPS)]
        assert sorted(taken) == list(range(n_items))
        writers = [b for block in range(grid) for b in range(grid - 1 - block, B, grid)]
        assert sorted(writers) == list(range(B))
    keys = {(i // per_slot, (i % per_slot) // splits, i % splits) for i in range(n_items)}
    assert len(keys) == n_items
    assert tmb.batch_scratch(cfg, C, B)["splits"] == splits


@pytest.mark.parametrize("wkind", ["fp", "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cfg_name", list(CFGS))
def test_smem_fits_a_block(cfg_name, dtype, wkind):
    """At every B and every capacity the kernels take: at least two ring
    slots (fc_proj holds HOLD = 2 tiles at once), the ring within
    RING_BYTES, and the ring, the staged rows and the two sums buffers with
    the static shared memory within a block's 227 KB. Every registry
    geometry fits, GPT-2 large in fp32 at 25-32 slots included: its fp32
    ring tile is 4 rows (20 KB), where the single stream's 8 (40 KB) left
    no two slots beside 25 or more staged fp32 rows."""
    cfg = CFGS[cfg_name]
    for B in range(1, tmb.MAX_BATCH + 1):
        for C in (8, 128, 320, 1024, 8192):
            slots, tile, rs, smem, _ = smem_plan(cfg, C, dtype, wkind, B)
            assert max(2, HOLD) <= slots <= MAX_SLOTS and slots * tile <= RING_BYTES
            assert tile % 16 == 0 and rs % 16 == 0 and smem % 16 == 0
            assert smem <= DYN_SMEM and smem + STATIC_SMEM <= SMEM_LIMIT


def test_smem_table():
    """GPT-2 small's ring slots, shared memory and fc_proj's quarters staged
    at once at C = 320 in bf16: four up to B = 8, two to 16, one at 32."""
    cfg = CFGS["gpt2"]
    want = {(1, "fp"): (7, 186912, 4), (8, "fp"): (6, 205568, 4), (16, "fp"): (6, 214528, 2),
            (32, "fp"): (5, 207872, 1), (32, "int8"): (7, 220160, 2),
            (32, "int4"): (14, 220160, 2), (16, "int4"): (17, 220672, 4)}
    for (B, wkind), (slots, smem, fcp_q) in want.items():
        got = smem_plan(cfg, 320, torch.bfloat16, wkind, B)
        assert (got[0], got[3], got[4]) == (slots, smem, fcp_q), (B, wkind, got)


def _params(dtype, wq=None):
    """Weights in name only for the gates (they read kinds, dtypes, groups)."""
    from torch_port_helpers import fake_params
    return fake_params(tmk.WEIGHT_NAMES, False, "wte", True, wq or "fp",
                       128 if wq == "int4" else 0, dtype=dtype)


def test_gates_refuse_what_a_block_cannot_hold():
    """The batched step's gates (fp and quantized panes) refuse exactly the
    geometries whose shared-memory plan keeps fewer than two ring slots,
    the launcher's own refusal, so the engine goes prompt by prompt and a
    server refuses at construction instead of a launch raising. GPT-2
    large takes every B in fp32 and bf16 and over its weight tiers (fp32
    past 24 slots since the 4-row fp32 tile); a wider fp32 geometry the
    single stream takes (E = 2048: 32 staged rows are 257 KB) is still
    refused past what a block holds."""
    from efficient_llm_inference_tpu_torch.ops import megakernel_batch_quant as tmbq
    wide = tgpt2.GPT2Config(vocab_size=1000, n_positions=512, n_embd=2048, n_layer=1,
                            n_head=16)
    for name, cfg in (("gpt2-large", CFGS["gpt2-large"]), ("wide", wide)):
        for dtype, wq in ((torch.float32, None), (torch.bfloat16, None),
                          (torch.float32, "int8"), (torch.bfloat16, "int4")):
            params = _params(dtype, wq)
            for B in range(1, tmb.MAX_BATCH + 1):
                fits = smem_plan(cfg, 320, dtype, wq or "fp", B)[0] >= 2
                if name == "gpt2-large":
                    assert fits, (dtype, wq, B)
                elif (dtype, wq, B) == (torch.float32, None, 32):
                    assert not fits
                assert tmb.mega_batch_supported(cfg, 320, params, B) == fits, (name, dtype, wq, B)
                for kv in ("int8", "mixed"):
                    assert tmbq.mega_batch_quant_supported(cfg, 320, params, B, kv) == fits


def test_engine_goes_prompt_by_prompt_past_the_plan():
    """An fp32 GPT-2 large engine takes the batched step for 24 and for
    25-32 prompts (fp32's 4-row ring tile) and not past MAX_BATCH
    (`_mega_batch_spec` is None: generate_batch decodes prompt by prompt)."""
    from efficient_llm_inference_tpu_torch import Config, InferenceEngine
    from efficient_llm_inference_tpu_torch.models.registry import gpt2_spec
    cfg = CFGS["gpt2-large"]
    eng = InferenceEngine(gpt2_spec(cfg), _params(torch.float32), config=Config(
        model_name="t", device="cpu", dtype=torch.float32, megakernel=True))
    eng._mega_packed = {}  # the gate alone decides; nothing is packed
    assert eng._mega_batch_spec(320, 24) is not None
    for B in (25, 32):
        assert eng._mega_batch_spec(320, B) is not None
        assert eng._mega_batch_spec(320, B, "int8") is not None
    assert eng._mega_batch_spec(320, tmb.MAX_BATCH + 1) is None


@pytest.mark.parametrize("B", BATCHES)
def test_batch_scratch(B):
    cfg = CFGS["gpt2"]
    assert tmb.batch_scratch(cfg, 320, B) == {
        "splits": 10, "rows": 32, "part": B * 12 * 10 * 66, "sync": 2 + 12 * B}
    small = CFGS["small-test"]
    assert tmb.batch_scratch(small, 8192, B) == {
        "splits": 64, "rows": 128, "part": B * 2 * 64 * 130, "sync": 2 + 2 * B}


def _c_int(name: str, text: str) -> str:
    m = re.search(rf"constexpr int {name} = ([^;]+);", text)
    assert m, name
    return m.group(1).strip()


def test_c_constants_mirror_the_plan():
    src = (CSRC / "gpt2_megabatch.cu").read_text()
    shared = (CSRC / "persistent_step.cuh").read_text()
    assert int(_c_int("kMaxBatch", src)) == tmb.MAX_BATCH
    assert eval(_c_int("kDynSmem", src)) == DYN_SMEM  # "216 * 1024"
    assert int(_c_int("kRowPad", src)) == ROW_PAD
    assert re.search(r"return (BTile<T, WK>::items \+ 1);", src)
    assert re.search(r"items = sizeof\(T\) == 4 \? 4 : Tile<T, WK>::items;", src)
    assert tmb.batch_tile_items(torch.float32) == 4
    assert tmb.batch_tile_items(torch.bfloat16) == tmb.tile_items(torch.bfloat16) == 16
    assert int(_c_int("kHold", src)) == HOLD
    assert int(_c_int("kMinSlots", src)) == MIN_SLOTS
    assert int(_c_int("kMaxSlots", shared)) == MAX_SLOTS
    assert eval(_c_int("kRingBytes", shared)) == RING_BYTES
    assert re.search(r"per_warp = (.*?);", shared).group(1) == "4 / (int)sizeof(T)"
    assert "kRowsPer" not in src  # no epilogue rows held a thread: any grid takes any B


def test_batch_args_mirror_the_c_struct():
    """GPT2BatchArgs is Gpt2StepArgs (MegaStepArgs, then the grid, the
    attention plan and the scratch) followed by B, as `struct Gpt2BatchArgs
    { Gpt2StepArgs s; int batch; }`."""
    src = (CSRC / "gpt2_megabatch.cu").read_text()
    body = re.search(r"struct Gpt2BatchArgs {(.*?)\n};", src, re.S).group(1)
    members = [line.split("//")[0].strip().rstrip(";").split()
               for line in body.splitlines() if line.split("//")[0].strip()]
    assert members == [["Gpt2StepArgs", "s"], ["int", "batch"]]
    names = [f[0] for c in reversed(tmb.GPT2BatchArgs.__mro__)
             for f in vars(c).get("_fields_", [])]
    assert names == ([n for n, _ in tmk.MegaStepArgs._fields_]
                     + [n for n, _ in tmk.Gpt2StepArgs._fields_] + ["batch"])
    import ctypes
    assert tmb.GPT2BatchArgs.batch.offset == ctypes.sizeof(tmk.Gpt2StepArgs)
    assert tmb.GPT2BatchLauncher.args_type is tmb.GPT2BatchArgs
    assert tmb.GPT2BatchLauncher.grid_entry == "elit_gpt2_megabatch_grid"
