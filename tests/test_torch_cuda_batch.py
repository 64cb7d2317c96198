"""The batched whole-step kernels (#14-#17) against their plain versions,
per slot, on the card: B in {1, 3, 8, 9, 16, 32}, every pane kind, both
dtypes and the weight tiers. The bf16 batched Llama chain (#15 / #17 on
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

from efficient_llm_inference_tpu_torch.ops import megakernel_batch as tmb
from efficient_llm_inference_tpu_torch.ops import megakernel_batch_quant as tmbq
from torch_cuda_cases import (  # noqa: F401 (cuda: the fixture)
    BATCH_LENGTHS,
    _batch_case,
    _check_megabatch,
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
