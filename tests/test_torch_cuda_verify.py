"""The speculative verify kernels and the draft bursts against their plain
versions, on the card: the single-sequence verifies (#10, #13 at R > 1), the
batched verifies (#18-#21) per slot and row, B in {1, 3, 16} x R in
{2, 5, 8} and past 128 rows, their bf16 GEMVs on the tensor cores
(`verify_gemv`), the weight tiers of each, and the draft bursts (#22, #23)
at the byte-vocab draft geometries.

CUDA kernels have no CPU mode, so every test here needs an NVIDIA GPU: it is
marked `cuda` and skips without one. This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_verify.py

Tolerances: the single-stream steps' (tests/test_torch_cuda_single.py), per
row; a bf16 row's bits do not depend on the rows beside it.
"""

import pytest
import torch

from efficient_llm_inference_tpu_torch.models import gpt2 as tgpt2
from efficient_llm_inference_tpu_torch.ops import megakernel as tmk
from efficient_llm_inference_tpu_torch.ops import megakernel_batch_verify as tbv
from efficient_llm_inference_tpu_torch.ops import megakernel_llama as tml
from torch_cuda_cases import (  # noqa: F401 (cuda: the fixture)
    BF16,
    DRAFT_CFGS,
    VERIFY_BATCH_LENGTHS,
    VERIFY_FAMILIES,
    _batch_case,
    _check_megabatch_verify,
    _check_megaverify,
    _gemv_weight,
    _linear_close,
    _llama_params,
    _rows_close,
    _token_close,
    cuda,
)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("R", [2, 5, 8])
@pytest.mark.parametrize("B", [1, 3, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["fp", "int8", "int4", "mixed"])
@pytest.mark.parametrize("family", ["gpt2", "gpt2-full", "llama"])
def test_megabatch_verify_matches_plain(cuda, family, mode, dtype, B, R):
    """#18-#21 against their plain versions (R sequential plain steps a
    slot), fed token ids: per slot and row the token and the R new rows
    under test_megabatch_matches_plain's tolerances, every other column and
    scale untouched. Over quantized panes each row is held against the
    plain step on the kernel's own earlier rows of the block, and a bf16 row
    may also differ by the fp rows' 1.6e-2 of its largest value (as
    chip_smoke.py does) and its token by 4e-2 (the deep-bf16 allowance:
    scripts/torch_verify_drift.py read a GPT-2 small row of these cases
    0.0243 under the plain maximum, the single-stream quant step on the same
    input the same)."""
    _check_megabatch_verify(cuda, family, mode, dtype, B, R)


@pytest.mark.parametrize("B", [24, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["fp", "int8", "int4", "mixed"])
@pytest.mark.parametrize("family", ["gpt2", "gpt2-full", "llama"])
def test_megabatch_verify_past_128_rows_matches_plain(cuda, family, mode, dtype, B):
    """The servers of 24 and 32 slots at spec_k = 8: 192 and 256 rows a
    pass, with test_megabatch_verify_matches_plain's checks."""
    _check_megabatch_verify(cuda, family, mode, dtype, B, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cur", [0, 7, 47])
@pytest.mark.parametrize("R", [1, 4, 8])
@pytest.mark.parametrize("family", VERIFY_FAMILIES)
def test_megaverify_matches_plain(cuda, family, R, cur, dtype):
    """#10 gpt2_megaverify and #13 at R > 1 (llama_megaverify) against their
    plain versions (R plain steps), C = 64: per row the token (chip_smoke.py's
    tolerances), the R new rows (fp32 1e-5, bf16 1.6e-2 of their largest
    value), every other row untouched; fed token ids (embedded on the
    device) and embeddings."""
    _check_megaverify(cuda, family, R, cur, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dlen", [0, 17])
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("name", list(DRAFT_CFGS))
def test_draft_burst_matches_plain(cuda, name, k, dlen, dtype):
    """#22 gpt2_draft_burst and #23 llama_draft_burst (one cluster launch, k
    steps) against the plain steps teacher-forced with the kernel's tokens,
    C = 64: each proposal is the plain step's token (chip_smoke.py's
    tolerances), the k new rows within the megastep tolerances, every other
    row untouched. Block weights at std 0.15, so that the proposals vary
    (at std 0.02 a tied draft repeats its input token)."""
    from efficient_llm_inference_tpu_torch.ops import megakernel_draft as tmd

    cfg = DRAFT_CFGS[name]()
    llama = name == "draft_llama"
    if llama:
        params = _llama_params(cfg, cuda)
        packed, W = tmd.pack_llama_draft(params, cfg), cfg.n_kv_head * cfg.head_dim
        kern, step = tmd.llama_draft_burst, tml.llama_megastep_plain
    else:
        params = tgpt2.init_gpt2_params(torch.Generator().manual_seed(3), cfg,
                                        torch.float32, cuda)
        for name_, t in params["blocks"].items():  # std 0.15: the proposals vary
            if name_.endswith("_w"):
                t.mul_(7.5)
        packed, W = tmd.pack_gpt2_draft(params, cfg), cfg.n_embd
        kern, step = tmd.gpt2_draft_burst, tmk.gpt2_megastep_plain
    packed = {k_: (v.to(dtype) if v.dtype == torch.float32 and k_ not in (
        "smalls", "lnf", "norms", "cos", "sin", "qkvb") else v) for k_, v in packed.items()}
    C = 64
    assert (tmd.llama_draft_burst_supported if llama else tmd.gpt2_draft_burst_supported)(
        cfg, C, dtype)
    g = torch.Generator(device="cpu").manual_seed(k * 10 + dlen)
    state = [(torch.randn((cfg.n_layer, C, W), generator=g) * 0.5).to(dtype).to(cuda)
             for _ in range(2)]
    cur = 65
    got = [t.clone() for t in state]
    before = kern.launches
    props = kern(packed, *got, torch.tensor([dlen], dtype=torch.int32, device=cuda),
                 torch.tensor([cur], dtype=torch.int32, device=cuda), cfg=cfg, k=k)[0]
    torch.cuda.synchronize()
    assert kern.launches == before + 1 and props.shape == (k,)
    want = [t.clone() for t in state]
    tok = cur
    for s in range(k):
        if llama:
            x = packed["embed"][tok][None]
        else:
            x = (packed["wte"][tok] + packed["wpe"][min(dlen + s, cfg.n_positions - 1)])[None]
            x = x.to(dtype)
        logits = step(packed, *want, dlen + s, x, cfg=cfg, return_logits=True)[-1]
        assert _token_close(int(props[s]), logits, dtype), (s, int(props[s]))
        tok = int(props[s])
    rows = torch.arange(dlen, dlen + k, device=cuda)
    others = torch.ones(C, dtype=torch.bool, device=cuda)
    others[rows] = False
    for g_, w_, b_ in zip(got, want, state):
        assert torch.equal(g_[:, others], b_[:, others])
        assert _rows_close(g_[:, rows], w_[:, rows], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cur", [0, 47])
@pytest.mark.parametrize("wq", ["int8", "int4", "int4w8"])
@pytest.mark.parametrize("family", ["gpt2", "gpt2-full", "g2", "llama-3-1b-L2"])
def test_tier_megaverify_matches_plain(cuda, family, wq, cur, dtype):
    """#10 and #13 at R = 8 over quantized weights (int8, int4 at G = 128,
    int4w8) against their plain versions, with test_megaverify_matches_plain's
    checks (Llama-3.2-1B's width at 2 layers included); the launch lands in
    the wrapper's tier count, not its full-precision one."""
    _check_megaverify(cuda, family, 8, cur, dtype, wq)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["fp", "int8"])
@pytest.mark.parametrize("wq", ["int8", "int4", "int4w8"])
@pytest.mark.parametrize("family", ["gpt2", "gpt2-full", "llama"])
def test_tier_megabatch_verify_matches_plain(cuda, family, wq, mode, dtype):
    """#18-#21 over quantized weights, 3 slots x 5 rows, with
    test_megabatch_verify_matches_plain's checks and tolerances."""
    _check_megabatch_verify(cuda, family, mode, dtype, 3, 5, wq)


@pytest.mark.parametrize("tier", ["fp", "int8", "int4"])
@pytest.mark.parametrize("R,N,K", [(64, 16384, 2048), (128, 3072, 768), (8, 50257, 768),
                                   (1, 2048, 8192), (256, 768, 3072), (37, 3072, 2048)])
def test_verify_gemv_matches_plain(cuda, R, N, K, tier):
    """One GEMV of the bf16 batched verify chain (Llama-3.2-1B gate/up and
    down, GPT-2 small fc, fc-proj and LM head shapes) against its plain
    version: within one bf16 ulp plus 1e-5 of the largest output."""
    g = torch.Generator(device="cpu").manual_seed(R + N + K)
    w, s = _gemv_weight(N, K, tier, g, cuda)
    x = torch.randn((R, K), generator=g).to(BF16).to(cuda)
    before = tbv.verify_gemv.launches
    got = tbv.verify_gemv(x, w, s)
    torch.cuda.synchronize()
    assert tbv.verify_gemv.launches == before + 1
    assert _linear_close(got, tbv.verify_gemv_plain(x, w, s), BF16)


@pytest.mark.parametrize("tier", ["fp", "int8", "int4"])
@pytest.mark.parametrize("N,K", [(3072, 768), (2048, 8192)])
def test_verify_gemv_rows_independent(cuda, N, K, tier):
    """A row's GEMV output is bitwise the same among 1, 8 and 256 rows."""
    g = torch.Generator(device="cpu").manual_seed(N + K)
    w, s = _gemv_weight(N, K, tier, g, cuda)
    x = torch.randn((256, K), generator=g).to(BF16).to(cuda)
    full = tbv.verify_gemv(x, w, s)
    eight = tbv.verify_gemv(x[8:16].clone(), w, s)
    one = tbv.verify_gemv(x[11:12].clone(), w, s)
    assert torch.equal(one[0], full[11]) and torch.equal(eight[3], full[11])


@pytest.mark.parametrize("wq", [None, "int8", "int4", "int4w8"])
@pytest.mark.parametrize("mode", ["fp", "int8", "int4", "mixed"])
@pytest.mark.parametrize("B", [1, 8, 16, 32])
@pytest.mark.parametrize("family", ["gpt2-full", "llama-3-1b-L2"])
def test_tc_megabatch_verify_matches_plain(cuda, family, B, mode, wq):
    """#18-#21 in bf16 on the tensor-core GEMVs at B x 8 rows (8 to 256), at
    GPT-2 small's and Llama-3.2-1B's widths (2 layers), every pane kind and
    weight tier, with test_megabatch_verify_matches_plain's checks and bf16
    limits."""
    _check_megabatch_verify(cuda, family, mode, BF16, B, 8, wq)


@pytest.mark.parametrize("wq", [None, "int8", "int4"])
@pytest.mark.parametrize("mode", ["fp", "int8"])
@pytest.mark.parametrize("family", ["gpt2-full", "llama-3-1b-L2"])
def test_tc_megabatch_verify_rows_independent(cuda, family, mode, wq):
    """A slot's verify rows are bitwise independent of the slots launched
    beside it: slot 0 (and slot 3) of a 1 x 8, an 8 x 8 and a 32 x 8 bf16
    launch over the same panes write the same K/V rows bit for bit and
    propose the same tokens."""
    packed, cfg, state, _ = _batch_case(family, mode, BF16, 32, cuda, wq)
    lengths = torch.tensor([VERIFY_BATCH_LENGTHS[b % 8] for b in range(32)],
                           dtype=torch.int32, device=cuda)
    g = torch.Generator(device="cpu").manual_seed(17)
    ids = torch.randint(0, cfg.vocab_size, (32 * 8,), generator=g).to(torch.int32).to(cuda)
    gpt2 = family.startswith("gpt2")
    kern = {(True, False): tbv.gpt2_megabatch_verify,
            (True, True): tbv.gpt2_megabatch_verify_quant,
            (False, False): tbv.llama_megabatch_verify,
            (False, True): tbv.llama_megabatch_verify_quant}[(gpt2, mode != "fp")]
    kw = {"kv_mode": mode} if mode != "fp" else {}
    runs = {}
    for B in (1, 8, 32):
        panes = [t[:, :B].clone() for t in state]
        toks = kern(packed, *panes, lengths[:B].clone(), ids[:B * 8].clone(), cfg=cfg,
                    **kw)[0]
        runs[B] = (toks, panes)
    torch.cuda.synchronize()
    for B, b in ((1, 0), (8, 0), (8, 3)):
        toks, panes = runs[B]
        assert torch.equal(toks[b], runs[32][0][b]), (B, b)
        for p_, q_ in zip(panes, runs[32][1]):
            assert torch.equal(p_[:, b], q_[:, b]), (B, b)


def _verify_kernel(kind):
    return tmk.gpt2_megaverify if kind == "gpt2" else tml.llama_megaverify


def _full_width_case(family, dtype, wq, device):
    """(kind, packed, cfg) at GPT-2 small's or Llama-3.2-1B's width (2
    layers): the weight tier `wq`, or (None) the weights in `dtype`."""
    from torch_cuda_cases import _TIER_PARAMS, TIER_OF, _tier_packed, _tree_to
    if wq is not None:
        kind, cfg, packed = _tier_packed(TIER_OF[family], wq, dtype, device)
        return kind, packed, cfg
    kind, cfg, _ = _tier_packed(TIER_OF[family], "int8", dtype, device)
    pack = tmk.pack_gpt2_mega if kind == "gpt2" else tml.pack_llama_mega
    return kind, pack(_tree_to(_TIER_PARAMS[TIER_OF[family]][1], dtype), cfg), cfg


@pytest.mark.parametrize("wq", [None, "int8", "int4"])
@pytest.mark.parametrize("family,dtype", [("gpt2-full", torch.float32),
                                          ("gpt2-full", torch.bfloat16),
                                          ("llama-3-1b-L2", torch.bfloat16)])
def test_megaverify_rows_independent(cuda, family, dtype, wq):
    """Row t's bits do not depend on R or on the rows after it: a verify of
    R = t + 1 rows and one of 8 over the same panes and tokens (cur = 40, C
    = 64) propose the same token t and write the same K/V rows cur .. cur +
    t bit for bit, at GPT-2 small's width (the persistent verify, bf16 and
    fp32) and Llama-3.2-1B's (2 layers; the bf16 chain on the tensor-core
    stream: the fp32 chain's gemv_batch.cuh GEMVs group their rows and sum
    in an order that depends on R), over full-precision weights and the int8
    / int4 weight tiers."""
    kind, packed, cfg = _full_width_case(family, dtype, wq, cuda)
    kern = _verify_kernel(kind)
    L, C, cur = cfg.n_layer, 64, 40
    W = cfg.n_embd if kind == "gpt2" else cfg.n_kv_head * cfg.head_dim
    g = torch.Generator(device="cpu").manual_seed(5)
    state = [(torch.randn((L, C, W), generator=g) * 0.5).to(dtype).to(cuda) for _ in range(2)]
    ids = torch.randint(0, cfg.vocab_size, (8,), generator=g).to(torch.int32).to(cuda)
    runs = {}
    for R in range(1, 9):
        panes = [t.clone() for t in state]
        toks = kern(packed, *panes, torch.tensor([cur], dtype=torch.int32, device=cuda),
                    ids[:R].clone(), cfg=cfg)[0]
        runs[R] = (toks, panes)
    torch.cuda.synchronize()
    for R in range(1, 8):
        toks, panes = runs[R]
        assert torch.equal(toks, runs[8][0][:R]), R
        for p_, q_ in zip(panes, runs[8][1]):
            assert torch.equal(p_[:, :cur + R], q_[:, :cur + R]), R


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wq", [None, "int8", "int4w8"])
@pytest.mark.parametrize("family", ["llama-3-1b-L2"])
def test_llama_megaverify_launch_count(cuda, family, wq, dtype):
    """#13 at R > 1 is the chain of 6 L + 3 kernels a pass (embed; per layer
    the q|k|v GEMV, the rows' writer, the split attention, o, gate|up, down;
    the LM head and the argmax), counted where each launches
    (`verify_chain_kernels`: csrc/megaverify.cu's launch helpers add one a
    launch), in every dtype and weight tier."""
    kind, packed, cfg = _full_width_case(family, dtype, wq, cuda)
    W = cfg.n_kv_head * cfg.head_dim
    panes = [torch.zeros((cfg.n_layer, 64, W), dtype=dtype, device=cuda) for _ in range(2)]
    ids = torch.zeros(8, dtype=torch.int32, device=cuda)
    before = tml.verify_chain_kernels()
    tml.llama_megaverify(packed, *panes, 3, ids, cfg=cfg)
    torch.cuda.synchronize()
    assert tml.verify_chain_kernels() - before == 6 * cfg.n_layer + 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wq", [None, "int8", "int4"])
@pytest.mark.parametrize("R", [2, 8])
def test_gpt2_megaverify_one_kernel_a_pass(cuda, R, wq, dtype):
    """#10 is one cooperative kernel a verify pass at every R, dtype and
    weight tier (csrc/gpt2_megaverify.cu counts its launches:
    `verify_step_kernels`), at GPT-2 small's width."""
    kind, packed, cfg = _full_width_case("gpt2-full", dtype, wq, cuda)
    panes = [torch.zeros((cfg.n_layer, 64, cfg.n_embd), dtype=dtype, device=cuda)
             for _ in range(2)]
    ids = torch.zeros(R, dtype=torch.int32, device=cuda)
    before = tmk.verify_step_kernels()
    toks = tmk.gpt2_megaverify(packed, *panes, 5, ids, cfg=cfg)[0]
    torch.cuda.synchronize()
    assert tmk.verify_step_kernels() - before == 1 and toks.shape == (R,)
