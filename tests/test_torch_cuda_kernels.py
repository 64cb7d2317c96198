"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so every test here needs an NVIDIA GPU: it is
marked `cuda` and skips without one. This file imports no JAX, so it runs on
a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: the quantize kernels are bit-exact; the attention kernel sums in
another order than the plain version (fp32 atol 1e-4; bf16 atol 2e-2, the
output's own rounding), also at the Llama/Qwen query groups G = 4 and 7. The
whole-step megakernels (GPT-2 and Llama/Qwen) against their plain steps in
fp32: the token equal wherever the plain top-2 logit gap is at least 1e-4,
new K/V rows within 1e-5 (of the row's largest value, at least 1e-5, for the
Llama step; codes within one step, scales within 1e-5 relative, for
quantized panes), every other row untouched. The batched whole-step kernels
(#14-#17) likewise per slot, B in {1, 3, 8, 9, 16, 32} (past 8 slots the
batched GEMVs launch once per group of 8 rows), and in bf16 with
chip_smoke.py's tolerances (a token within 2e-2 of the plain maximum logit,
fp rows within 1.6e-2 of their largest value, quantized rows within two
steps). The batched verify kernels (#18-#21) likewise per slot and row, B in
{1, 3, 16} x R in {2, 5, 8}, and the continuous-batching server on the card
against the same server on the CPU, with its launch counts. The weight tiers
(int8, grouped int4, int4w8) of every chain: the single-stream steps, the
verifies (#10, #13 at R = 8), the batched steps (B = 9; the Llama ones in
bf16 also at B = 8, 16 and 32) and the batched
verifies (3 x 5 rows), each against its plain version with the same
checks, each launch counted in its wrapper's tier. The single-stream
Llama/Qwen chain (#13 at R = 1, #12: the streaming GEMV and the split-KV
attention) at Llama-3.2-1B's width cut to 2 layers, a Qwen group of 7 and
head_dim 128, fp32 and bf16, every pane kind and weight tier, at C = 320
on the lengths where the attention's splits change (0, 1, the last row of
a split and the first of the next visible last, C - 1) and at C = 8192,
length 8191, with the checks above; and two replays of one captured graph
of 6 steps give identical bits, equal to the same steps launched eagerly.
The bf16 batched Llama chain (#15 / #17 on csrc/gemv_stream_tc.cuh): a
slot's token and new K/V row bytes are the same at B = 1, 8, 9, 16 and 32
for every pane kind and the int8 / int4 weights, a step launches 5 L + 3
kernels at every B, the chain holds at Qwen2.5-7B's and Llama-3-8B's widths
(one layer), and one of its GEMVs alone (`stream_gemv`) is within one bf16
rounding of its plain version in every weight tier.
"""

import dataclasses

import numpy as np
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
from efficient_llm_inference_tpu_torch.ops import dequant as tdq
from efficient_llm_inference_tpu_torch.ops import linear as tlin
from efficient_llm_inference_tpu_torch.ops import megakernel as tmk
from efficient_llm_inference_tpu_torch.ops import megakernel_batch as tmb
from efficient_llm_inference_tpu_torch.ops import megakernel_batch_quant as tmbq
from efficient_llm_inference_tpu_torch.ops import megakernel_batch_verify as tbv
from efficient_llm_inference_tpu_torch.ops import megakernel_llama as tml
from efficient_llm_inference_tpu_torch.ops import megakernel_quant as tmq
from efficient_llm_inference_tpu_torch.ops import paged as tpaged
from efficient_llm_inference_tpu_torch.ops import quantize as trows

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("rows,n,stride", [(1, 768, 2304), (12, 64, 64),
                                           (256, 768, 2304), (37, 50, 50)])
def test_quantize_rows_bit_exact(cuda, bits, dtype, rows, n, stride):
    g = torch.Generator(device="cpu").manual_seed(rows + n + bits)
    buf = torch.randn((rows, stride), generator=g) * torch.rand((rows, 1), generator=g) * 8
    buf[0] = 0.0  # the eps scale
    x = buf.to(dtype).to(cuda)[:, :n]
    wrapper = trows.quantize_int8_rows if bits == 8 else trows.quantize_int4_rows
    plain = (trows.quantize_int8_rows_plain if bits == 8
             else trows.quantize_int4_rows_plain)
    before = wrapper.launches
    codes, scale = wrapper(x)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want_codes, want_scale = plain(x)
    assert torch.equal(codes, want_codes)
    assert torch.equal(scale, want_scale)


def _attention_inputs(k_bits, v_bits, B, G, Hkv, C, D, S, dtype, per_token, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g)

    def store(bits):
        if bits == 16:
            return rnd(B, Hkv, C, D).to(dtype)
        if bits == 8:
            return torch.randint(-127, 128, (B, Hkv, C, D), generator=g,
                                 dtype=torch.int8)
        return torch.randint(0, 256, (B, Hkv, C, D // 2), generator=g,
                             dtype=torch.int32).to(torch.uint8)

    def scales():
        if per_token:  # one scale per token, shared by every head
            return (rnd(C).abs() * 0.02 + 1e-3).expand(B, Hkv, C)
        return rnd(B, Hkv, C).abs() * 0.02 + 1e-3

    q = rnd(B, Hkv * G, D).to(dtype)
    lengths = torch.tensor([C - 1, 0, 7, C][:B], dtype=torch.int32)
    return [q, store(k_bits), scales(), store(v_bits), scales(),
            rnd(B, Hkv, S, D).to(dtype), rnd(B, Hkv, S, D).to(dtype), lengths]


@pytest.mark.parametrize("k_bits,v_bits", [(8, 8), (4, 4), (8, 4), (4, 8), (16, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,G,Hkv,C,D,per_token", [
    (1, 1, 12, 320, 64, True),  # GPT-2 small decode, per_token scales
    (2, 2, 4, 100, 64, False),  # GQA, per-(head, token) scales
    (2, 4, 2, 33, 128, False),
    (1, 4, 8, 320, 64, True),  # Llama-3.2-1B decode: 32 query heads on 8
    (1, 7, 2, 100, 64, True),  # Qwen2.5-0.5B decode: 14 query heads on 2
])
def test_attention_matches_plain(cuda, k_bits, v_bits, dtype, B, G, Hkv, C, D,
                                 per_token):
    args = _attention_inputs(k_bits, v_bits, B, G, Hkv, C, D, 2, dtype,
                             per_token, seed=k_bits + v_bits + B + D)
    args = [a.to(cuda) for a in args]
    before = tattn.fused_quant_attention_batched.launches
    got = tattn.fused_quant_attention_batched(*args, 1, k_bits=k_bits, v_bits=v_bits)
    torch.cuda.synchronize()
    assert tattn.fused_quant_attention_batched.launches == before + 1
    want = tattn.fused_quant_attention_batched_plain(*args, 1, k_bits=k_bits,
                                                     v_bits=v_bits)
    assert got.dtype == dtype and got.shape == want.shape
    atol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


def test_attention_rejects_unsupported_head_dim(cuda):
    args = [a.to(cuda) for a in _attention_inputs(
        8, 8, 1, 1, 2, 16, 64, 1, torch.float32, True, seed=0)]
    args[0] = args[0][..., :32]
    with pytest.raises((NotImplementedError, ValueError)):
        tattn.fused_quant_attention_batched(*args, 1)


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


@pytest.mark.parametrize("k_bits,v_bits", [(8, 8), (4, 4), (8, 4), (16, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_no_visible_row_matches_plain(cuda, k_bits, v_bits, dtype):
    """length 0 and no extra row: the JAX kernel's (and the plain
    version's) uniform average over every stored and extra row."""
    args = _attention_inputs(k_bits, v_bits, 2, 1, 12, 320, 64, 2, dtype, True,
                             seed=k_bits * v_bits)
    args[7] = torch.zeros(2, dtype=torch.int32)
    args = [a.to(cuda) for a in args]
    got = tattn.fused_quant_attention_batched(*args, 0, k_bits=k_bits, v_bits=v_bits)
    want = tattn.fused_quant_attention_batched_plain(*args, 0, k_bits=k_bits,
                                                     v_bits=v_bits)
    torch.cuda.synchronize()
    assert torch.isfinite(want).all() and want.abs().max() > 0
    atol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


MEGA_CFGS = {
    "small-test": dict(vocab_size=300, n_positions=256, n_embd=256, n_layer=2,
                       n_head=2),  # head_dim 128
    "gpt2": {},  # GPT-2 small at full width
}


def _mega_inputs(cfg, mode, C, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    L, E = cfg.n_layer, cfg.n_embd
    x = (torch.randn((1, E), generator=g) * 0.5).to(device)
    if mode == "fp":
        return [(torch.randn((L, C, E), generator=g) * 0.5).to(device)
                for _ in range(2)], x

    def pane(kind):
        width = E if kind == "int8" else E // 2
        lo = -127 if kind == "int8" else -128
        return torch.randint(lo, 128, (L, C, width), generator=g,
                             dtype=torch.int32).to(torch.int8).to(device)

    scales = [(torch.rand((L, C), generator=g) * 0.02 + 1e-3).to(device)
              for _ in range(2)]
    return [pane(k) for k in tmq._kv_kinds(mode)] + scales, x


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


LLAMA_CFGS = {  # small geometries: (G, head_dim, bias, head)
    "g2": dict(hidden_size=512, n_head=8, n_kv_head=4),
    "g4-untied": dict(hidden_size=512, n_head=8, n_kv_head=2, tie_embeddings=False),
    "g7-qwen": dict(hidden_size=896, n_head=14, n_kv_head=2, qkv_bias=True,
                    rms_eps=1e-6, rope_theta=1e6),
    "d128": dict(hidden_size=512, n_head=4, n_kv_head=2),
}


def _llama_cfg(name):
    kw = dict(vocab_size=300, intermediate_size=1024, n_layer=2, n_positions=512,
              rope_theta=10000.0, tie_embeddings=True)
    return tllama.LlamaConfig(**dict(kw, **LLAMA_CFGS[name]))


def _llama_params(cfg, device):
    params = tllama.init_llama_params(torch.Generator().manual_seed(1), cfg,
                                      torch.float32, device)
    for name, t in params["blocks"].items():  # weights at std 0.15, as the CPU tests
        if name.startswith("w"):
            t.mul_(7.5)
    return params


def _llama_inputs(cfg, mode, C, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    L, E, KW = cfg.n_layer, cfg.hidden_size, cfg.n_kv_head * cfg.head_dim
    x = (torch.randn((1, E), generator=g) * 0.5).to(device)
    if mode == "fp":
        return [(torch.randn((L, C, KW), generator=g) * 0.5).to(device)
                for _ in range(2)], x

    def pane(kind):
        width = KW if kind == "int8" else KW // 2
        lo = -127 if kind == "int8" else -128
        return torch.randint(lo, 128, (L, C, width), generator=g,
                             dtype=torch.int32).to(torch.int8).to(device)

    scales = [(torch.rand((L, C), generator=g) * 0.02 + 1e-3).to(device)
              for _ in range(2)]
    return [pane(k) for k in tmq._kv_kinds(mode)] + scales, x


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


# ------------------------------------------------------- batched (#14-#17)

BATCH_LENGTHS = [0, 37, 127, 5, 64, 126, 1, 100]  # C = 128: no visible row, the last column


def _batch_case(family, mode, dtype, B, device, wq=None):
    """(packed, cfg, panes and scales [L, B, C, W], x [B, E]) of a model of
    `family`: "gpt2" E = 256, head_dim 128; "gpt2-full" GPT-2 small at full
    width (a 48 KB staged input at B = 8 in bf16: the shared-memory opt-in);
    "llama" G = 2, KW = 256; "llama-3-1b-L2" Llama-3.2-1B's widths at 2
    layers; "qwen2.5-7b-L1" / "llama-3-8b-L1" those models' widths at one
    layer (weights at the registry's std, drawn on the card). With `wq`, the
    weights of that weight_quant (`_tier_packed`)."""
    C = 128
    if wq is not None:
        kind, cfg, packed = _tier_packed(TIER_OF[family], wq, dtype, device)
        W = cfg.n_embd if kind == "gpt2" else cfg.n_kv_head * cfg.head_dim
        E = cfg.n_embd if kind == "gpt2" else cfg.hidden_size
    elif family.startswith("gpt2"):
        cfg = tgpt2.GPT2Config(**MEGA_CFGS["small-test" if family == "gpt2" else "gpt2"])
        params = tgpt2.init_gpt2_params(torch.Generator().manual_seed(1), cfg,
                                        torch.float32, device)
        packed, W, E = tmk.pack_gpt2_mega(params, cfg), cfg.n_embd, cfg.n_embd
    elif family.endswith("-L1"):
        cfg = dataclasses.replace(tllama.LlamaConfig.by_name(family[:-3]), n_layer=1)
        params = tllama.init_llama_params(torch.Generator(device=device).manual_seed(1), cfg,
                                          torch.float32, device)
        packed = tml.pack_llama_mega(params, cfg)
        del params
        W, E = cfg.n_kv_head * cfg.head_dim, cfg.hidden_size
    else:
        cfg = (dataclasses.replace(tllama.LlamaConfig.llama3_1b(), n_layer=2)
               if family == "llama-3-1b-L2" else _llama_cfg("g2"))
        packed = tml.pack_llama_mega(_llama_params(cfg, device), cfg)
        W, E = cfg.n_kv_head * cfg.head_dim, cfg.hidden_size
    if wq is None:
        packed = {k: (v.to(dtype) if v.dtype == torch.float32 and k not in (
            "smalls", "lnf", "norms", "cos", "sin", "qkvb") else v) for k, v in packed.items()}
    g = torch.Generator(device="cpu").manual_seed(B * 7 + len(mode))
    L = cfg.n_layer
    x = (torch.randn((B, E), generator=g) * 0.5).to(dtype).to(device)
    if mode == "fp":
        return packed, cfg, [(torch.randn((L, B, C, W), generator=g) * 0.5).to(dtype)
                             .to(device) for _ in range(2)], x

    def pane(kind):
        width = W if kind == "int8" else W // 2
        lo = -127 if kind == "int8" else -128
        return torch.randint(lo, 128, (L, B, C, width), generator=g,
                             dtype=torch.int32).to(torch.int8).to(device)

    scales = [(torch.rand((L, B, C), generator=g) * 0.02 + 1e-3).to(device)
              for _ in range(2)]
    return packed, cfg, [pane(k) for k in tmq._kv_kinds(mode)] + scales, x


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


def _check_megabatch(cuda, family, mode, dtype, B, wq=None):
    packed, cfg, state, x = _batch_case(family, mode, dtype, B, cuda, wq)
    lengths = [BATCH_LENGTHS[b % len(BATCH_LENGTHS)] for b in range(B)]
    got = [t.clone() for t in state]
    want = [t.clone() for t in state]
    gpt2 = family.startswith("gpt2")
    if mode == "fp":
        kern = tmb.gpt2_megabatch if gpt2 else tmb.llama_megabatch
        plain = tmb.gpt2_megabatch_plain if gpt2 else tmb.llama_megabatch_plain
        kw = {}
    else:
        kern = tmbq.gpt2_megabatch_quant if gpt2 else tmbq.llama_megabatch_quant
        plain = tmbq.gpt2_megabatch_quant_plain if gpt2 else tmbq.llama_megabatch_quant_plain
        kw = {"kv_mode": mode}
    counter = tmk.launch_counter(kern, packed)  # the wrapper, or its weight tier's count
    before = (kern.launches, counter.launches)
    toks = kern(packed, *got, torch.tensor(lengths, dtype=torch.int32, device=cuda), x,
                cfg=cfg, **kw)[0]
    assert counter.launches == before[1] + 1 and toks.shape == (B,)
    assert kern.launches == before[0] + (counter is kern)
    logits = plain(packed, *want, lengths, x, cfg=cfg, return_logits=True, **kw)[-1]
    torch.cuda.synchronize()
    for b in range(B):
        top2 = logits[b].topk(2).values
        tok = int(toks[b])
        if dtype == torch.float32:
            assert tok == int(logits[b].argmax()) or float(top2[0] - top2[1]) < 1e-4
        else:
            assert float(logits[b, tok]) >= float(top2[0]) - 2e-2
    C = state[0].shape[2]
    for b, length in enumerate(lengths):
        others = torch.arange(C, device=cuda) != length
        for g_, w_, b_ in zip(got, want, state):
            assert torch.equal(g_[:, b][:, others], b_[:, b][:, others])
            assert torch.equal(w_[:, b][:, others], b_[:, b][:, others])
        if mode == "fp":
            for g_, w_ in zip(got, want):
                gn, wn = g_[:, b, length].float(), w_[:, b, length].float()
                rel = 1e-5 if dtype == torch.float32 else 1.6e-2
                assert (gn - wn).abs().max() <= rel * max(1.0, wn.abs().max().item())
            continue
        steps = 1 if dtype == torch.float32 else 2
        for kind, g_, w_, gs, ws in zip(tmq._kv_kinds(mode), got[:2], want[:2],
                                        got[2:], want[2:]):
            gv = tmq.pane_values(g_[:, b, length], kind) * gs[:, b, length, None]
            wv = tmq.pane_values(w_[:, b, length], kind) * ws[:, b, length, None]
            step = max(gs[:, b, length].max().item(), ws[:, b, length].max().item())
            assert (gv - wv).abs().max() <= steps * step * 1.01
            if dtype == torch.float32:
                torch.testing.assert_close(gs[:, b, length], ws[:, b, length],
                                           rtol=1e-5, atol=0)


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


# ------------------------------------------ batched verify (#18-#21), server

VERIFY_BATCH_LENGTHS = [0, 7, 111, 8, 64, 1, 100, 55]  # C = 128: up to C - 17


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


def _check_megabatch_verify(cuda, family, mode, dtype, B, R, wq=None):
    packed, cfg, state, _ = _batch_case(family, mode, dtype, B, cuda, wq)
    lengths = [VERIFY_BATCH_LENGTHS[b % len(VERIFY_BATCH_LENGTHS)] for b in range(B)]
    g = torch.Generator(device="cpu").manual_seed(B * 10 + R)
    ids = torch.randint(0, cfg.vocab_size, (B * R,), generator=g).to(torch.int32).to(cuda)
    gpt2 = family.startswith("gpt2")
    quant = mode != "fp"
    kern = {(True, False): tbv.gpt2_megabatch_verify, (True, True): tbv.gpt2_megabatch_verify_quant,
            (False, False): tbv.llama_megabatch_verify,
            (False, True): tbv.llama_megabatch_verify_quant}[(gpt2, quant)]
    plain = {(True, False): tbv.gpt2_megabatch_verify_plain,
             (True, True): tbv.gpt2_megabatch_verify_quant_plain,
             (False, False): tbv.llama_megabatch_verify_plain,
             (False, True): tbv.llama_megabatch_verify_quant_plain}[(gpt2, quant)]
    kw = {"kv_mode": mode} if quant else {}
    got = [t.clone() for t in state]
    want = [t.clone() for t in state]
    counter = tmk.launch_counter(kern, packed)
    before = (kern.launches, counter.launches)
    toks = kern(packed, *got, torch.tensor(lengths, dtype=torch.int32, device=cuda), ids,
                cfg=cfg, **kw)[0]
    assert counter.launches == before[1] + 1 and toks.shape == (B, R)
    assert kern.launches == before[0] + (counter is kern)
    logits = plain(packed, *want, lengths, ids, cfg=cfg, return_logits=True, **kw)[-1]
    torch.cuda.synchronize()
    C = state[0].shape[2]
    for b, cur in enumerate(lengths):
        new = torch.zeros(C, dtype=torch.bool, device=cuda)
        new[cur:cur + R] = True
        for g_, w_, b_ in zip(got, want, state):
            assert torch.equal(g_[:, b][:, ~new], b_[:, b][:, ~new])
            assert torch.equal(w_[:, b][:, ~new], b_[:, b][:, ~new])
        if not quant:
            for t in range(R):
                assert _token_close(int(toks[b, t]), logits[b, t], dtype), (b, t)
            for g_, w_ in zip(got, want):
                assert _rows_close(g_[:, b][:, new], w_[:, b][:, new], dtype)
            continue
        # quantized panes: row t against the plain step on the kernel's own
        # rows cur .. cur + t - 1 (the plain verify's own earlier rows may
        # differ from the kernel's by a code step, which row t attends)
        step_fn = tmq.gpt2_megastep_quant_plain if gpt2 else tmq.llama_megastep_quant_plain
        steps = 1 if dtype == torch.float32 else 2
        for t in range(R):
            panes = [s_[:, b].clone() for s_ in state]
            for p_, g_ in zip(panes, got):
                p_[:, cur:cur + t] = g_[:, b, cur:cur + t]
            tok_id = ids[b * R + t].long()
            if gpt2:
                pos = min(cur + t, cfg.n_positions - 1)
                x = (packed["wte"][tok_id] + packed["wpe"][pos])[None].to(dtype)
            else:
                x = packed["embed"][tok_id][None]
            lg = step_fn(packed, *panes, cur + t, x, cfg=cfg, kv_mode=mode,
                         return_logits=True)[-1]
            assert _token_close(int(toks[b, t]), lg, dtype, bf16_tol=4e-2), (b, t)
            r = cur + t
            for kind, g_, w_, gs, ws in zip(tmq._kv_kinds(mode), got[:2], panes[:2],
                                            got[2:], panes[2:]):
                gv = tmq.pane_values(g_[:, b, r], kind) * gs[:, b, r, None]
                wv = tmq.pane_values(w_[:, r], kind) * ws[:, r, None]
                step = max(gs[:, b, r].max().item(), ws[:, r].max().item())
                tol = steps * step * 1.01
                if dtype == torch.bfloat16:  # the values quantized may differ by
                    # the fp rows' bf16 tolerance (chip_smoke.py's deep-bf16)
                    tol += 1.6e-2 * max(1.0, wv.abs().max().item())
                assert (gv - wv).abs().max() <= tol, (b, t)
                if dtype == torch.float32:
                    torch.testing.assert_close(gs[:, b, r], ws[:, r], rtol=1e-5, atol=0)


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
        srv = MegaBatchServer(spec_m, params[dev], pool=pool, spec=spec, kv_mode=kv_mode)
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


# ------------------------------------------------- speculative decoding

VERIFY_FAMILIES = ["gpt2", "gpt2-full", "g2", "g4-untied", "g7-qwen", "d128"]


def _verify_case(family, dtype, device, wq=None):
    """(kind, packed, cfg) of a verify target: GPT-2 at E = 256 or GPT-2
    small's full width, or a small Llama/Qwen geometry of LLAMA_CFGS; with
    `wq`, the weights of that weight_quant (`_tier_packed`)."""
    if wq is not None:
        kind, cfg, packed = _tier_packed(TIER_OF[family], wq, dtype, device)
        return kind, packed, cfg
    if family.startswith("gpt2"):
        cfg = tgpt2.GPT2Config(**MEGA_CFGS["small-test" if family == "gpt2" else "gpt2"])
        params = tgpt2.init_gpt2_params(torch.Generator().manual_seed(2), cfg,
                                        torch.float32, device)
        packed, kind = tmk.pack_gpt2_mega(params, cfg), "gpt2"
    else:
        cfg = _llama_cfg(family)
        packed, kind = tml.pack_llama_mega(_llama_params(cfg, device), cfg), "llama"
    packed = {k: (v.to(dtype) if v.dtype == torch.float32 and k not in (
        "smalls", "lnf", "norms", "cos", "sin", "qkvb") else v) for k, v in packed.items()}
    return kind, packed, cfg


def _token_close(tok, logits, dtype, bf16_tol=2e-2):
    top2 = logits.topk(2).values
    if dtype == torch.float32:
        return tok == int(logits.argmax()) or float(top2[0] - top2[1]) < 1e-4
    return float(logits[tok]) >= float(top2[0]) - bf16_tol


def _rows_close(got, want, dtype):
    """New fp rows: fp32 within 1e-5, bf16 within 1.6e-2, of the rows'
    largest value (at least 1)."""
    rel = 1e-5 if dtype == torch.float32 else 1.6e-2
    g_, w_ = got.float(), want.float()
    return (g_ - w_).abs().max().item() <= rel * max(1.0, w_.abs().max().item())


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


def _check_megaverify(cuda, family, R, cur, dtype, wq=None):
    kind, packed, cfg = _verify_case(family, dtype, cuda, wq)
    kern = tmk.gpt2_megaverify if kind == "gpt2" else tml.llama_megaverify
    plain = tmk.gpt2_megaverify_plain if kind == "gpt2" else tml.llama_megaverify_plain
    L = cfg.n_layer
    W = cfg.n_embd if kind == "gpt2" else cfg.n_kv_head * cfg.head_dim
    C = 64
    g = torch.Generator(device="cpu").manual_seed(R * 100 + cur)
    state = [(torch.randn((L, C, W), generator=g) * 0.5).to(dtype).to(cuda) for _ in range(2)]
    ids = torch.randint(0, cfg.vocab_size, (R,), generator=g).to(cuda)
    length = torch.tensor([cur], dtype=torch.int32, device=cuda)
    want = [t.clone() for t in state]
    _, _, _, logits = plain(packed, *want, cur, ids, cfg=cfg, return_logits=True)
    rows = torch.arange(cur, cur + R, device=cuda)
    others = torch.ones(C, dtype=torch.bool, device=cuda)
    others[rows] = False
    for x in (ids.to(torch.int32), None):
        if x is None:  # the embeddings the engine's eager glue would build
            if kind == "gpt2":
                pos = torch.clamp(rows, max=cfg.n_positions - 1)
                x = (packed["wte"][ids] + packed["wpe"][pos]).to(dtype)
            else:
                x = packed["embed"][ids]
        got = [t.clone() for t in state]
        counter = tmk.launch_counter(kern, packed)
        before = (kern.launches, counter.launches)
        toks = kern(packed, *got, length, x, cfg=cfg)[0]
        torch.cuda.synchronize()
        assert counter.launches == before[1] + 1 and toks.shape == (R,)
        assert kern.launches == before[0] + (counter is kern)
        for t in range(R):
            assert _token_close(int(toks[t]), logits[t], dtype), (t, int(toks[t]))
        for g_, w_, b_ in zip(got, want, state):
            assert torch.equal(g_[:, others], b_[:, others])
            assert _rows_close(g_[:, rows], w_[:, rows], dtype)


DRAFT_CFGS = {  # the repo's byte-vocab drafts (examples/train_scale_models.py)
    "draft_gpt2": lambda: tgpt2.GPT2Config(vocab_size=256, n_positions=256, n_embd=128,
                                           n_layer=2, n_head=4),
    "draft_llama": lambda: tllama.LlamaConfig(
        vocab_size=256, n_positions=256, hidden_size=256, intermediate_size=512, n_layer=1,
        n_head=4, n_kv_head=2, rope_theta=10000.0, tie_embeddings=True),
}


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


# ------------------------------------------------ the kernel API (#4-#8, #24)

def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each value (the spacing above |t|; 2^-133 at 0)."""
    e = torch.floor(torch.log2(t.float().abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape,scale_shape", [
    ((6, 64), ()), ((6, 64), (6, 1)), ((6, 64), (6, 64)), ((5, 40), (5, 1)),
    ((12, 1, 12, 320, 64), (12, 1, 1, 320, 1)),  # GPT-2 small's cache, per token
    ((16, 1, 8, 320, 64), (16, 1, 8, 320, 1)),  # Llama-3.2-1B's, per (head, token)
])
def test_dequant_int8_bit_exact(cuda, out_dtype, shape, scale_shape):
    g = torch.Generator(device="cpu").manual_seed(sum(shape))
    q = torch.randint(-127, 128, shape, generator=g, dtype=torch.int32).to(torch.int8).to(cuda)
    s = (torch.rand(scale_shape, generator=g) * 0.02 + 1e-3).to(cuda)
    before = tdq.dequant_int8.launches
    got = tdq.dequant_int8(q, s, out_dtype)
    torch.cuda.synchronize()
    assert tdq.dequant_int8.launches == before + 1
    assert torch.equal(got, tdq.dequant_int8_plain(q, s, out_dtype))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape,orig,scale_shape", [
    ((5, 32), 64, (5, 1)), ((5, 32), 63, (5, 1)), ((5, 32), 64, ()), ((7, 20), 39, (7, 1)),
    ((12, 1, 12, 320, 32), 64, (12, 1, 1, 320, 1)),  # GPT-2 small's int4 cache
])
def test_dequant_int4_bit_exact(cuda, out_dtype, shape, orig, scale_shape):
    g = torch.Generator(device="cpu").manual_seed(sum(shape) + orig)
    p = torch.randint(0, 256, shape, generator=g, dtype=torch.int32).to(torch.uint8).to(cuda)
    s = (torch.rand(scale_shape, generator=g) * 0.02 + 1e-3).to(cuda)
    before = tdq.dequant_int4_packed.launches
    got = tdq.dequant_int4_packed(p, s, orig, out_dtype)
    torch.cuda.synchronize()
    assert tdq.dequant_int4_packed.launches == before + 1
    assert got.shape == (*shape[:-1], orig)
    assert torch.equal(got, tdq.dequant_int4_packed_plain(p, s, orig, out_dtype))


LINEAR_SHAPES = [(1, 64, 256), (4, 128, 512), (3, 96, 77), (9, 64, 200), (17, 256, 1000),
                 (1, 768, 3072), (8, 3072, 768), (8, 768, 50257), (1, 2048, 8192),
                 (8, 8192, 2048)]


def _linear_close(got, want, x_dtype):
    """fp32: within 1e-5 of the output's largest value (the sum's order);
    bf16 output: one bf16 ulp of the plain result, plus that fp32 term."""
    fp32 = 1e-5 * max(1.0, want.float().abs().max().item())
    tol = fp32 if x_dtype == torch.float32 else _bf16_ulp(want) + fp32
    return bool(((got.float() - want.float()).abs() <= tol).all())


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("B,E,F,x_dtype,w_dtype", [
    (B, E, F, x, w) for B, E, F in LINEAR_SHAPES for x, w in ((F32, F32), (BF16, BF16))
] + [(B, E, F, x, w) for B, E, F in LINEAR_SHAPES[:5] for x, w in ((F32, BF16), (BF16, F32))])
def test_pallas_linear_matches_plain(cuda, B, E, F, x_dtype, w_dtype):
    g = torch.Generator(device="cpu").manual_seed(B + E + F)
    x = torch.randn((B, E), generator=g).to(x_dtype).to(cuda)
    w = (torch.randn((E, F), generator=g) / E ** 0.5).to(w_dtype).to(cuda)
    before = tlin.pallas_linear.launches
    got = tlin.pallas_linear(x, w)
    torch.cuda.synchronize()
    assert tlin.pallas_linear.launches == before + 1 and got.dtype == x_dtype
    assert _linear_close(got, tlin.pallas_linear_plain(x, w), x_dtype)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,E,F", LINEAR_SHAPES)
def test_pallas_linear_int8_matches_plain(cuda, B, E, F, x_dtype):
    g = torch.Generator(device="cpu").manual_seed(B * E + F)
    x = torch.randn((B, E), generator=g).to(x_dtype).to(cuda)
    w_q, w_s = tlin.quantize_weight_int8((torch.randn((E, F), generator=g) / E ** 0.5).to(cuda))
    before = tlin.pallas_linear_int8.launches
    got = tlin.pallas_linear_int8(x, w_q, w_s)
    torch.cuda.synchronize()
    assert tlin.pallas_linear_int8.launches == before + 1 and got.dtype == x_dtype
    assert _linear_close(got, tlin.pallas_linear_int8_plain(x, w_q, w_s), x_dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length", [0, 37, 320])
@pytest.mark.parametrize("k_bits,v_bits", [(8, 8), (4, 4), (8, 4), (4, 8)])
@pytest.mark.parametrize("Hq,Hkv,C", [(4, 4, 48), (8, 2, 48), (12, 12, 320), (32, 8, 320)])
def test_decode_attention_matches_plain(cuda, Hq, Hkv, C, k_bits, v_bits, length, dtype):
    """#4 against its plain version (`_attention_close`: fp32 atol 1e-4, as
    #1), and bit-equal to #1 at B = 1 with the current token as its extra
    row."""
    g = torch.Generator(device="cpu").manual_seed(Hq + C + k_bits * 3 + v_bits)
    D = 64

    def codes(bits):
        if bits == 8:
            return torch.randint(-127, 128, (Hkv, C, D), generator=g, dtype=torch.int8)
        return torch.randint(0, 256, (Hkv, C, D // 2), generator=g,
                             dtype=torch.int32).to(torch.uint8)

    k_q, v_q = codes(k_bits).to(cuda), codes(v_bits).to(cuda)
    k_s, v_s = ((torch.rand((Hkv, C), generator=g) * 0.02 + 1e-3).to(cuda) for _ in range(2))
    q, k_cur, v_cur = (torch.randn((n, D), generator=g).to(dtype).to(cuda)
                       for n in (Hq, Hkv, Hkv))
    length_t = torch.tensor([length], dtype=torch.int32, device=cuda)
    args = (q, k_q, k_s, v_q, v_s, k_cur, v_cur)
    before = tattn.fused_quant_attention_decode.launches
    got = tattn.fused_quant_attention_decode(*args, length, k_bits=k_bits, v_bits=v_bits)
    got_t = tattn.fused_quant_attention_decode(*args, length_t, k_bits=k_bits, v_bits=v_bits)
    batched = tattn.fused_quant_attention_batched(
        q[None], k_q[None], k_s[None], v_q[None], v_s[None], k_cur[None, :, None],
        v_cur[None, :, None], length_t, 1, k_bits=k_bits, v_bits=v_bits)[0]
    want = tattn.fused_quant_attention_decode_plain(*args, length, k_bits, v_bits)
    torch.cuda.synchronize()
    assert tattn.fused_quant_attention_decode.launches == before + 2
    assert torch.equal(got, got_t) and torch.equal(got, batched)
    assert _attention_close(got, want, 1e-4)
    if length == 0:  # the current token alone
        assert _attention_close(got, v_cur.repeat_interleave(Hq // Hkv, 0), 1e-4)


def _attention_close(got, want, fp32_tol):
    """fp32 output: within `fp32_tol`. bf16 output: within two bf16 ulps of
    the plain result plus 1e-3 of its largest value (both round one fp32
    value whose sum order differs, so they sit one ulp apart at most)."""
    g_, w_ = got.float(), want.float()
    if got.dtype == torch.float32:
        return (g_ - w_).abs().max().item() <= fp32_tol
    return bool(((g_ - w_).abs() <= 2 * _bf16_ulp(w_) + 1e-3 * w_.abs().max().item()).all())


def _paged_case(B, Hq, Hkv, n_blocks, bs, max_blocks, lengths, q_dtype, pool_dtype, device,
                seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    D = 64
    q = torch.randn((B, Hq, D), generator=g).to(q_dtype).to(device)
    k_pool, v_pool = (torch.randn((Hkv, n_blocks, bs, D), generator=g).to(pool_dtype)
                      .to(device) for _ in range(2))
    perm = torch.randperm(n_blocks, generator=g)
    tables = torch.full((B, max_blocks), n_blocks, dtype=torch.int32)
    for b in range(B):  # each slot its own blocks, the rest sentinels
        used = min(max_blocks, -(-max(lengths[b], 1) // bs))
        tables[b, :used] = perm[(b * max_blocks) % n_blocks:][:used]
    tables[-1, -1] = n_blocks + 5
    lens = torch.tensor(lengths, dtype=torch.int32)
    return q, k_pool, v_pool, tables.to(device), lens.to(device)


@pytest.mark.parametrize("q_dtype,pool_dtype", [(torch.float32, torch.float32),
                                                (torch.bfloat16, torch.bfloat16),
                                                (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("geometry", ["jax-test", "jax-test-gqa", "llama-3-1b", "gpt2",
                                      "llama-3-1b-full"])
def test_paged_attention_matches_plain(cuda, geometry, q_dtype, pool_dtype):
    """#24 against its plain version (`_attention_close`: fp32 atol 2e-5,
    also over bf16 pools, which widen exactly), with
    sentinel entries and an idle slot (length 0: the mean of V over every
    walked position)."""
    B, Hq, Hkv, n_blocks, bs, max_blocks, lengths = {
        "jax-test": (3, 4, 4, 10, 16, 4, [37, 60, 0]),
        "jax-test-gqa": (3, 8, 2, 10, 16, 4, [0, 64, 20]),
        "llama-3-1b": (8, 32, 8, 256, 64, 32, [24, 256, 100, 0, 64, 65, 200, 1]),
        "gpt2": (8, 12, 12, 256, 64, 32, [24, 256, 100, 0, 64, 65, 200, 1]),
        "llama-3-1b-full": (8, 32, 8, 256, 64, 32, [2048] * 7 + [0]),
    }[geometry]
    args = _paged_case(B, Hq, Hkv, n_blocks, bs, max_blocks, lengths, q_dtype, pool_dtype,
                       cuda, seed=B + Hq + max(lengths))
    before = tpaged.paged_attention_decode.launches
    got = tpaged.paged_attention_decode(*args)
    want = tpaged.paged_attention_decode_plain(*args)
    torch.cuda.synchronize()
    assert tpaged.paged_attention_decode.launches == before + 1 and got.dtype == q_dtype
    assert _attention_close(got, want, 2e-5)


# ------------------------------------------- weight tiers of #9, #11-#13

TIER_CFGS = {  # (family, config): small and full widths
    "gpt2-small-test": ("gpt2", MEGA_CFGS["small-test"]),
    "gpt2-full": ("gpt2", MEGA_CFGS["gpt2"]),
    "llama-g2": ("llama", LLAMA_CFGS["g2"]),
    "llama-g7-qwen": ("llama", LLAMA_CFGS["g7-qwen"]),
    "llama-3-1b-L2": ("llama", "llama-3-1b"),  # Llama-3.2-1B's width, 2 layers
}
_TIER_PARAMS, _TIER_PACKED = {}, {}


def _tier_packed(cfg_name, wq, dtype, device):
    """(family, cfg, packed) of a weight-quantized model (cached per case):
    random weights quantized by models' `quantize_*_weights` at int8, int4
    (group 128, or 64 where the JAX gates refuse 128: Qwen's 128-row tile)
    or the int4w8 group (GPT-2: E/2; Llama/Qwen: TR/2)."""
    family, kw = TIER_CFGS[cfg_name]
    if cfg_name not in _TIER_PARAMS:
        if family == "gpt2":
            cfg = tgpt2.GPT2Config(**kw)
            params = tgpt2.init_gpt2_params(torch.Generator().manual_seed(3), cfg,
                                            torch.float32, device)
        else:
            cfg = (dataclasses.replace(tllama.LlamaConfig.llama3_1b(), n_layer=2)
                   if kw == "llama-3-1b" else _llama_cfg(cfg_name[6:]))
            params = _llama_params(cfg, device)
        _TIER_PARAMS[cfg_name] = (cfg, params)
    cfg, params = _TIER_PARAMS[cfg_name]
    key = (cfg_name, wq, dtype)
    if key not in _TIER_PACKED:
        spec = gpt2_spec(cfg) if family == "gpt2" else tllama.llama_spec(cfg)
        pack = tmk.pack_gpt2_mega if family == "gpt2" else tml.pack_llama_mega
        qspec, mode, G = weight_quant_plan(spec, wq)  # as from_model_name quantizes
        assert qspec is spec
        packed = None
        for G in ((G,) if wq == "int4w8" else (G, 64)):
            packed = pack(quantize_weights(spec, _tree_to(params, dtype), mode, G), cfg)
            if packed is not None:
                break
        assert packed is not None and tmk.weight_kind(packed) == wq[:4], key
        _TIER_PACKED[key] = (family, cfg, packed)
    return _TIER_PACKED[key]


def _tree_to(tree, *args):
    """A nested dict of tensors with `.to(*args)` applied to every leaf."""
    return {k: (_tree_to(v, *args) if isinstance(v, dict) else v.to(*args))
            for k, v in tree.items()}


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



# ------------------------- weight tiers of #10, #13 at R > 1, #14-#21

# the batched and verify cases' families -> TIER_CFGS
TIER_OF = {"gpt2": "gpt2-small-test", "gpt2-full": "gpt2-full", "llama": "llama-g2",
           "g2": "llama-g2", "llama-3-1b-L2": "llama-3-1b-L2"}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["fp", "int8"])
@pytest.mark.parametrize("wq", ["int8", "int4", "int4w8"])
@pytest.mark.parametrize("family", ["gpt2", "gpt2-full", "llama"])
def test_tier_megabatch_verify_matches_plain(cuda, family, wq, mode, dtype):
    """#18-#21 over quantized weights, 3 slots x 5 rows, with
    test_megabatch_verify_matches_plain's checks and tolerances."""
    _check_megabatch_verify(cuda, family, mode, dtype, 3, 5, wq)


# ------------------- the bf16 tensor-core route (#7, the batched verify GEMVs)

TC_LINEAR_SHAPES = [(2048, 8192), (768, 50257), (96, 77), (100, 200)]


@pytest.mark.parametrize("E,F", TC_LINEAR_SHAPES)
@pytest.mark.parametrize("B", [1, 2, 8, 9, 16, 64, 256])
def test_pallas_linear_bf16_tensor_cores_match_plain(cuda, B, E, F):
    """#7 on two bf16 operands runs the tensor-core route at every B (ragged
    E and F, unaligned rows) and agrees with `pallas_linear_plain` within
    one bf16 ulp plus 1e-5 of the largest output (the fp32 sums' order);
    fp32 pairs stay on the CUDA-core kernel."""
    assert tlin.launch_plan(B, E, F, BF16, BF16)["route"] == "tensor_cores"
    for pair in ((F32, F32), (F32, BF16), (BF16, F32)):
        assert tlin.launch_plan(B, E, F, *pair)["route"] == "cuda_cores"
    g = torch.Generator(device="cpu").manual_seed(B + E + F)
    x = torch.randn((B, E), generator=g).to(BF16).to(cuda)
    w = (torch.randn((E, F), generator=g) / E ** 0.5).to(BF16).to(cuda)
    before = tlin.pallas_linear.launches
    got = tlin.pallas_linear(x, w)
    torch.cuda.synchronize()
    assert tlin.pallas_linear.launches == before + 1 and got.dtype == BF16
    assert _linear_close(got, tlin.pallas_linear_plain(x, w), BF16)


@pytest.mark.parametrize("E,F", TC_LINEAR_SHAPES)
def test_pallas_linear_bf16_rows_independent(cuda, E, F):
    """A row's bf16 result is bitwise the same launched alone, among 8 and
    among 256 rows (the K split depends on (E, F) alone)."""
    g = torch.Generator(device="cpu").manual_seed(E + F)
    x = torch.randn((256, E), generator=g).to(BF16).to(cuda)
    w = (torch.randn((E, F), generator=g) / E ** 0.5).to(BF16).to(cuda)
    full = tlin.pallas_linear(x, w)
    eight = tlin.pallas_linear(x[:8].clone(), w)
    for r in (0, 5):
        one = tlin.pallas_linear(x[r:r + 1].clone(), w)
        assert torch.equal(one[0], full[r]) and torch.equal(one[0], eight[r])


def _gemv_weight(N, K, tier, g, device):
    """Weight rows [N, K] of a tier: bf16, int8 codes with fp32 row scales,
    or packed int4 (group 128) with bf16 scales, as the packers lay them."""
    w = torch.randn((N, K), generator=g) / K ** 0.5
    if tier == "fp":
        return w.to(BF16).to(device), None
    if tier == "int8":
        q, s = tlin.quantize_weight_int8(w, axis=1)
        return q.to(device), s.reshape(N).to(device)
    q = tgpt2.quantize_int4_weights(w.t().contiguous(), 128)  # [K/G, G/2, N] codes
    codes = q["q4"].permute(2, 0, 1).reshape(N, K // 2).contiguous()
    return codes.to(device), q["s"][:, 0, :].t().contiguous().to(BF16).to(device)


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



# ---------------- the single-stream Llama chain's split-KV attention (#13, #12)

SPLIT_CFGS = {  # Llama-3.2-1B's width at 2 layers (G = 4), a Qwen group of 7, head_dim 128
    "llama-3-1b-L2": "llama-3-1b",
    "g7-qwen": LLAMA_CFGS["g7-qwen"],
    "d128": LLAMA_CFGS["d128"],
}
SPLIT_WHERE = ["zero", "one", "split_last", "split_first", "last"]
_SPLIT_PARAMS, _SPLIT_PACKED = {}, {}


def _split_packed(cfg_name, wq, dtype, device):
    """(cfg, packed) of a SPLIT_CFGS model in `dtype` over model-dtype
    weights (wq None) or a weight tier quantized as from_model_name does
    (int4 at group 128, or 64 where the JAX gates refuse 128)."""
    if cfg_name not in _SPLIT_PARAMS:
        kw = SPLIT_CFGS[cfg_name]
        cfg = (dataclasses.replace(tllama.LlamaConfig.llama3_1b(), n_layer=2)
               if kw == "llama-3-1b" else _llama_cfg(cfg_name))
        _SPLIT_PARAMS[cfg_name] = (cfg, _llama_params(cfg, device))
    cfg, params = _SPLIT_PARAMS[cfg_name]
    key = (cfg_name, wq, dtype)
    if key not in _SPLIT_PACKED:
        tree = _tree_to(params, dtype)
        if wq is None:
            packed = tml.pack_llama_mega(tree, cfg)
        else:
            spec = tllama.llama_spec(cfg)
            _, mode, G = weight_quant_plan(spec, wq)
            packed = None
            for G in ((G,) if wq == "int4w8" else (G, 64)):
                packed = tml.pack_llama_mega(quantize_weights(spec, tree, mode, G), cfg)
                if packed is not None:
                    break
        assert packed is not None, key
        _SPLIT_PACKED[key] = (cfg, packed)
    return _SPLIT_PACKED[key]


def _split_length(cfg, C, where):
    """A length at an edge of the launcher's split plan: no visible row, one,
    the last row of split 0 visible last, the first row of split 1 visible
    last, or the last row of the panes written."""
    _, rows = tml.attention_plan(C, cfg.n_head, cfg.n_kv_head,
                                 torch.cuda.get_device_properties(0).multi_processor_count)
    return {"zero": 0, "one": 1, "split_last": min(rows, C - 1),
            "split_first": min(rows + 1, C - 1), "last": C - 1}[where]


def _check_llama_split_step(device, cfg_name, wq, mode, dtype, C, length):
    """The single-stream step against its plain step: fp32 tokens equal where
    the top-2 gap is at least 1e-4, bf16 within 2e-2 of the plain maximum;
    new rows within 1e-5 (fp32) / 1.6e-2 (bf16) of their largest value,
    quantized rows within one (fp32) / two (bf16) steps, fp32 scales within
    1e-5; every other row untouched; one launch counted where it belongs."""
    cfg, packed = _split_packed(cfg_name, wq, dtype, device)
    state, x = _llama_inputs(cfg, mode, C, seed=length + 11, device=device)
    state = [t.to(dtype) if t.is_floating_point() and t.dim() == 3 else t for t in state]
    x = x.to(dtype)
    got = [t.clone() for t in state]
    want = [t.clone() for t in state]
    step, plain = ((tml.llama_megastep, tml.llama_megastep_plain) if mode == "fp" else
                   (tmq.llama_megastep_quant, tmq.llama_megastep_quant_plain))
    kw = {} if mode == "fp" else {"kv_mode": mode}
    counter = step if wq is None else step.tiers[wq[:4]]
    before = counter.launches
    tok = int(step(packed, *got, length, x, cfg=cfg, **kw)[0])
    assert counter.launches == before + 1
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
