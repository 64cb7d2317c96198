"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so every test here needs an NVIDIA GPU: it is
marked `cuda` and skips without one. This file imports no JAX, so it runs on
a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: the quantize kernels are bit-exact; the attention kernel sums in
another order than the plain version (fp32 atol 1e-4; bf16 atol 2e-2, the
output's own rounding).
"""

import numpy as np
import pytest
import torch

from efficient_llm_inference_tpu_torch import Config, InferenceEngine
from efficient_llm_inference_tpu_torch.models import gpt2 as tgpt2
from efficient_llm_inference_tpu_torch.models.registry import gpt2_spec
from efficient_llm_inference_tpu_torch.ops import attention as tattn
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
