"""The port's kernel library against its plain PyTorch versions, on the card:
the rows quantize kernels (#2, #3), the fused quantized attention (#1, #4),
dequantize (#5, #6), the linear kernels (#7, #8; #7 on two bf16 operands on
the tensor cores) and paged attention (#24).

CUDA kernels have no CPU mode, so every test here needs an NVIDIA GPU: it is
marked `cuda` and skips without one. This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_ops.py

Tolerances: the quantize and dequantize kernels are bit-exact; the attention
kernel sums in another order than the plain version (fp32 atol 1e-4; bf16
atol 2e-2, the output's own rounding), also at the Llama/Qwen query groups
G = 4 and 7; the linear kernels within 1e-5 of the output's largest value in
fp32 and one bf16 ulp more in bf16; a bf16 row's bits do not depend on the
rows beside it.
"""

import pytest
import torch

from efficient_llm_inference_tpu_torch.ops import attention as tattn
from efficient_llm_inference_tpu_torch.ops import dequant as tdq
from efficient_llm_inference_tpu_torch.ops import linear as tlin
from efficient_llm_inference_tpu_torch.ops import paged as tpaged
from efficient_llm_inference_tpu_torch.ops import quantize as trows
from torch_cuda_cases import (  # noqa: F401 (cuda: the fixture)
    BF16,
    F32,
    LINEAR_SHAPES,
    TC_LINEAR_SHAPES,
    _attention_close,
    _attention_inputs,
    _linear_close,
    _paged_case,
    cuda,
)

pytestmark = pytest.mark.cuda


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
