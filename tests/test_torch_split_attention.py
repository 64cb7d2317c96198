"""The single-stream Llama step's split-KV attention (csrc/llama_megastep.cu
`split_attention_kernel`): its plan and scratch, and its arithmetic as the
plain model `ops.megakernel_llama.split_attention_plain`, on the CPU.

* `attention_plan` against a table (Llama-3.2-1B, Qwen2.5-0.5B and wider
  groups at C = 320 and 8192 on 132 and 78 SMs) and its invariants over a
  grid: the splits cover the capacity with no empty split, rows a multiple
  of 8, a group's scores within ATTN_SCORES floats; `attention_scratch` and
  `Workspace` allocate the partials and the zeroed counters it names.
* The split model against the one-pass plain attention (`attend_plain`,
  `attend_quant_plain`) at lengths on both sides of a split's edge and
  several split counts: fp32 within 2e-6 (fp32 sums in another order); for
  quantized panes with bf16 queries, where the probabilities times the V
  scales round to bf16 relative to the split's max instead of the global
  one, within 4e-3 of the largest |code x scale| (one bf16 rounding, 2^-8
  relative, of each weight).
* A Llama step whose attention is the split model against the JAX kernel
  (`llama_megastep` / `llama_megastep_quant`, Pallas interpret mode) in
  fp32: the token equal, the new K/V rows within 1e-5 of their largest
  value (quantized: codes within one step).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efficient_llm_inference_tpu.models import llama as jllama
from efficient_llm_inference_tpu.ops.pallas import megakernel_llama as jml
from efficient_llm_inference_tpu.ops.pallas import megakernel_quant as jmq
from efficient_llm_inference_tpu_torch.models import llama as tllama
from efficient_llm_inference_tpu_torch.ops import megakernel as tmk
from efficient_llm_inference_tpu_torch.ops import megakernel_llama as tml
from efficient_llm_inference_tpu_torch.ops import megakernel_quant as tmq
from torch_port_helpers import jax_rope_rows, np_llama_params, to_jax


@pytest.mark.parametrize("C,Hq,Hkv,n_sm,want", [
    (320, 32, 8, 132, (10, 32)),     # Llama-3.2-1B at the main path's capacity
    (8192, 32, 8, 132, (16, 512)),   # ... at the capacity limit: 128 blocks
    (320, 14, 2, 132, (10, 32)),     # Qwen2.5-0.5B (group 7)
    (8192, 14, 2, 132, (64, 128)),
    (8192, 32, 1, 132, (128, 64)),   # group 32: 256 rows would fit its scores
    (8192, 64, 1, 132, (128, 64)),   # group 64: at most 128 rows
    (320, 32, 8, 78, (8, 40)),       # a card of 78 SMs
    (48, 4, 2, 132, (2, 32)),
    (8, 4, 4, 132, (1, 32)),
])
def test_attention_plan_table(C, Hq, Hkv, n_sm, want):
    assert tml.attention_plan(C, Hq, Hkv, n_sm) == want


@pytest.mark.parametrize("n_sm", [1, 78, 132])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2), (32, 8), (14, 2), (96, 1)])
def test_attention_plan_invariants(Hq, Hkv, n_sm):
    G = Hq // Hkv
    for C in list(range(8, 1024, 8)) + [2040, 4096, 8000, 8192]:
        splits, rows = tml.attention_plan(C, Hq, Hkv, n_sm)
        assert rows % 8 == 0 and splits * rows >= C > (splits - 1) * rows
        assert G * rows <= tml.ATTN_SCORES
        assert rows <= tml.ATTN_MAX_ROWS
        assert rows >= min(tml.ATTN_MIN_ROWS, tml.ATTN_SCORES // G // 8 * 8)


def test_attention_scratch_and_workspace_sizes():
    cfg = tllama.LlamaConfig.llama3_1b()
    plan = tml.attention_scratch(cfg, 320, 132)
    assert plan == {"splits": 10, "rows": 32, "part": 32 * 10 * (64 + 2), "count": 8,
                    "rope": 2 * 64}
    ws = tmk.Workspace(torch.float32, "cpu", x=2048, qkv=3072, attn=2048,
                       ffn=8192, **{k: plan[k] for k in ("part", "count", "rope")})
    assert ws.attn_part.shape == (plan["part"],) and ws.attn_part.dtype == torch.float32
    assert ws.attn_count.shape == (8,) and ws.attn_count.dtype == torch.int32
    assert int(ws.attn_count.abs().sum()) == 0
    assert ws.rope.shape == (128,) and ws.rope.dtype == torch.float32
    plain = tmk.Workspace(torch.float32, "cpu", x=64, qkv=192, attn=64, ffn=256)
    assert plain.attn_part is None and plain.attn_count is None and plain.rope is None


def _attn_inputs(seed, C, Hq, Hkv, D, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    q = (torch.randn(Hq * D, generator=g) * 0.8).to(dtype)
    kc, vc = (torch.randn(2, Hkv * D, generator=g) * 0.8).to(dtype)
    k_l, v_l = torch.randn(2, C, Hkv * D, generator=g) * 0.8
    return q, kc, vc, k_l.to(dtype), v_l.to(dtype)


SPLIT_CASES = [(1, 96), (3, 32), (12, 8), (2, 48), (4, 40)]


@pytest.mark.parametrize("splits,rows", SPLIT_CASES)
@pytest.mark.parametrize("length", [0, 1, 31, 32, 33, 95, 96])
def test_split_softmax_matches_plain_attention(length, splits, rows):
    C, Hq, Hkv, D = 96, 8, 2, 64
    q, kc, vc, k_l, v_l = _attn_inputs(length + 7 * splits, C, Hq, Hkv, D)
    want = tmk.attend_plain(q, kc, vc, k_l, v_l, length, Hkv)
    got = tml.split_attention_plain(q, kc, vc, k_l, v_l, length, Hkv, splits, rows)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["int8", "int4", "mixed"])
@pytest.mark.parametrize("splits,rows", SPLIT_CASES[1:3])
@pytest.mark.parametrize("length", [1, 32, 33, 96])
def test_split_softmax_matches_plain_quant_attention(length, splits, rows, mode, dtype):
    C, Hq, Hkv, D = 96, 8, 2, 64
    KW = Hkv * D
    g = torch.Generator().manual_seed(length + splits)
    q, kc, vc, _, _ = _attn_inputs(length + 3, C, Hq, Hkv, D, dtype)
    k_kind, v_kind = tmq._kv_kinds(mode)

    def pane(kind):
        width = KW if kind == "int8" else KW // 2
        return torch.randint(-127 if kind == "int8" else -128, 128, (C, width),
                             generator=g, dtype=torch.int32).to(torch.int8)

    k_l, v_l = pane(k_kind), pane(v_kind)
    ks, vs = torch.rand(2, C, generator=g) * 0.02 + 1e-3
    want = tmq.attend_quant_plain(q, kc, vc, k_l, v_l, ks, vs, length, Hkv, k_kind, v_kind)
    got = tml.split_attention_plain(q, kc, vc, tmq.pane_values(k_l, k_kind),
                                    tmq.pane_values(v_l, v_kind), length, Hkv, splits,
                                    rows, ks=ks, vs=vs)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-6, rtol=0)
    else:
        vmax = float((tmq.pane_values(v_l, v_kind).abs() * vs[:, None]).max())
        vmax = max(vmax, float(vc.float().abs().max()))
        assert float((got - want).abs().max()) <= 4e-3 * vmax


LCFG_KW = dict(vocab_size=300, hidden_size=512, intermediate_size=1024, n_layer=2,
               n_head=8, n_kv_head=4, n_positions=512, rope_theta=10000.0,
               tie_embeddings=True)
C = 48


@pytest.fixture(scope="module")
def llama():
    jcfg, tcfg = jllama.LlamaConfig(**LCFG_KW), tllama.LlamaConfig(**LCFG_KW)
    np_params = np_llama_params(tcfg, seed=31, std=0.15)
    tparams = tllama.params_from_jax(np_params, tcfg, torch.float32, "cpu")
    return (jcfg, tcfg, jml.pack_llama_mega(to_jax(np_params), jcfg),
            tml.pack_llama_mega(tparams, tcfg))


def _state(mode, seed, L, KW, E):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((1, E)) * 0.5).astype(np.float32)
    if mode == "fp":
        return [(rng.standard_normal((L, C, KW)) * 0.5).astype(np.float32)
                for _ in range(2)], x
    panes = [rng.integers(-127 if k == "int8" else -128, 128,
                          (L, C, tmq._pane_width(k, KW))).astype(np.int8)
             for k in tmq._kv_kinds(mode)]
    return panes + [(rng.random((L, C)) * 0.02 + 1e-3).astype(np.float32)
                    for _ in range(2)], x


@pytest.mark.parametrize("splits,rows", [(3, 16), (6, 8)])
@pytest.mark.parametrize("length", [7, 16, 47])
@pytest.mark.parametrize("mode", ["fp", "int8"])
def test_split_step_matches_jax(llama, mode, length, splits, rows):
    """A Llama step (the port's plain layer chain) attending through the split
    model, against the JAX kernel in interpret mode, fp32."""
    jcfg, tcfg, jp, tp = llama
    KW = tcfg.n_kv_head * tcfg.head_dim
    state, x = _state(mode, length, tcfg.n_layer, KW, tcfg.hidden_size)
    cos_q, sin_q = jax_rope_rows(jcfg, length)
    args = [jnp.asarray(a) for a in state]
    if mode == "fp":
        j = jml.llama_megastep(jp, *args, jnp.int32(length), jnp.asarray(x), cos_q, sin_q,
                               cfg=jcfg, capacity=C, interpret=True)
    else:
        j = jmq.llama_megastep_quant(jp, *args, jnp.int32(length), jnp.asarray(x), cos_q,
                                     sin_q, cfg=jcfg, capacity=C, kv_mode=mode,
                                     interpret=True)
    t = [torch.tensor(a) for a in state]
    kinds = ("fp", "fp") if mode == "fp" else tmq._kv_kinds(mode)

    def attend(layer, q, kc, vc):
        kv = [t[i][layer] if kinds[i] == "fp" else tmq.pane_values(t[i][layer], kinds[i])
              for i in range(2)]
        sc = {} if mode == "fp" else {"ks": t[2][layer], "vs": t[3][layer]}
        return tml.split_attention_plain(q, kc, vc, *kv, length, tcfg.n_kv_head, splits,
                                         rows, **sc)

    logits, new_k, new_v = tml.llama_plain_step(tp, tcfg, torch.tensor(x),
                                                tml.rope_position(length, tcfg), attend)
    assert int(torch.argmax(logits)) == int(j[0])
    if mode == "fp":
        for got, want in ((new_k, j[1]), (new_v, j[2])):
            want = np.asarray(want)[:, length]
            atol = 1e-5 * max(1.0, np.abs(want).max())
            np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)
        return
    for i, (kind, rows_new) in enumerate(zip(kinds, (new_k, new_v))):
        for layer in range(tcfg.n_layer):
            code, scale = tmq.quantize_row(rows_new[layer], kind, 1e-8)
            want_code = torch.tensor(np.asarray(j[1 + i])[layer, length])
            assert (tmq.pane_values(code, kind) - tmq.pane_values(want_code, kind)).abs().max() <= 1
            assert math.isclose(float(scale), float(np.asarray(j[3 + i])[layer, length]),
                                rel_tol=1e-6)
