"""The weight tiers of the port's single-stream whole-step kernels (#9 and
#11 for GPT-2, #13 at R = 1 and #12 for Llama/Qwen) against the JAX
package's, on the CPU in fp32.

* The port's plain steps over quantized weights (int8; grouped int4; the
  int4w8 group, one group a half tile; the same codes and scales on both
  sides: the port's quantizers are bit-exact with JAX's,
  tests/test_torch_weight_quant.py) against the JAX kernels in interpret
  mode (the packed dict's "wscale" / "w4scale" modes): the token is equal,
  the new K/V rows agree within 1e-5 of their largest value (quantized
  panes: codes within one step, scales within 1e-5 relative: a scale is
  the row's largest value over qmax), every other row is untouched;
  lengths 0 and C - 1. The two differ in fp32 rounding only: JAX's grouped
  int4 form dots the biased nibble (v + 8) * s and subtracts 8 s sum(x),
  the port dots the raw nibble and scales the fp32 sums.
* Eligibility: the port's `mega_supported` / `mega_quant_supported`
  against JAX's over weight modes, int4 groups and widths, each cell where
  they differ named with its reason.
* The packed layout: code rows in the model's own nibble order, scales in
  the model dtype for int4, gate and up interleaved with their scales.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_llm_inference_tpu.models import gpt2 as jgpt2
from efficient_llm_inference_tpu.models import llama as jllama
from efficient_llm_inference_tpu.ops.pallas import megakernel as jmk
from efficient_llm_inference_tpu.ops.pallas import megakernel_llama as jml
from efficient_llm_inference_tpu.ops.pallas import megakernel_quant as jmq
from efficient_llm_inference_tpu_torch.models import gpt2 as tgpt2
from efficient_llm_inference_tpu_torch.models import llama as tllama
from efficient_llm_inference_tpu_torch.ops import megakernel as tmk
from efficient_llm_inference_tpu_torch.ops import megakernel_llama as tml
from efficient_llm_inference_tpu_torch.ops import megakernel_quant as tmq
from torch_port_helpers import (
    jax_rope_rows,
    np_gpt2_params,
    np_llama_params,
    quantized_pair,
)

GPT2_KW = dict(vocab_size=300, n_positions=256, n_embd=128, n_layer=2, n_head=2)
LLAMA_KW = dict(vocab_size=300, hidden_size=256, intermediate_size=512, n_layer=2,
                n_head=4, n_kv_head=2, n_positions=512, rope_theta=10000.0,
                tie_embeddings=True)
C = 48
# weight_quant -> (mode, group): GPT-2 at E = 128 (int4w8's group E/2 is 64,
# the int4 group that E = 128 takes); Llama's tile TR = 256, so int4 at 64
# runs JAX's grouped form (two groups a half tile) and int4w8 at 128 its
# one-group-a-half-tile form.
GPT2_WQ = {"int8": ("int8", 128), "int4": ("int4", 64)}
LLAMA_WQ = {"int8": ("int8", 128), "int4": ("int4", 64), "int4w8": ("int4", 128)}


@pytest.fixture(scope="module")
def gpt2_models():
    jcfg, tcfg = jgpt2.GPT2Config(**GPT2_KW), tgpt2.GPT2Config(**GPT2_KW)
    np_p = np_gpt2_params(tcfg, seed=11, std=0.1)
    out = {}
    for wq, (mode, group) in GPT2_WQ.items():
        jq, tq = quantized_pair(np_p, tcfg, "gpt2", mode, group)
        out[wq] = (jmk.pack_gpt2_mega(jq, jcfg), tmk.pack_gpt2_mega(tq, tcfg))
    return jcfg, tcfg, out


@pytest.fixture(scope="module")
def llama_models():
    jcfg, tcfg = jllama.LlamaConfig(**LLAMA_KW), tllama.LlamaConfig(**LLAMA_KW)
    np_p = np_llama_params(tcfg, seed=11, std=0.15)
    out = {}
    for wq, (mode, group) in LLAMA_WQ.items():
        jq, tq = quantized_pair(np_p, tcfg, "llama", mode, group)
        out[wq] = (jml.pack_llama_mega(jq, jcfg), tml.pack_llama_mega(tq, tcfg))
    return jcfg, tcfg, out


def _state(mode: str, seed: int, L: int, W: int, E: int):
    """Panes of `mode` ("fp", or the KV kinds of int8/int4/mixed), per-token
    scales and an embedding, from a seed."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((1, E)) * 0.5).astype(np.float32)
    if mode == "fp":
        return [(rng.standard_normal((L, C, W)) * 0.5).astype(np.float32)
                for _ in range(2)], x

    def pane(kind):
        lo = -127 if kind == "int8" else -128
        return rng.integers(lo, 128, (L, C, tmq._pane_width(kind, W))).astype(np.int8)

    def scales():
        return (rng.random((L, C)) * 0.02 + 1e-3).astype(np.float32)

    k_kind, v_kind = tmq._kv_kinds(mode)
    return [pane(k_kind), pane(v_kind), scales(), scales()], x


def _check(mode, length, j, t, state):
    """Token equal, new rows close, every other row untouched."""
    assert int(t[0]) == int(j[0])
    others = np.arange(C) != length
    for got, want, before in zip(t[1:], j[1:], state):
        np.testing.assert_array_equal(got[:, others], want[:, others])
        np.testing.assert_array_equal(got[:, others], before[:, others])
    if mode == "fp":
        for got, want, before in zip(t[1:], j[1:], state):
            atol = 1e-5 * max(1.0, np.abs(want[:, length]).max())
            np.testing.assert_allclose(got[:, length], want[:, length], atol=atol, rtol=0)
            assert not np.array_equal(got[:, length], before[:, length])
        return
    for kind, got, want in zip(tmq._kv_kinds(mode), t[1:3], j[1:3]):
        g = tmq.pane_values(torch.tensor(got[:, length]), kind).numpy()
        w = tmq.pane_values(torch.tensor(want[:, length]), kind).numpy()
        assert np.abs(g - w).max() <= 1 and (g != w).mean() < 0.02
    for got, want in zip(t[3:], j[3:]):
        np.testing.assert_allclose(got[:, length], want[:, length], rtol=1e-5, atol=0)


# (weights, panes, length): #9 / #13 over fp panes at both lengths for every
# weight tier, #11 / #12 over each quantized pane kind
GPT2_CASES = [("int8", "fp", 0), ("int8", "fp", C - 1), ("int4", "fp", 0),
              ("int4", "fp", C - 1), ("int8", "int8", C - 1), ("int4", "int4", 0),
              ("int4", "mixed", C - 1)]
LLAMA_CASES = [("int8", "fp", 0), ("int8", "fp", C - 1), ("int4", "fp", 0),
               ("int4", "fp", C - 1), ("int4w8", "fp", 0), ("int4w8", "fp", C - 1),
               ("int8", "mixed", 0), ("int4", "int8", C - 1), ("int4w8", "int4", C - 1)]


@pytest.mark.parametrize("wq,mode,length", GPT2_CASES)
def test_gpt2_tier_steps_match_jax(gpt2_models, wq, mode, length):
    jcfg, tcfg, packed = gpt2_models
    jp, tp = packed[wq]
    assert "wscale" in jp if wq == "int8" else "w4scale" in jp
    state, x = _state(mode, length + 31, tcfg.n_layer, tcfg.n_embd, tcfg.n_embd)
    args = (jnp.int32(length), jnp.asarray(x))
    t_in = [torch.tensor(a) for a in state]
    if mode == "fp":
        j = jmk.gpt2_megastep(jp, *(jnp.asarray(a) for a in state), *args, cfg=jcfg,
                              capacity=C, interpret=True)
        t = tmk.gpt2_megastep(tp, *t_in, length, torch.tensor(x), cfg=tcfg)
    else:
        j = jmq.gpt2_megastep_quant(jp, *(jnp.asarray(a) for a in state), *args,
                                    cfg=jcfg, capacity=C, kv_mode=mode, interpret=True)
        t = tmq.gpt2_megastep_quant(tp, *t_in, length, torch.tensor(x), cfg=tcfg,
                                    kv_mode=mode)
    assert all(a is b for a, b in zip(t[1:], t_in))  # written in place
    _check(mode, length, [np.asarray(a) for a in j], [a.numpy() for a in t], state)


@pytest.mark.parametrize("wq,mode,length", LLAMA_CASES)
def test_llama_tier_steps_match_jax(llama_models, wq, mode, length):
    jcfg, tcfg, packed = llama_models
    jp, tp = packed[wq]
    KW = tcfg.n_kv_head * tcfg.head_dim
    state, x = _state(mode, length + 41, tcfg.n_layer, KW, tcfg.hidden_size)
    cos_q, sin_q = jax_rope_rows(jcfg, length)
    args = (jnp.int32(length), jnp.asarray(x), cos_q, sin_q)
    t_in = [torch.tensor(a) for a in state]
    if mode == "fp":
        j = jml.llama_megastep(jp, *(jnp.asarray(a) for a in state), *args, cfg=jcfg,
                               capacity=C, interpret=True)
        t = tml.llama_megastep(tp, *t_in, length, torch.tensor(x), cfg=tcfg)
    else:
        j = jmq.llama_megastep_quant(jp, *(jnp.asarray(a) for a in state), *args,
                                     cfg=jcfg, capacity=C, kv_mode=mode, interpret=True)
        t = tmq.llama_megastep_quant(tp, *t_in, length, torch.tensor(x), cfg=tcfg,
                                     kv_mode=mode)
    assert all(a is b for a, b in zip(t[1:], t_in))
    _check(mode, length, [np.asarray(a) for a in j], [a.numpy() for a in t], state)


# ---------------------------------------------------------------- the layout


def test_llama_pack_layout(llama_models):
    """Code rows of the model's nibble order ([out, in/2]: byte j = inputs 2j
    and 2j + 1), scales [out, in/G] in the model dtype, gate and up rows and
    scales interleaved, the LM head from the quantized copy; the int8 tier's
    scales fp32 [out]."""
    _, tcfg, packed = llama_models
    tp4, tp8 = packed["int4"][1], packed["int8"][1]
    E, I = tcfg.hidden_size, tcfg.intermediate_size
    assert tp4["gu_w"].shape == (2, 2 * I, E // 2) and tp4["gu_w"].dtype == torch.uint8
    assert tp4["gu_s"].shape == (2, 2 * I, E // 64) and tp4["gu_s"].dtype == torch.float32
    assert tp4["head"].shape == (300, E // 2) and tp4["head_s"].shape == (300, E // 64)
    assert tp8["qkv_s"].shape == (2, 512) and tp8["head_s"].shape == (300,)
    assert tmk.weight_kind(tp4) == "int4" and tmk.weight_kind(tp8) == "int8"
    assert tmk.weight_group(tp4, "down_w") == 64
    # the plain int4 dot equals the dequantized weights' product
    codes = tgpt2._unpack_nibbles(tp4["gu_w"][0])  # (even, odd) inputs
    v = torch.stack(codes, dim=-1).reshape(2 * I, E).float()
    w = v * tp4["gu_s"][0].repeat_interleave(64, dim=-1)
    h = torch.randn(E)
    torch.testing.assert_close(tmk.int4_rows_dot(h, tp4["gu_w"][0], tp4["gu_s"][0]),
                               w @ h, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- eligibility

# Cells where the port's eligibility differs from JAX's, with the reason:
# the kernels read 32 int4 codes (16 bytes) a load within one scale group.
PORT_ONLY = "G % 32 != 0: a 16-byte load of 32 int4 codes would straddle two groups"


def _gpt2_tree(E: int, wq: str, group: int):
    """(cfg, JAX tree, port tree) of a one-layer GPT-2 of width E."""
    cfg = tgpt2.GPT2Config(vocab_size=64, n_positions=64, n_embd=E, n_layer=1, n_head=2)
    return (cfg, *quantized_pair(np_gpt2_params(cfg, seed=E + group), cfg, "gpt2", wq, group))


def _gpt2_cells():
    for E in (128, 256):
        for wq, group in [("fp", 0), ("int8", 0)] + [("int4", g) for g in
                                                     (16, 64, 128, E // 2)]:
            yield E, wq, group


def test_gpt2_eligibility_table_matches_jax():
    table = {}
    for E, wq, group in _gpt2_cells():
        cfg, jq, tq = _gpt2_tree(E, wq, group)
        for kv in ("fp", "int8", "int4", "mixed"):
            if kv == "fp":
                want, got = jmk.mega_supported(cfg, C, jq), tmk.mega_supported(cfg, C, tq)
            else:
                want = jmq.mega_quant_supported(cfg, C, jq, kv)
                got = tmq.mega_quant_supported(cfg, C, tq, kv)
            table[(E, wq, group, kv)] = (want, got)
    differ = {key for key, (want, got) in table.items() if want != got}
    port_only = {key for key in table if key[2] == 16 and table[key][0]}
    assert differ == port_only, sorted(differ ^ port_only)
    assert all(table[key] == (True, False) for key in differ)  # only the port refuses
    # JAX's structural gate: int4 at E = 128, G = 128 splits a group across
    # the half tiles ((E/2) % G), so both send it to the megakernel-off path
    assert table[(128, "int4", 128, "fp")] == (False, False)
    assert table[(256, "int4", 128, "fp")] == (True, True)
    assert table[(128, "int4", 64, "fp")] == (True, True)
    # int4 panes need (E/2) % 128 == 0 whatever the weights
    assert table[(128, "int8", 0, "int4")] == (False, False)
    assert table[(256, "int8", 0, "mixed")] == (True, True)


def test_gpt2_eligibility_of_partial_and_headless_trees():
    cfg, jfp, tfp = _gpt2_tree(128, "fp", 0)
    jmix, tmix = dict(jfp), dict(tfp)  # a partly quantized tree has no weight mode
    jmix["blocks"] = dict(jfp["blocks"], fc_w=jgpt2.quantize_int8_weights(
        jfp["blocks"]["fc_w"]))
    tmix["blocks"] = dict(tfp["blocks"], fc_w=tgpt2.quantize_int8_weights(
        tfp["blocks"]["fc_w"]))
    assert not jmk.mega_supported(cfg, C, jmix) and not tmk.mega_supported(cfg, C, tmix)
    assert tmk.pack_gpt2_mega(tmix, cfg) is None
    jq8 = jgpt2.quantize_gpt2_weights(jfp)
    tq8 = tgpt2.quantize_gpt2_weights(tfp)
    for tree in (jq8, tq8):  # int8 blocks without the LM head's copy
        del tree["lm_q"], tree["lm_s"]
    assert not jmk.mega_supported(cfg, C, jq8) and not tmk.mega_supported(cfg, C, tq8)


def test_llama_eligibility_table_matches_jax():
    """The small Llama (TR = 256) and a Qwen shape with a 128-row tile,
    over weight modes and int4 groups (16, 64, 128, TR/2), fp and int4
    panes."""
    qwen_kw = dict(LLAMA_KW, hidden_size=896, n_head=14, n_kv_head=2, qkv_bias=True,
                   intermediate_size=1024)
    table = {}
    for name, kw in (("llama", LLAMA_KW), ("qwen", qwen_kw)):
        jcfg, tcfg = jllama.LlamaConfig(**kw), tllama.LlamaConfig(**kw)
        np_p = np_llama_params(tcfg, seed=5)
        TR = tml._tile_geometry(tcfg)[0]
        for wq, group in [("fp", 0), ("int8", 0)] + [("int4", g) for g in
                                                     (16, 64, 128, TR // 2)]:
            jq, tq = quantized_pair(np_p, tcfg, "llama", wq, group)
            for kv in ("fp", "int4"):
                if kv == "fp":
                    want = jml.mega_supported(jcfg, C, jq)
                    got = tml.mega_supported(tcfg, C, tq)
                else:
                    want = jmq.llama_mega_quant_supported(jcfg, C, jq, kv)
                    got = tmq.llama_mega_quant_supported(tcfg, C, tq, kv)
                table[(name, wq, group, kv)] = (want, got)
    differ = {key for key, (want, got) in table.items() if want != got}
    port_only = {key for key in table if key[2] == 16 and table[key][0]}
    assert differ == port_only, sorted(differ ^ port_only)
    assert all(table[key] == (True, False) for key in differ)
    # Qwen's 128-row tile: int4 at G = 128 splits a group across the half
    # tiles, so both refuse it; its int4w8 group TR/2 = 64 is eligible
    assert table[("qwen", "int4", 128, "fp")] == (False, False)
    assert table[("qwen", "int4", 64, "fp")] == (True, True)
    assert table[("llama", "int4", 128, "fp")] == (True, True)
    # KW = 128: int4 panes (64 lanes) are refused whatever the weights
    assert table[("llama", "int8", 0, "int4")] == (False, False)
