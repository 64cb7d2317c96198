"""The weight tiers of the port's verify and batched kernels (#10, #13 at
R > 1, #14-#17, #18-#21) against the JAX package's, on the CPU in fp32.

* The port's plain versions over quantized weights (int8; grouped int4 at
  G = 64; int4w8, one group a half tile, G = 128; the same codes and scales
  on both sides: the port's quantizers are bit-exact with JAX's,
  tests/test_torch_weight_quant.py) against the JAX kernels in interpret
  mode (the packed dict's "wscale" / "w4scale" modes), one small geometry a
  family (GPT-2: E = 256, 2 layers; Llama: E = 256, 2 layers, 4 query heads
  on 2), B x R <= 2 x 4 rows, the weight tiers spread over fp / int8 /
  int4 / mixed panes: the tokens are equal; the new K/V rows agree within
  1e-5 of their largest value (quantized panes: codes within one step,
  scales within 1e-5 relative, a scale being the row's largest value over
  qmax); every other row is bit-identical and unchanged. The two differ in
  fp32 rounding only (JAX's grouped int4 form dots the biased nibble; the
  port scales the fp32 sums of the raw codes).
* The packing: the verify and batched launchers' args structs carry the
  weight tier's fields of the single-stream struct, and the plain verify is
  R plain tier steps.
* Eligibility: the port's batched and batched-verify gates against JAX's
  over weight modes and int4 groups, the one named difference G % 32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_llm_inference_tpu.models import gpt2 as jgpt2
from efficient_llm_inference_tpu.models import llama as jllama
from efficient_llm_inference_tpu.models.llama import rope_cos_sin
from efficient_llm_inference_tpu.ops.pallas import megakernel as jmk
from efficient_llm_inference_tpu.ops.pallas import megakernel_batch as jmb
from efficient_llm_inference_tpu.ops.pallas import megakernel_batch_quant as jmbq
from efficient_llm_inference_tpu.ops.pallas import megakernel_batch_verify as jbv
from efficient_llm_inference_tpu.ops.pallas import megakernel_llama as jml
from efficient_llm_inference_tpu_torch.models import gpt2 as tgpt2
from efficient_llm_inference_tpu_torch.models import llama as tllama
from efficient_llm_inference_tpu_torch.ops import megakernel as tmk
from efficient_llm_inference_tpu_torch.ops import megakernel_batch as tmb
from efficient_llm_inference_tpu_torch.ops import megakernel_batch_quant as tmbq
from efficient_llm_inference_tpu_torch.ops import megakernel_batch_verify as tbv
from efficient_llm_inference_tpu_torch.ops import megakernel_llama as tml
from efficient_llm_inference_tpu_torch.ops import megakernel_quant as tmq
from torch_port_helpers import np_gpt2_params, np_llama_params, quantized_pair

GPT2_KW = dict(vocab_size=300, n_positions=256, n_embd=256, n_layer=2, n_head=2)
LLAMA_KW = dict(vocab_size=300, hidden_size=256, intermediate_size=512, n_layer=2,
                n_head=4, n_kv_head=2, n_positions=512, rope_theta=10000.0,
                tie_embeddings=True)
# weight_quant -> (mode, group); Llama's tile TR = 256: int4 at 64 runs
# JAX's grouped form, int4w8 at TR/2 = 128 its one-group-a-half-tile form
WQ = {"int8": ("int8", 0), "int4": ("int4", 64), "int4w8": ("int4", 128)}
C = 48


@functools.lru_cache(maxsize=None)
def _packs(family: str, wq: str):
    """(JAX cfg, port cfg, JAX packed, port packed, pane width, E)."""
    mode, group = WQ[wq]
    if family == "gpt2":
        jcfg, tcfg = jgpt2.GPT2Config(**GPT2_KW), tgpt2.GPT2Config(**GPT2_KW)
        jq, tq = quantized_pair(np_gpt2_params(tcfg, seed=51, std=0.1), tcfg, family,
                                mode, group)
        return (jcfg, tcfg, jmk.pack_gpt2_mega(jq, jcfg), tmk.pack_gpt2_mega(tq, tcfg),
                tcfg.n_embd, tcfg.n_embd)
    jcfg, tcfg = jllama.LlamaConfig(**LLAMA_KW), tllama.LlamaConfig(**LLAMA_KW)
    jq, tq = quantized_pair(np_llama_params(tcfg, seed=53, std=0.15), tcfg, family, mode,
                            group)
    return (jcfg, tcfg, jml.pack_llama_mega(jq, jcfg), tml.pack_llama_mega(tq, tcfg),
            tcfg.n_kv_head * tcfg.head_dim, tcfg.hidden_size)


def _state(mode: str, seed: int, lead: tuple, W: int, rows: int, E: int):
    """Panes [L, *lead, C, W] of `mode` (codes and [L, *lead, C] scales for
    the quantized kinds) and input rows [rows, E]."""
    rng = np.random.default_rng(seed)
    L = 2
    x = (rng.standard_normal((rows, E)) * 0.5).astype(np.float32)
    if mode == "fp":
        return [(rng.standard_normal((L, *lead, C, W)) * 0.5).astype(np.float32)
                for _ in range(2)], x

    def pane(kind):
        lo = -127 if kind == "int8" else -128
        return rng.integers(lo, 128, (L, *lead, C, tmq._pane_width(kind, W))).astype(np.int8)

    def scales():
        return (rng.random((L, *lead, C)) * 0.02 + 1e-3).astype(np.float32)

    k_kind, v_kind = tmq._kv_kinds(mode)
    return [pane(k_kind), pane(v_kind), scales(), scales()], x


def _rope(jcfg, positions):
    """cos_q/sin_q [n, Hq*D] of positions min(p, P - 1), as the JAX engine
    and server build them (under jit)."""
    @jax.jit
    def rows(pos):
        pos = jnp.minimum(pos, jcfg.n_positions - 1)
        cos, sin = rope_cos_sin(pos[None], jcfg.head_dim, jcfg.rope_theta)
        return jnp.tile(cos[0], (1, jcfg.n_head)), jnp.tile(sin[0], (1, jcfg.n_head))

    return rows(jnp.asarray(positions, jnp.int32))


def _check(mode, lengths, R, tok_t, tok_j, got, want, before):
    """Tokens equal; columns outside each slot's R new ones bit-identical
    and unchanged; new fp rows within 1e-5 of their largest value, new codes
    within one step, new scales within rtol 1e-5. Panes are [L, B, C, ...]."""
    np.testing.assert_array_equal(tok_t.numpy().reshape(-1), np.asarray(tok_j).reshape(-1))
    kinds = ("fp", "fp") if mode == "fp" else tmq._kv_kinds(mode)
    for i, (g, w, b0) in enumerate(zip(got, want, before)):
        for b, cur in enumerate(lengths):
            new = np.zeros(C, bool)
            new[cur:cur + R] = True
            np.testing.assert_array_equal(g[:, b, ~new], w[:, b, ~new])
            np.testing.assert_array_equal(g[:, b, ~new], b0[:, b, ~new])
            gn, wn = g[:, b, new], w[:, b, new]
            if mode == "fp":
                atol = 1e-5 * max(1.0, np.abs(wn).max())
                np.testing.assert_allclose(gn, wn, atol=atol, rtol=0)
                assert not np.array_equal(gn, b0[:, b, new])
            elif i < 2:
                gv = tmq.pane_values(torch.tensor(gn), kinds[i]).numpy()
                wv = tmq.pane_values(torch.tensor(wn), kinds[i]).numpy()
                assert np.abs(gv - wv).max() <= 1 and (gv != wv).mean() < 0.02
            else:
                np.testing.assert_allclose(gn, wn, rtol=1e-5, atol=0)


def _run(kernel: str, family: str, wq: str, mode: str, lengths, R: int, seed: int):
    """One JAX kernel in interpret mode and the port's wrapper (its plain
    version on CPU tensors) on the same inputs; checked by `_check`.
    kernel: "verify" (#10 / #13 at R > 1, one sequence at lengths[0]),
    "batch" (#14-#17, R = 1) or "batch_verify" (#18-#21)."""
    jcfg, tcfg, jpk, tpk, W, E = _packs(family, wq)
    assert ("wscale" in jpk) == (wq == "int8") and ("w4scale" in jpk) == (wq != "int8")
    assert tmk.weight_kind(tpk) == wq[:4]
    B = len(lengths)
    lead = () if kernel == "verify" else (B,)
    state, x = _state(mode, seed, lead, W, B * R, E)
    jin = [jnp.asarray(a) for a in state]
    t_in = [torch.tensor(a) for a in state]
    positions = [n + t for n in lengths for t in range(R)]
    rope = _rope(jcfg, positions) if family == "llama" else ()
    kw = dict(cfg=jcfg, capacity=C, interpret=True)
    tkw = {}
    if mode != "fp":
        kw["kv_mode"] = tkw["kv_mode"] = mode
    llama = family == "llama"
    if kernel == "verify":
        jfn = jml.llama_megaverify if llama else jmk.gpt2_megaverify
        tfn = tml.llama_megaverify if llama else tmk.gpt2_megaverify
        j = jfn(jpk, *jin, jnp.int32(lengths[0]), jnp.asarray(x), *rope, **kw)
        t = tfn(tpk, *t_in, lengths[0], torch.tensor(x), cfg=tcfg)
        j, t = [j[0], *(a[:, None] for a in j[1:])], [t[0], *(a[:, None] for a in t[1:])]
    elif kernel == "batch":
        names = {("gpt2", False): (jmb.gpt2_megabatch, tmb.gpt2_megabatch),
                 ("gpt2", True): (jmbq.gpt2_megabatch_quant, tmbq.gpt2_megabatch_quant),
                 ("llama", False): (jmb.llama_megabatch, tmb.llama_megabatch),
                 ("llama", True): (jmbq.llama_megabatch_quant, tmbq.llama_megabatch_quant)}
        jfn, tfn = names[(family, mode != "fp")]
        j = jfn(jpk, *jin, jnp.asarray(lengths, jnp.int32), jnp.asarray(x), *rope, **kw)
        t = tfn(tpk, *t_in, torch.tensor(lengths, dtype=torch.int32), torch.tensor(x),
                cfg=tcfg, **tkw)
    else:
        suffix = "" if mode == "fp" else "_quant"
        name = f"{'llama' if llama else 'gpt2'}_megabatch_verify{suffix}"
        j = getattr(jbv, name)(jpk, *jin, jnp.asarray(lengths, jnp.int32), jnp.asarray(x),
                               *rope, rows=R, **kw)
        t = getattr(tbv, name)(tpk, *t_in, torch.tensor(lengths, dtype=torch.int32),
                               torch.tensor(x), cfg=tcfg, **tkw)
    got = [a.numpy() for a in t[1:]]
    before = [a if kernel != "verify" else a[:, None] for a in state]
    _check(mode, lengths, R, t[0], j[0], got, [np.asarray(a) for a in j[1:]], before)


# (kernel, family, weights, panes, lengths, R): every kernel and weight tier,
# the pane kinds spread over them (Llama's KW = 128 takes no int4 pane)
CASES = [
    ("verify", "gpt2", "int8", "fp", (7,), 4),              # #10
    ("verify", "gpt2", "int4", "fp", (0,), 4),
    ("verify", "llama", "int8", "fp", (5,), 4),             # #13, R > 1
    ("verify", "llama", "int4w8", "fp", (C - 12,), 4),
    ("batch", "gpt2", "int4w8", "fp", (0, C - 1), 1),        # #14
    ("batch", "llama", "int4", "fp", (0, C - 1), 1),         # #15
    ("batch", "gpt2", "int8", "int4", (C - 1, 0), 1),        # #16
    ("batch", "gpt2", "int4", "mixed", (0, C - 1), 1),
    ("batch", "llama", "int8", "int8", (0, C - 1), 1),       # #17
    ("batch_verify", "gpt2", "int4", "fp", (0, 29), 4),      # #18
    ("batch_verify", "gpt2", "int8", "mixed", (3, 32), 2),   # #19
    ("batch_verify", "llama", "int8", "fp", (32, 0), 4),     # #20
    ("batch_verify", "llama", "int4w8", "int8", (0, 29), 2),  # #21
    ("batch_verify", "llama", "int4", "int8", (7, 32), 4),
]


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=["-".join(map(str, c[:4])) + f"-R{c[5]}" for c in CASES])
def test_tier_kernels_plain_match_jax(case):
    kernel, family, wq, mode, lengths, R = CASES[case]
    _run(kernel, family, wq, mode, list(lengths), R, seed=60 + case)


# ---------------------------------------------------------------- packing


def test_launcher_structs_carry_the_weight_tier():
    """Every verify and batched args struct carries the single-stream
    struct's fields, ending with its weight-tier fields, after its leading
    rows / batch fields; the batched verify's and the batched Llama step's
    then end with their bf16 chain's tensor-core scratch (the C structs'
    trailing fields), the Llama verify's after its split attention's plan
    and scratch; GPT-2's batched step and verify are the single stream's
    persistent-step struct (its grid, attention plan and scratch after the
    weight tier) with B or R last."""
    tc = [f[0] for f in tbv.TC_FIELDS]
    step_tail = [f[0] for f in tmk.Gpt2StepArgs._fields_]
    assert tc == ["xn", "tc_part", "tc_part_len", "tc_count"]
    tc_step = [f[0] for f in tmb.TC_FIELDS]
    assert tc_step == ["tc_part", "tc_part_len", "tc_count", "tc_count_len"]
    for struct, lead, base, tail in (
            (tmk.GPT2VerifyArgs, [], tmk.MegaStepArgs, step_tail + ["rows"]),
            (tml.LlamaVerifyArgs, ["rows"], tml.LlamaStepArgs,
             ["attn_splits", "attn_rows", "attn_part", "attn_count"] + tc_step),
            (tmb.GPT2BatchArgs, [], tmk.MegaStepArgs, step_tail + ["batch"]),
            (tmb.LlamaBatchArgs, ["batch"], tml.LlamaStepArgs, tc_step),
            (tbv.GPT2BatchVerifyArgs, ["batch", "rows"], tmk.MegaStepArgs, tc),
            (tbv.LlamaBatchVerifyArgs, ["batch", "rows"], tml.LlamaStepArgs, tc)):
        # a ctypes subclass lists its own fields: the struct's are its bases' first
        names = [f[0] for c in reversed(struct.__mro__) for f in vars(c).get("_fields_", [])]
        assert names == lead + [f[0] for f in base._fields_] + tail, struct
        assert {"w_kind", "w_group", "head_s"} <= set(names)
        assert names[-len(tail) - 1] == "head_s"


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_plain_verify_is_tier_steps(family):
    """The plain verify over a quantized pack is R plain tier steps: the
    same tokens, logits and rows (the kernels' function)."""
    _, tcfg, _, tpk, W, E = _packs(family, "int4")
    state, x = _state("fp", 5, (), W, 4, E)
    k1, v1 = (torch.tensor(a) for a in state)
    k2, v2 = k1.clone(), v1.clone()
    verify = tml.llama_megaverify_plain if family == "llama" else tmk.gpt2_megaverify_plain
    step = tml.llama_megastep_plain if family == "llama" else tmk.gpt2_megastep_plain
    toks, _, _, logits = verify(tpk, k1, v1, 9, torch.tensor(x), cfg=tcfg,
                                return_logits=True)
    for t in range(4):
        tok, _, _, lg = step(tpk, k2, v2, 9 + t, torch.tensor(x[t:t + 1]), cfg=tcfg,
                             return_logits=True)
        assert int(tok) == int(toks[t]) and torch.equal(lg, logits[t])
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


# ------------------------------------------------------------ eligibility

PORT_ONLY = "G % 32 != 0: a 16-byte load of 32 int4 codes would straddle two groups"


def _gate_table(family: str) -> dict:
    """(weights, group, gate) -> (JAX, port) over the batched step and
    batched-verify gates (fp and int8 panes, B = 2, R = 4) for the small
    geometry of `family`."""
    table = {}
    if family == "gpt2":
        jcfg, tcfg = jgpt2.GPT2Config(**GPT2_KW), tgpt2.GPT2Config(**GPT2_KW)
        np_p = np_gpt2_params(tcfg, seed=3)
        gates = {"batch": (jmb.mega_batch_supported, tmb.mega_batch_supported),
                 "batch_quant": (jmbq.mega_batch_quant_supported,
                                 tmbq.mega_batch_quant_supported),
                 "verify": (jbv.mega_batch_verify_supported, tbv.mega_batch_verify_supported),
                 "verify_quant": (jbv.mega_batch_verify_quant_supported,
                                  tbv.mega_batch_verify_quant_supported)}
    else:
        jcfg, tcfg = jllama.LlamaConfig(**LLAMA_KW), tllama.LlamaConfig(**LLAMA_KW)
        np_p = np_llama_params(tcfg, seed=3)
        gates = {"batch": (jmb.llama_mega_batch_supported, tmb.llama_mega_batch_supported),
                 "batch_quant": (jmbq.llama_mega_batch_quant_supported,
                                 tmbq.llama_mega_batch_quant_supported),
                 "verify": (jbv.llama_mega_batch_verify_supported,
                            tbv.llama_mega_batch_verify_supported),
                 "verify_quant": (jbv.llama_mega_batch_verify_quant_supported,
                                  tbv.llama_mega_batch_verify_quant_supported)}
    for wq, group in [("fp", 0), ("int8", 0)] + [("int4", g) for g in (16, 64, 128, 256)]:
        jq, tq = quantized_pair(np_p, tcfg, family, wq, group)
        for name, (jg, tg) in gates.items():
            args = {"batch": (2,), "batch_quant": (2, "int8"), "verify": (2, 4),
                    "verify_quant": (2, 4, "int8")}[name]
            table[(wq, group, name)] = (jg(jcfg, C, jq, *args), tg(tcfg, C, tq, *args))
    return table


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_batch_gates_over_weight_tiers_match_jax(family):
    """The batched and batched-verify gates take the JAX package's weight
    gates; the port refuses only an int4 group G % 32 != 0 (PORT_ONLY)."""
    table = _gate_table(family)
    differ = {key for key, (want, got) in table.items() if want != got}
    assert differ == {key for key in table if key[1] == 16}, sorted(differ)
    assert all(table[key] == (True, False) for key in differ)
    for wq, group in (("fp", 0), ("int8", 0), ("int4", 64), ("int4", 128)):
        for gate in ("batch", "batch_quant", "verify", "verify_quant"):
            assert table[(wq, group, gate)] == (True, True), (wq, group, gate)
    # G = 256: one group spans E (GPT-2: (E/2) % G; Llama: (TR/2) % G), refused
    # by both
    assert table[("int4", 256, "batch")] == (False, False)
