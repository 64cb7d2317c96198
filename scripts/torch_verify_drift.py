#!/usr/bin/env python3
"""How far the batched verify kernels' bf16 tokens and rows drift from their
plain versions, beside the single-stream kernels on the same rows.

    python3 scripts/torch_verify_drift.py [--past-128]

On one GPU, at chip_smoke.py's batched-verify shapes (GPT-2 small on 16
slots, Llama-3.2-1B on 8; R in {2, 8} rows a slot; C = 128; slot lengths 0,
7, 8, 55, 112 repeated; fp/int8/int4/mixed panes; bf16; random weights from
seed 42), for chip_smoke.py's input seeds and for a second set (+1000):

- the batched verify (#18-#21) is held as chip_smoke.py holds it: fp panes
  against the plain batched verify, quantized panes row by row against the
  plain step on the kernel's own earlier rows;
- the witness is the single-stream kernel on the same rows: the verify
  kernel #10 / #13 on slot b's pane (fp), or the whole-step quant kernel
  #11 / #12 at lengths[b] + t on the batched kernel's earlier rows
  (quantized panes);
- then the bf16 cases of tests/test_torch_cuda_verify.py's
  test_megabatch_verify_matches_plain (its three geometries, B in {1, 3,
  16}, R in {2, 5, 8}), inputs built as the test builds them;
- per case one JSON line: each token's shortfall under the plain maximum
  logit (quantiles and the count past 2e-2 and 4e-2) for both, how many
  tokens and new rows the two kernels share bit for bit, and the largest
  new-row difference from the plain version as a share of phase 2's
  tolerance (fp: 1.6e-2 of the row's largest value; quantized: two steps).

With --past-128, only chip_smoke.py's cases past the old 128-row limit
(R = 8: GPT-2 small int8 panes on 32 slots and fp panes on 24, Llama-3.2-1B
fp panes on 24), both seed sets; over fp panes each line adds the bf16
control: the fp32 plain verify on the same values (weights and panes
widened) and its token's shortfall under the bf16 plain maximum logit, the
shortfall a token right in fp32 arithmetic shows under chip_smoke.py's rule.

The card's name and power limit first.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

DEV = "cuda"


def _quantiles(x: torch.Tensor) -> dict:
    q = torch.quantile(x, torch.tensor([0.5, 0.9, 0.99])).tolist()
    return {"p50": q[0], "p90": q[1], "p99": q[2], "max": float(x.max()),
            "over_2e-2": int((x > 2e-2).sum()), "over_4e-2": int((x > 4e-2).sum())}


def _row_share(mode, got, want, r) -> float:
    """max |got - want| of row r (dequantized) over phase 2's bf16 tolerance."""
    from efficient_llm_inference_tpu_torch.ops import megakernel_quant as mq

    if mode == "fp":
        return max(float((g[:, r].float() - w[:, r].float()).abs().max())
                   / (1.6e-2 * max(float(w[:, r].float().abs().max()), 1.0))
                   for g, w in zip(got, want))
    share = 0.0
    for kind, g, w, gs, ws in zip(mq._kv_kinds(mode), got[:2], want[:2], got[2:], want[2:]):
        gv = mq.pane_values(g[:, r], kind) * gs[:, r, None]
        wv = mq.pane_values(w[:, r], kind) * ws[:, r, None]
        step = max(float(gs[:, r].max()), float(ws[:, r].max()))
        share = max(share, float((gv - wv).abs().max()) / (2 * step))
    return share


def case(family, cfg, packed, mode, R, lengths, ids, state, label, packed32=None) -> dict:
    """One batched verify of len(lengths) slots at R rows a slot (ids
    [B x R], `state` the panes and scales) against its plain version and the
    single-stream witness; `family` "gpt2" or "llama". With `packed32` (the
    weights widened to fp32) and fp panes, also the bf16 control."""
    from efficient_llm_inference_tpu_torch.ops import megakernel as mk
    from efficient_llm_inference_tpu_torch.ops import megakernel_batch_verify as mbv
    from efficient_llm_inference_tpu_torch.ops import megakernel_llama as ml

    llama = family == "llama"
    dtype = torch.bfloat16
    quant = mode != "fp"
    kw = {"kv_mode": mode} if quant else {}
    pre = "llama" if llama else "gpt2"
    kern = getattr(mbv, f"{pre}_megabatch_verify{'_quant' if quant else ''}")
    plain = getattr(mbv, f"{pre}_megabatch_verify{'_quant' if quant else ''}_plain")
    single_verify = ml.llama_megaverify if llama else mk.gpt2_megaverify
    n_slots = len(lengths)
    got = [t.clone() for t in state]
    toks = kern(packed, *got, torch.tensor(lengths, dtype=torch.int32, device=DEV), ids,
                cfg=cfg, **kw)[0]
    control = None
    if not quant:
        want_all = [t.clone() for t in state]
        logits = plain(packed, *want_all, lengths, ids, cfg=cfg, return_logits=True)[-1]
        if packed32 is not None:
            lg32 = plain(packed32, *[t.float() for t in state], lengths, ids, cfg=cfg,
                         return_logits=True)[-1]
            tok32 = lg32.argmax(-1, keepdim=True)
            lf = logits.float()
            control = _quantiles((lf.amax(-1) - lf.gather(-1, tok32)[..., 0]).flatten().cpu())
    short_b, short_w = [], []
    same_tok = same_row = 0
    share_b = share_w = 0.0
    for b, cur in enumerate(lengths):
        if not quant:  # witness: the single-stream verify on slot b's pane
            pane = [s_[:, b].clone() for s_ in state]
            wt = single_verify(packed, *pane, torch.tensor([cur], dtype=torch.int32,
                                                           device=DEV),
                               ids[b * R:(b + 1) * R], cfg=cfg)[0]
            want = [w_[:, b] for w_ in want_all]
        for t in range(R):
            r = cur + t
            if quant:  # plain and witness on the batched kernel's earlier rows
                panes = [s_[:, b].clone() for s_ in state]
                for p_, g_ in zip(panes, got):
                    p_[:, cur:r] = g_[:, b, cur:r]
                tok_id = ids[b * R + t].long()
                if llama:
                    x = packed["embed"][tok_id][None]
                else:
                    pos = min(r, cfg.n_positions - 1)
                    x = (packed["wte"][tok_id] + packed["wpe"][pos])[None].to(dtype)
                wit = [p_.clone() for p_ in panes]
                lg = cs._mega_step(mode, packed, cfg, panes, r, x, plain=True,
                                   family=family)[-1]
                wtok = int(cs._mega_step(mode, packed, cfg, wit,
                                         torch.tensor([r], dtype=torch.int32, device=DEV),
                                         x, family=family)[0])
                mine = [g_[:, b] for g_ in got]
                share_b = max(share_b, _row_share(mode, mine, panes, r))
                share_w = max(share_w, _row_share(mode, wit, panes, r))
                same_row += all(torch.equal(m_[:, r], w_[:, r]) for m_, w_ in zip(mine, wit))
            else:
                lg, wtok = logits[b, t], int(wt[t])
                mine = [g_[:, b] for g_ in got]
                share_b = max(share_b, _row_share(mode, mine, want, r))
                share_w = max(share_w, _row_share(mode, pane, want, r))
                same_row += all(torch.equal(m_[:, r], w_[:, r]) for m_, w_ in zip(mine, pane))
            tok = int(toks[b, t])
            short_b.append(float(lg.max() - lg[tok]))
            short_w.append(float(lg.max() - lg[wtok]))
            same_tok += tok == wtok
    n = n_slots * R
    return {"family": family, "mode": mode, "R": R, "B": n_slots, "inputs": label, "rows": n,
            "tokens_equal_to_witness": same_tok, "rows_bit_equal_to_witness": same_row,
            "shortfall_batched": _quantiles(torch.tensor(short_b)),
            "shortfall_witness": _quantiles(torch.tensor(short_w)),
            "row_share_batched": share_b, "row_share_witness": share_w,
            "shortfall_fp32_control": control}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_verify_drift: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from efficient_llm_inference_tpu_torch import InferenceEngine
    from efficient_llm_inference_tpu_torch.models import gpt2 as gpt2_mod
    from efficient_llm_inference_tpu_torch.ops import megakernel as mk
    from efficient_llm_inference_tpu_torch.ops import megakernel_llama as ml

    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip(), flush=True)
    gcfg = gpt2_mod.GPT2Config.small()
    gparams = gpt2_mod.init_gpt2_params(torch.Generator().manual_seed(42), gcfg,
                                        torch.bfloat16, "cuda")
    llama = InferenceEngine.from_model_name("llama-3-1b")  # random, seed 42, bf16
    gpacked = mk.pack_gpt2_mega(gparams, gcfg)
    lpacked = ml.pack_llama_mega(llama.params, llama.model.config)
    if "--past-128" in sys.argv:
        wide = {"gpt2": mk.pack_gpt2_mega(cs._cast_params(gparams, torch.float32), gcfg),
                "llama": ml.pack_llama_mega(cs._cast_params(llama.params, torch.float32),
                                            llama.model.config)}
        for family, cfg, packed, n_slots, mode in (
                ("gpt2", gcfg, gpacked, 32, "int8"), ("gpt2", gcfg, gpacked, 24, "fp"),
                ("llama", llama.model.config, lpacked, 24, "fp")):
            W = cfg.n_kv_head * cfg.head_dim if family == "llama" else cfg.n_embd
            lengths = [cs.VERIFY_LENGTHS[b % len(cs.VERIFY_LENGTHS)] for b in range(n_slots)]
            i, R = cs.MODES.index(mode), 8
            for offset in (0, 1000):
                g = torch.Generator().manual_seed(500 + 10 * R + i + offset)
                ids = torch.randint(0, cfg.vocab_size, (n_slots * R,), generator=g)
                state = cs._verify_state(mode, torch.bfloat16, 600 + 10 * R + i + offset,
                                         cfg.n_layer, n_slots, W)
                label = "chip_smoke" if offset == 0 else f"chip_smoke+{offset}"
                print(json.dumps(case(family, cfg, packed, mode, R, lengths,
                                      ids.to(torch.int32).to(DEV), state, label,
                                      packed32=wide[family])), flush=True)
        return 0
    runs = (("gpt2", gcfg, gpacked, 16), ("llama", llama.model.config, lpacked, 8))
    for family, cfg, packed, n_slots in runs:
        W = cfg.n_kv_head * cfg.head_dim if family == "llama" else cfg.n_embd
        lengths = [cs.VERIFY_LENGTHS[b % len(cs.VERIFY_LENGTHS)] for b in range(n_slots)]
        for offset in (0, 1000):
            for i, mode in enumerate(cs.MODES):
                for R in (2, 8):  # chip_smoke.py's seeds, then + offset
                    g = torch.Generator().manual_seed(500 + 10 * R + i + offset)
                    ids = torch.randint(0, cfg.vocab_size, (n_slots * R,), generator=g)
                    state = cs._verify_state(mode, torch.bfloat16, 600 + 10 * R + i + offset,
                                             cfg.n_layer, n_slots, W)
                    label = "chip_smoke" if offset == 0 else f"chip_smoke+{offset}"
                    print(json.dumps(case(family, cfg, packed, mode, R, lengths,
                                          ids.to(torch.int32).to(DEV), state, label)),
                          flush=True)
    del gparams, llama, runs
    torch.cuda.empty_cache()
    # the bf16 cases of tests/test_torch_cuda_verify.py's
    # test_megabatch_verify_matches_plain, built as the test builds them
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_cuda_cases as ct

    for test_family in ("gpt2", "gpt2-full", "llama"):
        for mode in cs.MODES:
            for B in (1, 3, 16):
                packed, cfg, state, _ = ct._batch_case(test_family, mode, torch.bfloat16, B, DEV)
                lengths = [ct.VERIFY_BATCH_LENGTHS[b % len(ct.VERIFY_BATCH_LENGTHS)]
                           for b in range(B)]
                for R in (2, 5, 8):
                    g = torch.Generator(device="cpu").manual_seed(B * 10 + R)
                    ids = torch.randint(0, cfg.vocab_size, (B * R,), generator=g)
                    family = "gpt2" if test_family.startswith("gpt2") else "llama"
                    print(json.dumps(case(family, cfg, packed, mode, R, lengths,
                                          ids.to(torch.int32).to(DEV),
                                          [t.clone() for t in state],
                                          f"card test {test_family}")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
