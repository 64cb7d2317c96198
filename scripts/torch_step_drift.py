#!/usr/bin/env python3
"""How far the single-stream Llama step's bf16 new K/V rows drift from its
plain step over 16 layers, for this checkout and, optionally, others.

    python3 scripts/torch_step_drift.py [OTHER_CHECKOUT ...] [--batch [--gpt2]] [--gemv]

On one GPU, Llama-3.2-1B at full width and depth (from_model_name, random
weights from seed 42, bf16), chip_smoke.py's Llama cases: fp / int8 / int4
/ mixed panes, C = 320 at lengths 0, 1, 32, 33 and 319 and C = 8192 at
8191, chip_smoke.py's inputs. For each case one line: the tree, the pane
kind, C, the length, whether the token passes phase 2's gate (within 2e-2
of the plain maximum logit) and the new rows' largest difference from the
plain step beside phase 2's limit (fp rows: 1.6e-2 of the rows' largest
value; quantized rows: two steps plus that, the deep-bf16 allowance).
Each OTHER_CHECKOUT (the parent unpacked into the gitignored _checkout/,
say) is run first, in its own process, with this checkout's chip_smoke.py
helpers: the drift of several chains on the same cases in one call. The
card's name and power limit first.

With --batch, the batched step instead (#15 / #17, chip_smoke.py's batch
kernels phase: every pane kind, B = 8, 16 and 32 slots at its lengths of
C = 320, its seeds and inputs; then over the int8 weight tier, fp and int8
panes, as its full-depth int8 phase): one line a case with the tokens that
pass the gate, the slots whose new rows pass phase 2's limit, and for fp
panes the largest row difference as a share of its slot's limit. With
--batch --gpt2, GPT-2's batched step (#14 / #16) at chip_smoke.py's GPT-2
batch cases (seed-42 GPT-2 small, 12 layers) and over its int8 and int4
weight tiers (fp and int8 panes): the slots within two steps (the limit
without the deep-bf16 allowance) beside those within the allowance, and
the largest quantized row difference in quantization steps.

With --gemv (this checkout only), where the drift starts: one bf16 GEMV at
each of Llama-3.2-1B's five weight shapes, 32 rows of N(0, 1) inputs and
N(0, 0.02) weights from seed 7, bf16 out, held against the fp64 product
rounded to bf16. For each route (the batched chain's `stream_gemv` and the
batched verify's `verify_gemv`, whose MMAs carry the running sum in their
fp32 accumulator; an fp32 matmul, TF32 off, which rounds to nearest): the
share of outputs that differ from the rounded fp64 product and, of those,
the share that lie nearer zero than it (an even split is unbiased
rounding).
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
CASES = [(320, 0), (320, 1), (320, 32), (320, 33), (320, 319), (8192, 8191)]


def worker(tree: str) -> None:
    sys.path.insert(0, tree)
    sys.path.insert(1, str(HERE))
    import torch

    import chip_smoke as cs
    from efficient_llm_inference_tpu_torch import InferenceEngine
    from efficient_llm_inference_tpu_torch.ops import megakernel_llama as ml

    torch.backends.cuda.matmul.allow_tf32 = False
    eng = InferenceEngine.from_model_name("llama-3-1b")
    cfg = eng.model.config
    KW = cfg.n_kv_head * cfg.head_dim
    packed = ml.pack_llama_mega(eng.params, cfg)
    dtype = torch.bfloat16
    for i, mode in enumerate(cs.MODES):
        for C, length in CASES:
            state, _ = cs._mega_state(mode, dtype, 200 + i + length, cfg.n_layer, KW,
                                      cfg.hidden_size, C)
            x = eng.params["embed"][(length * 7919 + i) % cfg.vocab_size][None]
            dev_len = torch.tensor([length], dtype=torch.int32, device="cuda")
            got = [t.clone() for t in state]
            want = [t.clone() for t in state]
            tok = int(cs._mega_step(mode, packed, cfg, got, dev_len, x, family="llama")[0])
            logits = cs._mega_step(mode, packed, cfg, want, length, x, plain=True,
                                   family="llama")[-1]
            torch.cuda.synchronize()
            try:
                err = cs._new_row_err(mode, dtype, got, want, state, row=length,
                                      deep_bf16=True)
                row = f"rows within the limit, max|kernel-plain| {err:.4g}"
            except AssertionError as e:
                row = f"rows past the limit: {e}"
            print(f"{tree} {mode} C={C} len={length} token_ok={cs._token_ok(tok, logits, dtype)} "
                  f"{row}", flush=True)


def batch_worker(tree: str, gpt2: bool = False) -> None:
    sys.path.insert(0, tree)
    sys.path.insert(1, str(HERE))
    import torch

    import chip_smoke as cs
    from efficient_llm_inference_tpu_torch import InferenceEngine
    from efficient_llm_inference_tpu_torch.models import gpt2 as gpt2_mod
    from efficient_llm_inference_tpu_torch.models.registry import spec_by_name
    from efficient_llm_inference_tpu_torch.ops import megakernel as mk
    from efficient_llm_inference_tpu_torch.ops import megakernel_llama as ml
    from efficient_llm_inference_tpu_torch.ops import megakernel_quant as mq

    torch.backends.cuda.matmul.allow_tf32 = False
    family = "gpt2" if gpt2 else "llama"
    if gpt2:  # chip_smoke.py's GPT-2 batch kernels phase: seed-42 GPT-2 small
        cfg = gpt2_mod.GPT2Config.small()
        base = gpt2_mod.init_gpt2_params(torch.Generator().manual_seed(42), cfg,
                                         torch.bfloat16, "cuda")
        W = E = cfg.n_embd
        pack, name = mk.pack_gpt2_mega, "gpt2"
    else:
        eng = InferenceEngine.from_model_name("llama-3-1b")
        cfg, base = eng.model.config, eng.params
        W, E = cfg.n_kv_head * cfg.head_dim, cfg.hidden_size
        pack, name = ml.pack_llama_mega, "llama-3-1b"
    dtype = torch.bfloat16
    tiers = ("int8", "int4") if gpt2 else ("int8",)
    cases = [("bf16", mode) for mode in cs.MODES] + [
        (w, mode) for w in tiers for mode in ("fp", "int8")]
    packs = {}
    for weights, mode in cases:
        i = cs.MODES.index(mode)
        if weights not in packs:
            packs.clear()
            params = (base if weights == "bf16" else
                      cs._quantized_params(spec_by_name(name), base, weights))
            packs[weights] = pack(params, cfg)
            del params
        packed = packs[weights]
        for n_slots in (8, 16, 32):
            lengths = [cs.BATCH_LENGTHS[b % 8] for b in range(n_slots)]
            if n_slots == 8:  # check_megabatches' states and inputs
                state, x = cs._batch_state(mode, dtype, 300 + i, cfg.n_layer, W, E, 8)
            else:
                state = cs._verify_state(mode, dtype, 300 + i + 100 * n_slots, cfg.n_layer,
                                         n_slots, W, C=cs.MEGA_C)
                g = torch.Generator(device="cuda").manual_seed(n_slots)
                x = (torch.randn((n_slots, E), generator=g, device="cuda") * 0.3).to(dtype)
            dev_len = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            got = [t.clone() for t in state]
            want = [t.clone() for t in state]
            toks = cs._batch_step(mode, packed, cfg, got, dev_len, x, family=family)[0]
            logits = cs._batch_step(mode, packed, cfg, want, lengths, x, plain=True,
                                    family=family)[-1]
            torch.cuda.synchronize()
            tok_ok, row_ok, two_ok, share, steps = 0, 0, 0, 0.0, 0.0
            for b, length in enumerate(lengths):
                tok_ok += cs._token_ok(int(toks[b]), logits[b], dtype)
                slot = [[t[:, b] for t in ts] for ts in (got, want, state)]
                for deep in (True, False):
                    try:
                        cs._new_row_err(mode, dtype, *slot, row=length, deep_bf16=deep)
                        row_ok += deep
                        two_ok += not deep
                    except AssertionError:
                        pass
                if mode == "fp":
                    g_ = torch.stack([t[:, b, length].float() for t in got])
                    w_ = torch.stack([t[:, b, length].float() for t in want])
                    tol = 1.6e-2 * max(w_.abs().max().item(), 1.0)
                    share = max(share, (g_ - w_).abs().max().item() / tol)
                else:  # the largest dequantized difference in quantization steps
                    for kind, g_, w_, gs, ws in zip(mq._kv_kinds(mode), slot[0][:2],
                                                    slot[1][:2], slot[0][2:], slot[1][2:]):
                        gv = mq.pane_values(g_[:, length], kind) * gs[:, length, None]
                        wv = mq.pane_values(w_[:, length], kind) * ws[:, length, None]
                        step = max(gs[:, length].max().item(), ws[:, length].max().item())
                        steps = max(steps, (gv - wv).abs().max().item() / step)
            print(f"{tree} batch {family} {weights} weights {mode} B={n_slots}: tokens ok "
                  f"{tok_ok}/{n_slots}, rows within the deep-bf16 limit {row_ok}/{n_slots}, "
                  f"within two steps / 1.6e-2 {two_ok}/{n_slots}"
                  + (f", largest fp row difference {share:.3f} of its limit" if mode == "fp"
                     else f", largest quantized row difference {steps:.2f} steps"),
                  flush=True)


def gemv_worker() -> None:
    import json

    sys.path.insert(0, str(HERE))
    import torch

    from efficient_llm_inference_tpu_torch.ops import megakernel_batch as mb
    from efficient_llm_inference_tpu_torch.ops import megakernel_batch_verify as mbv

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(7)
    for name, N, K in (("qkv", 3072, 2048), ("o", 2048, 2048), ("gate_up", 16384, 2048),
                       ("down", 2048, 8192), ("head", 128256, 2048)):
        x = torch.randn((32, K), generator=g, device="cuda").bfloat16()
        w = (torch.randn((N, K), generator=g, device="cuda") * 0.02).bfloat16()
        exact = x.double() @ w.double().t()
        ref = exact.to(torch.bfloat16)
        routes = {"stream_gemv": lambda: mb.stream_gemv(x, w),
                  "verify_gemv": lambda: mbv.verify_gemv(x, w),
                  "fp32_matmul": lambda: (x.float() @ w.float().t()).bfloat16()}
        for route, fn in routes.items():
            try:
                y = fn()
                torch.cuda.synchronize()
            except (RuntimeError, ValueError) as e:
                print(json.dumps({"gemv": name, "route": route, "error": str(e)}), flush=True)
                continue
            off = y != ref
            nearer = off & (y.double().abs() < exact.abs())
            n_off = int(off.sum())
            print(json.dumps({"gemv": name, "N": N, "K": K, "route": route,
                              "off_share": n_off / off.numel(),
                              "nearer_zero_of_off": int(nearer.sum()) / max(n_off, 1)}),
                  flush=True)


def main() -> int:
    if len(sys.argv) in (3, 4, 5) and sys.argv[1] == "--worker":
        if "--batch" in sys.argv:
            batch_worker(sys.argv[2], gpt2="--gpt2" in sys.argv)
        else:
            worker(sys.argv[2])
        return 0
    batch = "--batch" in sys.argv
    args = [a for a in sys.argv[1:] if a not in ("--batch", "--gemv", "--gpt2")]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    if "--gemv" in sys.argv:
        if args or batch:
            print(__doc__, file=sys.stderr)
            return 2
        gemv_worker()
        return 0
    trees = [str(pathlib.Path(t).resolve()) for t in args] + [str(HERE)]
    for tree in trees:
        subprocess.run([sys.executable, __file__, "--worker", tree] + ["--batch"] * batch
                       + ["--gpt2"] * ("--gpt2" in sys.argv), check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
