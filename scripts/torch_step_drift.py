#!/usr/bin/env python3
"""How far the single-stream Llama step's bf16 new K/V rows drift from its
plain step over 16 layers, for this checkout and, optionally, another.

    python3 scripts/torch_step_drift.py [OTHER_CHECKOUT]

On one GPU, Llama-3.2-1B at full width and depth (from_model_name, random
weights from seed 42, bf16), chip_smoke.py's Llama cases: fp / int8 / int4
/ mixed panes, C = 320 at lengths 0, 1, 32, 33 and 319 and C = 8192 at
8191, chip_smoke.py's inputs. For each case one line: the tree, the pane
kind, C, the length, whether the token passes phase 2's gate (within 2e-2
of the plain maximum logit) and the new rows' largest difference from the
plain step beside phase 2's limit (fp rows: 1.6e-2 of the rows' largest
value; quantized rows: two steps plus that, the deep-bf16 allowance).
OTHER_CHECKOUT (the parent unpacked into the gitignored _checkout/, say) is
run first, in its own process, with this checkout's chip_smoke.py helpers:
the drift of two chains on the same cases in one call. The card's name and
power limit first.
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


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        worker(sys.argv[2])
        return 0
    if len(sys.argv) > 2:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    trees = [str(pathlib.Path(t).resolve()) for t in sys.argv[1:]] + [str(HERE)]
    for tree in trees:
        subprocess.run([sys.executable, __file__, "--worker", tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
