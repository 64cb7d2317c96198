#!/usr/bin/env python3
"""Time the batched whole-step and batched verify kernels of two checkouts on
one GPU, in turns.

    python3 scripts/torch_kernel_compare.py OTHER_CHECKOUT

Runs this checkout's and OTHER_CHECKOUT's efficient_llm_inference_tpu_torch
(each built from its own sources into its own build/cuda/) in four worker
processes, other / this / this / other, so both are timed on the same card
in the same call. Each worker times the batched decode step (#14
gpt2_megabatch at GPT-2 small's full width, #15 llama_megabatch at
Llama-3.2-1B's; random weights from seed 42, bf16, C = 320, slot lengths
0, 1, 7, 8, 100, 255, 318, 319) at B = 1 and 8, and at 16 and 32 where the
checkout's MAX_BATCH takes them, and the batched verify pass (#18
gpt2_megabatch_verify at B = 16, #20 llama_megabatch_verify at B = 8, R = 2
and 8 rows a slot, C = 128, slot lengths 0, 7, 8, 55, 112) where the
checkout has it: device ms per call from a CUDA graph of 10 calls replayed
5 times. One JSON line per worker and case; the card's name and power
limit first.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
LENGTHS = (0, 1, 7, 8, 100, 255, 318, 319)
C = 320
VERIFY_LENGTHS = (0, 7, 8, 55, 112)
VERIFY_C = 128


def device_ms(fn, calls: int = 10, replays: int = 5) -> float:
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(replays):
        graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / (calls * replays)


def worker(tree: str) -> None:
    sys.path.insert(0, tree)
    import torch

    from efficient_llm_inference_tpu_torch.models import gpt2 as gpt2_mod
    from efficient_llm_inference_tpu_torch.models import llama as llama_mod
    from efficient_llm_inference_tpu_torch.ops import megakernel as mk
    from efficient_llm_inference_tpu_torch.ops import megakernel_batch as mb
    from efficient_llm_inference_tpu_torch.ops import megakernel_llama as ml

    try:
        from efficient_llm_inference_tpu_torch.ops import megakernel_batch_verify as mbv
    except ImportError:
        mbv = None
    models = {
        "gpt2": (gpt2_mod.GPT2Config.small(), gpt2_mod.init_gpt2_params,
                 mk.pack_gpt2_mega, mb.gpt2_megabatch,
                 mbv and mbv.gpt2_megabatch_verify, 16),
        "llama-3-1b": (llama_mod.LlamaConfig.llama3_1b(), llama_mod.init_llama_params,
                       ml.pack_llama_mega, mb.llama_megabatch,
                       mbv and mbv.llama_megabatch_verify, 8),
    }
    for name, (cfg, init, pack, step, verify, n_slots) in models.items():
        params = init(torch.Generator().manual_seed(42), cfg, torch.bfloat16, "cuda")
        packed = pack(params, cfg)
        W = cfg.n_kv_head * cfg.head_dim if name != "gpt2" else cfg.n_embd
        E = cfg.hidden_size if name != "gpt2" else cfg.n_embd
        g = torch.Generator().manual_seed(0)
        for B in (1, 8, 16, 32):
            if B > mb.MAX_BATCH:
                continue
            lengths = torch.tensor([LENGTHS[b % 8] for b in range(B)] if B > 1 else [319],
                                   dtype=torch.int32, device="cuda")
            panes = [(torch.randn((cfg.n_layer, B, C, W), generator=g) * 0.5)
                     .to(torch.bfloat16).cuda() for _ in range(2)]
            x = (torch.randn((B, E), generator=g) * 0.3).to(torch.bfloat16).cuda()
            ms = device_ms(lambda: step(packed, *panes, lengths, x, cfg=cfg))
            print(json.dumps({"tree": tree, "model": name, "B": B, "ms": ms}), flush=True)
        for R in (2, 8) if verify is not None else ():
            B = n_slots
            lengths = torch.tensor([VERIFY_LENGTHS[b % 5] for b in range(B)],
                                   dtype=torch.int32, device="cuda")
            panes = [(torch.randn((cfg.n_layer, B, VERIFY_C, W), generator=g) * 0.5)
                     .to(torch.bfloat16).cuda() for _ in range(2)]
            ids = torch.randint(0, cfg.vocab_size, (B * R,), generator=g)
            ids = ids.to(torch.int32).cuda()
            ms = device_ms(lambda: verify(packed, *panes, lengths, ids, cfg=cfg))
            print(json.dumps({"tree": tree, "model": name, "verify_B": B, "R": R, "ms": ms}),
                  flush=True)
        del params, packed
        torch.cuda.empty_cache()


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        worker(sys.argv[2])
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = str(pathlib.Path(sys.argv[1]).resolve())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    for tree in (other, str(HERE), str(HERE), other):
        subprocess.run([sys.executable, __file__, "--worker", tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
