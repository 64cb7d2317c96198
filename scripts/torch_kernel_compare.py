#!/usr/bin/env python3
"""Time the batched whole-step and batched verify kernels of two checkouts on
one GPU, in turns.

    python3 scripts/torch_kernel_compare.py OTHER_CHECKOUT [--profile]

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
5 times; the batched verify also over Llama-3.2-1B's int8 weights (as
from_model_name(weight_quant="int8") quantizes them) at 8 x 8 rows. Then
#7 pallas_linear on two bf16 operands at Llama-3.2-1B's w_gate [2048, 8192]
and GPT-2 small's LM head [768, 50257], B = 1, 8 and 64, beside
torch.matmul of the same operands (the yardstick), each call on its own
copy of the weight, the copies together past L2. One JSON line per worker
and case; the card's name and power limit first. With --profile, each
verify case also prints its device time by kernel name from a
torch.profiler trace of one call.
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
COLD_BYTES = 160e6  # rotating weight copies past the 50 MB L2


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


def rotating_ms(fns) -> float:
    """device_ms over `fns` called in turn (each on its own input copies)."""
    turn = [0]

    def step():
        fns[turn[0] % len(fns)]()
        turn[0] += 1

    return device_ms(step, calls=2 * len(fns), replays=3)


def kernel_breakdown(fn) -> tuple:
    """([[kernel name, launches, device ms], ...] by device time, [[name,
    device ms], ...] of the first 16 launches in order) of one call of fn
    (a torch.profiler trace with CUDA activity)."""
    from collections import defaultdict

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = defaultdict(lambda: [0, 0.0])
    seq = []
    for e in sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start):
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us() / 1e3
        seq.append([e.name[:60], e.time_range.elapsed_us() / 1e3])
    return (sorted(([n[:120], c, ms] for n, (c, ms) in by_name.items()), key=lambda r: -r[2]),
            seq[:16])


def worker(tree: str, profile_verify: bool = False) -> None:
    sys.path.insert(0, tree)
    import torch

    from efficient_llm_inference_tpu_torch.engine.engine import (
        quantize_weights,
        weight_quant_plan,
    )
    from efficient_llm_inference_tpu_torch.models import gpt2 as gpt2_mod
    from efficient_llm_inference_tpu_torch.models import llama as llama_mod
    from efficient_llm_inference_tpu_torch.models.registry import spec_by_name
    from efficient_llm_inference_tpu_torch.ops import linear as lin
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
        B = n_slots
        lengths = torch.tensor([VERIFY_LENGTHS[b % 5] for b in range(B)],
                               dtype=torch.int32, device="cuda")
        cases = [(R, "bf16", packed) for R in (2, 8)] if verify is not None else []
        if verify is not None and name == "llama-3-1b":
            spec = spec_by_name(name)
            _, mode, group = weight_quant_plan(spec, "int8")
            cases.append((8, "int8", pack(quantize_weights(spec, params, mode, group), cfg)))
        for R, weights, pk in cases:
            panes = [(torch.randn((cfg.n_layer, B, VERIFY_C, W), generator=g) * 0.5)
                     .to(torch.bfloat16).cuda() for _ in range(2)]
            ids = torch.randint(0, cfg.vocab_size, (B * R,), generator=g)
            ids = ids.to(torch.int32).cuda()
            ms = device_ms(lambda: verify(pk, *panes, lengths, ids, cfg=cfg))
            row = {"tree": tree, "model": name, "verify_B": B, "R": R, "weights": weights,
                   "ms": ms}
            if profile_verify and R == 8:
                top, seq = kernel_breakdown(lambda: verify(pk, *panes, lengths, ids, cfg=cfg))
                row["kernels"], row["first_launches"] = top[:12], seq
            print(json.dumps(row), flush=True)
        gemv = getattr(mbv, "verify_gemv", None)
        if profile_verify and gemv is not None:  # each GEMV shape of the pass alone
            E = cfg.n_embd if name == "gpt2" else cfg.hidden_size
            shapes = ([(3 * E, E), (E, E), (4 * E, E), (E, 4 * E), (cfg.vocab_size, E)]
                      if name == "gpt2" else
                      [((cfg.n_head + 2 * cfg.n_kv_head) * cfg.head_dim, E),
                       (E, cfg.n_head * cfg.head_dim), (2 * cfg.intermediate_size, E),
                       (E, cfg.intermediate_size), (cfg.vocab_size, E)])
            for N, K in shapes:
                w = (torch.randn((N, K), generator=g) / K ** 0.5).to(torch.bfloat16).cuda()
                ws = [w] + [w.clone() for _ in range(int(COLD_BYTES // (N * K * 2)))]
                x = torch.randn((B * 8, K), generator=g).to(torch.bfloat16).cuda()
                ms = rotating_ms([lambda w=w: gemv(x, w) for w in ws])
                lib = rotating_ms([lambda w=w: torch.matmul(x, w.t()) for w in ws])
                print(json.dumps({"tree": tree, "model": name, "gemv": [B * 8, N, K], "ms": ms,
                                  "matmul_ms": lib, "bound_ms": N * K * 2 / 3.35e9}),
                      flush=True)
                del ws, w
        del params, packed, cases
        torch.cuda.empty_cache()
    g = torch.Generator().manual_seed(1)
    for tag, (E, F) in (("llama w_gate", (2048, 8192)), ("gpt2 lm_head", (768, 50257))):
        w = (torch.randn((E, F), generator=g) / E ** 0.5).to(torch.bfloat16).cuda()
        ws = [w] + [w.clone() for _ in range(int(COLD_BYTES // (E * F * 2)))]
        for B in (1, 8, 64):
            x = torch.randn((B, E), generator=g).to(torch.bfloat16).cuda()
            ms = rotating_ms([lambda w=w: lin.pallas_linear(x, w) for w in ws])
            lib = rotating_ms([lambda w=w: torch.matmul(x, w) for w in ws])
            print(json.dumps({"tree": tree, "linear": tag, "B": B, "E": E, "F": F, "ms": ms,
                              "matmul_ms": lib}), flush=True)
        del ws, w
        torch.cuda.empty_cache()


def main() -> int:
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--worker":
        worker(sys.argv[2], sys.argv[3:] == ["--profile"])
        return 0
    args = sys.argv[1:]
    prof = args[1:] == ["--profile"]
    if len(args) != 1 + prof:
        print(__doc__, file=sys.stderr)
        return 2
    other = str(pathlib.Path(args[0]).resolve())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    for tree in (other, str(HERE), str(HERE), other):
        subprocess.run([sys.executable, __file__, "--worker", tree]
                       + (["--profile"] if prof else []), check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
