#!/usr/bin/env python3
"""Time the whole-step, batched and verify kernels of two checkouts on one
GPU, in turns.

    python3 scripts/torch_kernel_compare.py OTHER_CHECKOUT [--profile] [--single | --batch | --verify]

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

The single-stream steps (#9 gpt2_megastep and #11 gpt2_megastep_quant at
GPT-2 small's full width; #13 llama_megastep and #12 llama_megastep_quant at
Llama-3.2-1B's) are timed the same way at C = 320, length 319: GPT-2 in
bf16 over fp / int8 / int4 / mixed panes and over the int8 / int4 / int4w8
weight tiers (fp and int8 panes), with, where the checkout has the
persistent GPT-2 step, its skeleton (`elit_gpt2_megastep_skeleton`: the
step's weight stream and grid barriers without arithmetic) over each
weight tier; with --profile, GPT-2's fp- and int8-pane steps' kernels too;
Llama-3.2-1B
in bf16 and fp32 (the bf16 weights widened), each pane kind, over the
model-dtype weights and over the int8 / int4 / int4w8 tiers (as
from_model_name(weight_quant=...) quantizes them). With --profile, the
Llama bf16 step over fp and int8 panes and over each weight tier also
prints its device time by kernel name and its launches in order from a
torch.profiler trace of one replay of a CUDA graph of 4 steps, with the
overlap of each launch with the one before it (start before the previous
end; programmatic dependent launch lets a kernel start before its
predecessor ends). With --single, only the single-stream steps run. The
CUDA runtime of torch, nvidia-smi's version and nvcc --version come first.

With --batch, only the batched steps run: GPT-2 small's #14 gpt2_megabatch
(fp panes) and #16 gpt2_megabatch_quant (int8, int4 and mixed panes) in
bf16, and #14 / #16 (fp and int8 panes) over the int8, int4 and int4w8
weight tiers (as from_model_name(weight_quant=...) quantizes them), each at
B = 1, 8, 16 and 32 (C = 320, slot lengths LENGTHS repeated; B = 1 at
length 319), with, where the checkout has GPT-2's persistent batched step,
its skeleton (`elit_gpt2_megabatch_skeleton`: the weight stream, the grid
barriers and the slots' input staging without arithmetic) over each weight
tier at B = 1, 8 and 32; then Llama-3.2-1B's #15 (fp panes) and #17 (int8
panes) in bf16 at B = 8 and 32 as the control. With --batch --profile, the
Llama bf16 steps at B = 8 also print their split by kernel role (embed,
qkv, attention, o, gate|up, down, LM head, argmax; each launch charged its
end minus the latest end before it) and the gaps (time in which no kernel
of the step ran), from a torch.profiler trace of one replay of a CUDA graph
of 4 steps, with the launches of a step and how many of them start before
the one before them ends; GPT-2's step is one kernel
(scripts/torch_gpt2_step_phases.py --batch 8 splits it by phase).

With --verify, only the single-sequence verify passes run: #10
gpt2_megaverify at GPT-2 small's full width and #13 llama_megaverify at
Llama-3.2-1B's (random weights from seed 42 drawn on the card), R = 4 and
8 rows, cur = C - 16 of C = 344 (the speculation main path's capacity at k
= 8), token ids in, bf16 over the model-dtype weights and over the int8,
int4 and int4w8 tiers (as from_model_name(weight_quant=...) quantizes
them); with --verify --profile, the bf16 R = 8 pass of each model also
prints its device time by kernel name and its launches in order from a
torch.profiler trace of one replay of a CUDA graph of 4 passes.
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


SINGLE_LEN = 319  # the single-stream steps: the last row of C = 320
PANES = ("fp", "int8", "int4", "mixed")


def launches_in_order(fn, n_steps: int = 4) -> tuple:
    """(by name, in order) of one replay of a CUDA graph of n_steps calls of
    fn, from a torch.profiler trace: [[name, launches, device ms], ...] by
    device time, and [[name, start us, duration us, overlap us], ...] of the
    launches in order, overlap being how long a launch ran before the one
    before it ended (0 if it started after)."""
    from collections import defaultdict

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    graph = torch.cuda.CUDAGraph()
    fn()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        for _ in range(n_steps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    by_name = defaultdict(lambda: [0, 0.0])
    seq, prev_end = [], None
    t0 = evs[0].time_range.start if evs else 0
    for e in evs:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us() / 1e3 / n_steps
        start, end = e.time_range.start, e.time_range.end
        overlap = 0.0 if prev_end is None else max(0.0, prev_end - start)
        seq.append([e.name[:70], start - t0, end - start, overlap])
        prev_end = end if prev_end is None else max(prev_end, end)
    return (sorted(([n[:140], c / n_steps, ms] for n, (c, ms) in by_name.items()),
                   key=lambda r: -r[2]), seq)


def single_stream(tree: str, profile: bool) -> None:
    """The single-stream steps of this tree: GPT-2 small (#9 / #11, bf16) and
    Llama-3.2-1B (#13 / #12) in bf16 and fp32 over every pane kind and
    weight tier, one JSON line each."""
    import torch

    from efficient_llm_inference_tpu_torch.engine.engine import (
        quantize_weights,
        weight_quant_plan,
    )
    from efficient_llm_inference_tpu_torch.models import gpt2 as gpt2_mod
    from efficient_llm_inference_tpu_torch.models import llama as llama_mod
    from efficient_llm_inference_tpu_torch.models.registry import spec_by_name
    from efficient_llm_inference_tpu_torch.ops import megakernel as mk
    from efficient_llm_inference_tpu_torch.ops import megakernel_llama as ml
    from efficient_llm_inference_tpu_torch.ops import megakernel_quant as mq

    g = torch.Generator().manual_seed(0)
    length = torch.tensor([SINGLE_LEN], dtype=torch.int32, device="cuda")

    def state(mode, dtype, L, W):
        if mode == "fp":
            return [(torch.randn((L, C, W), generator=g) * 0.5).to(dtype).cuda()
                    for _ in range(2)]
        panes = []
        for kind in mq._kv_kinds(mode):
            width = W if kind == "int8" else W // 2
            panes.append(torch.randint(-127, 128, (L, C, width), generator=g,
                                       dtype=torch.int32).to(torch.int8).cuda())
        return panes + [(torch.rand((L, C), generator=g) * 0.02 + 1e-3).cuda()
                        for _ in range(2)]

    def stepper(family, mode, packed, cfg, st, x):
        fp = mk.gpt2_megastep if family == "gpt2" else ml.llama_megastep
        quant = mq.gpt2_megastep_quant if family == "gpt2" else mq.llama_megastep_quant
        if mode == "fp":
            return lambda: fp(packed, *st, length, x, cfg=cfg)
        return lambda: quant(packed, *st, length, x, cfg=cfg, kv_mode=mode)

    cfg = gpt2_mod.GPT2Config.small()
    spec = spec_by_name("gpt2")
    params = gpt2_mod.init_gpt2_params(torch.Generator().manual_seed(42), cfg,
                                       torch.bfloat16, "cuda")
    x = (torch.randn((1, cfg.n_embd), generator=g) * 0.3).to(torch.bfloat16).cuda()
    for weights in ("model", "int8", "int4", "int4w8"):
        if weights == "model":
            packed = mk.pack_gpt2_mega(params, cfg)
        else:
            _, mode_w, group = weight_quant_plan(spec, weights)
            packed = mk.pack_gpt2_mega(quantize_weights(spec, params, mode_w, group), cfg)
        for mode in PANES if weights == "model" else ("fp", "int8"):
            st = state(mode, torch.bfloat16, cfg.n_layer, cfg.n_embd)
            fn = stepper("gpt2", mode, packed, cfg, st, x)
            row = {"tree": tree, "single": "gpt2", "dtype": "bf16", "panes": mode,
                   "weights": "bf16" if weights == "model" else weights,
                   "ms": device_ms(fn, calls=20)}
            if profile and mode in ("fp", "int8"):
                row["kernels"], row["launches"] = launches_in_order(fn)
            print(json.dumps(row), flush=True)
        if hasattr(mk, "Gpt2StepArgs"):  # the persistent step's stream and barriers alone
            st = state("fp", torch.bfloat16, cfg.n_layer, cfg.n_embd)
            tok = torch.zeros(1, dtype=torch.int32, device="cuda")
            step = mk.StepLauncher(packed, cfg, *st, length, tok, x_emb=x)
            print(json.dumps({
                "tree": tree, "single": "gpt2", "skeleton": True, "dtype": "bf16",
                "weights": "bf16" if weights == "model" else weights, "grid": step.args.grid,
                "ms": device_ms(lambda: step.launch("elit_gpt2_megastep_skeleton"),
                                calls=20)}), flush=True)
        del packed
    del params

    cfg = llama_mod.LlamaConfig.llama3_1b()
    spec = spec_by_name("llama-3-1b")
    KW = cfg.n_kv_head * cfg.head_dim
    base = llama_mod.init_llama_params(torch.Generator().manual_seed(42), cfg,
                                       torch.bfloat16, "cuda")
    for dtype, dname in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        params = base if dtype == torch.bfloat16 else _cast(base, dtype)
        for weights in ("model", "int8", "int4", "int4w8"):
            if weights == "model":
                packed = ml.pack_llama_mega(params, cfg)
            else:
                _, mode_w, group = weight_quant_plan(spec, weights)
                packed = ml.pack_llama_mega(
                    quantize_weights(spec, params, mode_w, group), cfg)
            x = params["embed"][1234 % cfg.vocab_size][None].contiguous()
            for mode in PANES:
                st = state(mode, dtype, cfg.n_layer, KW)
                fn = stepper("llama", mode, packed, cfg, st, x)
                row = {"tree": tree, "single": "llama-3-1b", "dtype": dname, "panes": mode,
                       "weights": dname if weights == "model" else weights,
                       "ms": device_ms(fn)}
                if profile and dtype == torch.bfloat16 and (
                        mode in ("fp", "int8") if weights == "model" else mode == "fp"):
                    row["kernels"], row["launches"] = launches_in_order(fn)
                print(json.dumps(row), flush=True)
                del st
            del packed
            torch.cuda.empty_cache()
        del params


ROLES = ("qkv", "attention", "o", "gate|up", "down")


def step_split(seq, n_layer: int, n_steps: int = 4) -> dict:
    """The split of one step by kernel role from `launches_in_order`'s
    launches of n_steps steps: consecutive launches of one kernel name are
    one GEMV (gemv_batch.cuh launches a GEMV once per group of 8 slots); a step
    is embed, per layer qkv, attention, o, gate|up, down, then the LM head
    and argmax. Each launch is charged its end minus the latest end before
    it (its start, if later); `gaps` is the time no launch ran. µs a step,
    plus the step's launches and how many start before the previous end."""
    groups = []  # [name, [launches]]
    seq = [launch for launch in seq if "at::native" not in launch[0]]  # torch's own fills
    for launch in seq:
        if groups and groups[-1][0] == launch[0] and "embed" not in launch[0] \
                and "argmax_batch" not in launch[0]:
            groups[-1][1].append(launch)
        else:
            groups.append([launch[0], [launch]])
    per_step = 5 * n_layer + 3
    out = {r: 0.0 for r in ("embed",) + ROLES + ("lm_head", "argmax", "gaps")}
    prev_end, early = None, 0
    for i, (name, launches) in enumerate(groups):
        j = i % per_step
        role = ("embed" if j == 0 else "lm_head" if j == per_step - 2
                else "argmax" if j == per_step - 1 else ROLES[(j - 1) % 5])
        if len(groups) != per_step * n_steps:
            role = name[:40]
            out.setdefault(role, 0.0)
        for _, start, dur, overlap in launches:
            end = start + dur
            if prev_end is None:
                out[role] += dur
                prev_end = end
                continue
            early += overlap > 0
            out["gaps"] += max(0.0, start - prev_end)
            out[role] += max(0.0, end - max(prev_end, start))
            prev_end = max(prev_end, end)
    split = {k: round(v / n_steps, 2) for k, v in out.items()}
    split["launches"] = len(seq) / n_steps
    split["start_early"] = early / n_steps
    return split


def batch_steps(tree: str, profile: bool) -> None:
    """The batched steps of this tree: GPT-2's #14 / #16 over every pane kind
    and weight tier at B = 1, 8, 16, 32 and its skeleton, then the Llama
    chain's #15 / #17 as the control, one JSON line each; with `profile`,
    the Llama B = 8 bf16 steps' split by kernel."""
    import torch

    from efficient_llm_inference_tpu_torch.engine.engine import (
        quantize_weights,
        weight_quant_plan,
    )
    from efficient_llm_inference_tpu_torch.models import gpt2 as gpt2_mod
    from efficient_llm_inference_tpu_torch.models import llama as llama_mod
    from efficient_llm_inference_tpu_torch.models.registry import spec_by_name
    from efficient_llm_inference_tpu_torch.ops import megakernel as mk
    from efficient_llm_inference_tpu_torch.ops import megakernel_batch as mb
    from efficient_llm_inference_tpu_torch.ops import megakernel_batch_quant as mbq
    from efficient_llm_inference_tpu_torch.ops import megakernel_llama as ml
    from efficient_llm_inference_tpu_torch.ops import megakernel_quant as mq

    g = torch.Generator(device="cuda").manual_seed(0)

    def state(mode, L, B, W):  # drawn on the card
        if mode == "fp":
            return [(torch.randn((L, B, C, W), generator=g, device="cuda") * 0.5)
                    .to(torch.bfloat16) for _ in range(2)]
        panes = []
        for kind in mq._kv_kinds(mode):
            width = W if kind == "int8" else W // 2
            panes.append(torch.randint(-127, 128, (L, B, C, width), generator=g,
                                       device="cuda", dtype=torch.int8))
        return panes + [torch.rand((L, B, C), generator=g, device="cuda") * 0.02 + 1e-3
                        for _ in range(2)]

    def stepper(family, mode, packed, cfg, st, lengths, x):
        fp = mb.gpt2_megabatch if family == "gpt2" else mb.llama_megabatch
        quant = mbq.gpt2_megabatch_quant if family == "gpt2" else mbq.llama_megabatch_quant
        if mode == "fp":
            return lambda: fp(packed, *st, lengths, x, cfg=cfg)
        return lambda: quant(packed, *st, lengths, x, cfg=cfg, kv_mode=mode)

    def lengths_of(B):
        return torch.tensor([LENGTHS[b % len(LENGTHS)] for b in range(B)] if B > 1 else [319],
                            dtype=torch.int32, device="cuda")

    cfg = gpt2_mod.GPT2Config.small()
    spec = spec_by_name("gpt2")
    params = gpt2_mod.init_gpt2_params(torch.Generator().manual_seed(42), cfg,
                                       torch.bfloat16, "cuda")
    skeleton = hasattr(mb, "GPT2BatchLauncher") and hasattr(mb, "gpt2_kernels")
    for weights in ("bf16", "int8", "int4", "int4w8"):
        if weights == "bf16":
            packed = mk.pack_gpt2_mega(params, cfg)
        else:
            _, mode_w, group = weight_quant_plan(spec, weights)
            packed = mk.pack_gpt2_mega(quantize_weights(spec, params, mode_w, group), cfg)
        for mode in (PANES if weights == "bf16" else ("fp", "int8")):
            for B in (1, 8, 16, 32):
                st = state(mode, cfg.n_layer, B, cfg.n_embd)
                x = (torch.randn((B, cfg.n_embd), generator=g, device="cuda") * 0.3).to(
                    torch.bfloat16)
                ms = device_ms(stepper("gpt2", mode, packed, cfg, st, lengths_of(B), x))
                print(json.dumps({"tree": tree, "batch": "gpt2", "panes": mode,
                                  "weights": weights, "B": B, "ms": ms}), flush=True)
                del st
        for B in ((1, 8, 32) if skeleton else ()):
            st = state("fp", cfg.n_layer, B, cfg.n_embd)
            x = (torch.randn((B, cfg.n_embd), generator=g, device="cuda") * 0.3).to(
                torch.bfloat16)
            tok = torch.zeros(B, dtype=torch.int32, device="cuda")
            step = mb.GPT2BatchLauncher(packed, cfg, *st, lengths_of(B), tok, x_emb=x)
            print(json.dumps({
                "tree": tree, "batch": "gpt2", "skeleton": True, "weights": weights, "B": B,
                "grid": step.args.grid,
                "ms": device_ms(lambda: step.launch("elit_gpt2_megabatch_skeleton"))}),
                flush=True)
            del st, step
        del packed
        torch.cuda.empty_cache()
    del params

    cfg = llama_mod.LlamaConfig.llama3_1b()
    KW = cfg.n_kv_head * cfg.head_dim
    params = llama_mod.init_llama_params(torch.Generator().manual_seed(42), cfg,
                                         torch.bfloat16, "cuda")
    packed = ml.pack_llama_mega(params, cfg)
    for mode in ("fp", "int8"):
        for B in (8, 32):
            st = state(mode, cfg.n_layer, B, KW)
            x = params["embed"][torch.arange(B, device="cuda") * 977 + 11].contiguous()
            fn = stepper("llama", mode, packed, cfg, st, lengths_of(B), x)
            row = {"tree": tree, "batch": "llama-3-1b", "panes": mode, "weights": "bf16",
                   "B": B, "ms": device_ms(fn)}
            if profile and B == 8:
                _, seq = launches_in_order(fn)
                row["split_us"] = step_split(seq, cfg.n_layer)
                row["first_launches"] = [r[0] for r in seq[:8]]
            print(json.dumps(row), flush=True)
            del st
    del packed, params
    torch.cuda.empty_cache()


VERIFY_PASS_C = 344  # the speculation main path's capacity at k = 8 (chip_smoke.py SPEC_C)


def verify_passes(tree: str, profile: bool) -> None:
    """#10 and #13 at R = 4 and 8 of this tree, bf16 and the weight tiers,
    one JSON line each."""
    import torch

    from efficient_llm_inference_tpu_torch.engine.engine import (
        quantize_weights,
        weight_quant_plan,
    )
    from efficient_llm_inference_tpu_torch.models import gpt2 as gpt2_mod
    from efficient_llm_inference_tpu_torch.models import llama as llama_mod
    from efficient_llm_inference_tpu_torch.models.registry import spec_by_name
    from efficient_llm_inference_tpu_torch.ops import megakernel as mk
    from efficient_llm_inference_tpu_torch.ops import megakernel_llama as ml

    models = {
        "gpt2": (gpt2_mod.GPT2Config.small(), gpt2_mod.init_gpt2_params, mk.pack_gpt2_mega,
                 mk.gpt2_megaverify),
        "llama-3-1b": (llama_mod.LlamaConfig.llama3_1b(), llama_mod.init_llama_params,
                       ml.pack_llama_mega, ml.llama_megaverify),
    }
    C = VERIFY_PASS_C
    for name, (cfg, init, pack, verify) in models.items():
        params = init(torch.Generator(device="cuda").manual_seed(42), cfg, torch.bfloat16,
                      "cuda")
        spec = spec_by_name(name)
        W = cfg.n_kv_head * cfg.head_dim if name != "gpt2" else cfg.n_embd
        g = torch.Generator().manual_seed(0)
        panes = [(torch.randn((cfg.n_layer, C, W), generator=g) * 0.5).to(torch.bfloat16).cuda()
                 for _ in range(2)]
        for weights in ("bf16", "int8", "int4", "int4w8"):
            if weights == "bf16":
                pk = pack(params, cfg)
            else:
                _, mode, group = weight_quant_plan(spec, weights)
                pk = pack(quantize_weights(spec, params, mode, group), cfg)
            for R in (4, 8):
                ids = torch.randint(0, cfg.vocab_size, (R,), generator=g).to(torch.int32).cuda()
                length = torch.tensor([C - 16], dtype=torch.int32, device="cuda")

                def run():
                    verify(pk, *panes, length, ids, cfg=cfg)

                row = {"tree": tree, "model": name, "verify_R": R, "weights": weights,
                       "cur": C - 16, "C": C, "ms": device_ms(run)}
                if profile and R == 8 and weights == "bf16":
                    row["kernels"], row["launches"] = launches_in_order(run)
                print(json.dumps(row), flush=True)
            del pk
            torch.cuda.empty_cache()
        del params, panes
        torch.cuda.empty_cache()


def _cast(params, dtype):
    if isinstance(params, dict):
        return {k: _cast(v, dtype) for k, v in params.items()}
    return params.to(dtype) if params.is_floating_point() else params


def versions() -> str:
    """torch's CUDA runtime, nvidia-smi's version and nvcc's, for the record."""
    import torch

    drv = subprocess.run(["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    from efficient_llm_inference_tpu_torch.ops import _build

    nv = subprocess.run([_build.nvcc(), "--version"], capture_output=True, text=True,
                        timeout=60).stdout.strip().splitlines()[-2:]
    return (f"torch {torch.__version__} CUDA {torch.version.cuda}; nvidia {drv}; "
            f"nvcc {' / '.join(nv)}")


def worker(tree: str, profile_verify: bool = False) -> None:
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
    if len(sys.argv) >= 3 and sys.argv[1] == "--worker":
        tree, flags = sys.argv[2], sys.argv[3:]
        sys.path.insert(0, tree)
        if "--batch" in flags:
            batch_steps(tree, "--profile" in flags)
            return 0
        if "--verify" in flags:
            verify_passes(tree, "--profile" in flags)
            return 0
        if "--single" not in flags:
            worker(tree, "--profile" in flags)
        single_stream(tree, "--profile" in flags)
        return 0
    modes = ("--profile", "--single", "--batch", "--verify")
    args = [a for a in sys.argv[1:] if a not in modes]
    flags = [a for a in sys.argv[1:] if a in modes]
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    other = str(pathlib.Path(args[0]).resolve())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    sys.path.insert(0, str(HERE))
    print(f"versions: {versions()}", flush=True)
    for tree in (other, str(HERE), str(HERE), other):
        subprocess.run([sys.executable, __file__, "--worker", tree] + flags, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
