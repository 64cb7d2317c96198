#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's main path goes on one GPU.

    python3 scripts/torch_decode_profile.py [--model gpt2|llama-3-1b|...]
        [--weight-quant int8|int4|int4w8] [--batch B | --spec | --server [--spec]]
        [--megakernel-only] [--tree PATH]

A model of the registry at full width (GPT-2 small by default; random
weights, seed 42, drawn once and shared by both paths), bf16, batch 1, one
256-token prompt and 64 new tokens, for full_cache, quant_int8, quant_int4
and quant_mixed, with the megakernel off (the model's forward pass op by op)
and on (the default: one launch of the whole-step kernel chain per decode
step, the 64 steps replayed from a CUDA graph). For each path and method it
prints one JSON line with:

- wall_ms: median wall time of one whole generation (prefill + 64 decode
  steps), host clock around work that ends in a synchronise, unprofiled;
- kernel_ms: device time of every kernel, copy and fill of one generation,
  summed from a torch.profiler trace (CUDA activity);
- idle_share: 1 - kernel_ms / wall_ms, the share of the generation in which
  the card runs nothing;
- tokens_per_s: NEW_TOKENS over wall_ms;
- step_ms: (wall_ms - the same generation's wall time with one new token)
  / (NEW_TOKENS - 1), the wall time of one decode step with the prefill
  taken out;
- wall_1_ms: the median wall of the same generation with one new token
  (the prefill and the host around it);
- kernels_per_generation, and the six kernels with the most device time;
- decode_kernels: the launches of the single-stream step's own kernels
  (the persistent GPT-2 step's one a step, or the kernel chains' 5 L + 3 a
  step: STEP_KERNELS), and prefill_kernels: every other kernel, copy and
  fill of the generation (the prefill and the host's copies around the
  decode).

With `--megakernel-only` the single stream runs the megakernel path alone;
with `--tree PATH` the profile imports the package of another checkout
(the parent unpacked into the gitignored _checkout/, say), so two trees
are compared in one call by running the script once for each.

With `--weight-quant` the profile runs on weights quantized by
`Config(weight_quant=...)` (the chains' weight tiers), the single stream
with the megakernel on only: off, every eager decode step widens all the
codes to fp32 (a Llama-3.2-1B int4 run of the off path took most of a
1200 s call). It combines with `--batch`, `--spec` and `--server`.

With `--batch B` it profiles static-batch serving instead:
`generate_batch` of B prompts (256 tokens each, one per seed) with 64 new
tokens for kv_mode None, int8, int4 and mixed (the batched whole-step
kernels, replayed from a CUDA graph); tokens_per_s is then B x 64 over
wall_ms, step_ms the wall of one batched step, and the ten kernels with the
most device time are listed.

With `--spec` it profiles speculative decoding instead: the same prompt
and 64 new tokens through `generate_speculative` mode "ngram" (k = 8) and
"self_draft" (1 layer, k = 4), megakernel on (every round one launch of the
verify kernel, replayed from a CUDA graph), beside full_cache; n_rounds,
tokens_per_round, host_syncs (reads of the emitted count a generation) and
round_ms = (wall_ms - the wall of a 1-token full_cache generation) /
n_rounds, kernels_per_round (every kernel, copy and fill of the generation
over n_rounds), with the eight kernels with the most device time.

With `--server` it profiles the continuous-batching server instead
(`MegaBatchServer.run`, the server protocol of scripts/measure_megaserver.py:
2 x slots requests of "Question i: " + 6-10 words, 64 new tokens each,
slots = 16 (8 for Llama models) of C = 128, chunks of 32 steps), plain or,
with `--spec`, spec="ngram" (k = 8), for pools in the model dtype and int8:
wall_ms of one run of fresh requests (the server's CUDA graphs already
captured), aggregate tokens_per_s, kernel_ms, idle_share, bursts (host
reads), kernels_per_burst, the steps (plain) or rounds (spec) dispatched,
and for spec the tokens a productive slot-round and the final verify width.

If the profiler records no device activity, kernel_ms and idle_share are
null ("not measured"). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

# --tree: profile another checkout's package (e.g. the parent unpacked into
# _checkout/parent) with this script, for a comparison in one call
_TREE = (pathlib.Path(sys.argv[sys.argv.index("--tree") + 1]).resolve() if "--tree" in sys.argv
         else pathlib.Path(__file__).resolve().parents[1])
sys.path.insert(0, str(_TREE))

from efficient_llm_inference_tpu_torch import Config, InferenceEngine  # noqa: E402

METHODS = ("full_cache", "quant_int8", "quant_int4", "quant_mixed")
# Names of the single-stream steps' kernels in this checkout or an older one:
# the persistent GPT-2 step, and the chains' embed, GEMV, attention, argmax.
STEP_KERNELS = ("gpt2_step_kernel", "gemv_kernel", "gemv_stream_kernel", "attention_kernel",
                "embed_kernel", "argmax_kernel", "argmax_step_kernel")
PROMPT_TOKENS, NEW_TOKENS = 256, 64


def prompt(seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    chars = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)[
        rng.integers(0, 26, PROMPT_TOKENS)]
    chars[rng.random(PROMPT_TOKENS) < 0.18] = ord(" ")
    return chars.tobytes().decode()


def wall_ms(eng, text: str, method: str, n_new: int = NEW_TOKENS) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate_ids(text, method, n_new)  # reads the tokens: synchronises
    return (time.perf_counter() - t0) * 1e3


def run_batch(eng, texts, kv_mode, n_new: int = NEW_TOKENS) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate_batch(texts, n_new, kv_mode=kv_mode)  # reads the tokens
    return (time.perf_counter() - t0) * 1e3


def profiled(fn):
    """(kernel_ms or None, kernel count, {name: [count, ms]}) of one call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = defaultdict(lambda: [0, 0.0])
    for e in device:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    kernel_ms = sum(v[1] for v in by_name.values()) if device else None
    return kernel_ms, len(device), by_name


def _engine(model: str, wq):
    return InferenceEngine.from_model_name(model, config=Config(model_name=model,
                                                                weight_quant=wq))


def profile_batch(model: str, batch: int, wq=None) -> None:
    texts = [prompt(seed) for seed in range(batch)]
    eng = _engine(model, wq)
    for kv_mode in (None, "int8", "int4", "mixed"):
        run_batch(eng, texts, kv_mode)  # build, load, capture, warm
        walls = [run_batch(eng, texts, kv_mode) for _ in range(5)]
        run_batch(eng, texts, kv_mode, 1)
        wall_1 = statistics.median(run_batch(eng, texts, kv_mode, 1) for _ in range(5))
        kernel_ms, count, by_name = profiled(
            lambda: eng.generate_batch(texts, NEW_TOKENS, kv_mode=kv_mode))
        wall = statistics.median(walls)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
        print(json.dumps({
            "model": model, "weight_quant": wq, "batch": batch, "kv_mode": kv_mode,
            "wall_ms": wall, "wall_ms_runs": walls,
            "tokens_per_s": batch * NEW_TOKENS / wall * 1e3,
            "step_ms": (wall - wall_1) / (NEW_TOKENS - 1),
            "kernel_ms": kernel_ms,
            "idle_share": None if kernel_ms is None else 1.0 - kernel_ms / wall,
            "kernels_per_generation": count,
            "top": [{"name": n[:200], "count": c, "ms": ms} for n, (c, ms) in top],
        }), flush=True)


def profile_spec(model: str, wq=None) -> None:
    text = prompt()
    eng = _engine(model, wq)
    for n in (NEW_TOKENS, 1):
        eng.generate_ids(text, "full_cache", n)  # build, load, capture, warm
    full = statistics.median(wall_ms(eng, text, "full_cache") for _ in range(5))
    wall_1 = statistics.median(wall_ms(eng, text, "full_cache", 1) for _ in range(5))
    for mode, k in (("ngram", 8), ("self_draft", 4)):
        def run():
            return eng.generate_speculative(text, NEW_TOKENS, mode=mode, k=k, stats=True)

        run()  # build, load, capture
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            st = run()[2]  # reads the tokens: synchronises
            walls.append((time.perf_counter() - t0) * 1e3)
        kernel_ms, count, by_name = profiled(run)
        wall = statistics.median(walls)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
        print(json.dumps({
            "model": model, "tree": str(_TREE), "weight_quant": wq, "mode": mode, "k": k,
            "wall_ms": wall, "wall_ms_runs": walls,
            "tokens_per_s": NEW_TOKENS / wall * 1e3,
            "full_cache_wall_ms": full,
            "full_cache_tokens_per_s": NEW_TOKENS / full * 1e3,
            "n_rounds": st["n_rounds"], "tokens_per_round": st["tokens_per_round"],
            "host_syncs": eng.last_spec_host_syncs,
            "round_ms": (wall - wall_1) / st["n_rounds"],
            "kernel_ms": kernel_ms,
            "idle_share": None if kernel_ms is None else 1.0 - kernel_ms / wall,
            "kernels_per_generation": count,
            "kernels_per_round": count / st["n_rounds"],
            "top": [{"name": n[:90], "count": c, "ms": ms} for n, (c, ms) in top],
        }), flush=True)


SERVER_WORDS = ["weather", "mountain", "river", "engine", "tensor", "kernel", "stream",
                "window", "matrix", "garden"]


def server_prompts(tokenizer, n: int) -> list:
    """scripts/measure_megaserver.py's prompts: "Question i: " and 6-10 words
    of its list, default_rng(0)."""
    rng = np.random.default_rng(0)
    return [tokenizer.encode(f"Question {i}: " + " ".join(
        rng.choice(SERVER_WORDS, max(3, 8 + int(rng.integers(-2, 3)))))) for i in range(n)]


def profile_server(model: str, spec: bool, wq=None) -> None:
    from efficient_llm_inference_tpu_torch import MegaBatchServer, MegaPoolConfig, Request

    eng = _engine(model, wq)
    slots = 8 if model.startswith("llama") else 16
    prompts = server_prompts(eng.tokenizer, 2 * slots)
    for kv_mode in (None, "int8"):
        srv = MegaBatchServer(eng.model, eng.params,
                              pool=MegaPoolConfig(n_slots=slots, capacity=128, max_chunk=32),
                              kv_mode=kv_mode, spec="ngram" if spec else None, spec_k=8)
        bursts = []

        def run():
            reqs = [Request(rid=i, prompt_ids=list(p), max_new_tokens=NEW_TOKENS)
                    for i, p in enumerate(prompts)]
            bursts.clear()
            srv.run(reqs, progress=lambda n, _: bursts.append(n))  # reads every burst
            torch.cuda.synchronize()
            return reqs

        run()  # build, load, capture
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            run()
            walls.append((time.perf_counter() - t0) * 1e3)
        kernel_ms, count, by_name = profiled(run)
        wall = statistics.median(walls)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
        stats = srv.spec_stats
        print(json.dumps({
            "model": model, "weight_quant": wq, "slots": slots, "requests": len(prompts),
            "kv_mode": kv_mode,
            "spec": "ngram" if spec else None,
            "wall_ms": wall, "wall_ms_runs": walls,
            "tokens_per_s": len(prompts) * NEW_TOKENS / wall * 1e3,
            "kernel_ms": kernel_ms,
            "idle_share": None if kernel_ms is None else 1.0 - kernel_ms / wall,
            "bursts": len(bursts), "dispatched": bursts[-1],
            "kernels_per_burst": count / len(bursts),
            "tokens_per_round": (stats["tokens"] / stats["rounds"]) if spec else None,
            "final_R": srv._spec_R if spec else None,
            "top": [{"name": n[:90], "count": c, "ms": ms} for n, (c, ms) in top],
        }), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", default="gpt2", help="registry name")
    parser.add_argument("--batch", type=int, default=0,
                        help="profile generate_batch of this many prompts")
    parser.add_argument("--spec", action="store_true",
                        help="profile generate_speculative (ngram, self_draft); with "
                             "--server, the server's spec=\"ngram\" mode")
    parser.add_argument("--server", action="store_true",
                        help="profile MegaBatchServer.run on the server protocol")
    parser.add_argument("--weight-quant", choices=("int8", "int4", "int4w8"),
                        help="weights quantized by Config.weight_quant (any profile)")
    parser.add_argument("--megakernel-only", action="store_true",
                        help="single stream: the megakernel path only (no op-by-op run)")
    parser.add_argument("--tree", help="the checkout whose package is profiled "
                                       "(default: this one)")
    args = parser.parse_args()
    model = args.model
    if not torch.cuda.is_available():
        print("torch_decode_profile: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    wq = args.weight_quant
    if args.server:
        profile_server(model, args.spec, wq)
        return 0
    if args.batch:
        profile_batch(model, args.batch, wq)
        return 0
    if args.spec:
        profile_spec(model, wq)
        return 0
    text = prompt()
    t0 = time.perf_counter()
    base = InferenceEngine.from_model_name(
        model, config=Config(model_name=model, megakernel=False, weight_quant=wq))
    print(json.dumps({"model": model, "weight_quant": wq, "tree": str(_TREE),
                      "init_s": time.perf_counter() - t0}), flush=True)
    # quantized params serve as they are
    for mega in ((None,) if wq or args.megakernel_only else (False, None)):
        eng = base if mega is False else InferenceEngine(
            base.model, base.params, base.tokenizer, Config(model_name=model))
        for method in METHODS:
            eng.generate_ids(text, method, NEW_TOKENS)  # build, load, capture, warm
            walls = [wall_ms(eng, text, method) for _ in range(5)]
            eng.generate_ids(text, method, 1)
            wall_1 = statistics.median(wall_ms(eng, text, method, 1) for _ in range(5))
            kernel_ms, count, by_name = profiled(
                lambda: eng.generate_ids(text, method, NEW_TOKENS))
            wall = statistics.median(walls)
            top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
            decode = sum(c for n, (c, _) in by_name.items()
                         if any(k in n for k in STEP_KERNELS))
            print(json.dumps({
                "model": model,
                "tree": str(_TREE),
                "weight_quant": wq,
                "megakernel": mega is None,
                "method": method,
                "wall_ms": wall,
                "wall_1_ms": wall_1,
                "wall_ms_runs": walls,
                "tokens_per_s": NEW_TOKENS / wall * 1e3,
                "step_ms": (wall - wall_1) / (NEW_TOKENS - 1),
                "kernel_ms": kernel_ms,
                "idle_share": None if kernel_ms is None else 1.0 - kernel_ms / wall,
                "kernels_per_generation": count,
                "decode_kernels": decode,
                "prefill_kernels": count - decode,
                "top": [{"name": n[:90], "count": c, "ms": ms} for n, (c, ms) in top],
            }), flush=True)
        del eng
    return 0


if __name__ == "__main__":
    sys.exit(main())
