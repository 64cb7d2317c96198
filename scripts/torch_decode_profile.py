#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's main path goes on one GPU.

    python3 scripts/torch_decode_profile.py [--model gpt2|llama-3-1b|...]

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
- kernels_per_generation, and the six kernels with the most device time.

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

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from efficient_llm_inference_tpu_torch import Config, InferenceEngine  # noqa: E402

METHODS = ("full_cache", "quant_int8", "quant_int4", "quant_mixed")
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", default="gpt2", help="registry name")
    model = parser.parse_args().model
    if not torch.cuda.is_available():
        print("torch_decode_profile: no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    text = prompt()
    t0 = time.perf_counter()
    base = InferenceEngine.from_model_name(
        model, config=Config(model_name=model, megakernel=False))
    print(json.dumps({"model": model, "init_s": time.perf_counter() - t0}), flush=True)
    for mega in (False, None):
        eng = base if mega is False else InferenceEngine.from_model_name(
            model, config=Config(model_name=model), params=base.params)
        for method in METHODS:
            eng.generate_ids(text, method, NEW_TOKENS)  # build, load, capture, warm
            walls = [wall_ms(eng, text, method) for _ in range(5)]
            eng.generate_ids(text, method, 1)
            wall_1 = statistics.median(wall_ms(eng, text, method, 1) for _ in range(5))
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                eng.generate_ids(text, method, NEW_TOKENS)
            device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            by_name = defaultdict(lambda: [0, 0.0])
            for e in device:
                by_name[e.name][0] += 1
                by_name[e.name][1] += e.time_range.elapsed_us() / 1e3
            kernel_ms = sum(v[1] for v in by_name.values()) if device else None
            wall = statistics.median(walls)
            top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
            print(json.dumps({
                "model": model,
                "megakernel": mega is None,
                "method": method,
                "wall_ms": wall,
                "wall_ms_runs": walls,
                "tokens_per_s": NEW_TOKENS / wall * 1e3,
                "step_ms": (wall - wall_1) / (NEW_TOKENS - 1),
                "kernel_ms": kernel_ms,
                "idle_share": None if kernel_ms is None else 1.0 - kernel_ms / wall,
                "kernels_per_generation": len(device),
                "top": [{"name": n[:90], "count": c, "ms": ms} for n, (c, ms) in top],
            }), flush=True)
        del eng
    return 0


if __name__ == "__main__":
    sys.exit(main())
