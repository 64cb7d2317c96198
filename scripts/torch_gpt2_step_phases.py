#!/usr/bin/env python3
"""Where the time of GPT-2's persistent step goes, phase by phase, on one GPU.

    python3 scripts/torch_gpt2_step_phases.py

Builds a copy of csrc/gpt2_megastep.cu with timestamps added (the
%globaltimer of thread 0 of the first and the last block: at the step's
start, after each phase's prologue, after each GEMV phase, on entering and
on leaving each grid barrier; and, for block 0, the time its thread 0
spends issuing the ring's copies and waiting for tiles), with only the bf16
kernels at head_dim 64 over fp and int8 panes, into build/probe/. It then
runs GPT-2 small's step (random weights from seed 42, C = 320, length 319,
fp panes) over bf16, int8 and int4 weights, and prints one JSON line each
per block: microseconds a step summed over the 12 layers by phase and
interval (`qkv:pro>gemv` is the qkv phase's tiles and epilogue,
`attn:bar_out>bar_in` the attention phase, `fc:bar_in>bar_out` the wait at
the fc phase's grid barrier, `head:pro>gemv` the LM head), and the step's
device ms timed plain and instrumented (CUDA-graph replay), the card's name
and power limit first. The timestamps cost a little: read the split, time
the kernel with scripts/torch_kernel_compare.py. Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import subprocess
import sys
from collections import defaultdict

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "scripts"))

from efficient_llm_inference_tpu_torch.engine.engine import (  # noqa: E402
    quantize_weights,
    weight_quant_plan,
)
from efficient_llm_inference_tpu_torch.models import gpt2 as gpt2_mod  # noqa: E402
from efficient_llm_inference_tpu_torch.models.registry import spec_by_name  # noqa: E402
from efficient_llm_inference_tpu_torch.ops import _build  # noqa: E402
from efficient_llm_inference_tpu_torch.ops import megakernel as mk  # noqa: E402
from torch_kernel_compare import device_ms  # noqa: E402

PROBE = HERE / "build" / "probe"
EVENTS = 256  # timestamps a block records
TAGS = {0: "start", 1: "pro", 2: "gemv", 3: "bar_in", 4: "bar_out"}
PHASES = ("qkv", "attn", "proj", "fc", "fcp")

# The dispatch cut to the kernels this script runs (a shorter build).
CUTS = ("if (D == 128) return f.run<T, KK, VK, WK, 128>();",
        "if (kk == 4 && vk == 4) return by_tier<T, 4, 4>(f);",
        "if (kk == 8 && vk == 4) return by_tier<T, 8, 4>(f);",
        "if (f.sa.a.dtype == 0) return by_panes<float>(f);")


def instrument(src: str) -> str:
    """The step's source with the timestamps and their reader added."""
    def rep(old, new):
        nonlocal src
        if old not in src:
            raise RuntimeError(f"gpt2_megastep.cu changed: {old!r} not found")
        src = src.replace(old, new)

    for cut in CUTS:
        rep(cut, "")
    rep("long long g_kernels = 0;",
        "long long g_kernels = 0;\n"
        f"__device__ long long g_probe[2][{2 * EVENTS}];\n"
        "__device__ unsigned long long g_acc[4];")
    rep("  __device__ __forceinline__ void issue_next() {\n",
        "  __device__ __forceinline__ void issue_next() {\n"
        "    const long long t_in = globaltimer();\n")
    rep("    ++is_tile;\n    if (++is_slot == slots) is_slot = 0;\n",
        "    ++is_tile;\n    if (++is_slot == slots) is_slot = 0;\n"
        "    if (blockIdx.x == 0) {\n"
        "      atomicAdd(&g_acc[0], (unsigned long long)(globaltimer() - t_in));\n"
        "      atomicAdd(&g_acc[1], 1ull);\n    }\n")
    rep("    const int slot = use_slot;\n    mbar_wait(&full[slot], use_parity);\n",
        "    const int slot = use_slot;\n    const long long t_w = globaltimer();\n"
        "    mbar_wait(&full[slot], use_parity);\n"
        "    if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
        "      atomicAdd(&g_acc[2], (unsigned long long)(globaltimer() - t_w));\n"
        "      atomicAdd(&g_acc[3], 1ull);\n    }\n")
    anchor = "  auto x_at = [&](int e) { return ldcg_f32(x + e); };\n"
    rep(anchor, anchor + "  int probe_i = 0;\n"
        "  auto PT = [&](int tag) {\n"
        "    if (tid == 0 && (blockIdx.x == 0 || blockIdx.x == P.grid - 1)) {\n"
        "      long long* e = g_probe[blockIdx.x ? 1 : 0] + 2 * probe_i;\n"
        "      e[0] = tag;\n      e[1] = globaltimer();\n    }\n"
        "    probe_i++;\n  };\n  PT(0);\n")
    head, tail = src.split(anchor, 1)
    lines = []
    for ln in tail.split("\n"):
        st = ln.strip()
        if st == "grid_sync(bar, P.grid);":
            ln = ln.replace(st, "PT(3); grid_sync(bar, P.grid); PT(4);")
        elif st == "if (!met) grid_sync(bar, P.grid);":
            ln = ln.replace(st, "if (!met) { PT(3); grid_sync(bar, P.grid); PT(4); }")
        elif (("norm_to_h<T, WK>(h, x_at" in ln or "vec_to_h<T, WK>(" in ln
               or st == "}, E, sm, sm + E, a.ln_eps, red);") and ln.endswith(");")):
            ln += " PT(1);"
        elif st.startswith(("gemv_phase<", "head_phase<")):
            ln += " PT(2);"
        lines.append(ln)
    src = head + anchor + "\n".join(lines)
    rep('extern "C" long long elit_gpt2_megastep_kernels()',
        'extern "C" int elit_probe_read(long long* ev, unsigned long long* acc) {\n'
        "  cudaMemcpyFromSymbol(ev, g_probe, sizeof(g_probe));\n"
        "  cudaMemcpyFromSymbol(acc, g_acc, sizeof(g_acc));\n"
        "  const unsigned long long z[4] = {0, 0, 0, 0};\n"
        "  return (int)cudaMemcpyToSymbol(g_acc, z, sizeof(z));\n}\n"
        'extern "C" long long elit_gpt2_megastep_kernels()')
    return src


def build(name: str, source: str) -> ctypes.CDLL:
    """The probe library `name` built from csrc/ with gpt2_megastep.cu's
    source replaced by `source`."""
    work = PROBE / f"src_{name}"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(_build.CSRC, work)
    (work / "gpt2_megastep.cu").write_text(source)
    out = PROBE / f"{name}.so"
    proc = subprocess.run([_build.nvcc(), *_build.FLAGS, "-o", str(out),
                           str(work / "gpt2_megastep.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    for fn in (lib.elit_gpt2_megastep, lib.elit_gpt2_megastep_quant,
               lib.elit_gpt2_megastep_skeleton):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(mk.Gpt2StepArgs), ctypes.c_void_p]
    lib.elit_gpt2_megastep_grid.restype = ctypes.c_int
    lib.elit_gpt2_megastep_grid.argtypes = [ctypes.POINTER(mk.Gpt2StepArgs),
                                            ctypes.POINTER(ctypes.c_int),
                                            ctypes.POINTER(ctypes.c_int)]
    lib.elit_cuda_error_string.restype = ctypes.c_char_p
    lib.elit_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def split(events: np.ndarray) -> dict:
    """µs a step by phase and interval from one block's (tag, time) events."""
    ev = [(int(t), int(ns)) for t, ns in events.reshape(-1, 2) if ns > 0]
    out, phase = defaultdict(float), 0
    for (t0, ns0), (t1, ns1) in zip(ev, ev[1:]):
        name = PHASES[phase % 5] if phase < 5 * 12 else "head"
        out[f"{name}:{TAGS[t0]}>{TAGS[t1]}"] += (ns1 - ns0) / 1e3
        phase += t1 == 4
    out["total"] = (ev[-1][1] - ev[0][1]) / 1e3
    return {k: round(v, 2) for k, v in sorted(out.items(), key=lambda kv: -kv[1])}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gpt2_step_phases: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    PROBE.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "gpt2_megastep.cu").read_text()
    plain_src = source
    for cut in CUTS:
        plain_src = plain_src.replace(cut, "")
    libs = {"plain": build("gpt2_phases_plain", plain_src),
            "instrumented": build("gpt2_phases", instrument(source))}
    cfg = gpt2_mod.GPT2Config.small()
    spec = spec_by_name("gpt2")
    params = gpt2_mod.init_gpt2_params(torch.Generator().manual_seed(42), cfg,
                                       torch.bfloat16, "cuda")
    g = torch.Generator().manual_seed(0)
    x = (torch.randn((1, cfg.n_embd), generator=g) * 0.3).to(torch.bfloat16).cuda()
    panes = [(torch.randn((cfg.n_layer, 320, cfg.n_embd), generator=g) * 0.5)
             .to(torch.bfloat16).cuda() for _ in range(2)]
    length = torch.tensor([319], dtype=torch.int32, device="cuda")
    tok = torch.zeros(1, dtype=torch.int32, device="cuda")
    for weights in ("bf16", "int8", "int4"):
        if weights == "bf16":
            packed = mk.pack_gpt2_mega(params, cfg)
        else:
            _, mode, group = weight_quant_plan(spec, weights)
            packed = mk.pack_gpt2_mega(quantize_weights(spec, params, mode, group), cfg)
        ms = {}
        for name, lib in libs.items():
            mk._lib = lib
            step = mk.StepLauncher(packed, cfg, *panes, length, tok, x_emb=x)
            ms[name] = device_ms(step.launch, calls=20)
        ev = (ctypes.c_longlong * (2 * 2 * EVENTS))()
        acc = (ctypes.c_ulonglong * 4)()
        libs["instrumented"].elit_probe_read(ev, acc)  # clears the counters
        step.launch()
        torch.cuda.synchronize()
        libs["instrumented"].elit_probe_read(ev, acc)
        events = np.array(ev[:], dtype=np.int64).reshape(2, 2 * EVENTS)
        for b, block in enumerate((0, step.args.grid - 1)):
            row = {"weights": weights, "block": block, "grid": step.args.grid,
                   "ms": ms, "us": split(events[b])}
            if b == 0:
                row.update(issue_us=acc[0] / 1e3, issues=acc[1], tile_wait_us=acc[2] / 1e3,
                           tiles=acc[3])
            print(json.dumps(row), flush=True)
        del packed
    return 0


if __name__ == "__main__":
    sys.exit(main())
