#!/usr/bin/env python3
"""Where the time of GPT-2's persistent steps goes, phase by phase, on one GPU.

    python3 scripts/torch_gpt2_step_phases.py [--batch B[,B...] | --verify R[,R...]] [--bf16]

Builds a copy of csrc/gpt2_megastep.cu (with --batch: csrc/gpt2_megabatch.cu;
with --verify: csrc/gpt2_megaverify.cu, the verify pass of R rows at cur =
C - 16 of C = 344, token ids in) and of the persistent-step header it
includes, csrc/persistent_step.cuh,
with timestamps added (the %globaltimer of thread 0 of the first and the
last block: at the step's start, after each phase's prologue, after each
GEMV phase, on entering and on leaving each grid barrier; and, for block 0,
the time its thread 0 spends issuing the ring's copies and waiting for
tiles), with only the bf16 kernels (single stream: at head_dim 64) over fp
and int8 panes, into build/probe/. It then runs GPT-2 small's step (random
weights from seed 42, C = 320, fp panes; single stream at length 319, the
batched step at B slots of lengths 0, 1, 7, 8, 100, 255, 318, 319 repeated)
over bf16, int8 and int4 weights (with --bf16, bf16 alone), and prints one
JSON line each per block:
microseconds a step summed over the 12 layers by phase and interval
(`qkv:pro>gemv` is the qkv phase's tiles and epilogues, split for the
batched step into `tile` (a tile's bytes in), `mma` (its product) and `sync`
(the block barrier after it), `attn:bar_out>bar_in` the attention phase
(batched: `attn:bar_out>items` its warps' items, `attn:items>bar_in` the
writers), `fc:bar_in>bar_out` the wait at the fc phase's grid
barrier, `head:pro>gemv` the LM head; the batched step's fc_proj stages its
input quarters inside its tiles, so `fcp:pro>gemv` holds them), and the
step's device ms timed plain and instrumented (CUDA-graph replay), the
card's name and power limit first. The timestamps cost a little: read the
split, time the kernel with scripts/torch_kernel_compare.py. Imports nothing
of JAX.
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
from efficient_llm_inference_tpu_torch.ops import megakernel_batch as mkb  # noqa: E402
from torch_kernel_compare import device_ms  # noqa: E402

PROBE = HERE / "build" / "probe"
EVENTS = 1024  # timestamps a block records
TAGS = {0: "start", 1: "pro", 2: "gemv", 3: "bar_in", 4: "bar_out", 5: "tile", 6: "mma",
        7: "sync", 8: "items", 9: "staged"}
PHASES = ("qkv", "attn", "proj", "fc", "fcp")
LENGTHS = (0, 1, 7, 8, 100, 255, 318, 319)

# The dispatch cut to the kernels this script runs (a shorter build).
CUTS = {
    "gpt2_megastep": ("if (D == 128) return f.run<T, KK, VK, WK, 128>();",
                      "if (kk == 4 && vk == 4) return by_tier<T, 4, 4>(f);",
                      "if (kk == 8 && vk == 4) return by_tier<T, 8, 4>(f);",
                      "if (f.sa.a.dtype == 0) return by_panes<float>(f);"),
    "gpt2_megabatch": ("if (kk == 4 && vk == 4) return by_tier<T, 4, 4>(f);",
                       "if (kk == 8 && vk == 4) return by_tier<T, 8, 4>(f);",
                       "if (f.ba.s.a.dtype == 0) return by_panes<float>(f);"),
    "gpt2_megaverify": ("if (D == 128) return f.run<T, WK, 128>();",
                        "if (f.va.s.a.dtype == 0) return by_tier<float>(f);"),
}


def _rep(text: str, old: str, new: str, where: str) -> str:
    if old not in text:
        raise RuntimeError(f"{where} changed: {old!r} not found")
    return text.replace(old, new)


def instrument_header(hdr: str) -> str:
    """persistent_step.cuh with the probe's storage and marker PT(tag) (thread
    0 of the first and the last block records (tag, time)), and block 0's
    copy-issue and tile-wait times in the weight stream."""
    anchor = "// A bounded wait: traps with the block and what it waited for after kSpinNs.\n"
    hdr = _rep(hdr, anchor,
               f"__device__ long long g_probe[2][{2 * EVENTS}];\n"
               "__device__ unsigned long long g_acc[4];\n"
               "__shared__ int g_probe_i;\n"
               "__device__ __forceinline__ void PT(int tag) {\n"
               "  if (threadIdx.x != 0) return;\n"
               "  if (blockIdx.x == 0 || blockIdx.x == gridDim.x - 1) {\n"
               "    long long* e = g_probe[blockIdx.x ? 1 : 0] + 2 * g_probe_i;\n"
               "    e[0] = tag;\n    e[1] = globaltimer();\n  }\n"
               "  g_probe_i++;\n}\n" + anchor, "persistent_step.cuh")
    hdr = _rep(hdr, "  __device__ __forceinline__ void issue_next() {\n",
               "  __device__ __forceinline__ void issue_next() {\n"
               "    const long long t_in = globaltimer();\n", "persistent_step.cuh")
    hdr = _rep(hdr, "    ++is_tile;\n    if (++is_slot == slots) is_slot = 0;\n",
               "    ++is_tile;\n    if (++is_slot == slots) is_slot = 0;\n"
               "    if (blockIdx.x == 0) {\n"
               "      atomicAdd(&g_acc[0], (unsigned long long)(globaltimer() - t_in));\n"
               "      atomicAdd(&g_acc[1], 1ull);\n    }\n", "persistent_step.cuh")
    hdr = _rep(hdr, "    const int slot = use_slot;\n    mbar_wait(&full[slot], use_parity);\n",
               "    const int slot = use_slot;\n    const long long t_w = globaltimer();\n"
               "    mbar_wait(&full[slot], use_parity);\n"
               "    if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
               "      atomicAdd(&g_acc[2], (unsigned long long)(globaltimer() - t_w));\n"
               "      atomicAdd(&g_acc[3], 1ull);\n    }\n", "persistent_step.cuh")
    return hdr


def _reader(src: str, name: str) -> str:
    return _rep(src, f'extern "C" long long elit_{name}_kernels()',
                'extern "C" int elit_probe_read(long long* ev, unsigned long long* acc) {\n'
                "  cudaMemcpyFromSymbol(ev, g_probe, sizeof(g_probe));\n"
                "  cudaMemcpyFromSymbol(acc, g_acc, sizeof(g_acc));\n"
                "  static long long zero[sizeof(g_probe) / sizeof(long long)] = {0};\n"
                "  cudaMemcpyToSymbol(g_probe, zero, sizeof(g_probe));\n"
                "  const unsigned long long z[4] = {0, 0, 0, 0};\n"
                "  return (int)cudaMemcpyToSymbol(g_acc, z, sizeof(z));\n}\n"
                f'extern "C" long long elit_{name}_kernels()', name)


def instrument(src: str) -> str:
    """The single-stream step's source with the phase markers added."""
    anchor = "  auto x_at = [&](int e) { return ldcg_f32(x + e); };\n"
    src = _rep(src, anchor, anchor + "  if (tid == 0) g_probe_i = 0;\n  PT(0);\n",
               "gpt2_megastep.cu")
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
    return _reader(head + anchor + "\n".join(lines), "gpt2_megastep")


def instrument_batch(src: str) -> str:
    """The batched step's source with the phase markers added (fc_proj's
    prologue, its quarters' staging, is inside its tiles)."""
    anchor = "  Stream<T, WK> S;\n  S.init(a, P.grid"
    src = _rep(src, anchor, "  if (tid == 0) g_probe_i = 0;\n  PT(0);\n" + anchor,
               "gpt2_megabatch.cu")
    # inside a GEMV phase: a tile's (or held tiles') arrival, product, barrier
    src = _rep(src, "      n_rows[i] = i < nh ? min(RT, rows - (t0 + i) * RT) : 0;\n    }\n",
               "      n_rows[i] = i < nh ? min(RT, rows - (t0 + i) * RT) : 0;\n    }\n"
               "    PT(5);\n", "gpt2_megabatch.cu")
    src = _rep(src, "    for (int i = 0; i < nh; ++i) S.consumed();",
               "    PT(6);\n    for (int i = 0; i < nh; ++i) S.consumed();\n    PT(7);",
               "gpt2_megabatch.cu")
    src = _rep(src, "  grid_sync(P.sync, P.grid);  // the qkv phase's",
               "  PT(3); grid_sync(P.sync, P.grid); PT(4);  // the qkv phase's", "gpt2_megabatch.cu")
    src = _rep(src, "  __syncthreads();  // the writers reuse the warps' scores",
               "  __syncthreads();  // the writers reuse the warps' scores\n  PT(8);",
               "gpt2_megabatch.cu")
    src = _rep(src, "    gemv_phase<T, WK>(S, P, kind, l, epi, scales, bias, out, ffn, smem, rpar, best);",
               "    PT(1);\n"
               "    gemv_phase<T, WK>(S, P, kind, l, epi, scales, bias, out, ffn, smem, rpar, best);"
               "\n    PT(2);", "gpt2_megabatch.cu")
    src = _rep(src, "    if (kind != K_HEAD) grid_sync(bar, P.grid);",
               "    if (kind != K_HEAD) { PT(3); grid_sync(bar, P.grid); PT(4); }", "gpt2_megabatch.cu")
    return _reader(src, "gpt2_megabatch")


def instrument_verify(src: str) -> str:
    """The verify pass's source with the phase markers added."""
    anchor = "  S.fill();\n  const int cur = __ldcg(a.length);\n"
    src = _rep(src, anchor, anchor + "  if (tid == 0) g_probe_i = 0;\n  PT(0);\n",
               "gpt2_megaverify.cu")
    src = _rep(src, "    const bool rows = S.plan[kind].tiles > 0;\n",
               "    const bool rows = S.plan[kind].tiles > 0;\n    PT(9);\n", "gpt2_megaverify.cu")
    src = _rep(src, "    gemv_phase<T, WK>(S, P, h, kind, l, cur, ys, s4s, bv, bi);\n",
               "    PT(1);\n    gemv_phase<T, WK>(S, P, h, kind, l, cur, ys, s4s, bv, bi);\n"
               "    PT(2);\n", "gpt2_megaverify.cu")
    src = _rep(src, "    if (kind != K_HEAD) grid_sync(P.sync, P.grid);",
               "    if (kind != K_HEAD) { PT(3); grid_sync(P.sync, P.grid); PT(4); }",
               "gpt2_megaverify.cu")
    src = _rep(src, "    if (!met) grid_sync(P.sync, P.grid);",
               "    if (!met) { PT(3); grid_sync(P.sync, P.grid); PT(4); }", "gpt2_megaverify.cu")
    src = _rep(src, "    __syncthreads();  // the next item reuses the shared memory\n  }\n",
               "    __syncthreads();  // the next item reuses the shared memory\n  }\n  PT(8);\n",
               "gpt2_megaverify.cu")
    return _reader(src, "gpt2_megaverify")


def build(name: str, source: str, header: str, which: str) -> ctypes.CDLL:
    """The probe library `name` built from csrc/ with csrc/<which>.cu's
    source and persistent_step.cuh replaced by `source` and `header`."""
    work = PROBE / f"src_{name}"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(_build.CSRC, work)
    (work / f"{which}.cu").write_text(source)
    (work / "persistent_step.cuh").write_text(header)
    out = PROBE / f"{name}.so"
    proc = subprocess.run([_build.nvcc(), *_build.FLAGS, "-o", str(out),
                           str(work / f"{which}.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    args = {"gpt2_megabatch": mkb.GPT2BatchArgs,
            "gpt2_megaverify": mk.GPT2VerifyArgs}.get(which, mk.Gpt2StepArgs)
    entries = ("",) if which == "gpt2_megaverify" else ("", "_quant", "_skeleton")
    for fn in (getattr(lib, f"elit_{which}{e}") for e in entries):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(args), ctypes.c_void_p]
    grid = getattr(lib, f"elit_{which}_grid")
    grid.restype = ctypes.c_int
    grid.argtypes = [ctypes.POINTER(args), ctypes.POINTER(ctypes.c_int),
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


def run(B, libs, cfg, spec, params, weights_run) -> None:
    """One step's split (B None: the single stream) over each weight tier."""
    g = torch.Generator().manual_seed(0)
    rows = 1 if B is None else B
    x = (torch.randn((rows, cfg.n_embd), generator=g) * 0.3).to(torch.bfloat16).cuda()
    lead = () if B is None else (B,)
    panes = [(torch.randn((cfg.n_layer, *lead, 320, cfg.n_embd), generator=g) * 0.5)
             .to(torch.bfloat16).cuda() for _ in range(2)]
    length = torch.tensor([319] if B is None else [LENGTHS[b % 8] for b in range(B)],
                          dtype=torch.int32, device="cuda")
    tok = torch.zeros(rows, dtype=torch.int32, device="cuda")
    launcher = mk.StepLauncher if B is None else mkb.GPT2BatchLauncher
    for weights in weights_run:
        if weights == "bf16":
            packed = mk.pack_gpt2_mega(params, cfg)
        else:
            _, mode, group = weight_quant_plan(spec, weights)
            packed = mk.pack_gpt2_mega(quantize_weights(spec, params, mode, group), cfg)
        ms = {}
        for name, lib in libs.items():
            if B is None:
                mk._lib = lib
            else:
                mkb._gpt2_lib = lib
            step = launcher(packed, cfg, *panes, length, tok, x_emb=x)
            ms[name] = device_ms(step.launch, calls=20)
        _probe(libs, step, {"weights": weights, "B": rows, "ms": ms})
        del packed


def run_verify(R, libs, cfg, spec, params, weights_run) -> None:
    """One verify pass's split at R rows over each weight tier."""
    C = 344
    g = torch.Generator().manual_seed(0)
    panes = [(torch.randn((cfg.n_layer, C, cfg.n_embd), generator=g) * 0.5)
             .to(torch.bfloat16).cuda() for _ in range(2)]
    length = torch.tensor([C - 16], dtype=torch.int32, device="cuda")
    ids = torch.randint(0, cfg.vocab_size, (R,), generator=g).to(torch.int32).cuda()
    tok = torch.zeros(R, dtype=torch.int32, device="cuda")
    for weights in weights_run:
        if weights == "bf16":
            packed = mk.pack_gpt2_mega(params, cfg)
        else:
            _, mode, group = weight_quant_plan(spec, weights)
            packed = mk.pack_gpt2_mega(quantize_weights(spec, params, mode, group), cfg)
        ms = {}
        for name, lib in libs.items():
            mk._gpt2_verify_lib = lib
            step = mk.GPT2VerifyLauncher(packed, cfg, *panes, length, tok, tok_in=ids, rows=R)
            ms[name] = device_ms(step.launch, calls=20)
        _probe(libs, step, {"weights": weights, "R": R, "ms": ms})
        del packed


def _probe(libs, step, head) -> None:
    """One instrumented launch of `step`: a JSON line per probed block."""
    ev = (ctypes.c_longlong * (2 * 2 * EVENTS))()
    acc = (ctypes.c_ulonglong * 4)()
    libs["instrumented"].elit_probe_read(ev, acc)  # clears the counters
    step.launch()
    torch.cuda.synchronize()
    libs["instrumented"].elit_probe_read(ev, acc)
    events = np.array(ev[:], dtype=np.int64).reshape(2, 2 * EVENTS)
    for b, block in enumerate((0, step.args.grid - 1)):
        row = {**head, "block": block, "grid": step.args.grid, "us": split(events[b])}
        if b == 0:
            row.update(issue_us=acc[0] / 1e3, issues=acc[1], tile_wait_us=acc[2] / 1e3,
                       tiles=acc[3])
        print(json.dumps(row), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gpt2_step_phases: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    batches = ([int(b) for b in args[args.index("--batch") + 1].split(",")]
               if "--batch" in args else [None])
    verify = ([int(r) for r in args[args.index("--verify") + 1].split(",")]
              if "--verify" in args else None)
    B = batches[0]
    weights_run = ("bf16",) if "--bf16" in args else ("bf16", "int8", "int4")
    which = ("gpt2_megaverify" if verify else
             "gpt2_megastep" if B is None else "gpt2_megabatch")
    marks = {"gpt2_megastep": instrument, "gpt2_megabatch": instrument_batch,
             "gpt2_megaverify": instrument_verify}[which]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    PROBE.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / f"{which}.cu").read_text()
    header = (_build.CSRC / "persistent_step.cuh").read_text()
    for cut in CUTS[which]:
        source = _rep(source, cut, "", which)
    libs = {"plain": build(f"{which}_plain", source, header, which),
            "instrumented": build(f"{which}_phases", marks(source),
                                  instrument_header(header), which)}
    cfg = gpt2_mod.GPT2Config.small()
    spec = spec_by_name("gpt2")
    params = gpt2_mod.init_gpt2_params(torch.Generator().manual_seed(42), cfg,
                                       torch.bfloat16, "cuda")
    for R in verify or ():
        run_verify(R, libs, cfg, spec, params, weights_run)
    for B in () if verify else batches:
        run(B, libs, cfg, spec, params, weights_run)
    return 0


if __name__ == "__main__":
    sys.exit(main())
