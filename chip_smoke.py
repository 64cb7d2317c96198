#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, and check it.

    python3 chip_smoke.py

Phases (each prints one line with its seconds):

1. build: compile every CUDA kernel of the port with nvcc (one process per
   source, all at once) and print the card's name and power limit;
2. kernels: at the main path's shapes (GPT-2 small: H=12, D=64, C=320 = a
   256-token prompt + 64 new tokens), hold each kernel against its plain
   PyTorch version on the same inputs on the card (quantize: bit-exact;
   attention: fp32 atol 1e-4, bf16 atol 2e-2) and time kernel, plain
   version, library yardstick and bound;
3. main path: InferenceEngine.from_model_name("gpt2") on CUDA in bf16 (random
   weights from a seed), benchmark_method over 2 prompts of 256 tokens with
   64 new tokens for full_cache, quant_int8, quant_int4 and quant_mixed. The
   launch counters are zeroed just before and read just after each method,
   and each quant_* method must launch the attention kernel exactly
   layers x decode steps times and the rows kernels once per layer, K and V
   and forward pass;
4. fp32 hold: the same model in fp32 on the card; its greedy tokens,
   teacher-forced through the plain versions on the CPU, must give every
   step's logits within 1e-3 (and the same argmax wherever the top two are
   more than 1e-3 apart).

Then it prints the kernels' JSON line, the card's name and power limit, and
as the last line {"ok": true, "device": {...}}. Any failure raises and exits
nonzero without that line. Float32 matrix products run in full fp32 (TF32
off). Kernel times are device times per call from CUDA-graph replay (warm
L2); the eager time per call, host enqueue included, is printed beside them.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_FLOP_PER_S = 67e12  # fp32 outside the tensor cores
PROMPT_TOKENS, NEW_TOKENS, N_PROMPTS, SEED = 256, 64, 2, 0
METHODS = ("full_cache", "quant_int8", "quant_int4", "quant_mixed")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def eager_ms(fn, iters: int = 100) -> float:
    """Time per call of back-to-back eager calls: what a caller's loop pays,
    host enqueue included (for small kernels the host is the limit)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def device_ms(fn, calls: int = 50, replays: int = 5) -> float:
    """Device time per call: `calls` calls captured in one CUDA graph and
    replayed, so the host's enqueue rate does not enter. Inputs stay in L2
    (warm), as they are small."""
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
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(replays):
        graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / (calls * replays)


def bound_ms(n_bytes: float, n_flops: float) -> tuple:
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_flops / H100_FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build() -> None:
    from efficient_llm_inference_tpu_torch.ops import _build

    t0 = time.perf_counter()
    seconds = _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
    log(f"phase build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc per source: {json.dumps({k: round(v, 1) for k, v in seconds.items()})})")
    for name in _build.SOURCES:
        log_path = _build.BUILD_DIR / f"{name}.log"
        regs = [ln.strip() for ln in log_path.read_text().splitlines()
                if "registers" in ln or "spill" in ln] if log_path.exists() else []
        log(f"  ptxas {name}: " + " | ".join(regs[:4]))
    log(f"card: {card_line()}")


def _rows_inputs(dtype, rows, n, stride, seed):
    g = torch.Generator().manual_seed(seed)
    buf = torch.randn((rows, stride), generator=g) * torch.rand((rows, 1), generator=g) * 4
    return buf.to(dtype).cuda()[:, :n]


def check_quantize(bits: int) -> dict:
    """Bit-exact on the shapes the main path gives the rows kernels: a
    per_token decode row of one token's [H*D] values (a view with the qkv row
    stride), a prefill block of 256 such rows, and per_head rows."""
    from efficient_llm_inference_tpu_torch.ops import quantize as q

    wrapper = q.quantize_int8_rows if bits == 8 else q.quantize_int4_rows
    plain = q.quantize_int8_rows_plain if bits == 8 else q.quantize_int4_rows_plain
    shapes = [(1, 768, 2304), (256, 768, 2304), (12, 64, 64)]
    report = None
    for dtype in (torch.bfloat16, torch.float32):
        for rows, n, stride in shapes:
            x = _rows_inputs(dtype, rows, n, stride, seed=rows + bits)
            got, want = wrapper(x), plain(x)
            torch.cuda.synchronize()
            for g_, w_ in zip(got, want):
                if not torch.equal(g_, w_):
                    raise AssertionError(f"quantize_int{bits}_rows {dtype} "
                                         f"[{rows},{n}] differs from plain")
            if dtype == torch.bfloat16 and rows == 1:  # the decode write
                out_bytes = rows * (n if bits == 8 else n // 2) + rows * 4
                b, by = bound_ms(rows * n * x.element_size() + out_bytes, 4 * rows * n)
                report = {
                    "ms": device_ms(lambda: wrapper(x)),
                    "plain_ms": device_ms(lambda: plain(x)),
                    "eager_ms": eager_ms(lambda: wrapper(x)),
                    "bound_ms": b, "bound_by": by, "library_ms": None,
                    "shape": f"bf16 [{rows},{n}] row stride {stride}",
                }
    report["max_abs_err"] = 0.0
    log(f"  quantize_int{bits}_rows: bit-exact on {len(shapes)} shapes x "
        f"bf16/fp32; decode row {report['shape']}: device ms kernel {report['ms']:.5f}, "
        f"plain {report['plain_ms']:.5f}, bound {report['bound_ms']:.7f}; "
        f"eager kernel call {report['eager_ms']:.5f} ms")
    return report


def _attention_inputs(k_bits, v_bits, dtype, seed, B=1, H=12, C=320, D=64, length=319):
    """Inputs as QuantizedKV's decode step gives them at the last step of the
    main path: per_token scales (one per token, shared by the heads, an
    expanded view), the current token as the one extra row."""
    g = torch.Generator().manual_seed(seed)

    def store(bits):
        if bits == 8:
            return torch.randint(-127, 128, (B, H, C, D), generator=g, dtype=torch.int8)
        if bits == 4:
            return torch.randint(0, 256, (B, H, C, D // 2), generator=g,
                                 dtype=torch.int32).to(torch.uint8)
        return torch.randn((B, H, C, D), generator=g).to(dtype)

    def scale():
        return (torch.rand(C, generator=g) * 0.02 + 1e-3).cuda().expand(B, H, C)

    qkv = torch.randn((B, 1, 3 * H * D), generator=g).to(dtype).cuda()
    q, k_new, v_new = (t.reshape(B, 1, H, D).transpose(1, 2)
                       for t in qkv.split(H * D, dim=-1))
    lengths = torch.full((B,), length, dtype=torch.int32).cuda()
    return [q[:, :, 0], store(k_bits).cuda(), scale(), store(v_bits).cuda(), scale(),
            k_new, v_new, lengths]


def check_attention() -> dict:
    from efficient_llm_inference_tpu_torch.ops import attention as a
    from efficient_llm_inference_tpu_torch.ops.quantization import (
        dequantize_int4_packed, dequantize_int8)

    F = torch.nn.functional
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    report = None
    for k_bits, v_bits in ((8, 8), (4, 4), (8, 4), (16, 16)):
        for dtype in (torch.float32, torch.bfloat16):
            args = _attention_inputs(k_bits, v_bits, dtype, seed=k_bits * 3 + v_bits)
            got = a.fused_quant_attention_batched(*args, 1, k_bits=k_bits, v_bits=v_bits)
            want = a.fused_quant_attention_batched_plain(*args, 1, k_bits=k_bits,
                                                         v_bits=v_bits)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = 1e-4 if dtype == torch.float32 else 2e-2
            if not err <= tol:
                raise AssertionError(f"attention k{k_bits}/v{v_bits} {dtype}: "
                                     f"max |kernel - plain| {err} > {tol}")
            worst[dtype] = max(worst[dtype], err)
            if k_bits == 16 or dtype != torch.bfloat16:
                continue
            q, kq, ks, vq, vs, ke, ve, lengths = args
            B, H, D = q.shape
            L = int(lengths[0])

            def deq(codes, scale, bits):
                fn = dequantize_int8 if bits == 8 else dequantize_int4_packed
                return fn(codes[:, :, :L], scale[:, :, :L, None], dtype)

            def library():  # dequantize the visible rows, then one SDPA call
                k = torch.cat([deq(kq, ks, k_bits), ke], dim=2)
                v = torch.cat([deq(vq, vs, v_bits), ve], dim=2)
                return F.scaled_dot_product_attention(q[:, :, None], k, v)

            lib_err = (library()[:, :, 0].float() - want.float()).abs().max().item()
            row = lambda b: H * (D if b == 8 else D // 2) + 4  # noqa: E731
            n_bytes = (2 * B * H * D * 2  # q in, out
                       + B * L * (row(k_bits) + row(v_bits))  # visible codes + scales
                       + 2 * B * H * D * 2 + B * 4)  # current-token K/V, length
            b, by = bound_ms(n_bytes, B * H * (L + 1) * (4 * D + 8))
            kernel = lambda: a.fused_quant_attention_batched(  # noqa: E731
                *args, 1, k_bits=k_bits, v_bits=v_bits)
            entry = {
                "ms": device_ms(kernel),
                "plain_ms": device_ms(lambda: a.fused_quant_attention_batched_plain(
                    *args, 1, k_bits=k_bits, v_bits=v_bits)),
                "library_ms": device_ms(library),
                "bound_ms": b, "bound_by": by,
            }
            log(f"  attention k{k_bits}/v{v_bits} bf16 B=1 H=12 D=64 C=320 len={L}: "
                f"device ms kernel {entry['ms']:.5f}, plain {entry['plain_ms']:.5f}, "
                f"dequant+sdpa {entry['library_ms']:.5f} (|diff| {lib_err:.2e}), "
                f"bound {b:.7f} ({by}); eager kernel call {eager_ms(kernel):.5f} ms; "
                f"max|kernel-plain| {err:.2e}")
            if (k_bits, v_bits) == (8, 8):
                report = entry
    log(f"  attention max|kernel-plain|: fp32 {worst[torch.float32]:.2e} (tol 1e-4), "
        f"bf16 {worst[torch.bfloat16]:.2e} (tol 2e-2)")
    report["max_abs_err"] = max(worst.values())
    return report


def _prompts(n: int, seed: int):
    """n prompts of PROMPT_TOKENS bytes (one token each) of lowercase words."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    out = []
    for _ in range(n):
        chars = letters[rng.integers(0, 26, PROMPT_TOKENS)]
        chars[rng.random(PROMPT_TOKENS) < 0.18] = ord(" ")
        out.append(chars.tobytes().decode())
    return out


def counters():
    from efficient_llm_inference_tpu_torch.ops import attention, quantize

    return {
        "fused_quant_attention_batched": attention.fused_quant_attention_batched,
        "quantize_int8_rows": quantize.quantize_int8_rows,
        "quantize_int4_rows": quantize.quantize_int4_rows,
    }


def phase_main_path(launches: dict) -> None:
    from efficient_llm_inference_tpu_torch import InferenceEngine

    eng = InferenceEngine.from_model_name("gpt2")  # CUDA, bf16, seed 42
    assert eng.config.device == "cuda" and eng.config.dtype == torch.bfloat16
    assert eng.params["wte"].is_cuda
    prompts = _prompts(N_PROMPTS, SEED)
    assert all(len(eng.tokenizer.encode(p)) == PROMPT_TOKENS for p in prompts)
    L = eng.model.n_layer
    n_gen = N_PROMPTS + 1  # benchmark_method warms up once (one bucket)
    for method in METHODS:
        for fn in counters().values():
            fn.launches = 0
        res = eng.benchmark_method(prompts, method=method, max_new_tokens=NEW_TOKENS)
        got = {name: fn.launches for name, fn in counters().items()}
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
        ids = eng.last_generation_ids
        new = ids[-NEW_TOKENS:]
        assert len(ids) == PROMPT_TOKENS + NEW_TOKENS, len(ids)
        assert all(0 <= t < eng.model.vocab_size for t in new)
        assert res["total_new_tokens"] == N_PROMPTS * NEW_TOKENS
        assert math.isfinite(res["tokens_per_sec"]) and res["tokens_per_sec"] > 0
        if method == "full_cache":
            want = {name: 0 for name in got}
        else:
            mode = method.replace("quant_", "")
            per_pass = L * n_gen * (NEW_TOKENS + 1)  # prefill + each decode step
            k8, v8 = mode in ("int8", "mixed"), mode == "int8"
            want = {
                "fused_quant_attention_batched": L * NEW_TOKENS * n_gen,
                "quantize_int8_rows": per_pass * (k8 + v8),
                "quantize_int4_rows": per_pass * ((not k8) + (not v8)),
            }
        if got != want:
            raise AssertionError(f"{method}: launches {got}, expected {want}")
        log(f"  {method}: {res['tokens_per_sec']:.1f} tokens/s "
            f"({res['total_new_tokens']} new tokens in {res['elapsed_sec']:.3f} s, "
            f"peak {res['gpu_peak_mb']} MB, est KV {res['est_kv_cache_mb_avg']:.3f} MB), "
            f"launches {json.dumps(got)}, last tokens {new[:8]}")


def phase_fp32_hold() -> None:
    from efficient_llm_inference_tpu_torch import Config, InferenceEngine

    eng = InferenceEngine.from_model_name(
        "gpt2", config=Config(model_name="gpt2", dtype=torch.float32))
    params_cpu = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict)
                      else v.cpu()) for k, v in eng.params.items()}
    ref = InferenceEngine(eng.model, params_cpu, eng.tokenizer,
                          Config(model_name="gpt2", device="cpu", dtype=torch.float32))
    prompt = _prompts(1, SEED + 1)[0]
    cases = [(m, "per_token") for m in METHODS] + [("quant_mixed", "per_head")]
    for method, gran in cases:
        kw = {} if method == "full_cache" else {"granularity": gran}
        toks, logits = eng.generate_logits(prompt, method, NEW_TOKENS, **kw)
        _, want = ref.generate_logits(prompt, method, NEW_TOKENS, forced=toks, **kw)
        logits = logits.cpu()
        err = (logits - want).abs().max().item()
        if not err <= 1e-3:
            raise AssertionError(f"fp32 {method} {gran}: max |logits diff| {err}")
        top2 = want.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 1e-3
        same = logits.argmax(-1) == want.argmax(-1)
        if not bool(same[clear].all()):
            raise AssertionError(f"fp32 {method} {gran}: argmax differs at a clear step")
        assert torch.isfinite(logits).all()
        log(f"  fp32 {method} {gran}: max |card - plain on CPU| over "
            f"{NEW_TOKENS} steps {err:.2e}, argmax equal at {int(clear.sum())} "
            f"clear steps")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    phase_build()

    t0 = time.perf_counter()
    reports = {
        "fused_quant_attention_batched": check_attention(),
        "quantize_int8_rows": check_quantize(8),
        "quantize_int4_rows": check_quantize(4),
    }
    log(f"phase kernels: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    launches: dict = {}
    phase_main_path(launches)
    log(f"phase main path: {time.perf_counter() - t0:.1f} s")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was never launched on the main path")

    t0 = time.perf_counter()
    phase_fp32_hold()
    log(f"phase fp32 hold: {time.perf_counter() - t0:.1f} s")
    log(f"total: {time.perf_counter() - t_all:.1f} s")

    where = {
        "fused_quant_attention_batched": (
            "efficient_llm_inference_tpu_torch/csrc/fused_quant_attention.cu",
            "efficient_llm_inference_tpu/ops/pallas/attention.py:170"),
        "quantize_int8_rows": (
            "efficient_llm_inference_tpu_torch/csrc/quantize_rows.cu",
            "efficient_llm_inference_tpu/ops/pallas/quantize.py:41"),
        "quantize_int4_rows": (
            "efficient_llm_inference_tpu_torch/csrc/quantize_rows.cu",
            "efficient_llm_inference_tpu/ops/pallas/quantize.py:60"),
    }
    kernels = []
    for name, (source, replaces) in where.items():
        r = reports[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
