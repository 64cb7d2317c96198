#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, and check it.

    python3 chip_smoke.py

Phases (each prints one line with its seconds):

1. build: compile every CUDA kernel of the port with nvcc (one process per
   source, all at once) and print the card's name and power limit;
2. kernels: at the main path's shapes (GPT-2 small: L=12, E=768, H=12, D=64,
   V=50257, C=320 = a 256-token prompt + 64 new tokens), hold each kernel
   against its plain PyTorch version on the same inputs on the card and time
   kernel, plain version, library yardstick and bound:
   - quantize rows: bit-exact;
   - fused attention: fp32 atol 1e-4, bf16 atol 2e-2, also on a row with no
     visible position (length 0, no extra row: the uniform average);
   - whole-step megakernels (fp, int8, int4 and mixed panes, bf16 and fp32,
     length 319): the token (fp32: equal unless the plain top-2 gap is under
     1e-4; bf16: a token whose plain logit is within 2e-2 of the maximum),
     the new K/V rows (fp32: 1e-5, bf16: 1.6e-2, relative to the row's
     largest value), quantized rows within one quantization step (fp32) or
     two (bf16) after decoding, and every other row untouched;
3. llama init: InferenceEngine.from_model_name("llama-3-1b") (Llama-3.2-1B
   at full width: E=2048, I=8192, L=16, 32 query heads on 8 K/V heads,
   D=64, V=128256, tied embeddings; random weights from seed 42 drawn on
   the host, bf16 on the card);
4. llama kernels: the Llama whole-step kernels (#13 fp panes, #12 int8/int4/
   mixed panes) against their plain steps with the tolerances of phase 2, at
   the main path's weights in bf16 and widened to fp32, C=320 at lengths 0,
   1, the last row of the split-KV attention's first split and the first of
   its second (visible last) and 319 (timed at 319), and C=8192 (the
   capacity limit) at length 8191 (timed), and at a Qwen2.5-0.5B-width
   model cut to 2 layers (q/k/v biases, 14 query heads on 2, E=896) at
   C=320; the bf16 new rows at the lengths other than 0 and 319 are held on
   Llama-3.2-1B's widths cut to 2 layers (over 16 bf16 layers rounding
   flips compound past phase 2's fp-row limit, whatever the kernel);
5. main path, for GPT-2 small and for Llama-3.2-1B: InferenceEngine on CUDA
   in bf16, benchmark_method over 2 prompts of 256 tokens with 64 new tokens
   for full_cache, quant_int8, quant_int4 and quant_mixed, first with the
   megakernel off (Config(megakernel=False): each quant_* decode step
   launches the attention kernel once per layer and the rows kernels once
   per layer, K and V and forward pass), then with the default config
   (megakernel on: every decode step is one launch of the model's
   whole-step kernel chain, replayed from a CUDA graph, and the attention
   kernel runs on no decode step). The launch counters are zeroed just
   before and read just after each run;
6. fp32 hold: GPT-2 small in fp32 on the card. Megakernel off: its greedy
   tokens, teacher-forced through the plain versions on the CPU, must give
   every step's logits within 1e-3. Megakernel on, for GPT-2 and for
   Llama-3.2-1B (its bf16 weights widened to fp32): 64 teacher-forced steps
   of the kernel beside the plain step on the card; the tokens must be equal
   wherever the plain step's top-2 logit gap is at least 1e-4. Static batch
   (GPT-2): each row of generate_batch equals the single-stream megakernel's
   tokens of its prompt up to the first step with a top-2 gap under 1e-4.

Static-batch serving (the batched whole-step kernels: GPT-2's #14 / #16 one
persistent kernel a step in csrc/gpt2_megabatch.cu, Llama's #15 / #17 the
chain of csrc/megabatch.cu) runs in three more phases:
- batch kernels, after phase 2 for GPT-2 small (#14, #16) and after phase 4
  for Llama-3.2-1B (#15, #17): B = 8 slots at lengths 0, 1, 7, 8, 100, 255,
  318, 319 of C = 320, fp/int8/int4/mixed panes, bf16 and fp32, against the
  plain batched steps (per slot the token and new-row tolerances of phase
  2; every other column untouched), timed at B = 8 and B = 1; GPT-2's step
  launches one kernel a step at B = 1, 8, 16 and 32 (checked and printed),
  and a slot's token and new K/V bytes are the same at B = 32, 16, 9, 8
  and 1 and at 37 blocks (bf16 weights, fp and int8 panes, GPT-2 small's
  full width); the plain steps are timed for the kernels line's fp and
  int8 panes;
- batch main path, after phase 5: generate_batch on 8 prompts of 24-256
  tokens (bucket 256) with 64 new tokens for kv_mode None, int8, int4 and
  mixed on gpt2 and llama-3-1b in bf16: the batched chain launches once per
  step and no other kernel of the port runs; aggregate tokens/s beside
  benchmark_method's single-stream tokens/s over the same prompts.

Speculative decoding (the verify kernels: #10 one persistent kernel a pass
in csrc/gpt2_megaverify.cu, #13 at R > 1 the chain of csrc/megaverify.cu;
the draft bursts #22/#23 of csrc/draft_burst.cu) runs in three more phases:
- speculation kernels, after the batch kernels: gpt2_megaverify at GPT-2
  small's full width and llama_megaverify at Llama-3.2-1B's, R in {4, 8}
  rows, cur in {0, 7, 8, 100, C - 8 - R} of C = 344 (the main path's
  capacity at k = 8), bf16 and fp32, against the plain verify (R plain
  steps) with the tolerances of phase 2 (with its deep-bf16 allowance for
  the Llama rows), each pass's launches counted (#10 one kernel, #13 6 L +
  3), timed at R = 8; the bursts at the
  byte-vocab draft geometries (draft_gpt2, head_dim 32; draft_llama), k = 4,
  C = 208, each proposal against the plain step fed the kernel's tokens;
- speculation main path, after the batch main path: generate_speculative
  mode "ngram" (k = 8) and "self_draft" (1 layer, k = 4) on gpt2 and
  llama-3-1b over the phase-5 prompts, and mode "draft" (k = 4) on the
  byte-vocab pairs scale_gpt2_big + draft_gpt2 and scale_llama_big +
  draft_llama (random weights, 128-token prompts), bf16: the verify kernel
  launches once a round, the burst once a round, the self-draft's
  whole-step kernel k times a round, nothing else; tokens/s, tokens per
  round and host syncs beside benchmark_method full_cache over the same
  prompts;
- in the fp32 hold: each speculative generation (GPT-2 and Llama-3.2-1B
  ngram and self_draft, both pairs' draft) equals the megakernel greedy ids
  up to the first step whose top-2 gap is under 1e-4.

Continuous batching (`MegaBatchServer`: the batched chains past 8 slots,
the batched verify kernels #18-#21 of csrc/megabatch_verify.cu) runs in
four more phases:
- in the batch kernels: #14/#16 at B = 16 (and #14 at B = 32) on GPT-2
  small, #15/#17 at B = 16 and 32 on Llama-3.2-1B, the lengths above
  repeated, with the same tolerances (bf16 rows at B = 32 on the first two
  layers), timed in bf16; the bf16 Llama
  chain (one launch a GEMV for all slots, csrc/gemv_stream_tc.cuh) keeps a
  slot's token and new K/V bytes bit for bit at B = 32, 16, 9, 8 and 1
  (fp and int8 panes, bf16 weights and their int8 tier) and launches
  5 L + 3 kernels a step at every B; and #15/#17 over the int8 weight tier
  at Llama-3.2-1B's full depth (B = 8, 16, fp panes 32), fp32 and bf16;
- batched verify kernels, after the speculation kernels: #18/#19 at GPT-2
  small's width on 16 slots and #20/#21 at Llama-3.2-1B's on 8, R in
  {2, 8} rows a slot fed as token ids, C = 128, slot lengths 0, 7, 8, 55
  and C - 16 repeated, fp/int8/int4/mixed panes, fp32 and bf16, against the
  plain versions per slot and row (the tolerances of phase 2 with its
  deep-bf16 allowance for Llama; over quantized panes each row against the
  plain step on the kernel's own earlier rows), every other column
  untouched; timed in bf16 at R = 8 (the plain versions for fp and int8
  panes, the kernels line's);
- server main path, after the speculation main path: MegaBatchServer.run
  on the engines' models in bf16, the protocol of
  scripts/measure_megaserver.py ("Question i: " + 6-10 words, 64 new
  tokens, C = 128, chunks of 32; 32 requests on 16 slots for GPT-2 small,
  16 on 8 for Llama-3.2-1B), plain and spec="ngram" (k = 8), pools in bf16
  and int8: the batched chain launches once a step, the batched verify
  once a round, nothing else; aggregate tokens/s, tokens a slot-round and
  the final verify width;
- in the fp32 hold: GPT-2 small's plain and spec servers at C = 256 (every
  request fits), pools in fp32: each request equals the single-stream
  megakernel greedy ids up to the first step whose top-2 gap is under 1e-4;
  then the same servers at the JAX server's default pools, bf16, over the
  fp32 weights (the kernels on the weights cast once to bf16): the batched
  step (verify) launches once a step (round), every request gets its
  tokens, their agreement with the fp32 pools' printed.

The kernel API (`efficient_llm_inference_tpu_torch.ops`, the names of the
JAX package's ops.pallas; #4-#8 and #24, which no engine path calls) runs in
two more places:
- in the batched verify phase, past the old 128-row limit: #19 over int8
  panes at 32 x 8 rows, #18 and #20 at 24 x 8, fp32 and bf16, with its
  checks and tolerances, and a spec="ngram" server of 32 slots;
- kernel library, after it: each of the six at full width on the engines'
  own state (GPT-2 small's quantized caches of the phase-5 prompt and its
  weights, Llama-3.2-1B's weights and caches, PoolConfig's pool filled with
  its prefill rows of the batch prompts, sentinels and an idle slot), the
  counters zeroed just before and read just after the calls, each output
  against its plain version (dequant bit-exact; linear fp32 1e-5 of the
  largest output, bf16 one ulp; attention fp32 1e-4 (#4) / 2e-5 (#24), bf16
  two ulps plus 1e-3 of the largest output), timed with inputs
  rotated past L2 beside its bound, plain version and library call.

Weight-quantized serving (`Config.weight_quant`: the weight tiers of #9,
#11, #12 and #13 at R = 1, the same CUDA chains streaming int8 or grouped
int4 codes) runs in three more places:
- weight-tier kernels, after the llama kernels: GPT-2 small and
  Llama-3.2-1B at full width, the main path's seed-42 weights quantized to
  int8, int4 (G = 128) and int4w8 (G = E/2 = 384; TR/2 = 1024), fp / int8 /
  int4 / mixed panes, bf16 and fp32, lengths 0 and 319 of C = 320, each
  against its plain step with the tolerances of phase 2 (Llama: its
  deep-bf16 allowance) and timed at 319 beside its byte bound (the pack's
  codes and scales); a Qwen2.5-0.5B-width model cut to 2 layers at int4w8
  (G = 448, FFN padded 4864 -> 5376), untimed;
- weight-quant main path, after phase 5: benchmark_method for the four
  methods on gpt2 and llama-3-1b with Config(weight_quant=w), w in int8,
  int4, int4w8, bf16: every decode step one launch of the chain's weight
  tier (counted in `<wrapper>.tiers`) and no full-precision launch; tokens/s
  beside the bf16-weight run's and the bytes a step streams;
- in the fp32 hold: 64 teacher-forced steps of each family's int8 and int4
  tiers (full_cache and quant_int8) beside the plain step on the card,
  tokens equal wherever the plain top-2 gap is at least 1e-4.

The weight tiers of the verify and batched chains (#10, #13 at R > 1,
#14-#21: the batched GEMV of csrc/gemv_batch.cuh streaming int8 or
grouped-int4 codes; in bf16 #15 / #17 on csrc/gemv_stream_tc.cuh) run in
three more places:
- batched weight-tier kernels, after the batched verify phase: GPT-2 small
  (12 layers) at int8 and int4 (G = 128), Llama-3.2-1B's widths cut to 2
  layers at int8, int4 and int4w8 (G = 1024; no batched verify), bf16 and
  fp32: #10 / #13 at R = 8 (cur 0 and C - 16 of C = 344), #14-#17 at B = 8
  (lengths 0 .. 319 of C = 320; #16 also at B = 16, #15 / #17 at 16 and
  32), #18-#21 at 8 x 8 rows (C = 128; GPT-2's #18 also at 16 x 8 in
  bf16), fp and int8 panes, each against its plain version with its
  full-precision phase's checks and limits, timed in bf16 beside the
  pack's byte bound;
- weight-quant serving main path, after the server main path:
  from_model_name(weight_quant=...) for Llama-3.2-1B at int8 and GPT-2
  small at int4, bf16: generate_batch (8 prompts, kv_mode None and int8),
  generate_speculative ("ngram" k = 8, "self_draft" k = 4) and
  MegaBatchServer (plain and spec="ngram", bf16 and int8 pools; 16
  requests on 8 slots, 32 on 16), with the bf16-weight phases' launch
  checks on the weight tier (no full-precision launch of those kernels;
  the self-draft on the R = 1 tier steps, no burst), tokens/s beside the
  bf16-weight rates of the same call;
- in the fp32 hold: the same engines in fp32 (GPT-2 int4; Llama-3.2-1B
  int8, its server at 8 slots and 8 requests): generate_batch, the two
  speculative modes and both servers equal the single-stream weight-quant
  greedy ids up to the first step whose top-2 gap is under 1e-4.

Then it prints the kernels' JSON line, the card's name and power limit, and
as the last line {"ok": true, "device": {...}}. Any failure raises and exits
nonzero without that line. Float32 matrix products run in full fp32 (TF32
off). Kernel times are device times per call from CUDA-graph replay (warm
L2 for the small kernels; a whole step streams 247 MB (GPT-2) or 2.47 GB
(Llama) of weights, more than L2 holds); the eager time per call, host
enqueue included, is printed beside them.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_FLOP_PER_S = 67e12  # fp32 outside the tensor cores
H100_BF16_FLOP_PER_S = 989e12  # bf16, dense
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


def _ms(t) -> str:
    """A time for a log line: ms to 5 places, or "not timed"."""
    return "not timed" if t is None else f"{t:.5f}"


def bound_ms(n_bytes: float, n_flops: float,
             flop_rate: float = H100_FP32_FLOP_PER_S) -> tuple:
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_flops / flop_rate * 1e3
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
            # and a row with no visible position: length 0, no extra row
            none = args[:7] + [torch.zeros_like(args[7])]
            got0 = a.fused_quant_attention_batched(*none, 0, k_bits=k_bits, v_bits=v_bits)
            want0 = a.fused_quant_attention_batched_plain(*none, 0, k_bits=k_bits,
                                                          v_bits=v_bits)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            err0 = (got0.float() - want0.float()).abs().max().item()
            tol = 1e-4 if dtype == torch.float32 else 2e-2
            if not max(err, err0) <= tol:
                raise AssertionError(f"attention k{k_bits}/v{v_bits} {dtype}: "
                                     f"max |kernel - plain| {err}, with no visible "
                                     f"row {err0}, > {tol}")
            worst[dtype] = max(worst[dtype], err, err0)
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
    log(f"  attention max|kernel-plain| (visible rows, and no visible row): "
        f"fp32 {worst[torch.float32]:.2e} (tol 1e-4), bf16 {worst[torch.bfloat16]:.2e} "
        f"(tol 2e-2)")
    report["max_abs_err"] = max(worst.values())
    return report


MEGA_C, MEGA_LEN = PROMPT_TOKENS + NEW_TOKENS, PROMPT_TOKENS + NEW_TOKENS - 1
MODES = ("fp", "int8", "int4", "mixed")


def _mega_state(mode, dtype, seed, L, W, E, C=MEGA_C):
    """A decode state of C rows (by default 320, the main path's last
    step): random [L, C, W] panes (codes and per-token scales for quantized
    modes) and an embedding [1, E]."""
    from efficient_llm_inference_tpu_torch.ops import megakernel_quant as mq

    g = torch.Generator().manual_seed(seed)
    x = (torch.randn((1, E), generator=g) * 0.3).to(dtype).cuda()
    if mode == "fp":
        return [(torch.randn((L, C, W), generator=g) * 0.5).to(dtype).cuda()
                for _ in range(2)], x

    def pane(kind):
        lo = -127 if kind == "int8" else -128
        width = W if kind == "int8" else W // 2
        return torch.randint(lo, 128, (L, C, width), generator=g,
                             dtype=torch.int32).to(torch.int8).cuda()

    def scales():
        return (torch.rand((L, C), generator=g) * 0.02 + 1e-3).cuda()

    k_kind, v_kind = mq._kv_kinds(mode)
    return [pane(k_kind), pane(v_kind), scales(), scales()], x


def _step_fns(family: str):
    """(fp kernel, quant kernel, fp plain, quant plain) of a model family."""
    from efficient_llm_inference_tpu_torch.ops import megakernel as mk
    from efficient_llm_inference_tpu_torch.ops import megakernel_llama as ml
    from efficient_llm_inference_tpu_torch.ops import megakernel_quant as mq

    if family == "llama":
        return (ml.llama_megastep, mq.llama_megastep_quant, ml.llama_megastep_plain,
                mq.llama_megastep_quant_plain)
    return (mk.gpt2_megastep, mq.gpt2_megastep_quant, mk.gpt2_megastep_plain,
            mq.gpt2_megastep_quant_plain)


def _mega_step(mode, packed, cfg, state, length, x, plain=False, family="gpt2"):
    """The kernel (length: a device int32 tensor, so the call can be
    captured) or, with `plain`, the plain step (length: an int), which then
    returns its logits last."""
    fp, quant, fp_plain, quant_plain = _step_fns(family)
    kw = {"return_logits": True} if plain else {}
    if mode == "fp":
        return (fp_plain if plain else fp)(packed, *state, length, x, cfg=cfg, **kw)
    return (quant_plain if plain else quant)(packed, *state, length, x, cfg=cfg,
                                             kv_mode=mode, **kw)


def _token_ok(tok: int, logits: torch.Tensor, dtype, deep_bf16: bool = False,
              bf16_tol: float = None) -> bool:
    """fp32: the plain argmax unless its top-2 gap is under 1e-4; bf16: any
    token whose plain logit is within 2e-2 of the maximum (the kernel and
    the plain step round to bf16 at the same points, in other sum orders).
    `deep_bf16` (a Llama-3.2-1B verify pass): within 4e-2, the allowance
    once more, as for its rows in `_rows_err` (the 16 bf16 layers and the
    earlier verify rows compound the rounding flips; measured: a kernel
    token 0.027 under the plain maximum, PERF.md §6). `bf16_tol` replaces
    the bf16 tolerance (LLAMA_VERIFY_BF16_TOL for the batched verify)."""
    top2 = logits.topk(2).values
    if dtype == torch.float32:
        return tok == int(logits.argmax()) or float(top2[0] - top2[1]) < 1e-4
    if bf16_tol is None:
        bf16_tol = 2e-2 * (2 if deep_bf16 else 1)
    return float(logits[tok]) >= float(top2[0]) - bf16_tol


def _new_row_err(mode, dtype, got, want, before, row=MEGA_LEN,
                 deep_bf16=False, bf16_steps=2.0) -> float:
    """Max |kernel - plain| of the new rows (dequantized for quantized
    panes), after checking them against the tolerances and checking that no
    other row moved. A quantized row may be one quantization step off in
    fp32 and `bf16_steps` in bf16. `deep_bf16`: a quantized bf16 row may also carry the
    fp rows' tolerance (1.6e-2 of the row's largest value) on top of its two
    steps, because the values it quantizes differ by that much: over 16
    layers of a bf16 residual stream the kernel's and the plain step's
    rounding flips compound (Llama-3.2-1B's fp rows differ by up to ~2 bf16
    ulps of their largest value)."""
    from efficient_llm_inference_tpu_torch.ops import megakernel_quant as mq

    others = torch.arange(before[0].shape[1], device=before[0].device) != row
    for g_, w_, b_ in zip(got, want, before):
        if not (torch.equal(g_[:, others], b_[:, others])
                and torch.equal(w_[:, others], b_[:, others])):
            raise AssertionError(f"megastep {mode} {dtype}: a row other than "
                                 f"{row} changed")
    if mode == "fp":
        err, scale = 0.0, 0.0
        for g_, w_ in zip(got, want):
            g_, w_ = g_[:, row].float(), w_[:, row].float()
            err = max(err, (g_ - w_).abs().max().item())
            scale = max(scale, w_.abs().max().item())
        tol = (1e-5 if dtype == torch.float32 else 1.6e-2) * max(scale, 1.0)
        if not err <= tol:
            raise AssertionError(f"megastep {mode} {dtype}: new rows off by {err} > {tol}")
        return err
    err = 0.0
    steps = 1 if dtype == torch.float32 else bf16_steps
    for kind, g_, w_, gs, ws in zip(mq._kv_kinds(mode), got[:2], want[:2],
                                    got[2:], want[2:]):  # each pane by its own step
        gv = mq.pane_values(g_[:, row], kind) * gs[:, row, None]
        wv = mq.pane_values(w_[:, row], kind) * ws[:, row, None]
        d = (gv - wv).abs().max().item()
        step_tol = steps * max(gs[:, row].max().item(), ws[:, row].max().item()) * 1.01
        if deep_bf16 and dtype == torch.bfloat16:
            step_tol += 1.6e-2 * max(wv.abs().max().item(), 1.0)
        if not d <= step_tol:
            raise AssertionError(f"megastep {mode} {dtype}: new {kind} row "
                                 f"off by {d} > {step_tol}")
        err = max(err, d)
    return err


def _kv_bytes(mode, item, L, W, rows) -> float:
    """Bytes of `rows` cached rows of [L, rows, W] K and V panes (codes and
    per-token scales for quantized modes)."""
    from efficient_llm_inference_tpu_torch.ops import megakernel_quant as mq

    if mode == "fp":
        return L * rows * 2 * W * item
    return L * rows * (sum(W if k == "int8" else W // 2 for k in mq._kv_kinds(mode)) + 8)


def _mega_bound(mode, dtype) -> tuple:
    """Least time of one GPT-2 step on the card: every weight read once
    (layer weights, the LM head = wte, one wte and one wpe row), the visible
    KV rows and their scales read once, the new rows written once; two
    operations per weight element."""
    L, E, V = 12, 768, 50257
    item = 2 if dtype == torch.bfloat16 else 4
    weights = L * 12 * E * E + V * E + 2 * E
    smalls = (L * 13 * E + 2 * E) * 4
    n_bytes = weights * item + smalls + _kv_bytes(mode, item, L, E, MEGA_LEN + 1)
    flops = 2 * weights + L * 4 * (MEGA_LEN + 1) * E
    rate = H100_BF16_FLOP_PER_S if dtype == torch.bfloat16 else H100_FP32_FLOP_PER_S
    return bound_ms(n_bytes, flops, rate)


def check_megasteps() -> dict:
    """#9 and #11 at GPT-2 small's full width against their plain steps."""
    from efficient_llm_inference_tpu_torch.models import gpt2 as gpt2_mod
    from efficient_llm_inference_tpu_torch.ops import megakernel as mk

    cfg = gpt2_mod.GPT2Config.small()
    reports = {}
    dev_len = torch.tensor([MEGA_LEN], dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        params = gpt2_mod.init_gpt2_params(torch.Generator().manual_seed(42), cfg,
                                           dtype, "cuda")
        packed = mk.pack_gpt2_mega(params, cfg)
        for i, mode in enumerate(MODES):
            state, x = _mega_state(mode, dtype, 100 + i, 12, 768, 768)
            got = [t.clone() for t in state]
            want = [t.clone() for t in state]
            kernels = mk.step_kernels()
            tok = int(_mega_step(mode, packed, cfg, got, dev_len, x)[0])
            kernels = mk.step_kernels() - kernels
            logits = _mega_step(mode, packed, cfg, want, MEGA_LEN, x, plain=True)[-1]
            torch.cuda.synchronize()
            if not _token_ok(tok, logits, dtype):
                raise AssertionError(f"megastep {mode} {dtype}: token {tok}, plain "
                                     f"argmax {int(logits.argmax())}")
            if kernels != 1:
                raise AssertionError(f"megastep {mode} {dtype}: {kernels} kernels a step, "
                                     f"not one")
            err = _new_row_err(mode, dtype, got, want, state)
            b, by = _mega_bound(mode, dtype)
            entry = {
                "ms": device_ms(lambda: _mega_step(mode, packed, cfg, got, dev_len, x),
                                calls=20),
                "plain_ms": device_ms(lambda: _mega_step(mode, packed, cfg, want,
                                                         MEGA_LEN, x, plain=True),
                                      calls=3),
                "bound_ms": b, "bound_by": by, "library_ms": None,
                "max_abs_err": err,
            }
            eager = eager_ms(lambda: _mega_step(mode, packed, cfg, got, dev_len, x),
                             iters=20)
            log(f"  megastep {mode} {str(dtype)[6:]} L=12 E=768 V=50257 C=320 "
                f"len={MEGA_LEN}: {kernels} kernel a step, token {tok} (plain "
                f"{int(logits.argmax())}), new rows "
                f"max|kernel-plain| {err:.2e}; device ms kernel {entry['ms']:.5f}, "
                f"plain {entry['plain_ms']:.5f}, bound {b:.5f} ({by}); eager kernel "
                f"call {eager:.5f} ms")
            reports[(mode, dtype)] = entry
        del params, packed
    return _mega_reports(reports, "gpt2_megastep", "gpt2_megastep_quant")


# The pane kinds whose bf16 times a step's two kernels-line entries carry
# (_mega_reports); the plain versions are timed for these alone.
LINE_MODES = ("fp", "int8")


def _mega_reports(reports: dict, fp_name: str, quant_name: str) -> dict:
    """The kernels line's entries of a family's two steps: the bf16 times
    (fp panes; int8 panes for the quantized step) and the worst error over
    both dtypes and the pane kinds."""
    worst = {m: max(r["max_abs_err"] for (mode, _), r in reports.items() if mode == m)
             for m in MODES if any(mode == m for mode, _ in reports)}
    fp = dict(reports[("fp", torch.bfloat16)], max_abs_err=worst["fp"])
    quant = dict(reports[("int8", torch.bfloat16)],
                 max_abs_err=max(e for m, e in worst.items() if m != "fp"))
    return {fp_name: fp, quant_name: quant}


def _llama_bound(mode, dtype, cfg, rows) -> tuple:
    """Least time of one Llama step on the card: every layer weight and the
    LM head read once, the input embedding, the norms, one RoPE row, the
    `rows` visible KV rows and their scales read once, the new rows written
    once; two operations per weight element plus the attention's four per
    cached value and query head."""
    E, I, L, V, D = (cfg.hidden_size, cfg.intermediate_size, cfg.n_layer,
                     cfg.vocab_size, cfg.head_dim)
    QW, KW = cfg.n_head * D, cfg.n_kv_head * D
    item = 2 if dtype == torch.bfloat16 else 4
    weights = L * (E * (QW + 2 * KW) + QW * E + 3 * E * I) + V * E
    smalls = (L * 2 * E + E + 2 * D + (L * (QW + 2 * KW) if cfg.qkv_bias else 0)) * 4
    n_bytes = (weights + E) * item + smalls + _kv_bytes(mode, item, L, KW, rows + 1)
    flops = 2 * weights + L * 4 * (rows + 1) * QW
    rate = H100_BF16_FLOP_PER_S if dtype == torch.bfloat16 else H100_FP32_FLOP_PER_S
    return bound_ms(n_bytes, flops, rate)


LLAMA_LONG_C = 8192  # the kernels' capacity limit


def _llama_lengths(cfg, C) -> tuple:
    """The lengths the Llama steps are held at on C rows: 0 and 1, the last
    row of the split-KV attention's first split and the first of its second
    (the launcher's plan on this card) visible last, and C - 1."""
    from efficient_llm_inference_tpu_torch.ops import megakernel_llama as ml

    _, rows = ml.attention_plan(C, cfg.n_head, cfg.n_kv_head,
                                torch.cuda.get_device_properties(0).multi_processor_count)
    return tuple(sorted({0, 1, min(rows, C - 1), min(rows + 1, C - 1), C - 1}))


def _llama_case(mode, dtype, cfg, packed, params, C, length, i, name, deep_bf16,
                check_rows=True):
    """One Llama step over pane kind MODES[i] at `length` of C rows against
    its plain step: the token (phase 2's gate) and, with `check_rows`, the
    new rows (phase 2's limits, `deep_bf16` for quantized rows). Returns
    (kernel, plain, row error or None, log line)."""
    KW = cfg.n_kv_head * cfg.head_dim
    state, _ = _mega_state(mode, dtype, 200 + i + length, cfg.n_layer, KW, cfg.hidden_size, C)
    x = params["embed"][(length * 7919 + i) % cfg.vocab_size][None]
    dev_len = torch.tensor([length], dtype=torch.int32, device="cuda")
    got = [t.clone() for t in state]
    want = [t.clone() for t in state]

    def kernel():
        return _mega_step(mode, packed, cfg, got, dev_len, x, family="llama")

    def plain():
        return _mega_step(mode, packed, cfg, want, length, x, plain=True, family="llama")

    tok = int(kernel()[0])
    logits = plain()[-1]
    torch.cuda.synchronize()
    if not _token_ok(tok, logits, dtype):
        raise AssertionError(f"llama megastep {name} {mode} {dtype} C={C} len={length}: "
                             f"token {tok}, plain argmax {int(logits.argmax())}")
    err = (_new_row_err(mode, dtype, got, want, state, row=length, deep_bf16=deep_bf16)
           if check_rows else None)
    line = (f"  llama megastep {mode} {str(dtype)[6:]} {name} C={C} len={length}: token "
            f"{tok} (plain {int(logits.argmax())})"
            + (f", new rows max|kernel-plain| {err:.2e}" if check_rows else ""))
    return kernel, plain, err, line


def check_llama_megasteps(params_bf16: dict) -> dict:
    """#13 and #12 against their plain steps at Llama-3.2-1B's full width
    (the main path's weights), bf16 and fp32 (the same weights widened), fp,
    int8, int4 and mixed panes, C=320 at lengths 0, 1, the edges of the
    split-KV attention's first split and 319 (timed at 319), and C=8192
    (the capacity limit) at length 8191, timed; then a Qwen2.5-0.5B-width
    model cut to 2 layers (q/k/v biases, 14 query heads on 2 K/V heads,
    E=896, random weights) the same way at C=320, untimed. Every case holds
    the token; the new rows are held at 16 layers in fp32 at every length
    and in bf16 at lengths 0 and 319, and in bf16 at the other lengths and
    C=8192 on Llama-3.2-1B's widths cut to 2 layers: over 16 bf16 layers
    the kernel's and the plain step's rounding flips compound past phase
    2's fp-row limit at some lengths whatever the kernel: the chain before
    this design drifts there too (scripts/torch_step_drift.py compares two
    checkouts)."""

    from efficient_llm_inference_tpu_torch.models import llama as llama_mod
    from efficient_llm_inference_tpu_torch.ops import megakernel_llama as ml

    llama = llama_mod.LlamaConfig.llama3_1b()
    qwen = dataclasses.replace(llama_mod.LlamaConfig.qwen25_05b(), n_layer=2)
    cut = dataclasses.replace(llama, n_layer=2)
    qwen_params = llama_mod.init_llama_params(torch.Generator().manual_seed(7), qwen,
                                              torch.float32, "cuda")
    timing, errs = {}, {}
    for cfg, base, name in ((llama, params_bf16, "Llama-3.2-1B"),
                            (cut, _first_layers(params_bf16, 2), "Llama-3.2-1B width, L=2"),
                            (qwen, qwen_params, "Qwen2.5-0.5B width, L=2")):
        cases = [(MEGA_C, n) for n in _llama_lengths(cfg, MEGA_C)]
        if cfg is not qwen:
            cases.append((LLAMA_LONG_C, LLAMA_LONG_C - 1))
        for dtype in ((torch.bfloat16,) if cfg is cut else (torch.float32, torch.bfloat16)):
            params = _cast_params(base, dtype)
            packed = ml.pack_llama_mega(params, cfg)
            for i, mode in enumerate(MODES):
                for C, length in cases:
                    deep = cfg is llama and dtype == torch.bfloat16
                    if cfg is cut and length in (0, MEGA_LEN):
                        continue  # held at 16 layers
                    kernel, plain, err, line = _llama_case(
                        mode, dtype, cfg, packed, params, C, length, i, name,
                        deep_bf16=deep, check_rows=not deep or length in (0, MEGA_LEN))
                    if err is not None:
                        errs[(mode, dtype)] = max(err, errs.get((mode, dtype), 0.0))
                    if cfg is llama and length in (MEGA_LEN, LLAMA_LONG_C - 1):
                        b, by = _llama_bound(mode, dtype, cfg, length)
                        t = {"ms": device_ms(kernel, calls=10),
                             "plain_ms": device_ms(plain, calls=2, replays=3),
                             "bound_ms": b, "bound_by": by, "library_ms": None}
                        if C == MEGA_C:
                            timing[(mode, dtype)] = t
                        line += (f"; device ms kernel {t['ms']:.5f}, plain "
                                 f"{t['plain_ms']:.5f}, bound {b:.5f} ({by})")
                    log(line)
            del params, packed
    # errors: the worst over the models and every length
    reports = {key: dict(t, max_abs_err=errs[key]) for key, t in timing.items()}
    return _mega_reports(reports, "llama_megastep", "llama_megastep_quant")


BATCH_LENGTHS = (0, 1, 7, 8, 100, 255, 318, 319)  # C = 320: none visible ... the last column


def _batch_state(mode, dtype, seed, L, W, E, B):
    """A batched decode state: [L, B, C=320, W] panes (codes and
    per-(slot, token) scales for quantized modes) and embeddings [B, E]."""
    state, _ = _mega_state(mode, dtype, seed, L * B, W, E)
    g = torch.Generator().manual_seed(seed + 1)
    x = (torch.randn((B, E), generator=g) * 0.3).to(dtype).cuda()
    return [t.reshape(L, B, *t.shape[1:]) for t in state], x


def _batch_step(mode, packed, cfg, state, lengths, x, plain=False, family="gpt2"):
    """The batched kernel (lengths: a device int32 tensor) or, with `plain`,
    the plain batched step (lengths: ints), which then returns its logits
    [B, V] last."""
    from efficient_llm_inference_tpu_torch.ops import megakernel_batch as mb
    from efficient_llm_inference_tpu_torch.ops import megakernel_batch_quant as mbq

    llama = family == "llama"
    kw = {"return_logits": True} if plain else {}
    if mode == "fp":
        fn = ((mb.llama_megabatch_plain if llama else mb.gpt2_megabatch_plain) if plain
              else (mb.llama_megabatch if llama else mb.gpt2_megabatch))
        return fn(packed, *state, lengths, x, cfg=cfg, **kw)
    fn = ((mbq.llama_megabatch_quant_plain if llama else mbq.gpt2_megabatch_quant_plain)
          if plain else (mbq.llama_megabatch_quant if llama else mbq.gpt2_megabatch_quant))
    return fn(packed, *state, lengths, x, cfg=cfg, kv_mode=mode, **kw)


def _weight_cost(family, cfg, dtype, packed=None) -> tuple:
    """(bytes, elements) of the weights a pass streams: the layer weights
    and the LM head in the model dtype, or, for a weight-tier pack
    (`packed`), its code rows and scales (`_packed_weight_bytes`)."""
    from efficient_llm_inference_tpu_torch.ops import megakernel as mk

    if packed is not None and mk.weight_kind(packed) != "fp":
        n = sum(packed[k].numel() * (2 if packed[k].dtype == torch.uint8 else 1)
                for k in _STREAMED[family])
        return _packed_weight_bytes(family, packed), n
    item = 2 if dtype == torch.bfloat16 else 4
    if family == "gpt2":
        L, E, V = cfg.n_layer, cfg.n_embd, cfg.vocab_size
        weights = L * 12 * E * E + V * E
    else:
        E, I, L, V, D = (cfg.hidden_size, cfg.intermediate_size, cfg.n_layer,
                         cfg.vocab_size, cfg.head_dim)
        QW, W = cfg.n_head * D, cfg.n_kv_head * D
        weights = L * (E * (QW + 2 * W) + QW * E + 3 * E * I) + V * E
    return weights * item, weights


def _batch_bound(mode, dtype, cfg, family, lengths, packed=None) -> tuple:
    """Least time of one batched step on the card: every weight read once
    for all slots (a tier pack's codes and scales: `_weight_cost`), the
    norms and biases, each slot's embedding row (and RoPE row), its visible
    KV rows and scales read once and its new rows written once; two
    operations per weight element and slot, plus the attention's four per
    cached value and query head."""
    item = 2 if dtype == torch.bfloat16 else 4
    B, rows = len(lengths), sum(n + 1 for n in lengths)
    w_bytes, weights = _weight_cost(family, cfg, dtype, packed)
    if family == "gpt2":
        L, E = cfg.n_layer, cfg.n_embd
        QW, W = E, E
        small = (L * 13 * E + 2 * E) * 4 + B * 2 * E * item
    else:
        E, L, D = cfg.hidden_size, cfg.n_layer, cfg.head_dim
        QW, W = cfg.n_head * D, cfg.n_kv_head * D
        small = ((L * 2 * E + E + (L * (QW + 2 * W) if cfg.qkv_bias else 0)) * 4
                 + B * (E * item + 2 * D * 4))
    n_bytes = w_bytes + small + _kv_bytes(mode, item, L, W, rows)
    flops = 2 * weights * B + L * 4 * rows * QW
    rate = H100_BF16_FLOP_PER_S if dtype == torch.bfloat16 else H100_FP32_FLOP_PER_S
    return bound_ms(n_bytes, flops, rate)


def _step_kernels(family: str) -> int:
    """Kernels GPT-2's batched persistent step has launched (0 for Llama,
    whose chain check_llama_batch_rows counts)."""
    from efficient_llm_inference_tpu_torch.ops import megakernel_batch as mb

    return mb.step_kernels() if family == "gpt2" else 0


def _one_kernel(family: str, before: int, what: str) -> None:
    """GPT-2's batched step launched exactly one kernel since `before`."""
    if family == "gpt2" and _step_kernels(family) - before != 1:
        raise AssertionError(f"{what}: {_step_kernels(family) - before} kernels a step, want 1")


# GPT-2's batched step's quantized bf16 new rows: quantization steps from the
# plain step's at most. Its tensor-core sums over 12 layers put one row of
# chip_smoke.py's cases 2.11 steps off (the other slots, B = 16 and 32 and
# the int8 / int4 weight tiers 1.72-2.00; the CUDA-core chain it replaced
# 1.77 at most), scripts/torch_step_drift.py --batch --gpt2, PERF.md §6.
GPT2_BATCH_STEPS = 2.5


def check_megabatches(family: str, cfg, params_for, wide: dict, modes=MODES,
                      suffix: str = "", time_plain: bool = True, rows_2l: tuple = ()) -> dict:
    """#14/#16 (GPT-2) or #15/#17 (Llama) against their plain batched steps:
    B = 8 slots at BATCH_LENGTHS, C = 320, fp, int8, int4 and mixed panes,
    fp32 and bf16 (`params_for(dtype)` gives the weights); per slot the
    token and the new rows under the megastep tolerances, every other column
    untouched. Then past 8 slots: `wide[mode]` slot counts at the same
    lengths, repeated. Device ms
    by CUDA-graph replay in bf16 at B = 8, at B = 1 (one slot at length 319)
    and at each wide B, beside the bound and the plain step. `modes` limits
    the pane kinds; `suffix` ends the kernels' names (a weight tier's);
    without `time_plain` the plain step is checked but not timed. At the
    slot counts of `rows_2l` the bf16 new rows are held, with the same
    limits, on the same slots run through the model's first two layers (its
    tokens at full depth): over 16 bf16 layers the kernel's and the plain
    step's rounding flips compound to the rows' limit at 32 slots, whatever
    the chain (scripts/torch_step_drift.py --batch: the largest row reaches
    0.98-1.06 of it on the CUDA-core GEMVs of gemv_batch.cuh and on
    tensor-core GEMVs, also where their sums round to nearest; PERF.md §6).
    GPT-2's quantized bf16 rows may be GPT2_BATCH_STEPS quantization steps
    off (Llama's carry the deep-bf16 allowance instead)."""
    from efficient_llm_inference_tpu_torch.ops import megakernel as mk
    from efficient_llm_inference_tpu_torch.ops import megakernel_llama as ml

    llama = family == "llama"
    pack = ml.pack_llama_mega if llama else mk.pack_gpt2_mega
    W = cfg.n_kv_head * cfg.head_dim if llama else cfg.n_embd
    E = cfg.hidden_size if llama else cfg.n_embd
    B = len(BATCH_LENGTHS)
    one_len = torch.tensor([MEGA_LEN], dtype=torch.int32, device="cuda")
    names = tuple(f"{family}_megabatch{q}{suffix}" for q in ("", "_quant"))
    reports = {}
    for dtype in (torch.float32, torch.bfloat16):
        params = params_for(dtype)
        packed = pack(params, cfg)
        for mode in modes:
            i = MODES.index(mode)
            name = names[mode != "fp"]
            entry = {"max_abs_err": 0.0}
            for n_slots in (B,) + wide["fp" if mode == "fp" else "quant"]:
                lengths = [BATCH_LENGTHS[b % B] for b in range(n_slots)]
                dev_len = torch.tensor(lengths, dtype=torch.int32, device="cuda")
                if n_slots == B:
                    state, x = _batch_state(mode, dtype, 300 + i, cfg.n_layer, W, E, B)
                else:  # drawn on the card: the host draws of _batch_state take seconds
                    state = _verify_state(mode, dtype, 300 + i + 100 * n_slots, cfg.n_layer,
                                          n_slots, W, C=MEGA_C)
                    g = torch.Generator(device="cuda").manual_seed(n_slots)
                    x = (torch.randn((n_slots, E), generator=g, device="cuda") * 0.3).to(dtype)
                got = [t.clone() for t in state]
                want = [t.clone() for t in state]
                before = _step_kernels(family)
                toks = _batch_step(mode, packed, cfg, got, dev_len, x, family=family)[0]
                _one_kernel(family, before, f"{name} {mode} B={n_slots}")
                logits = _batch_step(mode, packed, cfg, want, lengths, x, plain=True,
                                     family=family)[-1]
                torch.cuda.synchronize()
                err = 0.0
                two_layers = dtype == torch.bfloat16 and n_slots in rows_2l
                if two_layers:  # the same slots through the first two layers
                    cfg2 = dataclasses.replace(cfg, n_layer=2)
                    pk2 = pack(_first_layers(params, 2), cfg2)
                    got2 = [t[:2].clone() for t in state]
                    want2 = [t[:2].clone() for t in state]
                    _batch_step(mode, pk2, cfg2, got2, dev_len, x, family=family)
                    _batch_step(mode, pk2, cfg2, want2, lengths, x, plain=True, family=family)
                    torch.cuda.synchronize()
                    rows = (got2, want2, [t[:2] for t in state])
                else:
                    rows = (got, want, state)
                for b, length in enumerate(lengths):
                    tok = int(toks[b])
                    if not _token_ok(tok, logits[b], dtype):
                        raise AssertionError(
                            f"{name} {mode} {dtype} B={n_slots} slot {b} (length {length}): "
                            f"token {tok}, plain argmax {int(logits[b].argmax())}")
                    err = max(err, _new_row_err(mode, dtype, *([t[:, b] for t in ts]
                                                               for ts in rows),
                                                row=length, deep_bf16=llama,
                                                bf16_steps=2.0 if llama else GPT2_BATCH_STEPS))
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                line = (f"  {name} {mode} {str(dtype)[6:]} B={n_slots} C=320 lengths "
                        f"{lengths[:8]}{' (repeated)' if n_slots > B else ''}"
                        f"{': 1 kernel a step' if family == 'gpt2' else ''}: tokens "
                        f"{toks.tolist()[:8]} (plain {logits.argmax(-1).tolist()[:8]}), new "
                        f"rows max|kernel-plain| {err:.2e}"
                        f"{' (first 2 layers)' if two_layers else ''}")
                if dtype == torch.bfloat16:
                    bnd, by = _batch_bound(mode, dtype, cfg, family, lengths, packed)
                    ms = device_ms(lambda: _batch_step(mode, packed, cfg, got, dev_len, x,
                                                       family=family), calls=10)
                    if n_slots == B:
                        one = [t[:, 7:8].clone() for t in got]
                        x1 = x[7:8].contiguous()
                        b1, _ = _batch_bound(mode, dtype, cfg, family, (MEGA_LEN,), packed)
                        before = _step_kernels(family)
                        _batch_step(mode, packed, cfg, [t.clone() for t in one], one_len, x1,
                                    family=family)
                        _one_kernel(family, before, f"{name} {mode} B=1")
                        entry.update({
                            "ms": ms, "bound_ms": bnd, "bound_by": by, "library_ms": None,
                            "ms_b1": device_ms(lambda: _batch_step(
                                mode, packed, cfg, one, one_len, x1, family=family),
                                calls=10),
                            "plain_ms": device_ms(lambda: _batch_step(
                                mode, packed, cfg, want, lengths, x, plain=True,
                                family=family), calls=1, replays=3)
                            if time_plain and mode in LINE_MODES else None,
                            "bound_ms_b1": b1,
                        })
                        line += (f"; device ms B=8 {ms:.5f} (bound {bnd:.5f}, {by}), B=1"
                                 f"{' (1 kernel a step)' if family == 'gpt2' else ''} "
                                 f"{entry['ms_b1']:.5f} (bound {b1:.5f}), plain B=8 "
                                 f"{_ms(entry['plain_ms'])}; per token B=8 {ms / B:.5f}")
                    else:
                        entry[f"ms_b{n_slots}"] = ms
                        entry[f"bound_ms_b{n_slots}"] = bnd
                        line += (f"; device ms B={n_slots} {ms:.5f} (bound {bnd:.5f}, "
                                 f"{by}); per token {ms / n_slots:.5f}")
                log(line)
            reports[(mode, dtype)] = entry
        del params, packed
    return _mega_reports(reports, *names)


ROW_BATCHES = (32, 16, 9, 8)  # the bf16 Llama chain's slot counts held bit for bit


def check_gpt2_batch_rows(cfg) -> None:
    """GPT-2's batched step (#14 / #16, csrc/gpt2_megabatch.cu: one
    persistent kernel a step for all slots) at GPT-2 small's full width,
    fp and int8 panes, over the main path's seed-42 bf16 weights: slot b's
    token and new K/V row bytes (codes and scales) are bit for bit the same
    run at B = 32, 16, 9, 8, alone (B = 1; slots 0, 8, 31) and at 37 blocks
    (B = 32); one kernel a step at every B. The card tests
    (tests/test_torch_cuda_batch.py test_gpt2_megabatch_slot_bits) hold
    every weight tier, pane kind and dtype, and 5 blocks."""
    from efficient_llm_inference_tpu_torch.models import gpt2 as gpt2_mod
    from efficient_llm_inference_tpu_torch.ops import megakernel as mk
    from efficient_llm_inference_tpu_torch.ops import megakernel_batch as mb
    from efficient_llm_inference_tpu_torch.ops import megakernel_quant as mq

    params = gpt2_mod.init_gpt2_params(torch.Generator().manual_seed(42), cfg,
                                       torch.bfloat16, "cuda")
    packs = {"bf16": mk.pack_gpt2_mega(params, cfg)}
    B, E = ROW_BATCHES[0], cfg.n_embd
    lengths = [BATCH_LENGTHS[b % len(BATCH_LENGTHS)] for b in range(B)]
    g = torch.Generator(device="cuda").manual_seed(78)
    x = (torch.randn((B, E), generator=g, device="cuda") * 0.3).to(torch.bfloat16)
    for weights, packed in packs.items():
        for mode in ("fp", "int8"):
            state = _verify_state(mode, torch.bfloat16, 950 + len(weights), cfg.n_layer, B, E,
                                  C=MEGA_C)
            kinds = ("fp", "fp") if mode == "fp" else mq._kv_kinds(mode)
            want, kernels = {}, {}
            runs = [(list(range(n)), None) for n in ROW_BATCHES]
            runs += [([0], None), ([8], None), ([31], None), (list(range(B)), 37)]
            for slots, grid in runs:
                st = [t[:, slots].contiguous() for t in state]
                tok = torch.zeros(len(slots), dtype=torch.int32, device="cuda")
                launcher = mb.GPT2BatchLauncher(
                    packed, cfg, st[0], st[1],
                    torch.tensor([lengths[b] for b in slots], dtype=torch.int32, device="cuda"),
                    tok, x_emb=x[slots].contiguous(), ks=st[2] if mode != "fp" else None,
                    vs=st[3] if mode != "fp" else None, k_kind=kinds[0], v_kind=kinds[1],
                    grid=grid)
                before = mb.step_kernels()
                launcher.launch()
                kernels[len(slots)] = mb.step_kernels() - before
                torch.cuda.synchronize()
                for i, b in enumerate(slots):
                    got = (int(tok[i]), [t[:, i, lengths[b]].clone() for t in st])
                    if b not in want:
                        want[b] = got
                    elif got[0] != want[b][0] or not all(
                            torch.equal(r, w) for r, w in zip(got[1], want[b][1])):
                        raise AssertionError(
                            f"gpt2_megabatch{'' if mode == 'fp' else '_quant'} {weights} "
                            f"weights, {mode} panes: slot {b} differs at B = {len(slots)}"
                            f"{f', {grid} blocks' if grid else ''} from B = {B}")
            if set(kernels.values()) != {1}:
                raise AssertionError(f"GPT-2 batched step launches {kernels}, want 1 a step")
            log(f"  gpt2_megabatch bf16 rows, {weights} weights, {mode} panes: slots' tokens "
                f"and new K/V bytes equal at B = {', '.join(map(str, ROW_BATCHES))} and 1, and "
                f"at 37 blocks; 1 kernel a step at B = {sorted(kernels)}")
            del state
    del packs, params
    torch.cuda.empty_cache()


def check_llama_batch_rows(llama) -> None:
    """The bf16 batched Llama chain (#15 / #17, csrc/gemv_stream_tc.cuh: one
    launch a GEMV for all slots) at Llama-3.2-1B's full width, fp and int8
    panes, over the main path's bf16 weights and their int8 tier: slot b's
    token and new K/V row bytes (codes and scales) are bit for bit the same
    run at B = 32, 16, 9, 8 and alone (B = 1; slots 0, 8, 31); and a step
    launches 5 L + 3 kernels at B = 8, 16 and 32 (no GEMV a group of 8)."""
    from efficient_llm_inference_tpu_torch.ops import megakernel_batch as mb
    from efficient_llm_inference_tpu_torch.ops import megakernel_llama as ml

    from efficient_llm_inference_tpu_torch.models.registry import spec_by_name

    cfg = llama.model.config
    W, E = cfg.n_kv_head * cfg.head_dim, cfg.hidden_size
    packs = {"bf16": ml.pack_llama_mega(llama.params, cfg),
             "int8": ml.pack_llama_mega(_quantized_params(spec_by_name("llama-3-1b"),
                                                          llama.params, "int8"), cfg)}
    B = ROW_BATCHES[0]
    lengths = [BATCH_LENGTHS[b % len(BATCH_LENGTHS)] for b in range(B)]
    g = torch.Generator(device="cuda").manual_seed(77)
    x = (torch.randn((B, E), generator=g, device="cuda") * 0.3).to(torch.bfloat16)
    want_kernels = 5 * cfg.n_layer + 3
    for weights, packed in packs.items():
        for mode in ("fp", "int8"):
            state = _verify_state(mode, torch.bfloat16, 900 + len(weights), cfg.n_layer, B, W,
                                  C=MEGA_C)
            want, kernels = {}, {}
            for slots in [list(range(n)) for n in ROW_BATCHES] + [[0], [8], [31]]:
                st = [t[:, slots].contiguous() for t in state]
                dev_len = torch.tensor([lengths[b] for b in slots], dtype=torch.int32,
                                       device="cuda")
                before = mb.chain_kernels()
                toks = _batch_step(mode, packed, cfg, st, dev_len, x[slots].contiguous(),
                                   family="llama")[0]
                kernels[len(slots)] = mb.chain_kernels() - before
                torch.cuda.synchronize()
                for i, b in enumerate(slots):
                    got = (int(toks[i]), [t[:, i, lengths[b]].clone() for t in st])
                    if b not in want:
                        want[b] = got
                    elif got[0] != want[b][0] or not all(
                            torch.equal(r, w) for r, w in zip(got[1], want[b][1])):
                        raise AssertionError(
                            f"llama_megabatch{'' if mode == 'fp' else '_quant'} {weights} "
                            f"weights, {mode} panes: slot {b} differs at B = {len(slots)} "
                            f"from B = {B}")
            if set(kernels.values()) != {want_kernels}:
                raise AssertionError(f"bf16 Llama batched step launches {kernels}, "
                                     f"want {want_kernels} at every B")
            log(f"  llama_megabatch bf16 rows, {weights} weights, {mode} panes: slots' tokens "
                f"and new K/V bytes equal at B = {', '.join(map(str, ROW_BATCHES))} and 1; "
                f"{want_kernels} kernels a step at B = {sorted(kernels)}")
            del state
    del packs
    torch.cuda.empty_cache()


def check_llama_batch_int8_full(llama) -> None:
    """#15 / #17 over the int8 weight tier at Llama-3.2-1B's full width and
    depth (16 layers; the batched weight-tier phase holds the tiers on a
    2-layer cut), fp and int8 panes, fp32 and bf16, B = 8 and 16 (fp panes
    also 32), with check_megabatches' checks and limits, timed in bf16."""
    from efficient_llm_inference_tpu_torch.models.registry import spec_by_name

    spec = spec_by_name("llama-3-1b")
    quantized = {}

    def q_for(dtype):
        if dtype not in quantized:
            quantized.clear()
            torch.cuda.empty_cache()
            quantized[dtype] = _quantized_params(spec, _cast_params(llama.params, dtype),
                                                 "int8")
        return quantized[dtype]

    check_megabatches("llama", llama.model.config, q_for, modes=("fp", "int8"),
                      wide={"fp": (16, 32), "quant": (16,)}, suffix="_w8_full",
                      time_plain=False, rows_2l=(32,))
    quantized.clear()
    torch.cuda.empty_cache()


SPEC_K, SPEC_SELF_K, DRAFT_K = 8, 4, 4  # verify rows of n-gram, self-draft, draft rounds
# the main path's speculative capacity at k = 8: roundup8(256 + 64 + 8 + 1) + 8
SPEC_C = -(-(PROMPT_TOKENS + NEW_TOKENS + SPEC_K + 1) // 8) * 8 + 8


def _verify_bound(dtype, cfg, family, cur, R, packed=None) -> tuple:
    """Least time of one verify pass: every weight read once for all R rows
    (`_weight_cost`), the norms and biases, the R embedding (and RoPE) rows,
    the cur visible K/V rows read once and the R new rows written once; two
    operations per weight element and row, plus the attention's four per
    value of each row's cur + t + 1 keys and query head."""
    item = 2 if dtype == torch.bfloat16 else 4
    w_bytes, weights = _weight_cost(family, cfg, dtype, packed)
    if family == "gpt2":
        L, E = cfg.n_layer, cfg.n_embd
        QW, W = E, E
        small = (L * 13 * E + 2 * E) * 4 + R * 2 * E * item
    else:
        E, L, D = cfg.hidden_size, cfg.n_layer, cfg.head_dim
        QW, W = cfg.n_head * D, cfg.n_kv_head * D
        small = ((L * 2 * E + E + (L * (QW + 2 * W) if cfg.qkv_bias else 0)) * 4
                 + R * (E * item + 2 * D * 4))
    n_bytes = w_bytes + small + _kv_bytes("fp", item, L, W, cur + R)
    keys = sum(cur + t + 1 for t in range(R))
    flops = 2 * weights * R + L * 4 * keys * QW
    rate = H100_BF16_FLOP_PER_S if dtype == torch.bfloat16 else H100_FP32_FLOP_PER_S
    return bound_ms(n_bytes, flops, rate)


def _rows_err(name, dtype, got, want, before, rows, deep_bf16=False) -> float:
    """Max |kernel - plain| of the new rows `rows` after checking them
    against the megastep tolerances (fp32 1e-5, bf16 1.6e-2 of their largest
    value) and that no other row moved in either. `deep_bf16`: as in
    `_new_row_err`, a bf16 row of Llama-3.2-1B may carry the fp rows'
    tolerance once more: the kernel's and the plain pass's rounding flips
    compound over its 16 bf16 layers and, in a verify pass, over the
    earlier verify rows that each row attends."""
    C = before[0].shape[1]
    others = torch.ones(C, dtype=torch.bool, device=before[0].device)
    others[rows] = False
    err = 0.0
    for g_, w_, b_ in zip(got, want, before):
        if not (torch.equal(g_[:, others], b_[:, others])
                and torch.equal(w_[:, others], b_[:, others])):
            raise AssertionError(f"{name} {dtype}: a row outside {rows} changed")
        g_, w_ = g_[:, rows].float(), w_[:, rows].float()
        d = (g_ - w_).abs().max().item()
        rel = 1e-5 if dtype == torch.float32 else 1.6e-2 * (2 if deep_bf16 else 1)
        tol = rel * max(w_.abs().max().item(), 1.0)
        if not d <= tol:
            raise AssertionError(f"{name} {dtype}: new rows off by {d} > {tol}")
        err = max(err, d)
    return err


def check_megaverify(family: str, cfg, params_for, rows=(4, 8), curs=None,
                     suffix: str = "", time_plain: bool = True) -> dict:
    """#10 (GPT-2) or #13 at R > 1 (Llama) against the plain verify (R plain
    steps): R in `rows` fed as token ids, cur in `curs` (default {0, 7, 8,
    100, C - 8 - R}, the last the largest the capacity rule admits) of C =
    SPEC_C, bf16 and fp32; per row the token and the new rows under the
    megastep tolerances, every other row untouched; the launches of a pass
    (csrc/gpt2_megaverify.cu: one cooperative kernel; csrc/megaverify.cu:
    the chain of 6 L + 3). Device ms in bf16 at R = 8, cur = C - 16.
    `suffix` ends the kernel's name (a weight tier's); without `time_plain`
    the plain verify is checked but not timed."""
    from efficient_llm_inference_tpu_torch.ops import megakernel as mk
    from efficient_llm_inference_tpu_torch.ops import megakernel_llama as ml

    llama = family == "llama"
    name = f"{family}_megaverify{suffix}"
    kern = ml.llama_megaverify if llama else mk.gpt2_megaverify
    plain = ml.llama_megaverify_plain if llama else mk.gpt2_megaverify_plain
    pack = ml.pack_llama_mega if llama else mk.pack_gpt2_mega
    W = cfg.n_kv_head * cfg.head_dim if llama else cfg.n_embd
    report, worst = {}, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        params = params_for(dtype)
        packed = pack(params, cfg)
        for R in rows:
            for i, cur in enumerate(curs or (0, 7, 8, 100, SPEC_C - 8 - R)):
                g = torch.Generator().manual_seed(400 + 10 * R + i)
                state = [(torch.randn((cfg.n_layer, SPEC_C, W), generator=g) * 0.5)
                         .to(dtype).cuda() for _ in range(2)]
                ids = torch.randint(0, cfg.vocab_size, (R,), generator=g).to(torch.int32).cuda()
                dev_len = torch.tensor([cur], dtype=torch.int32, device="cuda")
                got = [t.clone() for t in state]
                want = [t.clone() for t in state]

                def kernel():
                    return kern(packed, *got, dev_len, ids, cfg=cfg)

                def plain_fn():
                    return plain(packed, *want, cur, ids, cfg=cfg, return_logits=True)

                before = ml.verify_chain_kernels() if llama else mk.verify_step_kernels()
                toks = kernel()[0]
                ran = (ml.verify_chain_kernels() if llama else mk.verify_step_kernels()) - before
                want_ran = 6 * cfg.n_layer + 3 if llama else 1
                if ran != want_ran:
                    raise AssertionError(f"{name} {dtype} R={R}: {ran} kernels a pass, "
                                         f"expected {want_ran}")
                logits = plain_fn()[-1]
                torch.cuda.synchronize()
                for t in range(R):
                    if not _token_ok(int(toks[t]), logits[t], dtype, deep_bf16=llama):
                        raise AssertionError(f"{name} {dtype} R={R} cur={cur} row {t}: "
                                             f"token {int(toks[t])}, plain argmax "
                                             f"{int(logits[t].argmax())}")
                err = _rows_err(name, dtype, got, want, state,
                                torch.arange(cur, cur + R, device="cuda"), deep_bf16=llama)
                worst = max(worst, err)
                line = (f"  {name} {str(dtype)[6:]} R={R} C={SPEC_C} cur={cur}: tokens "
                        f"{toks.tolist()} (plain {logits.argmax(-1).tolist()}), new rows "
                        f"max|kernel-plain| {err:.2e}, {ran} kernel(s) a pass")
                if dtype == torch.bfloat16 and R == 8 and cur == SPEC_C - 16:
                    b, by = _verify_bound(dtype, cfg, family, cur, R, packed)
                    report = {
                        "ms": device_ms(kernel, calls=10),
                        "plain_ms": (device_ms(plain_fn, calls=1, replays=3) if time_plain
                                     else None),
                        "bound_ms": b, "bound_by": by, "library_ms": None,
                    }
                    line += (f"; device ms kernel {report['ms']:.5f}, plain "
                             f"{_ms(report['plain_ms'])}, bound {b:.5f} ({by})")
                log(line)
        del params, packed
    report["max_abs_err"] = worst
    return {name: report}


SERVER_C = 128  # the server protocol's pane length (scripts/measure_megaserver.py)
# bf16 tokens of Llama-3.2-1B's batched verify: within 7e-2 of the plain
# maximum logit. scripts/torch_verify_drift.py read these cases (this
# script's seeds and a second set): at 8 slots the largest shortfall 0.0445
# (int8 panes, R = 8; the second set 0.0361), at 24 slots 0.0620 (fp panes;
# the second set 0.0492), and on every row the single-stream kernels (#13
# verify, #12 step) on the same pane and rows chose the same token; with
# --past-128 it also reads the fp32 plain verify's token on the same values
# under the bf16 plain maximum (the bf16 control, PERF.md PR 10). A row's
# sums do not depend on B, so the 24 slots sample more rows of one
# distribution and the limit is one for every B.
LLAMA_VERIFY_BF16_TOL = 7e-2
VERIFY_LENGTHS = (0, 7, 8, 55, SERVER_C - 16)  # C - 16: the deepest block of the window


def _verify_batch_bound(mode, dtype, cfg, family, lengths, R, packed=None) -> tuple:
    """Least time of one batched verify pass: every weight read once for all
    B x R rows (`_weight_cost`), the norms and biases, the rows' embeddings
    (and RoPE rows), each slot's cur visible K/V rows (and scales) read once
    and its R new rows written once; two operations per weight element and
    row, plus the attention's four per value of each row's cur + t + 1 keys
    and query head."""
    item = 2 if dtype == torch.bfloat16 else 4
    N = len(lengths) * R
    w_bytes, weights = _weight_cost(family, cfg, dtype, packed)
    if family == "gpt2":
        L, E = cfg.n_layer, cfg.n_embd
        QW, W = E, E
        small = (L * 13 * E + 2 * E) * 4 + N * 2 * E * item
    else:
        E, L, D = cfg.hidden_size, cfg.n_layer, cfg.head_dim
        QW, W = cfg.n_head * D, cfg.n_kv_head * D
        small = ((L * 2 * E + E + (L * (QW + 2 * W) if cfg.qkv_bias else 0)) * 4
                 + N * (E * item + 2 * D * 4))
    rows = sum(cur + R for cur in lengths)
    n_bytes = w_bytes + small + _kv_bytes(mode, item, L, W, rows)
    keys = sum(cur + t + 1 for cur in lengths for t in range(R))
    flops = 2 * weights * N + L * 4 * keys * QW
    rate = H100_BF16_FLOP_PER_S if dtype == torch.bfloat16 else H100_FP32_FLOP_PER_S
    return bound_ms(n_bytes, flops, rate)


def _verify_state(mode, dtype, seed, L, B, W, C=SERVER_C):
    """Random [L, B, C, W] panes (codes and [L, B, C] scales for quantized
    modes), drawn on the card."""
    from efficient_llm_inference_tpu_torch.ops import megakernel_quant as mq

    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (L, B, C)
    if mode == "fp":
        return [(torch.randn(shape + (W,), generator=g, device="cuda") * 0.5).to(dtype)
                for _ in range(2)]
    panes = [torch.randint(-127 if kind == "int8" else -128, 128,
                           shape + (mq._pane_width(kind, W),), generator=g, device="cuda",
                           dtype=torch.int32).to(torch.int8) for kind in mq._kv_kinds(mode)]
    return panes + [torch.rand(shape, generator=g, device="cuda") * 0.02 + 1e-3
                    for _ in range(2)]


def _teacher_forced_rows(mode, dtype, packed, cfg, family, state, got, toks, ids,
                        lengths, name) -> tuple:
    """Each row of a quantized batched verify block against the plain step
    on the kernel's own earlier rows: row t of slot b is the plain quantized
    step at lengths[b] + t over slot b's panes as they were, with the
    kernel's rows lengths[b] .. lengths[b] + t - 1 (codes and scales) in
    place, fed row t's token. (The plain verify runs on its own earlier
    rows, whose codes may differ from the kernel's by a step, and a later
    row attends them: in bf16 a tenth of int4 codes flip, which moved a
    Llama-3.2-1B row's logits by 0.15.) The kernel's token under the token
    rule (LLAMA_VERIFY_BF16_TOL for Llama in bf16) and its new row under the
    megastep tolerances with the deep-bf16 allowance for both families: the
    bf16 values a row quantizes may differ by the fp rows' 1.6e-2 of their
    largest value (scripts/torch_verify_drift.py: GPT-2 rows up to 1.127x
    two steps, the single-stream quant step on the same input the same);
    every column outside the block untouched. Returns
    (max |kernel - plain| of the rows, the tokens' largest shortfall under
    the plain maximum logit)."""
    R = toks.shape[1]
    llama = family == "llama"
    err = short = 0.0
    for b, cur in enumerate(lengths):
        block = torch.zeros(state[0].shape[2], dtype=torch.bool, device="cuda")
        block[cur:cur + R] = True
        if not all(torch.equal(g_[:, b][:, ~block], s_[:, b][:, ~block])
                   for g_, s_ in zip(got, state)):
            raise AssertionError(f"{name} {mode} {dtype}: slot {b} changed outside its block")
        for t in range(R):
            panes = [s_[:, b].clone() for s_ in state]
            for p_, g_ in zip(panes, got):
                p_[:, cur:cur + t] = g_[:, b, cur:cur + t]
            before = [p_.clone() for p_ in panes]
            tok_id = ids[b * R + t].long()
            if llama:
                x = packed["embed"][tok_id][None]
            else:
                pos = min(cur + t, cfg.n_positions - 1)
                x = (packed["wte"][tok_id] + packed["wpe"][pos])[None].to(dtype)
            logits = _mega_step(mode, packed, cfg, panes, cur + t, x, plain=True,
                                family=family)[-1]
            tok = int(toks[b, t])
            short = max(short, float(logits.max() - logits[tok]))
            if not _token_ok(tok, logits, dtype,
                             bf16_tol=LLAMA_VERIFY_BF16_TOL if llama else None):
                raise AssertionError(f"{name} {mode} {dtype} slot {b} (length {cur}) row {t}: "
                                     f"token {tok}, plain argmax {int(logits.argmax())}, "
                                     f"{float(logits.max() - logits[tok]):.4f} under the "
                                     f"plain maximum")
            kern = [p_.clone() for p_ in before]
            for k_, g_ in zip(kern, got):
                k_[:, cur + t] = g_[:, b, cur + t]
            err = max(err, _new_row_err(mode, dtype, kern, panes, before, row=cur + t,
                                        deep_bf16=True))
    return err, short


def _verify_gemv_case(label: str, packed: dict, key: str, R: int) -> None:
    """One GEMV of the bf16 batched verify chain alone (`verify_gemv`: the
    tensor-core route, stored, no prologue or bias) on layer 0 of packed
    weight `key` at R input rows: held against `verify_gemv_plain` (one
    bf16 ulp plus 1e-5 of the largest output: the fp32 sums' order), timed
    with inputs rotated past L2 beside its byte bound and torch.matmul's
    bf16 product of the same shape (the yardstick, never called by the
    port; a tier's codes widened to bf16 once, outside the timing)."""
    from efficient_llm_inference_tpu_torch.ops import megakernel as mk
    from efficient_llm_inference_tpu_torch.ops import megakernel_batch_verify as mbv

    w = packed[key][0]
    s = packed.get(mk.scale_key(key))
    s = None if s is None else s[0]
    N, K = w.shape[0], w.shape[1] * (2 if w.dtype == torch.uint8 else 1)
    g = torch.Generator(device="cuda").manual_seed(SEED + 61)
    x = torch.randn((R, K), generator=g, device="cuda").to(torch.bfloat16)
    got = mbv.verify_gemv(x, w, s)
    want = mbv.verify_gemv_plain(x, w, s)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    tol = _bf16_ulp(want) + 1e-5 * max(1.0, float(want.float().abs().max()))
    if not bool((diff <= tol).all()):
        raise AssertionError(f"{label}: verify_gemv off its plain version by {diff.max():.3e}")
    size = lambda t: t.numel() * t.element_size()  # noqa: E731
    args = (x, w) if s is None else (x, w, s)
    n_bytes = sum(size(t) for t in args) + size(got)
    copies = _copies(args, n_bytes)
    ms = device_ms_rotating([lambda a=a: mbv.verify_gemv(*a) for a in copies])
    if w.dtype == torch.uint8:
        dense = torch.stack(mk._unpack_nibbles(w), dim=-1).reshape(N, K).to(torch.bfloat16)
    else:
        dense = w.to(torch.bfloat16)
    lib_copies = _copies((x, dense), size(x) + size(dense))
    lib_ms = device_ms_rotating([lambda a=a: torch.matmul(a[0], a[1].t()) for a in lib_copies])
    bnd, by = bound_ms(n_bytes, 2 * R * N * K, H100_BF16_FLOP_PER_S)
    tier = {torch.bfloat16: "bf16", torch.int8: "int8", torch.uint8: "int4"}[w.dtype]
    log(f"  {label}: one GEMV [{R}, {K}] x [{N}, {K}]^T ({tier} weights) alone: device ms "
        f"{ms:.5f}, torch.matmul bf16 yardstick {lib_ms:.5f}, bound {bnd:.5f} ({by}); "
        f"max|kernel-plain| {float(diff.max()):.2e}")
    del copies, lib_copies, dense


def check_megabatch_verify(family: str, cfg, params_for, n_slots: int) -> dict:
    """#18/#19 (GPT-2) or #20/#21 (Llama) against their plain versions (R
    sequential plain steps a slot): n_slots slots at VERIFY_LENGTHS
    (repeated) of C = SERVER_C, R in {2, 8} rows a slot fed as token ids, fp,
    int8, int4 and mixed panes, fp32 and bf16; per slot and row the token
    and the new rows under the megastep tolerances (with the deep-bf16
    allowance for Llama's rows, LLAMA_VERIFY_BF16_TOL for its bf16 tokens),
    every other column and scale untouched; over
    quantized panes each row against the plain step on the kernel's own
    earlier rows (`_teacher_forced_rows`). Device ms in bf16 at R = 8, the
    server protocol's shape."""
    reports = _verify_batch_cases(family, cfg, params_for, n_slots,
                                  gemv_key="gu_w" if family == "llama" else "fc_w")
    return _mega_reports(reports, f"{family}_megabatch_verify",
                         f"{family}_megabatch_verify_quant")


def _verify_batch_cases(family: str, cfg, params_for, n_slots: int, modes=MODES,
                        dtypes=(torch.float32, torch.bfloat16), rows=(2, 8),
                        suffix: str = "", time_plain: bool = True,
                        gemv_key: Optional[str] = None) -> dict:
    """check_megabatch_verify's cases over `modes` x `dtypes` x `rows`:
    {(mode, dtype): report}; `suffix` ends the kernels' names in the log;
    without `time_plain` the plain pass is checked but not timed. With
    `gemv_key`, the bf16 pack's weight of that key also runs alone at the
    pass's n_slots x 8 rows (`_verify_gemv_case`)."""
    from efficient_llm_inference_tpu_torch.ops import megakernel as mk
    from efficient_llm_inference_tpu_torch.ops import megakernel_batch_verify as mbv
    from efficient_llm_inference_tpu_torch.ops import megakernel_llama as ml

    llama = family == "llama"
    pack = ml.pack_llama_mega if llama else mk.pack_gpt2_mega
    W = cfg.n_kv_head * cfg.head_dim if llama else cfg.n_embd
    E = cfg.hidden_size if llama else cfg.n_embd
    names = (f"{family}_megabatch_verify{suffix}", f"{family}_megabatch_verify_quant{suffix}")
    fns = {(False, False): mbv.gpt2_megabatch_verify,
           (False, True): mbv.gpt2_megabatch_verify_plain,
           (True, False): mbv.gpt2_megabatch_verify_quant,
           (True, True): mbv.gpt2_megabatch_verify_quant_plain}
    if llama:
        fns = {(False, False): mbv.llama_megabatch_verify,
               (False, True): mbv.llama_megabatch_verify_plain,
               (True, False): mbv.llama_megabatch_verify_quant,
               (True, True): mbv.llama_megabatch_verify_quant_plain}
    lengths = [VERIFY_LENGTHS[b % len(VERIFY_LENGTHS)] for b in range(n_slots)]
    dev_len = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    reports = {}
    for dtype in dtypes:
        params = params_for(dtype)
        packed = pack(params, cfg)
        for mode in modes:
            i = MODES.index(mode)
            quant = mode != "fp"
            kw = {"kv_mode": mode} if quant else {}
            entry = {"max_abs_err": 0.0}
            for R in rows:
                g = torch.Generator().manual_seed(500 + 10 * R + i)
                ids = torch.randint(0, cfg.vocab_size, (n_slots * R,), generator=g)
                ids = ids.to(torch.int32).cuda()
                t0 = time.perf_counter()
                state = _verify_state(mode, dtype, 600 + 10 * R + i, cfg.n_layer, n_slots, W)
                got = [t.clone() for t in state]
                want = [t.clone() for t in state]

                def kernel():
                    return fns[(quant, False)](packed, *got, dev_len, ids, cfg=cfg, **kw)

                def plain_fn():
                    return fns[(quant, True)](packed, *want, lengths, ids, cfg=cfg,
                                              return_logits=True, **kw)

                toks = kernel()[0]
                # quantized panes are held row by row (the plain verify runs
                # on its own earlier rows): the plain pass only for its time
                logits = None if quant else plain_fn()[-1]
                torch.cuda.synchronize()
                if quant:
                    err, short = _teacher_forced_rows(mode, dtype, packed, cfg, family, state,
                                                      got, toks, ids, lengths, names[1])
                else:
                    err, short = 0.0, 0.0
                    for b, cur in enumerate(lengths):
                        for t in range(R):
                            tok, lg = int(toks[b, t]), logits[b, t]
                            short = max(short, float(lg.max() - lg[tok]))
                            if not _token_ok(tok, lg, dtype,
                                             bf16_tol=LLAMA_VERIFY_BF16_TOL if llama else None):
                                raise AssertionError(
                                    f"{names[0]} {dtype} R={R} slot {b} (length {cur}) row "
                                    f"{t}: token {tok}, plain argmax {int(lg.argmax())}, "
                                    f"{float(lg.max() - lg[tok]):.4f} under the plain maximum")
                        slot = [[x[:, b] for x in v] for v in (got, want, state)]
                        err = max(err, _rows_err(names[0], dtype, *slot,
                                                 torch.arange(cur, cur + R, device="cuda"),
                                                 deep_bf16=llama))
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                line = (f"  {names[quant]} {mode} {str(dtype)[6:]} B={n_slots} R={R} "
                        f"C={SERVER_C} lengths {lengths[:5]} (repeated): tokens "
                        f"{toks[:2].tolist()}, new rows max|kernel-plain| {err:.2e}, tokens "
                        f"at most {short:.4f} under the plain maximum logit (checked in "
                        f"{time.perf_counter() - t0:.1f} s)")
                if dtype == torch.bfloat16 and R == 8:
                    bnd, by = _verify_batch_bound(mode, dtype, cfg, family, lengths, R, packed)
                    entry.update({
                        "ms": device_ms(kernel, calls=5),
                        "plain_ms": (device_ms(plain_fn, calls=1, replays=1)
                                     if time_plain and mode in LINE_MODES else None),
                        "bound_ms": bnd, "bound_by": by, "library_ms": None,
                    })
                    line += (f"; device ms kernel {entry['ms']:.5f}, plain "
                             f"{_ms(entry['plain_ms'])}, bound {bnd:.5f} ({by}); per row "
                             f"{entry['ms'] / (n_slots * R):.5f}")
                log(line)
            reports[(mode, dtype)] = entry
        if gemv_key is not None and dtype == torch.bfloat16:
            _verify_gemv_case(f"{names[0]} {gemv_key}", packed, gemv_key, n_slots * 8)
        del params, packed
    return reports


def check_verify_past_128_rows(gpt2_cfg, gpt2, llama) -> None:
    """The batched verify past the old 128-row limit, with
    check_megabatch_verify's checks and tolerances at R = 8, fp32 and bf16:
    #19 over int8 panes at 32 x 8
    rows and #18 at 24 x 8 on GPT-2 small, #20 at 24 x 8 on Llama-3.2-1B
    (C = SERVER_C); then a spec="ngram"
    MegaBatchServer of 32 slots over an int8 pool (256 verify rows a round)
    serves the server protocol's 32 requests on GPT-2 small."""
    gpt2_params = lambda dtype: _cast_params(gpt2.params, dtype)  # noqa: E731
    for family, cfg, params_for, n_slots, mode in (
            ("gpt2", gpt2_cfg, gpt2_params, 32, "int8"),
            ("gpt2", gpt2_cfg, gpt2_params, 24, "fp"),
            ("llama", llama.model.config, lambda dtype: _cast_params(llama.params, dtype),
             24, "fp")):
        _verify_batch_cases(family, cfg, params_for, n_slots, modes=(mode,), rows=(8,))
    srv = _server(gpt2, 32, "int8", "ngram")
    reqs, wall, rounds = _serve(srv, _server_prompts(gpt2.tokenizer, 32))
    if not (all(len(r.out_ids) == NEW_TOKENS for r in reqs) and rounds > 0
            and all(0 <= t < gpt2.model.vocab_size for r in reqs for t in r.out_ids)):
        raise AssertionError("the 32-slot spec server did not serve its requests")
    log(f"  MegaBatchServer gpt2 spec=ngram int8 32 slots (B x R = {32 * SPEC_K} rows): "
        f"32 requests in {wall:.3f} s ({32 * NEW_TOKENS / wall:.1f} tokens/s, first run: "
        f"graph captures included), {rounds} rounds, spec_stats {srv.spec_stats}")


DRAFT_C = 208  # the draft main path's capacity: roundup8(128 + 64 + 4 + 1) + 8


def _draft_cfgs():
    """The repo's byte-vocab drafts (examples/train_scale_models.py)."""
    from efficient_llm_inference_tpu_torch.models import gpt2 as gpt2_mod
    from efficient_llm_inference_tpu_torch.models import llama as llama_mod

    return {
        "gpt2": gpt2_mod.GPT2Config(vocab_size=256, n_positions=256, n_embd=128,
                                    n_layer=2, n_head=4),
        "llama": llama_mod.LlamaConfig(vocab_size=256, n_positions=256, hidden_size=256,
                                       intermediate_size=512, n_layer=1, n_head=4,
                                       n_kv_head=2, rope_theta=10000.0,
                                       tie_embeddings=True),
    }


def check_draft_bursts() -> dict:
    """#22 and #23 at the draft geometries (draft_gpt2: E=128, L=2, 4 heads of
    D=32, V=256; draft_llama: E=256, I=512, L=1, 4 query heads on 2, tied),
    random weights, bf16 and fp32, k = 4, C = DRAFT_C, lengths 0, 60 and
    C - 8 - k: each proposal against the plain step teacher-forced with the
    kernel's tokens (the megastep tolerances), the k new rows, every other
    row untouched. The block weights are widened 7.5x (std 0.15, as the CPU
    tests draw them): at std 0.02 a tied draft proposes its input token k
    times, which would leave the token feedback untested. Device ms in bf16
    at length 60, beside k plain steps."""
    from efficient_llm_inference_tpu_torch.models import gpt2 as gpt2_mod
    from efficient_llm_inference_tpu_torch.models import llama as llama_mod
    from efficient_llm_inference_tpu_torch.ops import megakernel as mk
    from efficient_llm_inference_tpu_torch.ops import megakernel_draft as md
    from efficient_llm_inference_tpu_torch.ops import megakernel_llama as ml

    reports = {}
    for family, cfg in _draft_cfgs().items():
        llama = family == "llama"
        name = f"{family}_draft_burst"
        kern = md.llama_draft_burst if llama else md.gpt2_draft_burst
        step = ml.llama_megastep_plain if llama else mk.gpt2_megastep_plain
        W = cfg.n_kv_head * cfg.head_dim if llama else cfg.n_embd
        worst, fed_back = 0.0, False
        for dtype in (torch.float32, torch.bfloat16):
            init = llama_mod.init_llama_params if llama else gpt2_mod.init_gpt2_params
            params = init(torch.Generator().manual_seed(11), cfg, dtype, "cuda")
            for n_, t in params["blocks"].items():
                if n_.startswith("w") or n_.endswith("_w"):  # the matmul weights
                    t.mul_(7.5)
            packed = (md.pack_llama_draft if llama else md.pack_gpt2_draft)(params, cfg)
            for i, dlen in enumerate((0, 60, DRAFT_C - 8 - DRAFT_K)):
                g = torch.Generator().manual_seed(500 + i)
                state = [(torch.randn((cfg.n_layer, DRAFT_C, W), generator=g) * 0.5)
                         .to(dtype).cuda() for _ in range(2)]
                cur = 97 + i
                got = [t.clone() for t in state]
                dev_len = torch.tensor([dlen], dtype=torch.int32, device="cuda")
                dev_cur = torch.tensor([cur], dtype=torch.int32, device="cuda")

                def kernel():
                    return kern(packed, *got, dev_len, dev_cur, cfg=cfg, k=DRAFT_K)

                props = kernel()[0]
                torch.cuda.synchronize()
                want = [t.clone() for t in state]
                tok, xs = cur, []
                for s_ in range(DRAFT_K):
                    xs.append(packed["embed"][tok][None] if llama else
                              (packed["wte"][tok] + packed["wpe"][min(dlen + s_, 255)])[None]
                              .to(dtype))
                    logits = step(packed, *want, dlen + s_, xs[-1], cfg=cfg,
                                  return_logits=True)[-1]
                    if not _token_ok(int(props[s_]), logits, dtype):
                        raise AssertionError(f"{name} {dtype} dlen={dlen} step {s_}: "
                                             f"token {int(props[s_])}, plain argmax "
                                             f"{int(logits.argmax())}")
                    tok = int(props[s_])
                err = _rows_err(name, dtype, got, want, state,
                                torch.arange(dlen, dlen + DRAFT_K, device="cuda"))
                worst = max(worst, err)
                fed_back |= len(set(props.tolist())) > 1
                line = (f"  {name} {str(dtype)[6:]} k={DRAFT_K} C={DRAFT_C} dlen={dlen}: "
                        f"proposals {props.tolist()}, new rows max|kernel-plain| {err:.2e}")
                if dtype == torch.bfloat16 and dlen == 60:
                    # every weight and table read once (the tied head is the
                    # embedding; k rows of wpe/RoPE), the visible and new KV
                    # rows once; two operations per weight element and step
                    used = [t for n_, t in packed.items()
                            if n_ not in ("cos", "sin", "wpe", "head")]
                    n_w = sum(t.numel() for t in used if t.dtype == dtype)
                    n_bytes = (sum(t.numel() * t.element_size() for t in used)
                               + (dlen + DRAFT_K) * 2 * cfg.n_layer * W * 2
                               + DRAFT_K * (cfg.head_dim * 8 if llama else cfg.n_embd * 2))
                    b, by = bound_ms(n_bytes, 2 * n_w * DRAFT_K, H100_BF16_FLOP_PER_S)

                    def plain_steps():  # the plain burst's k steps, the kernel's tokens fed
                        for s_, x in enumerate(xs):
                            step(packed, *want, dlen + s_, x, cfg=cfg)

                    reports[name] = {
                        "ms": device_ms(kernel, calls=20),
                        "plain_ms": device_ms(plain_steps, calls=1, replays=3),
                        "bound_ms": b, "bound_by": by, "library_ms": None,
                    }
                    r = reports[name]
                    line += (f"; device ms kernel {r['ms']:.5f} ({r['ms'] / DRAFT_K:.5f} a "
                             f"step), plain {r['plain_ms']:.5f}, bound {b:.7f} ({by}; "
                             f"latency-bound)")
                log(line)
            del params, packed
        if not fed_back:
            raise AssertionError(f"{name}: every burst proposed one token k times")
        reports[name]["max_abs_err"] = worst
    return reports


# ------------------------------------------------------------ kernel library
#
# The kernel API (efficient_llm_inference_tpu_torch.ops, the names of the JAX
# package's ops.pallas): #4 fused_quant_attention_decode, #5 dequant_int8, #6
# dequant_int4_packed, #7 pallas_linear, #8 pallas_linear_int8, #24
# paged_attention_decode. No engine path calls them; this phase is their main
# path: each is called as a user of the API calls it, at full width on the
# engines' own state, with the launch counters zeroed just before and read
# just after.

LIB_KERNELS = ("fused_quant_attention_decode", "dequant_int8", "dequant_int4_packed",
               "pallas_linear", "pallas_linear_int8", "paged_attention_decode")
LIB_C = PROMPT_TOKENS + NEW_TOKENS  # the quantized caches' capacity (phase 5's)
# engine/batching.py PoolConfig's geometry: block_size, n_blocks, max_blocks_per_seq
POOL_BS, POOL_BLOCKS, POOL_TABLE, POOL_SLOTS = 64, 256, 32, 8
COLD_BYTES = 160e6  # rotating input copies past the 50 MB L2


def device_ms_rotating(fns, calls: int = 48, replays: int = 3) -> float:
    """device_ms over calls on distinct copies of their inputs, taken in
    turn (copies together past L2), so each call finds its inputs in device
    memory, as a decode step finds its weights."""
    turn = [0]

    def step():
        fns[turn[0] % len(fns)]()
        turn[0] += 1

    return device_ms(step, calls=calls, replays=replays)


def _copies(args: tuple, n_bytes: float) -> list:
    """`args` and copies of them (their tensors cloned), together at least
    COLD_BYTES."""
    n = max(1, math.ceil(COLD_BYTES / max(n_bytes, 1.0)))
    clone = lambda a: a.clone() if isinstance(a, torch.Tensor) else a  # noqa: E731
    return [args] + [tuple(clone(a) for a in args) for _ in range(n - 1)]


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    e = torch.floor(torch.log2(t.float().abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


def _quant_caches(eng, prompt: str) -> dict:
    """{mode: QuantizedKV cache} of the engine's prefill of `prompt` for the
    int8, int4 and mixed caches, as benchmark_method's quant_* methods build
    them (per_token scales, capacity LIB_C)."""
    from efficient_llm_inference_tpu_torch.cache.kvcache import QuantizedKV
    from efficient_llm_inference_tpu_torch.engine.generate import make_prefill

    ids = eng.tokenizer.encode(prompt)
    tokens = torch.tensor([ids], dtype=torch.long, device="cuda")
    caches = {}
    for mode in ("int8", "int4", "mixed"):
        strategy = QuantizedKV(**eng._dense_kw(LIB_C), mode=mode)
        caches[mode], _ = make_prefill(eng.model, strategy)(eng.params, tokens, len(ids))
    torch.cuda.synchronize()
    return caches


def _paged_pool(eng):
    """PoolConfig's pool ([Hkv, 256 blocks, 64, D] K and V) filled with
    layer 0's K/V rows of the engine's batched prefill of the batch main
    path's 8 prompts (24-256 tokens), each slot's blocks taken from a seeded
    permutation, the rest of its table sentinels (>= n_blocks); slot 7 idle
    (length 0, every entry a sentinel). Returns (k_pool, v_pool, tables,
    lengths, the prefill's dense rows [B, Hkv, C, D] K and V)."""
    from efficient_llm_inference_tpu_torch.cache.kvcache import DenseKV
    from efficient_llm_inference_tpu_torch.engine.generate import prefill_batch

    prompts = _batch_prompts(POOL_SLOTS, SEED + 3)
    ids = [eng.tokenizer.encode(p) for p in prompts]
    lens = [len(i) for i in ids]
    buf = torch.zeros((POOL_SLOTS, max(lens)), dtype=torch.long)
    for b, row in enumerate(ids):
        buf[b, :len(row)] = torch.tensor(row)
    strategy = DenseKV(**dict(eng._dense_kw(max(lens)), batch=POOL_SLOTS))
    cache, _ = prefill_batch(eng.model, strategy, eng.params, buf.cuda(),
                             torch.tensor(lens, device="cuda"))
    k, v = cache["k"][0], cache["v"][0]  # [B, Hkv, C, D]
    Hkv, D = k.shape[1], k.shape[3]
    lengths = lens[:-1] + [0]
    perm = torch.randperm(POOL_BLOCKS, generator=torch.Generator().manual_seed(SEED + 24))
    g = torch.Generator(device="cuda").manual_seed(SEED + 25)
    k_pool, v_pool = ((torch.randn((Hkv, POOL_BLOCKS, POOL_BS, D), generator=g,
                                   device="cuda") * 0.5).to(k.dtype) for _ in range(2))
    tables = torch.full((POOL_SLOTS, POOL_TABLE), POOL_BLOCKS, dtype=torch.int32)
    nxt = 0
    for b, n in enumerate(lengths):
        for j in range(-(-n // POOL_BS)):
            blk = int(perm[nxt])
            nxt += 1
            tables[b, j] = blk
            rows = slice(j * POOL_BS, min(n, (j + 1) * POOL_BS))
            width = rows.stop - rows.start
            k_pool[:, blk, :width] = k[b, :, rows]
            v_pool[:, blk, :width] = v[b, :, rows]
    tables[0, -1] = POOL_BLOCKS + 9  # a sentinel past n_blocks, also clamped
    return (k_pool, v_pool, tables.cuda(), torch.tensor(lengths, dtype=torch.int32,
                                                        device="cuda"), k, v)


def _library_inputs(gpt2, llama) -> dict:
    """Every call of the phase's drive: {case: (kernel name, fn, args,
    kwargs)}, on the engines' state, built before the counters are zeroed."""
    from efficient_llm_inference_tpu_torch import ops

    cases = {}
    prompt = _prompts(N_PROMPTS, SEED)[0]  # phase 5's first prompt, 256 tokens
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    for fam, eng in (("gpt2", gpt2), ("llama", llama)):
        caches = _quant_caches(eng, prompt)
        if fam == "gpt2":  # #5/#6 over the whole caches; scales per token over heads
            for part in ("k", "v"):
                c8, c4 = caches["int8"], caches["int4"]
                s8 = c8[f"{part}_scale"][:, None, None, :, None]
                s4 = c4[f"{part}_scale"][:, None, None, :, None]
                for dt in (torch.bfloat16, torch.float32):
                    name = str(dt)[6:]
                    cases[f"dequant_int8 gpt2 {part} cache {name}"] = (
                        "dequant_int8", ops.dequant_int8, (c8[part], s8, dt), {})
                    cases[f"dequant_int4 gpt2 {part} cache {name}"] = (
                        "dequant_int4_packed", ops.dequant_int4_packed,
                        (c4[part], s4, c4[part].shape[-1] * 2, dt), {})
                scalar = torch.tensor(0.0123, device="cuda")
                cases[f"dequant_int8 gpt2 {part} cache scalar"] = (
                    "dequant_int8", ops.dequant_int8, (c8[part], scalar), {})
                odd = c4[part].shape[-1] * 2 - 1  # 63: the pad lane cut
                cases[f"dequant_int4 gpt2 {part} cache scalar, orig {odd}"] = (
                    "dequant_int4_packed", ops.dequant_int4_packed, (c4[part], scalar, odd), {})
        H, D = eng.model.n_head, eng.model.head_dim
        Hkv = eng.model.n_kv_head
        for mode, (kb, vb) in (("int8", (8, 8)), ("int4", (4, 4)), ("mixed", (8, 4))):
            c = caches[mode]
            qkv = [torch.randn((n, D), generator=gen, device="cuda") for n in (H, Hkv, Hkv)]
            for dt in (torch.bfloat16, torch.float32):
                q, k_cur, v_cur = (t.to(dt) for t in qkv)
                for length in (PROMPT_TOKENS, 0):
                    length_t = torch.tensor([length], dtype=torch.int32, device="cuda")
                    args = (q, c["k"][0, 0], c["k_scale"][0].expand(Hkv, LIB_C), c["v"][0, 0],
                            c["v_scale"][0].expand(Hkv, LIB_C), k_cur, v_cur, length_t)
                    cases[f"decode_attention {fam} layer 0 {mode} length {length}"
                          f"{'' if dt == torch.bfloat16 else ' float32'}"] = (
                        "fused_quant_attention_decode", ops.fused_quant_attention_decode, args,
                        {"k_bits": kb, "v_bits": vb})
        del caches
    b2, b3 = gpt2.params["blocks"], llama.params["blocks"]
    mats = {"gpt2 fc_w": b2["fc_w"][0], "gpt2 fc_proj_w": b2["fc_proj_w"][0],
            "gpt2 lm_head wte.T": gpt2.params["wte"].t().contiguous(),
            "llama w_gate": b3["w_gate"][0], "llama w_down": b3["w_down"][0]}
    for mname, w in mats.items():
        for dt in (torch.bfloat16, torch.float32):
            wd = w.to(dt).contiguous()
            w_q, w_s = ops.quantize_weight_int8(wd)
            for B in (1, 8):
                x = torch.randn((B, w.shape[0]), generator=gen, device="cuda").to(dt)
                tag = f"{mname} [{B}, {w.shape[0]}] x [{w.shape[0]}, {w.shape[1]}] {str(dt)[6:]}"
                cases[f"linear {tag}"] = ("pallas_linear", ops.pallas_linear, (x, wd), {})
                cases[f"linear_int8 {tag}"] = ("pallas_linear_int8", ops.pallas_linear_int8,
                                              (x, w_q, w_s), {})
    k_pool, v_pool, tables, lengths, dense_k, dense_v = _paged_pool(llama)
    Hq = llama.model.n_head
    q = torch.randn((POOL_SLOTS, Hq, k_pool.shape[-1]), generator=gen,
                    device="cuda").to(k_pool.dtype)
    cases["paged llama-3-1b prefill rows"] = (
        "paged_attention_decode", ops.paged_attention_decode,
        (q, k_pool, v_pool, tables, lengths), {})
    full_tables = torch.randperm(POOL_BLOCKS, generator=torch.Generator().manual_seed(SEED + 26))
    full_tables = full_tables.reshape(POOL_SLOTS, POOL_TABLE).to(torch.int32).cuda()
    full = torch.full((POOL_SLOTS,), POOL_TABLE * POOL_BS, dtype=torch.int32, device="cuda")
    cases["paged llama-3-1b full lengths"] = (
        "paged_attention_decode", ops.paged_attention_decode,
        (q, k_pool, v_pool, full_tables, full), {})
    q32, k32, v32 = (t.float() for t in (q, k_pool, v_pool))  # the same values widened
    cases["paged llama-3-1b prefill rows float32"] = (
        "paged_attention_decode", ops.paged_attention_decode,
        (q32, k32, v32, tables, lengths), {})
    cases["paged llama-3-1b full lengths float32"] = (
        "paged_attention_decode", ops.paged_attention_decode,
        (q32, k32, v32, full_tables, full), {})
    H2 = gpt2.model.n_head
    k2, v2 = ((torch.randn((H2, POOL_BLOCKS, POOL_BS, 64), generator=gen, device="cuda") * 0.5)
              .to(torch.bfloat16) for _ in range(2))
    q2 = torch.randn((POOL_SLOTS, H2, 64), generator=gen, device="cuda").to(torch.bfloat16)
    cases["paged gpt2 geometry"] = ("paged_attention_decode", ops.paged_attention_decode,
                                    (q2, k2, v2, tables, lengths), {})
    cases["paged gpt2 geometry full lengths"] = (
        "paged_attention_decode", ops.paged_attention_decode,
        (q2, k2, v2, full_tables, full), {})
    return {"cases": cases, "dense": (dense_k, dense_v)}


def _plain_of(name: str):
    from efficient_llm_inference_tpu_torch.ops import attention, dequant, linear, paged

    return {
        "dequant_int8": dequant.dequant_int8_plain,
        "dequant_int4_packed": dequant.dequant_int4_packed_plain,
        "pallas_linear": linear.pallas_linear_plain,
        "pallas_linear_int8": linear.pallas_linear_int8_plain,
        "fused_quant_attention_decode": attention.fused_quant_attention_decode_plain,
        "paged_attention_decode": paged.paged_attention_decode_plain,
    }[name]


def _attention_close(got, want, fp32_tol: float) -> bool:
    """fp32 output: within `fp32_tol` (#4 1e-4 and #24 2e-5, the card tests'
    atol). bf16 output: within two bf16 ulps of the plain result plus 1e-3
    of its largest value (the kernel and the plain version both round one
    fp32 value whose sum order differs, so they sit one ulp apart at most);
    a slot that skipped one pool block in 32 moves its output by more."""
    g_, w_ = got.float(), want.float()
    if got.dtype == torch.float32:
        return (g_ - w_).abs().max().item() <= fp32_tol
    tol = 2 * _bf16_ulp(w_) + 1e-3 * w_.abs().max().item()
    return bool(((g_ - w_).abs() <= tol).all())


def _library_err(case: str, name: str, got, args, kw) -> float:
    """Raises unless the kernel's output `got` holds against its plain
    version (and the case's second reference); returns max |kernel - plain|.
    Dequant: bit-exact, and equal to ops/quantization.dequantize_*. Linear:
    fp32 within 1e-5 of the output's largest value; bf16 within one bf16 ulp
    of the plain result plus that term. Attention (`_attention_close`): fp32
    1e-4 (#4; and bit-equal to #1 at B = 1) and 2e-5 (#24); bf16 two ulps of
    the plain result plus 1e-3 of its largest value."""
    from efficient_llm_inference_tpu_torch.ops import attention, quantization

    want = _plain_of(name)(*args, **kw)
    err = (got.float() - want.float()).abs().max().item() if got.numel() else 0.0
    if name.startswith("dequant"):
        if name == "dequant_int8":
            ref = quantization.dequantize_int8(args[0], args[1], got.dtype)
        else:
            ref = quantization.dequantize_int4_packed(args[0], args[1], got.dtype, args[2])
        if not (torch.equal(got, want) and torch.equal(got, ref)):
            raise AssertionError(f"{case}: not bit-exact (max |diff| {err})")
        return err
    if name.startswith("pallas_linear"):
        fp32 = 1e-5 * max(1.0, want.float().abs().max().item())
        tol = fp32 if got.dtype == torch.float32 else _bf16_ulp(want) + fp32
        if not bool(((got.float() - want.float()).abs() <= tol).all()):
            raise AssertionError(f"{case}: max |kernel - plain| {err}")
        return err
    if not _attention_close(got, want, 1e-4 if name == "fused_quant_attention_decode" else 2e-5):
        raise AssertionError(f"{case}: max |kernel - plain| {err}")
    if name == "fused_quant_attention_decode":
        q, k_q, k_s, v_q, v_s, k_cur, v_cur, length = args
        batched = attention.fused_quant_attention_batched(
            q[None], k_q[None], k_s[None], v_q[None], v_s[None], k_cur[None, :, None],
            v_cur[None, :, None], length, 1, **kw)[0]
        if not torch.equal(got, batched):
            raise AssertionError(f"{case}: differs from #1 at B = 1")
        if int(length) == 0:  # the current token alone
            G = q.shape[0] // k_cur.shape[0]
            if not _attention_close(got, v_cur.repeat_interleave(G, 0), 1e-4):
                raise AssertionError(f"{case}: length 0 is not v_cur")
    return err


def _paged_dense_err(got, args, dense) -> float:
    """#24 on the prefill rows against dense attention over the unpaged rows
    (softmax in fp32), and the idle slot against the mean of V over its
    walk (every entry a sentinel: the last block, POOL_TABLE times), under
    `_attention_close`'s tolerances."""
    q, k_pool, v_pool, tables, lengths = args
    dense_k, dense_v = dense
    G = q.shape[1] // k_pool.shape[0]
    err = 0.0
    for b, n in enumerate(lengths.tolist()):
        if n == 0:
            want = v_pool[:, POOL_BLOCKS - 1].float().mean(1).repeat_interleave(G, 0)
        else:
            k = dense_k[b, :, :n].float().repeat_interleave(G, 0)
            v = dense_v[b, :, :n].float().repeat_interleave(G, 0)
            p = torch.softmax(torch.einsum("hd,hnd->hn", q[b].float(), k)
                              / math.sqrt(q.shape[-1]), dim=-1)
            want = torch.einsum("hn,hnd->hd", p, v)
        if not _attention_close(got[b], want, 2e-5):
            raise AssertionError(f"paged attention slot {b} (length {n}) against dense "
                                 f"attention: {(got[b].float() - want).abs().max().item()}")
        err = max(err, (got[b].float() - want).abs().max().item())
    return err


def _library_yardstick(name: str, args, kw):
    """One PyTorch call (or, for #8 and the attentions, the library calls
    named in PERF.md) computing the same function, timed beside the kernel;
    None where there is none (#6: no call unpacks nibbles)."""
    F = torch.nn.functional
    from efficient_llm_inference_tpu_torch.ops import quantization

    if name == "dequant_int8":
        q, s = args[:2]
        out = torch.empty(q.shape, dtype=args[2] if len(args) > 2 else torch.bfloat16,
                          device=q.device)
        return lambda: torch.mul(q, s, out=out)
    if name == "pallas_linear":
        x, w = args
        return (lambda: torch.matmul(x, w)) if x.dtype == w.dtype else None
    if name == "pallas_linear_int8":
        x, w_q, w_s = args
        return lambda: torch.matmul(x.to(torch.bfloat16), w_q.to(torch.bfloat16)) * w_s
    if name == "fused_quant_attention_decode":
        q, k_q, k_s, v_q, v_s, k_cur, v_cur, length = args
        n, G = int(length), q.shape[0] // k_cur.shape[0]

        def deq(codes, scale, bits):
            fn = quantization.dequantize_int8 if bits == 8 else \
                quantization.dequantize_int4_packed
            return fn(codes[:, :n], scale[:, :n, None], q.dtype)

        def lib():  # dequantize the visible rows, then one SDPA call
            k, v = k_cur[:, None], v_cur[:, None]
            if n:
                k = torch.cat([deq(k_q, k_s, kw["k_bits"]), k], 1)
                v = torch.cat([deq(v_q, v_s, kw["v_bits"]), v], 1)
            return F.scaled_dot_product_attention(
                q[:, None], k.repeat_interleave(G, 0), v.repeat_interleave(G, 0))
        return lib
    if name == "paged_attention_decode":
        q, k_pool, v_pool, tables, lengths = args
        Hkv, n_blocks, bs, D = k_pool.shape
        B, G, T = q.shape[0], q.shape[1] // Hkv, tables.shape[1] * bs
        t = tables.long().clamp(0, n_blocks - 1)
        mask = torch.arange(T, device=q.device)[None, :] < lengths.long()[:, None]
        mask = mask[:, None, None, :]

        def lib():  # gather the table's blocks, one masked SDPA call
            k = k_pool[:, t].reshape(Hkv, B, T, D).transpose(0, 1)
            v = v_pool[:, t].reshape(Hkv, B, T, D).transpose(0, 1)
            return F.scaled_dot_product_attention(
                q[:, :, None], k.repeat_interleave(G, 1), v.repeat_interleave(G, 1),
                attn_mask=mask)
        return lib
    return None


def _library_bound(name: str, args, kw, got) -> tuple:
    """Least time of one call: each input byte read once (what this call's
    data needs: the visible K/V rows), the output written once; operations
    at the rate of their type."""
    size = lambda t: t.numel() * t.element_size()  # noqa: E731
    out = size(got)
    if name.startswith("dequant"):
        q, s = args[:2]
        return bound_ms(size(q) + size(s) + out, got.numel())
    if name.startswith("pallas_linear"):
        x, w = args[:2]
        B, E = x.shape
        n_bytes = size(x) + size(w) + out + (size(args[2]) if len(args) > 2 else 0)
        rate = H100_BF16_FLOP_PER_S if (name.endswith("int8") or w.dtype == torch.bfloat16) \
            else H100_FP32_FLOP_PER_S
        return bound_ms(n_bytes, 2 * B * E * w.shape[1], rate)
    if name == "fused_quant_attention_decode":
        q, k_q, k_s, v_q, v_s, k_cur, v_cur, length = args
        n = min(int(length), k_q.shape[1])
        Hkv, C = k_q.shape[:2]
        rows = n * Hkv * (k_q.shape[2] + v_q.shape[2] + 8)  # visible codes, scales
        n_bytes = size(q) + out + rows + size(k_cur) + size(v_cur) + 4
        return bound_ms(n_bytes, q.shape[0] * (n + 1) * (4 * q.shape[1] + 8))
    # #24: a slot of length n > 0 reads its n visible K and V rows; an idle
    # slot (length 0) returns the mean of V over its clamped table, so it
    # reads the V rows of the distinct blocks that table names and no K
    q, k_pool, v_pool, tables, lengths = args
    n_blocks, bs = k_pool.shape[1:3]
    walk = tables.shape[1] * bs
    D, Hkv, Hq = q.shape[-1], k_pool.shape[0], q.shape[1]
    kv_rows = v_rows = flops = 0
    for b, x in enumerate(lengths.tolist()):
        if x > 0:
            kv_rows += min(x, walk)
            flops += min(x, walk) * Hq * (4 * D + 8)
        else:
            distinct = torch.unique(tables[b].clamp(max=n_blocks - 1)).numel()
            v_rows += distinct * bs
            flops += distinct * bs * Hq * D
    n_bytes = (size(q) + out + size(tables) + size(lengths)
               + (2 * kv_rows + v_rows) * Hkv * D * k_pool.element_size())
    return bound_ms(n_bytes, flops)


# the case whose numbers stand in the kernels line, one a kernel
LIB_REPORTED = {
    "dequant_int8": "dequant_int8 gpt2 k cache bfloat16",
    "dequant_int4_packed": "dequant_int4 gpt2 k cache bfloat16",
    "pallas_linear": "linear llama w_gate [1, 2048] x [2048, 8192] bfloat16",
    "pallas_linear_int8": "linear_int8 llama w_gate [1, 2048] x [2048, 8192] bfloat16",
    "fused_quant_attention_decode": "decode_attention gpt2 layer 0 int8 length 256",
    "paged_attention_decode": "paged llama-3-1b prefill rows",
}


def phase_kernel_library(launches: dict, gpt2, llama) -> dict:
    """The kernel API's main path: every case of `_library_inputs` called
    once through `efficient_llm_inference_tpu_torch.ops`, the counters zeroed
    just before and read just after (each of the six launched, nothing
    else); each output held against its plain version; then each case timed
    (device ms by graph replay over input copies past L2, eager ms, plain,
    library yardstick, bound). Returns the kernels line's entries."""
    t0 = time.perf_counter()
    state = _library_inputs(gpt2, llama)
    cases = state["cases"]
    log(f"  kernel library: {len(cases)} calls built on the engines' state in "
        f"{time.perf_counter() - t0:.1f} s")
    outs, got = _counted(launches, lambda: {c: fn(*a, **kw) for c, (_, fn, a, kw)
                                            in cases.items()})
    torch.cuda.synchronize()
    want = {k: 0 for k in counters()}
    for name, *_ in cases.values():
        want[name] += 1
    if got != want:
        raise AssertionError(f"kernel library: launches {got}, expected {want}")
    log(f"  kernel library launches: {json.dumps({k: v for k, v in got.items() if v})}")
    reports = {name: {"max_abs_err": 0.0} for name in LIB_KERNELS}
    for case, (name, fn, args, kw) in cases.items():
        err = _library_err(case, name, outs[case], args, kw)
        if case.startswith("paged llama-3-1b prefill"):
            err = max(err, _paged_dense_err(outs[case], args, state["dense"]))
        reports[name]["max_abs_err"] = max(reports[name]["max_abs_err"], err)
        in_bytes = sum(t.numel() * t.element_size() for t in args
                       if isinstance(t, torch.Tensor))
        copies = _copies(args, in_bytes)
        kernel_ms = device_ms_rotating([lambda a=a: fn(*a, **kw) for a in copies])
        lib = _library_yardstick(name, args, kw)
        lib_ms = None
        if lib is not None:
            lib_ms = device_ms_rotating(
                [_library_yardstick(name, a, kw) for a in copies])
        plain = _plain_of(name)
        plain_ms = device_ms(lambda: plain(*args, **kw), calls=3, replays=2)
        eager = eager_ms(lambda: fn(*args, **kw), iters=20)
        bnd, by = _library_bound(name, args, kw, outs[case])
        log(f"  {case}: device ms kernel {kernel_ms:.5f} (eager {eager:.5f}), plain "
            f"{plain_ms:.5f}, library {'none' if lib_ms is None else f'{lib_ms:.5f}'}, "
            f"bound {bnd:.6f} ({by}); max|kernel-plain| {err:.2e}")
        if case == LIB_REPORTED[name]:
            reports[name].update({"ms": kernel_ms, "eager_ms": eager, "plain_ms": plain_ms,
                                  "library_ms": lib_ms, "bound_ms": bnd, "bound_by": by,
                                  "shape": case})
        del copies
    torch.cuda.empty_cache()
    missing = [name for name, r in reports.items() if "ms" not in r]
    if missing:
        raise AssertionError(f"kernel library: no reported case for {missing}")
    return reports


def _cast_params(params: dict, dtype) -> dict:
    return {k: (_cast_params(v, dtype) if isinstance(v, dict) else v.to(dtype))
            for k, v in params.items()}


def _leaves(params: dict):
    for v in params.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


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
    from efficient_llm_inference_tpu_torch.ops import (
        attention, dequant, linear, megakernel, megakernel_batch, megakernel_batch_quant,
        megakernel_batch_verify, megakernel_draft, megakernel_llama, megakernel_quant, paged,
        quantize)

    fns = {
        "fused_quant_attention_decode": attention.fused_quant_attention_decode,
        "dequant_int8": dequant.dequant_int8,
        "dequant_int4_packed": dequant.dequant_int4_packed,
        "pallas_linear": linear.pallas_linear,
        "pallas_linear_int8": linear.pallas_linear_int8,
        "paged_attention_decode": paged.paged_attention_decode,
        "gpt2_megabatch_verify": megakernel_batch_verify.gpt2_megabatch_verify,
        "gpt2_megabatch_verify_quant": megakernel_batch_verify.gpt2_megabatch_verify_quant,
        "llama_megabatch_verify": megakernel_batch_verify.llama_megabatch_verify,
        "llama_megabatch_verify_quant": megakernel_batch_verify.llama_megabatch_verify_quant,
        "gpt2_megaverify": megakernel.gpt2_megaverify,
        "llama_megaverify": megakernel_llama.llama_megaverify,
        "gpt2_draft_burst": megakernel_draft.gpt2_draft_burst,
        "llama_draft_burst": megakernel_draft.llama_draft_burst,
        "gpt2_megabatch": megakernel_batch.gpt2_megabatch,
        "llama_megabatch": megakernel_batch.llama_megabatch,
        "gpt2_megabatch_quant": megakernel_batch_quant.gpt2_megabatch_quant,
        "llama_megabatch_quant": megakernel_batch_quant.llama_megabatch_quant,
        "fused_quant_attention_batched": attention.fused_quant_attention_batched,
        "quantize_int8_rows": quantize.quantize_int8_rows,
        "quantize_int4_rows": quantize.quantize_int4_rows,
        "gpt2_megastep": megakernel.gpt2_megastep,
        "gpt2_megastep_quant": megakernel_quant.gpt2_megastep_quant,
        "llama_megastep": megakernel_llama.llama_megastep,
        "llama_megastep_quant": megakernel_quant.llama_megastep_quant,
    }
    for name in TIERED:  # each weight tier's launches, apart from the wrapper's
        for w in ("int8", "int4"):
            fns[f"{name}_{TIER_SUFFIX[w]}"] = fns[name].tiers[w]
    return fns


def _expected_launches(method: str, mega: bool, L: int, n_gen: int,
                       family: str) -> dict:
    want = {name: 0 for name in counters()}
    if method == "full_cache":
        if mega:
            want[f"{family}_megastep"] = NEW_TOKENS * n_gen
        return want
    mode = method.replace("quant_", "")
    k8, v8 = mode in ("int8", "mixed"), mode == "int8"
    # the rows kernels quantize K and V per layer and forward pass: the
    # prefill and, megakernel off, every decode step
    per_pass = L * n_gen * (1 if mega else NEW_TOKENS + 1)
    want["quantize_int8_rows"] = per_pass * (k8 + v8)
    want["quantize_int4_rows"] = per_pass * ((not k8) + (not v8))
    if mega:
        want[f"{family}_megastep_quant"] = NEW_TOKENS * n_gen
    else:
        want["fused_quant_attention_batched"] = L * NEW_TOKENS * n_gen
    return want


def phase_main_path(launches: dict, name: str, engines) -> dict:
    """benchmark_method for the four methods with the megakernel off
    (Config(megakernel=False)), then with the default config (on).
    `engines(mega)` makes the engine of each path through
    InferenceEngine.from_model_name. Returns the megakernel-on tokens/s of
    each method."""
    prompts = _prompts(N_PROMPTS, SEED)
    n_gen = N_PROMPTS + 1  # benchmark_method warms up once (one bucket)
    tps = {}
    for mega in (False, None):  # megakernel off, then the default (on)
        eng = engines(mega)
        family = eng.model.name
        assert eng.config.device == "cuda" and eng.config.dtype == torch.bfloat16
        assert all(t.is_cuda for t in (eng.params.get("wte"), eng.params.get("embed"))
                   if t is not None)
        assert eng.config.resolved_megakernel() == (mega is None)
        assert all(len(eng.tokenizer.encode(p)) == PROMPT_TOKENS for p in prompts)
        L = eng.model.n_layer
        for method in METHODS:
            for fn in counters().values():
                fn.launches = 0
            res = eng.benchmark_method(prompts, method=method, max_new_tokens=NEW_TOKENS)
            got = {k: fn.launches for k, fn in counters().items()}
            for k, n in got.items():
                launches[k] = launches.get(k, 0) + n
            ids = eng.last_generation_ids
            new = ids[-NEW_TOKENS:]
            assert len(ids) == PROMPT_TOKENS + NEW_TOKENS, len(ids)
            assert all(0 <= t < eng.model.vocab_size for t in new)
            assert res["total_new_tokens"] == N_PROMPTS * NEW_TOKENS
            assert math.isfinite(res["tokens_per_sec"]) and res["tokens_per_sec"] > 0
            want = _expected_launches(method, mega is None, L, n_gen, family)
            if got != want:
                raise AssertionError(f"{name} {method} megakernel={mega}: launches "
                                     f"{got}, expected {want}")
            tps[(method, mega)] = res["tokens_per_sec"]
            log(f"  {name} {method} megakernel {'on' if mega is None else 'off'}: "
                f"{res['tokens_per_sec']:.1f} tokens/s ({res['total_new_tokens']} new "
                f"tokens in {res['elapsed_sec']:.3f} s, peak {res['gpu_peak_mb']} MB, "
                f"est KV {res['est_kv_cache_mb_avg']:.3f} MB), launches "
                f"{json.dumps({k: v for k, v in got.items() if v})}, last tokens {new[:8]}")
        del eng
        torch.cuda.empty_cache()
    for method in METHODS:
        log(f"  {name} {method}: megakernel on {tps[(method, None)]:.1f} tokens/s, "
            f"off {tps[(method, False)]:.1f} tokens/s "
            f"({tps[(method, None)] / tps[(method, False)]:.1f}x)")
    return {method: tps[(method, None)] for method in METHODS}


def _batch_prompts(n: int, seed: int):
    """n prompts of lowercase words, 24 to 256 tokens (one a byte), the
    first 256 and the second 24: one 256-token bucket."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    sizes = [PROMPT_TOKENS, 24] + [int(t) for t in rng.integers(24, PROMPT_TOKENS + 1, n - 2)]
    out = []
    for size in sizes:
        chars = letters[rng.integers(0, 26, size)]
        chars[rng.random(size) < 0.18] = ord(" ")
        chars[0] = ord("a")
        out.append(chars.tobytes().decode())
    return out


BATCH_PROMPTS, BATCH_KV = 8, (None, "int8", "int4", "mixed")


def _counted(launches: dict, run):
    """Zero every launch counter, call `run`, read the counters, add them to
    `launches`; returns (run's result, the counts of this run)."""
    for fn in counters().values():
        fn.launches = 0
    out = run()
    got = {k: fn.launches for k, fn in counters().items()}
    for k, n in got.items():
        launches[k] = launches.get(k, 0) + n
    return out, got


def _tier_sfx(eng) -> str:
    """The kernels-line suffix of an engine's weight tier: "" (full
    precision), "_w8" or "_w4"."""
    from efficient_llm_inference_tpu_torch.ops import megakernel as mk

    kind = mk.weight_kind(eng._packed())
    return "" if kind == "fp" else "_" + TIER_SUFFIX[kind]


def phase_batch_main_path(launches: dict, name: str, eng, kvs=BATCH_KV) -> dict:
    """generate_batch on 8 prompts of 24-256 tokens (bucket 256) with 64 new
    tokens for each KV kind of `kvs`, on the engine as a user makes it (bf16
    on the card): a first call (build, graph capture), then three timed
    calls. The batched chain (on the engine's weight tier) launches once per
    step, nothing else runs a kernel of the port (the prefill is dense, the
    panes quantize in plain PyTorch). Aggregate tokens/s = 8 x 64 over the
    wall of one call, beside benchmark_method's single-stream tokens/s over
    the same prompts. Returns {kv: aggregate tokens/s}."""
    prompts = _batch_prompts(BATCH_PROMPTS, SEED + 3)
    family = eng.model.name
    assert eng.config.device == "cuda" and eng.config.dtype == torch.bfloat16
    lens = [len(eng.tokenizer.encode(p)) for p in prompts]
    assert max(lens) == PROMPT_TOKENS and min(lens) == 24
    tps = {}
    for kv in kvs:
        batch_name = f"{family}_megabatch" + ("_quant" if kv else "") + _tier_sfx(eng)
        walls = []

        def run():
            for i in range(4):
                t0 = time.perf_counter()
                eng.generate_batch(prompts, NEW_TOKENS, kv_mode=kv)
                if i:
                    walls.append(time.perf_counter() - t0)

        _, got = _counted(launches, run)
        want = {k: 0 for k in counters()}
        want[batch_name] = 4 * NEW_TOKENS
        if got != want:
            raise AssertionError(f"{name} generate_batch kv_mode={kv}: launches {got}, "
                                 f"expected {want}")
        ids = eng.last_batch_ids
        assert [len(r) for r in ids] == [n + NEW_TOKENS for n in lens]
        assert all(0 <= t < eng.model.vocab_size for r in ids for t in r[-NEW_TOKENS:])
        method = f"quant_{kv}" if kv else "full_cache"
        res, _ = _counted(launches, lambda: eng.benchmark_method(
            prompts, method=method, max_new_tokens=NEW_TOKENS))
        wall = sorted(walls)[1]
        tps[kv] = BATCH_PROMPTS * NEW_TOKENS / wall
        log(f"  {name} generate_batch kv_mode={kv}: {tps[kv]:.1f} "
            f"tokens/s aggregate (8 x {NEW_TOKENS} new tokens, wall {wall * 1e3:.2f} ms, "
            f"median of {[round(w * 1e3, 2) for w in walls]}); single-stream "
            f"benchmark_method {method} {res['tokens_per_sec']:.1f} tokens/s over the same "
            f"prompts; launches {json.dumps({k: v for k, v in got.items() if v})}; row 0 "
            f"last tokens {ids[0][-8:]}")
    return tps


def _spec_run(launches, eng, prompts, mode, k, draft=None) -> tuple:
    """A first call (build, graph capture), then one timed call a prompt;
    the launch counters are zeroed just before and read just after. Returns
    (counts, rounds over all calls, wall s of the timed calls, tokens per
    round of the timed calls, host syncs a timed call)."""
    kw = {"draft": draft} if draft is not None else {}
    stats = {"rounds": 0, "wall": 0.0, "tpr": [], "syncs": []}

    def run():
        for i, p in enumerate([prompts[0]] + prompts):
            t0 = time.perf_counter()
            _, n, st = eng.generate_speculative(p, NEW_TOKENS, mode=mode, k=k, stats=True, **kw)
            ids = eng.last_generation_ids
            assert n == NEW_TOKENS and len(ids) == len(eng.tokenizer.encode(p)) + n
            assert all(0 <= t < eng.model.vocab_size for t in ids[-n:])
            stats["rounds"] += st["n_rounds"]
            if i:
                stats["wall"] += time.perf_counter() - t0
                stats["tpr"].append(st["tokens_per_round"])
                stats["syncs"].append(eng.last_spec_host_syncs)

    _, got = _counted(launches, run)
    return got, stats


def phase_spec_main_path(launches: dict, name: str, eng, prompts) -> dict:
    """generate_speculative on the engine as a user makes it (bf16, the
    megakernel on): mode "ngram" at k = 8 and "self_draft" (1 layer) at
    k = 4, over the prompts (64 new tokens). Every round is one launch of
    the verify kernel; the self-draft (vocabulary past the burst's 2048)
    runs k launches of the model's whole-step kernel; nothing else launches
    a kernel of the port (the prefill is dense). Tokens/s beside
    benchmark_method full_cache over the same prompts. Over quantized
    weights the verify and the self-draft's steps run on their weight tier
    (no burst: JAX packs one only for a full-precision draft). Returns
    {mode: tokens/s}."""
    family, sfx = eng.model.name, _tier_sfx(eng)
    res, _ = _counted(launches, lambda: eng.benchmark_method(
        prompts, method="full_cache", max_new_tokens=NEW_TOKENS))
    tps = {}
    for mode, k in (("ngram", SPEC_K), ("self_draft", SPEC_SELF_K)):
        got, st = _spec_run(launches, eng, prompts, mode, k)
        want = {n: 0 for n in counters()}
        want[f"{family}_megaverify{sfx}"] = st["rounds"]
        if mode == "self_draft":
            want[f"{family}_megastep{sfx}"] = k * st["rounds"]
        if got != want:
            raise AssertionError(f"{name} speculative {mode}: launches {got}, expected {want}")
        tps[mode] = len(prompts) * NEW_TOKENS / st["wall"]
        log(f"  {name} generate_speculative {mode} k={k}: "
            f"{tps[mode]:.1f} tokens/s ({len(prompts)} x "
            f"{NEW_TOKENS} new tokens in {st['wall'] * 1e3:.1f} ms), tokens per round "
            f"{[round(t, 3) for t in st['tpr']]}, host syncs a generation {st['syncs']}; "
            f"benchmark_method full_cache {res['tokens_per_sec']:.1f} tokens/s over the "
            f"same prompts; launches {json.dumps({n: v for n, v in got.items() if v})}")
    return tps


def _scale_pairs():
    """The repo's byte-vocab speculation pairs (examples/train_scale_models.py):
    scale_gpt2_big (GPT-2 small's widths at V = 256, P = 256) with draft_gpt2,
    scale_llama_big (E = 1024, I = 2048, L = 8, 16 query heads on 4, V = 256,
    tied) with draft_llama."""
    from efficient_llm_inference_tpu_torch.models import gpt2 as gpt2_mod
    from efficient_llm_inference_tpu_torch.models import llama as llama_mod

    drafts = _draft_cfgs()
    return {
        "gpt2": (gpt2_mod.GPT2Config(vocab_size=256, n_positions=256, n_embd=768,
                                     n_layer=12, n_head=12), drafts["gpt2"]),
        "llama": (llama_mod.LlamaConfig(vocab_size=256, n_positions=256, hidden_size=1024,
                                        intermediate_size=2048, n_layer=8, n_head=16,
                                        n_kv_head=4, rope_theta=10000.0,
                                        tie_embeddings=True), drafts["llama"]),
    }


def _scale_engine(family: str, cfg, dcfg, dtype):
    """(engine, draft) of a byte-vocab pair, random weights from seeds 42 and
    43 drawn on the host, through gpt2_spec / llama_spec."""
    from efficient_llm_inference_tpu_torch import Config, InferenceEngine
    from efficient_llm_inference_tpu_torch.models import gpt2 as gpt2_mod
    from efficient_llm_inference_tpu_torch.models import llama as llama_mod
    from efficient_llm_inference_tpu_torch.models.registry import gpt2_spec

    spec = gpt2_spec if family == "gpt2" else llama_mod.llama_spec
    init = gpt2_mod.init_gpt2_params if family == "gpt2" else llama_mod.init_llama_params
    config = Config(model_name=f"scale_{family}_big", dtype=dtype)
    eng = InferenceEngine(spec(cfg), init(config.generator(), cfg, dtype, "cuda"),
                          config=config)
    draft = (spec(dcfg), init(torch.Generator().manual_seed(43), dcfg, dtype, "cuda"))
    return eng, draft


def _draft_prompts(n: int, seed: int):
    """n prompts of 128 lowercase bytes (bucket 128)."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    out = []
    for _ in range(n):
        chars = letters[rng.integers(0, 26, 128)]
        chars[rng.random(128) < 0.18] = ord(" ")
        out.append(chars.tobytes().decode())
    return out


def phase_spec_draft_main_path(launches: dict) -> None:
    """generate_speculative mode "draft" at k = 4 on the byte-vocab pairs in
    bf16, over 2 prompts of 128 tokens: every round is one launch of the
    draft burst and one of the verify kernel, nothing else; tokens/s beside
    benchmark_method full_cache over the same prompts."""
    prompts = _draft_prompts(N_PROMPTS, SEED + 6)
    for family, (cfg, dcfg) in _scale_pairs().items():
        eng, draft = _scale_engine(family, cfg, dcfg, torch.bfloat16)
        res, _ = _counted(launches, lambda: eng.benchmark_method(
            prompts, method="full_cache", max_new_tokens=NEW_TOKENS))
        got, st = _spec_run(launches, eng, prompts, "draft", DRAFT_K, draft=draft)
        want = {n: 0 for n in counters()}
        want[f"{family}_megaverify"] = want[f"{family}_draft_burst"] = st["rounds"]
        if got != want:
            raise AssertionError(f"scale_{family}_big draft: launches {got}, expected {want}")
        log(f"  scale_{family}_big + draft_{family} generate_speculative draft k={DRAFT_K}: "
            f"{len(prompts) * NEW_TOKENS / st['wall']:.1f} tokens/s ({len(prompts)} x "
            f"{NEW_TOKENS} new tokens in {st['wall'] * 1e3:.1f} ms), tokens per round "
            f"{[round(t, 3) for t in st['tpr']]}, host syncs a generation {st['syncs']}; "
            f"benchmark_method full_cache {res['tokens_per_sec']:.1f} tokens/s over the "
            f"same prompts; launches {json.dumps({n: v for n, v in got.items() if v})}")
        del eng, draft
        torch.cuda.empty_cache()


SERVER_WORDS = ["weather", "mountain", "river", "engine", "tensor", "kernel", "stream",
                "window", "matrix", "garden"]


def _server_prompts(tokenizer, n: int) -> list:
    """The server protocol's prompts (scripts/measure_megaserver.py:101-129):
    "Question i: " and 6-10 words of its list, default_rng(0), byte
    tokens."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        words = max(3, 8 + int(rng.integers(-2, 3)))
        out.append(tokenizer.encode(f"Question {i}: " + " ".join(rng.choice(SERVER_WORDS,
                                                                             words))))
    return out


def _server(eng, n_slots, kv, spec, capacity=SERVER_C, dtype=None):
    """A MegaBatchServer over the engine's model and weights (its pools on
    the card in `dtype`, by default the engine's), chunks of 32 steps, k =
    SPEC_K."""
    from efficient_llm_inference_tpu_torch import MegaBatchServer, MegaPoolConfig

    return MegaBatchServer(eng.model, eng.params,
                           pool=MegaPoolConfig(n_slots=n_slots, capacity=capacity,
                                               max_chunk=32),
                           kv_mode=kv, spec=spec, spec_k=SPEC_K,
                           dtype=dtype or eng.config.dtype)


def _serve(srv, prompts):
    """One run of the server over one request a prompt of NEW_TOKENS;
    returns (requests, wall s, steps or rounds dispatched)."""
    from efficient_llm_inference_tpu_torch import Request

    reqs = [Request(rid=i, prompt_ids=list(p), max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    steps = [0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv.run(reqs, progress=lambda n, _: steps.append(n))
    torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0, steps[-1]


def phase_server_main_path(launches: dict, name: str, eng, n_slots: int,
                           n_requests: int) -> dict:
    """MegaBatchServer.run on the engine's model and weights as a user makes
    them (bf16 on the card): the server protocol (n_requests requests of
    "Question i: " + 6-10 words, NEW_TOKENS new tokens each, n_slots slots
    of C = SERVER_C, chunks of 32 steps), plain and spec="ngram" (k = 8),
    pools in bf16 and int8. A first run builds the chunks' CUDA graphs (and
    warms the acceptance estimate, which a server keeps across runs); the
    launch counters are zeroed just before and read just after a second run
    of the same server over fresh requests: plain, the batched chain launches once a step
    dispatched; spec, the batched verify once a round dispatched; no other
    kernel of the port runs (the prefill is dense); over quantized weights
    each on its weight tier. Aggregate tokens/s = requests x NEW_TOKENS over
    the second run's wall; returns {(spec, kv): tokens/s}."""
    family, sfx = eng.model.name, _tier_sfx(eng)
    assert eng.config.device == "cuda" and eng.config.dtype == torch.bfloat16
    prompts = _server_prompts(eng.tokenizer, n_requests)
    tps = {}
    for spec in (None, "ngram"):
        for kv in (None, "int8"):
            srv = _server(eng, n_slots, kv, spec)
            _serve(srv, prompts)  # builds and captures
            (reqs, wall, steps), got = _counted(launches, lambda: _serve(srv, prompts))
            kernel = f"{family}_mega{'batch_verify' if spec else 'batch'}"
            want = {k: 0 for k in counters()}
            want[kernel + ("_quant" if kv else "") + sfx] = steps
            if got != want or steps == 0:
                raise AssertionError(f"{name} server spec={spec} kv_mode={kv}: launches "
                                     f"{got}, expected {want}")
            assert all(r.done and len(r.out_ids) == NEW_TOKENS for r in reqs)
            assert all(0 <= t < eng.model.vocab_size for r in reqs for t in r.out_ids)
            tps[(spec, kv)] = n_requests * NEW_TOKENS / wall
            stats = srv.spec_stats
            extra = (f", {stats['tokens'] / max(stats['rounds'], 1):.3f} tokens a round "
                     f"({stats['tokens']} in {stats['rounds']} slot-rounds), final R "
                     f"{srv._spec_R}" if spec else "")
            log(f"  {name} MegaBatchServer spec={spec} kv_mode={kv} {n_slots} slots C="
                f"{SERVER_C}: {tps[(spec, kv)]:.1f} tokens/s aggregate ({n_requests} x "
                f"{NEW_TOKENS} new tokens, wall {wall * 1e3:.2f} ms, {steps} "
                f"{'rounds' if spec else 'steps'} dispatched){extra}; launches "
                f"{json.dumps({k: v for k, v in got.items() if v})}; request 0 first "
                f"tokens {reqs[0].out_ids[:8]}")
    for kv in (None, "int8"):
        log(f"  {name} MegaBatchServer kv_mode={kv}: spec {tps[('ngram', kv)]:.1f} "
            f"against plain {tps[(None, kv)]:.1f} tokens/s "
            f"({tps[('ngram', kv)] / tps[(None, kv)]:.2f}x)")
    return tps


def _hold_name(eng) -> str:
    """An engine's name in the fp32 holds' lines: the model and its weights."""
    wq = eng.config.weight_quant
    return eng.model.name + (f" weight_quant={wq}" if wq else "")


def phase_server_fp32_hold(eng, n_slots: int = 16, n_requests: int = 32) -> None:
    """An engine in fp32 on the card (GPT-2 small: 16 slots of C = 256, 32
    requests; every request fits the pane): each request of the plain and
    the spec="ngram" server equals the single-stream megakernel greedy ids
    of its prompt (generate_ids full_cache) up to the first step whose
    top-2 logit gap (megakernel-off logits, teacher-forced) is under
    1e-4."""
    assert eng.config.dtype == torch.float32
    prompts = _server_prompts(eng.tokenizer, n_requests)
    text = [eng.tokenizer.decode(p) for p in prompts]
    for spec in (None, "ngram"):
        reqs, _, _ = _serve(_server(eng, n_slots, None, spec, capacity=256), prompts)
        equal, cut = 0, []
        for p, req in zip(text, reqs):
            want = eng.generate_ids(p, "full_cache", NEW_TOKENS)
            assert want[:len(req.prompt_ids)] == req.prompt_ids
            row = req.prompt_ids + req.out_ids
            if row == want:
                equal += 1
                continue
            _, logits = eng.generate_logits(p, "full_cache", NEW_TOKENS,
                                            forced=want[-NEW_TOKENS:])
            top2 = logits.topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) >= 1e-4
            first = int((~clear).nonzero()[0]) if not bool(clear.all()) else NEW_TOKENS
            n = len(req.prompt_ids) + first
            if row[:n] != want[:n]:
                raise AssertionError(f"fp32 server spec={spec}: request {req.rid} differs "
                                     f"from generate_ids before its first unclear step "
                                     f"{first}")
            cut.append(first)
        log(f"  fp32 MegaBatchServer {_hold_name(eng)} spec={spec}: {equal} of {len(reqs)} "
            f"requests "
            f"equal the single-stream megakernel tokens; the rest equal up to a step with "
            f"a top-2 gap under 1e-4 (at {cut})")


def _server_plain_logits(srv, prompt, out) -> torch.Tensor:
    """The plain single-stream logits (fp32, [len(out), V]) of one request
    of `srv` (pools in its dtype over its weights), teacher-forced on its
    tokens `out`: row 0 the prefill's (its cache written in the pools'
    dtype), row j the plain step over the server's packed weights fed
    out[j - 1], embedded as the server embeds it."""
    from efficient_llm_inference_tpu_torch.cache.kvcache import DenseKV
    from efficient_llm_inference_tpu_torch.ops import megakernel as mk
    from efficient_llm_inference_tpu_torch.ops import megakernel_batch as mkb

    model, params, C = srv.model, srv.params, srv.pool_cfg.capacity
    strategy = DenseKV(n_layer=model.n_layer, n_head=model.n_kv_head, head_dim=model.head_dim,
                       capacity=C, batch=1, dtype=srv.k_pool.dtype, device="cuda")
    toks = torch.tensor([prompt], dtype=torch.long, device="cuda")
    pos = torch.arange(len(prompt), device="cuda")[None]
    logits, cache = model.forward(params, toks, pos, strategy.init(), strategy, None)
    rows = [logits[0, -1].float()]
    k = mkb.to_mega_layout_batch(cache["k"])[:, 0].contiguous()
    v = mkb.to_mega_layout_batch(cache["v"])[:, 0].contiguous()
    wte, wpe = srv.packed["wte"], srv.packed["wpe"]
    for j in range(len(out) - 1):
        cur = len(prompt) + j
        x = wte[out[j]].float() + wpe[min(cur, model.n_positions - 1)].float()
        rows.append(mk.gpt2_megastep_plain(srv.packed, k, v, cur, x[None].to(wte.dtype),
                                           cfg=model.config, return_logits=True)[3].float())
    return torch.stack(rows)


def phase_server_pool_dtype(eng, n_slots: int = 16, n_requests: int = 32) -> None:
    """The server's pools in the JAX server's default dtype, bf16, over an
    fp32 engine's weights (GPT-2 small, 16 slots of C = 256, 32 requests),
    plain and spec="ngram": the decode kernels take the weights cast once to
    bf16 (the batched step once a step dispatched, the batched verify once
    a round; no other kernel of the port runs), every request gets its
    NEW_TOKENS tokens in the vocabulary. A request equal to the fp32 pools'
    tokens is held by phase_server_fp32_hold; one that parts from them is
    held, from its first parting to its end, to the plain bf16 logits
    teacher-forced on its own tokens (_server_plain_logits): each token
    within 2e-2 of their maximum, the bf16 limit of `_token_ok`
    (tests/test_torch_megaserver_dtype.py holds the port against the JAX
    server at this default)."""
    assert eng.config.dtype == torch.float32
    prompts = _server_prompts(eng.tokenizer, n_requests)
    for spec in (None, "ngram"):
        want, _, _ = _serve(_server(eng, n_slots, None, spec, capacity=256), prompts)
        srv = _server(eng, n_slots, None, spec, capacity=256, dtype=torch.bfloat16)
        assert srv.k_pool.dtype == srv.packed["attn_w"].dtype == torch.bfloat16
        (reqs, wall, steps), got = _counted({}, lambda: _serve(srv, prompts))
        kernel = f"{eng.model.name}_mega{'batch_verify' if spec else 'batch'}"
        expect = {k: 0 for k in counters()}
        expect[kernel] = steps
        if got != expect or steps == 0:
            raise AssertionError(f"bf16 pools over fp32 weights spec={spec}: launches {got}, "
                                 f"expected {expect}")
        assert all(r.done and len(r.out_ids) == NEW_TOKENS for r in reqs)
        assert all(0 <= t < eng.model.vocab_size for r in reqs for t in r.out_ids)
        same = [next((i for i, (a, b) in enumerate(zip(r.out_ids, w.out_ids)) if a != b),
                     NEW_TOKENS) for r, w in zip(reqs, want)]
        short = 0.0  # the largest shortfall of a held token under the plain maximum
        for r, first in zip(reqs, same):
            if first == NEW_TOKENS:
                continue
            logits = _server_plain_logits(srv, r.prompt_ids, r.out_ids)
            for i in range(first, NEW_TOKENS):
                if not _token_ok(r.out_ids[i], logits[i], torch.bfloat16):
                    raise AssertionError(f"bf16 pools over fp32 weights spec={spec}: request "
                                         f"{r.rid} token {i} ({r.out_ids[i]}) more than 2e-2 "
                                         f"under the plain bf16 maximum")
                short = max(short, float(logits[i].max() - logits[i][r.out_ids[i]]))
        log(f"  MegaBatchServer {_hold_name(eng)} bf16 pools over fp32 weights spec={spec}: "
            f"{n_requests} x {NEW_TOKENS} tokens in {wall * 1e3:.2f} ms ({steps} "
            f"{'rounds' if spec else 'steps'}, {kernel} launched {steps} times); "
            f"{sum(n == NEW_TOKENS for n in same)} of {n_requests} requests equal the fp32 "
            f"pools' tokens, common prefix mean {sum(same) / len(same):.1f} tokens; the "
            f"others' tokens from the parting on within {short:.4f} of the plain bf16 "
            f"maximum (limit 2e-2)")


def _hold_spec(eng, name: str, runs) -> None:
    """fp32: each speculative generation's ids equal the megakernel greedy
    ids (generate_ids full_cache) up to the first step whose top-2 logit gap
    (megakernel-off logits, teacher-forced) is under 1e-4. `runs`: (prompt,
    mode, k, draft) tuples."""
    assert eng.config.dtype == torch.float32
    for prompt, mode, k, draft in runs:
        want = eng.generate_ids(prompt, "full_cache", NEW_TOKENS)
        _, logits = eng.generate_logits(prompt, "full_cache", NEW_TOKENS,
                                        forced=want[-NEW_TOKENS:])
        top2 = logits.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) >= 1e-4
        first = int((~clear).nonzero()[0]) if not bool(clear.all()) else NEW_TOKENS
        kw = {"draft": draft} if draft is not None else {}
        _, _, st = eng.generate_speculative(prompt, NEW_TOKENS, mode=mode, k=k, stats=True,
                                            **kw)
        got = eng.last_generation_ids
        n = len(want) - NEW_TOKENS + first
        if got[:n] != want[:n]:
            raise AssertionError(f"fp32 speculative {name} {mode}: ids differ from the "
                                 f"megakernel greedy ids before step {first}")
        log(f"  fp32 speculative {name} {mode} k={k}: ids equal the megakernel greedy ids "
            f"over {first} of {NEW_TOKENS} steps (the first unclear step: {first}; "
            f"{'all equal' if got == want else 'differ after it'}), "
            f"{st['n_rounds']} rounds")


def phase_spec_fp32_hold(eng) -> None:
    prompt = _prompts(1, SEED + 5)[0]
    _hold_spec(eng, _hold_name(eng), [(prompt, "ngram", SPEC_K, None),
                                      (prompt, "self_draft", SPEC_SELF_K, None)])


def phase_batch_fp32_hold(eng, kvs=BATCH_KV) -> None:
    """An engine in fp32 on the card (GPT-2 small; over quantized weights
    too): each row of generate_batch equals the single-stream megakernel
    generate_ids of its prompt, up to the first step whose top-2 logit gap
    (megakernel-off logits, teacher-forced) is under 1e-4."""
    assert eng.config.dtype == torch.float32
    prompts = _batch_prompts(BATCH_PROMPTS, SEED + 4)
    for kv in kvs:
        method = f"quant_{kv}" if kv else "full_cache"
        eng.generate_batch(prompts, NEW_TOKENS, kv_mode=kv)
        equal, cut = 0, []
        for p, row in zip(prompts, eng.last_batch_ids):
            want = eng.generate_ids(p, method, NEW_TOKENS)
            if row == want:
                equal += 1
                continue
            _, logits = eng.generate_logits(p, method, NEW_TOKENS, forced=want[-NEW_TOKENS:])
            top2 = logits.topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) >= 1e-4
            first = int((~clear).nonzero()[0]) if not bool(clear.all()) else NEW_TOKENS
            n = len(row) - NEW_TOKENS + first
            if row[:n] != want[:n]:
                raise AssertionError(f"fp32 generate_batch {method}: a row differs from "
                                     f"generate_ids before its first unclear step {first}")
            cut.append(first)
        log(f"  fp32 generate_batch {_hold_name(eng)} {method}: {equal} of {BATCH_PROMPTS} "
            f"rows equal "
            f"the single-stream megakernel tokens; the rest equal up to a step with a "
            f"top-2 gap under 1e-4 (at {cut})")


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


def phase_fp32_mega_hold(eng, methods=METHODS) -> None:
    """64 teacher-forced steps of the model's megakernels beside their plain
    steps on the card in fp32 (`eng`: an fp32 engine, full-precision or
    quantized weights), from the same prefill: both get the kernel's
    token."""
    from efficient_llm_inference_tpu_torch.engine.generate import (
        _embed, _mega_panes, bucket_for, make_prefill)

    assert eng.config.dtype == torch.float32
    family = eng.model.name
    ids = eng.tokenizer.encode(_prompts(1, SEED + 2)[0])
    bucket = bucket_for(len(ids))
    buf = torch.zeros((1, bucket), dtype=torch.long)
    buf[0, :len(ids)] = torch.tensor(ids)
    buf = buf.cuda()
    wq = eng.config.weight_quant or "full-precision"
    for method in methods:
        _, strategy = eng._build(method, bucket, NEW_TOKENS, {})
        kv_mode = None if method == "full_cache" else method.replace("quant_", "")
        mode = kv_mode or "fp"
        mega = eng._mega_spec if kv_mode is None else eng._mega_quant_spec
        assert (mega(bucket + NEW_TOKENS, None) if kv_mode is None else
                mega(bucket + NEW_TOKENS, None, kv_mode, {})) is not None
        cache, last = make_prefill(eng.model, strategy)(eng.params, buf, len(ids))
        kern = list(_mega_panes(cache, kv_mode).values())
        plain = [t.clone() for t in kern]
        tok, length, clear, gaps = int(last[0].argmax()), len(ids), 0, []
        for _ in range(NEW_TOKENS):
            x = _embed(eng.model, eng.params, torch.tensor(tok, device="cuda"), length)
            got = int(_mega_step(mode, eng._mega_packed, eng.model.config, kern,
                                 length, x, family=family)[0])
            logits = _mega_step(mode, eng._mega_packed, eng.model.config, plain,
                                length, x, plain=True, family=family)[-1]
            top2 = logits.topk(2).values
            gap = float(top2[0] - top2[1])
            gaps.append(gap)
            if gap >= 1e-4:
                clear += 1
                if got != int(logits.argmax()):
                    raise AssertionError(f"fp32 megakernel {family} {wq} {method}: token "
                                         f"{got}, plain {int(logits.argmax())} "
                                         f"(gap {gap})")
            assert torch.isfinite(logits).all()
            tok, length = got, length + 1
        log(f"  fp32 megakernel {family} {wq} {method}: kernel token == plain argmax at "
            f"{clear} of {NEW_TOKENS} teacher-forced steps (the rest have a top-2 gap "
            f"under 1e-4; smallest gap {min(gaps):.2e})")


# ---------------------------------------------------------------------------
# Weight tiers (Config.weight_quant): #9, #11, #12 and #13 at R = 1 streaming
# int8 or grouped-int4 weights.

WEIGHT_QUANTS = ("int8", "int4", "int4w8")
TIER_SUFFIX = {"int8": "w8", "int4": "w4"}
TIER_HOLD_METHODS = ("full_cache", "quant_int8")  # a tier of each step kernel


def _quantized_params(spec, params: dict, wq: str) -> dict:
    """`params` quantized as from_model_name quantizes them for `wq`, at the
    mode and group of the engine's `weight_quant_plan` (a padded FFN comes
    from the caller: the plan must keep `spec`)."""
    from efficient_llm_inference_tpu_torch.engine.engine import (
        quantize_weights,
        weight_quant_plan,
    )

    qspec, mode, group = weight_quant_plan(spec, wq)
    assert qspec is spec, "pad the FFN to the int4w8 geometry first"
    return quantize_weights(spec, params, mode, group)


# the packed keys a step streams: weights (codes or values) and their scales
_STREAMED = {"gpt2": ("attn_w", "proj_w", "fc_w", "fcp_w", "head"),
             "llama": ("qkv_w", "o_w", "gu_w", "down_w", "head")}


def _packed_weight_bytes(family: str, packed: dict) -> int:
    """Bytes of the weights one step streams: every code row and scale of a
    quantized pack (the LM head's copy included), or the full-precision
    weights and the LM head (GPT-2: wte)."""
    from efficient_llm_inference_tpu_torch.ops import megakernel as mk

    names = list(_STREAMED[family])
    if family == "gpt2" and "head" not in packed:
        names[-1] = "wte"
    names += [mk.scale_key(n) for n in names if mk.scale_key(n) in packed]
    return sum(packed[n].numel() * packed[n].element_size() for n in names)


def _tier_bound(family: str, cfg, packed: dict, mode: str, dtype, rows: int) -> tuple:
    """Least time of one step over a weight-tier pack: its streamed codes and
    scales (from the pack itself), the layer norms, biases and one
    embedding row, the `rows` visible KV rows and their scales and the new
    rows; two operations per weight plus the attention's four per cached
    value and query head (as `_mega_bound` / `_llama_bound`)."""
    item = 2 if dtype == torch.bfloat16 else 4
    names = _STREAMED[family]
    n_weights = sum(packed[n].numel() * (2 if packed[n].dtype == torch.uint8 else 1)
                    for n in names)
    if family == "gpt2":
        E, L = cfg.n_embd, cfg.n_layer
        smalls, emb, W, QW = (L * 13 * E + 2 * E) * 4, 2 * E * item, E, E
    else:
        E, L, D = cfg.hidden_size, cfg.n_layer, cfg.head_dim
        W, QW = cfg.n_kv_head * D, cfg.n_head * D
        smalls = (L * 2 * E + E + 2 * D + (L * (QW + 2 * W) if cfg.qkv_bias else 0)) * 4
        emb = E * item
    n_bytes = (_packed_weight_bytes(family, packed) + smalls + emb
               + _kv_bytes(mode, item, L, W, rows + 1))
    flops = 2 * n_weights + L * 4 * (rows + 1) * QW
    rate = H100_BF16_FLOP_PER_S if dtype == torch.bfloat16 else H100_FP32_FLOP_PER_S
    return bound_ms(n_bytes, flops, rate)


def _tier_case(family, cfg, packed, mode, dtype, length, seed, deep_bf16, timed):
    """One tier step at `length` of C = 320 against its plain step (phase
    2's tolerances); with `timed`, its device ms (graph replay), the plain
    step's, and the bound. Returns (token, plain argmax, row error, times)."""
    L = cfg.n_layer
    E = cfg.n_embd if family == "gpt2" else cfg.hidden_size
    W = E if family == "gpt2" else cfg.n_kv_head * cfg.head_dim
    state, x = _mega_state(mode, dtype, seed, L, W, E)
    dev_len = torch.tensor([length], dtype=torch.int32, device="cuda")
    got = [t.clone() for t in state]
    want = [t.clone() for t in state]

    def kernel():
        return _mega_step(mode, packed, cfg, got, dev_len, x, family=family)

    def plain():
        return _mega_step(mode, packed, cfg, want, length, x, plain=True, family=family)

    tok = int(kernel()[0])
    logits = plain()[-1]
    torch.cuda.synchronize()
    if not _token_ok(tok, logits, dtype, deep_bf16=deep_bf16):
        raise AssertionError(f"tier step {family} {mode} {dtype} len={length}: token "
                             f"{tok}, plain argmax {int(logits.argmax())}")
    err = _new_row_err(mode, dtype, got, want, state, row=length, deep_bf16=deep_bf16)
    times = None
    if timed:
        b, by = _tier_bound(family, cfg, packed, mode, dtype, length)
        times = {"ms": device_ms(kernel, calls=10),
                 "plain_ms": device_ms(plain, calls=2, replays=2),
                 "bound_ms": b, "bound_by": by, "library_ms": None}
    return tok, int(logits.argmax()), err, times


def check_weight_tiers(gpt2_cfg, llama_params_bf16: dict) -> dict:
    """#9 / #11 (GPT-2 small) and #13 / #12 (Llama-3.2-1B) over int8, int4
    (G = 128) and int4w8 weights quantized from the main path's seed-42
    params, fp / int8 / int4 / mixed panes, bf16 and fp32 (the bf16 weights
    widened, then quantized), lengths 0 and 319 of C = 320, each against its
    plain step (Llama: the deep-bf16 allowance) and timed at 319; then a
    Qwen2.5-0.5B-width model cut to 2 layers at int4w8 (group 448, FFN
    padded 4864 -> 5376), fp and int8 panes, untimed. The kernels line
    takes the bf16 times at 319 (fp panes for #9 / #13, int8 panes for
    #11 / #12; int8 weights for _w8, int4 for _w4) and the worst error."""

    from efficient_llm_inference_tpu_torch.engine.engine import weight_quant_plan
    from efficient_llm_inference_tpu_torch.models import gpt2 as gpt2_mod
    from efficient_llm_inference_tpu_torch.models import llama as llama_mod
    from efficient_llm_inference_tpu_torch.models.registry import (
        gpt2_spec,
        spec_by_name,
        spec_with_config,
    )
    from efficient_llm_inference_tpu_torch.ops import megakernel as mk
    from efficient_llm_inference_tpu_torch.ops import megakernel_llama as ml

    timing, errs = {}, {}
    cases = [(gpt2_spec(gpt2_cfg), "GPT-2 small", lambda dtype: gpt2_mod.init_gpt2_params(
                  torch.Generator().manual_seed(42), gpt2_cfg, dtype, "cuda")),
             (spec_by_name("llama-3-1b"), "Llama-3.2-1B",
              lambda dtype: _cast_params(llama_params_bf16, dtype))]
    for spec, label, params_for in cases:
        family, cfg = spec.name, spec.config
        pack = mk.pack_gpt2_mega if family == "gpt2" else ml.pack_llama_mega
        for dtype in (torch.float32, torch.bfloat16):
            base = params_for(dtype)
            for wq in WEIGHT_QUANTS:
                packed = pack(_quantized_params(spec, base, wq), cfg)
                assert packed is not None and mk.weight_kind(packed) == wq[:4]
                group = mk.weight_group(packed, "head")
                for i, mode in enumerate(MODES):
                    for length in (0, MEGA_LEN):
                        tok, want, err, t = _tier_case(
                            family, cfg, packed, mode, dtype, length, 300 + i + length,
                            deep_bf16=family == "llama", timed=length == MEGA_LEN)
                        key = (family, wq, mode, dtype)
                        errs[key] = max(err, errs.get(key, 0.0))
                        line = (f"  tier step {label} {wq} (G={group}) {mode} panes "
                                f"{str(dtype)[6:]} C=320 len={length}: token {tok} "
                                f"(plain {want}), new rows max|kernel-plain| {err:.2e}")
                        if t is not None:
                            timing[key] = t
                            line += (f"; device ms kernel {t['ms']:.5f}, plain "
                                     f"{t['plain_ms']:.5f}, bound {t['bound_ms']:.5f} "
                                     f"({t['bound_by']}), streamed weight bytes "
                                     f"{_packed_weight_bytes(family, packed)}")
                        log(line)
                del packed
            del base
            torch.cuda.empty_cache()
    qspec, _, group = weight_quant_plan(spec_by_name("qwen2.5-0.5b"), "int4w8")
    qspec = spec_with_config(qspec, dataclasses.replace(qspec.config, n_layer=2))
    qwen = qspec.config
    assert (group, qwen.intermediate_size) == (448, 5376)
    qparams = llama_mod.init_llama_params(torch.Generator().manual_seed(7), qwen,
                                          torch.float32, "cuda")
    for dtype in (torch.float32, torch.bfloat16):
        packed = ml.pack_llama_mega(_quantized_params(
            qspec, _cast_params(qparams, dtype), "int4w8"), qwen)
        assert packed is not None and mk.weight_group(packed, "head") == 448
        for i, mode in enumerate(("fp", "int8")):
            for length in (0, MEGA_LEN):
                tok, want, err, _ = _tier_case("llama", qwen, packed, mode, dtype, length,
                                               400 + i + length, deep_bf16=False,
                                               timed=False)
                key = ("llama", "int4w8", mode, dtype)
                errs[key] = max(err, errs.get(key, 0.0))
                log(f"  tier step Qwen2.5-0.5B width L=2 int4w8 (G=448, I=5376) {mode} "
                    f"panes {str(dtype)[6:]} C=320 len={length}: token {tok} (plain "
                    f"{want}), new rows max|kernel-plain| {err:.2e}")
    reports = {}
    for family in ("gpt2", "llama"):
        for wq in ("int8", "int4"):
            for quant, mode in ((False, "fp"), (True, "int8")):
                name = f"{family}_megastep{'_quant' if quant else ''}_{TIER_SUFFIX[wq]}"
                worst = max(e for (f, w, m, _), e in errs.items()
                            if f == family and w[:4] == wq and (m == "fp") != quant)
                reports[name] = dict(timing[(family, wq, mode, torch.bfloat16)],
                                     max_abs_err=worst)
    return reports


# ---------------------------------------------------------------------------
# Weight tiers of the verify and batched chains: #10, #13 at R > 1 and
# #14-#21 streaming int8 or grouped-int4 weights through the batched GEMV.

BATCH_TIER_WQ = {"gpt2": ("int8", "int4"), "llama": ("int8", "int4", "int4w8")}
# the weight tier each family's weight-quant serving main path runs on (the
# kernels line lists the verify and batched chains at these tiers; the
# kernel phase also checks and times the others)
SERVED_TIER = {"gpt2": "w4", "llama": "w8"}
# the chains whose wrappers count a weight tier's launches apart
TIERED = ("gpt2_megastep", "gpt2_megastep_quant", "llama_megastep", "llama_megastep_quant",
          "gpt2_megaverify", "llama_megaverify", "gpt2_megabatch", "llama_megabatch",
          "gpt2_megabatch_quant", "llama_megabatch_quant", "gpt2_megabatch_verify",
          "gpt2_megabatch_verify_quant", "llama_megabatch_verify",
          "llama_megabatch_verify_quant")


def _first_layers(params: dict, n: int) -> dict:
    """A model's params cut to its first n layers (every block leaf, codes
    and scales too, sliced; the embeddings shared)."""
    def first(t):
        return {k: first(v) for k, v in t.items()} if isinstance(t, dict) else t[:n]

    return dict(params, blocks=first(params["blocks"]))


def check_batch_weight_tiers(gpt2_cfg, llama_params_bf16: dict) -> dict:
    """The verify and batched chains over quantized weights against their
    plain versions: GPT-2 small (12 layers) at int8 and int4 (G = 128), and
    Llama-3.2-1B's widths cut to 2 layers at int8, int4 and int4w8 (G =
    1024), the main path's seed-42 weights quantized as from_model_name
    quantizes them, bf16 and fp32, each with its full-precision phase's
    checks and limits:
    - #10 / #13 at R = 8 rows, cur 0 and C - 16 of C = SPEC_C (fp panes);
    - #14-#17 at B = 8 (BATCH_LENGTHS of C = 320: lengths 0 .. C - 1), fp
      and int8 panes, #16 at B = 16, and #15 / #17 at B = 16 and 32;
    - #18-#21 at 8 x 8 rows, VERIFY_LENGTHS of C = SERVER_C (up to C - 16),
      fp and int8 panes; GPT-2's #18 also at 16 x 8 in bf16;
    int4w8 (which differs from int4 by its group) at #13 and #15 / #17 only.
    The kernels line takes each tier's bf16 times (int8: _w8; int4 at G =
    128: _w4; at 8 rows or slots, int8 panes for the quantized-pane
    kernels) beside its bound (the pack's codes and scales) and the worst
    error over the tier's cases (int4w8 in _w4)."""

    from efficient_llm_inference_tpu_torch.models import gpt2 as gpt2_mod
    from efficient_llm_inference_tpu_torch.models.registry import (
        gpt2_spec,
        spec_by_name,
        spec_with_config,
    )

    llama_spec = spec_by_name("llama-3-1b")
    llama_spec = spec_with_config(llama_spec, dataclasses.replace(llama_spec.config,
                                                                  n_layer=2))
    cases = [("gpt2", gpt2_spec(gpt2_cfg), lambda dtype: gpt2_mod.init_gpt2_params(
                 torch.Generator().manual_seed(42), gpt2_cfg, dtype, "cuda")),
             ("llama", llama_spec, lambda dtype: _cast_params(
                 _first_layers(llama_params_bf16, 2), dtype))]
    reports = {}
    for family, spec, base_for in cases:
        cfg = spec.config
        for wq in BATCH_TIER_WQ[family]:
            sfx = "_" + TIER_SUFFIX[wq[:4]]
            quantized = {}  # dtype -> the quantized params, made once for the three checks

            def q_for(dtype, spec=spec, base_for=base_for, wq=wq, quantized=quantized):
                if dtype not in quantized:
                    quantized[dtype] = _quantized_params(spec, base_for(dtype), wq)
                return quantized[dtype]

            # the plain versions are timed for the kernels line's tiers only
            # (an eager plain pass of 64-128 steps takes seconds)
            timed = sfx[1:] == SERVED_TIER[family] and wq != "int4w8"
            # int4w8 differs from int4 by its group only: its verify and B = 8 steps
            full = wq != "int4w8"
            got = check_megaverify(family, cfg, q_for, rows=(8,), curs=(0, SPEC_C - 16),
                                   suffix=sfx, time_plain=timed)
            # the bf16 Llama chain takes every B in one launch a GEMV: each tier at 8-32
            wide = ({"fp": (16, 32), "quant": (16, 32)} if family == "llama"
                    else {"fp": (), "quant": (16,) if full else ()})
            got.update(check_megabatches(family, cfg, q_for, modes=("fp", "int8"), wide=wide,
                                         suffix=sfx, time_plain=timed))
            if full:
                got.update(_mega_reports(
                    _verify_batch_cases(family, cfg, q_for, 8, modes=("fp", "int8"), rows=(8,),
                                        suffix=sfx, time_plain=timed,
                                        gemv_key="gu_w" if family == "llama" else None),
                    f"{family}_megabatch_verify{sfx}", f"{family}_megabatch_verify_quant{sfx}"))
            if family == "gpt2":  # 16 x 8 rows, bf16 fp panes: its error counts, its time logged
                name = f"{family}_megabatch_verify{sfx}"
                wide = _verify_batch_cases(family, cfg, q_for, 16, modes=("fp",),
                                           dtypes=(torch.bfloat16,), rows=(8,), suffix=sfx,
                                           time_plain=False, gemv_key="fc_w")
                got[name]["max_abs_err"] = max(got[name]["max_abs_err"],
                                               wide[("fp", torch.bfloat16)]["max_abs_err"])
            for name, r in got.items():
                if name in reports:  # int4w8: its errors into _w4, int4's times kept
                    reports[name]["max_abs_err"] = max(reports[name]["max_abs_err"],
                                                       r["max_abs_err"])
                else:
                    reports[name] = r
            quantized.clear()
            torch.cuda.empty_cache()
    return reports


def _expected_tier_launches(method: str, L: int, n_gen: int, family: str, wq: str) -> dict:
    """The megakernel-on main path's launches over `wq` weights: those of
    full-precision weights with each chain launch on its weight tier."""
    want = _expected_launches(method, True, L, n_gen, family)
    step = f"{family}_megastep" + ("" if method == "full_cache" else "_quant")
    want[f"{step}_{TIER_SUFFIX[wq[:4]]}"] = want.pop(step)
    want[step] = 0
    return want


def phase_weight_quant_main_path(launches: dict, name: str, engines, bf16_tps: dict) -> None:
    """benchmark_method for the four methods on from_model_name(name,
    Config(weight_quant=wq)) for wq in int8, int4, int4w8 (bf16, the
    megakernel on: each decode step one launch of the chain's weight tier,
    no full-precision launch), the counters zeroed just before and read
    just after each run; tokens/s beside the bf16-weight run's (phase 5) and
    the streamed weight bytes of a step. `engines(wq)` makes the engine."""
    from efficient_llm_inference_tpu_torch.ops import megakernel as mk

    prompts = _prompts(N_PROMPTS, SEED)
    n_gen = N_PROMPTS + 1
    for wq in WEIGHT_QUANTS:
        eng = engines(wq)
        family = eng.model.name
        assert eng.config.weight_quant == wq and eng.config.resolved_megakernel()
        assert eng.config.device == "cuda" and eng.config.dtype == torch.bfloat16
        assert mk.weight_quantized(eng.params)
        for method in METHODS:
            res, got = _counted(launches, lambda: eng.benchmark_method(
                prompts, method=method, max_new_tokens=NEW_TOKENS))
            want = _expected_tier_launches(method, eng.model.n_layer, n_gen, family, wq)
            if got != want:
                raise AssertionError(f"{name} weight_quant={wq} {method}: launches {got}, "
                                     f"expected {want}")
            ids = eng.last_generation_ids
            assert len(ids) == PROMPT_TOKENS + NEW_TOKENS
            assert all(0 <= t < eng.model.vocab_size for t in ids[-NEW_TOKENS:])
            assert res["total_new_tokens"] == N_PROMPTS * NEW_TOKENS
            assert math.isfinite(res["tokens_per_sec"]) and res["tokens_per_sec"] > 0
            packed = eng._mega_packed
            log(f"  {name} weight_quant={wq} (G={mk.weight_group(packed, 'head')}) "
                f"{method}: {res['tokens_per_sec']:.1f} tokens/s (bf16 weights "
                f"{bf16_tps[method]:.1f}, {res['tokens_per_sec'] / bf16_tps[method]:.2f}x), "
                f"streamed weight bytes a step {_packed_weight_bytes(family, packed)}, peak "
                f"{res['gpu_peak_mb']} MB, launches "
                f"{json.dumps({k: v for k, v in got.items() if v})}, last tokens "
                f"{ids[-NEW_TOKENS:][:8]}")
        del eng
        torch.cuda.empty_cache()


def phase_weight_quant_serving(launches: dict, name: str, eng, bf16: dict, n_slots: int,
                               n_requests: int) -> None:
    """Serving over quantized weights on the engine as a user makes it
    (from_model_name(weight_quant=...), bf16): generate_batch (kv_mode None
    and int8), generate_speculative ("ngram", "self_draft") and
    MegaBatchServer (plain and spec="ngram", bf16 and int8 pools), each
    with its bf16-weight phase's launch check on the chains' weight tier:
    the tier counters move, no full-precision launch of those kernels, the
    self-draft on the R = 1 tier steps and no burst. Tokens/s beside the
    bf16-weight engine's of the same path from this call (`bf16`: the
    phases' returns under "batch", "spec", "server"). Its tokens are held to
    the single-stream weight-quant decode in fp32 (phase fp32 hold)."""
    from efficient_llm_inference_tpu_torch.ops import megakernel as mk

    wq = eng.config.weight_quant
    assert wq and mk.weight_quantized(eng.params) and eng.config.dtype == torch.bfloat16
    label = f"{name} weight_quant={wq}"
    rates = {
        "batch": phase_batch_main_path(launches, label, eng, kvs=(None, "int8")),
        "spec": phase_spec_main_path(launches, label, eng, _prompts(N_PROMPTS, SEED)),
        "server": phase_server_main_path(launches, label, eng, n_slots, n_requests),
    }
    for path, got in rates.items():
        for key, v in got.items():
            ref = bf16[path][key]
            log(f"  {label} {path} {key}: {v:.1f} tokens/s against {ref:.1f} with bf16 "
                f"weights ({v / ref:.2f}x)")


def _line_kernels() -> dict:
    """The kernels line's entries: {name: (port source, TPU kernel file:line)},
    every kernel the main path launches."""
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
        "gpt2_megastep": (
            "efficient_llm_inference_tpu_torch/csrc/gpt2_megastep.cu",
            "efficient_llm_inference_tpu/ops/pallas/megakernel.py:332"),
        "gpt2_megastep_quant": (
            "efficient_llm_inference_tpu_torch/csrc/gpt2_megastep.cu",
            "efficient_llm_inference_tpu/ops/pallas/megakernel_quant.py:244"),
        "llama_megastep": (
            "efficient_llm_inference_tpu_torch/csrc/llama_megastep.cu",
            "efficient_llm_inference_tpu/ops/pallas/megakernel_llama.py:729"),
        "llama_megastep_quant": (
            "efficient_llm_inference_tpu_torch/csrc/llama_megastep.cu",
            "efficient_llm_inference_tpu/ops/pallas/megakernel_quant.py:694"),
        "gpt2_megabatch": (
            "efficient_llm_inference_tpu_torch/csrc/gpt2_megabatch.cu",
            "efficient_llm_inference_tpu/ops/pallas/megakernel_batch.py:124"),
        "llama_megabatch": (
            "efficient_llm_inference_tpu_torch/csrc/megabatch.cu",
            "efficient_llm_inference_tpu/ops/pallas/megakernel_batch.py:583"),
        "gpt2_megabatch_quant": (
            "efficient_llm_inference_tpu_torch/csrc/gpt2_megabatch.cu",
            "efficient_llm_inference_tpu/ops/pallas/megakernel_batch_quant.py:215"),
        "llama_megabatch_quant": (
            "efficient_llm_inference_tpu_torch/csrc/megabatch.cu",
            "efficient_llm_inference_tpu/ops/pallas/megakernel_batch_quant.py:679"),
        "gpt2_megaverify": (
            "efficient_llm_inference_tpu_torch/csrc/gpt2_megaverify.cu",
            "efficient_llm_inference_tpu/ops/pallas/megakernel.py:680"),
        "llama_megaverify": (
            "efficient_llm_inference_tpu_torch/csrc/megaverify.cu",
            "efficient_llm_inference_tpu/ops/pallas/megakernel_llama.py:1253"),
        "gpt2_draft_burst": (
            "efficient_llm_inference_tpu_torch/csrc/draft_burst.cu",
            "efficient_llm_inference_tpu/ops/pallas/megakernel_draft.py:85"),
        "llama_draft_burst": (
            "efficient_llm_inference_tpu_torch/csrc/draft_burst.cu",
            "efficient_llm_inference_tpu/ops/pallas/megakernel_draft.py:290"),
        "gpt2_megabatch_verify": (
            "efficient_llm_inference_tpu_torch/csrc/megabatch_verify.cu",
            "efficient_llm_inference_tpu/ops/pallas/megakernel_batch_verify.py:118"),
        "gpt2_megabatch_verify_quant": (
            "efficient_llm_inference_tpu_torch/csrc/megabatch_verify.cu",
            "efficient_llm_inference_tpu/ops/pallas/megakernel_batch_verify.py:591"),
        "llama_megabatch_verify": (
            "efficient_llm_inference_tpu_torch/csrc/megabatch_verify.cu",
            "efficient_llm_inference_tpu/ops/pallas/megakernel_batch_verify.py:1177"),
        "llama_megabatch_verify_quant": (
            "efficient_llm_inference_tpu_torch/csrc/megabatch_verify.cu",
            "efficient_llm_inference_tpu/ops/pallas/megakernel_batch_verify.py:1758"),
        "fused_quant_attention_decode": (
            "efficient_llm_inference_tpu_torch/csrc/fused_quant_attention.cu",
            "efficient_llm_inference_tpu/ops/pallas/attention.py:312"),
        "dequant_int8": (
            "efficient_llm_inference_tpu_torch/csrc/dequant.cu",
            "efficient_llm_inference_tpu/ops/pallas/dequant.py:49"),
        "dequant_int4_packed": (
            "efficient_llm_inference_tpu_torch/csrc/dequant.cu",
            "efficient_llm_inference_tpu/ops/pallas/dequant.py:71"),
        "pallas_linear": (
            "efficient_llm_inference_tpu_torch/csrc/linear.cu",
            "efficient_llm_inference_tpu/ops/pallas/linear.py:44"),
        "pallas_linear_int8": (
            "efficient_llm_inference_tpu_torch/csrc/linear.cu",
            "efficient_llm_inference_tpu/ops/pallas/linear.py:75"),
        "paged_attention_decode": (
            "efficient_llm_inference_tpu_torch/csrc/paged_attention.cu",
            "efficient_llm_inference_tpu/ops/pallas/paged.py:109"),
    }
    for chain in TIERED:  # the weight tiers of #9-#21 the main paths serve
        for suffix in (TIER_SUFFIX.values() if "megastep" in chain
                       else (SERVED_TIER[chain.split("_")[0]],)):
            where[f"{chain}_{suffix}"] = where[chain]
    return where


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from efficient_llm_inference_tpu_torch import Config, InferenceEngine

    t_all = time.perf_counter()

    phase_build()

    t0 = time.perf_counter()
    reports = {
        "fused_quant_attention_batched": check_attention(),
        "quantize_int8_rows": check_quantize(8),
        "quantize_int4_rows": check_quantize(4),
        **check_megasteps(),
    }
    log(f"phase kernels: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    from efficient_llm_inference_tpu_torch.models import gpt2 as gpt2_mod

    gpt2_cfg = gpt2_mod.GPT2Config.small()
    reports.update(check_megabatches("gpt2", gpt2_cfg, lambda dtype: gpt2_mod.init_gpt2_params(
        torch.Generator().manual_seed(42), gpt2_cfg, dtype, "cuda"),
        wide={"fp": (16, 32), "quant": (16,)}))  # #16 at 32: check_gpt2_batch_rows
    check_gpt2_batch_rows(gpt2_cfg)
    log(f"phase batch kernels, gpt2: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    llama = InferenceEngine.from_model_name("llama-3-1b")  # random, seed 42, bf16
    torch.cuda.synchronize()
    log(f"phase llama init: {time.perf_counter() - t0:.1f} s (Llama-3.2-1B, "
        f"{sum(t.numel() for t in _leaves(llama.params)) / 1e9:.3f} B params drawn "
        f"on the host, bf16 on the card)")

    t0 = time.perf_counter()
    reports.update(check_llama_megasteps(llama.params))
    log(f"phase llama kernels: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    reports.update(check_weight_tiers(gpt2_cfg, llama.params))
    log(f"phase weight-tier kernels: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    reports.update(check_megabatches("llama", llama.model.config,
                                     lambda dtype: _cast_params(llama.params, dtype),
                                     wide={"fp": (16, 32), "quant": (16, 32)}, rows_2l=(32,)))
    check_llama_batch_rows(llama)
    check_llama_batch_int8_full(llama)
    log(f"phase batch kernels, llama: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    reports.update(check_megaverify("gpt2", gpt2_cfg, lambda dtype: gpt2_mod.init_gpt2_params(
        torch.Generator().manual_seed(42), gpt2_cfg, dtype, "cuda")))
    reports.update(check_megaverify("llama", llama.model.config,
                                    lambda dtype: _cast_params(llama.params, dtype)))
    reports.update(check_draft_bursts())
    log(f"phase speculation kernels: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    reports.update(check_megabatch_verify(
        "gpt2", gpt2_cfg, lambda dtype: gpt2_mod.init_gpt2_params(
            torch.Generator().manual_seed(42), gpt2_cfg, dtype, "cuda"), 16))
    reports.update(check_megabatch_verify("llama", llama.model.config,
                                          lambda dtype: _cast_params(llama.params, dtype), 8))
    gpt2 = InferenceEngine.from_model_name("gpt2")  # random, seed 42, bf16
    check_verify_past_128_rows(gpt2_cfg, gpt2, llama)
    log(f"phase batched verify kernels: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    reports.update(check_batch_weight_tiers(gpt2_cfg, llama.params))
    log(f"phase batched weight-tier kernels: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    launches: dict = {}
    reports.update(phase_kernel_library(launches, gpt2, llama))
    log(f"phase kernel library: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    gpt2_tps = phase_main_path(launches, "gpt2", lambda mega: InferenceEngine.from_model_name(
        "gpt2", config=Config(model_name="gpt2", megakernel=mega)))
    llama_tps = phase_main_path(launches, "llama-3-1b", lambda mega: (
        llama if mega is None else InferenceEngine.from_model_name(
            "llama-3-1b", config=Config(model_name="llama-3-1b", megakernel=False),
            params=llama.params)))
    log(f"phase main path: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    phase_weight_quant_main_path(launches, "gpt2", lambda wq: InferenceEngine.from_model_name(
        "gpt2", config=Config(model_name="gpt2", weight_quant=wq)), gpt2_tps)
    phase_weight_quant_main_path(launches, "llama-3-1b", lambda wq: (
        InferenceEngine.from_model_name(
            "llama-3-1b", config=Config(model_name="llama-3-1b", weight_quant=wq),
            params=llama.params)), llama_tps)
    log(f"phase weight-quant main path: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    bf16_rates = {"gpt2": {}, "llama-3-1b": {}}
    bf16_rates["gpt2"]["batch"] = phase_batch_main_path(launches, "gpt2", gpt2)
    bf16_rates["llama-3-1b"]["batch"] = phase_batch_main_path(launches, "llama-3-1b", llama)
    log(f"phase batch main path: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    prompts = _prompts(N_PROMPTS, SEED)
    bf16_rates["gpt2"]["spec"] = phase_spec_main_path(launches, "gpt2", gpt2, prompts)
    bf16_rates["llama-3-1b"]["spec"] = phase_spec_main_path(launches, "llama-3-1b", llama,
                                                             prompts)
    phase_spec_draft_main_path(launches)
    log(f"phase speculation main path: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    bf16_rates["gpt2"]["server"] = phase_server_main_path(launches, "gpt2", gpt2,
                                                          n_slots=16, n_requests=32)
    bf16_rates["llama-3-1b"]["server"] = phase_server_main_path(
        launches, "llama-3-1b", llama, n_slots=8, n_requests=16)
    del gpt2
    log(f"phase server main path: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    phase_weight_quant_serving(launches, "llama-3-1b", InferenceEngine.from_model_name(
        "llama-3-1b", config=Config(model_name="llama-3-1b", weight_quant="int8"),
        params=llama.params), bf16_rates["llama-3-1b"], n_slots=8, n_requests=16)
    torch.cuda.empty_cache()
    phase_weight_quant_serving(launches, "gpt2", InferenceEngine.from_model_name(
        "gpt2", config=Config(model_name="gpt2", weight_quant="int4")), bf16_rates["gpt2"],
        n_slots=16, n_requests=32)
    torch.cuda.empty_cache()
    log(f"phase weight-quant serving main path: {time.perf_counter() - t0:.1f} s")
    for name in _line_kernels():
        if launches.get(name, 0) == 0:
            raise AssertionError(f"{name} was never launched on the main path")

    t0 = time.perf_counter()
    phase_fp32_hold()
    gpt2_32 = InferenceEngine.from_model_name(
        "gpt2", config=Config(model_name="gpt2", dtype=torch.float32))
    phase_fp32_mega_hold(gpt2_32)
    for wq in ("int8", "int4"):
        eng32 = InferenceEngine.from_model_name("gpt2", config=Config(
            model_name="gpt2", dtype=torch.float32, weight_quant=wq))
        phase_fp32_mega_hold(eng32, TIER_HOLD_METHODS)
        if wq == "int4":  # the weight-quant serving main path's GPT-2 tier
            phase_batch_fp32_hold(eng32, kvs=(None, "int8"))
            phase_spec_fp32_hold(eng32)
            phase_server_fp32_hold(eng32)
        del eng32
    phase_batch_fp32_hold(gpt2_32)
    phase_spec_fp32_hold(gpt2_32)
    phase_server_fp32_hold(gpt2_32)
    phase_server_pool_dtype(gpt2_32)
    del gpt2_32
    for family, (cfg, dcfg) in _scale_pairs().items():
        eng32, draft32 = _scale_engine(family, cfg, dcfg, torch.float32)
        prompt = _draft_prompts(1, SEED + 7)[0]
        _hold_spec(eng32, f"scale_{family}_big", [(prompt, "draft", DRAFT_K, draft32)])
        del eng32, draft32
    params32 = _cast_params(llama.params, torch.float32)
    del llama
    torch.cuda.empty_cache()
    llama32 = InferenceEngine.from_model_name(
        "llama-3-1b", config=Config(model_name="llama-3-1b", dtype=torch.float32),
        params=params32)
    phase_fp32_mega_hold(llama32)
    phase_spec_fp32_hold(llama32)
    del llama32
    for wq in ("int8", "int4"):
        eng32 = InferenceEngine.from_model_name("llama-3-1b", config=Config(
            model_name="llama-3-1b", dtype=torch.float32, weight_quant=wq), params=params32)
        phase_fp32_mega_hold(eng32, TIER_HOLD_METHODS)
        if wq == "int8":  # the weight-quant serving main path's Llama tier
            phase_batch_fp32_hold(eng32, kvs=(None, "int8"))
            phase_spec_fp32_hold(eng32)
            phase_server_fp32_hold(eng32, n_slots=8, n_requests=8)
        del eng32
        torch.cuda.empty_cache()
    log(f"phase fp32 hold: {time.perf_counter() - t0:.1f} s")
    log(f"total: {time.perf_counter() - t_all:.1f} s")

    where = _line_kernels()
    kernels = []
    for name, (source, replaces) in where.items():
        r = reports[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **({"eager_ms": r["eager_ms"]} if "eager_ms" in r else {}),
        })
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
