"""Core configuration dataclasses (PyTorch port of
efficient_llm_inference_tpu/core/config.py).

The device is explicit and defaults to "cuda": nothing falls back to the CPU
when no card is present. The dtype policy mirrors the JAX package's
(bf16 on the accelerator, fp32 on the CPU). Seeding is an explicit
`torch.Generator` built from `seed`; no global RNG is touched.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


WEIGHT_QUANT_MODES = (None, "int8", "int4", "int4w8")


def default_dtype(device: str) -> torch.dtype:
    """bfloat16 on CUDA, float32 on the CPU."""
    return torch.float32 if torch.device(device).type == "cpu" else torch.bfloat16


@dataclass
class Config:
    """Main configuration for inference benchmarking.

    Attributes:
        model_name: model identifier ("gpt2", "gpt2-tiny", "llama-3-1b",
            "qwen2.5-0.5b", ...).
        device: torch device string; "cuda" unless the caller asks otherwise.
        dtype: compute dtype of weights and activations; None picks
            :func:`default_dtype` for the device.
        seed: seed of the generator that initialises random weights.
        max_new_tokens: default generation length (the JAX Config's field;
            the engine's calls take theirs explicitly).
        batch_size: batch size for inference (the quantized cache takes 1).
        prompt_cap: prompt-length cap of the truncating methods.
        scan_unroll: the JAX package's layer-loop unroll factor, a TPU
            compile knob; accepted so that configs carry over, and ignored
            (the port's layer loop is eager Python or a CUDA kernel chain).
        megakernel: run eligible greedy batch-1 decode (full_cache, and
            quant_* at per_token granularity) as one chain of hand-written
            CUDA kernels per step, captured in a CUDA graph
            (ops/megakernel.py, ops/megakernel_quant.py). None = on for a
            CUDA device, off on the CPU; False disables; True forces (on the
            CPU the steps then run the kernels' plain PyTorch versions).
            It also lets `generate_batch` take the batched kernels
            (ops/megakernel_batch.py); off, it generates prompt by prompt.
        weight_quant: serving mode beyond the reference (the JAX Config's
            field). "int8" quantizes every matmul weight per output
            channel; "int4" uses grouped 4-bit weights (group 128 along
            the input); "int4w8" is int4 with one scale group per half of
            the JAX kernel's weight tile (Llama/Qwen: TR/2; GPT-2: E/2).
            The engine quantizes at `from_model_name` and every whole-step
            kernel chain streams the codes (single stream, speculation,
            static batches, `MegaBatchServer`; ops/megakernel.py); None
            keeps full-precision weights.
    """

    model_name: str = "gpt2"
    device: str = "cuda"
    dtype: Optional[torch.dtype] = None
    seed: int = 42
    max_new_tokens: int = 64
    batch_size: int = 1
    prompt_cap: int = 1024
    scan_unroll: Optional[int] = None
    megakernel: Optional[bool] = None
    weight_quant: Optional[str] = None

    def __post_init__(self):
        if self.weight_quant not in WEIGHT_QUANT_MODES:
            raise ValueError(f"weight_quant={self.weight_quant!r}: expected one of "
                             f"{WEIGHT_QUANT_MODES}")
        if self.dtype is None:
            self.dtype = default_dtype(self.device)

    def resolved_megakernel(self) -> bool:
        if self.megakernel is not None:
            return self.megakernel
        return torch.device(self.device).type == "cuda"

    def generator(self) -> torch.Generator:
        """A CPU generator seeded from `seed` (weights are drawn on the host,
        so the same seed gives the same weights on every device)."""
        return torch.Generator(device="cpu").manual_seed(self.seed)
