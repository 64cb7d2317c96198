"""The port's kernel API under the JAX package's name for it
(`efficient_llm_inference_tpu.ops.pallas`): on a CUDA tensor each wrapper
launches its hand-written CUDA kernel, on a CPU tensor it runs its plain
PyTorch version."""

from .attention import fused_quant_attention_decode  # noqa: F401
from .dequant import dequant_int4_packed, dequant_int8  # noqa: F401
from .linear import pallas_linear, pallas_linear_int8, quantize_weight_int8  # noqa: F401
from .paged import paged_attention_decode  # noqa: F401
from .quantize import quantize_int4_rows, quantize_int8_rows  # noqa: F401
