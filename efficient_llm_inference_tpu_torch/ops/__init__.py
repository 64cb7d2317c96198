"""The port's kernel API: the names of the JAX package's
`efficient_llm_inference_tpu.ops.pallas`, each a wrapper that launches a
hand-written CUDA kernel on a CUDA tensor and runs its plain PyTorch
version (`<name>_plain`, in the same module) on a CPU tensor."""

from .attention import fused_quant_attention_decode  # noqa: F401
from .dequant import dequant_int4_packed, dequant_int8  # noqa: F401
from .linear import pallas_linear, pallas_linear_int8, quantize_weight_int8  # noqa: F401
from .paged import paged_attention_decode  # noqa: F401
from .quantize import quantize_int4_rows, quantize_int8_rows  # noqa: F401
