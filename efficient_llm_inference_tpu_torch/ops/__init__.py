"""The port's op-level API.

As the JAX package's `efficient_llm_inference_tpu.ops`, it exports the
quantization functions of ops/quantization.py (bit-exact with JAX's). It also
exports the kernel API, the names of JAX's `ops.pallas` (reachable as
`efficient_llm_inference_tpu_torch.ops.pallas` too): each a wrapper that
launches a hand-written CUDA kernel on a CUDA tensor and runs its plain
PyTorch version (`<name>_plain`, in the same module) on a CPU tensor."""

from .pallas import (  # noqa: F401
    dequant_int4_packed,
    dequant_int8,
    fused_quant_attention_decode,
    paged_attention_decode,
    pallas_linear,
    pallas_linear_int8,
    quantize_int4_rows,
    quantize_int8_rows,
    quantize_weight_int8,
)
from .quantization import (  # noqa: F401
    dequantize_int4_packed,
    dequantize_int8,
    quantize_int4_packed,
    quantize_int8,
    unpack_int4,
)
