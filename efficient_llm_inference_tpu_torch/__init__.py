"""efficient_llm_inference_tpu_torch: the PyTorch/CUDA port of the quantized
KV-cache inference engine, with hand-written CUDA kernels for the NVIDIA H100
(sm_90a). The JAX package `efficient_llm_inference_tpu` is its reference.
"""

__version__ = "0.1.0"

from .core.config import Config  # noqa: F401
from .engine.engine import InferenceEngine  # noqa: F401
from .engine.batching import Request  # noqa: F401
from .engine.megaserver import MegaBatchServer, MegaPoolConfig  # noqa: F401
