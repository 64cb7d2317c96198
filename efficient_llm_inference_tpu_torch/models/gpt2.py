"""GPT-2 in PyTorch (port of efficient_llm_inference_tpu/models/gpt2.py).

Parameters are a plain dict of tensors in the JAX package's stacked-layer
layout: every per-layer tensor has a leading `n_layer` axis, and linear
weights follow the HF Conv1D convention `y = x @ W + b` with W [in, out].
The KV cache lives behind a strategy object (cache/kvcache.py) whose
`layer_attend` hook receives each layer's q/k/v; the model body is the same
for every cache policy. Numerics follow HF GPT2LMHeadModel: tanh-GELU,
1/sqrt(D) attention scale, fp32 layer-norm statistics.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @staticmethod
    def small() -> "GPT2Config":
        return GPT2Config()

    @staticmethod
    def medium() -> "GPT2Config":
        return GPT2Config(n_embd=1024, n_layer=24, n_head=16)

    @staticmethod
    def large() -> "GPT2Config":
        return GPT2Config(n_embd=1280, n_layer=36, n_head=20)

    @staticmethod
    def tiny(vocab_size: int = 256) -> "GPT2Config":
        """Small config for tests."""
        return GPT2Config(
            vocab_size=vocab_size, n_positions=512, n_embd=64, n_layer=2, n_head=4
        )


def param_shapes(cfg: GPT2Config) -> dict:
    """Shape of every parameter, in the stacked-layer layout."""
    E, L, V = cfg.n_embd, cfg.n_layer, cfg.vocab_size
    return {
        "wte": (V, E),
        "wpe": (cfg.n_positions, E),
        "blocks": {
            "ln1_g": (L, E), "ln1_b": (L, E),
            "attn_w": (L, E, 3 * E), "attn_b": (L, 3 * E),
            "attn_proj_w": (L, E, E), "attn_proj_b": (L, E),
            "ln2_g": (L, E), "ln2_b": (L, E),
            "fc_w": (L, E, 4 * E), "fc_b": (L, 4 * E),
            "fc_proj_w": (L, 4 * E, E), "fc_proj_b": (L, E),
        },
        "lnf_g": (E,), "lnf_b": (E,),
    }


def init_gpt2_params(generator: torch.Generator, cfg: GPT2Config,
                     dtype=torch.float32, device="cuda") -> dict:
    """Random-init parameters (normal, std 0.02; residual projections scaled
    by 1/sqrt(2L); layer norms at identity; biases zero). The draws are made
    in fp32 on the generator's device, then cast and moved."""
    shapes = param_shapes(cfg)
    L = cfg.n_layer

    def nrm(shape, div=1.0):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * 0.02
        return (w.to(dtype) / div).to(device)

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    b = shapes["blocks"]
    return {
        "wte": nrm(shapes["wte"]),
        "wpe": nrm(shapes["wpe"]),
        "blocks": {
            "ln1_g": const(b["ln1_g"], 1.0),
            "ln1_b": const(b["ln1_b"], 0.0),
            "attn_w": nrm(b["attn_w"]),
            "attn_b": const(b["attn_b"], 0.0),
            "attn_proj_w": nrm(b["attn_proj_w"], math.sqrt(2 * L)),
            "attn_proj_b": const(b["attn_proj_b"], 0.0),
            "ln2_g": const(b["ln2_g"], 1.0),
            "ln2_b": const(b["ln2_b"], 0.0),
            "fc_w": nrm(b["fc_w"]),
            "fc_b": const(b["fc_b"], 0.0),
            "fc_proj_w": nrm(b["fc_proj_w"], math.sqrt(2 * L)),
            "fc_proj_b": const(b["fc_proj_b"], 0.0),
        },
        "lnf_g": const(shapes["lnf_g"], 1.0),
        "lnf_b": const(shapes["lnf_b"], 0.0),
    }


def convert_tree(tree: Mapping, shapes: dict, dtype, device, path: str = "") -> dict:
    """A nested dict of arrays -> the same dict of tensors in `dtype` on
    `device`, its keys and shapes checked against `shapes`."""
    if set(tree) != set(shapes):
        raise ValueError(f"{path or 'params'}: keys {sorted(tree)} != "
                         f"{sorted(shapes)}")
    out = {}
    for k, shape in shapes.items():
        if isinstance(shape, dict):
            out[k] = convert_tree(tree[k], shape, dtype, device, f"{path}{k}.")
            continue
        a = np.asarray(tree[k])
        if a.shape != shape:
            raise ValueError(f"{path}{k}: shape {a.shape} != {shape}")
        out[k] = torch.from_numpy(a.astype(np.float32)).to(dtype).to(device)
    return out


def params_from_jax(np_params: Mapping, cfg: GPT2Config,
                    dtype=torch.float32, device="cuda") -> dict:
    """The JAX package's stacked-layer GPT-2 param dict, given as numpy
    arrays (e.g. `jax.tree.map(np.asarray, params)`), as the port's dict of
    tensors. Shapes are checked against `cfg`."""
    return convert_tree(np_params, param_shapes(cfg), dtype, device)


def _mm(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None):
    """x @ w (+ b) in x's dtype."""
    y = torch.matmul(x, w)
    return y if b is None else y + b


def _layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                eps: float) -> torch.Tensor:
    """LayerNorm with fp32 statistics."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * g.float() + b.float()).to(x.dtype)


def _gelu_new(x: torch.Tensor) -> torch.Tensor:
    """HF "gelu_new" tanh approximation, in fp32."""
    x32 = x.float()
    y = 0.5 * x32 * (
        1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x32 + 0.044715 * x32**3))
    )
    return y.to(x.dtype)


def gpt2_forward(
    params: dict,
    cfg: GPT2Config,
    tokens: torch.Tensor,  # [B, T] int64
    positions: torch.Tensor,  # [B, T] int64; the caller sets them
    cache: Any,  # strategy cache state (updated in place)
    strategy,  # KV strategy (cache/kvcache.py)
    seq_mask: Optional[torch.Tensor] = None,  # [B, T] bool, True = real token
) -> Tuple[torch.Tensor, Any]:
    """One forward pass (prefill T>1 or decode T=1) through all layers.

    Returns (logits [B, T, vocab] float32, cache). Attention over the cache
    is `strategy.layer_attend(cache, layer, q, k, v, seq_mask)`, which writes
    the layer's new K/V into the cache in place.
    """
    B, T = tokens.shape
    E, H, D = cfg.n_embd, cfg.n_head, cfg.head_dim

    x = params["wte"][tokens] + params["wpe"][positions]  # [B, T, E]
    if seq_mask is not None:
        x = torch.where(seq_mask[..., None], x, torch.zeros_like(x))

    blocks = params["blocks"]
    for layer in range(cfg.n_layer):
        bp = {k: v[layer] for k, v in blocks.items()}
        h = _layer_norm(x, bp["ln1_g"], bp["ln1_b"], cfg.layer_norm_epsilon)
        qkv = _mm(h, bp["attn_w"], bp["attn_b"])  # [B, T, 3E]
        # [B, T, H, D] -> [B, H, T, D] views of qkv
        q, k, v = (t.reshape(B, T, H, D).transpose(1, 2)
                   for t in qkv.split(E, dim=-1))
        attn = strategy.layer_attend(cache, layer, q, k, v, seq_mask)
        a = attn.transpose(1, 2).reshape(B, T, E).to(x.dtype)
        x = x + _mm(a, bp["attn_proj_w"], bp["attn_proj_b"])

        h2 = _layer_norm(x, bp["ln2_g"], bp["ln2_b"], cfg.layer_norm_epsilon)
        m = _gelu_new(_mm(h2, bp["fc_w"], bp["fc_b"]))
        x = x + _mm(m, bp["fc_proj_w"], bp["fc_proj_b"])

    x = _layer_norm(x, params["lnf_g"], params["lnf_b"], cfg.layer_norm_epsilon)
    logits = torch.matmul(x, params["wte"].t()).float()  # [B, T, V]
    return logits, cache
