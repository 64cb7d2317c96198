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
from functools import partial
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


def _quantized_shapes(leaf: Mapping, shape: tuple, path: str) -> dict:
    """Expected shapes of a quantized weight {"q": int8, "s": fp32} (per
    output channel) or {"q4": uint8, "s": fp32} (groups along the input
    dim, the group read off the codes) standing for a weight of `shape`
    [..., K, F]."""
    *lead, K, F = shape
    if set(leaf) == {"q", "s"}:
        return {"q": tuple(shape), "s": (*lead, 1, F)}
    if set(leaf) == {"q4", "s"}:
        q4 = np.asarray(leaf["q4"])
        g = 2 * q4.shape[-2] if q4.ndim == len(shape) + 1 else 0
        if g == 0 or K % g:
            raise ValueError(f"{path}: int4 codes {q4.shape} for a weight {shape}")
        return {"q4": (*lead, K // g, g // 2, F), "s": (*lead, K // g, 1, F)}
    raise ValueError(f"{path}: a quantized weight has keys q, s or q4, s; "
                     f"got {sorted(leaf)}")


def _leaf(a, key: str, dtype, device) -> torch.Tensor:
    """One array as a tensor: quantized codes keep their integer dtype
    (q int8, q4 uint8), scales stay fp32, every other leaf takes `dtype`."""
    if key in ("q", "lm_q"):
        return torch.from_numpy(np.array(a, np.int8)).to(device)
    if key in ("q4", "lm_q4"):
        return torch.from_numpy(np.array(a, np.uint8)).to(device)
    if key in ("s", "lm_s", "lm_s4"):
        return torch.from_numpy(np.array(a, np.float32)).to(device)
    return torch.from_numpy(a.astype(np.float32)).to(dtype).to(device)


def convert_tree(tree: Mapping, shapes: dict, dtype, device, path: str = "") -> dict:
    """A nested dict of arrays -> the same dict of tensors on `device`, its
    keys and shapes checked against `shapes`. Float leaves take `dtype`; a
    weight given as a quantized dict (models' `quantize_*_weights`) is
    carried as it is: integer codes, fp32 scales."""
    if set(tree) != set(shapes):
        raise ValueError(f"{path or 'params'}: keys {sorted(tree)} != "
                         f"{sorted(shapes)}")
    out = {}
    for k, shape in shapes.items():
        if isinstance(tree[k], Mapping) and not isinstance(shape, dict):
            shape = _quantized_shapes(tree[k], shape, f"{path}{k}")
        if isinstance(shape, dict):
            out[k] = convert_tree(tree[k], shape, dtype, device, f"{path}{k}.")
            continue
        a = np.asarray(tree[k])
        if a.shape != shape:
            raise ValueError(f"{path}{k}: shape {a.shape} != {shape}")
        out[k] = _leaf(a, k, dtype, device)
    return out


def lm_head_shapes(tree: Mapping, E: int, V: int) -> dict:
    """Shapes of the quantized LM-head copy at the root of a
    weight-quantized tree (`lm_q`/`lm_s` or `lm_q4`/`lm_s4`), if any."""
    if "lm_q" in tree:
        return {"lm_q": (E, V), "lm_s": (1, V)}
    if "lm_q4" in tree:
        s = _quantized_shapes({"q4": tree["lm_q4"], "s": None}, (E, V), "lm_q4")
        return {"lm_q4": s["q4"], "lm_s4": s["s"]}
    return {}


def params_from_jax(np_params: Mapping, cfg: GPT2Config,
                    dtype=torch.float32, device="cuda") -> dict:
    """The JAX package's stacked-layer GPT-2 param dict, given as numpy
    arrays (e.g. `jax.tree.map(np.asarray, params)`), as the port's dict of
    tensors. Shapes are checked against `cfg`. A weight-quantized tree
    (`quantize_gpt2_weights`, either package) keeps its codes and fp32
    scales, and its LM-head copy."""
    shapes = param_shapes(cfg)
    shapes.update(lm_head_shapes(np_params, cfg.n_embd, cfg.vocab_size))
    return convert_tree(np_params, shapes, dtype, device)


# ---------------------------------------------------------------------------
# Weight quantization (serving mode, beyond the reference; JAX
# models/gpt2.py:104-197). The JAX engine quantizes op by op, outside jit,
# so the scales follow the divide form max|w| / 127 (or / 7), as
# ops.linear.quantize_weight_int8 does, not the jitted multiply by
# f32(1/qmax) of the KV quantizers.


def quantize_int8_weights(w: torch.Tensor) -> dict:
    """Per-output-channel symmetric int8: w [..., K, F] -> {"q": int8
    [..., K, F], "s": fp32 [..., 1, F]}, s = max(max|w| / 127, 1e-8) over K,
    q = clip(round_half_even(w / s), -127, 127)."""
    from ..ops.linear import quantize_weight_int8

    q, s = quantize_weight_int8(w, axis=-2)
    return {"q": q, "s": s}


def quantize_int4_weights(w: torch.Tensor, group: int = 128) -> dict:
    """Group-wise symmetric int4: w [..., K, F] -> {"q4": uint8
    [..., K/g, g/2, F], "s": fp32 [..., K/g, 1, F]}. One scale per (input
    group, output channel): s = max(max|w| / 7, 1e-8) over the group, codes
    clip(round_half_even(w / s), -8, 7); two codes a byte, the even
    in-group input position in the low nibble and the odd one in the high
    (two's complement). The group g is `group`, widened to K where K %
    group != 0 or the group is odd."""
    K = w.shape[-2]
    g = group if K % group == 0 else K
    if g % 2:
        g = K
    if g % 2:
        raise ValueError(f"int4 weight quant needs an even input dim, got {K}")
    lead, F = w.shape[:-2], w.shape[-1]
    wg = w.float().reshape(*lead, K // g, g, F)
    s = torch.clamp(torch.amax(wg.abs(), dim=-2, keepdim=True) / 7.0, min=1e-8)
    q = torch.clamp(torch.round(wg / s), -8, 7).to(torch.int8)
    lo = (q[..., 0::2, :] & 0xF).to(torch.uint8)
    hi = (q[..., 1::2, :] & 0xF).to(torch.uint8)
    return {"q4": lo | (hi << 4), "s": s}


def _unpack_nibbles(q: torch.Tensor):
    """Packed uint8 -> (even, odd) sign-extended int8 nibbles."""
    lo = (q & 0xF).to(torch.int8)
    hi = (q >> 4).to(torch.int8)
    return (lo ^ 8) - 8, (hi ^ 8) - 8


def _int4_dot(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ packed int4 (q [Kg, G/2, F], s [Kg, 1, F]) -> fp32
    [..., F]: per group, the even and the odd in-group positions dot their
    nibble planes in fp32 (exact products of x's values), and the group
    sums are scaled and summed over the groups (JAX `_int4_dot`)."""
    Kg, Gh, F = q.shape
    xg = x.float().reshape(*x.shape[:-1], Kg, 2 * Gh)
    lo, hi = _unpack_nibbles(q)
    y = (torch.einsum("...kg,kgf->...kf", xg[..., 0::2], lo.float())
         + torch.einsum("...kg,kgf->...kf", xg[..., 1::2], hi.float()))
    # contiguous: einsum may hand back a permuted layout, and the rows
    # kernels downstream take unit inner strides
    return torch.einsum("...kf,kf->...f", y, s[:, 0, :].float()).contiguous()


def quantize_gpt2_weights(params: dict, mode: str = "int8", group: int = 128) -> dict:
    """Weight quantization for serving ("int8" or "int4"): every matmul
    weight becomes {"q", "s"} (per output channel) or {"q4", "s"} (grouped,
    `quantize_int4_weights`); embeddings, norms and biases stay as they are.
    `wte` also gets a quantized LM-head copy from wte.T (`lm_q`/`lm_s` or
    `lm_q4`/`lm_s4`) and stays for the embedding lookup."""
    if mode == "int8":
        q = quantize_int8_weights
    else:
        q = partial(quantize_int4_weights, group=group)
    blocks = dict(params["blocks"])
    for name in ("attn_w", "attn_proj_w", "fc_w", "fc_proj_w"):
        blocks[name] = q(blocks[name])
    out = dict(params)
    out["blocks"] = blocks
    lm = q(params["wte"].t())  # [E, V]
    if mode == "int8":
        out["lm_q"], out["lm_s"] = lm["q"], lm["s"]
    else:
        out["lm_q4"], out["lm_s4"] = lm["q4"], lm["s"]
    return out


def lm_logits(params: dict, x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """fp32 logits of the final hidden states x [..., E]: over the quantized
    LM-head copy when the params carry one (`lm_q`: (x @ q) * s with fp32
    sums; `lm_q4`: `_int4_dot`), else x @ head ([E, V], full precision, in
    x's dtype)."""
    if "lm_q" in params:
        return torch.matmul(x.float(), params["lm_q"].float()) * params["lm_s"]
    if "lm_q4" in params:
        return _int4_dot(x, params["lm_q4"], params["lm_s4"])
    return torch.matmul(x, head).float()


def _mm(x: torch.Tensor, w, b: Optional[torch.Tensor] = None):
    """x @ w (+ b) in x's dtype. w is a dense tensor, or a quantized dict:
    {"q", "s"} gives (x @ q) * s with fp32 sums, {"q4", "s"} `_int4_dot`;
    the bias is added in fp32 before the cast (JAX `_mm`)."""
    if isinstance(w, dict):
        if "q4" in w:
            y = _int4_dot(x, w["q4"], w["s"])
        else:
            y = torch.matmul(x.float(), w["q"].float()) * w["s"]
        if b is not None:
            y = y + b.float()
        return y.to(x.dtype)
    y = torch.matmul(x, w)
    return y if b is None else y + b


def layer_params(blocks: dict, layer: int) -> dict:
    """One layer's slice of the stacked block params (quantized weights
    slice code by code)."""
    return {k: ({kk: vv[layer] for kk, vv in v.items()} if isinstance(v, dict)
                else v[layer]) for k, v in blocks.items()}


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
        bp = layer_params(blocks, layer)
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
    logits = lm_logits(params, x, params["wte"].t())  # [B, T, V]
    return logits, cache
