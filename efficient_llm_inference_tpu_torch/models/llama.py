"""The Llama family in PyTorch: RoPE, RMSNorm, grouped-query attention,
SwiGLU (port of efficient_llm_inference_tpu/models/llama.py), with the
serving mode's weight quantization (`quantize_llama_weights`,
`init_quantized_llama_params`, `pad_llama_ffn`).

Qwen2/Qwen2.5 is the same architecture with q/k/v projection biases
(`LlamaConfig.qkv_bias`). Parameters are a plain dict of tensors in the JAX
package's stacked-layer layout (every per-layer tensor has a leading
`n_layer` axis; linear weights are [in, out], `y = x @ W`), so the same
numpy arrays feed both packages. Numerics follow HF LlamaForCausalLM:
rotate-half RoPE, fp32 RMSNorm statistics with the normalised value cast to
the model dtype before the gain, 1/sqrt(D) attention scale, silu in fp32.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch

from .gpt2 import (
    _mm,
    convert_tree,
    layer_params,
    lm_head_shapes,
    lm_logits,
    quantize_int4_weights,
    quantize_int8_weights,
)

WEIGHT_NAMES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    n_layer: int = 32
    n_head: int = 32
    n_kv_head: int = 8
    n_positions: int = 8192  # max_position_embeddings
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    qkv_bias: bool = False  # Qwen2 adds biases to the q/k/v projections

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.n_head

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama3_1b() -> "LlamaConfig":
        # Llama-3.2-1B geometry
        return LlamaConfig(hidden_size=2048, intermediate_size=8192, n_layer=16,
                           n_head=32, n_kv_head=8, tie_embeddings=True)

    @staticmethod
    def llama3_3b() -> "LlamaConfig":
        # Llama-3.2-3B geometry
        return LlamaConfig(hidden_size=3072, intermediate_size=8192, n_layer=28,
                           n_head=24, n_kv_head=8, tie_embeddings=True)

    @staticmethod
    def tiny(vocab_size: int = 256) -> "LlamaConfig":
        return LlamaConfig(vocab_size=vocab_size, hidden_size=64,
                           intermediate_size=128, n_layer=2, n_head=4,
                           n_kv_head=2, n_positions=512, rope_theta=10000.0)

    @staticmethod
    def qwen25_7b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=152064, hidden_size=3584, intermediate_size=18944,
            n_layer=28, n_head=28, n_kv_head=4, n_positions=32768,
            rope_theta=1000000.0, rms_eps=1e-6, qkv_bias=True)

    @staticmethod
    def qwen25_15b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=151936, hidden_size=1536, intermediate_size=8960,
            n_layer=28, n_head=12, n_kv_head=2, n_positions=32768,
            rope_theta=1000000.0, rms_eps=1e-6, tie_embeddings=True,
            qkv_bias=True)

    @staticmethod
    def qwen25_05b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=151936, hidden_size=896, intermediate_size=4864,
            n_layer=24, n_head=14, n_kv_head=2, n_positions=32768,
            rope_theta=1000000.0, rms_eps=1e-6, tie_embeddings=True,
            qkv_bias=True)

    @staticmethod
    def qwen_tiny(vocab_size: int = 256) -> "LlamaConfig":
        return dataclasses.replace(LlamaConfig.tiny(vocab_size), qkv_bias=True,
                                   rms_eps=1e-6)

    @staticmethod
    def by_name(name: str) -> "LlamaConfig":
        table = {
            "llama-3-8b": LlamaConfig.llama3_8b,
            "llama3-8b": LlamaConfig.llama3_8b,
            "llama-3-1b": LlamaConfig.llama3_1b,
            "llama-3-3b": LlamaConfig.llama3_3b,
            "llama-tiny": LlamaConfig.tiny,
            "qwen2.5-7b": LlamaConfig.qwen25_7b,
            "qwen/qwen2.5-7b": LlamaConfig.qwen25_7b,
            "qwen2.5-1.5b": LlamaConfig.qwen25_15b,
            "qwen2.5-0.5b": LlamaConfig.qwen25_05b,
            "qwen-tiny": LlamaConfig.qwen_tiny,
        }
        key = name.lower()
        if key not in table:
            raise ValueError(f"Unknown llama variant: {name}")
        return table[key]()


def param_shapes(cfg: LlamaConfig) -> dict:
    """Shape of every parameter, in the stacked-layer layout."""
    E, L, V, I = cfg.hidden_size, cfg.n_layer, cfg.vocab_size, cfg.intermediate_size
    QW, KW = cfg.n_head * cfg.head_dim, cfg.n_kv_head * cfg.head_dim
    blocks = {
        "ln1": (L, E), "wq": (L, E, QW), "wk": (L, E, KW), "wv": (L, E, KW),
        "wo": (L, QW, E), "ln2": (L, E), "w_gate": (L, E, I), "w_up": (L, E, I),
        "w_down": (L, I, E),
    }
    if cfg.qkv_bias:
        blocks.update(bq=(L, QW), bk=(L, KW), bv=(L, KW))
    shapes = {"embed": (V, E), "blocks": blocks, "ln_f": (E,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (E, V)
    return shapes


def init_llama_params(generator: torch.Generator, cfg: LlamaConfig,
                      dtype=torch.float32, device="cuda") -> dict:
    """Random-init parameters (normal, std 0.02; the residual projections wo
    and w_down scaled by 1/sqrt(2L); norms at one). Each tensor is drawn in
    fp32 on the generator's device, then cast and moved, so the same seed
    gives the same weights on every device."""
    shapes = param_shapes(cfg)
    L = cfg.n_layer

    def nrm(shape, div=1.0):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * 0.02
        w = w.to(dtype)
        return (w / div if div != 1.0 else w).to(device)

    b = shapes["blocks"]
    res = math.sqrt(2 * L)
    blocks = {
        "ln1": torch.ones(b["ln1"], dtype=dtype, device=device),
        "wq": nrm(b["wq"]), "wk": nrm(b["wk"]), "wv": nrm(b["wv"]),
        "wo": nrm(b["wo"], res),
        "ln2": torch.ones(b["ln2"], dtype=dtype, device=device),
        "w_gate": nrm(b["w_gate"]), "w_up": nrm(b["w_up"]),
        "w_down": nrm(b["w_down"], res),
    }
    params = {"embed": nrm(shapes["embed"]), "blocks": blocks,
              "ln_f": torch.ones(shapes["ln_f"], dtype=dtype, device=device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = nrm(shapes["lm_head"])
    if cfg.qkv_bias:
        for name in ("bq", "bk", "bv"):
            blocks[name] = nrm(b[name])
    return params


def param_bytes_estimate(cfg: LlamaConfig, dtype=torch.bfloat16) -> int:
    """Full-precision parameter footprint in bytes (norms and biases left
    out, as in the JAX package)."""
    E, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.n_layer
    QW, KW = cfg.n_head * cfg.head_dim, cfg.n_kv_head * cfg.head_dim
    n = cfg.vocab_size * E + L * (E * QW + 2 * E * KW + QW * E + 3 * E * I)
    if not cfg.tie_embeddings:
        n += E * cfg.vocab_size
    return n * torch.empty((), dtype=dtype).element_size()


def params_from_jax(np_params: Mapping, cfg: LlamaConfig, dtype=torch.float32,
                    device="cuda") -> dict:
    """The JAX package's Llama param dict, given as numpy arrays (e.g.
    `jax.tree.map(np.asarray, params)`), as the port's dict of tensors. Keys
    and shapes are checked against `cfg`. A weight-quantized tree
    (`quantize_llama_weights`, either package: every matmul weight a
    {"q", "s"} or {"q4", "s"} dict, the LM head's copy under `lm_q`/`lm_s` or
    `lm_q4`/`lm_s4`, no `lm_head`) keeps its integer codes and fp32
    scales."""
    shapes = param_shapes(cfg)
    lm = lm_head_shapes(np_params, cfg.hidden_size, cfg.vocab_size)
    if lm:
        shapes.pop("lm_head", None)
        shapes.update(lm)
    return convert_tree(np_params, shapes, dtype, device)


def params_from_hf_state_dict(state_dict: Mapping, cfg: LlamaConfig,
                              dtype=torch.float32, device="cuda") -> dict:
    """HF LlamaForCausalLM / Qwen2ForCausalLM weights, given as a plain dict
    of tensors or arrays under the HF names (no `transformers` needed), as
    the port's params. HF linear weights are [out, in]; they are transposed
    to the [in, out] layout here."""

    def get(name, transpose=False):
        t = state_dict[name]
        a = t.detach().cpu().float().numpy() if isinstance(t, torch.Tensor) \
            else np.asarray(t, np.float32)
        return a.T if transpose else a

    def stack(fmt, transpose=False):
        return np.stack([get(fmt.format(i), transpose) for i in range(cfg.n_layer)])

    layer = "model.layers.{}."
    blocks = {
        "ln1": stack(layer + "input_layernorm.weight"),
        "wq": stack(layer + "self_attn.q_proj.weight", True),
        "wk": stack(layer + "self_attn.k_proj.weight", True),
        "wv": stack(layer + "self_attn.v_proj.weight", True),
        "wo": stack(layer + "self_attn.o_proj.weight", True),
        "ln2": stack(layer + "post_attention_layernorm.weight"),
        "w_gate": stack(layer + "mlp.gate_proj.weight", True),
        "w_up": stack(layer + "mlp.up_proj.weight", True),
        "w_down": stack(layer + "mlp.down_proj.weight", True),
    }
    if cfg.qkv_bias:  # Qwen2 checkpoints carry q/k/v biases under the same names
        for short, proj in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
            blocks[short] = stack(layer + f"self_attn.{proj}.bias")
    tree = {"embed": get("model.embed_tokens.weight"), "blocks": blocks,
            "ln_f": get("model.norm.weight")}
    if not cfg.tie_embeddings:
        tree["lm_head"] = get("lm_head.weight", True)
    return params_from_jax(tree, cfg, dtype, device)


def _rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with fp32 statistics; the normalised value is cast to x's
    dtype before the gain, as HF does."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y.to(x.dtype) * g.to(x.dtype)).to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables of HF rotate-half RoPE: positions [...] -> [..., D]
    fp32 each. The inverse frequencies are taken in float64 and rounded
    once to fp32, which is what the JAX package's jitted (constant-folded)
    table holds; the angles are the fp32 products, as there, and their
    cos/sin are taken in float64 and rounded once (fp32 cos/sin lose
    accuracy at the large angles of long positions)."""
    expo = torch.arange(0, head_dim, 2, dtype=torch.float64) / head_dim
    inv_freq = (1.0 / theta ** expo).to(torch.float32).to(positions.device)
    freqs = positions.to(torch.float32)[..., None] * inv_freq  # [..., D/2]
    emb = torch.cat([freqs, freqs], dim=-1).double()
    return torch.cos(emb).float(), torch.sin(emb).float()


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    d = x.shape[-1] // 2
    return torch.cat([-x[..., d:], x[..., :d]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, T, D]; cos/sin [B, T, D] fp32. Computed in fp32, returned in
    x's dtype."""
    c, s = cos[:, None].float(), sin[:, None].float()
    x32 = x.float()
    return (x32 * c + _rotate_half(x32) * s).to(x.dtype)


def llama_forward(
    params: dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, T] int64
    positions: torch.Tensor,  # [B, T] int64
    cache: Any,
    strategy,
    seq_mask: Optional[torch.Tensor] = None,  # [B, T] bool, True = real token
) -> Tuple[torch.Tensor, Any]:
    """One forward pass (prefill T>1 or decode T=1) through all layers.

    Returns (logits [B, T, vocab] float32, cache). Attention over the cache
    is `strategy.layer_attend(cache, layer, q, k, v, seq_mask)` with Hq
    query heads over Hkv K/V heads (grouped-query attention); it writes the
    layer's new K/V into the cache in place.
    """
    B, T = tokens.shape
    Hq, Hkv, D = cfg.n_head, cfg.n_kv_head, cfg.head_dim

    x = params["embed"][tokens]  # [B, T, E]
    if seq_mask is not None:
        x = torch.where(seq_mask[..., None], x, torch.zeros_like(x))
    cos, sin = rope_cos_sin(positions, D, cfg.rope_theta)

    blocks = params["blocks"]
    for layer in range(cfg.n_layer):
        bp = layer_params(blocks, layer)
        h = _rms_norm(x, bp["ln1"], cfg.rms_eps)
        q = _mm(h, bp["wq"], bp.get("bq")).reshape(B, T, Hq, D).transpose(1, 2)
        k = _mm(h, bp["wk"], bp.get("bk")).reshape(B, T, Hkv, D).transpose(1, 2)
        v = _mm(h, bp["wv"], bp.get("bv")).reshape(B, T, Hkv, D).transpose(1, 2)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn = strategy.layer_attend(cache, layer, q, k, v, seq_mask)
        a = attn.transpose(1, 2).reshape(B, T, Hq * D).to(x.dtype)
        x = x + _mm(a, bp["wo"])

        h2 = _rms_norm(x, bp["ln2"], cfg.rms_eps)
        g = _mm(h2, bp["w_gate"]).float()
        gate = (g * torch.sigmoid(g)).to(x.dtype)  # silu in fp32
        x = x + _mm(gate * _mm(h2, bp["w_up"]), bp["w_down"])

    x = _rms_norm(x, params["ln_f"], cfg.rms_eps)
    head = params["embed"].t() if cfg.tie_embeddings else params.get("lm_head")
    logits = lm_logits(params, x, head)  # [B, T, V]
    return logits, cache


def quantize_llama_weights(params: dict, mode: str = "int8", group: int = 128) -> dict:
    """Weight quantization for serving ("int8" or "int4"; JAX
    `quantize_llama_weights`): the seven matmul weights become {"q", "s"} or
    {"q4", "s"} dicts (models.gpt2's quantizers); embed, norms and biases
    stay as they are; the LM head (`lm_head`, or `embed.T` when tied) gets a
    quantized copy under `lm_q`/`lm_s` or `lm_q4`/`lm_s4`, and `lm_head`
    itself is dropped."""
    if mode == "int8":
        q = quantize_int8_weights
    else:
        q = partial(quantize_int4_weights, group=group)
    blocks = dict(params["blocks"])
    for name in WEIGHT_NAMES:
        blocks[name] = q(blocks[name])
    out = dict(params)
    out["blocks"] = blocks
    head = params["lm_head"] if "lm_head" in params else params["embed"].t()
    lm = q(head)
    out.pop("lm_head", None)
    if mode == "int8":
        out["lm_q"], out["lm_s"] = lm["q"], lm["s"]
    else:
        out["lm_q4"], out["lm_s4"] = lm["q4"], lm["s"]
    return out


def init_quantized_llama_params(generator: torch.Generator, cfg: LlamaConfig,
                                mode: str = "int8", dtype=torch.bfloat16,
                                device="cuda", group: int = 128) -> dict:
    """Random-init and weight-quantize on the host, then move only the
    quantized tree to `device` (JAX `init_quantized_llama_params`): the
    full-precision weights never occupy the card. The draws are
    `init_llama_params`' own, so the result equals quantizing after
    `init_llama_params`."""
    params = init_llama_params(generator, cfg, dtype, "cpu")
    q = quantize_llama_weights(params, mode=mode, group=group)
    del params
    return _to_device(q, device)


def _to_device(tree: dict, device) -> dict:
    return {k: (_to_device(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in tree.items()}


def pad_llama_ffn(params: dict, new_I: int) -> dict:
    """Zero-pad the FFN width of full-precision Llama params to new_I (JAX
    `pad_llama_ffn`): w_gate and w_up gain zero output columns, w_down zero
    input rows, exact through SwiGLU (silu(0) * 0 adds nothing). Serves
    weights on the int4w8 padded geometry (engine `weight_quant_plan`);
    pad before quantizing so the scale groups come out uniform."""
    b = dict(params["blocks"])
    old_I = b["w_gate"].shape[-1]
    if new_I == old_I:
        return params
    if new_I < old_I:
        raise ValueError(f"pad_llama_ffn: {old_I} -> {new_I} shrinks the FFN")
    pad = new_I - old_I
    b["w_gate"] = torch.nn.functional.pad(b["w_gate"], (0, pad))
    b["w_up"] = torch.nn.functional.pad(b["w_up"], (0, pad))
    b["w_down"] = torch.nn.functional.pad(b["w_down"], (0, 0, 0, pad))
    out = dict(params)
    out["blocks"] = b
    return out


def llama_spec(cfg: LlamaConfig):
    from .registry import ModelSpec

    return ModelSpec(
        name="llama",
        config=cfg,
        forward=partial(_llama_forward, cfg),
        vocab_size=cfg.vocab_size,
        n_positions=cfg.n_positions,
        n_layer=cfg.n_layer,
        n_head=cfg.n_head,
        head_dim=cfg.head_dim,
        n_kv_head=cfg.n_kv_head,
    )


def _llama_forward(cfg, params, tokens, positions, cache, strategy, seq_mask=None):
    return llama_forward(params, cfg, tokens, positions, cache, strategy, seq_mask)
