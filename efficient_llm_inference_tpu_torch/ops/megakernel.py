"""Whole-step GPT-2 decode: one persistent CUDA kernel per batch-1 step.

Port of efficient_llm_inference_tpu/ops/pallas/megakernel.py
(gpt2_megastep, gpt2_megaverify, to_mega_layout, mega_supported,
pack_gpt2_mega). The TPU program streams every weight through a VMEM ring;
on the H100 the step is one cooperative kernel from `csrc/gpt2_megastep.cu`
(every block resident, its phases separated by grid barriers, its weight
stream running through them), launched by one host call (`gpt2_megastep`)
and, in the engine's decode loop, captured once into a CUDA graph
(`MegaDecodeGraph`) that replays all N steps of a generation. The
quantized-KV variant (ops/megakernel_quant.py) shares this module's packing,
launcher and graph. The speculative verify pass (`gpt2_megaverify`: R <= 8
rows of one sequence, in-block causal) is the chain of `csrc/megaverify.cu`
over the same packing.

Layouts:

* KV panes are [L, C, E] (`to_mega_layout` converts the prefill's
  [L, 1, H, C, D] buffer once per generation), so a cache row of one layer is
  one contiguous E-vector.
* `pack_gpt2_mega` stores every weight as [out, in] row-major (the transpose
  of the HF Conv1D [in, out] layout), so one warp reads one output's whole
  input row with 16-byte loads; the LM head is `wte` itself ([V, E] is
  already [out, in]). Per-layer biases and layer-norm parameters are the JAX
  package's fp32 `smalls` [L, 13, E] (rows: 0 ln1_g, 1 ln1_b, 2 ln2_g,
  3 ln2_b, 4-6 attn_b, 7 proj_b, 8-11 fc_b, 12 fc_proj_b) and `lnf` [2, E].

Weight tiers (the JAX packed dict's "wscale" / "w4scale" modes; the serving
mode `Config.weight_quant`): params from `models.gpt2.quantize_gpt2_weights`
pack into the same row-major [out, in] rows, of codes instead of values:

* int8: int8 rows [out, in] and fp32 per-output-channel scales [out]
  (`<name>_s`); y = (sum_k x_k q[n, k]) * s[n] with fp32 sums, the scale
  applied before the bias and the LM head's argmax compare;
* grouped int4: uint8 rows [out, in / 2] holding the model's own nibble
  order (byte j: input 2j in the low nibble, 2j + 1 in the high, two's
  complement; JAX `quantize_int4_weights` transposed), and one scale per
  (output, group of G inputs) [out, in / G] rounded to the model dtype (the
  JAX packer's `.astype(dtype)`): y = sum over groups of
  (sum_k x_k v[n, k]) * s[n, g] with fp32 sums. This is the JAX kernel's
  int4w8 form (raw nibble dots, the fp32 sums scaled) for every G; JAX's
  grouped form, which rounds each dequantized weight v * s to the model
  dtype before the dot, is not kept (in fp32 the two agree to rounding).

The LM head of a quantized model is its quantized copy (`lm_q` / `lm_q4`,
exactly V rows: no padding to carry); the embedding lookup stays on `wte`.
Every chain streams the tiers from the same packing: the single-stream
steps (#9 here and #11 through the persistent step's ring of tiles, #12
and #13 at R = 1 through `csrc/gemv_stream.cuh`), the verify passes (#10
here, #13 at R > 1), the batched steps (#14-#17) and the batched verifies
(#18-#21) through the batched GEMV (`csrc/gemv_batch.cuh`, bf16 ones on
the tensor-core routes); each wrapper counts a tier's launches in
`<wrapper>.tiers[kind]`.

Numerics follow the JAX kernel's rounding points: layer-norm statistics in
fp32; the LN output, q, k, v, the attention output, the GELU output and each
residual add in the model dtype; matmuls accumulate in fp32 with the bias
added in fp32 before the cast; fp32 softmax with the current token merged
into the same softmax as the cached rows t < length; greedy argmax over the
fp32 logits, first maximum wins.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..models.gpt2 import _unpack_nibbles
from . import _build

NEG_INF = float(torch.finfo(torch.float32).min)
GELU_C = 0.7978845608028654
WEIGHT_NAMES = ("attn_w", "attn_proj_w", "fc_w", "fc_proj_w")
# Kernel limits beyond the JAX package's eligibility: the attention kernel's
# head templates, and the scores of one head (32 KB) in shared memory.
HEAD_DIMS = (64, 128)
MAX_CAPACITY = 8192
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# KV storage kinds as the kernels name them: 0 = the model dtype, 8 = int8
# codes, 4 = int4 codes packed in half-split pairs.
KIND_CODE = {"fp": 0, "int8": 8, "int4": 4}
# (max, argmax) partials a row of the LM head: one a block of the largest
# grid an LM-head GEMV launches (gemm_rows_tc.cuh's 1002 tiles of Llama-3's
# vocabulary; the persistent GPT-2 step's one block an SM).
LM_PARTS = 1056
# The persistent GPT-2 step's plan (csrc/gpt2_megastep.cu kThreads,
# kRowsPer): the threads of a block, a layer phase's rows a thread's
# epilogue takes, and the attention items a layer its split plan aims at.
STEP_THREADS = 256
STEP_ROWS_PER = 4
ATTN_ITEMS = 128
ATTN_MIN_ROWS = 32


def to_mega_layout(buf: torch.Tensor) -> torch.Tensor:
    """[L, 1, H, C, D] cache pane -> [L, C, E] kernel layout (a copy)."""
    L, B, H, C, D = buf.shape
    if B != 1:
        raise ValueError("the megakernel is single-stream (batch 1)")
    return buf[:, 0].permute(0, 2, 1, 3).reshape(L, C, H * D)


# Weight tiers of the kernels (csrc/megastep_common.cuh W_T / W_I8 / W_I4).
WEIGHT_CODE = {"fp": 0, "int8": 8, "int4": 4}
# The int4 tier reads 32 codes (16 bytes) a load, all in one scale group.
INT4_CHUNK = 32


def _full_precision_dtype(params: dict) -> Optional[torch.dtype]:
    """The weights' dtype when every block weight is one full-precision
    tensor type the kernels take, else None (the JAX package's "f" weight
    mode)."""
    b = params.get("blocks", {})
    dts = set()
    for n in WEIGHT_NAMES:
        w = b.get(n)
        if not isinstance(w, torch.Tensor):
            return None
        dts.add(w.dtype)
    wte = params.get("wte")
    if not isinstance(wte, torch.Tensor):
        return None
    dts.add(wte.dtype)
    if len(dts) != 1:
        return None
    dt = dts.pop()
    return dt if dt in _DTYPE_CODE else None


def weight_mode(b: dict, names) -> Optional[str]:
    """"f" | "int8" | "int4" when the block weights `names` are uniform, else
    None (JAX `_gpt2_weight_mode` / megakernel_llama `_weight_mode`): a
    partly quantized tree has no mode."""
    kinds = set()
    for n in names:
        w = b.get(n)
        if isinstance(w, dict):
            if "q" in w:
                kinds.add("int8")
            elif "q4" in w:
                kinds.add("int4")
            else:
                return None
        else:
            kinds.add("f")
    return kinds.pop() if len(kinds) == 1 else None


def weight_quantized(params: dict) -> bool:
    """Does a GPT-2 or Llama/Qwen param tree carry quantized weights (a
    quantized block weight, or a quantized LM-head copy)?"""
    return ("lm_q" in params or "lm_q4" in params
            or any(isinstance(w, dict) for w in params.get("blocks", {}).values()))


def _gpt2_weight_mode(b: dict) -> Optional[str]:
    return weight_mode(b, WEIGHT_NAMES)


def _q4_group(d: dict) -> int:
    """The group of a {"q4", "s"} weight (models.gpt2.quantize_int4_weights)."""
    return 2 * d["q4"].shape[-2]


def _gpt2_int4_group(params: dict) -> int:
    """The int4 group shared by every block weight and the LM head, or 0."""
    b = params["blocks"]
    gs = {_q4_group(b[n]) for n in WEIGHT_NAMES}
    if "lm_q4" in params:
        gs.add(_q4_group({"q4": params["lm_q4"]}))
    return gs.pop() if len(gs) == 1 else 0


def _tier_ok(params: dict, mode: Optional[str], dtype) -> bool:
    """The weight tier's own gates, shared by both families: a mode, the
    quantized LM-head copy of a quantized tree, and a model dtype the
    kernels take (the full-precision tensors' dtype: `dtype`)."""
    if mode is None:
        return False
    if mode == "int8" and "lm_q" not in params:
        return False
    if mode == "int4" and "lm_q4" not in params:
        return False
    return dtype in _DTYPE_CODE


def _int4_group_ok(G: int) -> bool:
    """The kernels' limit on an int4 group beyond JAX's: whole 16-byte loads
    of 32 codes in one group (G % 32 == 0)."""
    return G > 0 and G % INT4_CHUNK == 0


def _weights_ok(cfg, params: dict, kernels: bool = True) -> bool:
    """The JAX package's weight gates (uniform weights: full precision,
    int8 with `lm_q`, or grouped int4 with `lm_q4` at one group G with
    E % G == 0, (E/2) % G == 0 and E % 16 == 0) and, with `kernels`, the
    kernels' G % 32."""
    b = params.get("blocks", {})
    mode = _gpt2_weight_mode(b)
    wte = params.get("wte")
    dtype = (_full_precision_dtype(params) if mode == "f"
             else wte.dtype if isinstance(wte, torch.Tensor) else None)
    if not _tier_ok(params, mode, dtype):
        return False
    if mode == "int4":
        E, G = cfg.n_embd, _gpt2_int4_group(params)
        if G == 0 or E % G or (E // 2) % G or E % 16 or (kernels and not _int4_group_ok(G)):
            return False
    return True


def mega_supported(cfg, capacity: int, params: dict) -> bool:
    """Can the megakernel run this geometry? The JAX package's eligibility
    (the weight gates of `_weights_ok`, E % 128 == 0, capacity % 8 == 0)
    plus the kernels' own limits: head_dim 64 or 128, capacity <= 8192,
    and an int4 group G % 32 == 0. The JAX package's VMEM budget is a TPU
    limit and is not carried over."""
    return _weights_ok(cfg, params) and _geometry_ok(cfg, capacity)


def jax_structure_ok(cfg, capacity: int, params: dict) -> bool:
    """The JAX package's eligibility without its VMEM budget (its weight
    gates, E % 128 == 0, capacity % 8 == 0): what decides the JAX engine's
    routes for a speculative draft."""
    return (_weights_ok(cfg, params, kernels=False) and cfg.n_embd % 128 == 0
            and capacity % 8 == 0)


def _geometry_ok(cfg, capacity: int) -> bool:
    return (cfg.n_embd % 128 == 0 and capacity % 8 == 0
            and cfg.head_dim in HEAD_DIMS and 0 < capacity <= MAX_CAPACITY)


def pack_rows(w, dtype) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One [..., K, F] weight -> (rows [..., F, K] as the kernels stream
    them, scales): a full-precision tensor transposes (no scales); {"q", "s"}
    gives int8 rows and fp32 scales [..., F]; {"q4", "s"} gives uint8 rows
    [..., F, K/2] in the codes' own byte order and scales [..., F, K/G] in
    `dtype`."""
    if not isinstance(w, dict):
        return w.transpose(-1, -2).contiguous(), None
    if "q" in w:
        return w["q"].transpose(-1, -2).contiguous(), w["s"][..., 0, :].float().contiguous()
    q4, s = w["q4"], w["s"]
    *lead, Kg, Gh, F = q4.shape
    rows = q4.reshape(*lead, Kg * Gh, F).transpose(-1, -2).contiguous()
    return rows, s[..., 0, :].transpose(-1, -2).to(dtype).contiguous()


def lm_rows(params: dict, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The quantized LM-head copy (`lm_q`/`lm_s` or `lm_q4`/`lm_s4`, [E, V])
    as [V, ...] rows and scales (`pack_rows`)."""
    if "lm_q" in params:
        return pack_rows({"q": params["lm_q"], "s": params["lm_s"]}, dtype)
    return pack_rows({"q4": params["lm_q4"], "s": params["lm_s4"]}, dtype)


# Packed tensors every kernel reads in fp32 whatever the model dtype.
FP32_KEYS = ("smalls", "lnf", "norms", "qkvb", "cos", "sin")


def cast_packed(packed: dict, dtype) -> dict:
    """A copy of packed weights (`pack_gpt2_mega` / `pack_llama_mega`) for
    kernels in `dtype`: every tensor they read in the model dtype cast to
    it (the full-precision weights, the embeddings, the int4 group scales),
    the fp32 ones (FP32_KEYS, the int8 row scales) and the codes as they
    are. The JAX batched kernels cast each weight tile to the panes' dtype
    and keep their smalls fp32 (the server's pools apart from the
    weights')."""
    int4 = weight_kind(packed) == "int4"
    out = {}
    for key, t in packed.items():
        if t.is_floating_point() and key not in FP32_KEYS and (int4 or not key.endswith("_s")):
            t = t.to(dtype).contiguous()
        out[key] = t
    return out


def scale_key(name: str) -> str:
    """The packed key of a weight's scales: "attn_w" -> "attn_s", "head" ->
    "head_s"."""
    return name[:-2] + "_s" if name.endswith("_w") else name + "_s"


def weight_kind(packed: dict) -> str:
    """The weight tier of a packed dict: "fp", "int8" or "int4" (the port's
    counterpart of JAX's "wscale" / "w4scale" keys)."""
    if "head_s" not in packed:
        return "fp"
    return "int8" if packed["head"].dtype == torch.int8 else "int4"


def weight_group(packed: dict, name: str) -> int:
    """The int4 group of packed weight `name` ([.., N, K/2] bytes, [.., N,
    K/G] scales); 0 for the other tiers."""
    s = packed.get(scale_key(name))
    if s is None or packed[name].dtype != torch.uint8:
        return 0
    return 2 * packed[name].shape[-1] // s.shape[-1]


def pack_gpt2_mega(params: dict, cfg) -> Optional[dict]:
    """Re-layout GPT-2 params for the kernels (once per engine); None when
    the params are not packable (see `mega_supported`). Quantized weights
    pack into code rows with `<name>_s` scales and a `head` / `head_s` LM
    head (`pack_rows`); `wte` and `wpe` stay for the embedding."""
    if cfg.n_embd % 128 != 0 or not _weights_ok(cfg, params):
        return None
    b = params["blocks"]
    E, L = cfg.n_embd, cfg.n_layer
    dtype = params["wte"].dtype

    def rows(x, n):
        return x.float().reshape(L, n, E)

    smalls = torch.cat([
        rows(b["ln1_g"], 1), rows(b["ln1_b"], 1),
        rows(b["ln2_g"], 1), rows(b["ln2_b"], 1),
        rows(b["attn_b"], 3), rows(b["attn_proj_b"], 1),
        rows(b["fc_b"], 4), rows(b["fc_proj_b"], 1),
    ], dim=1).contiguous()
    lnf = torch.stack([params["lnf_g"].float(), params["lnf_b"].float()])
    packed = {
        "wte": params["wte"].contiguous(),  # [V, E]: the LM head too (fp)
        "wpe": params["wpe"].contiguous(),
        "smalls": smalls,
        "lnf": lnf.contiguous(),
    }
    # [L, in, out] -> [L, out, in] rows: attn_w [L, 3E, E], proj_w [L, E, E],
    # fc_w [L, 4E, E], fcp_w [L, E, 4E]
    for key, name in (("attn_w", "attn_w"), ("proj_w", "attn_proj_w"),
                      ("fc_w", "fc_w"), ("fcp_w", "fc_proj_w")):
        packed[key], scales = pack_rows(b[name], dtype)
        if scales is not None:
            packed[scale_key(key)] = scales
    if _gpt2_weight_mode(b) != "f":
        packed["head"], packed["head_s"] = lm_rows(params, dtype)
    return packed


# ---------------------------------------------------------------------------
# Plain PyTorch version of the step (any device; the CPU tests' reference and
# the card's yardstick).


def _ln(x32, g, b, eps):
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + eps) * g + b


def _mv(h, w):
    """h [K] (model dtype) @ w[N, K]^T -> fp32 [N], accumulated in fp32."""
    return torch.mv(w.float(), h.float())


def int4_rows_dot(h, w, s):
    """h [K] (model dtype) times grouped-int4 rows w (uint8 [N, K/2], byte j
    = input 2j low nibble | 2j + 1 high nibble) with scales s [N, K/G] ->
    fp32 [N]: per group the fp32 sum of h times the raw signed codes, times
    the group's scale, summed over the groups (the kernels' int4 tier)."""
    N, K = w.shape[0], 2 * w.shape[1]
    v = torch.stack(_unpack_nibbles(w), dim=-1).reshape(N, K)  # inputs 2j, 2j + 1
    ng = s.shape[-1]
    sums = torch.einsum("ngk,gk->ng", v.float().reshape(N, ng, K // ng),
                        h.float().reshape(ng, K // ng))
    return (sums * s.float()).sum(-1)


def wmv(h, packed: dict, name: str, layer: Optional[int] = None):
    """h [K] (model dtype) times the rows of packed weight `name` (of layer
    `layer`) -> fp32 [N], in the arithmetic of its tier: full precision
    (`_mv`), int8 (fp32 sums times the row's scale) or grouped int4
    (`int4_rows_dot`)."""
    w = packed[name] if layer is None else packed[name][layer]
    s = packed.get(scale_key(name))
    if s is None:
        return _mv(h, w)
    s = s if layer is None else s[layer]
    if w.dtype == torch.int8:
        return _mv(h, w) * s
    return int4_rows_dot(h, w, s)


def plain_step(packed: dict, cfg, x_emb: torch.Tensor, attend):
    """The layer chain of one decode step, shared by both plain versions.

    `attend(layer, q, k, v)` gets the current token's q/k/v in the model
    dtype ([E] each) and returns the attention output [E] in fp32. Returns
    (logits fp32 [V], new K rows [L, E], new V rows [L, E]) in the model
    dtype; the caller writes the rows to row `length` (after the last layer,
    as the JAX kernel does).
    """
    E, L = cfg.n_embd, cfg.n_layer
    eps = cfg.layer_norm_epsilon
    dt = x_emb.dtype
    x = x_emb.reshape(E)
    new_k, new_v = [], []
    for layer in range(L):
        sm = packed["smalls"][layer]
        h = _ln(x.float(), sm[0], sm[1], eps).to(dt)
        qkv = (wmv(h, packed, "attn_w", layer) + sm[4:7].reshape(-1)).to(dt)
        q, k, v = qkv.split(E)
        a = attend(layer, q, k, v).to(dt)
        x = x + (wmv(a, packed, "proj_w", layer) + sm[7]).to(dt)
        h2 = _ln(x.float(), sm[2], sm[3], eps).to(dt)
        m = wmv(h2, packed, "fc_w", layer) + sm[8:12].reshape(-1)
        g = (0.5 * m * (1.0 + torch.tanh(GELU_C * (m + 0.044715 * m ** 3)))).to(dt)
        x = x + (sm[12] + wmv(g, packed, "fcp_w", layer)).to(dt)
        new_k.append(k)
        new_v.append(v)
    xf = _ln(x.float(), packed["lnf"][0], packed["lnf"][1], eps).to(dt)
    logits = wmv(xf, packed, "head" if "head" in packed else "wte")
    return logits, torch.stack(new_k), torch.stack(new_v)


def attend_plain(q, kc, vc, k_l, v_l, length: int, n_kv_head: int):
    """Decode attention of one layer over fp panes, in fp32: the query heads
    q [Hq*D] (grouped onto n_kv_head K/V heads) over the pane rows
    t < length of k_l/v_l [C, Hkv*D], with the current token's kc/vc
    [Hkv*D] merged into the same softmax. Returns [Hq*D] fp32."""
    C = k_l.shape[0]
    G, D = q.numel() // kc.numel(), kc.numel() // n_kv_head
    scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(n_kv_head, G, D)
    visible = torch.arange(C, device=k_l.device) < length
    scores = torch.einsum("ckd,kgd->kgc", k_l.float().reshape(C, n_kv_head, D), qf)
    scores = torch.where(visible, scores * scale, NEG_INF)
    s_cur = (kc.float().reshape(n_kv_head, 1, D) * qf).sum(-1, keepdim=True) * scale
    mx = torch.maximum(scores.amax(-1, keepdim=True), s_cur)
    p = torch.exp(scores - mx)
    p_cur = torch.exp(s_cur - mx)
    denom = p.sum(-1, keepdim=True) + p_cur
    ao = torch.einsum("kgc,ckd->kgd", p, v_l.float().reshape(C, n_kv_head, D))
    ao = ao + p_cur * vc.float().reshape(n_kv_head, 1, D)
    return (ao / denom).reshape(-1)


def gpt2_megastep_plain(packed: dict, k: torch.Tensor, v: torch.Tensor,
                        length, x_emb: torch.Tensor, *, cfg,
                        return_logits: bool = False):
    """Plain PyTorch version of `gpt2_megastep`, the same function on any
    device: returns (token int32 [], k, v), with row `length` of every
    layer of k/v written in place; with `return_logits`, the fp32 logits
    [V] that chose the token come fourth."""
    C = k.shape[1]
    cur = int(length)

    def attend(layer, q, kc, vc):
        return attend_plain(q, kc, vc, k[layer], v[layer], cur, cfg.n_head)

    logits, new_k, new_v = plain_step(packed, cfg, x_emb, attend)
    if cur < C:
        k[:, cur] = new_k.to(k.dtype)
        v[:, cur] = new_v.to(v.dtype)
    tok = torch.argmax(logits).to(torch.int32)
    return (tok, k, v, logits) if return_logits else (tok, k, v)


# ---------------------------------------------------------------------------
# The kernels: arguments, launcher, CUDA graph of a decode loop.


def tier_fields(scales) -> list:
    """The weight-tier fields that end every chain's args struct: the tier
    (0 = model dtype, 8 = int8, 4 = grouped int4), the int4 group, then one
    pointer a name (code rows or scales; null for the fp tier)."""
    return ([("w_kind", ctypes.c_int), ("w_group", ctypes.c_int)]
            + [(n, ctypes.c_void_p) for n in scales])


class MegaStepArgs(ctypes.Structure):
    """Mirror of `struct MegaArgs` in csrc/gpt2_megastep.cu (same order): the
    fields the batched and verify structs repeat after their leading rows /
    batch, ending with the weight tier: the LM head's code rows (`head`;
    null: wte is the head) and each weight's scales."""

    _fields_ = [
        ("dtype", ctypes.c_int),
        ("n_layer", ctypes.c_int),
        ("n_embd", ctypes.c_int),
        ("n_head", ctypes.c_int),
        ("vocab", ctypes.c_int),
        ("n_pos", ctypes.c_int),
        ("capacity", ctypes.c_int),
        ("k_kind", ctypes.c_int),
        ("v_kind", ctypes.c_int),
        ("advance", ctypes.c_int),
        ("lm_blocks", ctypes.c_int),
        ("ln_eps", ctypes.c_float),
        ("quant_eps", ctypes.c_float),
        ("attn_w", ctypes.c_void_p),
        ("proj_w", ctypes.c_void_p),
        ("fc_w", ctypes.c_void_p),
        ("fcp_w", ctypes.c_void_p),
        ("wte", ctypes.c_void_p),
        ("wpe", ctypes.c_void_p),
        ("smalls", ctypes.c_void_p),
        ("lnf", ctypes.c_void_p),
        ("k", ctypes.c_void_p),
        ("v", ctypes.c_void_p),
        ("ks", ctypes.c_void_p),
        ("vs", ctypes.c_void_p),
        ("length", ctypes.c_void_p),
        ("tok_in", ctypes.c_void_p),
        ("x_emb", ctypes.c_void_p),
        ("tok_out", ctypes.c_void_p),
        ("x", ctypes.c_void_p),
        ("qkv", ctypes.c_void_p),
        ("attn", ctypes.c_void_p),
        ("ffn", ctypes.c_void_p),
        ("lm_val", ctypes.c_void_p),
        ("lm_idx", ctypes.c_void_p),
    ] + tier_fields(("head", "attn_s", "proj_s", "fc_s", "fcp_s", "head_s"))


class Gpt2StepArgs(MegaStepArgs):
    """Mirror of `struct Gpt2StepArgs` in csrc/gpt2_megastep.cu: the
    single-stream step's `MegaStepArgs`, then its grid, its split
    attention's plan (`attention_plan`) and its launcher's scratch
    (`step_scratch`)."""

    _fields_ = [("grid", ctypes.c_int), ("attn_splits", ctypes.c_int),
                ("attn_rows", ctypes.c_int), ("attn_part", ctypes.c_void_p),
                ("sync", ctypes.c_void_p)]


_lib = None


def kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("gpt2_megastep")
        for fn in (lib.elit_gpt2_megastep, lib.elit_gpt2_megastep_quant,
                   lib.elit_gpt2_megastep_skeleton):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(Gpt2StepArgs), ctypes.c_void_p]
        lib.elit_gpt2_megastep_grid.restype = ctypes.c_int
        lib.elit_gpt2_megastep_grid.argtypes = [
            ctypes.POINTER(Gpt2StepArgs), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.elit_gpt2_megastep_kernels.restype = ctypes.c_longlong
        lib.elit_gpt2_megastep_kernels.argtypes = []
        _lib = lib
    return _lib


def step_kernels() -> int:
    """Kernels the GPT-2 single-stream step has launched in this process
    (csrc/gpt2_megastep.cu counts each launch): one a step."""
    return int(kernels().elit_gpt2_megastep_kernels())


# ---------------------------------------------------------------------------
# The persistent step's plan: the launcher's part of it (the C side sizes
# its ring and shared memory; tests/test_torch_gpt2_step_plan.py models both).


def attention_plan(capacity: int, n_head: int) -> Tuple[int, int]:
    """(splits, rows) of the persistent step's split-KV attention: the
    capacity cut into `splits` runs of `rows` rows (a multiple of 8, at
    least ATTN_MIN_ROWS), about ATTN_ITEMS (head, split) items a layer. A
    function of the capacity and the head count alone, never of the grid,
    so a step's bits are the same at every grid size, and of the capacity,
    not the length, so a captured graph serves every length."""
    rows = max(ATTN_MIN_ROWS, -(-capacity * n_head // ATTN_ITEMS))
    rows = -(-rows // 8) * 8
    return -(-capacity // rows), rows


def min_grid(n_embd: int) -> int:
    """The least grid the step takes: a block's rows of fc (4E) at most
    STEP_ROWS_PER a thread."""
    return -(-4 * n_embd // (STEP_ROWS_PER * STEP_THREADS))


def step_scratch(cfg, capacity: int) -> dict:
    """The persistent step's plan and scratch sizes: the attention's splits
    and rows, its partials (`part` fp32: (m, l, acc[D]) a head and split)
    and the zeroed counters (`sync` int32: the grid barrier, the LM head's
    ticket, a finished-split count a head), which every launch leaves as it
    found them."""
    splits, rows = attention_plan(capacity, cfg.n_head)
    return {"splits": splits, "rows": rows,
            "part": cfg.n_head * splits * (cfg.head_dim + 2), "sync": 2 + cfg.n_head}


def check_weights(packed: dict, weights: dict, kind: str, dtype, device) -> int:
    """Checks the packed weights `weights` ({name: (..., N, K)}) of tier
    `kind` against their shapes: rows of the model dtype, int8 rows with
    fp32 scales [..., N], or int4 rows [..., N, K/2] with scales
    [..., N, K/G] in the model dtype at one group G (K % G == 0,
    G % 32 == 0). Returns G (0 for the other tiers)."""
    group = weight_group(packed, "head") if kind == "int4" else 0
    for name, shape in weights.items():
        *lead, N, K = shape
        if kind == "fp":
            _check(name, packed[name], dtype, shape, device)
        elif kind == "int8":
            _check(name, packed[name], torch.int8, shape, device)
            _check(scale_key(name), packed[scale_key(name)], torch.float32,
                   (*lead, N), device)
        else:
            if not _int4_group_ok(group) or K % group:
                raise NotImplementedError(f"{name}: int4 group {group} for {K} inputs "
                                          f"(the kernels take G % {INT4_CHUNK} == 0)")
            _check(name, packed[name], torch.uint8, (*lead, N, K // 2), device)
            _check(scale_key(name), packed[scale_key(name)], dtype,
                   (*lead, N, K // group), device)
    return group


def set_tier(args, packed: dict, weights, kind: str, group: int) -> None:
    """Fills the weight-tier fields of a single-stream args struct for a
    quantized tier (the fp tier leaves them zero)."""
    args.w_kind, args.w_group = WEIGHT_CODE[kind], group
    args.head = packed["head"].data_ptr()
    for name in weights:
        setattr(args, scale_key(name), packed[scale_key(name)].data_ptr())


class TierCount:
    """The launch count of one weight tier of a kernel wrapper
    (`<wrapper>.tiers[kind].launches`): the tiers share the wrapper and are
    counted apart from its full-precision launches."""

    def __init__(self):
        self.launches = 0


def tier_counts() -> dict:
    """A wrapper's `tiers`: one `TierCount` a quantized tier."""
    return {"int8": TierCount(), "int4": TierCount()}


def launch_counter(wrapper, packed: dict):
    """What counts a launch of `wrapper` over `packed`: the wrapper itself
    for full-precision weights, else its tier's `TierCount`."""
    kind = weight_kind(packed)
    return wrapper if kind == "fp" else wrapper.tiers[kind]


class Workspace:
    """Scratch of one step, preallocated so a captured step allocates
    nothing: the residual stream x, q|k|v, the attention and MLP activations
    (model dtype, of the given widths) and the LM head's per-block (max,
    argmax) partials, LM_PARTS a row (one a block of the LM head); each once
    per row (slot) of the step. The single-stream steps add their split
    attention's scratch (`step_scratch`; ops/megakernel_llama.py
    `attention_scratch`): the partials (`attn_part`, `part` fp32) and
    counters (`attn_count`, `count` int32, zeroed: each launch leaves them
    zero; a count a K/V head, and for GPT-2's persistent step first its
    grid barrier and its LM head's ticket); Llama's adds the step's RoPE
    rows (`rope`, `rope` fp32)."""

    def __init__(self, dtype: torch.dtype, device, *, x: int,
                 qkv: int, attn: int, ffn: int, rows: int = 1,
                 part: int = 0, count: int = 0, rope: int = 0):
        self.n_lm = LM_PARTS
        f32 = dict(dtype=torch.float32, device=device)
        self.attn_part = torch.empty(part, **f32) if part else None
        self.attn_count = (torch.zeros(count, dtype=torch.int32, device=device)
                           if count else None)
        self.rope = torch.empty(rope, **f32) if rope else None
        self.x = torch.empty(rows * x, dtype=dtype, device=device)
        self.qkv = torch.empty(rows * qkv, dtype=dtype, device=device)
        self.attn = torch.empty(rows * attn, dtype=dtype, device=device)
        self.ffn = torch.empty(rows * ffn, dtype=dtype, device=device)
        self.lm_val = torch.empty(rows * self.n_lm, dtype=torch.float32, device=device)
        self.lm_idx = torch.empty(rows * self.n_lm, dtype=torch.int32, device=device)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _slots(launcher, k: torch.Tensor) -> tuple:
    """(B, lead dims of the panes) of a launcher: single-stream panes are
    [L, C, W], a batched launcher's [L, B, C, W] with
    1 <= B <= launcher.max_rows."""
    if k.dim() != 3 + launcher.batched:
        raise ValueError(f"k: {k.dim()}-d panes for a "
                         f"{'batched' if launcher.batched else 'single-stream'} step")
    if not launcher.batched:
        return 1, ()
    B = k.shape[1]
    if not 1 <= B <= launcher.max_rows:
        raise NotImplementedError(f"batched megakernel: batch {B} outside "
                                  f"1..{launcher.max_rows}")
    return B, (B,)


class StepLauncher:
    """The prepared arguments of one configuration's step; `launch()` issues
    the step on the current stream and allocates nothing, so it can be
    captured. `tok_in`/`tok_out`/`length` are device int32 tensors: the
    step reads the current token (or `x_emb`) and `length` on the device.
    GPT-2's single-stream step (`Gpt2StepArgs`) is one cooperative kernel
    of `grid` blocks: all the card holds at once, queried here, or the
    `grid` given (tests: a step's bits do not depend on it); its launcher
    keeps the step's attention partials and zeroed counters (`scratch`). A
    subclass with `batched = True` (ops/megakernel_batch.py) takes
    [L, B, C, W] panes, [B] tokens and lengths and a [B, E] x_emb, and
    passes B in its args struct (GPT-2's batched step, a Gpt2StepArgs with
    B last, is a persistent kernel too); the verify and other batched
    launchers issue their chains of kernels."""

    entry = {False: "elit_gpt2_megastep", True: "elit_gpt2_megastep_quant"}
    grid_entry = "elit_gpt2_megastep_grid"  # the persistent kernel's blocks an SM
    args_type = Gpt2StepArgs
    batched = False
    max_rows = 1
    lead_field = None  # a persistent struct's last field: its row count (batch, rows)
    launched = 0  # launch() calls: launches, or launches recorded into a CUDA graph

    def scratch(self, cfg, capacity: int, B: int) -> dict:
        """The persistent step's plan and scratch sizes (`step_scratch`)."""
        return step_scratch(cfg, capacity)

    def least_grid(self, n_embd: int) -> int:
        """The least grid the persistent step takes (`min_grid`)."""
        return min_grid(n_embd)

    def layout(self, k, rows: Optional[int]) -> tuple:
        """(token rows B, lead dims of the panes, entries of `length`, the
        args struct's leading fields): a step has one row per slot; a verify
        launcher overrides it (R rows of one sequence)."""
        B, lead = _slots(self, k)
        return B, lead, B, lead

    def __init__(self, packed: dict, cfg, k, v, length, tok_out, *,
                 x_emb=None, tok_in=None, ks=None, vs=None,
                 k_kind: str = "fp", v_kind: str = "fp",
                 quant_eps: float = 1e-8, advance: bool = False,
                 rows: Optional[int] = None, grid: Optional[int] = None):
        B, lead, n_len, prefix = self.layout(k, rows)
        E, L, C = cfg.n_embd, cfg.n_layer, k.shape[-2]
        dtype = packed["wte"].dtype
        wkind = weight_kind(packed)
        dev = k.device
        if dev.type != "cuda":
            raise ValueError(f"no kernel for device {dev}")
        if dtype not in _DTYPE_CODE or not _geometry_ok(cfg, C):
            raise NotImplementedError(
                f"megakernel: E={E}, head_dim={cfg.head_dim}, capacity={C}")
        if (x_emb is None) == (tok_in is None):
            raise ValueError("give exactly one of x_emb and tok_in")
        V, P = cfg.vocab_size, cfg.n_positions
        weights = {"attn_w": (L, 3 * E, E), "proj_w": (L, E, E), "fc_w": (L, 4 * E, E),
                   "fcp_w": (L, E, 4 * E)}
        if wkind != "fp":
            weights["head"] = (V, E)
        group = check_weights(packed, weights, wkind, dtype, dev)
        for name, shape in (("wte", (V, E)), ("wpe", (P, E))):
            _check(name, packed[name], dtype, shape, dev)
        _check("smalls", packed["smalls"], torch.float32, (L, 13, E), dev)
        _check("lnf", packed["lnf"], torch.float32, (2, E), dev)
        store = {"fp": (dtype, E), "int8": (torch.int8, E), "int4": (torch.int8, E // 2)}
        for name, pane, kind in (("k", k, k_kind), ("v", v, v_kind)):
            dt, width = store[kind]
            _check(name, pane, dt, (L, *lead, C, width), dev)
        if k_kind != "fp" or v_kind != "fp":
            if k_kind == "fp" or v_kind == "fp":
                raise ValueError("quantized K and V panes go together")
            if "int4" in (k_kind, v_kind) and (E // 2) % cfg.head_dim:
                raise NotImplementedError("int4 panes need whole heads per half")
            _check("ks", ks, torch.float32, (L, *lead, C), dev)
            _check("vs", vs, torch.float32, (L, *lead, C), dev)
        _check("length", length, torch.int32, (n_len,), dev)
        _check("tok_out", tok_out, torch.int32, (B,), dev)
        if x_emb is not None:
            _check("x_emb", x_emb.reshape(B * E), dtype, (B * E,), dev)
        else:
            _check("tok_in", tok_in, torch.int32, (B,), dev)
        persistent = issubclass(self.args_type, Gpt2StepArgs)
        plan = self.scratch(cfg, C, B) if persistent else None
        ws = Workspace(dtype, dev, x=E, qkv=3 * E, attn=E, ffn=4 * E, rows=B,
                       **({"part": plan["part"], "count": plan["sync"]} if persistent else {}))
        # keep every tensor the struct points at alive with the launcher
        self._refs = (packed, k, v, ks, vs, length, tok_in, x_emb, tok_out, ws)
        self.x_emb = x_emb
        self.quant = k_kind != "fp"
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        self.args = self.args_type(
            *prefix, _DTYPE_CODE[dtype], L, E, cfg.n_head, V, P, C,
            KIND_CODE[k_kind], KIND_CODE[v_kind], int(advance), ws.n_lm,
            cfg.layer_norm_epsilon, quant_eps,
            ptr(packed["attn_w"]), ptr(packed["proj_w"]), ptr(packed["fc_w"]),
            ptr(packed["fcp_w"]), ptr(packed["wte"]), ptr(packed["wpe"]),
            ptr(packed["smalls"]), ptr(packed["lnf"]),
            ptr(k), ptr(v), ptr(ks), ptr(vs), ptr(length), ptr(tok_in),
            ptr(x_emb), ptr(tok_out),
            ptr(ws.x), ptr(ws.qkv), ptr(ws.attn), ptr(ws.ffn),
            ptr(ws.lm_val), ptr(ws.lm_idx))
        if wkind != "fp":
            set_tier(self.args, packed, weights, wkind, group)
        self.device = dev
        if persistent:
            self.args.attn_splits, self.args.attn_rows = plan["splits"], plan["rows"]
            self.args.attn_part = ws.attn_part.data_ptr()
            self.args.sync = ws.attn_count.data_ptr()
            if self.lead_field is not None:
                setattr(self.args, self.lead_field, B)
            self._set_grid(grid)

    def _set_grid(self, grid: Optional[int]) -> None:
        """The persistent step's grid: every block the card holds at once
        (the kernel's blocks an SM times the SM count, queried once here),
        or `grid` (tests: a step's bits do not depend on it), which must not
        exceed that."""
        per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
        lib = self.library()
        _build.check(lib, getattr(lib, self.grid_entry)(ctypes.byref(self.args),
                                                        ctypes.byref(per_sm),
                                                        ctypes.byref(sms)),
                     self.grid_entry)
        self.per_sm, self.sms = per_sm.value, sms.value
        full = min(self.per_sm * self.sms, LM_PARTS)
        least = self.least_grid(self.args.n_embd)
        if full < least or (grid is not None and not least <= grid <= full):
            raise RuntimeError(f"{self.entry[False]}: a grid of {grid or full} blocks cannot be "
                               f"resident at once or is under {least} ({self.per_sm} a "
                               f"block an SM x {self.sms} SMs, at most {LM_PARTS})")
        self.args.grid = full if grid is None else grid

    def set_tokens(self, tok_in: Optional[torch.Tensor], tok_out: torch.Tensor) -> None:
        """Point the step at other token slots (views of one int32 buffer
        that the launcher's owner keeps alive); tok_in None: a launcher of
        `x_emb` rows keeps them."""
        if tok_in is not None:
            self.args.tok_in = tok_in.data_ptr()
        self.args.tok_out = tok_out.data_ptr()

    def library(self) -> ctypes.CDLL:
        return kernels()

    def launch(self, entry: Optional[str] = None) -> None:
        """Issues the step (or the library's entry point `entry` on the same
        arguments) on the current stream."""
        lib = self.library()
        name = entry or self.entry[self.quant]
        rc = getattr(lib, name)(ctypes.byref(self.args),
                                torch.cuda.current_stream(self.device).cuda_stream)
        if rc != 0 and isinstance(self.args, Gpt2StepArgs):
            _build.check(lib, rc, f"{name} ({self.args.grid} blocks, cooperative; "
                                  f"{self.per_sm} a block an SM x {self.sms} SMs)")
        _build.check(lib, rc, name)
        self.launched += 1


def _length_tensor(length, device) -> torch.Tensor:
    """int32 [n] on `device`: a length (int or tensor) or per-slot lengths."""
    if isinstance(length, torch.Tensor):
        return length.reshape(-1).to(device=device, dtype=torch.int32)
    values = list(length) if isinstance(length, (list, tuple)) else [length]
    return torch.tensor([int(n) for n in values], dtype=torch.int32, device=device)


def gpt2_megastep(packed: dict, k: torch.Tensor, v: torch.Tensor, length,
                  x_emb: torch.Tensor, *, cfg):
    """One whole decode step (greedy, batch 1). Returns (token int32 [],
    k, v).

    packed: `pack_gpt2_mega(params, cfg)`, of full-precision or quantized
    weights; k, v: [L, C, E] panes in the model dtype, written in place at
    row `length` of every layer (the JAX kernel aliases them the same way)
    and returned; length: tokens already
    cached (int or int32 tensor); x_emb: [1, E] token + position embedding
    in the model dtype. On a CUDA tensor it launches the persistent kernel
    of `csrc/gpt2_megastep.cu` (one kernel a step) and counts one launch in
    `gpt2_megastep.launches` (full-precision weights) or
    `gpt2_megastep.tiers["int8" | "int4"].launches`; on a CPU tensor it runs
    `gpt2_megastep_plain`. The capacity is the panes' row count (the JAX
    kernel's static `capacity`).
    """
    if k.device.type == "cpu":
        return gpt2_megastep_plain(packed, k, v, length, x_emb, cfg=cfg)
    tok = torch.empty(1, dtype=torch.int32, device=k.device)
    StepLauncher(packed, cfg, k, v, _length_tensor(length, k.device), tok,
                 x_emb=x_emb.contiguous()).launch()
    launch_counter(gpt2_megastep, packed).launches += 1
    return tok[0], k, v


gpt2_megastep.launches = 0
gpt2_megastep.tiers = tier_counts()


# ---------------------------------------------------------------------------
# The speculative verify pass: R rows of one sequence in one weight stream.

# The verify chains' largest R (csrc/megaverify.cu and csrc/megabatch_verify.cu
# kMaxVerifyRows), the JAX kernels' limit.
MAX_VERIFY_ROWS = 8


def verify_rows_check(k: torch.Tensor, length, R: int) -> None:
    """The JAX verify kernels' limits: 1 <= R <= 8, and, where the length is
    known on the host, capacity >= roundup8(length + R) + 8 (the JAX
    kernels' 16-row write window; the port keeps the rule so capacities and
    results match)."""
    if not 1 <= R <= MAX_VERIFY_ROWS:
        raise NotImplementedError(f"verify of {R} rows: the kernels take "
                                  f"1..{MAX_VERIFY_ROWS}")
    if isinstance(length, torch.Tensor) and length.is_cuda:
        return
    cur, C = int(length), k.shape[-2]
    if C < -(-(cur + R) // 8) * 8 + 8:
        raise ValueError(f"verify of {R} rows at length {cur} needs capacity "
                         f">= roundup8({cur + R}) + 8, got {C}")


def _verify_rows(packed: dict, x: torch.Tensor, cur: int, n_positions: int):
    """[R, E] inputs of the plain verify: `x` itself, or, for token ids, the
    token + position embeddings min(cur + t, P - 1) in the model dtype."""
    if x.is_floating_point():
        return x
    wte, wpe = packed["wte"], packed["wpe"]
    pos = torch.clamp(torch.arange(x.shape[0], device=x.device) + cur, max=n_positions - 1)
    return (wte[x.long()] + wpe[pos]).to(wte.dtype)


def verify_plain(step, packed: dict, k, v, cur: int, rows: torch.Tensor):
    """R plain steps at lengths cur .. cur + R - 1, each writing its row: the
    in-block causal verify (row t attends the cache rows < cur and the verify
    rows j <= t), the same function as one R-row pass. Returns (tokens int32
    [R], fp32 logits [R, V])."""
    toks, logits = [], []
    for t in range(rows.shape[0]):
        out = step(packed, k, v, cur + t, rows[t:t + 1])
        toks.append(out[0])
        logits.append(out[-1])
    return torch.stack(toks), torch.stack(logits)


def gpt2_megaverify_plain(packed: dict, k: torch.Tensor, v: torch.Tensor,
                          length, x: torch.Tensor, *, cfg,
                          return_logits: bool = False):
    """Plain PyTorch version of `gpt2_megaverify`, the same function on any
    device: returns (tokens int32 [R], k, v), rows length .. length + R - 1
    of every layer written in place (none at or past capacity); with
    `return_logits`, the fp32 logits [R, V] come fourth."""
    cur = int(length)
    verify_rows_check(k, cur, x.shape[0])

    def step(pk, kk, vv, n, xr):
        return gpt2_megastep_plain(pk, kk, vv, n, xr, cfg=cfg, return_logits=True)

    toks, logits = verify_plain(step, packed, k, v, cur,
                                _verify_rows(packed, x, cur, cfg.n_positions))
    return (toks, k, v, logits) if return_logits else (toks, k, v)


class GPT2VerifyArgs(Gpt2StepArgs):
    """Mirror of `struct Gpt2VerifyArgs` in csrc/gpt2_megaverify.cu: the
    single stream's `Gpt2StepArgs` over [R]-row tensors (its scratch sized
    by `verify_scratch`), then R."""

    _fields_ = [("rows", ctypes.c_int)]


_verify_lib = None
_gpt2_verify_lib = None


def verify_kernels() -> ctypes.CDLL:
    """csrc/megaverify.cu (the Llama/Qwen verify; its struct is
    ops/megakernel_llama.py's), loaded with its entry points typed."""
    global _verify_lib
    if _verify_lib is None:
        from .megakernel_llama import LlamaVerifyArgs

        lib = _build.load("megaverify")
        lib.elit_llama_megaverify.restype = ctypes.c_int
        lib.elit_llama_megaverify.argtypes = [ctypes.POINTER(LlamaVerifyArgs), ctypes.c_void_p]
        lib.elit_megaverify_kernels.restype = ctypes.c_longlong
        lib.elit_megaverify_kernels.argtypes = []
        _verify_lib = lib
    return _verify_lib


def gpt2_verify_kernels() -> ctypes.CDLL:
    """The library of GPT-2's persistent verify (csrc/gpt2_megaverify.cu)."""
    global _gpt2_verify_lib
    if _gpt2_verify_lib is None:
        lib = _build.load("gpt2_megaverify")
        lib.elit_gpt2_megaverify.restype = ctypes.c_int
        lib.elit_gpt2_megaverify.argtypes = [ctypes.POINTER(GPT2VerifyArgs), ctypes.c_void_p]
        lib.elit_gpt2_megaverify_grid.restype = ctypes.c_int
        lib.elit_gpt2_megaverify_grid.argtypes = [
            ctypes.POINTER(GPT2VerifyArgs), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.elit_gpt2_megaverify_kernels.restype = ctypes.c_longlong
        lib.elit_gpt2_megaverify_kernels.argtypes = []
        _gpt2_verify_lib = lib
    return _gpt2_verify_lib


def verify_step_kernels() -> int:
    """Kernels GPT-2's verify has launched in this process
    (csrc/gpt2_megaverify.cu counts each launch): one a pass."""
    return int(gpt2_verify_kernels().elit_gpt2_megaverify_kernels())


def verify_scratch(cfg, capacity: int, R: int) -> dict:
    """GPT-2's persistent verify: the single stream's attention plan (a
    function of the capacity and the head count alone, so a row's bits do
    not depend on R), the partials of R rows (`part` fp32: [R, H, splits,
    D + 2]) and the zeroed counters (`sync` int32: the grid barrier, the LM
    head's ticket, a finished-split count a head)."""
    splits, rows = attention_plan(capacity, cfg.n_head)
    return {"splits": splits, "rows": rows,
            "part": R * cfg.n_head * splits * (cfg.head_dim + 2), "sync": 2 + cfg.n_head}


class VerifyLayout:
    """The verify launchers' layout: [L, C, W] panes of one sequence, R
    token rows, one length, R first in the args struct; fp panes."""

    def layout(self, k, rows: Optional[int]) -> tuple:
        if k.dim() != 3:
            raise ValueError(f"k: {k.dim()}-d panes for a verify pass")
        if rows is None or not 1 <= rows <= MAX_VERIFY_ROWS:
            raise NotImplementedError(f"verify of {rows} rows: the kernels take "
                                      f"1..{MAX_VERIFY_ROWS}")
        return rows, (), 1, (rows,)

    def library(self) -> ctypes.CDLL:
        return verify_kernels()


class GPT2VerifyLauncher(VerifyLayout, StepLauncher):
    """The prepared arguments of one GPT-2 verify pass (R rows): one
    cooperative kernel of `grid` blocks, as the single stream's step (any
    grid whose plan fits a block; tests: a row's bits do not depend on it),
    with its scratch for R rows (`verify_scratch`)."""

    entry = {False: "elit_gpt2_megaverify"}
    grid_entry = "elit_gpt2_megaverify_grid"
    args_type = GPT2VerifyArgs
    lead_field = "rows"

    def layout(self, k, rows: Optional[int]) -> tuple:
        R, lead, n_len, _ = super().layout(k, rows)
        return R, lead, n_len, ()  # R is the struct's last field

    def scratch(self, cfg, capacity: int, B: int) -> dict:
        return verify_scratch(cfg, capacity, B)

    def least_grid(self, n_embd: int) -> int:
        return 1

    def library(self) -> ctypes.CDLL:
        return gpt2_verify_kernels()


def launch_verify(launcher, counter, packed, cfg, k, v, length, x):
    """One verify launch on CUDA tensors; returns the tokens [R]. `x`:
    [R, E] embeddings, or [R] integer token ids embedded on the device."""
    R = x.shape[0]
    verify_rows_check(k, length, R)
    tok = torch.empty(R, dtype=torch.int32, device=k.device)
    kw = ({"x_emb": x.contiguous()} if x.is_floating_point()
          else {"tok_in": x.to(torch.int32).contiguous()})
    launcher(packed, cfg, k, v, _length_tensor(length, k.device), tok, rows=R,
             **kw).launch()
    launch_counter(counter, packed).launches += 1
    return tok


def gpt2_megaverify(packed: dict, k: torch.Tensor, v: torch.Tensor, length,
                    x: torch.Tensor, *, cfg):
    """Verify R <= 8 draft rows in one weight-streaming pass (greedy).
    Returns (tokens int32 [R], k, v).

    Row t carries the t-th verify token at position length + t: x is [R, E]
    token + position embeddings (wpe[min(length + t, P - 1)]) in the model
    dtype, or [R] integer token ids embedded on the device. Its K/V rows are
    written to row length + t of every layer (in place; none at or past
    capacity) and it attends the cache rows < length plus the verify rows
    j <= t; tokens[t] is its greedy argmax. k, v: [L, C, E] panes in the
    model dtype; length: int or int32 tensor; packed: of full-precision or
    quantized weights. On a CUDA tensor it launches the persistent kernel
    of `csrc/gpt2_megaverify.cu` (one a pass) and counts one launch in
    `gpt2_megaverify.launches`
    (full-precision weights) or `gpt2_megaverify.tiers["int8" |
    "int4"].launches`; on a CPU tensor it runs `gpt2_megaverify_plain`.
    """
    if k.device.type == "cpu":
        return gpt2_megaverify_plain(packed, k, v, length, x, cfg=cfg)
    return launch_verify(GPT2VerifyLauncher, gpt2_megaverify, packed, cfg, k, v,
                         length, x), k, v


gpt2_megaverify.launches = 0
gpt2_megaverify.tiers = tier_counts()


class MegaDecodeGraph:
    """The N-step greedy decode loop of one built configuration, captured
    once as a CUDA graph and replayed per generation (the port's
    counterpart of the JAX package's `jax.lax.scan` under `jax.jit`).

    Static state: the KV panes (and scales), `toks` int32 [N + 1, rows]
    (row 0 holds the prefill's tokens, step i reads row i and writes row
    i + 1) and `length` int32 [rows], which each step increments on the
    device; rows is 1 for the single-stream steps and the panes' B for a
    batched launcher (ops/megakernel_batch.py). `run` copies a generation's state in,
    replays, and adds to the wrapper's launch count (`counter.launches`)
    the launches recorded into the graph (N: one a step). `launcher` is the model's
    step launcher (`StepLauncher` for GPT-2,
    ops.megakernel_llama.LlamaStepLauncher for the Llama family, or a
    batched one).
    """

    def __init__(self, packed: dict, cfg, n_steps: int, panes: dict, counter,
                 launcher=StepLauncher, **launch_kw):
        dev = panes["k"].device
        rows = panes["k"].shape[1] if launcher.batched else 1
        self.n = n_steps
        self.panes = panes
        self.toks = torch.zeros(n_steps + 1, rows, dtype=torch.int32, device=dev)
        self.length = torch.zeros(rows, dtype=torch.int32, device=dev)
        self.step = launcher(
            packed, cfg, panes["k"], panes["v"], self.length, self.toks[1],
            tok_in=self.toks[0], ks=panes.get("ks"), vs=panes.get("vs"),
            advance=True, **launch_kw)
        self.counter = launch_counter(counter, packed)  # after the launcher's checks
        self.step.library()  # build and load outside the capture
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            for i in range(n_steps):
                self.step.set_tokens(self.toks[i], self.toks[i + 1])
                self.step.launch()
        self.per_replay = self.step.launched  # the launcher launched nothing before

    def run(self, tok0: torch.Tensor, length) -> torch.Tensor:
        """Decode N tokens from the panes' current contents; returns the
        tokens [N, rows] (int32, on the device): tok0 and the N - 1 that
        follow, as the JAX scan emits them. `length`: an int, or int32
        [rows] per row."""
        self.toks[0].copy_(tok0.reshape(-1))
        if isinstance(length, torch.Tensor):
            self.length.copy_(length)
        else:
            self.length.fill_(length)
        self.graph.replay()
        self.counter.launches += self.per_replay
        return self.toks[:self.n]
