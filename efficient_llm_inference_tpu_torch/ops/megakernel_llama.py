"""Whole-step Llama/Qwen decode: one chain of CUDA kernels per batch-1 step.

Port of efficient_llm_inference_tpu/ops/pallas/megakernel_llama.py
(`_llama_megapass` through `llama_megastep`, the R = 1 decode row, and
through `llama_megaverify`, R <= 8 verify rows of one sequence;
`mega_supported`, `pack_llama_mega`, `_weight_mode`; full-precision, int8
and grouped-int4 weights, the last at any group including the int4w8
group TR/2). The TPU program streams a uniform [TR, TC] tile grid of every
weight through VMEM; on the H100 the step is a fixed chain of hand-written
kernels from `csrc/llama_megastep.cu`, launched by one host call
(`llama_megastep`) and, in the engine's decode loop, captured once into a
CUDA graph (ops/megakernel.py `MegaDecodeGraph`) that replays all N steps
of a generation. The chain's GEMVs are `csrc/gemv_stream.cuh`'s persistent
streaming GEMV, its attention a split-KV kernel (one block per K/V head and
split of the capacity, `attention_plan`, the splits combined by the last
block of each head; `split_attention_plain` is its arithmetic), and every
kernel is launched with programmatic dependent launch. The quantized-KV
variant (ops/megakernel_quant.py `llama_megastep_quant`) shares this
module's packing and launcher, and so does the verify pass
(`llama_megaverify`, the chain of `csrc/megaverify.cu`; row t takes its
RoPE row at min(length + t, n_positions - 1)).

Layouts:

* KV panes are [L, C, KW] with KW = n_kv_head * head_dim (the JAX
  package's `to_mega_layout`, shared with GPT-2).
* `pack_llama_mega` stores every weight as [out, in] row-major, so one warp
  reads one output's input row with 16-byte loads: q|k|v concatenated
  [L, QW + 2 KW, E], o [L, E, QW], gate and up interleaved row by row
  [L, 2 I, E] (row 2j = gate j, row 2j + 1 = up j, so one block yields whole
  SwiGLU outputs), down [L, E, I], and the LM head [V, E] (the embedding
  itself when tied; the untied lm_head [E, V] transposed). RMSNorm gains are
  fp32 `norms` [L, 2, E] and `lnf` [1, E]; the Qwen q/k/v biases fp32
  `qkvb` [L, QW + 2 KW]. The RoPE tables `cos`/`sin` [n_positions, D] (fp32,
  `models.llama.rope_cos_sin`) are packed too: a step reads row
  min(length, n_positions - 1) on the device.

Quantized weights (`models.llama.quantize_llama_weights`) pack into the
same rows of codes with `<name>_s` scales (ops/megakernel.py `pack_rows`:
int8 rows and fp32 per-row scales; int4 rows of the codes' own nibble order
and per-(row, group) scales in the model dtype), gate and up interleaved
row by row with their scales, and the LM head from the quantized copy
(`lm_q` / `lm_q4`) into `head` / `head_s`; `embed` stays for the lookup.
The int4 tier's arithmetic is the JAX kernel's int4w8 form (`_int4_tile_dot`
at one group a half tile: raw nibble dots, their fp32 sums scaled) at every
group; ops/megakernel.py says what it leaves of the grouped form.

Numerics follow the JAX kernel's rounding points, which differ from the
model's (`models/llama.py`) in one place: silu is applied to the fp32 gate
sum, not to the gate rounded to the model dtype (identical in fp32).
RMSNorm statistics in fp32 with the normalised value rounded before the
gain; q/k/v (bias added in fp32) rounded, RoPE in fp32 on the rounded q/k
and rounded again; the attention output, SwiGLU factors and product and each
residual add in the model dtype; fp32 softmax with the current token merged
into the same softmax as the cached rows t < length; greedy argmax over the
fp32 logits, first maximum wins.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..models.llama import WEIGHT_NAMES, _rms_norm, apply_rope, rope_cos_sin
from . import _build, _gemv_stream_tc
from .megakernel import (
    _DTYPE_CODE,
    HEAD_DIMS,
    KIND_CODE,
    MAX_CAPACITY,
    MAX_VERIFY_ROWS,
    StepLauncher,
    VerifyLayout,
    Workspace,
    _check,
    _int4_group_ok,
    _length_tensor,
    _q4_group,
    _tier_ok,
    attend_plain,
    check_weights,
    launch_counter,
    launch_verify,
    lm_rows,
    pack_rows,
    set_tier,
    tier_counts,
    tier_fields,
    verify_kernels,
    verify_plain,
    verify_rows_check,
    weight_kind,
    weight_mode,
    wmv,
)


def _full_precision_dtype(params: dict, cfg) -> Optional[torch.dtype]:
    """The weights' dtype when every block weight, the embedding and (untied)
    the LM head are full-precision tensors of one dtype the kernels take,
    else None (the JAX package's "f" weight mode)."""
    b = params.get("blocks", {})
    ts = [b.get(n) for n in WEIGHT_NAMES] + [params.get("embed")]
    if not cfg.tie_embeddings:
        ts.append(params.get("lm_head"))
    if not all(isinstance(t, torch.Tensor) for t in ts):
        return None
    dts = {t.dtype for t in ts}
    dt = dts.pop() if len(dts) == 1 else None
    return dt if dt in _DTYPE_CODE else None


def _tile_geometry(cfg):
    """(TR, TC, Ip): the JAX kernel's uniform weight tile and padded FFN
    width (copy of ops/pallas/megakernel_llama.py `_tile_geometry`). The
    port streams whole rows and needs no tiles; the JAX eligibility is
    stated in terms of them."""
    E, I = cfg.hidden_size, cfg.intermediate_size
    QW = cfg.n_head * cfg.head_dim
    KW = cfg.n_kv_head * cfg.head_dim

    def geo(Ip):
        TR = math.gcd(math.gcd(E, QW), Ip)
        while TR > 2048:
            TR //= 2
        TC = math.gcd(math.gcd(QW, KW), math.gcd(E, Ip))
        while TC > 512:
            TC //= 2
        return TR, TC

    TR, TC = geo(I)
    Ie = -(-I // E) * E
    if Ie != I and (Ie - I) * 100 <= 15 * I:
        TRp, TCp = geo(Ie)
        if TRp * TCp >= 2 * TR * TC:
            return TRp, TCp, Ie
    return TR, TC, I


def _jax_geometry_ok(cfg, capacity: int) -> bool:
    """The JAX package's structural conditions (TC % 128, KW % 128, TR % 8,
    even head_dim, capacity % 8)."""
    TR, TC, _ = _tile_geometry(cfg)
    D = cfg.head_dim
    return (TC % 128 == 0 and (cfg.n_kv_head * D) % 128 == 0 and TR % 8 == 0
            and D % 2 == 0 and capacity % 8 == 0)


def _geometry_ok(cfg, capacity: int) -> bool:
    """The JAX package's structural conditions and the kernels' limits:
    head_dim 64 or 128, capacity <= 8192, whole query groups, and widths
    that are multiples of 8 (16-byte weight rows)."""
    return (_jax_geometry_ok(cfg, capacity)
            and cfg.head_dim in HEAD_DIMS and 0 < capacity <= MAX_CAPACITY
            and cfg.n_head % cfg.n_kv_head == 0 and cfg.hidden_size % 8 == 0
            and cfg.intermediate_size % 8 == 0)


def jax_structure_ok(cfg, capacity: int, params: dict) -> bool:
    """The JAX package's eligibility without its TPU memory envelopes (its
    weight gates and structure): what decides the JAX engine's routes for a
    speculative draft."""
    return _weights_ok(cfg, params, kernels=False) and _jax_geometry_ok(cfg, capacity)


def _weight_mode(b: dict) -> Optional[str]:
    """"f" | "int8" | "int4" when the seven block weights are uniform, else
    None (JAX `_weight_mode`)."""
    return weight_mode(b, WEIGHT_NAMES)


def _weights_ok(cfg, params: dict, kernels: bool = True) -> bool:
    """The JAX package's weight gates: uniform weights (full precision with
    an lm_head when untied, int8 with `lm_q`, or grouped int4 with `lm_q4`
    at one group G with TR % G == 0, (TR/2) % G == 0, TR % 16 == 0 and
    (Ip - I) % G == 0, the copied `_tile_geometry`), and, with `kernels`,
    the kernels' own: G % 32 == 0 (int4), and E, QW and I multiples of 16
    (int8: 16 codes a load)."""
    b = params.get("blocks", {})
    mode = _weight_mode(b)
    embed = params.get("embed")
    dtype = (_full_precision_dtype(params, cfg) if mode == "f"
             else embed.dtype if isinstance(embed, torch.Tensor) else None)
    if not _tier_ok(params, mode, dtype):
        return False
    QW = cfg.n_head * cfg.head_dim
    if (kernels and mode == "int8"
            and any(d % 16 for d in (cfg.hidden_size, QW, cfg.intermediate_size))):
        return False
    if mode == "int4":
        gs = {_q4_group(b[n]) for n in WEIGHT_NAMES} | {_q4_group({"q4": params["lm_q4"]})}
        if len(gs) != 1:
            return False
        G = gs.pop()
        TR, _, Ip = _tile_geometry(cfg)
        if (TR % G or (TR // 2) % G or TR % 16 or (Ip - cfg.intermediate_size) % G
                or (kernels and not _int4_group_ok(G))):
            return False
    return True


def mega_supported(cfg, capacity: int, params: dict) -> bool:
    """Can the Llama megakernel run this geometry? The JAX package's
    eligibility (the weight gates of `_weights_ok`, the structure of
    `_geometry_ok`) plus the kernels' limits. The JAX package's TPU
    memory envelopes (the VMEM budget, the 4 GiB packed-stream cap and the
    2048-tile DMA gate) are not carried over: the card streams the weights
    from its own memory, where both copies fit."""
    return _weights_ok(cfg, params) and _geometry_ok(cfg, capacity)


def pack_llama_mega(params: dict, cfg) -> Optional[dict]:
    """Re-layout Llama/Qwen params for the kernels (once per engine); None
    when the params are not packable (see `mega_supported`)."""
    if not _weights_ok(cfg, params):
        return None
    L, E, I = cfg.n_layer, cfg.hidden_size, cfg.intermediate_size
    b = params["blocks"]
    dtype = params["embed"].dtype
    rows = {n: pack_rows(b[n], dtype) for n in WEIGHT_NAMES}  # [L, out, in]

    def cat(names):  # q|k|v rows (and scales) along the outputs
        parts = [rows[n] for n in names]
        s = None if parts[0][1] is None else torch.cat([p[1] for p in parts], dim=1)
        return torch.cat([p[0] for p in parts], dim=1), s

    def interleave(a, b_):  # gate j, up j -> rows 2j, 2j + 1
        return torch.stack([a, b_], dim=2).reshape(L, 2 * I, *a.shape[2:])

    positions = torch.arange(cfg.n_positions, device=params["embed"].device)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    (gate, gate_s), (up, up_s) = rows["w_gate"], rows["w_up"]
    packed = {
        "o_w": rows["wo"][0],  # [L, E, QW]
        "gu_w": interleave(gate, up).contiguous(),  # [L, 2 I, E]
        "down_w": rows["w_down"][0],  # [L, E, I]
        "embed": params["embed"].contiguous(),
        "norms": torch.stack([b["ln1"].float(), b["ln2"].float()], dim=1).contiguous(),
        "lnf": params["ln_f"].float()[None].contiguous(),
        "cos": cos.contiguous(),
        "sin": sin.contiguous(),
    }
    packed["qkv_w"], qkv_s = cat(("wq", "wk", "wv"))
    if qkv_s is not None:  # quantized weights: the scales, the LM head's copy
        packed.update(qkv_s=qkv_s, o_s=rows["wo"][1], down_s=rows["w_down"][1],
                      gu_s=interleave(gate_s, up_s).contiguous())
        packed["head"], packed["head_s"] = lm_rows(params, dtype)
    else:
        packed["head"] = (params["embed"] if cfg.tie_embeddings
                          else params["lm_head"].t()).contiguous()
    if cfg.qkv_bias:
        packed["qkvb"] = torch.cat([b["bq"], b["bk"], b["bv"]], dim=-1).float().contiguous()
    return packed


# ---------------------------------------------------------------------------
# Plain PyTorch version of the step (any device; the CPU tests' reference and
# the card's yardstick).


def rope_position(length: int, cfg) -> int:
    """The position of the token a step decodes: min(length, P - 1)."""
    return min(max(int(length), 0), cfg.n_positions - 1)


def llama_plain_step(packed: dict, cfg, x_emb: torch.Tensor, pos: int, attend):
    """The layer chain of one decode step, shared by both plain versions.

    `attend(layer, q, k, v)` gets the current token's roped q [QW] and k
    [KW] and its v [KW] in the model dtype and returns the attention output
    [QW] in fp32. Returns (logits fp32 [V], new K rows [L, KW] (roped), new
    V rows [L, KW]) in the model dtype; the caller writes the rows to row
    `length` (after the last layer, as the JAX kernel does).
    """
    E, L, D, I = cfg.hidden_size, cfg.n_layer, cfg.head_dim, cfg.intermediate_size
    QW, KW = cfg.n_head * D, cfg.n_kv_head * D
    eps = cfg.rms_eps
    dt = x_emb.dtype
    cos, sin = packed["cos"][pos].reshape(1, 1, D), packed["sin"][pos].reshape(1, 1, D)

    def rope(t):  # [H*D] -> [H*D]
        return apply_rope(t.reshape(1, -1, 1, D), cos, sin).reshape(-1)

    x = x_emb.reshape(E)
    new_k, new_v = [], []
    for layer in range(L):
        norms = packed["norms"][layer]
        h = _rms_norm(x, norms[0], eps)
        y = wmv(h, packed, "qkv_w", layer)
        if "qkvb" in packed:
            y = y + packed["qkvb"][layer]
        q, k, v = y.to(dt).split([QW, KW, KW])
        q, k = rope(q), rope(k)
        a = attend(layer, q, k, v).to(dt)
        x = x + wmv(a, packed, "o_w", layer).to(dt)
        h2 = _rms_norm(x, norms[1], eps)
        gu = wmv(h2, packed, "gu_w", layer).reshape(I, 2)
        g, u = gu[:, 0], gu[:, 1]
        gate = (g * torch.sigmoid(g)).to(dt)  # silu on the fp32 gate
        x = x + wmv(gate * u.to(dt), packed, "down_w", layer).to(dt)
        new_k.append(k)
        new_v.append(v)
    xf = _rms_norm(x, packed["lnf"][0], eps)
    logits = wmv(xf, packed, "head")
    return logits, torch.stack(new_k), torch.stack(new_v)


def llama_megastep_plain(packed: dict, k: torch.Tensor, v: torch.Tensor,
                         length, x_emb: torch.Tensor, *, cfg,
                         return_logits: bool = False):
    """Plain PyTorch version of `llama_megastep`, the same function on any
    device: returns (token int32 [], k, v), with row `length` of every
    layer of k/v written in place; with `return_logits`, the fp32 logits
    [V] that chose the token come fourth."""
    cur = int(length)

    def attend(layer, q, kc, vc):
        return attend_plain(q, kc, vc, k[layer], v[layer], cur, cfg.n_kv_head)

    logits, new_k, new_v = llama_plain_step(packed, cfg, x_emb,
                                            rope_position(cur, cfg), attend)
    if cur < k.shape[1]:
        k[:, cur] = new_k.to(k.dtype)
        v[:, cur] = new_v.to(v.dtype)
    tok = torch.argmax(logits).to(torch.int32)
    return (tok, k, v, logits) if return_logits else (tok, k, v)


# ---------------------------------------------------------------------------
# Split-KV attention (csrc/llama_megastep.cu split_attention_kernel): the
# plan of its grid and scratch, and a plain model of its arithmetic.

# A split covers 32-512 rows, and a group's scores of a split (group x rows
# fp32) at most ATTN_SCORES floats of shared memory.
ATTN_MIN_ROWS, ATTN_MAX_ROWS, ATTN_SCORES = 32, 512, 8192


def attention_plan(capacity: int, n_head: int, n_kv_head: int, n_sm: int, rows_of: int = 1):
    """(splits, rows) of the single-stream step's split-KV attention: the
    capacity cut into `splits` runs of `rows` rows (a multiple of 8), one
    block a K/V head and split, about one wave of `n_sm` SMs (the writer
    block is one more), each split at least ATTN_MIN_ROWS rows and at most
    ATTN_MAX_ROWS or ATTN_SCORES / (group x rows_of). The grid depends on
    the capacity, not the length, so a captured graph serves every length.
    The verify's plan (`verify_scratch`) takes rows_of = MAX_VERIFY_ROWS:
    the scores of a group's query heads of every verify row, whatever R."""
    group = n_head // n_kv_head
    want = max(1, n_sm // n_kv_head)
    rows = max(ATTN_MIN_ROWS, -(-capacity // want))
    cap = max(8, min(ATTN_MAX_ROWS, ATTN_SCORES // (group * rows_of) // 8 * 8))
    rows = min(-(-rows // 8) * 8, cap)
    return -(-capacity // rows), rows


def attention_scratch(cfg, capacity: int, n_sm: int) -> dict:
    """The split attention's plan and scratch sizes (`Workspace`'s
    attn_part floats, attn_count ints and rope floats: the step's RoPE rows,
    which the chain's first kernel copies for every layer's attention) for a
    Llama/Qwen config."""
    splits, rows = attention_plan(capacity, cfg.n_head, cfg.n_kv_head, n_sm)
    return {"splits": splits, "rows": rows,
            "part": cfg.n_head * splits * (cfg.head_dim + 2), "count": cfg.n_kv_head,
            "rope": 2 * cfg.head_dim}


def split_attention_plain(q, kc, vc, k_vals, v_vals, length: int, n_kv_head: int,
                          splits: int, rows: int, ks=None, vs=None):
    """The split-KV attention kernel's arithmetic in plain PyTorch (no main
    path calls it; the CPU tests hold it against `attend_plain` /
    `attend_quant_plain` and the JAX step): query heads q [Hq*D] grouped
    onto n_kv_head K/V heads, over the rows t < length of the pane values
    k_vals/v_vals [C, Hkv*D] (fp32; codes unscaled for quantized panes,
    whose per-token scales ks/vs [C] are then given), cut into `splits` runs
    of `rows` rows. Each split gives per query head its max m_s, the sum l_s
    of exp(score - m_s) and acc_s = sum of those weights times V: for
    quantized panes the weights times the V scales are rounded to q's dtype
    relative to the split's max m_s (the JAX kernel rounds relative to the
    row's global max: the kernel moves that reference, see
    csrc/llama_megastep.cu). The combine merges the splits and the current
    token kc/vc [Hkv*D]: M = max(m_s, s_cur), out = (sum_s acc_s e^(m_s - M)
    + e^(s_cur - M) vc) / (sum_s l_s e^(m_s - M) + e^(s_cur - M)) (the
    kernel takes 16 splits a round trip, rescaling its running sums when a
    later 16 raise M: the same value in another fp32 rounding). Returns
    [Hq*D] fp32."""
    C = k_vals.shape[0]
    G, D = q.numel() // kc.numel(), kc.numel() // n_kv_head
    scale = 1.0 / math.sqrt(D)
    u = q.float().reshape(n_kv_head, G, D)
    length = min(max(int(length), 0), C)
    ms, ls, accs = [], [], []
    for s in range(splits):
        r0, r1 = s * rows, min((s + 1) * rows, length)
        if r1 <= r0:  # the neutral partial
            ms.append(torch.full((n_kv_head, G, 1), -math.inf))
            ls.append(torch.zeros(n_kv_head, G, 1))
            accs.append(torch.zeros(n_kv_head, G, D))
            continue
        kv = k_vals[r0:r1].float().reshape(r1 - r0, n_kv_head, D)
        raw = torch.einsum("kgd,ckd->kgc", u, kv)
        sc = raw * ks[r0:r1] * scale if ks is not None else raw * scale
        m = sc.amax(-1, keepdim=True)
        p = torch.exp(sc - m)
        w = (p * vs[r0:r1]).to(q.dtype).float() if vs is not None else p
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        accs.append(torch.einsum("kgc,ckd->kgd", w,
                                 v_vals[r0:r1].float().reshape(r1 - r0, n_kv_head, D)))
    s_cur = (u * kc.float().reshape(n_kv_head, 1, D)).sum(-1, keepdim=True) * scale
    M = torch.maximum(torch.stack(ms).amax(0), s_cur)
    wts = [torch.exp(m - M) for m in ms]
    p_cur = torch.exp(s_cur - M)
    denom = sum(l * w for l, w in zip(ls, wts)) + p_cur
    num = sum(a * w for a, w in zip(accs, wts)) + p_cur * vc.float().reshape(n_kv_head, 1, D)
    return (num / denom).reshape(-1)


# ---------------------------------------------------------------------------
# The kernels: arguments and launcher (the CUDA graph is ops/megakernel.py's).


class LlamaStepArgs(ctypes.Structure):
    """Mirror of `struct LlamaArgs` in csrc/llama_megastep.cu (same order):
    the fields the batched and verify structs repeat after their leading
    rows / batch, ending with the weight tier (ops/megakernel.py
    `tier_fields`): each weight's scales."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "dtype", "n_layer", "n_embd", "n_head", "n_kv_head", "head_dim",
        "inter", "vocab", "n_pos", "capacity", "k_kind", "v_kind", "advance",
        "lm_blocks")] + [
        ("rms_eps", ctypes.c_float), ("quant_eps", ctypes.c_float),
    ] + [(n, ctypes.c_void_p) for n in (
        "qkv_w", "o_w", "gu_w", "down_w", "embed", "head", "norms", "lnf",
        "qkvb", "cos", "sin", "k", "v", "ks", "vs", "length", "tok_in",
        "x_emb", "tok_out", "x", "qkv", "attn", "ffn", "lm_val", "lm_idx")] + tier_fields(
        ("qkv_s", "o_s", "gu_s", "down_s", "head_s"))


class LlamaSingleArgs(LlamaStepArgs):
    """Mirror of `struct LlamaSingleArgs` in csrc/llama_megastep.cu: the
    single-stream step's `LlamaStepArgs`, then its split-KV attention's
    plan and scratch (`attention_scratch`)."""

    _fields_ = [("attn_splits", ctypes.c_int), ("attn_rows", ctypes.c_int),
                ("attn_part", ctypes.c_void_p), ("attn_count", ctypes.c_void_p),
                ("rope", ctypes.c_void_p)]


_lib = None


def kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("llama_megastep")
        for fn in (lib.elit_llama_megastep, lib.elit_llama_megastep_quant):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(LlamaSingleArgs), ctypes.c_void_p]
        _lib = lib
    return _lib


class LlamaStepLauncher(StepLauncher):
    """The prepared arguments of one configuration's Llama step (the
    LlamaSingleArgs of csrc/llama_megastep.cu, with the
    split attention's scratch in its `Workspace`); `set_tokens` and
    `launch` are ops.megakernel.StepLauncher's. The batched and verify
    launchers derive from it with their own structs (LlamaArgs after their
    leading fields, no split attention)."""

    entry = {False: "elit_llama_megastep", True: "elit_llama_megastep_quant"}
    args_type = LlamaSingleArgs

    def __init__(self, packed: dict, cfg, k, v, length, tok_out, *,
                 x_emb=None, tok_in=None, ks=None, vs=None,
                 k_kind: str = "fp", v_kind: str = "fp",
                 quant_eps: float = 1e-8, advance: bool = False,
                 rows: Optional[int] = None):
        B, lead, n_len, prefix = self.layout(k, rows)
        E, L, C, D = cfg.hidden_size, cfg.n_layer, k.shape[-2], cfg.head_dim
        I, V, P = cfg.intermediate_size, cfg.vocab_size, cfg.n_positions
        QW, KW = cfg.n_head * D, cfg.n_kv_head * D
        dtype = packed["embed"].dtype
        wkind = weight_kind(packed)
        dev = k.device
        if dev.type != "cuda":
            raise ValueError(f"no kernel for device {dev}")
        if dtype not in _DTYPE_CODE or not _geometry_ok(cfg, C):
            raise NotImplementedError(
                f"llama megakernel: E={E}, head_dim={D}, heads {cfg.n_head}/"
                f"{cfg.n_kv_head}, capacity={C}")
        if (x_emb is None) == (tok_in is None):
            raise ValueError("give exactly one of x_emb and tok_in")
        weights = {"qkv_w": (L, QW + 2 * KW, E), "o_w": (L, E, QW), "gu_w": (L, 2 * I, E),
                   "down_w": (L, E, I), "head": (V, E)}
        group = check_weights(packed, weights, wkind, dtype, dev)
        _check("embed", packed["embed"], dtype, (V, E), dev)
        f32 = {"norms": (L, 2, E), "lnf": (1, E), "cos": (P, D), "sin": (P, D)}
        if "qkvb" in packed:
            f32["qkvb"] = (L, QW + 2 * KW)
        for name, shape in f32.items():
            _check(name, packed[name], torch.float32, shape, dev)
        store = {"fp": (dtype, KW), "int8": (torch.int8, KW), "int4": (torch.int8, KW // 2)}
        for name, pane, kind in (("k", k, k_kind), ("v", v, v_kind)):
            dt, width = store[kind]
            _check(name, pane, dt, (L, *lead, C, width), dev)
        if k_kind != "fp" or v_kind != "fp":
            if k_kind == "fp" or v_kind == "fp":
                raise ValueError("quantized K and V panes go together")
            if "int4" in (k_kind, v_kind) and (KW // 2) % D:
                raise NotImplementedError("int4 panes need whole heads per half")
            _check("ks", ks, torch.float32, (L, *lead, C), dev)
            _check("vs", vs, torch.float32, (L, *lead, C), dev)
        _check("length", length, torch.int32, (n_len,), dev)
        _check("tok_out", tok_out, torch.int32, (B,), dev)
        if x_emb is not None:
            _check("x_emb", x_emb.reshape(B * E), dtype, (B * E,), dev)
        else:
            _check("tok_in", tok_in, torch.int32, (B,), dev)
        single = issubclass(self.args_type, LlamaSingleArgs)
        plan = (attention_scratch(
            cfg, C, torch.cuda.get_device_properties(dev).multi_processor_count)
            if single else None)
        ws = Workspace(dtype, dev, x=E, qkv=QW + 2 * KW, attn=QW, ffn=I, rows=B,
                       **({k: plan[k] for k in ("part", "count", "rope")} if single else {}))
        # keep every tensor the struct points at alive with the launcher
        self._refs = (packed, k, v, ks, vs, length, tok_in, x_emb, tok_out, ws)
        self.x_emb = x_emb
        self.quant = k_kind != "fp"
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        self.args = self.args_type(
            *prefix, _DTYPE_CODE[dtype], L, E, cfg.n_head, cfg.n_kv_head, D, I, V, P, C,
            KIND_CODE[k_kind], KIND_CODE[v_kind], int(advance), ws.n_lm,
            cfg.rms_eps, quant_eps,
            *(ptr(packed.get(n)) for n in (
                "qkv_w", "o_w", "gu_w", "down_w", "embed", "head", "norms",
                "lnf", "qkvb", "cos", "sin")),
            ptr(k), ptr(v), ptr(ks), ptr(vs), ptr(length), ptr(tok_in),
            ptr(x_emb), ptr(tok_out), ptr(ws.x), ptr(ws.qkv), ptr(ws.attn),
            ptr(ws.ffn), ptr(ws.lm_val), ptr(ws.lm_idx))
        if wkind != "fp":
            set_tier(self.args, packed, weights, wkind, group)
        if single:
            self.args.attn_splits, self.args.attn_rows = plan["splits"], plan["rows"]
            self.args.attn_part = ws.attn_part.data_ptr()
            self.args.attn_count = ws.attn_count.data_ptr()
            self.args.rope = ws.rope.data_ptr()
        self.device = dev

    def library(self) -> ctypes.CDLL:
        return kernels()


def llama_megastep(packed: dict, k: torch.Tensor, v: torch.Tensor, length,
                   x_emb: torch.Tensor, *, cfg):
    """One whole Llama/Qwen decode step (greedy, batch 1). Returns (token
    int32 [], k, v).

    packed: `pack_llama_mega(params, cfg)`; k, v: [L, C, KW] panes in the
    model dtype, written in place at row `length` of every layer (the JAX
    kernel aliases them the same way) and returned; length: tokens already
    cached (int or int32 tensor), whose RoPE position min(length, P - 1)
    the step takes from the packed tables; x_emb: [1, E] token embedding in
    the model dtype. On a CUDA tensor it launches the kernel chain of
    `csrc/llama_megastep.cu` and counts one launch in
    `llama_megastep.launches` (full-precision weights) or its weight tier's
    `llama_megastep.tiers["int8" | "int4"].launches`; on a CPU tensor it
    runs `llama_megastep_plain`. The capacity is the panes' row count.
    """
    if k.device.type == "cpu":
        return llama_megastep_plain(packed, k, v, length, x_emb, cfg=cfg)
    tok = torch.empty(1, dtype=torch.int32, device=k.device)
    LlamaStepLauncher(packed, cfg, k, v, _length_tensor(length, k.device), tok,
                      x_emb=x_emb.contiguous()).launch()
    launch_counter(llama_megastep, packed).launches += 1
    return tok[0], k, v


llama_megastep.launches = 0
llama_megastep.tiers = tier_counts()


# ---------------------------------------------------------------------------
# The speculative verify pass (JAX `llama_megaverify`: `_llama_megapass` at
# R > 1).


def llama_megaverify_plain(packed: dict, k: torch.Tensor, v: torch.Tensor,
                           length, x: torch.Tensor, *, cfg,
                           return_logits: bool = False):
    """Plain PyTorch version of `llama_megaverify`, the same function on any
    device: returns (tokens int32 [R], k, v), rows length .. length + R - 1
    written in place; with `return_logits`, the fp32 logits [R, V] come
    fourth."""
    cur = int(length)
    verify_rows_check(k, cur, x.shape[0])
    rows = x if x.is_floating_point() else packed["embed"][x.long()]

    def step(pk, kk, vv, n, xr):
        return llama_megastep_plain(pk, kk, vv, n, xr, cfg=cfg, return_logits=True)

    toks, logits = verify_plain(step, packed, k, v, cur, rows)
    return (toks, k, v, logits) if return_logits else (toks, k, v)


# The bf16 chains' tensor-core GEMV scratch (ops/_gemv_stream_tc.py), the
# tail of LlamaVerifyArgs and ops/megakernel_batch.py's LlamaBatchArgs.
TC_FIELDS = [("tc_part", ctypes.c_void_p), ("tc_part_len", ctypes.c_longlong),
             ("tc_count", ctypes.c_void_p), ("tc_count_len", ctypes.c_int)]
# The verify's split attention: its plan and scratch.
VERIFY_ATTN_FIELDS = [("attn_splits", ctypes.c_int), ("attn_rows", ctypes.c_int),
                      ("attn_part", ctypes.c_void_p), ("attn_count", ctypes.c_void_p)]


class LlamaVerifyArgs(ctypes.Structure):
    """Mirror of `struct LlamaVerifyArgs` in csrc/megaverify.cu: R, then
    `LlamaStepArgs`, then the split attention's plan and scratch
    (`VERIFY_ATTN_FIELDS`, `verify_scratch`), then the bf16 chain's
    tensor-core scratch (`TC_FIELDS`)."""

    _fields_ = ([("rows", ctypes.c_int)] + LlamaStepArgs._fields_ + VERIFY_ATTN_FIELDS
                + TC_FIELDS)


def verify_scratch(cfg, capacity: int, R: int, n_sm: int) -> dict:
    """The verify attention's plan and scratch: `attention_plan` with the
    scores of all MAX_VERIFY_ROWS rows of a group in a block (so the plan,
    and a row's bits, do not depend on R), the partials of R rows (`part`
    fp32: [R, n_head, splits, D + 2]) and a zeroed counter a K/V head
    (`count`)."""
    splits, rows = attention_plan(capacity, cfg.n_head, cfg.n_kv_head, n_sm,
                                  rows_of=MAX_VERIFY_ROWS)
    return {"splits": splits, "rows": rows,
            "part": R * cfg.n_head * splits * (cfg.head_dim + 2), "count": cfg.n_kv_head}


class LlamaVerifyLauncher(VerifyLayout, LlamaStepLauncher):
    """The prepared arguments of one Llama/Qwen verify pass (R rows), with
    its split attention's scratch (`verify_scratch`) and, in bf16, the
    tensor-core GEMVs' (`TC_FIELDS`, ops/_gemv_stream_tc.py `scratch_sizes`
    at B = R), allocated once per launcher so a captured pass allocates
    nothing and no two launchers share counters."""

    entry = {False: "elit_llama_megaverify"}
    args_type = LlamaVerifyArgs

    def __init__(self, packed: dict, cfg, k, *args, **kw):
        super().__init__(packed, cfg, k, *args, **kw)
        a, dev = self.args, self.device
        plan = verify_scratch(cfg, k.shape[-2], a.rows,
                              torch.cuda.get_device_properties(dev).multi_processor_count)
        part = torch.empty(plan["part"], dtype=torch.float32, device=dev)
        count = torch.zeros(plan["count"], dtype=torch.int32, device=dev)
        a.attn_splits, a.attn_rows = plan["splits"], plan["rows"]
        a.attn_part, a.attn_count = part.data_ptr(), count.data_ptr()
        self._refs = self._refs + (part, count)
        if a.dtype != _DTYPE_CODE[torch.bfloat16]:
            return
        n_part, n_count = _gemv_stream_tc.scratch_sizes(cfg, a.rows)
        tc_part = torch.empty(n_part, dtype=torch.float32, device=dev)
        tc_count = torch.zeros(n_count, dtype=torch.int32, device=dev)
        self._refs = self._refs + (tc_part, tc_count)
        a.tc_part, a.tc_part_len = tc_part.data_ptr(), n_part
        a.tc_count, a.tc_count_len = tc_count.data_ptr(), n_count


def verify_chain_kernels() -> int:
    """Kernels the Llama/Qwen verify has launched in this process
    (csrc/megaverify.cu counts each where it launches): a pass's launches,
    6 L + 3, are the difference across the pass."""
    return int(verify_kernels().elit_megaverify_kernels())


def llama_megaverify(packed: dict, k: torch.Tensor, v: torch.Tensor, length,
                     x: torch.Tensor, *, cfg):
    """Verify R <= 8 draft rows of a Llama/Qwen model in one weight-streaming
    pass (greedy). Returns (tokens int32 [R], k, v).

    As `ops.megakernel.gpt2_megaverify`: x is [R, E] token embeddings in the
    model dtype or [R] integer token ids; row t is rotated at
    min(length + t, P - 1) from the packed RoPE tables (the JAX kernel takes
    the same rows as cos_q/sin_q inputs). k, v: [L, C, KW] panes. On a CUDA
    tensor it launches the chain of `csrc/megaverify.cu` and counts one
    launch in `llama_megaverify.launches` or its weight tier's
    `llama_megaverify.tiers[...]`; on a CPU tensor it runs
    `llama_megaverify_plain`.
    """
    if k.device.type == "cpu":
        return llama_megaverify_plain(packed, k, v, length, x, cfg=cfg)
    return launch_verify(LlamaVerifyLauncher, llama_megaverify, packed, cfg, k, v,
                         length, x), k, v


llama_megaverify.launches = 0
llama_megaverify.tiers = tier_counts()
