"""Draft bursts: k greedy steps of a small draft model in one launch.

Port of efficient_llm_inference_tpu/ops/pallas/megakernel_draft.py
(`gpt2_draft_burst_supported`, `pack_gpt2_draft`, `gpt2_draft_burst`,
`llama_draft_burst_supported`, `pack_llama_draft`, `llama_draft_burst`). A
speculation round with a draft model runs k draft steps, each of which on
its own is a few microseconds of work on a model of at most 6 MB; one
launch of `csrc/draft_burst.cu` runs all k (token feedback, the pane append
at the running cursor, the tied LM head's argmax) on one thread-block
cluster, so a round is two launches (burst + verify) instead of k + 1.

The bursts take the whole-step kernels' packing (`pack_gpt2_draft` is
ops/megakernel.py `pack_gpt2_mega`, `pack_llama_draft` is
ops/megakernel_llama.py `pack_llama_mega`) and [L, C, W] panes in the model
dtype; their numerics are the single-stream steps', so the plain bursts
here are k plain steps (`gpt2_megastep_plain`, `llama_megastep_plain`) with
the token fed back. The eligibility gates copy the JAX package's (the 6 MB
byte budget, V <= 2048, E % 128 or KW % 128, tied embeddings): on the TPU
the budget is a VMEM envelope, here it decides which route the engine
takes, and the routes must match. The kernel's own limits come on top.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import megakernel as mk
from . import megakernel_llama as ml

DRAFT_BYTES_MAX = 6 * 1024 * 1024  # weights + tables + panes (the JAX budget)
# The kernel's own limits: attention_block's head templates, and the
# scores (and GEMV inputs) of one block in 48 KB of shared memory.
BURST_HEAD_DIMS = (32, 64, 128)
_SMEM_FLOATS = 48 * 1024 // 4
_CLUSTER = 8  # blocks of the burst's cluster (csrc/draft_burst.cu kCluster)


def _item(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _gpt2_draft_bytes(cfg, capacity: int, dt_item: int) -> int:
    E, L, V, P = cfg.n_embd, cfg.n_layer, cfg.vocab_size, cfg.n_positions
    w = L * (E * 3 * E + E * E + E * 4 * E + 4 * E * E)  # matmul weights
    tables = (V + P) * E
    panes = 2 * L * capacity * E
    return (w + tables + panes) * dt_item


def gpt2_draft_burst_supported(cfg, capacity: int, dtype) -> bool:
    """The JAX gate (E % 128 == 0, V <= 2048, weights + tables + panes
    within 6 MB) and the kernel's limits (head_dim 32, 64 or 128; the
    widest of capacity and 4E in 48 KB of fp32)."""
    if cfg.n_embd % 128 or cfg.vocab_size > 2048:
        return False
    if _gpt2_draft_bytes(cfg, capacity, _item(dtype)) > DRAFT_BYTES_MAX:
        return False
    return (cfg.head_dim in BURST_HEAD_DIMS
            and max(capacity, 4 * cfg.n_embd) <= _SMEM_FLOATS)


def _llama_draft_bytes(cfg, capacity: int, dt_item: int) -> int:
    E, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.n_layer
    QW = cfg.n_head * cfg.head_dim
    KW = cfg.n_kv_head * cfg.head_dim
    w = L * (E * QW + 2 * E * KW + QW * E + 3 * E * I)
    tables = cfg.vocab_size * E + 2 * cfg.n_positions * cfg.head_dim
    panes = 2 * L * capacity * KW
    return (w + tables + panes) * dt_item


def llama_draft_burst_supported(cfg, capacity: int, dtype) -> bool:
    """The JAX gate (KW % 128 == 0, V <= 2048, even head_dim, tied
    embeddings, the 6 MB budget) and the kernel's limits (head_dim 32, 64 or
    128, whole query groups, widths in multiples of 8, the widest of
    capacity, E, the query width and I in 48 KB of fp32)."""
    KW = cfg.n_kv_head * cfg.head_dim
    if KW % 128 or cfg.vocab_size > 2048 or cfg.head_dim % 2:
        return False
    if not cfg.tie_embeddings:
        return False
    if _llama_draft_bytes(cfg, capacity, _item(dtype)) > DRAFT_BYTES_MAX:
        return False
    E, I, QW = cfg.hidden_size, cfg.intermediate_size, cfg.n_head * cfg.head_dim
    return (cfg.head_dim in BURST_HEAD_DIMS and cfg.n_head % cfg.n_kv_head == 0
            and E % 8 == 0 and I % 8 == 0
            and max(capacity, E, QW, I) <= _SMEM_FLOATS)


def pack_gpt2_draft(params: dict, cfg):
    """The burst's layout of a GPT-2 draft: the whole-step kernels'
    (`ops.megakernel.pack_gpt2_mega`; None when not packable)."""
    return mk.pack_gpt2_mega(params, cfg)


def pack_llama_draft(params: dict, cfg):
    """The burst's layout of a Llama/Qwen draft: the whole-step kernels'
    (`ops.megakernel_llama.pack_llama_mega`), whose tied `head` is the
    embedding."""
    return ml.pack_llama_mega(params, cfg)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (any device): k plain steps with token feedback.


def _burst_plain(step, embed, dk, dv, dlen, cur, k: int, V: int):
    tok, length, props = int(cur), int(dlen), []
    for _ in range(k):
        t = step(dk, dv, length, embed(tok, length))[0]
        tok = min(max(int(t), 0), V - 1)
        props.append(tok)
        length += 1
    return torch.tensor(props, dtype=torch.int32, device=dk.device), dk, dv


def gpt2_draft_burst_plain(dpk: dict, dk: torch.Tensor, dv: torch.Tensor, dlen,
                           cur, *, cfg, k: int):
    """Plain PyTorch version of `gpt2_draft_burst`: k `gpt2_megastep_plain`
    steps from token `cur` at length `dlen`, each appending its row and
    feeding its greedy token to the next. Returns (proposals int32 [k], dk,
    dv)."""
    wte, wpe = dpk["wte"], dpk["wpe"]

    def embed(tok, length):
        return (wte[tok] + wpe[min(length, cfg.n_positions - 1)])[None].to(wte.dtype)

    def step(kk, vv, length, x):
        return mk.gpt2_megastep_plain(dpk, kk, vv, length, x, cfg=cfg)

    return _burst_plain(step, embed, dk, dv, dlen, cur, k, cfg.vocab_size)


def llama_draft_burst_plain(dpk: dict, dk: torch.Tensor, dv: torch.Tensor, dlen,
                            cur, *, cfg, k: int):
    """Plain PyTorch version of `llama_draft_burst` (as
    `gpt2_draft_burst_plain`, over `llama_megastep_plain`)."""
    def embed(tok, length):
        return dpk["embed"][tok][None]

    def step(kk, vv, length, x):
        return ml.llama_megastep_plain(dpk, kk, vv, length, x, cfg=cfg)

    return _burst_plain(step, embed, dk, dv, dlen, cur, k, cfg.vocab_size)


# ---------------------------------------------------------------------------
# The kernel: arguments and launcher.


class DraftArgs(ctypes.Structure):
    """Mirror of `struct DraftArgs` in csrc/draft_burst.cu (same order)."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "family", "dtype", "n_layer", "n_embd", "n_head", "n_kv_head",
        "head_dim", "inter", "vocab", "n_pos", "capacity", "steps")] + [
        ("eps", ctypes.c_float),
    ] + [(n, ctypes.c_void_p) for n in (
        "qkv_w", "o_w", "up_w", "down_w", "embed", "wpe", "smalls", "lnf",
        "qkvb", "cos", "sin", "k", "v", "length", "tok_in", "tok_out", "x",
        "qkv", "attn", "ffn", "part_val", "part_idx")]


_lib = None


def kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("draft_burst")
        lib.elit_draft_burst.restype = ctypes.c_int
        lib.elit_draft_burst.argtypes = [ctypes.POINTER(DraftArgs), ctypes.c_void_p]
        _lib = lib
    return _lib


def _family(cfg) -> str:
    return "llama" if hasattr(cfg, "hidden_size") else "gpt2"


class BurstLauncher:
    """The prepared arguments of one draft's burst of `steps` steps; `launch()`
    issues it on the current stream and allocates nothing, so it can be
    captured. `length` and `tok_in` (int32 [1]) are read on the device;
    `tok_out` (int32 [steps]) receives the proposals. The caller advances
    the draft's length (the kernel leaves it as it is)."""

    launched = 0  # launch() calls: launches, or launches recorded into a CUDA graph

    def __init__(self, dpk: dict, cfg, k, v, length, tok_in, tok_out, steps: int):
        family = _family(cfg)
        llama = family == "llama"
        dev = k.device
        if dev.type != "cuda":
            raise ValueError(f"no kernel for device {dev}")
        dtype = dpk["embed" if llama else "wte"].dtype
        C = k.shape[-2]
        supported = llama_draft_burst_supported if llama else gpt2_draft_burst_supported
        if dtype not in mk._DTYPE_CODE or not supported(cfg, C, dtype):
            raise NotImplementedError(f"draft burst: {cfg} at capacity {C}")
        L, V, P, D = cfg.n_layer, cfg.vocab_size, cfg.n_positions, cfg.head_dim
        if llama:
            E, I, Hkv, eps = cfg.hidden_size, cfg.intermediate_size, cfg.n_kv_head, cfg.rms_eps
            QW, KW, FF = cfg.n_head * D, Hkv * D, I
            w = ("qkv_w", "o_w", "gu_w", "down_w")
            wants = {"qkv_w": (L, QW + 2 * KW, E), "o_w": (L, E, QW),
                     "gu_w": (L, 2 * I, E), "down_w": (L, E, I), "embed": (V, E)}
            f32 = {"norms": (L, 2, E), "lnf": (1, E), "cos": (P, D), "sin": (P, D)}
            if "qkvb" in dpk:
                f32["qkvb"] = (L, QW + 2 * KW)
        else:
            E, I, Hkv, eps = cfg.n_embd, 0, cfg.n_head, cfg.layer_norm_epsilon
            QW = KW = E
            FF = 4 * E
            w = ("attn_w", "proj_w", "fc_w", "fcp_w")
            wants = {"attn_w": (L, 3 * E, E), "proj_w": (L, E, E), "fc_w": (L, 4 * E, E),
                     "fcp_w": (L, E, 4 * E), "wte": (V, E), "wpe": (P, E)}
            f32 = {"smalls": (L, 13, E), "lnf": (2, E)}
        for name, shape in wants.items():
            mk._check(name, dpk[name], dtype, shape, dev)
        for name, shape in f32.items():
            mk._check(name, dpk[name], torch.float32, shape, dev)
        for name, pane in (("k", k), ("v", v)):
            mk._check(name, pane, dtype, (L, C, KW), dev)
        mk._check("length", length, torch.int32, (1,), dev)
        mk._check("tok_in", tok_in, torch.int32, (1,), dev)
        mk._check("tok_out", tok_out, torch.int32, (steps,), dev)
        ws = [torch.empty(n, dtype=dtype, device=dev) for n in (E, QW + 2 * KW, QW, FF)]
        part_val = torch.empty(_CLUSTER, dtype=torch.float32, device=dev)
        part_idx = torch.empty(_CLUSTER, dtype=torch.int32, device=dev)
        # keep every tensor the struct points at alive with the launcher
        self._refs = (dpk, k, v, length, tok_in, tok_out, ws, part_val, part_idx)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        embed = dpk["embed" if llama else "wte"]
        self.args = DraftArgs(
            int(llama), mk._DTYPE_CODE[dtype], L, E, cfg.n_head, Hkv, D, I, V, P, C, steps,
            eps, *(ptr(dpk[n]) for n in w), ptr(embed), ptr(dpk.get("wpe")),
            ptr(dpk["norms" if llama else "smalls"]), ptr(dpk["lnf"]),
            ptr(dpk.get("qkvb")), ptr(dpk.get("cos")), ptr(dpk.get("sin")),
            ptr(k), ptr(v), ptr(length), ptr(tok_in), ptr(tok_out),
            *(ptr(t) for t in ws), ptr(part_val), ptr(part_idx))
        self.device = dev

    def library(self) -> ctypes.CDLL:
        return kernels()

    def launch(self) -> None:
        lib = self.library()
        rc = lib.elit_draft_burst(ctypes.byref(self.args),
                                  torch.cuda.current_stream(self.device).cuda_stream)
        _build.check(lib, rc, "elit_draft_burst")
        self.launched += 1


def _burst(counter, dpk, dk, dv, dlen, cur, cfg, k):
    dev = dk.device
    props = torch.empty(k, dtype=torch.int32, device=dev)
    tok_in = torch.as_tensor(cur, dtype=torch.int32, device=dev).reshape(1)
    BurstLauncher(dpk, cfg, dk, dv, mk._length_tensor(dlen, dev), tok_in, props, k).launch()
    counter.launches += 1
    return props, dk, dv


def gpt2_draft_burst(dpk: dict, dk: torch.Tensor, dv: torch.Tensor, dlen, cur, *,
                     cfg, k: int):
    """k greedy GPT-2 draft steps in one launch. Returns (proposals int32
    [k], dk, dv).

    dpk: `pack_gpt2_draft(params, cfg)`; dk, dv: [L, C, E] draft panes in the
    model dtype, rows dlen .. dlen + k - 1 written in place; dlen: tokens
    already cached; cur: the round's current token (int or int32 tensor).
    Step s embeds its token at position min(dlen + s, P - 1). On a CUDA
    tensor it launches `csrc/draft_burst.cu` and counts one launch in
    `gpt2_draft_burst.launches`; on a CPU tensor it runs
    `gpt2_draft_burst_plain`.
    """
    if dk.device.type == "cpu":
        return gpt2_draft_burst_plain(dpk, dk, dv, dlen, cur, cfg=cfg, k=k)
    return _burst(gpt2_draft_burst, dpk, dk, dv, dlen, cur, cfg, k)


gpt2_draft_burst.launches = 0


def llama_draft_burst(dpk: dict, dk: torch.Tensor, dv: torch.Tensor, dlen, cur, *,
                      cfg, k: int):
    """k greedy steps of a tied Llama/Qwen draft in one launch (as
    `gpt2_draft_burst`; [L, C, KW] panes, RoPE at min(dlen + s, P - 1) from
    the packed tables). On a CUDA tensor it counts one launch in
    `llama_draft_burst.launches`; on a CPU tensor it runs
    `llama_draft_burst_plain`."""
    if dk.device.type == "cpu":
        return llama_draft_burst_plain(dpk, dk, dv, dlen, cur, cfg=cfg, k=k)
    return _burst(llama_draft_burst, dpk, dk, dv, dlen, cur, cfg, k)


llama_draft_burst.launches = 0
