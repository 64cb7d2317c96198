"""Speculative greedy decoding: propose, verify, accept (PyTorch port of
efficient_llm_inference_tpu/engine/speculative.py: `make_self_draft`,
`make_speculative_generate`, `make_ngram_speculative_generate`).

A round proposes k tokens (a draft model's k greedy steps, or the tokens
that followed the latest earlier match of the sequence's last `ngram`
tokens), verifies [current, p_1 .. p_{k-1}] in one k-row pass of the
target, accepts the longest prefix of proposals equal to the target's own
greedy tokens and emits the target's token at the first mismatch. The
output is exactly plain greedy decoding for any proposals; the proposals
only change how many tokens a round emits. Both caches roll back to the
accepted prefix by a length update (rows past it are overwritten later).

Two paths, as in the JAX package:

* megakernel (`mega`, engine `_mega_spec`): the target's verify is one
  launch of `gpt2_megaverify` / `llama_megaverify` over [L, C, W] panes
  (on its weight tier over quantized weights); a full-precision draft runs
  as one `gpt2_draft_burst` / `llama_draft_burst` launch where the burst
  takes it, else (and a quantized draft, which has no burst) as k launches
  of its whole-step kernel (`gpt2_megastep` / `llama_megastep`), else as k
  eager forward passes. On a
  card a round (proposal, verify, acceptance, length updates) is captured
  once per built configuration as a CUDA graph over static device tensors
  and replayed; the host reads the emitted count after ceil(r / k) rounds,
  r the tokens still to emit, which no round can overshoot (a round emits
  at most k), so no round is wasted. A round with an eager draft is not
  captured (the dense cache keeps its length on the host) and syncs once.
* eager (megakernel off): the model's k-row forward pass over `DenseKV`
  (which attends T > 1 rows at length > 0), one host sync a round.

Both paths run the same round (`_SpecLoop`) over a target (`_PaneTarget`,
`_DenseTarget`) and a proposer (`_Ngram`, `_DraftPanes`, `_DraftEager`).

The JAX package runs each generation as a `jax.lax.while_loop` under jit;
the CUDA graph of one round is the port's counterpart of its body.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from ..cache.kvcache import DenseKV
from ..models.registry import ModelSpec, spec_with_config
from ..ops import megakernel as mk
from ..ops import megakernel_draft as md
from ..ops import megakernel_llama as ml
from .generate import _embed, make_prefill

class _Kind(NamedTuple):
    """A model family's kernels on the speculation path (each wrapper counts
    its launches; on the CPU each runs its plain version)."""

    verify: Callable
    verify_launcher: type
    step: Callable
    step_launcher: type
    burst: Callable
    burst_supported: Callable


_KINDS = {
    "gpt2": _Kind(mk.gpt2_megaverify, mk.GPT2VerifyLauncher, mk.gpt2_megastep,
                  mk.StepLauncher, md.gpt2_draft_burst, md.gpt2_draft_burst_supported),
    "llama": _Kind(ml.llama_megaverify, ml.LlamaVerifyLauncher, ml.llama_megastep,
                   ml.LlamaStepLauncher, md.llama_draft_burst,
                   md.llama_draft_burst_supported),
}


def make_self_draft(spec: ModelSpec, params: dict, n_layers: int):
    """Truncated self-draft: the target's own first `n_layers` layers
    (shares the embeddings and the LM head, or its quantized copy; the
    block tensors, codes and scales too, are views)."""
    dspec = spec_with_config(spec, dataclasses.replace(spec.config, n_layer=n_layers))

    def first(t):  # every leaf of a block weight (JAX: jax.tree.map)
        return {k: first(v) for k, v in t.items()} if isinstance(t, dict) else t[:n_layers]

    dparams = dict(params)
    dparams["blocks"] = first(params["blocks"])
    return dspec, dparams


def spec_capacity(prompt_bucket: int, max_new_tokens: int, k: int, mega: bool) -> int:
    """Cache rows of a speculative generation: the bucket, the new tokens and
    a round's overshoot, rounded up to a multiple of 8 plus 8 on the
    megakernel path (the JAX verify kernels' capacity rule)."""
    cap = prompt_bucket + max_new_tokens + k + 1
    return -(-cap // 8) * 8 + 8 if mega else cap


# ---------------------------------------------------------------------------
# Pieces shared by every path (tensor ops on the device, JAX's semantics).


def _prefill(spec: ModelSpec, strategy, params, tokens, true_len: int):
    """(cache, the prompt's greedy next token int32 [1])."""
    cache, last = make_prefill(spec, strategy)(params, tokens, true_len)
    return cache, torch.argmax(last[0]).to(torch.int32).reshape(1)


def _write(buf: torch.Tensor, start: torch.Tensor, vals: torch.Tensor) -> None:
    """buf[start : start + n] = vals, start clamped to [0, len(buf) - n] as
    `lax.dynamic_update_slice` clamps it."""
    n = vals.shape[0]
    idx = torch.clamp(start.long(), 0, buf.shape[0] - n) + torch.arange(n, device=buf.device)
    buf[idx] = vals


def _accept(proposals: torch.Tensor, greedy: torch.Tensor):
    """JAX `_accept_and_emit`: (emitted int32 [k], n_new int32 [1]). n_acc is
    the first index where proposal and target disagree (k when none does);
    the round emits the accepted proposals and the target's token at
    n_acc, n_new = min(n_acc + 1, k) tokens, which is also how many cache
    rows each side keeps."""
    k = proposals.shape[0]
    agree = proposals == greedy
    n_acc = torch.argmin(torch.cat([agree, agree.new_zeros(1)]).to(torch.int32))
    n_acc = n_acc.to(torch.int32).reshape(1)
    ar = torch.arange(k, device=proposals.device)
    emitted = torch.where(ar < n_acc, proposals, torch.where(ar == n_acc, greedy, 0))
    n_new = torch.clamp(n_acc + 1, max=k)
    return emitted.to(torch.int32), n_new


def _propose_ngram(seq: torch.Tensor, L: torch.Tensor, k: int, ngram: int):
    """JAX `_propose`: the k tokens after the latest position p < L - 1 whose
    trailing `ngram` tokens equal the sequence's last `ngram` (seq[:L]);
    without a match, the last token k times. L: int32 [1]."""
    S = seq.shape[0]
    L = L.long()
    idx = torch.arange(S, device=seq.device)
    match = (idx >= ngram - 1) & (idx < L - 1)
    for j in range(ngram):
        tail = seq[torch.clamp(L - 1 - j, 0, S - 1)]
        match = match & (torch.roll(seq, j) == tail)
    q = torch.max(torch.where(match, idx, -1)).reshape(1)
    found = q >= 0
    base = torch.where(found, q + 1, 0)
    cont = seq[torch.clamp(base, 0, S - k) + torch.arange(k, device=seq.device)]
    last = seq[torch.clamp(L - 1, 0, S - 1)]
    return torch.where(found, cont, last).to(torch.int32)


def _init_seq(tokens: torch.Tensor, true_len: int, first: torch.Tensor, S: int):
    seq = torch.zeros(S, dtype=torch.int32, device=tokens.device)
    w = min(S, tokens.shape[1])
    seq[:w] = tokens[0, :w].to(torch.int32)
    seq[min(true_len, S - 1)] = first[0]
    return seq


def _dense(spec: ModelSpec, cap: int, dtype, device) -> DenseKV:
    return DenseKV(n_layer=spec.n_layer, n_head=spec.n_kv_head, head_dim=spec.head_dim,
                   capacity=cap, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Proposers: start(tokens, true_len, first, d_params) at a generation's
# start; propose(cur, loop) -> proposals int32 [k] on the device;
# accept(emitted, n_new) rolls the draft back to the accepted prefix.


class _Ngram:
    """Prompt-lookup proposals over the static sequence buffer."""

    capturable = True
    launcher = None

    def __init__(self, S: int, k: int, ngram: int, device):
        self.k, self.ngram = k, ngram
        self.seq = torch.zeros(S, dtype=torch.int32, device=device)
        self.true_len = torch.zeros(1, dtype=torch.int32, device=device)

    def start(self, tokens, true_len, first, d_params) -> None:
        self.seq.copy_(_init_seq(tokens, true_len, first, self.seq.shape[0]))
        self.true_len.fill_(true_len)

    def propose(self, cur, loop) -> torch.Tensor:
        self.L = self.true_len + loop.n_emitted
        return _propose_ngram(self.seq, self.L, self.k, self.ngram)

    def accept(self, emitted, n_new) -> None:
        _write(self.seq, self.L, emitted)


class _DraftPanes:
    """A draft model whose steps run on the device over [L, C, W] panes: one
    burst launch a round (`burst`), or k whole-step launches."""

    capturable = True

    def __init__(self, draft: ModelSpec, dmega: dict, cap: int, k: int, burst: bool,
                 dtype, device, d_strategy):
        self.draft, self.k, self.burst, self.cfg = draft, k, burst, dmega["cfg"]
        self.packed = dmega["burst_packed" if burst else "packed"]
        self.strategy = d_strategy
        kind = _KINDS[dmega["kind"]]
        self.step_fn, self.burst_fn = kind.step, kind.burst
        self.counter = mk.launch_counter(kind.burst if burst else kind.step, self.packed)
        W = draft.n_kv_head * draft.head_dim
        self.dk = torch.zeros(draft.n_layer, cap, W, dtype=dtype, device=device)
        self.dv = torch.zeros_like(self.dk)
        self.d_len = torch.zeros(1, dtype=torch.int32, device=device)
        self.toks = torch.zeros(k + 1, dtype=torch.int32, device=device)  # cur, then proposals
        self.launcher = None
        if self.dk.is_cuda:
            if burst:
                self.launcher = md.BurstLauncher(self.packed, self.cfg, self.dk, self.dv,
                                                 self.d_len, self.toks[:1], self.toks[1:], k)
            else:
                self.launcher = kind.step_launcher(self.packed, self.cfg, self.dk, self.dv,
                                                   self.d_len, self.toks[1:2],
                                                   tok_in=self.toks[:1], advance=True)
            self.launcher.library()  # build and load outside a capture

    def start(self, tokens, true_len, first, d_params) -> None:
        cache, _ = _prefill(self.draft, self.strategy, d_params, tokens, true_len)
        self.dk.copy_(mk.to_mega_layout(cache["k"]))
        self.dv.copy_(mk.to_mega_layout(cache["v"]))
        self.d_len.fill_(true_len)
        self.d_params = d_params

    def propose(self, cur, loop) -> torch.Tensor:
        self.toks[:1].copy_(cur)
        if self.launcher is not None and self.burst:
            self.launcher.launch()
        elif self.launcher is not None:
            for i in range(self.k):  # advance=True: each step clamps its token, length += 1
                self.launcher.set_tokens(self.toks[i:i + 1], self.toks[i + 1:i + 2])
                self.launcher.launch()
            self.d_len -= self.k  # the rollback below counts from the round's start
        elif self.burst:
            self.toks[1:].copy_(self.burst_fn(self.packed, self.dk, self.dv, self.d_len,
                                              cur, cfg=self.cfg, k=self.k)[0])
        else:
            length = int(self.d_len)
            for i in range(self.k):
                x = _embed(self.draft, self.d_params, self.toks[i], length + i)
                tok = self.step_fn(self.packed, self.dk, self.dv, length + i, x, cfg=self.cfg)[0]
                self.toks[i + 1] = tok.clamp(0, self.draft.vocab_size - 1)
        return self.toks[1:]

    def accept(self, emitted, n_new) -> None:
        self.d_len += n_new


class _DraftEager:
    """A draft model run as k eager forward passes over its DenseKV (its
    length is a host integer: rounds with it are not captured)."""

    capturable = False
    launcher = None

    def __init__(self, draft: ModelSpec, d_strategy, k: int):
        self.draft, self.strategy, self.k = draft, d_strategy, k

    def start(self, tokens, true_len, first, d_params) -> None:
        self.cache, _ = _prefill(self.draft, self.strategy, d_params, tokens, true_len)
        self.d_params = d_params

    def propose(self, cur, loop) -> torch.Tensor:
        self.len0 = self.cache["length"]
        tok, props = cur, []
        for _ in range(self.k):  # greedy, no clamp (as the JAX draft scan)
            pos = min(self.cache["length"], self.draft.n_positions - 1)
            positions = torch.full((1, 1), pos, dtype=torch.long, device=cur.device)
            logits, self.cache = self.draft.forward(self.d_params, tok.reshape(1, 1).long(),
                                                    positions, self.cache, self.strategy,
                                                    None)
            self.strategy.set_length(self.cache, self.cache["length"] + 1)
            tok = torch.argmax(logits[0, 0]).to(torch.int32).reshape(1)
            props.append(tok)
        return torch.cat(props)

    def accept(self, emitted, n_new) -> None:
        self.strategy.set_length(self.cache, self.len0 + int(n_new))  # one host sync


# ---------------------------------------------------------------------------
# Targets: start(params, cache, true_len) takes the prefill's cache;
# verify(vin [k]) -> the target's greedy tokens [k] at the k rows;
# accept(n_new) keeps the accepted prefix.


class _PaneTarget:
    """The megakernel path: one verify launch over [L, C, W] panes."""

    capturable = True

    def __init__(self, target: ModelSpec, mega: dict, k: int, cap: int, device, dtype):
        self.cfg, self.packed = mega["cfg"], mega["packed"]
        kind = _KINDS[mega["kind"]]
        self.verify_fn, launcher = kind.verify, kind.verify_launcher
        self.counter = mk.launch_counter(kind.verify, self.packed)
        i32 = dict(dtype=torch.int32, device=device)
        W = target.n_kv_head * target.head_dim
        self.tk = torch.zeros(target.n_layer, cap, W, dtype=dtype, device=device)
        self.tv = torch.zeros_like(self.tk)
        self.t_len = torch.zeros(1, **i32)
        self.vin = torch.zeros(k, **i32)
        self.greedy = torch.zeros(k, **i32)
        self.launcher = None
        if self.tk.is_cuda:
            self.launcher = launcher(self.packed, self.cfg, self.tk, self.tv, self.t_len,
                                     self.greedy, tok_in=self.vin, rows=k)
            self.launcher.library()  # build and load outside a capture

    def start(self, params, cache, true_len: int) -> None:
        self.tk.copy_(mk.to_mega_layout(cache["k"]))
        self.tv.copy_(mk.to_mega_layout(cache["v"]))
        self.t_len.fill_(true_len)

    def verify(self, vin: torch.Tensor) -> torch.Tensor:
        self.vin.copy_(vin)
        if self.launcher is not None:
            self.launcher.launch()
        else:
            self.greedy.copy_(self.verify_fn(self.packed, self.tk, self.tv, self.t_len,
                                             self.vin, cfg=self.cfg)[0])
        return self.greedy

    def accept(self, n_new) -> None:
        self.t_len += n_new


class _DenseTarget:
    """The eager path: the model's k-row forward pass over its DenseKV (the
    length is a host integer: its rounds are not captured)."""

    capturable = False
    launcher = None

    def __init__(self, target: ModelSpec, strategy, k: int):
        self.target, self.strategy, self.k = target, strategy, k

    def start(self, params, cache, true_len: int) -> None:
        self.params, self.cache = params, cache

    def verify(self, vin: torch.Tensor) -> torch.Tensor:
        self.len0 = self.cache["length"]
        pos = torch.clamp(self.len0 + torch.arange(self.k, device=vin.device),
                          max=self.target.n_positions - 1)[None]
        logits, self.cache = self.target.forward(self.params, vin[None].long(), pos,
                                                 self.cache, self.strategy, None)
        return torch.argmax(logits[0], dim=-1).to(torch.int32)

    def accept(self, n_new) -> None:
        self.strategy.set_length(self.cache, self.len0 + int(n_new))  # one host sync


class _SpecLoop:
    """Static device state of one built configuration's rounds (the emitted
    tokens and counts), the round over a target and a proposer, and, on a
    card where both allow it, the round's CUDA graph."""

    def __init__(self, target, proposer, strategy, spec: ModelSpec, max_new: int, k: int,
                 device):
        self.target, self.proposer, self.strategy = target, proposer, strategy
        self.spec, self.k, self.n = spec, k, max_new
        i32 = dict(dtype=torch.int32, device=device)
        self.out = torch.zeros(max_new + k, **i32)
        self.n_emitted = torch.zeros(1, **i32)
        self.n_rounds = torch.zeros(1, **i32)
        self.cuda = torch.device(device).type == "cuda"
        self.graph = None
        self.host_syncs = 0

    def round(self) -> None:
        cur = self.out[(self.n_emitted - 1).long()]  # [1]
        props = self.proposer.propose(cur, self)
        greedy = self.target.verify(torch.cat([cur, props[:-1]]))
        emitted, n_new = _accept(props, greedy)
        _write(self.out, self.n_emitted, emitted)
        self.proposer.accept(emitted, n_new)
        self.target.accept(n_new)
        self.n_emitted += n_new
        self.n_rounds += 1

    def _launchers(self) -> list:
        """(launcher, wrapper) of each part that launches its kernel itself."""
        return [(p.launcher, p.counter) for p in (self.target, self.proposer)
                if p.launcher is not None]

    def _capture(self) -> None:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # first use of every op, outside the capture
            self.round()
        torch.cuda.current_stream().wait_stream(side)
        before = [launcher.launched for launcher, _ in self._launchers()]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.round()
        # the launches recorded into the graph: each replay launches them
        self.per_replay = [(fn, launcher.launched - n) for (launcher, fn), n
                           in zip(self._launchers(), before)]

    def run(self, t_params, d_params, tokens, true_len: int):
        captured = self.cuda and self.target.capturable and self.proposer.capturable
        if captured and self.graph is None:
            self._capture()
        cache, first = _prefill(self.spec, self.strategy, t_params, tokens, true_len)
        self.target.start(t_params, cache, true_len)
        self.out.zero_()
        self.out[:1] = first
        self.n_emitted.fill_(1)
        self.n_rounds.zero_()
        self.proposer.start(tokens, true_len, first, d_params)
        n, self.host_syncs = 1, 0
        while n < self.n:
            rounds = -(-(self.n - n) // self.k)  # no round can overshoot
            before = [launcher.launched for launcher, _ in self._launchers()]
            for _ in range(rounds):
                if captured:
                    self.graph.replay()
                else:
                    self.round()
            if captured:
                for fn, per_replay in self.per_replay:
                    fn.launches += per_replay * rounds
            else:  # the parts' own launches, made eagerly
                for (launcher, fn), b in zip(self._launchers(), before):
                    fn.launches += launcher.launched - b
            n = int(self.n_emitted)
            self.host_syncs += 1
        return self.out.clone(), min(n, self.n), int(self.n_rounds)


def _result(out, n, n_rounds, stats):
    return (out, n, n_rounds) if stats else (out, n)


def _target(target: ModelSpec, mega: Optional[dict], k: int, cap: int, strategy, device,
            dtype):
    if mega is None:
        return _DenseTarget(target, strategy, k)
    return _PaneTarget(target, mega, k, cap, device, dtype)


def _generator(build, stats: bool, with_draft: bool):
    """The generation function over a loop per device (the tokens'), built
    at first use; `generate.host_syncs` holds the last generation's reads
    of the emitted count."""
    loops = {}

    def run(t_params, d_params, tokens, true_len: int):
        if tokens.device not in loops:
            loops[tokens.device] = build(tokens.device)
        loop = loops[tokens.device]
        out = loop.run(t_params, d_params, tokens, true_len)
        generate.host_syncs = loop.host_syncs
        return _result(*out, stats)

    if with_draft:
        generate = run
    else:
        def generate(t_params, tokens, true_len: int):
            return run(t_params, None, tokens, true_len)
    return generate


def make_speculative_generate(target: ModelSpec, draft: ModelSpec, max_new_tokens: int,
                              k: int = 4, prompt_bucket: int = 128,
                              mega: Optional[dict] = None, dtype=torch.float32,
                              stats: bool = False, draft_mega: Optional[dict] = None):
    """generate(t_params, d_params, tokens [1, bucket], true_len) ->
    (out int32 [max_new + k], n_emitted) — or, with `stats`, (out,
    n_emitted, n_rounds) — with a draft model's greedy proposals (target and
    draft share the vocabulary). `mega` (engine `_mega_spec`: "packed",
    "cfg", "kind") runs the target's verify as one megakernel launch a
    round; `draft_mega` ("cfg", "kind", and "packed" where the draft's
    whole-step kernels take it, "burst_packed" where the burst's layout
    exists) runs the draft on the device (`draft_route`); else the draft
    runs k eager forward passes. The generation's device is the tokens'."""
    if target.vocab_size != draft.vocab_size:
        raise ValueError("target and draft must share the vocabulary")
    if draft_mega is not None and mega is None:
        raise ValueError("draft_mega requires the mega verify path")
    if mega is not None and not 1 <= k <= mk.MAX_VERIFY_ROWS:
        raise ValueError(f"the megakernel verify takes k <= {mk.MAX_VERIFY_ROWS}, got {k}")
    cap = spec_capacity(prompt_bucket, max_new_tokens, k, mega is not None)
    route = draft_route(draft, draft_mega, cap, dtype)

    def build(dev):
        t_strategy, d_strategy = _dense(target, cap, dtype, dev), _dense(draft, cap, dtype, dev)
        proposer = (_DraftEager(draft, d_strategy, k) if route == "eager" else
                    _DraftPanes(draft, draft_mega, cap, k, route == "burst", dtype, dev,
                                d_strategy))
        return _SpecLoop(_target(target, mega, k, cap, t_strategy, dev, dtype), proposer,
                         t_strategy, target, max_new_tokens, k, dev)

    return _generator(build, stats, with_draft=True)


def draft_route(draft: ModelSpec, draft_mega: Optional[dict], cap: int, dtype) -> str:
    """How the megakernel path runs a draft: "burst" (one launch a round),
    "step" (k whole-step launches) or "eager" (k forward passes)."""
    if draft_mega is None:
        return "eager"
    if (draft_mega.get("burst_packed") is not None
            and _KINDS[draft_mega["kind"]].burst_supported(draft_mega["cfg"], cap, dtype)):
        return "burst"
    return "step" if draft_mega.get("packed") is not None else "eager"


def make_ngram_speculative_generate(target: ModelSpec, max_new_tokens: int, k: int = 8,
                                    ngram: int = 2, prompt_bucket: int = 128,
                                    mega: Optional[dict] = None, dtype=torch.float32,
                                    stats: bool = False):
    """Prompt-lookup decoding: generate(t_params, tokens [1, bucket],
    true_len) -> (out int32 [max_new + k], n_emitted) — or, with `stats`,
    (out, n_emitted, n_rounds). Each round proposes the k tokens that
    followed the latest earlier match of the sequence's last `ngram` tokens
    (no draft model); with `mega` the verify is one megakernel launch a
    round, as in `make_speculative_generate`."""
    if mega is not None and not 1 <= k <= mk.MAX_VERIFY_ROWS:
        raise ValueError(f"the megakernel verify takes k <= {mk.MAX_VERIFY_ROWS}, got {k}")
    cap = spec_capacity(prompt_bucket, max_new_tokens, k, mega is not None)

    def build(dev):
        strategy = _dense(target, cap, dtype, dev)
        # the sequence buffer (prompt + emitted tokens) has the cache's rows
        return _SpecLoop(_target(target, mega, k, cap, strategy, dev, dtype),
                         _Ngram(cap, k, ngram, dev), strategy, target, max_new_tokens, k, dev)

    return _generator(build, stats, with_draft=False)
