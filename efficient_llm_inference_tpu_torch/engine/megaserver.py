"""Continuous batching over the batched whole-step kernels (PyTorch port of
efficient_llm_inference_tpu/engine/megaserver.py: `MegaPoolConfig`,
`MegaBatchServer`).

Per-slot [C] panes live in one [L, B, C, W] pool on the card. The server
admits requests between decode chunks and decodes every slot together:

* admission: a wave of queued requests (padded to a power of two up to 32,
  pad rows repeating the last request) is prefilled in one batched eager
  forward pass with per-row lengths (engine/generate.py's right-padded
  prefill), the dense cache converts to the batch layout (quantized once
  for an int8/int4/mixed pool) and the wave's pane columns are written into
  the admitted slots;
* plain decode: a chunk is `max_chunk` steps of the batched chain (#14-#17,
  ops/megakernel_batch.py), each followed by lengths = min(lengths +
  active, C - 1) and toks = where(active, new, toks); on a card the chunk
  is one CUDA graph over static buffers (pools, lengths, tokens, active
  mask), replayed once a chunk;
* speculative decode (`spec="ngram"`): a chunk is 16 rounds, each a
  per-slot prompt-lookup proposal mined from the slot's token stream on the
  device, one launch of the batched verify (#18-#21,
  ops/megakernel_batch_verify.py) over R rows a slot, and greedy acceptance
  with rollback by length (slen = min(slen + n_new, C - 8)); one CUDA graph
  per (chunk, R). The verify width R follows the acceptance EMA's ladder
  (2 .. spec_k) from burst to burst.

The host schedules bursts of chunks and reads the device once a burst.
Slots that finish inside a burst decode on as zombies into their own panes
(discarded at harvest, overwritten at the next admission), exactly as in
the JAX server, so every request's tokens are the JAX server's: plain
greedy (of the pool's KV kind) while prompt + 1 + max_new fits the pane
(C - 1, spec: C - 8), past that the JAX server's frozen-context tokens.
Shared-prefix caching (`enable_prefix_cache`) is not ported.

The pools' dtype is the JAX server's `dtype` (bf16 by default), apart from
the weights': the prefill writes its cache in it, and with panes in that
dtype (no `kv_mode`) the decode kernels compute in it, as JAX's compute in
the panes' dtype on weight tiles cast to it; they take a copy of the packed
weights cast once to it (`ops.megakernel.cast_packed`: the norms' gains,
biases and int8 scales stay fp32, as JAX keeps its smalls). The kernels
embed a token from that copy: GPT-2's wte and wpe rows are each rounded
to the pools' dtype before their sum is, where JAX rounds the fp32 sum
once (tests/test_torch_megaserver_dtype.py: no request of its GPT-2
cases parts from JAX's server either way). Quantized pools
decode in the weights' dtype, as JAX's (its quantized kernels compute in
x_emb's dtype).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..cache.kvcache import DenseKV
from ..models.registry import ModelSpec
from ..ops import megakernel as mk
from ..ops import megakernel_batch as mkb
from ..ops import megakernel_batch_quant as mbq
from ..ops import megakernel_batch_verify as mbv
from ..ops import megakernel_llama as ml
from ..ops.megakernel_quant import _kv_kinds, _pane_width
from .batching import Request
from .generate import bucket_for, prefill_batch


@dataclasses.dataclass(frozen=True)
class MegaPoolConfig:
    n_slots: int = 16
    capacity: int = 128  # per-slot pane length (tokens), multiple of 8
    max_chunk: int = 32  # decode steps fused into one dispatch
    prompt_bucket: int = 256


_WAVE_BUCKETS = (1, 2, 4, 8, 16, 32)


class _Family(NamedTuple):
    """A model family's packer, gates and kernels on the server's paths
    (each wrapper counts its launches; on the CPU each runs its plain
    version)."""

    pack: Callable
    step_ok: Callable
    step_quant_ok: Callable
    verify_ok: Callable
    verify_quant_ok: Callable
    step: Callable
    step_quant: Callable
    step_launcher: type
    verify: Callable
    verify_quant: Callable
    verify_launcher: type


_FAMILIES = {
    "gpt2": _Family(mk.pack_gpt2_mega, mkb.mega_batch_supported,
                    mbq.mega_batch_quant_supported, mbv.mega_batch_verify_supported,
                    mbv.mega_batch_verify_quant_supported, mkb.gpt2_megabatch,
                    mbq.gpt2_megabatch_quant, mkb.GPT2BatchLauncher,
                    mbv.gpt2_megabatch_verify, mbv.gpt2_megabatch_verify_quant,
                    mbv.GPT2BatchVerifyLauncher),
    "llama": _Family(ml.pack_llama_mega, mkb.llama_mega_batch_supported,
                     mbq.llama_mega_batch_quant_supported,
                     mbv.llama_mega_batch_verify_supported,
                     mbv.llama_mega_batch_verify_quant_supported, mkb.llama_megabatch,
                     mbq.llama_megabatch_quant, mkb.LlamaBatchLauncher,
                     mbv.llama_megabatch_verify, mbv.llama_megabatch_verify_quant,
                     mbv.LlamaBatchVerifyLauncher),
}


def _weights(params: dict) -> torch.Tensor:
    return params["wte"] if "wte" in params else params["embed"]


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A host array on `device`; to a card through pinned memory without
    blocking the host (the copy is ordered on the current stream)."""
    t = torch.from_numpy(np.ascontiguousarray(arr)).clone()
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _propose(seq: torch.Tensor, slen: torch.Tensor, R: int, ngram: int) -> torch.Tensor:
    """Per-slot prompt lookup, JAX `propose`: [B, S] streams, [B] lengths ->
    [B, R] proposals. The latest position q < slen - 1 whose trailing
    `ngram` tokens (torch.roll, as jnp.roll) equal the slot's last `ngram`
    proposes the R tokens after it (start clamped to S - R, as
    `lax.dynamic_slice`); without a match, the slot's last token R times."""
    B, S = seq.shape
    idx = torch.arange(S, device=seq.device)[None]
    last = slen.long()[:, None] - 1
    match = (idx >= ngram - 1) & (idx < last)
    for j in range(ngram):
        tail = seq.gather(1, torch.clamp(last - j, min=0))
        match = match & (torch.roll(seq, j, dims=1) == tail)
    q = torch.where(match, idx, -1).amax(dim=1)
    found = q >= 0
    base = torch.clamp(torch.where(found, q + 1, 0), 0, S - R)
    cont = seq.gather(1, base[:, None] + torch.arange(R, device=seq.device)[None])
    return torch.where(found[:, None], cont, seq.gather(1, last).expand(B, R))


class MegaBatchServer:
    """Dense-pane continuous batching: megakernel decode for full waves."""

    # with an eos_id, bursts are speculative (EOS retirements are only
    # discovered at the fetch): cap them so zombie decode and admission
    # delay stay bounded while fetches amortize over several chunks
    _EOS_BURST_CAP = 4
    # spec bursts: chunks of 16 verify rounds, at most 8 chunks a burst
    _SPEC_BURST_CAP = 8
    _SPEC_CHUNK = 16

    def __init__(
        self,
        model: ModelSpec,
        params: dict,
        pool: MegaPoolConfig = MegaPoolConfig(),
        dtype: torch.dtype = torch.bfloat16,
        eos_id: Optional[int] = None,
        kv_mode: Optional[str] = None,
        interpret: bool = False,
        spec: Optional[str] = None,
        spec_k: int = 8,
        ngram_n: int = 2,
        enable_prefix_cache: bool = False,
        prefix_grain: int = 64,
        prefix_cache_max: int = 4,
    ):
        """The JAX server's arguments and defaults. The pools live on the
        params' device in `dtype` (bf16 or fp32, over bf16 or fp32 weights;
        the module docstring says what it sets); `interpret` (a Pallas
        switch) is accepted and ignored.
        `spec="ngram"` turns every decode chunk into speculative rounds
        (greedy acceptance: per-request outputs equal the plain server's of
        the same kv_mode); spec_k <= 8. Size panes so prompt + 1 + max_new
        <= capacity - 8 in spec mode (capacity - 1 plain): past that the
        cursor clamps and tokens are computed against a frozen context, as
        in the JAX server. `enable_prefix_cache=True` raises
        NotImplementedError (ROADMAP.md Queue 1 item 13). Weight-quantized
        params (`Config.weight_quant`) serve on the kernels' weight tiers."""
        if enable_prefix_cache:
            raise NotImplementedError(
                "MegaBatchServer's shared-prefix caching is not ported yet "
                "(ROADMAP.md Queue 1 item 13); pass enable_prefix_cache=False")
        assert pool.capacity % 8 == 0, "pane length must be 8-aligned"
        wdtype = _weights(params).dtype
        if dtype not in mk._DTYPE_CODE:
            raise ValueError(f"pools in {dtype}: the kernels take float32 or bfloat16")
        self.model = model
        self.params = params
        self.pool_cfg = pool
        self.dtype = dtype  # the pools' and the prefill cache's
        # the decode kernels' dtype: the panes' (fp pools), else the weights'
        self._cdtype = wdtype if kv_mode else dtype
        self.device = _weights(params).device
        self.eos_id = eos_id
        self.kv_mode = kv_mode  # None = panes in the model dtype; int8/int4/mixed
        self.spec = spec
        self.spec_k = spec_k
        self.ngram_n = ngram_n
        # live acceptance estimate (booked tokens / productive round) and
        # the verify width it steers; both persist across run() calls
        self._acc_est = 2.0
        self._spec_R = spec_k
        self.spec_stats = {"rounds": 0, "tokens": 0}
        cfg = model.config
        fam = _FAMILIES.get(model.name)
        B, C = pool.n_slots, pool.capacity
        if spec is not None:
            if spec != "ngram":
                raise ValueError(f"unknown spec mode: {spec!r}")
            if fam is None:
                raise ValueError("spec serving needs a gpt2- or llama-family model")
            ok_spec = (fam.verify_quant_ok(cfg, C, params, B, spec_k, kv_mode) if kv_mode
                       else fam.verify_ok(cfg, C, params, B, spec_k))
            if not ok_spec:
                raise ValueError(
                    "batched verify megakernel unsupported at this "
                    "(model, n_slots, capacity, spec_k)"
                )
        if fam is None:
            raise ValueError(f"unsupported model family: {model.name}")
        ok = (fam.step_quant_ok(cfg, C, params, B, kv_mode) if kv_mode
              else fam.step_ok(cfg, C, params, B))
        if not ok:
            raise ValueError(
                "batched megakernel unsupported at this (model, n_slots, "
                "capacity) — use ContinuousBatchingEngine"
            )
        self._fam = fam
        self.packed = fam.pack(params, cfg)
        assert self.packed is not None, "params not packable"
        if self._cdtype != wdtype:
            self.packed = mk.cast_packed(self.packed, self._cdtype)

        L, KW, dev = model.n_layer, model.n_kv_head * model.head_dim, self.device
        if kv_mode:
            k_kind, v_kind = _kv_kinds(kv_mode)
            self.k_pool = torch.zeros((L, B, C, _pane_width(k_kind, KW)), dtype=torch.int8,
                                      device=dev)
            self.v_pool = torch.zeros((L, B, C, _pane_width(v_kind, KW)), dtype=torch.int8,
                                      device=dev)
            self.ks_pool = torch.ones((L, B, C), dtype=torch.float32, device=dev)
            self.vs_pool = torch.ones((L, B, C), dtype=torch.float32, device=dev)
        else:
            self.k_pool = torch.zeros((L, B, C, KW), dtype=dtype, device=dev)
            self.v_pool = torch.zeros((L, B, C, KW), dtype=dtype, device=dev)
            self.ks_pool = self.vs_pool = None
        # host mirrors
        self.lengths = np.zeros((B,), np.int32)
        self.active = np.zeros((B,), bool)
        self.last_token = np.zeros((B,), np.int32)
        self.slot_req: List[Optional[Request]] = [None] * B
        # spec mode: each slot's token stream (prompt + emitted) lives on the
        # device (seq_dev [B, C], slen_dev [B]); admission writes the prompt
        # and the prefill token there with no host read, and the first burst
        # books that token (`pending` slots; `plen` is where it sits)
        self.slen = np.ones((B,), np.int32)  # host mirror (scheduling)
        if spec is not None:
            self.seq_dev = torch.zeros((B, C), dtype=torch.int32, device=dev)
            self.slen_dev = torch.ones((B,), dtype=torch.int32, device=dev)
        self.pending = np.zeros((B,), bool)
        self.plen = np.zeros((B,), np.int32)
        # the static device state the decode chunks read and write: plain
        # chunks' lengths and tokens, and every chunk's active mask
        self._lengths_dev = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._toks_dev = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._active_dev = torch.zeros((B,), dtype=torch.bool, device=dev)
        self._chunks: Dict = {}

    def _embed(self, toks: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """The decode kernels' input rows of tokens `toks` at positions
        `pos` (clamped to P - 1), as the kernels embed them from the packed
        weights (in the kernels' dtype): GPT-2's wte and wpe rows summed in
        fp32, the sum rounded."""
        pos = torch.clamp(pos, max=self.model.n_positions - 1).long()
        if self.model.name == "llama":
            return self.packed["embed"][toks.long()]
        wte = self.packed["wte"]
        return (wte[toks.long()].float() + self.packed["wpe"][pos].float()).to(wte.dtype)

    # ------------------------------------------------------------------
    def _pools(self) -> tuple:
        if self.kv_mode:
            return self.k_pool, self.v_pool, self.ks_pool, self.vs_pool
        return self.k_pool, self.v_pool

    def _prefill_wave(self, tokens: np.ndarray, true_lens: np.ndarray, slots: np.ndarray):
        """Prefill W prompts (per-row lengths) into W slots: one batched
        forward pass, the panes (quantized for a quant pool) written into the
        slots' columns in wave order (a pad row rewrites its request's slot
        with the same values); spec mode also writes each prompt and its
        first token into the slot's token stream. Returns the first tokens
        int32 [W] on the device."""
        model, dev = self.model, self.device
        W, Tpad = tokens.shape
        strategy = DenseKV(n_layer=model.n_layer, n_head=model.n_kv_head,
                           head_dim=model.head_dim, capacity=self.pool_cfg.capacity, batch=W,
                           dtype=self.dtype, device=dev)
        toks = _to_device(tokens.astype(np.int64), dev)
        cache, tok0 = prefill_batch(model, strategy, self.params, toks,
                                    _to_device(true_lens.astype(np.int64), dev))
        kb = mkb.to_mega_layout_batch(cache["k"])
        vb = mkb.to_mega_layout_batch(cache["v"])
        wave = (mbq.quantize_panes_batch(kb, vb, self.kv_mode) if self.kv_mode
                else (kb, vb))
        for w, slot in enumerate(slots.tolist()):
            for pool, panes in zip(self._pools(), wave):
                pool[:, slot].copy_(panes[:, w])
        if self.spec is not None:
            for w, (slot, n) in enumerate(zip(slots.tolist(), true_lens.tolist())):
                self.seq_dev[slot, :Tpad].copy_(toks[w])
                self.seq_dev[slot, n].copy_(tok0[w])
                self.slen_dev[slot].fill_(n + 1)
        return tok0

    def _admit(self, queue: List[Request]) -> int:
        """Prefill a wave of queued requests into free slots."""
        C = self.pool_cfg.capacity
        # spec mode needs room for a 16-row verify window at the cursor
        margin = 16 if self.spec else 8
        free = [s for s in range(self.pool_cfg.n_slots) if not self.active[s]]
        wave = []
        while queue and free:
            req = queue[0]
            ids = req.prompt_ids[: self.pool_cfg.prompt_bucket]
            if len(ids) >= C - (margin - 8):  # cannot fit prompt + 1 token
                ids = ids[: C - margin]
            wave.append((free.pop(0), queue.pop(0), ids))
        if not wave:
            return 0
        return self._dispatch_group(wave)

    def _dispatch_group(self, wave) -> int:
        """Prefill one admission wave in one dispatch."""
        C = self.pool_cfg.capacity
        margin = 16 if self.spec else 8
        Tmax = max(len(ids) for _, _, ids in wave)
        Tpad = min(bucket_for(Tmax), self.pool_cfg.prompt_bucket)
        Tpad = min(Tpad, C - margin)
        W = next(w for w in _WAVE_BUCKETS if w >= len(wave))
        buf = np.zeros((W, Tpad), np.int32)
        lens = np.zeros((W,), np.int32)
        slots = np.zeros((W,), np.int32)
        for w in range(W):
            slot, req, ids = wave[min(w, len(wave) - 1)]  # pad = repeat last
            ids = ids[:Tpad]
            buf[w, : len(ids)] = ids
            lens[w] = len(ids)
            slots[w] = slot
        tok0 = self._prefill_wave(buf, lens, slots)
        if self.spec:
            # device-side admission: the prompt and the prefill token are in
            # seq_dev; the first burst's fetch books the token
            for slot, req, ids in wave:
                ids = ids[:Tpad]
                self.slot_req[slot] = req
                self.active[slot] = True
                self.pending[slot] = True
                self.plen[slot] = len(ids)
                self.lengths[slot] = len(ids)
                self.slen[slot] = len(ids) + 1
            return len(wave)
        tok0 = tok0.cpu().numpy()
        for w, (slot, req, ids) in enumerate(wave):
            ids = ids[:Tpad]
            self.slot_req[slot] = req
            self.active[slot] = True
            self.lengths[slot] = len(ids)
            self.last_token[slot] = int(tok0[w])
            req.out_ids.append(int(tok0[w]))
            if len(req.out_ids) >= req.max_new_tokens or (
                self.eos_id is not None and req.out_ids[-1] == self.eos_id
            ):  # satisfied by the prefill token alone
                req.done = True
                self.active[slot] = False
                self.slot_req[slot] = None
                self.lengths[slot] = 0
        return len(wave)

    # ------------------------------------------------------------------
    def _plain_step(self, launcher=None, out=None):
        """One batched step of every slot from the static state (lengths,
        tokens, active mask): the kernel chain through `launcher` on a card
        (its token goes to `out`), else the plain batched step; then the
        JAX chunk's bookkeeping. Returns the step's tokens [B]."""
        model, C = self.model, self.pool_cfg.capacity
        lengths, toks, active = self._lengths_dev, self._toks_dev, self._active_dev
        if launcher is not None:
            launcher.set_tokens(toks, out)
            launcher.launch()
            tok2 = out
        else:
            x = self._embed(toks, lengths)
            if self.kv_mode:
                tok2 = self._fam.step_quant(self.packed, *self._pools(), lengths, x,
                                            cfg=model.config, kv_mode=self.kv_mode)[0]
            else:
                tok2 = self._fam.step(self.packed, *self._pools(), lengths, x,
                                      cfg=model.config)[0]
        tok2.clamp_(0, model.vocab_size - 1)
        # inactive slots idle at their cursor; finished-in-chunk slots
        # overshoot but never past the pane end
        lengths.copy_(torch.clamp(lengths + active.to(torch.int32), max=C - 1))
        toks.copy_(torch.where(active, tok2, toks))
        return tok2

    def _plain_chunk(self, n_steps: int) -> Callable:
        """chunk() -> tokens [n_steps, B]: n_steps batched steps, one CUDA
        graph on a card (replayed per chunk; the step wrapper's launch count
        grows a replay by the launches recorded into the graph, n_steps)."""
        if n_steps in self._chunks:
            return self._chunks[n_steps]
        B = self.pool_cfg.n_slots
        counter = mk.launch_counter(self._fam.step_quant if self.kv_mode else self._fam.step,
                                    self.packed)
        toks_all = torch.zeros((n_steps, B), dtype=torch.int32, device=self.device)
        if self.device.type != "cuda":
            def chunk():
                for i in range(n_steps):
                    toks_all[i] = self._plain_step()
                return toks_all
        else:
            kinds = _kv_kinds(self.kv_mode) if self.kv_mode else ("fp", "fp")
            launcher = self._fam.step_launcher(
                self.packed, self.model.config, self.k_pool, self.v_pool, self._lengths_dev,
                toks_all[0], ks=self.ks_pool, vs=self.vs_pool,
                k_kind=kinds[0], v_kind=kinds[1], tok_in=self._toks_dev)
            launcher.library()  # build and load outside the capture
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for i in range(n_steps):
                    self._plain_step(launcher, toks_all[i])
            per_replay = launcher.launched  # the launches recorded into the graph

            def chunk():
                graph.replay()
                counter.launches += per_replay
                return toks_all

            chunk.graph, chunk.launcher = graph, launcher  # alive with the chunk
        self._chunks[n_steps] = chunk
        return chunk

    def _spec_round(self, R: int, verify: Callable, em: torch.Tensor, nn: torch.Tensor) -> None:
        """One speculative round of every slot (JAX `_make_spec_chunk`'s
        round_): proposals, `verify(vin [B, R], cur [B]) -> greedy [B, R]`,
        acceptance, the stream update at slen (start clamped to C - R, as
        `lax.dynamic_update_slice`) and slen = min(slen + n_new, C - 8);
        the emitted tokens [B, R] and counts [B] go to em and nn."""
        model, C = self.model, self.pool_cfg.capacity
        seq, slen, active = self.seq_dev, self.slen_dev, self._active_dev
        B, dev = seq.shape[0], seq.device
        props = _propose(seq, slen, R, self.ngram_n)
        cur = seq.gather(1, slen.long()[:, None] - 1)
        vin = torch.cat([cur, props[:, :-1]], dim=1).clamp(0, model.vocab_size - 1)
        greedy = verify(vin, slen - 1).clamp(0, model.vocab_size - 1)
        agree = (props == greedy).to(torch.int32)
        n_acc = torch.argmin(torch.cat([agree, agree.new_zeros((B, 1))], dim=1), dim=1)
        n_acc = n_acc.to(torch.int32)[:, None]  # first mismatch (R if none)
        ar = torch.arange(R + 1, device=dev)[None]
        prop_pad = torch.cat([props, props.new_zeros((B, 1))], dim=1)
        greedy_pad = torch.cat([greedy, greedy[:, -1:]], dim=1)
        emitted = torch.where(ar < n_acc, prop_pad,
                              torch.where(ar == n_acc, greedy_pad, 0))[:, :R]
        n_new = torch.where(n_acc[:, 0] == R, R, n_acc[:, 0] + 1)
        n_new = torch.where(active, n_new, 0).to(torch.int32)
        start = torch.clamp(slen.long(), 0, C - R)[:, None]
        seq.scatter_(1, start + torch.arange(R, device=dev)[None], emitted.to(torch.int32))
        # rollback is a length update; the clamp keeps the verify window
        # in the pane (zombie past it, as the plain path's C - 1 clamp)
        slen.copy_(torch.clamp(slen + n_new, max=C - 8))
        em.copy_(emitted)
        nn.copy_(n_new)

    def _spec_chunk(self, n_rounds: int, R: int) -> Callable:
        """chunk() -> (emitted [n_rounds, B, R], counts [n_rounds, B]):
        n_rounds speculative rounds at verify width R, one CUDA graph per
        (n_rounds, R) on a card (the verify wrapper's launch count grows a
        replay by the launches recorded into the graph, n_rounds)."""
        key = ("spec", n_rounds, R)
        if key in self._chunks:
            return self._chunks[key]
        B, dev, cfg = self.pool_cfg.n_slots, self.device, self.model.config
        quant = self._fam.verify_quant if self.kv_mode else self._fam.verify
        counter = mk.launch_counter(quant, self.packed)
        em = torch.zeros((n_rounds, B, R), dtype=torch.int32, device=dev)
        nn = torch.zeros((n_rounds, B), dtype=torch.int32, device=dev)
        if dev.type != "cuda":
            def verify(vin, cur):
                kw = {"kv_mode": self.kv_mode} if self.kv_mode else {}
                return quant(self.packed, *self._pools(), cur, vin.reshape(-1), cfg=cfg,
                             **kw)[0]

            def chunk():
                for i in range(n_rounds):
                    self._spec_round(R, verify, em[i], nn[i])
                return em, nn
        else:
            kinds = _kv_kinds(self.kv_mode) if self.kv_mode else ("fp", "fp")
            vin_buf = torch.zeros((B * R,), dtype=torch.int32, device=dev)
            cur_buf = torch.zeros((B,), dtype=torch.int32, device=dev)
            greedy = torch.zeros((B * R,), dtype=torch.int32, device=dev)
            launcher = self._fam.verify_launcher(
                self.packed, cfg, self.k_pool, self.v_pool, cur_buf, greedy,
                ks=self.ks_pool, vs=self.vs_pool, k_kind=kinds[0], v_kind=kinds[1], rows=R,
                tok_in=vin_buf)
            launcher.library()  # build and load outside the capture

            def verify(vin, cur):
                vin_buf.copy_(vin.reshape(-1))
                cur_buf.copy_(cur)
                launcher.launch()
                return greedy.reshape(B, R)

            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for i in range(n_rounds):
                    self._spec_round(R, verify, em[i], nn[i])
            per_replay = launcher.launched  # the launches recorded into the graph

            def chunk():
                graph.replay()
                counter.launches += per_replay
                return em, nn

            chunk.graph, chunk.launcher = graph, launcher  # alive with the chunk
        self._chunks[key] = chunk
        return chunk

    # ------------------------------------------------------------------
    def _harvest(self, toks_all: np.ndarray) -> None:
        """Book a fetched [chunk, B] token block; retire finished slots."""
        n_steps = toks_all.shape[0]
        for slot in range(self.pool_cfg.n_slots):
            req = self.slot_req[slot]
            if req is None or not self.active[slot]:
                continue
            for i in range(n_steps):
                if len(req.out_ids) >= req.max_new_tokens:
                    break
                if (self.eos_id is not None and req.out_ids
                        and req.out_ids[-1] == self.eos_id):
                    break
                # last_token is not updated here: the device carry already
                # holds the next feed token for continuing slots
                req.out_ids.append(int(toks_all[i, slot]))
            hit_eos = (
                self.eos_id is not None
                and req.out_ids
                and req.out_ids[-1] == self.eos_id
            )
            if hit_eos or len(req.out_ids) >= req.max_new_tokens:
                req.done = True
                self.active[slot] = False
                self.slot_req[slot] = None
                self.lengths[slot] = 0
                self.last_token[slot] = 0

    def _harvest_spec(self, em: np.ndarray, nn: np.ndarray):
        """Book a fetched spec block (em [rounds, B, R], nn [rounds, B]).

        Returns (rounds_used, tokens_booked) summed over slots: the live
        acceptance sample that drives burst scheduling (zombie rounds after
        a slot met its budget are excluded)."""
        n_rounds = em.shape[0]
        rounds_used = 0
        tokens_booked = 0
        for slot in range(self.pool_cfg.n_slots):
            req = self.slot_req[slot]
            if req is None or not self.active[slot]:
                continue
            for i in range(n_rounds):
                if len(req.out_ids) >= req.max_new_tokens:
                    break
                if (self.eos_id is not None and req.out_ids
                        and req.out_ids[-1] == self.eos_id):
                    break
                rounds_used += 1
                take = int(nn[i, slot])
                for j in range(take):
                    if len(req.out_ids) >= req.max_new_tokens:
                        break
                    if (self.eos_id is not None and req.out_ids
                            and req.out_ids[-1] == self.eos_id):
                        break
                    req.out_ids.append(int(em[i, slot, j]))
                    tokens_booked += 1
            hit_eos = (
                self.eos_id is not None
                and req.out_ids
                and req.out_ids[-1] == self.eos_id
            )
            if hit_eos or len(req.out_ids) >= req.max_new_tokens:
                req.done = True
                self.active[slot] = False
                self.slot_req[slot] = None
                self.lengths[slot] = 0
                self.slen[slot] = 1
                self.last_token[slot] = 0
        return rounds_used, tokens_booked

    def _ladder_next(self, R_cur: int) -> int:
        """Adaptive verify width from the live acceptance EMA: widen when the
        current width saturates, shrink toward the R = 2 floor on streams
        that accept little, else hold."""
        if self._acc_est >= 0.75 * R_cur and R_cur < self.spec_k:
            return min(R_cur * 2, self.spec_k)
        if self._acc_est < 1.3 and R_cur > 2:
            return max(2, R_cur // 2)
        return R_cur

    def _run_spec(
        self, requests: List[Request], progress: Optional[Callable]
    ) -> List[Request]:
        """Speculative serve loop: chunks count verify rounds; bursts are
        sized from the live acceptance estimate; one host read a burst.
        Overshoot is discarded at harvest, so per-request outputs match the
        plain server's either way."""
        queue = list(requests)
        chunk = min(self.pool_cfg.max_chunk, self._SPEC_CHUNK)
        total_steps = 0
        self.spec_stats = {"rounds": 0, "tokens": 0}
        B = self.pool_cfg.n_slots
        while queue or self.active.any():
            self._admit(queue)
            if not self.active.any():
                continue
            R_cur = max(2, min(self._spec_R, self.spec_k))
            step_fn = self._spec_chunk(chunk, R_cur)
            rem = {
                s: self.slot_req[s].max_new_tokens
                - len(self.slot_req[s].out_ids)
                for s in range(B) if self.active[s]
            }
            est = min(max(self._acc_est, 1.0), float(R_cur))
            rounds_needed = [-(-r // est) for r in rem.values()]
            need = min(rounds_needed) if queue else max(rounds_needed)
            n_burst = -(-int(need) // chunk)
            n_burst = max(1, min(n_burst, self._SPEC_BURST_CAP))
            self._active_dev.copy_(_to_device(self.active.copy(), self.device))
            blocks = []
            for _ in range(n_burst):
                em, nn = step_fn()
                blocks.append(torch.cat([em.reshape(-1), nn.reshape(-1)]))
            # the burst's one host read: every block, the streams, the lengths
            fetched = torch.cat(blocks + [self.seq_dev.reshape(-1), self.slen_dev]).cpu().numpy()
            n_em = chunk * B * R_cur
            blocks_np = fetched[: n_burst * (n_em + chunk * B)].reshape(n_burst, -1)
            seq_np = fetched[n_burst * (n_em + chunk * B):-B].reshape(B, -1)
            slen_np = fetched[-B:]
            was_active = self.active.copy()
            # book the prefill token of freshly admitted slots first (it
            # lives at seq[plen]: admission never fetched it)
            for s in range(B):
                if self.pending[s] and self.active[s]:
                    req = self.slot_req[s]
                    req.out_ids.append(int(seq_np[s, self.plen[s]]))
                    self.pending[s] = False
                    if len(req.out_ids) >= req.max_new_tokens or (
                        self.eos_id is not None
                        and req.out_ids[-1] == self.eos_id
                    ):  # satisfied by the prefill token alone
                        req.done = True
                        self.active[s] = False
                        self.slot_req[s] = None
                        self.lengths[s] = 0
                        self.slen[s] = 1
            b_rounds = b_tokens = 0
            for block in blocks_np:
                r_used, t_booked = self._harvest_spec(
                    block[:n_em].reshape(chunk, B, R_cur), block[n_em:].reshape(chunk, B))
                b_rounds += r_used
                b_tokens += t_booked
            if b_rounds:
                obs = b_tokens / b_rounds
                self._acc_est = 0.5 * self._acc_est + 0.5 * obs
                self.spec_stats["rounds"] += b_rounds
                self.spec_stats["tokens"] += b_tokens
                self._spec_R = self._ladder_next(R_cur)
            # mirror device state for slots still running
            for s in range(B):
                if was_active[s] and self.active[s]:
                    self.slen[s] = int(slen_np[s])
                    self.lengths[s] = int(slen_np[s]) - 1
                    self.last_token[s] = int(seq_np[s][slen_np[s] - 1])
            total_steps += chunk * n_burst
            if progress:
                progress(total_steps, self)
        return requests

    def run(
        self, requests: List[Request], progress: Optional[Callable] = None
    ) -> List[Request]:
        """Serve all requests to completion; returns them (with out_ids).

        Burst scheduling: every chunk up to the next budget retirement (with
        nothing queued, up to the last) is dispatched back to back, the
        device state threading from chunk to chunk, and one host read
        fetches the whole burst. With an eos_id the burst assumes no early
        EOS and is capped at _EOS_BURST_CAP chunks; a slot that hits EOS
        mid-burst decodes on as a zombie into its own pane (discarded at
        harvest). `progress(total_steps, server)` is called after each
        burst (total_steps: decode steps, or verify rounds in spec mode,
        dispatched so far in this run).
        """
        if self.spec is not None:
            return self._run_spec(requests, progress)
        queue = list(requests)
        chunk = self.pool_cfg.max_chunk
        step_fn = self._plain_chunk(chunk)
        B = self.pool_cfg.n_slots
        total_steps = 0
        while queue or self.active.any():
            self._admit(queue)
            if not self.active.any():
                continue
            rem = {
                s: self.slot_req[s].max_new_tokens
                - len(self.slot_req[s].out_ids)
                for s in range(B) if self.active[s]
            }
            per_slot = [-(-r // chunk) for r in rem.values()]
            # drain until a slot frees by budget (admit sooner) or, with
            # nothing queued, until every active slot's budget expires
            n_burst = min(per_slot) if queue else max(per_slot)
            if self.eos_id is not None:
                n_burst = min(n_burst, self._EOS_BURST_CAP)
            active_mask = self.active.copy()
            masks = []
            for _ in range(n_burst):
                masks.append(active_mask.copy())
                for s in list(rem):  # evolve the mask as budgets expire
                    rem[s] -= chunk
                    if rem[s] <= 0:
                        del rem[s]
                        active_mask[s] = False
            state = np.concatenate([self.lengths, self.last_token]).astype(np.int32)
            state = _to_device(state, self.device)
            self._lengths_dev.copy_(state[:B])
            self._toks_dev.copy_(state[B:])
            masks_dev = _to_device(np.stack(masks), self.device)
            blocks = []
            for i in range(n_burst):
                self._active_dev.copy_(masks_dev[i])
                blocks.append(step_fn().reshape(-1).clone())
            # the burst's one host read: every block, the cursors, the tokens
            fetched = torch.cat(blocks + [self._lengths_dev, self._toks_dev]).cpu().numpy()
            for i in range(n_burst):
                self._harvest(fetched[i * chunk * B:(i + 1) * chunk * B].reshape(chunk, B))
            lengths_np, last_np = fetched[-2 * B:-B], fetched[-B:]
            # mirror device bookkeeping for slots still running
            for s in range(B):
                if self.active[s]:
                    self.lengths[s] = int(lengths_np[s])
                    self.last_token[s] = int(last_np[s])
            total_steps += chunk * n_burst
            if progress:
                progress(total_steps, self)
        return requests
