"""Inference engine (PyTorch port of efficient_llm_inference_tpu/engine/
engine.py, the full_cache and quant_* methods).

`InferenceEngine` owns a GPT-2 or Llama/Qwen model as a dict of tensors and
exposes the JAX package's generation API and `benchmark_method` metric-dict
schema.
Generation runs prefill over the bucket-padded prompt, then a greedy decode
loop over a static-capacity cache. Eligible greedy batch-1 decode (full_cache,
and quant_* at per_token granularity) runs the whole-step megakernel when
`Config.resolved_megakernel()` is on (the default on a CUDA device), as the
JAX engine does on a TPU (`_mega_spec`, `_mega_quant_spec`).
`generate_batch` decodes B prompts together through the batched whole-step
kernels (`_mega_batch_spec`), or prompt by prompt where they do not apply.
`generate_speculative` (n-gram, self-draft or draft-model proposals, one
k-row verify a round) and `generate_speculative_auto` decode one prompt
speculatively (engine/speculative.py), with output equal to plain greedy.
`Config.weight_quant` ("int8", "int4", "int4w8") quantizes the weights at
`from_model_name` (the JAX engine's serving mode); every path serves them,
megakernel on or off: on the kernels' weight tiers where the megakernel
takes the model, else the model's forward over the codes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from ..cache.kvcache import DenseKV, QuantizedKV
from ..core.config import Config
from ..core.utils import (
    DeviceTimer,
    get_cpu_mem_mb,
    get_device_peak_mb,
    mb,
    reset_device_peak,
)
from ..data.tokenizer import ByteTokenizer, load_tokenizer
from ..models import gpt2 as gpt2_mod
from ..models import llama as llama_mod
from ..models.registry import ModelSpec, spec_by_name, spec_with_config
from ..ops import megakernel as mk
from ..ops import megakernel_batch as mkb
from ..ops import megakernel_batch_quant as mbq
from ..ops import megakernel_draft as md
from ..ops import megakernel_llama as ml
from ..ops import megakernel_quant as mq
from . import speculative as spec_mod
from .generate import SamplingParams, bucket_for, make_generate, make_generate_batch

VALID_METHODS = [
    "no_cache",
    "full_cache",
    "sliding_window",
    "quant_int8",
    "quant_int4",
    "quant_mixed",
    "paged_attention",
    "chunked_cache",
    "prefix_window",
    "strided_cache",
    "block_cache",
    "budget_cache",
]
PORTED_METHODS = ("full_cache", "quant_int8", "quant_int4", "quant_mixed")
# Per model family: (megakernel eligibility, quantized-KV eligibility, packer).
_MEGA = {
    "gpt2": (mk.mega_supported, mq.mega_quant_supported, mk.pack_gpt2_mega),
    "llama": (ml.mega_supported, mq.llama_mega_quant_supported,
              ml.pack_llama_mega),
}

# Per model family, for a speculative draft: the JAX package's structure for
# full-precision weights, and the draft burst's packer.
_MEGA_DRAFT = {
    "gpt2": (mk.jax_structure_ok, md.pack_gpt2_draft),
    "llama": (ml.jax_structure_ok, md.pack_llama_draft),
}

# Per model family: batched eligibility for full-precision and quantized panes.
_MEGA_BATCH = {
    "gpt2": (mkb.mega_batch_supported, mbq.mega_batch_quant_supported),
    "llama": (mkb.llama_mega_batch_supported, mbq.llama_mega_batch_quant_supported),
}


def weight_quant_plan(spec: ModelSpec, weight_quant: Optional[str]
                      ) -> Tuple[ModelSpec, Optional[str], int]:
    """(spec', mode, group) that `from_model_name` serves `weight_quant` at
    (the JAX engine's choice): "int8" per output channel, "int4" at group
    128, "int4w8" as "int4" at the half-tile group (GPT-2: E/2; Llama/Qwen:
    TR/2 of the JAX kernel's tile geometry, the port's copy in
    ops/megakernel_llama.py `_tile_geometry`, JAX `_int4w8_llama_spec`).
    TR divides the hidden and query widths by construction; where TR/2
    does not divide the FFN width, spec' serves the padded width Ip of that
    geometry, a multiple of TR: Llama-3.2-1B gives group 1024 unpadded,
    Qwen2.5-0.5B group 448 with I 4864 -> 5376 (TR/2 divides Ip for every
    model of the registry: none has an odd TR). `weight_quant=None` gives
    (spec, None, 128)."""
    if weight_quant != "int4w8":
        return spec, weight_quant, 128
    if spec.name == "gpt2":
        return spec, "int4", spec.config.n_embd // 2
    if spec.name != "llama":
        raise ValueError(f"weight_quant=int4w8 not supported for {spec.name}")
    c = spec.config
    TR, _, Ip = ml._tile_geometry(c)
    g = TR // 2
    if c.intermediate_size % g == 0:
        return spec, "int4", g
    return spec_with_config(spec, dataclasses.replace(c, intermediate_size=Ip)), "int4", g


def quantize_weights(spec: ModelSpec, params: dict, mode: str, group: int) -> dict:
    """Full-precision `params` of `spec` quantized by the family's
    `quantize_*_weights` at `mode` and `group` (from `weight_quant_plan`;
    a padded spec' needs params of its width)."""
    quantize = (llama_mod.quantize_llama_weights if spec.name == "llama"
                else gpt2_mod.quantize_gpt2_weights)
    return quantize(params, mode=mode, group=group)


# Paths where the reference truncates prompts at prompt_cap.
_TRUNCATING_METHODS = {
    "no_cache",
    "full_cache",
    "prefix_window",
    "strided_cache",
    "block_cache",
    "budget_cache",
}


def _check_method(method: str) -> None:
    if method not in VALID_METHODS:  # the JAX engine asserts it
        raise AssertionError(f"Invalid method: {method}")
    if method not in PORTED_METHODS:
        raise NotImplementedError(
            f"method {method!r} is not ported yet: the eviction policies and "
            "the rest of the 12-method registry are ROADMAP.md Queue 1 item 5")


class InferenceEngine:
    """Generation engine over a functional PyTorch model."""

    def __init__(self, model: ModelSpec, params: dict, tokenizer=None,
                 config: Optional[Config] = None):
        self.model = model
        self.params = params
        self.tokenizer = tokenizer if tokenizer is not None else ByteTokenizer()
        self.config = config or Config()
        self._fns: Dict = {}
        self._mega_packed: Optional[dict] = None

    @classmethod
    def from_model_name(cls, name: str = "gpt2", tokenizer=None,
                        config: Optional[Config] = None,
                        params: Optional[dict] = None) -> "InferenceEngine":
        """Random-init (from `config.seed`, drawn on the host) or given
        full-precision params, on `config.device` (CUDA unless the config
        says otherwise). With `config.weight_quant` the weights are
        quantized here, as the JAX engine does: "int8" per output channel,
        "int4" at group 128, "int4w8" at the half-tile group
        (`weight_quant_plan`; its padded FFN also pads given full-precision
        params). A Llama too large to hold in full precision
        (`param_bytes_estimate` over 4 GiB) is drawn and quantized on the
        host and only its quantized tree moves to the device
        (`init_quantized_llama_params`). Given params that are already
        quantized raise ValueError with a weight_quant: the JAX engine
        would quantize them again and fail (its "loud fallback" for them
        crashes); pass them with weight_quant=None, which serves them as
        they are."""
        config = config or Config(model_name=name)
        spec = spec_by_name(name)
        wq = config.weight_quant
        if wq is not None and params is not None and mk.weight_quantized(params):
            raise ValueError(f"weight_quant={wq!r} with params that are already "
                             "quantized: pass full-precision params, or these with "
                             "weight_quant=None")
        qspec, wq_mode, wq_group = weight_quant_plan(spec, wq)
        if qspec is not spec:  # FFN width padded to the int4w8 tile geometry
            if params is not None:
                params = llama_mod.pad_llama_ffn(params, qspec.config.intermediate_size)
            spec = qspec
        quantized = False
        if params is None:
            if spec.name == "llama":
                big = llama_mod.param_bytes_estimate(spec.config, config.dtype) > 4 * 1024**3
                if wq_mode is not None and big:
                    params = llama_mod.init_quantized_llama_params(
                        config.generator(), spec.config, mode=wq_mode,
                        dtype=config.dtype, device=config.device, group=wq_group)
                    quantized = True
                else:
                    params = llama_mod.init_llama_params(
                        config.generator(), spec.config, config.dtype, config.device)
            else:
                params = gpt2_mod.init_gpt2_params(config.generator(), spec.config,
                                                   config.dtype, config.device)
        if wq_mode is not None and not quantized:
            params = quantize_weights(spec, params, wq_mode, wq_group)
        if tokenizer is None:
            tokenizer = load_tokenizer(name)
        return cls(spec, params, tokenizer, config)

    # ------------------------------------------------------------------
    def _dense_kw(self, capacity: int) -> dict:
        m = self.model
        return dict(
            n_layer=m.n_layer,
            n_head=m.n_kv_head,
            head_dim=m.head_dim,
            capacity=capacity,
            batch=self.config.batch_size,
            dtype=self.config.dtype,
            device=self.config.device,
        )

    def _build(self, method: str, bucket: int, max_new: int, kw: dict,
               sampling: Optional[SamplingParams] = None,
               allow_mega: bool = True):
        """Build (and cache) the generate function of one configuration.
        `allow_mega=False` keeps the megakernel-off path (teacher forcing
        needs the logits the megakernel does not return)."""
        _check_method(method)
        if sampling is not None and not sampling.greedy:
            raise NotImplementedError(
                "sampled decoding is not ported yet (ROADMAP.md Queue 1 "
                "item 6); pass sampling=None for greedy")
        key = (method, bucket, max_new, tuple(sorted(kw.items())), allow_mega)
        if key in self._fns:
            return self._fns[key]
        cap = bucket + max_new
        mega = None
        if method == "full_cache":
            if allow_mega:
                mega = self._mega_spec(cap, sampling)
            if mega is not None:
                cap = mega["capacity"]  # rounded up to a multiple of 8
            strategy = DenseKV(**self._dense_kw(cap))
        else:
            kv_mode = method.replace("quant_", "")
            if allow_mega:
                mega = self._mega_quant_spec(cap, sampling, kv_mode, kw)
            if mega is not None:
                cap = mega["capacity"]
            strategy = QuantizedKV(
                **self._dense_kw(cap), mode=kv_mode,
                granularity=kw.get("granularity", "per_token"))
            if mega is not None:
                mega["eps"] = strategy.eps
        built = (make_generate(self.model, strategy, max_new, mega=mega),
                 strategy)
        self._fns[key] = built
        return built

    def _mega_eligible(self, sampling: Optional[SamplingParams]) -> bool:
        return (self.config.resolved_megakernel()
                and self.config.batch_size == 1
                and (sampling is None or sampling.greedy)
                and self.model.name in _MEGA)

    def _packed(self) -> Optional[dict]:
        if self._mega_packed is None:
            pack = _MEGA[self.model.name][2]
            self._mega_packed = pack(self.params, self.model.config)
        return self._mega_packed

    def _mega_spec(self, cap: int, sampling: Optional[SamplingParams]
                   ) -> Optional[dict]:
        """Whole-step megakernel eligibility for full_cache decode (greedy,
        batch 1, GPT-2 or Llama family, weights packable; ops/megakernel.py,
        ops/megakernel_llama.py)."""
        if not self._mega_eligible(sampling):
            return None
        cap8 = -(-cap // 8) * 8  # capacity % 8 == 0, as the JAX engine
        supported = _MEGA[self.model.name][0]
        if not supported(self.model.config, cap8, self.params):
            return None
        packed = self._packed()
        if packed is None:
            return None
        return {"packed": packed, "cfg": self.model.config, "capacity": cap8,
                "kind": self.model.name}

    def _mega_quant_spec(self, cap: int, sampling: Optional[SamplingParams],
                         kv_mode: str, kw: dict) -> Optional[dict]:
        """Quantized-KV megakernel eligibility for quant_int8/int4/mixed
        decode (greedy, batch 1, GPT-2 or Llama family, per_token scales;
        ops/megakernel_quant.py). per_head keeps the megakernel-off path."""
        if not self._mega_eligible(sampling):
            return None
        if kw.get("granularity", "per_token") != "per_token":
            return None
        cap8 = -(-cap // 8) * 8
        supported = _MEGA[self.model.name][1]
        if not supported(self.model.config, cap8, self.params, kv_mode):
            return None
        packed = self._packed()
        if packed is None:
            return None
        return {"packed": packed, "cfg": self.model.config, "capacity": cap8,
                "kind": self.model.name, "kv_mode": kv_mode}

    def _mega_batch_spec(self, cap: int, batch: int,
                         kv_mode: Optional[str] = None) -> Optional[dict]:
        """Batched-megakernel eligibility (greedy, GPT-2 or Llama family,
        weights packable; ops/megakernel_batch.py, or
        ops/megakernel_batch_quant.py when `kv_mode` asks for int8/int4/mixed
        panes)."""
        if not self.config.resolved_megakernel() or self.model.name not in _MEGA_BATCH:
            return None
        cap8 = -(-cap // 8) * 8
        fp_ok, quant_ok = _MEGA_BATCH[self.model.name]
        cfg = self.model.config
        if not (quant_ok(cfg, cap8, self.params, batch, kv_mode) if kv_mode
                else fp_ok(cfg, cap8, self.params, batch)):
            return None
        packed = self._packed()
        if packed is None:
            return None
        spec = {"packed": packed, "cfg": cfg, "capacity": cap8,
                "kind": self.model.name}
        if kv_mode:
            spec["kv_mode"] = kv_mode
        return spec

    def _encode(self, prompt: str, method: str) -> List[int]:
        ids = self.tokenizer.encode(prompt)
        cap = (
            min(self.config.prompt_cap, self.model.n_positions)
            if method in _TRUNCATING_METHODS
            else self.model.n_positions
        )
        return list(ids[:cap])

    def _generate(self, prompt: str, method: str, max_new_tokens: int,
                  sampling=None, forced=None, allow_mega: bool = True, **kw):
        ids = self._encode(prompt, method)
        true_len = len(ids)
        if true_len == 0:
            raise ValueError("empty prompt")
        bucket = min(bucket_for(true_len), self.model.n_positions)
        generate, strategy = self._build(method, bucket, max_new_tokens, kw,
                                         sampling, allow_mega)
        buf = torch.zeros((self.config.batch_size, bucket), dtype=torch.long)
        buf[0, :true_len] = torch.tensor(ids, dtype=torch.long)
        if forced is not None:
            forced = forced.to(self.config.device)
        toks, final_len, step_logits = generate(
            self.params, buf.to(self.config.device), true_len, forced)
        return ids, toks, final_len, step_logits, strategy

    def _run(self, prompt: str, method: str, max_new_tokens: int,
             sampling: Optional[SamplingParams] = None, **kw
             ) -> Tuple[str, int, object, int]:
        """One generation: returns (text, n_new, strategy, final_length)."""
        ids, toks, final_len, _, strategy = self._generate(
            prompt, method, max_new_tokens, sampling, **kw)
        out_ids = ids + toks[0].tolist()  # the one host sync of a generation
        self.last_generation_ids = out_ids
        return (
            self.tokenizer.decode(out_ids, skip_special_tokens=True),
            max_new_tokens,
            strategy,
            final_len,
        )

    def generate(self, prompt: str, method: str = "full_cache",
                 max_new_tokens: int = 32,
                 sampling: Optional[SamplingParams] = None, **kw) -> str:
        """Greedy generation with a cache method; `kw` reaches the strategy
        (e.g. granularity="per_head" for the quant_* methods)."""
        text, _, _, _ = self._run(prompt, method, max_new_tokens,
                                  sampling=sampling, **kw)
        return text

    def generate_ids(self, prompt: str, method: str = "full_cache",
                     max_new_tokens: int = 32, **kw) -> List[int]:
        """Raw token ids (prompt + generation)."""
        self._run(prompt, method, max_new_tokens, **kw)
        return list(self.last_generation_ids)

    def generate_logits(self, prompt: str, method: str = "full_cache",
                        max_new_tokens: int = 32,
                        forced: Optional[List[int]] = None, **kw
                        ) -> Tuple[List[int], torch.Tensor]:
        """(new token ids, fp32 logits [N, V] that chose them). With `forced`
        the N tokens are fed instead of the argmax (teacher forcing). Always
        the megakernel-off path: the megakernel returns tokens, not logits."""
        forced_t = None
        if forced is not None:
            if len(forced) != max_new_tokens:
                raise ValueError(f"{len(forced)} forced tokens for "
                                 f"max_new_tokens={max_new_tokens}")
            forced_t = torch.tensor([list(forced)], dtype=torch.long)
        _, toks, _, step_logits, _ = self._generate(
            prompt, method, max_new_tokens, forced=forced_t, allow_mega=False,
            **kw)
        return toks[0].tolist(), torch.cat(step_logits, dim=0)

    def generate_batch(self, prompts: List[str], max_new_tokens: int = 32,
                       kv_mode: Optional[str] = None, mesh=None,
                       mesh_axis: str = "data") -> List[str]:
        """Static-batch greedy generation: B prompts decode together.

        Where the batched whole-step kernels take the model and B (see
        `_mega_batch_spec`), every decode step is one launch of the batched
        chain for all B prompts; otherwise each prompt runs through
        `generate` on its own, as the JAX engine falls back. With `kv_mode`
        in {"int8", "int4", "mixed"} the panes are quantized and each row
        matches `generate(p, f"quant_{kv_mode}")`; without it, each row
        matches `generate(p, "full_cache")`. The token ids (prompt +
        generation) of each row are kept in `last_batch_ids`. Over
        weight-quantized params the batched kernels stream the codes (their
        weight tiers), and the fallback is the single-stream path on them.
        """
        if mesh is not None:
            raise NotImplementedError(
                "mesh-sharded batched serving is not ported yet: the parallel "
                "package is ROADMAP.md Queue 1 item 12")
        if not prompts:
            raise ValueError("empty prompt batch")
        # encode as the method this batch emulates: quant_* methods do not
        # truncate at prompt_cap, so the batch and its fallback agree
        method = f"quant_{kv_mode}" if kv_mode else "full_cache"
        ids_list = [self._encode(p, method) for p in prompts]
        true_lens = [len(i) for i in ids_list]
        if min(true_lens) == 0:
            raise ValueError("empty prompt")
        B = len(prompts)
        bucket = min(bucket_for(max(true_lens)), self.model.n_positions)
        mega = self._mega_batch_spec(bucket + max_new_tokens, B, kv_mode)
        if mega is None:  # the reference's fallback: one stream at a time
            texts, ids = [], []
            for p in prompts:
                texts.append(self.generate(p, method, max_new_tokens))
                ids.append(self.last_generation_ids)
            self.last_batch_ids = ids
            return texts
        key = ("batch", B, bucket, max_new_tokens, kv_mode)
        if key not in self._fns:
            strategy = DenseKV(**dict(self._dense_kw(mega["capacity"]), batch=B))
            self._fns[key] = (make_generate_batch(self.model, strategy,
                                                  max_new_tokens, mega), strategy)
        fn, _ = self._fns[key]
        buf = torch.zeros((B, bucket), dtype=torch.long)
        for b, ids in enumerate(ids_list):
            buf[b, :len(ids)] = torch.tensor(ids, dtype=torch.long)
        toks, _ = fn(self.params, buf.to(self.config.device), true_lens)
        rows = toks.tolist()  # the one host sync of a batch
        self.last_batch_ids = [ids + row for ids, row in zip(ids_list, rows)]
        return [self.tokenizer.decode(ids, skip_special_tokens=True)
                for ids in self.last_batch_ids]

    # ------------------------------------------------------------------
    def _spec_mega(self, bucket: int, max_new_tokens: int, k: int) -> Optional[dict]:
        """The target's megakernel spec of a speculative generation: the JAX
        engine's `_mega_spec(bucket + N + k + 1)`, and the kernels' limits
        at the generation's capacity (spec_capacity: 8 rows more, the JAX
        verify kernels' rule capacity >= roundup8(cur + R) + 8)."""
        mega = self._mega_spec(bucket + max_new_tokens + k + 1, None)
        if mega is None:
            return None
        cap = spec_mod.spec_capacity(bucket, max_new_tokens, k, True)
        if not _MEGA[self.model.name][0](self.model.config, cap, self.params):
            return None
        return mega

    @staticmethod
    def _draft_kernels(dspec: ModelSpec, dparams: dict,
                       mega: Optional[dict]) -> Optional[Tuple[bool, bool]]:
        """(the port's whole-step kernels take the draft at the generation's
        capacity, the JAX engine would pack it for a burst: full-precision
        GPT-2 or a tied full-precision Llama), or None where the JAX engine
        gives the draft no megakernel spec (no mega target, another family,
        or the JAX structure, its weight gates included, refuses the draft
        at the target's capacity)."""
        if mega is None or dspec.name not in _MEGA_DRAFT:
            return None
        cfg = dspec.config
        if not _MEGA_DRAFT[dspec.name][0](cfg, mega["capacity"], dparams):
            return None
        cap = mega["capacity"] + 8  # spec_capacity of the mega path
        return (_MEGA[dspec.name][0](cfg, cap, dparams),
                (dspec.name == "gpt2" or cfg.tie_embeddings)
                and not mk.weight_quantized(dparams))

    def _draft_mega_spec(self, dspec: ModelSpec, dparams: dict,
                         mega: Optional[dict]) -> Optional[dict]:
        """Megakernel spec of a speculative DRAFT (JAX `_draft_mega_spec`),
        packed once per build (drafts are small): "packed" where the port's
        whole-step kernels take it, "burst_packed" where the JAX engine
        packs a burst (`_draft_kernels`); engine/speculative.py
        `draft_route` picks among them."""
        kernels = self._draft_kernels(dspec, dparams, mega)
        if kernels is None:
            return None
        step_ok, burst_ok = kernels
        packed = _MEGA_DRAFT[dspec.name][1](dparams, dspec.config)
        return {"cfg": dspec.config, "kind": dspec.name,
                "packed": packed if step_ok else None,
                "burst_packed": packed if burst_ok else None}

    def generate_speculative(self, prompt: str, max_new_tokens: int = 32,
                             mode: str = "ngram", k: int = 8, draft_layers: int = 1,
                             draft: Optional[tuple] = None, stats: bool = False):
        """Speculative greedy generation (beyond the reference).

        mode "ngram" = draft-free prompt-lookup proposals; "self_draft" = a
        truncated `draft_layers`-layer self-draft; "draft" = an external
        draft passed as `draft=(spec, params)` (sharing the target's
        vocabulary). Where the whole-step megakernel takes the model
        (`_mega_spec`), each round's k-row verify is one launch of
        `gpt2_megaverify` / `llama_megaverify` and a draft runs on the
        device (engine/speculative.py `draft_route`); otherwise the model's
        k-row forward pass verifies. Output is exactly plain full_cache
        greedy in fp32. Returns (text, n_new) — or, with `stats=True`,
        (text, n_new, {"n_rounds", "tokens_per_round"}), tokens_per_round =
        (n_new - 1) / n_rounds. The ids (prompt + generation) are kept in
        `last_generation_ids`, the host's reads of the emitted count (before
        the final read of the tokens) in `last_spec_host_syncs`. Over
        weight-quantized params the verify runs on its kernel's weight tier,
        and a quantized draft (the self-draft of a quantized target) takes
        k whole-step launches on theirs: as in the JAX engine, only a
        full-precision draft has a burst.
        """
        ids = self._encode(prompt, "full_cache")
        true_len = len(ids)
        if true_len == 0:
            raise ValueError("empty prompt")
        bucket = min(bucket_for(true_len), self.model.n_positions)
        key = ("speculative", mode, bucket, max_new_tokens, k, draft_layers, stats,
               id(draft[1]) if draft is not None else None)
        if key not in self._fns:
            mega = self._spec_mega(bucket, max_new_tokens, k)
            dtype = self.config.dtype
            if mode == "ngram":
                gen = spec_mod.make_ngram_speculative_generate(
                    self.model, max_new_tokens, k=k, prompt_bucket=bucket, mega=mega,
                    dtype=dtype, stats=stats)
                args = ()
            elif mode in ("self_draft", "draft"):
                if mode == "draft":
                    if draft is None:
                        raise ValueError("mode='draft' needs draft=(spec, params)")
                    dspec, dparams = draft
                else:
                    dspec, dparams = spec_mod.make_self_draft(self.model, self.params,
                                                              draft_layers)
                gen = spec_mod.make_speculative_generate(
                    self.model, dspec, max_new_tokens, k=k, prompt_bucket=bucket,
                    mega=mega, dtype=dtype, stats=stats,
                    draft_mega=self._draft_mega_spec(dspec, dparams, mega))
                args = (dparams,)
            else:
                raise ValueError(f"unknown speculative mode: {mode}")
            self._fns[key] = (gen, args, mega)
        gen, args, _ = self._fns[key]
        buf = torch.zeros((1, bucket), dtype=torch.long)
        buf[0, :true_len] = torch.tensor(ids, dtype=torch.long)
        res = gen(self.params, *args, buf.to(self.config.device), true_len)
        out, n = res[0], int(res[1])
        out_ids = ids + out[:n].tolist()
        self.last_generation_ids = out_ids
        self.last_spec_host_syncs = gen.host_syncs
        text = self.tokenizer.decode(out_ids, skip_special_tokens=True)
        if stats:
            n_rounds = int(res[2])
            return text, n, {"n_rounds": n_rounds,
                             "tokens_per_round": (n - 1) / max(n_rounds, 1)}
        return text, n

    def generate_speculative_auto(self, prompt: str, max_new_tokens: int = 32,
                                  draft: Optional[tuple] = None, stats: bool = False):
        """Acceptance-driven speculation (JAX `generate_speculative_auto`):
        the candidates ngram k=8 / k=4, plus draft k=8 / k=4 when
        `draft=(spec, params)` is given, are each probed once, then the
        engine commits to the best expected tokens per round-cost
        (acceptance EMA / cost; a round costs 1 target pass for ngram and
        1 + k * max(draft/target layer-width ratio, 0.02) for a draft),
        re-probing the runner-up every 8th call. Output equals plain greedy
        for any candidate."""
        cands = [("ngram", 8, None), ("ngram", 4, None)]
        if draft is not None:
            cands += [("draft", 8, draft), ("draft", 4, draft)]
        draft_id = id(draft[1]) if draft is not None else None
        st = getattr(self, "_spec_auto", None)
        if st is None or st["draft_id"] != draft_id:
            st = self._spec_auto = {"acc": {}, "calls": 0, "draft_id": draft_id}

        def width(cfg):
            return getattr(cfg, "hidden_size", None) or getattr(cfg, "n_embd", 1)

        def cost(mode, k, d):
            if mode == "ngram":
                return 1.0
            rel = (d[0].n_layer * width(d[0].config) ** 2) / max(
                self.model.n_layer * width(self.model.config) ** 2, 1)
            return 1.0 + k * max(rel, 0.02)

        unprobed = [c for c in cands if (c[0], c[1]) not in st["acc"]]
        if unprobed:
            mode, k, d = unprobed[0]
        else:
            scored = sorted(cands, key=lambda c: st["acc"][(c[0], c[1])] / cost(*c),
                            reverse=True)
            mode, k, d = scored[1] if st["calls"] % 8 == 7 and len(scored) > 1 else scored[0]
        st["calls"] += 1
        text, n_new, s = self.generate_speculative(prompt, max_new_tokens, mode=mode, k=k,
                                                   draft=d, stats=True)
        prev = st["acc"].get((mode, k))
        obs = s["tokens_per_round"]
        st["acc"][(mode, k)] = obs if prev is None else 0.5 * prev + 0.5 * obs
        s = dict(s, mode=mode, k=k)
        return (text, n_new, s) if stats else (text, n_new)

    # ------------------------------------------------------------------
    def generate_with_cache(self, prompt: str, max_new_tokens: int = 32):
        text, n_new, _, _ = self._run(prompt, "full_cache", max_new_tokens)
        return text, n_new

    def generate_with_quantized_kv(self, prompt: str, max_new_tokens: int = 32,
                                   mode: str = "int8"):
        text, n_new, strategy, final_len = self._run(
            prompt, f"quant_{mode}", max_new_tokens)
        return text, n_new, mb(strategy.est_bytes(final_len))

    def estimate_kv_bytes(self, method: str, length: int, **kw) -> float:
        """Estimated KV-cache bytes `method` holds at sequence `length`
        (quantized methods count packed codes plus scales)."""
        _, strategy = self._build(method, 1, max(length - 1, 1), dict(kw),
                                  allow_mega=False)
        return float(strategy.est_bytes(length))

    # ------------------------------------------------------------------
    def benchmark_method(
        self,
        prompts: List[str],
        method: str = "no_cache",
        max_new_tokens: int = 32,
        window_size: int = 256,
        block_size: int = 64,
        chunk_size: int = 64,
        keep_last: int = 256,
        mode: str = "int8",
        prefix_len: int = 32,
        stride: int = 4,
        keep_per_block: int = 8,
        old_budget: int = 64,
        warmup: bool = True,
    ) -> dict:
        """Run one method over a list of prompts; the JAX package's
        signature (its defaults too: `method` "no_cache", which raises
        NotImplementedError until ROADMAP Queue 1 item 5 ports it) and
        metric-dict schema. `warmup=True` runs each prompt bucket once
        before timing, so first-use costs (kernel build and load, allocator
        growth) stay out of the throughput."""
        _check_method(method)

        def run_one(prompt):
            if method == "full_cache":
                _, n_new = self.generate_with_cache(prompt, max_new_tokens)
                return n_new, float("nan")
            _, n_new, est = self.generate_with_quantized_kv(
                prompt, max_new_tokens, mode=method.replace("quant_", ""))
            return n_new, est

        if warmup and prompts:
            seen = set()
            for p in prompts:
                b = bucket_for(len(self._encode(p, method)))
                if b not in seen:
                    seen.add(b)
                    run_one(p)

        device = self.config.device
        reset_device_peak(device)
        start_cpu = get_cpu_mem_mb()
        timer = DeviceTimer(device).start()
        total_new_tokens = 0
        est_cache_mbs = []
        for prompt in prompts:
            n_new, est = run_one(prompt)
            total_new_tokens += n_new
            est_cache_mbs.append(est)
        elapsed = timer.stop()
        cpu_used = get_cpu_mem_mb() - start_cpu
        dev_peak = get_device_peak_mb(device)
        tps = total_new_tokens / elapsed if elapsed > 0 else float("inf")

        finite = [x for x in est_cache_mbs if not math.isnan(x)]
        est_cache_mb_avg = sum(finite) / len(finite) if finite else float("nan")
        return {
            "method": method,
            "elapsed_sec": elapsed,
            "total_new_tokens": total_new_tokens,
            "tokens_per_sec": tps,
            "cpu_mem_used_mb": cpu_used,
            "gpu_peak_mb": dev_peak,
            "window_size": None,
            "block_size": None,
            "chunk_size": None,
            "est_kv_cache_mb_avg": est_cache_mb_avg,
            "prefix_len": None,
            "stride": None,
            "keep_per_block": None,
            "old_budget": None,
        }
