"""Shared inputs of the port's parity tests: GPT-2 and Llama parameters
drawn with numpy from a seed, in the JAX package's stacked-layer layout, so
the same arrays feed both packages.

Importing it runs the process's torch CPU ops on one thread: the port's
tests are thousands of small ops, and under pytest-xdist six processes'
intra-op thread pools spin against each other on the shared cores (one
server parity test: 12 s alone or as one of six single-threaded processes,
~850 s as one of six at torch's default thread count)."""

import numpy as np
import torch

torch.set_num_threads(1)


def np_gpt2_params(cfg, seed: int, std: float = 0.05) -> dict:
    """Random GPT-2 params as float32 numpy arrays. Norm gains and biases
    are perturbed too, so every parameter takes part in the comparison."""
    rng = np.random.default_rng(seed)
    E, L, V, P = cfg.n_embd, cfg.n_layer, cfg.vocab_size, cfg.n_positions

    def nrm(*shape, scale=std):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def gain(*shape):
        return (1.0 + nrm(*shape, scale=0.1)).astype(np.float32)

    return {
        "wte": nrm(V, E),
        "wpe": nrm(P, E),
        "blocks": {
            "ln1_g": gain(L, E), "ln1_b": nrm(L, E, scale=0.02),
            "attn_w": nrm(L, E, 3 * E), "attn_b": nrm(L, 3 * E, scale=0.02),
            "attn_proj_w": nrm(L, E, E), "attn_proj_b": nrm(L, E, scale=0.02),
            "ln2_g": gain(L, E), "ln2_b": nrm(L, E, scale=0.02),
            "fc_w": nrm(L, E, 4 * E), "fc_b": nrm(L, 4 * E, scale=0.02),
            "fc_proj_w": nrm(L, 4 * E, E), "fc_proj_b": nrm(L, E, scale=0.02),
        },
        "lnf_g": gain(E), "lnf_b": nrm(E, scale=0.02),
    }


def np_llama_params(cfg, seed: int, std: float = 0.05,
                    embed_std: float = 0.5) -> dict:
    """Random Llama/Qwen params as float32 numpy arrays (biases when
    `cfg.qkv_bias`, an lm_head when untied). Norm gains are perturbed too,
    so every parameter takes part in the comparison. A wide embedding
    (`embed_std`) keeps greedy decodes from repeating one token."""
    rng = np.random.default_rng(seed)
    E, L, V, I = cfg.hidden_size, cfg.n_layer, cfg.vocab_size, cfg.intermediate_size
    QW, KW = cfg.n_head * cfg.head_dim, cfg.n_kv_head * cfg.head_dim

    def nrm(*shape, scale=std):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def gain(*shape):
        return (1.0 + nrm(*shape, scale=0.1)).astype(np.float32)

    blocks = {
        "ln1": gain(L, E), "wq": nrm(L, E, QW), "wk": nrm(L, E, KW),
        "wv": nrm(L, E, KW), "wo": nrm(L, QW, E), "ln2": gain(L, E),
        "w_gate": nrm(L, E, I), "w_up": nrm(L, E, I), "w_down": nrm(L, I, E),
    }
    if cfg.qkv_bias:
        blocks.update(bq=nrm(L, QW, scale=0.1), bk=nrm(L, KW, scale=0.1),
                      bv=nrm(L, KW, scale=0.1))
    params = {"embed": nrm(V, E, scale=embed_std), "blocks": blocks, "ln_f": gain(E)}
    if not cfg.tie_embeddings:
        params["lm_head"] = nrm(E, V)
    return params


def to_jax(tree):
    import jax.numpy as jnp

    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def to_numpy(tree):
    """A nested dict of torch tensors (CPU) as the same dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.numpy()


def quantized_pair(np_p, cfg, family: str, mode: str, group: int):
    """(JAX tree, port tree) of the same quantized weights: the port's
    quantizers (bit-exact with JAX's) on the port's params of the numpy
    draw, handed to JAX as arrays. mode "fp" keeps full precision."""
    import torch

    from efficient_llm_inference_tpu_torch.models import gpt2 as tgpt2
    from efficient_llm_inference_tpu_torch.models import llama as tllama

    mod = tgpt2 if family == "gpt2" else tllama
    tp = mod.params_from_jax(np_p, cfg, torch.float32, "cpu")
    if mode != "fp":
        quantize = (tgpt2.quantize_gpt2_weights if family == "gpt2"
                    else tllama.quantize_llama_weights)
        tp = quantize(tp, mode=mode, group=group)
    return to_jax(to_numpy(tp)), tp


def fake_params(names, jax_side: bool, embed: str, tied: bool = True,
                mode: str = "fp", group: int = 0, dtype=None) -> dict:
    """Params in name only (the eligibility gates read the weight kinds,
    dtypes and int4 groups, not the values), as the JAX tests fake them, in
    `dtype` (default bf16): full-precision leaves, or int8 / grouped-int4
    weights with the LM head's quantized copy (a {"q4"} leaf of shape
    [1, G/2, 1], the shape the int4 group is read from)."""
    if jax_side:
        import jax.numpy as jnp

        z, q8, q4 = (jnp.zeros((1,), dtype or jnp.bfloat16), jnp.zeros((1,), jnp.int8),
                     jnp.zeros((1, group // 2, 1), jnp.uint8))
    else:
        import torch

        z, q8, q4 = (torch.zeros(1, dtype=dtype or torch.bfloat16),
                     torch.zeros(1, dtype=torch.int8),
                     torch.zeros(1, group // 2, 1, dtype=torch.uint8))
    if mode == "fp":
        p = {embed: z, "blocks": {n: z for n in names}}
        if not tied:
            p["lm_head"] = z
    elif mode == "int8":
        p = {embed: z, "blocks": {n: {"q": q8, "s": z} for n in names}, "lm_q": q8,
             "lm_s": z}
    else:
        p = {embed: z, "blocks": {n: {"q4": q4, "s": z} for n in names}, "lm_q4": q4,
             "lm_s4": z}
    return p


# The JAX package's TPU memory envelopes, which the port's gates leave out:
# the reason a JAX gate refuses a cell whose structure both accept.
VMEM = "VMEM budget of the kernel's rings"
STREAM_CAP = "packed tile stream over the 4 GiB (int4: 5 GiB) cap"
DMA_GATE = "more than 2048 tiles of under 256 KB"


def jax_envelope(jcfg, mode: str, group: int) -> str:
    """Which JAX envelope a cell of bf16 weights of `mode` ("f", "int8",
    "int4") at `group` meets first: for Llama/Qwen the batched step's
    tile-stream gates (ops/pallas/megakernel_batch.py
    `llama_mega_batch_supported`, which the verify gates call too), else
    the VMEM budget (GPT-2 has only that)."""
    from efficient_llm_inference_tpu.ops.pallas import megakernel_llama as jml

    if not hasattr(jcfg, "hidden_size"):
        return VMEM
    TR, TC, Ip = jml._tile_geometry(jcfg)
    n_tiles = jcfg.n_layer * jml._tiles_per_layer(jcfg, TR, TC, Ip) + (
        jml._num_lm_tiles(jcfg.vocab_size, TC) * (jcfg.hidden_size // TR))
    slot = jml._w_slot_bytes(mode, TR, TC, group, 2,
                             2 * jml._s4_half_rows(TR, group) if mode == "int4" else None)
    if n_tiles > 2048 and slot < 256 * 1024:
        return DMA_GATE
    if n_tiles * slot > (5 if mode == "int4" else 4) * 1024**3:
        return STREAM_CAP
    return VMEM


def served_configs(name: str, wq: str):
    """(JAX cfg, port cfg, mode, group) of registry model `name` served at
    weight_quant `wq`: the port engine's plan (`weight_quant_plan`: int4 at
    group 128, int4w8 at the half-tile group, an FFN padded to it) and JAX's
    (`_int4w8_llama_spec` with padding)."""
    import efficient_llm_inference_tpu.engine.engine as jengine
    from efficient_llm_inference_tpu.models import registry as jreg
    from efficient_llm_inference_tpu_torch.engine.engine import weight_quant_plan
    from efficient_llm_inference_tpu_torch.models import registry as treg

    tspec, mode, group = weight_quant_plan(treg.spec_by_name(name), wq)
    jspec = jreg.spec_by_name(name)
    if wq == "int4w8" and jspec.name == "llama":
        jspec = jengine._int4w8_llama_spec(jspec, True)[0]
    return jspec.config, tspec.config, mode, group


def jax_rope_rows(jcfg, length: int):
    """cos_q/sin_q [1, Hq*D] of the JAX Llama step at `length`, as the JAX
    engine builds them (position min(length, P - 1), under jit)."""
    import jax
    import jax.numpy as jnp

    from efficient_llm_inference_tpu.models.llama import rope_cos_sin

    pos = min(length, jcfg.n_positions - 1)

    @jax.jit
    def rows(p):
        cos, sin = rope_cos_sin(p[None, None], jcfg.head_dim, jcfg.rope_theta)
        return jnp.tile(cos[0], (1, jcfg.n_head)), jnp.tile(sin[0], (1, jcfg.n_head))

    return rows(jnp.int32(pos))


# ------------------------------------------------- static-batch serving

PROMPTS = ["the quick brown fox", "pack my box with five dozen liquor jugs", "a"]


def engine_pair(spec_j, spec_t, np_p, params_t):
    """A JAX engine and a port engine over the same numpy params, fp32 on
    the CPU, megakernel on (the Pallas kernels in interpret mode, the port's
    plain steps)."""
    import jax.numpy as jnp
    import torch

    from efficient_llm_inference_tpu.core.config import Config as JaxConfig
    from efficient_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine
    from efficient_llm_inference_tpu_torch import Config, InferenceEngine

    jeng = JaxEngine(spec_j, to_jax(np_p), config=JaxConfig(
        model_name="t", device="cpu", dtype=jnp.float32, megakernel=True))
    teng = InferenceEngine(spec_t, params_t, config=Config(
        model_name="t", device="cpu", dtype=torch.float32, megakernel=True))
    return jeng, teng


def jax_batch_ids(jeng, prompts, n, kv_mode=None):
    """(texts, token ids per row) of the JAX engine's generate_batch: its
    texts, then its built batch function called again for the raw tokens
    (the texts drop ids >= 256)."""
    import jax.numpy as jnp

    from efficient_llm_inference_tpu.engine.generate import bucket_for

    texts = jeng.generate_batch(prompts, max_new_tokens=n, kv_mode=kv_mode)
    method = f"quant_{kv_mode}" if kv_mode else "full_cache"
    ids = [jeng._encode(p, method) for p in prompts]
    bucket = min(bucket_for(max(len(i) for i in ids)), jeng.model.n_positions)
    _, fn, _, mega = jeng._fns[("batch", len(prompts), bucket, n, kv_mode)]
    buf = np.zeros((len(prompts), bucket), np.int32)
    for b, row in enumerate(ids):
        buf[b, :len(row)] = row
    toks, _ = fn(dict(jeng.params, __mega_packed__=mega["packed"]), jnp.asarray(buf),
                 jnp.asarray([len(i) for i in ids], jnp.int32))
    return texts, [row + np.asarray(toks)[b].tolist() for b, row in enumerate(ids)]


def check_generate_batch(engines, kv_mode, n=7):
    """The port's generate_batch took the batched path, and its ids equal
    the JAX engine's generate_batch and the port's per-prompt generate."""
    jeng, teng = engines
    method = f"quant_{kv_mode}" if kv_mode else "full_cache"
    texts = teng.generate_batch(PROMPTS, max_new_tokens=n, kv_mode=kv_mode)
    got = teng.last_batch_ids
    assert any(k[0] == "batch" and k[-1] == kv_mode for k in teng._fns)
    want_texts, want = jax_batch_ids(jeng, PROMPTS, n, kv_mode)
    assert got == want and texts == want_texts
    assert got == [teng.generate_ids(p, method, n) for p in PROMPTS]
    assert any(len(set(row[-n:])) > 1 for row in got)  # not one repeated token
