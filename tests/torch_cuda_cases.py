"""Cases and helpers shared by the card tests (tests/test_torch_cuda_*.py):
the `cuda` fixture, the model geometries, random inputs and packed weights
of each chain, the tolerance checks, and the plain logits a server's
request is held to (also used by tests/test_torch_megaserver_dtype.py). No
test lives here, and nothing here imports JAX."""

import dataclasses

import pytest
import torch

from efficient_llm_inference_tpu_torch.cache.kvcache import DenseKV
from efficient_llm_inference_tpu_torch.engine.engine import (
    quantize_weights,
    weight_quant_plan,
)
from efficient_llm_inference_tpu_torch.models import gpt2 as tgpt2
from efficient_llm_inference_tpu_torch.models import llama as tllama
from efficient_llm_inference_tpu_torch.models.registry import gpt2_spec
from efficient_llm_inference_tpu_torch.ops import linear as tlin
from efficient_llm_inference_tpu_torch.ops import megakernel as tmk
from efficient_llm_inference_tpu_torch.ops import megakernel_batch as tmb
from efficient_llm_inference_tpu_torch.ops import megakernel_batch_quant as tmbq
from efficient_llm_inference_tpu_torch.ops import megakernel_batch_verify as tbv
from efficient_llm_inference_tpu_torch.ops import megakernel_llama as tml
from efficient_llm_inference_tpu_torch.ops import megakernel_quant as tmq


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _attention_inputs(k_bits, v_bits, B, G, Hkv, C, D, S, dtype, per_token, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g)

    def store(bits):
        if bits == 16:
            return rnd(B, Hkv, C, D).to(dtype)
        if bits == 8:
            return torch.randint(-127, 128, (B, Hkv, C, D), generator=g,
                                 dtype=torch.int8)
        return torch.randint(0, 256, (B, Hkv, C, D // 2), generator=g,
                             dtype=torch.int32).to(torch.uint8)

    def scales():
        if per_token:  # one scale per token, shared by every head
            return (rnd(C).abs() * 0.02 + 1e-3).expand(B, Hkv, C)
        return rnd(B, Hkv, C).abs() * 0.02 + 1e-3

    q = rnd(B, Hkv * G, D).to(dtype)
    lengths = torch.tensor([C - 1, 0, 7, C][:B], dtype=torch.int32)
    return [q, store(k_bits), scales(), store(v_bits), scales(),
            rnd(B, Hkv, S, D).to(dtype), rnd(B, Hkv, S, D).to(dtype), lengths]


MEGA_CFGS = {
    "small-test": dict(vocab_size=300, n_positions=256, n_embd=256, n_layer=2,
                       n_head=2),  # head_dim 128
    "gpt2": {},  # GPT-2 small at full width
}


def _mega_inputs(cfg, mode, C, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    L, E = cfg.n_layer, cfg.n_embd
    x = (torch.randn((1, E), generator=g) * 0.5).to(device)
    if mode == "fp":
        return [(torch.randn((L, C, E), generator=g) * 0.5).to(device)
                for _ in range(2)], x

    def pane(kind):
        width = E if kind == "int8" else E // 2
        lo = -127 if kind == "int8" else -128
        return torch.randint(lo, 128, (L, C, width), generator=g,
                             dtype=torch.int32).to(torch.int8).to(device)

    scales = [(torch.rand((L, C), generator=g) * 0.02 + 1e-3).to(device)
              for _ in range(2)]
    return [pane(k) for k in tmq._kv_kinds(mode)] + scales, x


LLAMA_CFGS = {  # small geometries: (G, head_dim, bias, head)
    "g2": dict(hidden_size=512, n_head=8, n_kv_head=4),
    "g4-untied": dict(hidden_size=512, n_head=8, n_kv_head=2, tie_embeddings=False),
    "g7-qwen": dict(hidden_size=896, n_head=14, n_kv_head=2, qkv_bias=True,
                    rms_eps=1e-6, rope_theta=1e6),
    "d128": dict(hidden_size=512, n_head=4, n_kv_head=2),
}


def _llama_cfg(name):
    kw = dict(vocab_size=300, intermediate_size=1024, n_layer=2, n_positions=512,
              rope_theta=10000.0, tie_embeddings=True)
    return tllama.LlamaConfig(**dict(kw, **LLAMA_CFGS[name]))


def _llama_params(cfg, device):
    params = tllama.init_llama_params(torch.Generator().manual_seed(1), cfg,
                                      torch.float32, device)
    for name, t in params["blocks"].items():  # weights at std 0.15, as the CPU tests
        if name.startswith("w"):
            t.mul_(7.5)
    return params


def _llama_inputs(cfg, mode, C, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    L, E, KW = cfg.n_layer, cfg.hidden_size, cfg.n_kv_head * cfg.head_dim
    x = (torch.randn((1, E), generator=g) * 0.5).to(device)
    if mode == "fp":
        return [(torch.randn((L, C, KW), generator=g) * 0.5).to(device)
                for _ in range(2)], x

    def pane(kind):
        width = KW if kind == "int8" else KW // 2
        lo = -127 if kind == "int8" else -128
        return torch.randint(lo, 128, (L, C, width), generator=g,
                             dtype=torch.int32).to(torch.int8).to(device)

    scales = [(torch.rand((L, C), generator=g) * 0.02 + 1e-3).to(device)
              for _ in range(2)]
    return [pane(k) for k in tmq._kv_kinds(mode)] + scales, x


# ------------------------------------------------------- batched (#14-#17)

BATCH_LENGTHS = [0, 37, 127, 5, 64, 126, 1, 100]  # C = 128: no visible row, the last column


def _batch_case(family, mode, dtype, B, device, wq=None):
    """(packed, cfg, panes and scales [L, B, C, W], x [B, E]) of a model of
    `family`: "gpt2" E = 256, head_dim 128; "gpt2-full" GPT-2 small at full
    width (a 48 KB staged input at B = 8 in bf16: the shared-memory opt-in),
    "gpt2-large-L2" GPT-2 large's width at 2 layers;
    "llama" G = 2, KW = 256; "llama-3-1b-L2" Llama-3.2-1B's widths at 2
    layers; "qwen2.5-7b-L1" / "llama-3-8b-L1" those models' widths at one
    layer (weights at the registry's std, drawn on the card). With `wq`, the
    weights of that weight_quant (`_tier_packed`)."""
    C = 128
    if wq is not None:
        kind, cfg, packed = _tier_packed(TIER_OF[family], wq, dtype, device)
        W = cfg.n_embd if kind == "gpt2" else cfg.n_kv_head * cfg.head_dim
        E = cfg.n_embd if kind == "gpt2" else cfg.hidden_size
    elif family.startswith("gpt2"):
        cfg = (dataclasses.replace(tgpt2.GPT2Config.large(), n_layer=2)
               if family == "gpt2-large-L2" else
               tgpt2.GPT2Config(**MEGA_CFGS["small-test" if family == "gpt2" else "gpt2"]))
        params = tgpt2.init_gpt2_params(torch.Generator().manual_seed(1), cfg,
                                        torch.float32, device)
        packed, W, E = tmk.pack_gpt2_mega(params, cfg), cfg.n_embd, cfg.n_embd
    elif family.endswith("-L1"):
        cfg = dataclasses.replace(tllama.LlamaConfig.by_name(family[:-3]), n_layer=1)
        params = tllama.init_llama_params(torch.Generator(device=device).manual_seed(1), cfg,
                                          torch.float32, device)
        packed = tml.pack_llama_mega(params, cfg)
        del params
        W, E = cfg.n_kv_head * cfg.head_dim, cfg.hidden_size
    else:
        cfg = (dataclasses.replace(tllama.LlamaConfig.llama3_1b(), n_layer=2)
               if family == "llama-3-1b-L2" else _llama_cfg("g2"))
        packed = tml.pack_llama_mega(_llama_params(cfg, device), cfg)
        W, E = cfg.n_kv_head * cfg.head_dim, cfg.hidden_size
    if wq is None:
        packed = {k: (v.to(dtype) if v.dtype == torch.float32 and k not in (
            "smalls", "lnf", "norms", "cos", "sin", "qkvb") else v) for k, v in packed.items()}
    g = torch.Generator(device="cpu").manual_seed(B * 7 + len(mode))
    L = cfg.n_layer
    x = (torch.randn((B, E), generator=g) * 0.5).to(dtype).to(device)
    if mode == "fp":
        return packed, cfg, [(torch.randn((L, B, C, W), generator=g) * 0.5).to(dtype)
                             .to(device) for _ in range(2)], x

    def pane(kind):
        width = W if kind == "int8" else W // 2
        lo = -127 if kind == "int8" else -128
        return torch.randint(lo, 128, (L, B, C, width), generator=g,
                             dtype=torch.int32).to(torch.int8).to(device)

    scales = [(torch.rand((L, B, C), generator=g) * 0.02 + 1e-3).to(device)
              for _ in range(2)]
    return packed, cfg, [pane(k) for k in tmq._kv_kinds(mode)] + scales, x


def _check_megabatch(cuda, family, mode, dtype, B, wq=None):
    packed, cfg, state, x = _batch_case(family, mode, dtype, B, cuda, wq)
    lengths = [BATCH_LENGTHS[b % len(BATCH_LENGTHS)] for b in range(B)]
    got = [t.clone() for t in state]
    want = [t.clone() for t in state]
    gpt2 = family.startswith("gpt2")
    if mode == "fp":
        kern = tmb.gpt2_megabatch if gpt2 else tmb.llama_megabatch
        plain = tmb.gpt2_megabatch_plain if gpt2 else tmb.llama_megabatch_plain
        kw = {}
    else:
        kern = tmbq.gpt2_megabatch_quant if gpt2 else tmbq.llama_megabatch_quant
        plain = tmbq.gpt2_megabatch_quant_plain if gpt2 else tmbq.llama_megabatch_quant_plain
        kw = {"kv_mode": mode}
    counter = tmk.launch_counter(kern, packed)  # the wrapper, or its weight tier's count
    before = (kern.launches, counter.launches)
    toks = kern(packed, *got, torch.tensor(lengths, dtype=torch.int32, device=cuda), x,
                cfg=cfg, **kw)[0]
    assert counter.launches == before[1] + 1 and toks.shape == (B,)
    assert kern.launches == before[0] + (counter is kern)
    logits = plain(packed, *want, lengths, x, cfg=cfg, return_logits=True, **kw)[-1]
    torch.cuda.synchronize()
    for b in range(B):
        top2 = logits[b].topk(2).values
        tok = int(toks[b])
        if dtype == torch.float32:
            assert tok == int(logits[b].argmax()) or float(top2[0] - top2[1]) < 1e-4
        else:
            assert float(logits[b, tok]) >= float(top2[0]) - 2e-2
    C = state[0].shape[2]
    for b, length in enumerate(lengths):
        others = torch.arange(C, device=cuda) != length
        for g_, w_, b_ in zip(got, want, state):
            assert torch.equal(g_[:, b][:, others], b_[:, b][:, others])
            assert torch.equal(w_[:, b][:, others], b_[:, b][:, others])
        if mode == "fp":
            for g_, w_ in zip(got, want):
                gn, wn = g_[:, b, length].float(), w_[:, b, length].float()
                rel = 1e-5 if dtype == torch.float32 else 1.6e-2
                assert (gn - wn).abs().max() <= rel * max(1.0, wn.abs().max().item())
            continue
        steps = 1 if dtype == torch.float32 else 2
        for kind, g_, w_, gs, ws in zip(tmq._kv_kinds(mode), got[:2], want[:2],
                                        got[2:], want[2:]):
            gv = tmq.pane_values(g_[:, b, length], kind) * gs[:, b, length, None]
            wv = tmq.pane_values(w_[:, b, length], kind) * ws[:, b, length, None]
            step = max(gs[:, b, length].max().item(), ws[:, b, length].max().item())
            assert (gv - wv).abs().max() <= steps * step * 1.01
            if dtype == torch.float32:
                torch.testing.assert_close(gs[:, b, length], ws[:, b, length],
                                           rtol=1e-5, atol=0)


# ------------------------------------------ batched verify (#18-#21), server

VERIFY_BATCH_LENGTHS = [0, 7, 111, 8, 64, 1, 100, 55]  # C = 128: up to C - 17


def _check_megabatch_verify(cuda, family, mode, dtype, B, R, wq=None):
    packed, cfg, state, _ = _batch_case(family, mode, dtype, B, cuda, wq)
    lengths = [VERIFY_BATCH_LENGTHS[b % len(VERIFY_BATCH_LENGTHS)] for b in range(B)]
    g = torch.Generator(device="cpu").manual_seed(B * 10 + R)
    ids = torch.randint(0, cfg.vocab_size, (B * R,), generator=g).to(torch.int32).to(cuda)
    gpt2 = family.startswith("gpt2")
    quant = mode != "fp"
    kern = {(True, False): tbv.gpt2_megabatch_verify, (True, True): tbv.gpt2_megabatch_verify_quant,
            (False, False): tbv.llama_megabatch_verify,
            (False, True): tbv.llama_megabatch_verify_quant}[(gpt2, quant)]
    plain = {(True, False): tbv.gpt2_megabatch_verify_plain,
             (True, True): tbv.gpt2_megabatch_verify_quant_plain,
             (False, False): tbv.llama_megabatch_verify_plain,
             (False, True): tbv.llama_megabatch_verify_quant_plain}[(gpt2, quant)]
    kw = {"kv_mode": mode} if quant else {}
    got = [t.clone() for t in state]
    want = [t.clone() for t in state]
    counter = tmk.launch_counter(kern, packed)
    before = (kern.launches, counter.launches)
    toks = kern(packed, *got, torch.tensor(lengths, dtype=torch.int32, device=cuda), ids,
                cfg=cfg, **kw)[0]
    assert counter.launches == before[1] + 1 and toks.shape == (B, R)
    assert kern.launches == before[0] + (counter is kern)
    logits = plain(packed, *want, lengths, ids, cfg=cfg, return_logits=True, **kw)[-1]
    torch.cuda.synchronize()
    C = state[0].shape[2]
    for b, cur in enumerate(lengths):
        new = torch.zeros(C, dtype=torch.bool, device=cuda)
        new[cur:cur + R] = True
        for g_, w_, b_ in zip(got, want, state):
            assert torch.equal(g_[:, b][:, ~new], b_[:, b][:, ~new])
            assert torch.equal(w_[:, b][:, ~new], b_[:, b][:, ~new])
        if not quant:
            for t in range(R):
                assert _token_close(int(toks[b, t]), logits[b, t], dtype), (b, t)
            for g_, w_ in zip(got, want):
                assert _rows_close(g_[:, b][:, new], w_[:, b][:, new], dtype)
            continue
        # quantized panes: row t against the plain step on the kernel's own
        # rows cur .. cur + t - 1 (the plain verify's own earlier rows may
        # differ from the kernel's by a code step, which row t attends)
        step_fn = tmq.gpt2_megastep_quant_plain if gpt2 else tmq.llama_megastep_quant_plain
        steps = 1 if dtype == torch.float32 else 2
        for t in range(R):
            panes = [s_[:, b].clone() for s_ in state]
            for p_, g_ in zip(panes, got):
                p_[:, cur:cur + t] = g_[:, b, cur:cur + t]
            tok_id = ids[b * R + t].long()
            if gpt2:
                pos = min(cur + t, cfg.n_positions - 1)
                x = (packed["wte"][tok_id] + packed["wpe"][pos])[None].to(dtype)
            else:
                x = packed["embed"][tok_id][None]
            lg = step_fn(packed, *panes, cur + t, x, cfg=cfg, kv_mode=mode,
                         return_logits=True)[-1]
            assert _token_close(int(toks[b, t]), lg, dtype, bf16_tol=4e-2), (b, t)
            r = cur + t
            for kind, g_, w_, gs, ws in zip(tmq._kv_kinds(mode), got[:2], panes[:2],
                                            got[2:], panes[2:]):
                gv = tmq.pane_values(g_[:, b, r], kind) * gs[:, b, r, None]
                wv = tmq.pane_values(w_[:, r], kind) * ws[:, r, None]
                step = max(gs[:, b, r].max().item(), ws[:, r].max().item())
                tol = steps * step * 1.01
                if dtype == torch.bfloat16:  # the values quantized may differ by
                    # the fp rows' bf16 tolerance (chip_smoke.py's deep-bf16)
                    tol += 1.6e-2 * max(1.0, wv.abs().max().item())
                assert (gv - wv).abs().max() <= tol, (b, t)
                if dtype == torch.float32:
                    torch.testing.assert_close(gs[:, b, r], ws[:, r], rtol=1e-5, atol=0)


# ------------------------------------------------- speculative decoding

VERIFY_FAMILIES = ["gpt2", "gpt2-full", "g2", "g4-untied", "g7-qwen", "d128"]


def _verify_case(family, dtype, device, wq=None):
    """(kind, packed, cfg) of a verify target: GPT-2 at E = 256 or GPT-2
    small's full width, or a small Llama/Qwen geometry of LLAMA_CFGS; with
    `wq`, the weights of that weight_quant (`_tier_packed`)."""
    if wq is not None:
        kind, cfg, packed = _tier_packed(TIER_OF[family], wq, dtype, device)
        return kind, packed, cfg
    if family.startswith("gpt2"):
        cfg = tgpt2.GPT2Config(**MEGA_CFGS["small-test" if family == "gpt2" else "gpt2"])
        params = tgpt2.init_gpt2_params(torch.Generator().manual_seed(2), cfg,
                                        torch.float32, device)
        packed, kind = tmk.pack_gpt2_mega(params, cfg), "gpt2"
    else:
        cfg = _llama_cfg(family)
        packed, kind = tml.pack_llama_mega(_llama_params(cfg, device), cfg), "llama"
    packed = {k: (v.to(dtype) if v.dtype == torch.float32 and k not in (
        "smalls", "lnf", "norms", "cos", "sin", "qkvb") else v) for k, v in packed.items()}
    return kind, packed, cfg


def _token_close(tok, logits, dtype, bf16_tol=2e-2):
    top2 = logits.topk(2).values
    if dtype == torch.float32:
        return tok == int(logits.argmax()) or float(top2[0] - top2[1]) < 1e-4
    return float(logits[tok]) >= float(top2[0]) - bf16_tol


def server_plain_logits(tspec, params, packed, prompt, out, capacity, dtype):
    """The plain single-stream logits (fp32, [len(out), V]) of one request
    that `MegaBatchServer` serves at pools of `dtype` over `params`,
    teacher-forced on its tokens `out`: row 0 the prefill's (its cache
    written in `dtype`), row j the plain step over `packed` (the server's
    weights, cast to the pools' dtype) fed out[j - 1], embedded as the
    server embeds it (from `packed`: GPT-2's wte and wpe rows summed in
    fp32, the sum rounded). The request must fit the pane: prompt +
    len(out) <= capacity."""
    gpt2 = tspec.name == "gpt2"
    emb = packed["wte"] if gpt2 else packed["embed"]
    dev, cfg, T = emb.device, tspec.config, len(prompt)
    strategy = DenseKV(n_layer=tspec.n_layer, n_head=tspec.n_kv_head, head_dim=tspec.head_dim,
                       capacity=capacity, batch=1, dtype=dtype, device=dev)
    toks = torch.tensor([prompt], dtype=torch.long, device=dev)
    pos = torch.arange(T, device=dev)[None]
    logits, cache = tspec.forward(params, toks, pos, strategy.init(), strategy, None)
    rows = [logits[0, -1].float()]
    k = tmb.to_mega_layout_batch(cache["k"])[:, 0].contiguous()
    v = tmb.to_mega_layout_batch(cache["v"])[:, 0].contiguous()
    step = tmk.gpt2_megastep_plain if gpt2 else tml.llama_megastep_plain
    for j in range(len(out) - 1):
        cur = T + j
        t = torch.tensor([out[j]], device=dev)
        x = (emb[t].float() + packed["wpe"][min(cur, tspec.n_positions - 1)].float()
             if gpt2 else emb[t])
        rows.append(step(packed, k, v, cur, x.to(dtype), cfg=cfg,
                         return_logits=True)[3].float())
    return torch.stack(rows)


def _rows_close(got, want, dtype):
    """New fp rows: fp32 within 1e-5, bf16 within 1.6e-2, of the rows'
    largest value (at least 1)."""
    rel = 1e-5 if dtype == torch.float32 else 1.6e-2
    g_, w_ = got.float(), want.float()
    return (g_ - w_).abs().max().item() <= rel * max(1.0, w_.abs().max().item())


def _check_megaverify(cuda, family, R, cur, dtype, wq=None):
    kind, packed, cfg = _verify_case(family, dtype, cuda, wq)
    kern = tmk.gpt2_megaverify if kind == "gpt2" else tml.llama_megaverify
    plain = tmk.gpt2_megaverify_plain if kind == "gpt2" else tml.llama_megaverify_plain
    L = cfg.n_layer
    W = cfg.n_embd if kind == "gpt2" else cfg.n_kv_head * cfg.head_dim
    C = 64
    g = torch.Generator(device="cpu").manual_seed(R * 100 + cur)
    state = [(torch.randn((L, C, W), generator=g) * 0.5).to(dtype).to(cuda) for _ in range(2)]
    ids = torch.randint(0, cfg.vocab_size, (R,), generator=g).to(cuda)
    length = torch.tensor([cur], dtype=torch.int32, device=cuda)
    want = [t.clone() for t in state]
    _, _, _, logits = plain(packed, *want, cur, ids, cfg=cfg, return_logits=True)
    rows = torch.arange(cur, cur + R, device=cuda)
    others = torch.ones(C, dtype=torch.bool, device=cuda)
    others[rows] = False
    for x in (ids.to(torch.int32), None):
        if x is None:  # the embeddings the engine's eager glue would build
            if kind == "gpt2":
                pos = torch.clamp(rows, max=cfg.n_positions - 1)
                x = (packed["wte"][ids] + packed["wpe"][pos]).to(dtype)
            else:
                x = packed["embed"][ids]
        got = [t.clone() for t in state]
        counter = tmk.launch_counter(kern, packed)
        before = (kern.launches, counter.launches)
        toks = kern(packed, *got, length, x, cfg=cfg)[0]
        torch.cuda.synchronize()
        assert counter.launches == before[1] + 1 and toks.shape == (R,)
        assert kern.launches == before[0] + (counter is kern)
        for t in range(R):
            assert _token_close(int(toks[t]), logits[t], dtype), (t, int(toks[t]))
        for g_, w_, b_ in zip(got, want, state):
            assert torch.equal(g_[:, others], b_[:, others])
            assert _rows_close(g_[:, rows], w_[:, rows], dtype)


DRAFT_CFGS = {  # the repo's byte-vocab drafts (examples/train_scale_models.py)
    "draft_gpt2": lambda: tgpt2.GPT2Config(vocab_size=256, n_positions=256, n_embd=128,
                                           n_layer=2, n_head=4),
    "draft_llama": lambda: tllama.LlamaConfig(
        vocab_size=256, n_positions=256, hidden_size=256, intermediate_size=512, n_layer=1,
        n_head=4, n_kv_head=2, rope_theta=10000.0, tie_embeddings=True),
}


# ------------------------------------------------ the kernel API (#4-#8, #24)

def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each value (the spacing above |t|; 2^-133 at 0)."""
    e = torch.floor(torch.log2(t.float().abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


LINEAR_SHAPES = [(1, 64, 256), (4, 128, 512), (3, 96, 77), (9, 64, 200), (17, 256, 1000),
                 (1, 768, 3072), (8, 3072, 768), (8, 768, 50257), (1, 2048, 8192),
                 (8, 8192, 2048)]


def _linear_close(got, want, x_dtype):
    """fp32: within 1e-5 of the output's largest value (the sum's order);
    bf16 output: one bf16 ulp of the plain result, plus that fp32 term."""
    fp32 = 1e-5 * max(1.0, want.float().abs().max().item())
    tol = fp32 if x_dtype == torch.float32 else _bf16_ulp(want) + fp32
    return bool(((got.float() - want.float()).abs() <= tol).all())


F32, BF16 = torch.float32, torch.bfloat16


def _attention_close(got, want, fp32_tol):
    """fp32 output: within `fp32_tol`. bf16 output: within two bf16 ulps of
    the plain result plus 1e-3 of its largest value (both round one fp32
    value whose sum order differs, so they sit one ulp apart at most)."""
    g_, w_ = got.float(), want.float()
    if got.dtype == torch.float32:
        return (g_ - w_).abs().max().item() <= fp32_tol
    return bool(((g_ - w_).abs() <= 2 * _bf16_ulp(w_) + 1e-3 * w_.abs().max().item()).all())


def _paged_case(B, Hq, Hkv, n_blocks, bs, max_blocks, lengths, q_dtype, pool_dtype, device,
                seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    D = 64
    q = torch.randn((B, Hq, D), generator=g).to(q_dtype).to(device)
    k_pool, v_pool = (torch.randn((Hkv, n_blocks, bs, D), generator=g).to(pool_dtype)
                      .to(device) for _ in range(2))
    perm = torch.randperm(n_blocks, generator=g)
    tables = torch.full((B, max_blocks), n_blocks, dtype=torch.int32)
    for b in range(B):  # each slot its own blocks, the rest sentinels
        used = min(max_blocks, -(-max(lengths[b], 1) // bs))
        tables[b, :used] = perm[(b * max_blocks) % n_blocks:][:used]
    tables[-1, -1] = n_blocks + 5
    lens = torch.tensor(lengths, dtype=torch.int32)
    return q, k_pool, v_pool, tables.to(device), lens.to(device)


# ------------------------------------------- weight tiers of #9, #11-#13

TIER_CFGS = {  # (family, config): small and full widths
    "gpt2-small-test": ("gpt2", MEGA_CFGS["small-test"]),
    "gpt2-full": ("gpt2", MEGA_CFGS["gpt2"]),
    "llama-g2": ("llama", LLAMA_CFGS["g2"]),
    "llama-g7-qwen": ("llama", LLAMA_CFGS["g7-qwen"]),
    "llama-3-1b-L2": ("llama", "llama-3-1b"),  # Llama-3.2-1B's width, 2 layers
}
_TIER_PARAMS, _TIER_PACKED = {}, {}


def _tier_packed(cfg_name, wq, dtype, device):
    """(family, cfg, packed) of a weight-quantized model (cached per case):
    random weights quantized by models' `quantize_*_weights` at int8, int4
    (group 128, or 64 where the JAX gates refuse 128: Qwen's 128-row tile)
    or the int4w8 group (GPT-2: E/2; Llama/Qwen: TR/2)."""
    family, kw = TIER_CFGS[cfg_name]
    if cfg_name not in _TIER_PARAMS:
        if family == "gpt2":
            cfg = tgpt2.GPT2Config(**kw)
            params = tgpt2.init_gpt2_params(torch.Generator().manual_seed(3), cfg,
                                            torch.float32, device)
        else:
            cfg = (dataclasses.replace(tllama.LlamaConfig.llama3_1b(), n_layer=2)
                   if kw == "llama-3-1b" else _llama_cfg(cfg_name[6:]))
            params = _llama_params(cfg, device)
        _TIER_PARAMS[cfg_name] = (cfg, params)
    cfg, params = _TIER_PARAMS[cfg_name]
    key = (cfg_name, wq, dtype)
    if key not in _TIER_PACKED:
        spec = gpt2_spec(cfg) if family == "gpt2" else tllama.llama_spec(cfg)
        pack = tmk.pack_gpt2_mega if family == "gpt2" else tml.pack_llama_mega
        qspec, mode, G = weight_quant_plan(spec, wq)  # as from_model_name quantizes
        assert qspec is spec
        packed = None
        for G in ((G,) if wq == "int4w8" else (G, 64)):
            packed = pack(quantize_weights(spec, _tree_to(params, dtype), mode, G), cfg)
            if packed is not None:
                break
        assert packed is not None and tmk.weight_kind(packed) == wq[:4], key
        _TIER_PACKED[key] = (family, cfg, packed)
    return _TIER_PACKED[key]


def _tree_to(tree, *args):
    """A nested dict of tensors with `.to(*args)` applied to every leaf."""
    return {k: (_tree_to(v, *args) if isinstance(v, dict) else v.to(*args))
            for k, v in tree.items()}



# ------------------------- weight tiers of #10, #13 at R > 1, #14-#21

# the batched and verify cases' families -> TIER_CFGS
TIER_OF = {"gpt2": "gpt2-small-test", "gpt2-full": "gpt2-full", "llama": "llama-g2",
           "g2": "llama-g2", "llama-3-1b-L2": "llama-3-1b-L2"}


# ------------------- the bf16 tensor-core route (#7, the batched verify GEMVs)

TC_LINEAR_SHAPES = [(2048, 8192), (768, 50257), (96, 77), (100, 200)]


def _gemv_weight(N, K, tier, g, device):
    """Weight rows [N, K] of a tier: bf16, int8 codes with fp32 row scales,
    or packed int4 (group 128) with bf16 scales, as the packers lay them."""
    w = torch.randn((N, K), generator=g) / K ** 0.5
    if tier == "fp":
        return w.to(BF16).to(device), None
    if tier == "int8":
        q, s = tlin.quantize_weight_int8(w, axis=1)
        return q.to(device), s.reshape(N).to(device)
    q = tgpt2.quantize_int4_weights(w.t().contiguous(), 128)  # [K/G, G/2, N] codes
    codes = q["q4"].permute(2, 0, 1).reshape(N, K // 2).contiguous()
    return codes.to(device), q["s"][:, 0, :].t().contiguous().to(BF16).to(device)



# ---------------- the single-stream Llama chain's split-KV attention (#13, #12)

SPLIT_CFGS = {  # Llama-3.2-1B's width at 2 layers (G = 4), a Qwen group of 7, head_dim 128
    "llama-3-1b-L2": "llama-3-1b",
    "g7-qwen": LLAMA_CFGS["g7-qwen"],
    "d128": LLAMA_CFGS["d128"],
}
SPLIT_WHERE = ["zero", "one", "split_last", "split_first", "last"]
_SPLIT_PARAMS, _SPLIT_PACKED = {}, {}


def _split_packed(cfg_name, wq, dtype, device):
    """(cfg, packed) of a SPLIT_CFGS model in `dtype` over model-dtype
    weights (wq None) or a weight tier quantized as from_model_name does
    (int4 at group 128, or 64 where the JAX gates refuse 128)."""
    if cfg_name not in _SPLIT_PARAMS:
        kw = SPLIT_CFGS[cfg_name]
        cfg = (dataclasses.replace(tllama.LlamaConfig.llama3_1b(), n_layer=2)
               if kw == "llama-3-1b" else _llama_cfg(cfg_name))
        _SPLIT_PARAMS[cfg_name] = (cfg, _llama_params(cfg, device))
    cfg, params = _SPLIT_PARAMS[cfg_name]
    key = (cfg_name, wq, dtype)
    if key not in _SPLIT_PACKED:
        tree = _tree_to(params, dtype)
        if wq is None:
            packed = tml.pack_llama_mega(tree, cfg)
        else:
            spec = tllama.llama_spec(cfg)
            _, mode, G = weight_quant_plan(spec, wq)
            packed = None
            for G in ((G,) if wq == "int4w8" else (G, 64)):
                packed = tml.pack_llama_mega(quantize_weights(spec, tree, mode, G), cfg)
                if packed is not None:
                    break
        assert packed is not None, key
        _SPLIT_PACKED[key] = (cfg, packed)
    return _SPLIT_PACKED[key]


def _split_length(cfg, C, where):
    """A length at an edge of the launcher's split plan: no visible row, one,
    the last row of split 0 visible last, the first row of split 1 visible
    last, or the last row of the panes written."""
    _, rows = tml.attention_plan(C, cfg.n_head, cfg.n_kv_head,
                                 torch.cuda.get_device_properties(0).multi_processor_count)
    return {"zero": 0, "one": 1, "split_last": min(rows, C - 1),
            "split_first": min(rows + 1, C - 1), "last": C - 1}[where]


def _check_llama_split_step(device, cfg_name, wq, mode, dtype, C, length):
    """The single-stream step against its plain step: fp32 tokens equal where
    the top-2 gap is at least 1e-4, bf16 within 2e-2 of the plain maximum;
    new rows within 1e-5 (fp32) / 1.6e-2 (bf16) of their largest value,
    quantized rows within one (fp32) / two (bf16) steps, fp32 scales within
    1e-5; every other row untouched; one launch counted where it belongs."""
    cfg, packed = _split_packed(cfg_name, wq, dtype, device)
    state, x = _llama_inputs(cfg, mode, C, seed=length + 11, device=device)
    state = [t.to(dtype) if t.is_floating_point() and t.dim() == 3 else t for t in state]
    x = x.to(dtype)
    got = [t.clone() for t in state]
    want = [t.clone() for t in state]
    step, plain = ((tml.llama_megastep, tml.llama_megastep_plain) if mode == "fp" else
                   (tmq.llama_megastep_quant, tmq.llama_megastep_quant_plain))
    kw = {} if mode == "fp" else {"kv_mode": mode}
    counter = step if wq is None else step.tiers[wq[:4]]
    before = counter.launches
    tok = int(step(packed, *got, length, x, cfg=cfg, **kw)[0])
    assert counter.launches == before + 1
    logits = plain(packed, *want, length, x, cfg=cfg, return_logits=True, **kw)[-1]
    torch.cuda.synchronize()
    top2 = logits.topk(2).values
    if dtype == torch.float32:
        if float(top2[0] - top2[1]) >= 1e-4:
            assert tok == int(logits.argmax())
    else:
        assert float(logits[tok]) >= float(top2[0]) - 2e-2
    others = torch.arange(C, device=device) != length
    for g_, w_, b_ in zip(got, want, state):
        assert torch.equal(g_[:, others], b_[:, others])
        assert torch.equal(w_[:, others], b_[:, others])
    if mode == "fp":
        rel = 1e-5 if dtype == torch.float32 else 1.6e-2
        for g_, w_ in zip(got, want):
            atol = rel * max(1.0, w_[:, length].float().abs().max().item())
            torch.testing.assert_close(g_[:, length].float(), w_[:, length].float(),
                                       atol=atol, rtol=0)
        return
    steps = 1 if dtype == torch.float32 else 2
    for kind, g_, w_, gs, ws in zip(tmq._kv_kinds(mode), got[:2], want[:2], got[2:],
                                    want[2:]):
        gv = tmq.pane_values(g_[:, length], kind) * gs[:, length, None]
        wv = tmq.pane_values(w_[:, length], kind) * ws[:, length, None]
        tol = steps * max(gs[:, length].max().item(), ws[:, length].max().item()) * 1.01
        assert (gv - wv).abs().max() <= tol
        if dtype == torch.float32:
            torch.testing.assert_close(gs[:, length], ws[:, length], rtol=1e-5, atol=0)
