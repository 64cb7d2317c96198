"""The port's `MegaBatchServer` at the JAX server's default pool dtype, bf16,
over fp32 weights, against the JAX server at its default (interpret mode),
on the CPU, on the same numpy-made weights.

JAX makes bf16 pools whatever the params' dtype and computes the fp-pane
decode in the panes' dtype on weight tiles cast to it (JAX
engine/megaserver.py `dtype=jnp.bfloat16`, ops/pallas/megakernel_batch.py);
the prefill writes its DenseKV in the pools' dtype. The port does the same:
its decode kernels (here their plain versions) take a copy of the packed
weights cast once to bf16 (`ops.megakernel.cast_packed`: the norms' gains,
biases and fp32 scales stay fp32, as JAX keeps its smalls fp32). The
kernels embed from that copy: GPT-2's wte and wpe rows are each rounded to
bf16 before their sum is, where JAX's x_emb rounds the fp32 sum once (with
the sum rounded once instead, no request here parted either).

Tolerance: the two sides round at the same points (GPT-2's embedding
apart) but sum in other orders
(the JAX kernels' dots against the plain versions' torch.mv; bf16 outputs
one rounding apart now and then), so a request's stream may part at a
near-tie. Every request's tokens are equal up to the first parting, and
there JAX's token is within the port's stated bf16 limit, 2e-2, of the
maximum of the port's own bf16 logits (the plain single-stream step over
the same bf16 weights and prefill), the limit the card tests and
chip_smoke.py hold a bf16 kernel's token to. Quantized pools decode in the
weights' dtype (JAX's quantized kernels compute in x_emb's dtype; only the
prefill's cache is bf16 before it is quantized): their tokens are equal.
"""

import numpy as np
import pytest
import torch

from efficient_llm_inference_tpu.engine.batching import Request as JaxRequest
from efficient_llm_inference_tpu.engine.megaserver import MegaBatchServer as JaxServer
from efficient_llm_inference_tpu.engine.megaserver import MegaPoolConfig as JaxPool
from efficient_llm_inference_tpu_torch import MegaBatchServer, MegaPoolConfig, Request
from efficient_llm_inference_tpu_torch.data.tokenizer import ByteTokenizer
from efficient_llm_inference_tpu_torch.ops import megakernel as tmk
from efficient_llm_inference_tpu_torch.ops import megakernel_llama as tml
from test_torch_megaserver import BUDGETS, FITS, POOL, PROMPTS, family
from torch_cuda_cases import server_plain_logits

BF16_TOL = 2e-2  # a bf16 token's plain logit within this of the maximum


def _serve(server, request_type, idx):
    tok = ByteTokenizer()
    reqs = [request_type(rid=i, prompt_ids=tok.encode(PROMPTS[i]), max_new_tokens=BUDGETS[i])
            for i in idx]
    server.run(reqs)
    assert all(r.done for r in reqs)
    return reqs


CASES = [("gpt2", None, None), ("gpt2", "ngram", None), ("llama", None, None),
         ("llama", "ngram", None), ("gpt2", None, "int8")]


@pytest.mark.parametrize("name,spec,kv_mode", CASES)
def test_default_dtype_server_matches_jax(name, spec, kv_mode):
    """The requests that fit the pane, JAX's server at its default dtype
    (bf16 pools) against the port's at its default, both over fp32 params;
    the tolerance is the module docstring's."""
    jspec, tspec, jp, tp = family(name)
    kw = dict(spec=spec, spec_k=4, kv_mode=kv_mode)
    want = _serve(JaxServer(jspec, jp, pool=JaxPool(**POOL), interpret=True, **kw),
                  JaxRequest, FITS)
    srv = MegaBatchServer(tspec, tp, pool=MegaPoolConfig(**POOL), **kw)
    assert srv.k_pool.dtype == (torch.int8 if kv_mode else torch.bfloat16)
    assert srv.packed["smalls" if name == "gpt2" else "norms"].dtype == torch.float32
    got = _serve(srv, Request, FITS)
    parted = 0
    for g, w in zip(got, want):
        if g.out_ids == w.out_ids:
            continue
        assert kv_mode is None, (g.rid, g.out_ids, w.out_ids)
        i = next(j for j, (a, b) in enumerate(zip(g.out_ids, w.out_ids)) if a != b)
        logits = server_plain_logits(tspec, tp, srv.packed, g.prompt_ids, g.out_ids[:i + 1],
                                     POOL["capacity"], torch.bfloat16)[i]
        top = float(logits.max())
        assert int(torch.argmax(logits)) == g.out_ids[i]
        assert float(logits[w.out_ids[i]]) >= top - BF16_TOL, (g.rid, i)
        parted += 1
    assert parted <= 1, "more than one request parted at a near-tie"
    assert any(len(set(r.out_ids)) > 1 for r in got)


def test_cast_packed_keeps_the_fp32_smalls():
    """cast_packed casts the weights the kernels read in the model dtype and
    keeps the fp32 ones; over fp32 params the result is the bf16 rounding
    of each weight."""
    for name in ("gpt2", "llama"):
        _, tspec, _, tp = family(name)
        pack = tmk.pack_gpt2_mega if name == "gpt2" else tml.pack_llama_mega
        packed = pack(tp, tspec.config)
        cast = tmk.cast_packed(packed, torch.bfloat16)
        assert set(cast) == set(packed)
        for key, t in packed.items():
            if key in tmk.FP32_KEYS:
                assert cast[key] is t
            else:
                assert cast[key].dtype == torch.bfloat16
                np.testing.assert_array_equal(cast[key].float().numpy(),
                                              t.to(torch.bfloat16).float().numpy())
