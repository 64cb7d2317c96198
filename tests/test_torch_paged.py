"""The port's paged decode attention wrapper (#24 `paged_attention_decode`;
ops/paged.py) against the JAX package's Pallas kernel in interpret mode, on
the CPU, where the wrapper runs its plain version.

Tolerance 2e-5 in fp32 (absolute and relative): both take the same fp32
scores and sum in another order. Cases: the JAX test's shapes (B = 3, D =
64, block 16, 10 blocks, 4 a table; Hq/Hkv 4/4 and 8/2) with sentinel
entries; a slot with length 0, whose output is the JAX kernel's uniform
mean of V over every walked position (sentinels clamped), not zero; a
length past the table's reach; and, in fp32 and bf16 pools, dense
attention over the unpaged rows, which is the same function.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efficient_llm_inference_tpu.ops.pallas.paged import paged_attention_decode as jpaged
from efficient_llm_inference_tpu_torch.ops import paged as tpaged

TOL = 2e-5


def _case(Hq, Hkv, lengths, seed=0, B=3, D=64, bs=16, n_blocks=10, max_blocks=4):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    k_pool = rng.normal(size=(Hkv, n_blocks, bs, D)).astype(np.float32)
    v_pool = rng.normal(size=(Hkv, n_blocks, bs, D)).astype(np.float32)
    tables = np.full((B, max_blocks), n_blocks, np.int32)  # sentinels
    perm = rng.permutation(n_blocks)
    used = [3, 4, 2][:B] + [1] * max(0, B - 3)
    start = 0
    for b in range(B):
        n = min(used[b], max_blocks)
        tables[b, :n] = perm[start:start + n] % n_blocks
        start += n
    tables[-1, -1] = n_blocks + 7  # a sentinel past n_blocks, also clamped
    return q, k_pool, v_pool, tables, np.asarray(lengths, np.int32)


def _both(q, k_pool, v_pool, tables, lengths):
    want = jpaged(jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
                  jnp.asarray(tables), jnp.asarray(lengths), interpret=True)
    got = tpaged.paged_attention_decode(*(torch.from_numpy(np.array(a)) for a in
                                          (q, k_pool, v_pool, tables, lengths)))
    return got, np.asarray(want)


@pytest.mark.parametrize("lengths", [[37, 60, 20], [0, 60, 1], [64, 0, 200]])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2)])
def test_paged_attention_matches_jax(Hq, Hkv, lengths):
    case = _case(Hq, Hkv, lengths)
    got, want = _both(*case)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_zero_length_slot_is_the_mean_of_the_walked_rows():
    """lengths[b] == 0: the mean of V over all max_blocks x bs walked
    positions, sentinels clamped to the last block (the JAX kernel's
    finfo.min mask), for every query head of the group."""
    q, k_pool, v_pool, tables, lengths = _case(8, 2, [0, 60, 0])
    got, want = _both(q, k_pool, v_pool, tables, lengths)
    t = np.minimum(tables, k_pool.shape[1] - 1)
    for b in (0, 2):
        mean = v_pool[:, t[b]].reshape(2, -1, 64).mean(axis=1)  # [Hkv, D]
        np.testing.assert_allclose(got[b].numpy(), np.repeat(mean, 4, axis=0),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(want[b], np.repeat(mean, 4, axis=0), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_equals_dense_attention_over_the_unpaged_rows(dtype):
    """Gathering each slot's visible rows into a dense [T, D] block and
    attending over it (softmax in fp32) gives the same output."""
    q, k_pool, v_pool, tables, lengths = _case(8, 2, [37, 60, 20], seed=3)
    args = [torch.from_numpy(np.array(a)) for a in (q, k_pool, v_pool, tables, lengths)]
    args[:3] = [a.to(dtype) for a in args[:3]]
    got = tpaged.paged_attention_decode(*args)
    qt, kp, vp = (a.float() for a in args[:3])
    for b, n in enumerate(lengths):
        rows = [(blk, r) for blk in tables[b] for r in range(16)][:n]
        k = torch.stack([kp[:, blk, r] for blk, r in rows], dim=1)  # [Hkv, n, D]
        v = torch.stack([vp[:, blk, r] for blk, r in rows], dim=1)
        k, v = k.repeat_interleave(4, dim=0), v.repeat_interleave(4, dim=0)
        p = torch.softmax(torch.einsum("hd,hnd->hn", qt[b], k) / 8.0, dim=-1)
        dense = torch.einsum("hn,hnd->hd", p, v).to(dtype)
        tol = TOL if dtype == torch.float32 else 2 ** -8
        torch.testing.assert_close(got[b].float(), dense.float(), rtol=tol, atol=tol)
