"""Shared inputs of the port's parity tests: GPT-2 parameters drawn with
numpy from a seed, in the JAX package's stacked-layer layout, so the same
arrays feed both packages."""

import numpy as np


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


def to_jax(tree):
    import jax.numpy as jnp

    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)
