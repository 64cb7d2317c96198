"""The port's continuous-batching server against the JAX package's for the
Llama family: tests/test_torch_megaserver.py's `test_server_matches_jax_server`
at its Llama cases (plain and spec="ngram", panes in the model dtype and
int8), in a file of their own so that one xdist worker (`--dist loadfile`)
does not carry both families' servers."""

import pytest

from test_torch_megaserver import LLAMA_CASES, check_server_matches_jax_server


@pytest.mark.parametrize("name,spec,kv_mode", LLAMA_CASES)
def test_server_matches_jax_server(name, spec, kv_mode):
    check_server_matches_jax_server(name, spec, kv_mode)
