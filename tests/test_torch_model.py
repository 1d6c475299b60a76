"""The port's model (params bridge, prefill, decode step, one-shot sampler)
against the JAX package on the CPU, in fp32, from weights carried across
with ``models/convert.py``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_2_distributed_tpu.models import decode as jax_decode
from gpt_2_distributed_tpu.models import gpt2 as jax_gpt2
from gpt_2_distributed_torch.config import GPT2Config
from gpt_2_distributed_torch.models import decode, gpt2
from gpt_2_distributed_torch.models.convert import (
    load_npz,
    params_from_jax,
    params_to_jax,
    save_npz,
)

PROMPT = [[3, 17, 42, 200, 5, 9, 250], [1, 1, 2, 3, 5, 8, 13]]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: intra-op threads only contend with the other test
    workers sharing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_config(jax_config) -> GPT2Config:
    return GPT2Config(
        vocab_size=jax_config.vocab_size, n_positions=jax_config.n_positions,
        n_embd=jax_config.n_embd, n_layer=jax_config.n_layer,
        n_head=jax_config.n_head,
    )


@pytest.fixture(scope="module")
def jax_params(tiny_config):
    return jax_gpt2.init_params(tiny_config, seed=0)


@pytest.fixture(scope="module")
def jax_tree(jax_params):
    return jax.tree_util.tree_map(np.asarray, jax_params)


@pytest.fixture(scope="module")
def weights(jax_tree):
    return gpt2.compute_weights(params_from_jax(jax_tree), torch.float32,
                                torch.device("cpu"))


def _assert_trees_equal(a, b):
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], dict):
            _assert_trees_equal(a[key], b[key])
        else:
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
            np.testing.assert_array_equal(a[key], b[key]), key


def test_params_bridge_is_bitwise_identity(jax_tree, tiny_config, tmp_path):
    port = params_from_jax(jax_tree)
    _assert_trees_equal(params_to_jax(port, tiny_config.n_head), jax_tree)
    fresh = gpt2.init_params(port_config(tiny_config), seed=3)
    back = params_from_jax(params_to_jax(fresh, tiny_config.n_head))
    for key in ("wte", "wpe", "ln_f_scale", "ln_f_bias"):
        assert torch.equal(back[key], fresh[key])
    for bp, bq in zip(back["blocks"], fresh["blocks"]):
        assert all(torch.equal(bp[k], bq[k]) for k in bp)
    path = str(tmp_path / "params.npz")
    save_npz(path, jax_tree)
    loaded = load_npz(path)
    assert all(torch.equal(loaded["blocks"][1][k], port["blocks"][1][k])
               for k in gpt2.BLOCK_KEYS)


def test_prefill_and_decode_step_match_jax(jax_params, weights, tiny_config):
    cfg = port_config(tiny_config)
    prompt = np.array(PROMPT, np.int32)
    total = prompt.shape[1] + 4
    h_j, cache_j = jax_decode.prefill(jax_params, tiny_config, jnp.asarray(prompt),
                                      total, jnp.float32)
    h_p, cache_p = decode.prefill(weights, cfg, torch.from_numpy(prompt), total)
    np.testing.assert_allclose(h_p.numpy(), np.asarray(h_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(cache_p.k.numpy(), np.asarray(cache_j.k), atol=1e-5, rtol=0)
    np.testing.assert_allclose(cache_p.v.numpy(), np.asarray(cache_j.v), atol=1e-5, rtol=0)

    # Two decode steps, the second over the first one's cache write; the
    # token ids include an out-of-range one, which both sides clamp.
    for pos, tok in ((prompt.shape[1], [7, 300]), (prompt.shape[1] + 1, [9, 11])):
        tok = np.array(tok, np.int32)
        logits_j, cache_j = jax_decode.decode_step(
            jax_params, tiny_config, jnp.asarray(tok), jnp.int32(pos), cache_j,
            jnp.float32)
        logits_p = decode.decode_step(weights, cfg, torch.from_numpy(tok), pos, cache_p)
        assert logits_p.dtype == torch.float32
        np.testing.assert_allclose(logits_p.numpy(), np.asarray(logits_j),
                                   atol=1e-5, rtol=0)


def test_greedy_generate_cached_matches_jax(jax_params, jax_tree, tiny_config):
    cfg = port_config(tiny_config)
    want = jax_decode.generate_cached(
        jax_params, tiny_config, jnp.asarray(PROMPT, jnp.int32),
        jax.random.PRNGKey(0), max_new_tokens=12, temperature=0.0,
        compute_dtype=jnp.float32,
    )
    got = decode.generate_cached(params_from_jax(jax_tree), cfg, PROMPT,
                                 max_new_tokens=12, temperature=0.0,
                                 compute_dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_cached_refuses_a_missing_gpu(jax_tree, tiny_config):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode.generate_cached(params_from_jax(jax_tree), port_config(tiny_config),
                               PROMPT, max_new_tokens=2)
