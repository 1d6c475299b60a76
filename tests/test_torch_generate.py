"""The port's uncached sampler (``models/generate.py::generate``) against
the JAX package's ``generate`` and against the port's own
``generate_cached`` on the CPU, in fp32, from weights carried across with
``models/convert.py``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_2_distributed_tpu.models import generate as jax_generate
from gpt_2_distributed_tpu.models import gpt2 as jax_gpt2
from gpt_2_distributed_torch.config import GPT2Config
from gpt_2_distributed_torch.models import decode
from gpt_2_distributed_torch.models import generate as port_generate
from gpt_2_distributed_torch.models.convert import params_from_jax

PROMPT = [[3, 17, 42, 200, 5, 9, 250], [1, 1, 2, 3, 5, 8, 13]]
NEW = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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
def params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))


def test_greedy_generate_matches_jax_ids_and_logits(jax_params, params, tiny_config,
                                                    monkeypatch):
    """Greedy ids equal, and each step's fp32 logits within 1e-5: the JAX
    logits are read through a debug callback in its ``sample_token``, the
    port's through a wrapper around its own."""
    seen_jax, seen_port = [], []

    def capture_jax(logits, rng, temperature, top_k):
        jax.debug.callback(lambda lg: seen_jax.append(np.asarray(lg)), logits, ordered=True)
        return jnp.argmax(logits, axis=-1).astype(jnp.int32)

    monkeypatch.setattr(jax_generate, "sample_token", capture_jax)
    # A fresh jit of the undecorated function traces the patched sampler
    # whatever other tests put in the module's compile cache.
    fresh = jax.jit(jax_generate.generate.__wrapped__,
                    static_argnames=("config", "max_new_tokens", "temperature", "top_k",
                                     "compute_dtype"))
    want = fresh(jax_params, tiny_config, jnp.asarray(PROMPT, jnp.int32),
                 jax.random.PRNGKey(0), max_new_tokens=NEW, temperature=0.0,
                 compute_dtype=jnp.float32)
    want = np.asarray(jax.block_until_ready(want))
    jax.effects_barrier()

    sample = port_generate.sample_token

    def capture_port(logits, gens, temperature, top_k):
        seen_port.append(logits.numpy().copy())
        return sample(logits, gens, temperature, top_k)

    monkeypatch.setattr(port_generate, "sample_token", capture_port)
    got = port_generate.generate(params, port_config(tiny_config), PROMPT,
                                 max_new_tokens=NEW, temperature=0.0,
                                 compute_dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(seen_port) == len(seen_jax) == NEW
    for step, (a, b) in enumerate(zip(seen_port, seen_jax)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=f"step {step}")


@pytest.mark.parametrize("temperature, top_k, seed", [(0.0, None, 0), (1.0, None, 5),
                                                      (0.9, 40, 11)])
def test_generate_equals_generate_cached(params, tiny_config, temperature, top_k, seed):
    """One generator for the batch, drawn row by row in the same order: at
    fp32 on the CPU the uncached and cached samplers give the same ids,
    greedy and sampled."""
    cfg = port_config(tiny_config)
    kw = dict(seed=seed, max_new_tokens=NEW, temperature=temperature, top_k=top_k,
              compute_dtype=torch.float32, device="cpu")
    got = port_generate.generate(params, cfg, PROMPT, **kw)
    want = decode.generate_cached(params, cfg, PROMPT, **kw)
    assert got.shape == (2, len(PROMPT[0]) + NEW) and got.dtype == torch.long
    assert torch.equal(got[:, :len(PROMPT[0])], torch.tensor(PROMPT))
    assert torch.equal(got, want)


@pytest.mark.parametrize("case, match", [
    ("length", "exceeds n_positions"),
    ("top_k_low", "top_k"),
    ("top_k_high", "top_k"),
    ("zero_new", "max_new_tokens"),
])
def test_generate_refuses_what_jax_refuses(jax_params, params, tiny_config, case, match):
    """The JAX ``generate``'s ValueErrors, with the same messages."""
    cfg = port_config(tiny_config)
    prompt = np.zeros((1, 4), np.int32)
    kw = dict(max_new_tokens=4)
    if case == "length":
        prompt = np.zeros((1, tiny_config.n_positions - 2), np.int32)
        kw = dict(max_new_tokens=8)
    elif case == "top_k_low":
        kw["top_k"] = 0
    elif case == "top_k_high":
        kw["top_k"] = tiny_config.vocab_size + 1
    else:
        kw["max_new_tokens"] = 0
    with pytest.raises(ValueError, match=match) as jax_err:
        jax_generate.generate(jax_params, tiny_config, jnp.asarray(prompt),
                              jax.random.PRNGKey(0), **kw)
    with pytest.raises(ValueError, match=match) as port_err:
        port_generate.generate(params, cfg, prompt, device="cpu", **kw)
    assert str(port_err.value) == str(jax_err.value)


def test_generate_refuses_a_missing_gpu(params, tiny_config):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_generate.generate(params, port_config(tiny_config), PROMPT, max_new_tokens=2)


def test_generate_reruns_the_forward_over_the_ids_so_far(params, tiny_config, monkeypatch):
    """Step t runs the stack over ``ids[:, :t]`` (no padding to the final
    length) and hands only row t - 1 to the head."""
    from gpt_2_distributed_torch.models import gpt2

    lengths, head_rows = [], []
    layers, head = gpt2.infer_layers, gpt2.logits_fp32

    def spy_layers(w, config, x, attn_fn, cache=None):
        lengths.append(x.shape[1])
        return layers(w, config, x, attn_fn, cache)

    def spy_head(w, h):
        head_rows.append(tuple(h.shape))
        return head(w, h)

    monkeypatch.setattr(gpt2, "infer_layers", spy_layers)
    monkeypatch.setattr(gpt2, "logits_fp32", spy_head)
    port_generate.generate(params, port_config(tiny_config), PROMPT, max_new_tokens=5,
                           temperature=0.0, compute_dtype=torch.float32, device="cpu")
    p = len(PROMPT[0])
    assert lengths == list(range(p, p + 5))
    assert head_rows == [(2, tiny_config.n_embd)] * 5

