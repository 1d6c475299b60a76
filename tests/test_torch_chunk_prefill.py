"""Chunked prefill of the port on the CPU, against the JAX package: the
plain ``paged_prefill_attention`` against JAX's over a partly built block
table with stale data in the pool, ``chunk_prefill`` against the JAX
engine's ``_chunk_prefill_impl`` (pools and fp32 logits), and K1's
query-offset plain version against the whole-prompt one. Inputs come from a
numpy seed; fp32 throughout, so the bound is 1e-5."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_2_distributed_tpu.models import gpt2 as jax_gpt2
from gpt_2_distributed_tpu.ops.paged_attention import (
    paged_prefill_attention as jax_paged_prefill_attention,
)
from gpt_2_distributed_tpu.serving import engine as jax_engine
from gpt_2_distributed_torch.config import GPT2Config
from gpt_2_distributed_torch.models import gpt2
from gpt_2_distributed_torch.models.convert import params_from_jax
from gpt_2_distributed_torch.ops.flash_attention import (
    flash_attention_fwd_offset,
    flash_attention_offset_plain,
    flash_attention_plain,
)
from gpt_2_distributed_torch.ops.paged_attention import paged_prefill_attention
from gpt_2_distributed_torch.serving.engine import chunk_prefill

TOL = 1e-5
N, H, BS, D, M = 20, 2, 8, 16, 8   # pool blocks, heads, block size, head dim, table width


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table(rng, rows: int) -> np.ndarray:
    """Block tables of distinct non-null blocks, one row per sequence."""
    return np.stack([rng.permutation(np.arange(1, N))[:M] for _ in range(rows)]).astype(np.int32)


@pytest.mark.parametrize("start", [0, 5, 16, 60], ids=["zero", "mid_block",
                                                       "block_aligned", "straddling"])
def test_plain_paged_prefill_attention_matches_jax(start):
    """Queries at ``start .. start + 7`` (the last case past n_positions =
    64) and a second sequence at 3, over pools whose every block holds
    random data: what a query must not read is stale garbage, so the mask
    is what is held."""
    rng = np.random.default_rng(start)
    t = 8
    q = rng.standard_normal((2, t, H, D)).astype(np.float32)
    k_pool, v_pool = (rng.standard_normal((N, H, BS, D)).astype(np.float32) for _ in range(2))
    table = _table(rng, 2)
    starts = np.array([start, 3], np.int32)
    want = jax_paged_prefill_attention(jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
                                       jnp.asarray(table), jnp.asarray(starts))
    got = paged_prefill_attention(torch.from_numpy(q), torch.from_numpy(k_pool),
                                  torch.from_numpy(v_pool), torch.from_numpy(table),
                                  torch.from_numpy(starts))
    assert got.shape == (2, t, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    plain = paged_prefill_attention(torch.from_numpy(q), torch.from_numpy(k_pool),
                                    torch.from_numpy(v_pool), torch.from_numpy(table),
                                    torch.from_numpy(starts), impl="plain")
    assert torch.equal(plain, got)   # "auto" on CPU tensors is the plain version


def test_paged_prefill_attention_refuses_the_kernel_on_the_cpu():
    q = torch.zeros(1, 4, H, D)
    pool = torch.zeros(N, H, BS, D)
    table, start = torch.ones(1, M, dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        paged_prefill_attention(q, pool, pool, table, start, impl="kernel")
    with pytest.raises(ValueError, match="impl="):
        paged_prefill_attention(q, pool, pool, table, start, impl="xla")


def test_offset_plain_at_start_zero_is_the_whole_prompt_plain_version():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, 40, D)).astype(np.float32))
               for _ in range(3))
    zero = torch.zeros(2, dtype=torch.int32)
    o, lse = flash_attention_offset_plain(q, k, v, zero)
    o_ref, lse_ref = flash_attention_plain(q, k, v)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    # The wrapper on CPU tensors is the plain version, launching nothing.
    launches = flash_attention_fwd_offset.launches
    o2, lse2 = flash_attention_fwd_offset(q, k, v, zero)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
    assert flash_attention_fwd_offset.launches == launches


def test_offset_plain_rows_are_the_whole_prompt_rows():
    """A chunk of rows 24 .. 35 at start 24 over keys that hold stale data
    past the chunk gives the whole-prompt rows 24 .. 35 (to fp32 summation
    order: the softmax runs over a wider row)."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 36, D)).astype(np.float32))
               for _ in range(3))
    o_ref, lse_ref = flash_attention_plain(q, k, v)
    stale = torch.from_numpy(rng.standard_normal((1, 2, 20, D)).astype(np.float32))
    kk, vv = torch.cat([k, stale], 2), torch.cat([v, stale], 2)
    o, lse = flash_attention_offset_plain(q[:, :, 24:], kk, vv, torch.tensor([24], dtype=torch.int32))
    torch.testing.assert_close(o, o_ref[:, :, 24:], rtol=0, atol=TOL)
    torch.testing.assert_close(lse, lse_ref[:, :, 24:], rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def models(tiny_config):
    jax_params = jax_gpt2.init_params(tiny_config, seed=0)
    cfg = GPT2Config(vocab_size=tiny_config.vocab_size, n_positions=tiny_config.n_positions,
                     n_embd=tiny_config.n_embd, n_layer=tiny_config.n_layer,
                     n_head=tiny_config.n_head)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))
    return jax_params, cfg, params


def test_chunk_prefill_matches_the_jax_chunk_program(models, tiny_config, monkeypatch):
    """R = 3 rows: a chunk at block-aligned start 8, a pad row (clen 0) and
    a final chunk at 59 whose width runs past n_positions = 64. The pools
    after the call and the fp32 logits at each row's last position agree
    with the JAX program to 1e-5, their argmax tokens are equal, and
    nothing but the valid positions was written."""
    jax_params, cfg, params = models
    rng = np.random.default_rng(3)
    layers, h, d = cfg.n_layer, cfg.n_head, cfg.head_dim
    k_pool, v_pool = (rng.standard_normal((layers, N, h, BS, d)).astype(np.float32)
                      for _ in range(2))
    c = 8
    bt = _table(rng, 3)
    bt[1] = 0                                    # the pad row's table
    chunk = rng.integers(0, cfg.vocab_size, (3, c)).astype(np.int32)
    start = np.array([8, 0, 59], np.int32)
    clen = np.array([5, 0, 5], np.int32)
    chunk[np.arange(c)[None] >= clen[:, None]] = 0

    # The JAX program samples inside; its logits are read through a debug
    # callback keyed by each row's sampling key.
    seen = {}

    def capture(logits, key, temperature, top_k):
        jax.debug.callback(lambda lg, k: seen.__setitem__(np.asarray(k).tobytes(),
                                                         np.asarray(lg)), logits, key)
        return jnp.argmax(logits, axis=-1)

    monkeypatch.setattr(jax_engine, "sample_token", capture)
    keys = np.stack([np.asarray(jax.random.PRNGKey(i), np.uint32) for i in range(3)])
    prog = jax.jit(functools.partial(jax_engine._chunk_prefill_impl, config=tiny_config,
                                     temperature=0.0, top_k=None))
    first, _, kps, vps = prog(jax_params, jnp.asarray(k_pool), jnp.asarray(v_pool),
                              jnp.asarray(bt), jnp.asarray(chunk), jnp.asarray(start),
                              jnp.asarray(clen), jnp.asarray(keys))
    jax.block_until_ready(first)
    want_logits = np.stack([seen[np.asarray(jax.random.split(jnp.asarray(kk))[1]).tobytes()][0]
                            for kk in keys])

    w = gpt2.compute_weights(params, torch.float32, torch.device("cpu"))
    kp, vp = torch.from_numpy(k_pool.copy()), torch.from_numpy(v_pool.copy())
    logits = chunk_prefill(w, cfg, kp, vp, bt, chunk, start, clen)
    assert logits.dtype == torch.float32 and logits.shape == (3, cfg.vocab_size)
    for r in (0, 2):   # a pad row's logits are not read
        np.testing.assert_allclose(logits[r].numpy(), want_logits[r], rtol=0, atol=TOL)
        assert int(logits[r].argmax()) == int(first[r])
    np.testing.assert_allclose(kp.numpy(), np.asarray(kps), rtol=0, atol=TOL)
    np.testing.assert_allclose(vp.numpy(), np.asarray(vps), rtol=0, atol=TOL)

    written = np.zeros((N, BS), bool)
    for r in range(3):
        for i in range(clen[r]):
            p = start[r] + i
            written[bt[r, p // BS], p % BS] = True
    assert written.sum() == clen.sum()
    untouched = torch.from_numpy(~written)[None, :, None, :, None].expand(kp.shape)
    assert torch.equal(kp[untouched], torch.from_numpy(k_pool)[untouched])
    assert torch.equal(vp[untouched], torch.from_numpy(v_pool)[untouched])
    assert not torch.equal(kp[~untouched], torch.from_numpy(k_pool)[~untouched])


def test_chunk_prefill_refuses_a_valid_position_in_the_null_block(models):
    _, cfg, params = models
    w = gpt2.compute_weights(params, torch.float32, torch.device("cpu"))
    pool = torch.zeros(cfg.n_layer, N, cfg.n_head, BS, cfg.head_dim)
    bt = np.zeros((1, M), np.int32)
    with pytest.raises(ValueError, match="null block"):
        chunk_prefill(w, cfg, pool, pool.clone(), bt, np.ones((1, 4), np.int64),
                      np.zeros(1), np.array([4]))
