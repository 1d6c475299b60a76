"""The bf16 gradient carry (``make_train_step(..., accum_dtype=
torch.bfloat16)``, ``--accum_dtype bf16``) on the CPU: the carry is the
running bf16 sum of the micro-batches' fp32 grads bit for bit, ten steps
track the fp32 carry and the JAX package's ``accum_dtype=bf16`` run within
the JAX test's bound and descend, a guard-skipped step changes nothing,
and the CLI runs it."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_2_distributed_tpu.models import gpt2 as jax_gpt2
from gpt_2_distributed_tpu.parallel import train_step as jax_ts
from gpt_2_distributed_torch import train
from gpt_2_distributed_torch.models import gpt2
from gpt_2_distributed_torch.parallel import train_step as ts
from gpt_2_distributed_torch.resilience import init_guard_state
from test_torch_train import TINY, port_config, trainable

ACCUM_TOL = 5e-2   # tests/test_train_step.py::test_bf16_accum_tracks_fp32_accum
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params(tiny_config):
    return jax_gpt2.init_params(tiny_config, seed=0)


def _learnable_batch(vocab, accum=4, b=4, t=32, seed=0):
    """y a fixed function of x (the JAX test's ``_fake_batch``), so the
    loss can fall well below ln(vocab)."""
    x = np.random.default_rng(seed).integers(0, vocab, (accum, b, t)).astype(np.int32)
    return x, (x + 1) % vocab


def test_bf16_carry_is_the_running_bf16_sum(jax_params, tiny_config):
    """Dropout 0.1, 4 micro-batches: each param's grad after the
    accumulation equals ``((0 + g_0) + g_1) + ...`` summed in bf16, each
    g_i the fp32 grad of micro-batch i's loss / 4, then upcast."""
    rate = 0.1
    cfg = port_config(tiny_config).replace(embd_dropout=rate, attn_dropout=rate,
                                           resid_dropout=rate)
    x, y = (torch.from_numpy(a).long() for a in _learnable_batch(cfg.vocab_size))
    params = trainable(jax_params)
    ts._accumulate_grads(cfg, torch.float32, params, x, y, 3, 5, accum_dtype=BF16)
    got = [p.grad.clone() for p in ts.param_list(params)]
    assert all(g.dtype == torch.float32 for g in got)

    carry = [torch.zeros_like(p, dtype=BF16) for p in ts.param_list(params)]
    for i in range(x.shape[0]):
        _, loss = gpt2.forward(params, cfg, x[i], y[i], rng=(3, 5, i), deterministic=False,
                               compute_dtype=torch.float32)
        grads = torch.autograd.grad(loss * (1.0 / x.shape[0]), ts.param_list(params))
        carry = [c + g.to(BF16) for c, g in zip(carry, grads)]
    assert all(torch.equal(a, c.float()) for a, c in zip(got, carry))
    # The fold is a real rounding: the fp32 carry differs somewhere.
    ts._accumulate_grads(cfg, torch.float32, params, x, y, 3, 5)
    assert not all(torch.equal(a, p.grad) for a, p in zip(got, ts.param_list(params)))


def test_bf16_carry_tracks_fp32_and_jax_bf16_and_descends(jax_params, tiny_config):
    """Ten steps of 4 micro-batches at lr 3e-3 (the JAX test's setting):
    the bf16 run's losses within rtol/atol 5e-2 of the port's fp32 run and
    of the JAX ``accum_dtype=bf16`` run on the same weights, and falling."""
    x, y = _learnable_batch(tiny_config.vocab_size)
    opt_j = jax_ts.make_optimizer(3e-3)
    step_j = jax_ts.make_train_step(tiny_config, opt_j, compute_dtype=jnp.float32,
                                    donate=False, accum_dtype=jnp.bfloat16)
    p_j, s_j, jax_bf16 = jax_params, opt_j.init(jax_params), []
    for i in range(10):
        p_j, s_j, m = step_j(p_j, s_j, jnp.asarray(x), jnp.asarray(y),
                             jax.random.PRNGKey(0), i)
        jax_bf16.append(float(m.loss))

    def run(accum_dtype):
        params = trainable(jax_params)
        step = ts.make_train_step(port_config(tiny_config),
                                  ts.make_optimizer(params, 3e-3),
                                  compute_dtype=torch.float32, accum_dtype=accum_dtype)
        losses = []
        for i in range(10):
            m = step(params, torch.from_numpy(x).long(), torch.from_numpy(y).long(), 0, i)
            losses.append(m.loss.item())
        assert all(p.dtype == torch.float32 for p in ts.param_list(params))
        return losses

    fp32, bf16 = run(None), run(BF16)
    np.testing.assert_allclose(bf16, fp32, rtol=ACCUM_TOL, atol=ACCUM_TOL)
    np.testing.assert_allclose(bf16, jax_bf16, rtol=ACCUM_TOL, atol=ACCUM_TOL)
    assert bf16[-1] < bf16[0] - 0.5
    assert bf16 != fp32


def test_guard_skipped_bf16_step_changes_nothing(jax_params, tiny_config):
    x, y = (torch.from_numpy(a).long() for a in _learnable_batch(tiny_config.vocab_size, 2))
    params = trainable(jax_params)
    opt = ts.make_optimizer(params, 1e-3)
    step = ts.make_train_step(port_config(tiny_config), opt, compute_dtype=torch.float32,
                              guard=True, accum_dtype=BF16)
    guard, m = step(params, init_guard_state(), x, y, 0, 0, torch.ones(2))
    assert m.skip_reason == 0
    before = [p.detach().clone() for p in ts.param_list(params)]
    moments = [t.clone() for s in opt.state.values() for t in (s["exp_avg"], s["exp_avg_sq"])]
    nan = torch.ones(2)
    nan[1] = float("nan")
    guard, m = step(params, guard, x, y, 0, 1, nan)
    assert m.skip_reason != 0 and guard.skipped_steps == 1 and opt.count == 1
    assert all(torch.equal(a, b) for a, b in zip(before, ts.param_list(params)))
    after = [t for s in opt.state.values() for t in (s["exp_avg"], s["exp_avg_sq"])]
    assert all(torch.equal(a, b) for a, b in zip(moments, after))


def test_bf16_carry_leaves_no_hooks_behind(jax_params, tiny_config):
    """The fold's hooks live for one accumulation: a plain backward after
    it accumulates into ``.grad`` as usual."""
    x, y = (torch.from_numpy(a).long() for a in _learnable_batch(tiny_config.vocab_size, 2))
    params = trainable(jax_params)
    cfg = port_config(tiny_config)
    ts._accumulate_grads(cfg, torch.float32, params, x, y, 0, 0, accum_dtype=BF16)
    for p in ts.param_list(params):
        p.grad = None
    _, loss = gpt2.forward(params, cfg, x[0], y[0], compute_dtype=torch.float32)
    loss.backward()
    assert all(p.grad is not None for p in ts.param_list(params))


def test_train_cli_with_bf16_accum_on_the_cpu(shard_dir, capsys):
    tracker = train.main(["--data_dir", shard_dir, *TINY, "--max_steps", "2",
                          "--cli_every", "1", "--accum_dtype", "bf16", "--device", "cpu"])
    assert "training done: 2 optimizer steps" in capsys.readouterr().out
    losses = list(tracker.buffers["loss"])
    assert len(losses) == 2 and all(np.isfinite(losses))
