"""The port's training path against the JAX package on the CPU: the model's
loss and every parameter's grad (unfused and with each ``fused_layers``
setting), three guarded AdamW steps with grad accumulation and a warmup +
cosine schedule, the non-finite guard, dropout determinism, and the
training CLI. fp32, tiny config, weights carried across with
``models/convert.py``."""

from __future__ import annotations

import argparse
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_2_distributed_tpu import train as jax_train
from gpt_2_distributed_tpu.models import gpt2 as jax_gpt2
from gpt_2_distributed_tpu.parallel import train_step as jax_ts
from gpt_2_distributed_tpu.resilience import init_guard_state as jax_guard_state
from gpt_2_distributed_torch import train
from gpt_2_distributed_torch.config import GPT2Config
from gpt_2_distributed_torch.models import gpt2
from gpt_2_distributed_torch.models.convert import params_from_jax
from gpt_2_distributed_torch.parallel import train_step as ts
from gpt_2_distributed_torch.resilience import SKIP_NONFINITE_LOSS, init_guard_state


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_config(jax_config, **kw) -> GPT2Config:
    return GPT2Config(
        vocab_size=jax_config.vocab_size, n_positions=jax_config.n_positions,
        n_embd=jax_config.n_embd, n_layer=jax_config.n_layer,
        n_head=jax_config.n_head, embd_dropout=jax_config.embd_dropout,
        attn_dropout=jax_config.attn_dropout,
        resid_dropout=jax_config.resid_dropout, **kw,
    )


@pytest.fixture(scope="module")
def jax_params(tiny_config):
    return jax_gpt2.init_params(tiny_config, seed=0)


def trainable(jax_params) -> dict:
    return ts.trainable_params(params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params)),
                               torch.device("cpu"))


def grads_as_jax_tree(params: dict, n_head: int) -> dict:
    from gpt_2_distributed_torch.models.convert import params_to_jax

    g = {k: v if k == "blocks" else v.grad for k, v in params.items()}
    g["blocks"] = [{k: v.grad for k, v in bp.items()} for bp in params["blocks"]]
    return params_to_jax(g, n_head)


def _assert_tree_close(got: dict, want, atol, what):
    want = jax.tree_util.tree_map(np.asarray, want)
    for key in ("wte", "wpe", "ln_f_scale", "ln_f_bias"):
        np.testing.assert_allclose(got[key], want[key], atol=atol, rtol=0,
                                   err_msg=f"{what} {key}")
    for key in gpt2.BLOCK_KEYS:
        np.testing.assert_allclose(got["block"][key], want["block"][key], atol=atol,
                                   rtol=0, err_msg=f"{what} block/{key}")


def _batch(rng, vocab, *shape):
    x = rng.integers(0, vocab, size=shape).astype(np.int32)
    y = rng.integers(0, vocab, size=shape).astype(np.int32)
    y[..., 0] = -100
    return x, y


# fp32 on both sides: the model's sums run in another order (dense
# attention and its autograd here, XLA's fusions there), ~1e-6 on a loss of
# ~5.5 and on grads of order 1e-2..1.
MODEL_TOL = 1e-5


@pytest.mark.parametrize("loss_impl", ["blocked", "dense"])
def test_model_loss_and_every_grad_match_jax(jax_params, tiny_config, loss_impl):
    jcfg = tiny_config.replace(loss_impl=loss_impl, loss_block_rows=24)
    x, y = _batch(np.random.default_rng(1), jcfg.vocab_size, 2, 20)
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jax_gpt2.forward(p, jcfg, jnp.asarray(x), jnp.asarray(y),
                                   compute_dtype=jnp.float32)[1])(jax_params)
    params = trainable(jax_params)
    cfg = port_config(jcfg, loss_impl=loss_impl, loss_block_rows=24)
    _, loss = gpt2.forward(params, cfg, torch.from_numpy(x), torch.from_numpy(y),
                           compute_dtype=torch.float32)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), atol=MODEL_TOL, rtol=0)
    _assert_tree_close(grads_as_jax_tree(params, cfg.n_head), grads_j, MODEL_TOL, "grad")


@pytest.mark.parametrize("fused_layers", ["ln", "gelu", "all"])
def test_fused_model_loss_and_every_grad_match_jax(jax_params, tiny_config, fused_layers):
    """``fused_layers`` at dropout 0: the port's fused epilogues (their plain
    versions here) against the JAX model with the same setting (its Pallas
    kernels in interpret mode), to the bound tests/test_fused_layer.py holds
    JAX fused against unfused."""
    jcfg = tiny_config.replace(fused_layers=fused_layers)
    x, y = _batch(np.random.default_rng(4), jcfg.vocab_size, 2, 20)
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jax_gpt2.forward(p, jcfg, jnp.asarray(x), jnp.asarray(y),
                                   compute_dtype=jnp.float32)[1])(jax_params)
    params = trainable(jax_params)
    cfg = port_config(jcfg, fused_layers=fused_layers)
    _, loss = gpt2.forward(params, cfg, torch.from_numpy(x), torch.from_numpy(y),
                           compute_dtype=torch.float32)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), atol=MODEL_TOL, rtol=0)
    _assert_tree_close(grads_as_jax_tree(params, cfg.n_head), grads_j, MODEL_TOL, "grad")


@pytest.mark.parametrize("fused_matmul, fused_layers", [
    ("mlp", "off"), ("proj", "off"), ("all", "off"), ("all", "all")])
def test_fused_matmul_model_loss_and_every_grad_match_jax(jax_params, tiny_config,
                                                         fused_matmul, fused_layers):
    """``fused_matmul`` at dropout 0, alone and over ``fused_layers="all"``
    (where K7 takes the legs K4-K6 would): the port's K7 legs (their plain
    versions here) against the JAX model with the same flags (its Pallas
    kernels in interpret mode), to the bound tests/test_fused_matmul.py
    holds JAX fused against unfused."""
    jcfg = tiny_config.replace(fused_matmul=fused_matmul, fused_layers=fused_layers)
    x, y = _batch(np.random.default_rng(6), jcfg.vocab_size, 2, 20)
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jax_gpt2.forward(p, jcfg, jnp.asarray(x), jnp.asarray(y),
                                   compute_dtype=jnp.float32)[1])(jax_params)
    params = trainable(jax_params)
    cfg = port_config(jcfg, fused_matmul=fused_matmul, fused_layers=fused_layers)
    _, loss = gpt2.forward(params, cfg, torch.from_numpy(x), torch.from_numpy(y),
                           compute_dtype=torch.float32)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), atol=MODEL_TOL, rtol=0)
    _assert_tree_close(grads_as_jax_tree(params, cfg.n_head), grads_j, MODEL_TOL, "grad")


def test_fused_dropout_is_deterministic_per_seed_and_step(tiny_config):
    """``fused_layers="all"`` at dropout 0.1: the same seed and step give the
    same loss bit for bit; another step or seed draws other masks."""
    cfg = port_config(tiny_config, fused_layers="all").replace(
        embd_dropout=0.1, attn_dropout=0.1, resid_dropout=0.1)
    params = gpt2.init_params(cfg, seed=1)
    x, y = map(torch.from_numpy, _batch(np.random.default_rng(3), cfg.vocab_size, 2, 16))

    def loss(seed, step):
        return gpt2.forward(params, cfg, x, y, rng=(seed, step, 0), deterministic=False,
                            compute_dtype=torch.float32)[1].item()

    assert loss(7, 3) == loss(7, 3)
    assert loss(7, 4) != loss(7, 3) and loss(8, 3) != loss(7, 3)


def _schedule_args(lr=1e-3):
    return argparse.Namespace(lr=lr, lr_schedule="cosine", warmup_steps=1,
                              max_steps=3, epochs=1)


def test_three_guarded_adamw_steps_match_jax(jax_params, tiny_config):
    """Losses, grad norms and params after 3 guarded steps, grad_accum 2,
    warmup + cosine. AdamW divides by sqrt(v): a grad's last-bit difference
    moves the update of a near-zero-grad element by up to ~lr x its relative
    error, so params are held to 1e-5 at lr 1e-3."""
    accum, b, t = 2, 2, 16
    rng = np.random.default_rng(5)
    batches = [_batch(rng, tiny_config.vocab_size, accum, b, t) for _ in range(3)]

    schedule_j = jax_train.make_lr_schedule(_schedule_args(), steps_per_epoch=3)
    step_j = jax_ts.make_train_step(tiny_config, jax_ts.make_optimizer(schedule_j),
                                    compute_dtype=jnp.float32, donate=False, guard=True)
    p_j = jax_params
    opt_j = jax_ts.make_optimizer(schedule_j).init(p_j)
    guard_j = jax_guard_state()
    want = []
    for i, (x, y) in enumerate(batches):
        p_j, opt_j, guard_j, m = step_j(p_j, opt_j, guard_j, jnp.asarray(x), jnp.asarray(y),
                                        jax.random.PRNGKey(0), i, jnp.ones(accum))
        want.append((float(m.loss), float(m.grad_norm)))

    params = trainable(jax_params)
    cfg = port_config(tiny_config)
    schedule = train.make_lr_schedule(_schedule_args(), steps_per_epoch=3)
    assert [schedule(c) for c in range(4)] == pytest.approx(
        [float(schedule_j(c)) for c in range(4)], rel=1e-6)
    opt = ts.make_optimizer(params, schedule)
    step = ts.make_train_step(cfg, opt, compute_dtype=torch.float32, guard=True)
    guard = init_guard_state()
    for i, (x, y) in enumerate(batches):
        guard, m = step(params, guard, torch.from_numpy(x), torch.from_numpy(y), 0, i,
                        torch.ones(accum))
        assert m.skip_reason == 0
        np.testing.assert_allclose([m.loss.item(), m.grad_norm.item()], want[i],
                                   atol=1e-5, rtol=0, err_msg=f"step {i}")
    assert opt.count == 3 and guard.skipped_steps == 0
    from gpt_2_distributed_torch.models.convert import params_to_jax

    _assert_tree_close(params_to_jax(params, cfg.n_head), p_j, 1e-5, "param")


def test_nan_step_is_skipped_bit_unchanged_without_advancing_the_schedule(
        jax_params, tiny_config):
    params = trainable(jax_params)
    cfg = port_config(tiny_config)
    schedule = train.make_lr_schedule(_schedule_args(), steps_per_epoch=3)
    opt = ts.make_optimizer(params, schedule)
    step = ts.make_train_step(cfg, opt, compute_dtype=torch.float32, guard=True)
    rng = np.random.default_rng(9)
    x, y = map(torch.from_numpy, _batch(rng, cfg.vocab_size, 2, 2, 16))
    guard, _ = step(params, init_guard_state(), x, y, 0, 0, torch.ones(2))
    before = [p.detach().clone() for p in ts.param_list(params)]
    opt_before = copy.deepcopy(opt.state_dict())
    poisoned = torch.tensor([float("nan"), 1.0])
    guard, m = step(params, guard, x, y, 0, 1, poisoned)
    assert (m.skip_reason, m.skipped_steps, guard.skipped_steps) == (SKIP_NONFINITE_LOSS, 1, 1)
    assert guard.last_skip_reason == SKIP_NONFINITE_LOSS
    assert all(torch.equal(a, p) for a, p in zip(before, ts.param_list(params)))
    # AdamW's state (step, moments) bit-unchanged, and the schedule's count.
    after = opt.state_dict()
    for i, s in opt_before["state"].items():
        assert all(torch.equal(s[k], after["state"][i][k]) for k in s), i
    assert opt.count == 1
    # The next applied update takes schedule(1), the count's next value.
    assert opt.current_lr() == schedule(1)


def test_dropout_is_deterministic_per_seed_and_step(tiny_config):
    cfg = port_config(tiny_config).replace(embd_dropout=0.1, attn_dropout=0.1,
                                          resid_dropout=0.1)
    params = gpt2.init_params(cfg, seed=1)
    x, y = map(torch.from_numpy, _batch(np.random.default_rng(2), cfg.vocab_size, 2, 16))

    def loss(seed, step):
        return gpt2.forward(params, cfg, x, y, rng=(seed, step, 0), deterministic=False,
                            compute_dtype=torch.float32)[1].item()

    assert loss(7, 3) == loss(7, 3)
    assert loss(7, 4) != loss(7, 3) and loss(8, 3) != loss(7, 3)
    eval_loss = gpt2.forward(params, cfg, x, y, compute_dtype=torch.float32)[1].item()
    assert eval_loss not in (loss(7, 3), loss(7, 4))


@pytest.mark.parametrize("preset", ["124M", "1.5B"])
def test_flops_and_param_counts_match_jax(preset):
    from gpt_2_distributed_tpu.config import MODEL_PRESETS as JAX_PRESETS
    from gpt_2_distributed_tpu.utils.flops import flops_per_token as jax_flops
    from gpt_2_distributed_torch.config import MODEL_PRESETS
    from gpt_2_distributed_torch.utils import flops

    cfg, jcfg = MODEL_PRESETS[preset], JAX_PRESETS[preset]
    assert cfg.num_params() == jcfg.num_params()
    assert flops.flops_per_token(cfg, 1024) == jax_flops(jcfg, 1024)
    # No card, no peak: MFU is not reported rather than taken against a
    # TPU's or a guessed peak.
    assert flops.device_peak_flops(torch.device("cpu")) is None
    assert flops.mfu(1e5, cfg, 1024, None) is None


TINY = ["--n_layer", "2", "--n_embd", "32", "--n_head", "2", "--vocab_size", "257",
        "--seq_len", "32", "--batch", "4", "--grad_accum_steps", "2", "--workers", "2"]


def test_train_cli_on_the_cpu(shard_dir, capsys):
    tracker = train.main(["--data_dir", shard_dir, *TINY, "--max_steps", "3",
                          "--cli_every", "1", "--eval_every", "3", "--eval_batches", "2",
                          "--lr", "3e-3", "--lr_schedule", "cosine", "--warmup_steps",
                          "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "training done: 3 optimizer steps" in out
    assert [line.split(" | ")[0] for line in out.splitlines()
            if line.startswith("step ")] == [f"step {i:>7d}" for i in (1, 2, 3)]
    losses = list(tracker.buffers["loss"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert np.isfinite(tracker.buffers["eval_loss"][-1])


def test_train_cli_with_fused_matmul_on_the_cpu(shard_dir, capsys):
    """``--fused_matmul all`` over ``--fused_layers all`` with dropout: two
    steps through K7's plain versions (n_embd 32: the port needs no tile
    multiple)."""
    tracker = train.main(["--data_dir", shard_dir, *TINY, "--max_steps", "2",
                          "--cli_every", "1", "--dropout", "0.1", "--fused_matmul", "all",
                          "--fused_layers", "all", "--device", "cpu"])
    assert "training done: 2 optimizer steps" in capsys.readouterr().out
    losses = list(tracker.buffers["loss"])
    assert len(losses) == 2 and all(np.isfinite(losses))


@pytest.mark.parametrize("flags, message", [
    ([], "no CUDA device"),
    # The bf16 gradient carry and remat run now (message None: the run
    # goes through).
    pytest.param(["--accum_dtype", "bf16", "--device", "cpu"], None, id="flags1-later slice"),
    # The multi-host flags run now; a process id outside the count is refused.
    pytest.param(["--coordinator_address", "localhost:1234", "--num_processes", "2",
                  "--process_id", "2", "--device", "cpu"],
                 "--process_id 2 is outside the 2 processes", id="flags2-later slice"),
    pytest.param(["--remat", "block", "--device", "cpu"], None, id="flags3-later slice"),
    (["--inject_hang_at", "2", "--device", "cpu"], "requires --hang_timeout_s > 0"),
    (["--inject_desync_at", "2", "--device", "cpu"], "requires --desync_check_every > 0"),
])
def test_train_cli_refusals(shard_dir, capsys, flags, message):
    if not flags and torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    argv = ["--data_dir", shard_dir, *TINY, "--max_steps", "1", *flags]
    if message is None:
        tracker = train.main(argv)
        assert "training done: 1 optimizer steps" in capsys.readouterr().out
        assert np.isfinite(tracker.buffers["loss"][-1])
        return
    with pytest.raises(SystemExit) as exc:
        train.main(argv)
    assert message in str(exc.value.code) + capsys.readouterr().err
