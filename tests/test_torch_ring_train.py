"""Sequence-parallel training of the port (``--mesh sp=S``) on the CPU: a
2-process gloo sp=2 train step against the port's local step and against
the JAX package's ``make_train_step`` on ``MeshSpec(data=1, fsdp=1,
sp=2)``; the params bit-identical across ranks; the training CLI under
``torch.distributed.run``; and the refusals of this slice.

Tiny config (vocab 257, 2 layers, C 32, T 64), fp32, 3 guarded AdamW steps
of 2 micro-batches at lr 1e-3, weights carried across with
``models/convert.py``. Tolerance 5e-5, the JAX ring train test's own
(``tests/test_ring_attention.py``): the sp run sums the same terms as the
local run in another order (the ring's block combine, a loss split over
two ranks, the gradient all-reduce), ~1e-6 on a loss of ~5.5; AdamW turns
a last-bit grad difference into at most ~lr x its relative error on a
param. The dropout-0.1 run is held to the same bound against the port's
local run: the masks are the same bits (global coordinates), only the
order of the sums differs.
"""

from __future__ import annotations

import copy
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_2_distributed_tpu.models import gpt2 as jax_gpt2
from gpt_2_distributed_tpu.parallel import mesh as jax_mesh
from gpt_2_distributed_tpu.parallel import train_step as jax_ts
from gpt_2_distributed_tpu.parallel.sharding import shard_batch, shard_params_and_opt_state
from gpt_2_distributed_torch import train
from gpt_2_distributed_torch.config import GPT2Config
from gpt_2_distributed_torch.models import gpt2
from gpt_2_distributed_torch.models.convert import params_from_jax
from gpt_2_distributed_torch.parallel import train_step as ts
from gpt_2_distributed_torch.parallel.mesh import (
    Mesh,
    MeshSpec,
    activate_mesh,
    validate_mesh_for_config,
)
from gpt_2_distributed_torch.resilience import init_guard_state
from test_torch_ring import REPO, join, spawn_gloo

TOL = 5e-5
STEPS, LR = 3, 1e-3
CASES = (("det", 0.0), ("drop", 0.1))

# One rank of a gloo sp group: the job's params and batches, 3 guarded
# steps on its [accum, B, T/sp] blocks under the active mesh, per case;
# writes losses, grad norms and the params after the steps.
_TRAIN_WORKER = r"""
import copy
import sys
import torch
import torch.distributed as dist
from gpt_2_distributed_torch.config import GPT2Config
from gpt_2_distributed_torch.parallel import train_step as ts
from gpt_2_distributed_torch.parallel.mesh import Mesh, MeshSpec, activate_mesh
from gpt_2_distributed_torch.resilience import init_guard_state

rank, world, store, job, out = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world)
job = torch.load(job)
tl = job["x"].shape[-1] // world
blk = slice(rank * tl, (rank + 1) * tl)
res = {}
with activate_mesh(Mesh(MeshSpec(sp=world), rank)):
    for tag, rate in job["cases"]:
        cfg = GPT2Config(**job["config"]).replace(embd_dropout=rate, attn_dropout=rate,
                                                  resid_dropout=rate)
        params = ts.trainable_params(copy.deepcopy(job["params"]), torch.device("cpu"))
        step = ts.make_train_step(cfg, ts.make_optimizer(params, job["lr"]),
                                  compute_dtype=torch.float32, guard=True)
        guard, metrics = init_guard_state(), []
        for i in range(job["steps"]):
            guard, m = step(params, guard, job["x"][i][..., blk], job["y"][i][..., blk], 0, i,
                            torch.ones(job["x"].shape[1]))
            metrics.append((m.loss.item(), m.grad_norm.item(), m.skip_reason))
        res[tag] = (metrics, [p.detach().clone() for p in ts.param_list(params)])
torch.save(res, f"{out}-{rank}.pt")
dist.destroy_process_group()
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config_kwargs(jax_config) -> dict:
    return dict(vocab_size=jax_config.vocab_size, n_positions=jax_config.n_positions,
                n_embd=jax_config.n_embd, n_layer=jax_config.n_layer,
                n_head=jax_config.n_head)


@pytest.fixture(scope="module")
def job(tiny_config):
    """Params (JAX init, carried across) and one [2, 8, 64] batch for each
    of the 3 steps (the same batch, as the JAX ring train test feeds it);
    the first 3 labels of every row ignored, so rank 0 holds fewer valid
    labels than rank 1 and the loss must be the global token mean."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 257, (2, 8, 64), dtype=np.int32)
    y = rng.integers(0, 257, (2, 8, 64), dtype=np.int32)
    y[..., :3] = -100
    x, y = np.stack([x] * STEPS), np.stack([y] * STEPS)
    jax_params = jax_gpt2.init_params(tiny_config, seed=0)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))
    return dict(jax_params=jax_params, params=params, x=x, y=y,
                config=_config_kwargs(tiny_config))


def _local_run(job, rate):
    cfg = GPT2Config(**job["config"]).replace(embd_dropout=rate, attn_dropout=rate,
                                              resid_dropout=rate)
    params = ts.trainable_params(copy.deepcopy(job["params"]), torch.device("cpu"))
    step = ts.make_train_step(cfg, ts.make_optimizer(params, LR), compute_dtype=torch.float32,
                              guard=True)
    guard, metrics = init_guard_state(), []
    for i in range(STEPS):
        guard, m = step(params, guard, torch.from_numpy(job["x"][i]),
                        torch.from_numpy(job["y"][i]), 0, i, torch.ones(2))
        metrics.append((m.loss.item(), m.grad_norm.item(), m.skip_reason))
    return metrics, [p.detach() for p in ts.param_list(params)]


@pytest.fixture(scope="module")
def sp_runs(job, tmp_path_factory):
    """The gloo sp=2 runs: ``{case: [(metrics, params) of rank 0, of rank 1]}``."""
    tmp = tmp_path_factory.mktemp("ring_train")
    torch.save(dict(params=job["params"], x=torch.from_numpy(job["x"]),
                    y=torch.from_numpy(job["y"]), config=job["config"], cases=CASES,
                    lr=LR, steps=STEPS), tmp / "job.pt")
    join(spawn_gloo(2, _TRAIN_WORKER, tmp, str(tmp / "job.pt"), str(tmp / "out")))
    ranks = [torch.load(tmp / f"out-{r}.pt") for r in range(2)]
    return {tag: [r[tag] for r in ranks] for tag, _ in CASES}


def _jax_sp_losses(tiny_config, job, spec):
    params = job["jax_params"]
    opt = jax_ts.make_optimizer(LR)
    mesh = jax_mesh.create_mesh(spec)
    losses = []
    with jax_mesh.activate_mesh(mesh):
        params, opt_state, _, _ = shard_params_and_opt_state(params, opt, mesh)
        step = jax_ts.make_train_step(tiny_config, opt, compute_dtype=jnp.float32,
                                      donate=False)
        for i in range(STEPS):
            xb, yb = shard_batch((job["x"][i], job["y"][i]), mesh)
            params, opt_state, m = step(params, opt_state, xb, yb, jax.random.PRNGKey(0), i)
            losses.append((float(m.loss), float(m.grad_norm)))
    return losses


def test_sp2_step_matches_the_local_step_and_jax_sp2(tiny_config, job, sp_runs):
    (metrics, params), _ = sp_runs["det"]
    local_metrics, local_params = _local_run(job, 0.0)
    assert all(m[2] == 0 for m in metrics)
    assert metrics[-1][0] < metrics[0][0], "loss did not descend"
    got = np.array([m[:2] for m in metrics])
    np.testing.assert_allclose(got, np.array([m[:2] for m in local_metrics]), atol=TOL, rtol=0)
    want = _jax_sp_losses(tiny_config, job, jax_mesh.MeshSpec(data=1, fsdp=1, sp=2))
    np.testing.assert_allclose(got, np.array(want), atol=TOL, rtol=0)
    for p, q in zip(params, local_params):
        np.testing.assert_allclose(p.numpy(), q.numpy(), atol=TOL, rtol=0)


def test_sp2_dropout_step_matches_the_local_step(job, sp_runs):
    (metrics, params), _ = sp_runs["drop"]
    local_metrics, local_params = _local_run(job, 0.1)
    np.testing.assert_allclose(np.array([m[:2] for m in metrics]),
                               np.array([m[:2] for m in local_metrics]), atol=TOL, rtol=0)
    for p, q in zip(params, local_params):
        np.testing.assert_allclose(p.numpy(), q.numpy(), atol=TOL, rtol=0)
    # Dropout is on: the losses differ from the dropout-0 run's.
    assert abs(metrics[0][0] - sp_runs["det"][0][0][0][0]) > 1e-4


@pytest.mark.parametrize("tag", [tag for tag, _ in CASES])
def test_params_are_bit_identical_across_ranks(sp_runs, tag):
    (m0, p0), (m1, p1) = sp_runs[tag]
    assert m0 == m1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_cli_sp2_under_torchrun_descends(shard_dir):
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "gpt_2_distributed_torch.train", "--device", "cpu", "--mesh", "sp=2",
         "--data_dir", shard_dir, "--n_layer", "2", "--n_embd", "32", "--n_head", "2",
         "--vocab_size", "257", "--seq_len", "32", "--batch", "4", "--grad_accum_steps", "2",
         "--max_steps", "4", "--lr", "3e-3", "--dropout", "0.1", "--cli_every", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "sp=2" in out.stdout
    losses = [float(v) for v in re.findall(r"\| loss: ([0-9.]+)", out.stdout)]
    assert len(losses) == 4 and losses[-1] < losses[0], out.stdout
    assert "training done: 4 optimizer steps" in out.stdout


@pytest.mark.parametrize("argv, message", [
    # The DDP/FSDP slice's meshes run; with a tp axis they stay refused.
    pytest.param(["--mesh", "data=2,tp=2"], "tensor-parallel slice",
                 id="argv0-DDP/FSDP slice"),
    pytest.param(["--mesh", "fsdp=2,sp=2,tp=2"], "tensor-parallel slice",
                 id="argv1-DDP/FSDP slice"),
    (["--mesh", "tp=2"], "tensor-parallel slice"),
    (["--mesh", "sp=2", "--fused_layers", "all"], "later slice"),
    (["--mesh", "sp=2", "--fused_matmul", "mlp"], "later slice"),
    (["--mesh", "sp=2", "--attention_impl", "flash"], "later slice"),
    (["--mesh", "sp=2", "--attention_impl", "dense"], "later slice"),
    # Remat runs under sp now (message None: a torchrun launch goes through).
    pytest.param(["--mesh", "sp=2", "--remat"], None, id="argv7-later slice"),
    (["--mesh", "pp=2"], "unknown mesh axis"),
])
def test_cli_refuses_what_this_slice_does_not_run(capsys, shard_dir, argv, message):
    if message is None:
        out = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2", "-m", "gpt_2_distributed_torch.train", "--device", "cpu",
             "--data_dir", shard_dir, "--n_layer", "2", "--n_embd", "32", "--n_head", "2",
             "--vocab_size", "257", "--seq_len", "32", "--batch", "2",
             "--grad_accum_steps", "2", "--max_steps", "2", "--dropout", "0.1", *argv],
            cwd=REPO, capture_output=True, text=True, timeout=240,
            env=dict(os.environ, OMP_NUM_THREADS="1"))
        assert out.returncode == 0, out.stdout + out.stderr
        assert "sp=2" in out.stdout and "training done: 2 optimizer steps" in out.stdout
        return
    with pytest.raises(SystemExit) as exc:
        train.main(["--data_dir", "unused", "--device", "cpu", *argv])
    assert message in capsys.readouterr().err + str(exc.value.code)


@pytest.mark.parametrize("argv, message", [
    (["--mesh", "sp=3", "--seq_len", "32"], "does not divide seq_len=32"),
    (["--mesh", "sp=2", "--seq_len", "32"], "launch it with torchrun --nproc_per_node 2"),
])
def test_cli_exits_on_a_mesh_it_cannot_run(argv, message):
    with pytest.raises(SystemExit) as exc:
        train.main(["--data_dir", "unused", "--device", "cpu", "--n_layer", "2", "--n_embd",
                    "32", "--n_head", "2", "--vocab_size", "257", *argv])
    assert message in str(exc.value.code)


@pytest.mark.parametrize("text", ["sp=2", "data=2,fsdp=4", "fsdp=2,tp=2,sp=2", ""])
def test_mesh_spec_parses_as_the_jax_package(text):
    want = jax_mesh.MeshSpec.parse(text)
    got = MeshSpec.parse(text)
    assert got.to_str() == want.to_str() and got.n_devices == want.n_devices


def test_mesh_validation_and_refusals(tiny_config):
    cfg = GPT2Config(**_config_kwargs(tiny_config))
    validate_mesh_for_config(MeshSpec(sp=2), cfg, "tiny", 64)
    with pytest.raises(ValueError, match="does not divide seq_len"):
        validate_mesh_for_config(MeshSpec(sp=3), cfg, "tiny", 64)
    with pytest.raises(ValueError, match="tensor-parallel slice"):
        Mesh(MeshSpec(tp=2), 0)
    params = gpt2.init_params(cfg)
    x = torch.zeros(1, 32, dtype=torch.long)
    with activate_mesh(Mesh(MeshSpec(sp=2), 0)):
        with pytest.raises(ValueError, match="later slice"):
            gpt2.forward(params, cfg.replace(fused_layers="all"), x, x)
        with pytest.raises(ValueError, match="exceeds n_positions"):
            gpt2.forward(params, cfg, torch.zeros(1, 40, dtype=torch.long))
