"""Data-parallel and fully-sharded training of the port (``--training_mode
dp|ddp|fsdp``, ``--mesh data=D,fsdp=F[,sp=S]``, ``--shard_update``) on the
CPU, in gloo groups of 2 and 4 processes over a ``FileStore`` (one launch
per mesh, every case of that mesh in it):

* at dropout 0 the data=2, fsdp=2, data=2 x fsdp=2 and data=2 x sp=2 runs
  match the port's local run and the JAX package's ``make_train_step`` on
  the same ``MeshSpec`` (the JAX ``test_mode_equivalence``);
* every rank ends every step with bit-identical params;
* ``--shard_update on`` holds to ``off`` within the JAX sharded-update
  test's 1e-6 (lr 3e-4, its own setting), and the per-rank AdamW moments
  are the shard sizes of ``parallel/sharding.py`` (1/N of the replicated
  layout's, the leaves that no degree divides counted whole); so are its
  fp32 params and grads after a step under 'fsdp';
* a guard-skipped step leaves every rank's params and moments
  bit-unchanged;
* at dropout 0.1 the data=2 x sp=2 run draws the local run's masks
  (global coordinates on both sides) and matches it;
* ``torch.distributed.run ... --training_mode ddp --device cpu``.

Tiny config (vocab 257, 2 layers, C 32), fp32, 3 guarded AdamW steps of 2
micro-batches of [8, 32], weights carried across with
``models/convert.py``. Tolerance 5e-5, the ring train test's: the mesh
runs sum the same terms as the local run in another order.
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
from gpt_2_distributed_torch.config import GPT2Config
from gpt_2_distributed_torch.models.convert import params_from_jax
from gpt_2_distributed_torch.parallel import train_step as ts
from gpt_2_distributed_torch.parallel.mesh import MeshSpec
from gpt_2_distributed_torch.parallel.sharding import tensor_layouts
from gpt_2_distributed_torch.resilience import init_guard_state
from test_torch_ring import REPO, join, spawn_gloo

TOL = 5e-5
UPDATE_TOL = 1e-6   # tests/test_shard_update.py, at its lr 3e-4
STEPS, ACCUM, BATCH, SEQ, LR = 3, 2, 8, 32, 3e-4

# mesh -> cases (tag, dropout, --shard_update)
MESHES = {
    "data=2": (("off", 0.0, "off"), ("on", 0.0, "on"), ("drop", 0.1, "auto")),
    "fsdp=2": (("det", 0.0, "auto"), ("drop", 0.1, "auto")),
    "data=2,fsdp=2": (("off", 0.0, "auto"), ("on", 0.0, "on")),
    "data=2,sp=2": (("det", 0.0, "auto"), ("drop", 0.1, "auto")),
}
DET = {"data=2": "off", "fsdp=2": "det", "data=2,fsdp=2": "off", "data=2,sp=2": "det"}

# One rank of a gloo group: its rows (and T/sp block) of every micro-batch,
# the job's cases under the active mesh; each case's metrics, full params
# and AdamW moment bytes after the steps, then one step with a NaN loss,
# which the guard must skip leaving params and moments bit-unchanged.
_WORKER = r"""
import copy
import sys
import torch
import torch.distributed as dist
from gpt_2_distributed_torch.config import GPT2Config
from gpt_2_distributed_torch.ops.spmd import batch_axes, shard_offset
from gpt_2_distributed_torch.parallel import train_step as ts
from gpt_2_distributed_torch.parallel.mesh import Mesh, MeshSpec, activate_mesh
from gpt_2_distributed_torch.parallel.sharding import resolve_shard_update
from gpt_2_distributed_torch.resilience import init_guard_state

rank, world, store, job, out = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world)
job = torch.load(job)
spec = MeshSpec.parse(job["mesh"])
mesh = Mesh(spec, rank)
b, tl = job["x"].shape[2] // (spec.data * spec.fsdp), job["x"].shape[3] // spec.sp
r0, s0 = shard_offset(mesh, batch_axes(mesh, b), b), mesh.sp_index * tl
x, y = (a[:, :, r0:r0 + b, s0:s0 + tl] for a in (job["x"], job["y"]))
res = {}
with activate_mesh(mesh):
    for tag, rate, mode in job["cases"]:
        cfg = GPT2Config(**job["config"]).replace(embd_dropout=rate, attn_dropout=rate,
                                                  resid_dropout=rate)
        params = ts.trainable_params(copy.deepcopy(job["params"]), torch.device("cpu"))
        sharded = ts.ShardedUpdate.build(params, cfg, mesh, resolve_shard_update(mode, spec))
        opt = ts.make_optimizer(params, job["lr"], sharded=sharded)
        step = ts.make_train_step(cfg, opt, compute_dtype=torch.float32, guard=True,
                                  sharded=sharded)
        guard, metrics = init_guard_state(), []
        for i in range(x.shape[0]):
            guard, m = step(params, guard, x[i], y[i], 0, i, torch.ones(x.shape[1]))
            metrics.append((m.loss.item(), m.grad_norm.item(), m.skip_reason))
        state = [t.clone() for s in opt.state.values() for t in (s["exp_avg"], s["exp_avg_sq"])]
        held = ts.state_bytes(params, opt, sharded)

        def whole():
            w = params if sharded is None else sharded.full_params(params)
            return [p.detach().clone() for p in ts.param_list(w)]

        full = whole()
        nan = torch.ones(x.shape[1])
        nan[0] = float("nan")
        guard, m = step(params, guard, x[0], y[0], 0, x.shape[0], nan)
        after = [t for s in opt.state.values() for t in (s["exp_avg"], s["exp_avg_sq"])]
        res[tag] = dict(
            metrics=metrics, params=full, skip_reason=m.skip_reason,
            unchanged=all(torch.equal(a, b) for a, b in zip(full, whole()))
            and all(torch.equal(a, b) for a, b in zip(state, after)),
            moment_bytes=sum(t.nbytes for t in state), held=held)
torch.save(res, f"{out}-{rank}.pt")
dist.destroy_process_group()
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def job(tiny_config):
    """Params (JAX init, carried across) and one [2, 8, 32] batch a step;
    the first 3 labels of rows 0-3 ignored, so the ranks hold different
    counts of valid labels and the loss must be the global token mean."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 257, (STEPS, ACCUM, BATCH, SEQ), dtype=np.int32)
    y = rng.integers(0, 257, (STEPS, ACCUM, BATCH, SEQ), dtype=np.int32)
    y[:, :, :4, :3] = -100
    jax_params = jax_gpt2.init_params(tiny_config, seed=0)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))
    config = dict(vocab_size=tiny_config.vocab_size, n_positions=tiny_config.n_positions,
                  n_embd=tiny_config.n_embd, n_layer=tiny_config.n_layer,
                  n_head=tiny_config.n_head)
    return dict(jax_params=jax_params, params=params, x=x, y=y, config=config)


@pytest.fixture(scope="module")
def runs(job, tmp_path_factory):
    """Every mesh's gloo launch, all started together: ``{mesh: {tag:
    [rank 0's result, rank 1's, ...]}}``."""
    tmp = tmp_path_factory.mktemp("ddp")
    launches = {}
    for i, (mesh, cases) in enumerate(MESHES.items()):
        d = tmp / f"m{i}"
        d.mkdir()
        torch.save(dict(params=job["params"], x=torch.from_numpy(job["x"]),
                        y=torch.from_numpy(job["y"]), config=job["config"], cases=cases,
                        lr=LR, mesh=mesh), d / "job.pt")
        world = MeshSpec.parse(mesh).n_devices
        launches[mesh] = (d, world, spawn_gloo(world, _WORKER, d, str(d / "job.pt"),
                                               str(d / "out")))
    out = {}
    for mesh, (d, world, procs) in launches.items():
        join(procs)
        ranks = [torch.load(d / f"out-{r}.pt") for r in range(world)]
        out[mesh] = {tag: [r[tag] for r in ranks] for tag, _, _ in MESHES[mesh]}
    return out


def _local_run(job, rate):
    cfg = GPT2Config(**job["config"]).replace(embd_dropout=rate, attn_dropout=rate,
                                              resid_dropout=rate)
    params = ts.trainable_params(copy.deepcopy(job["params"]), torch.device("cpu"))
    opt = ts.make_optimizer(params, LR)
    step = ts.make_train_step(cfg, opt, compute_dtype=torch.float32, guard=True)
    guard, metrics = init_guard_state(), []
    for i in range(STEPS):
        guard, m = step(params, guard, torch.from_numpy(job["x"][i]),
                        torch.from_numpy(job["y"][i]), 0, i, torch.ones(ACCUM))
        metrics.append((m.loss.item(), m.grad_norm.item(), m.skip_reason))
    return metrics, [p.detach() for p in ts.param_list(params)], ts.state_bytes(params, opt)


@pytest.fixture(scope="module")
def local(job):
    return {rate: _local_run(job, rate) for rate in (0.0, 0.1)}


def _jax_losses(tiny_config, job, spec: jax_mesh.MeshSpec):
    opt = jax_ts.make_optimizer(LR)
    mesh = jax_mesh.create_mesh(spec)
    losses = []
    with jax_mesh.activate_mesh(mesh):
        params, opt_state, _, _ = shard_params_and_opt_state(job["jax_params"], opt, mesh)
        step = jax_ts.make_train_step(tiny_config, opt, compute_dtype=jnp.float32,
                                      donate=False)
        for i in range(STEPS):
            xb, yb = shard_batch((job["x"][i], job["y"][i]), mesh)
            params, opt_state, m = step(params, opt_state, xb, yb, jax.random.PRNGKey(0), i)
            losses.append((float(m.loss), float(m.grad_norm)))
    return np.array(losses)


def _close(a, b, tol=TOL):
    for p, q in zip(a, b):
        np.testing.assert_allclose(p.numpy(), q.numpy(), atol=tol, rtol=0)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mode_equivalence_with_the_local_step_and_jax(tiny_config, job, runs, local, mesh):
    res = runs[mesh][DET[mesh]][0]
    local_metrics, local_params, _ = local[0.0]
    got = np.array([m[:2] for m in res["metrics"]])
    assert all(m[2] == 0 for m in res["metrics"])
    assert got[-1, 0] < got[0, 0], "loss did not descend"
    np.testing.assert_allclose(got, np.array([m[:2] for m in local_metrics]), atol=TOL, rtol=0)
    _close(res["params"], local_params)
    s = MeshSpec.parse(mesh)
    want = _jax_losses(tiny_config, job, jax_mesh.MeshSpec(data=s.data, fsdp=s.fsdp, sp=s.sp))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("mesh, tag", [(m, t) for m, cases in MESHES.items()
                                       for t, _, _ in cases])
def test_ranks_end_every_run_bit_identical_and_skip_a_nan_step(runs, mesh, tag):
    ranks = runs[mesh][tag]
    for r in ranks:
        assert r["metrics"] == ranks[0]["metrics"]
        assert all(torch.equal(a, b) for a, b in zip(r["params"], ranks[0]["params"]))
        assert r["skip_reason"] != 0 and r["unchanged"]


@pytest.mark.parametrize("mesh", ["data=2", "data=2,fsdp=2"])
def test_shard_update_on_matches_off(runs, mesh):
    on, off = runs[mesh]["on"][0], runs[mesh]["off"][0]
    np.testing.assert_allclose(np.array([m[:2] for m in on["metrics"]]),
                               np.array([m[:2] for m in off["metrics"]]),
                               atol=UPDATE_TOL, rtol=0)
    _close(on["params"], off["params"], UPDATE_TOL)


@pytest.mark.parametrize("mesh, tag, shard_update, fraction", [
    ("data=2", "off", False, 1.0), ("data=2", "on", True, 0.5),
    ("fsdp=2", "det", False, 0.5), ("data=2,fsdp=2", "off", False, 0.5),
    ("data=2,fsdp=2", "on", True, 0.25)])
def test_optimizer_state_per_rank_is_its_shard(job, runs, local, mesh, tag, shard_update,
                                               fraction):
    """Each rank holds its shards' moments: the sizes of ``tensor_layouts``,
    within a rounding of ``fraction`` of the replicated layout's (the
    tiny config's wte [257, 32] takes no 'data' split: 257 is odd)."""
    spec = MeshSpec.parse(mesh)
    deg = {"data": spec.data, "fsdp": spec.fsdp}
    want = 0
    for lay in tensor_layouts(GPT2Config(**job["config"]), spec, shard_update):
        n = int(np.prod(lay.view))
        for axis, _ in lay.placement:
            n //= deg[axis]
        want += 2 * 4 * n
    replicated = local[0.0][2]["moments"]
    for r in runs[mesh][tag]:
        assert r["moment_bytes"] == r["held"]["moments"] == want
    assert fraction * replicated <= want < (fraction + 0.1) * replicated


@pytest.mark.parametrize("mesh, tag, shard_update, fraction", [
    ("data=2", "off", False, 1.0), ("data=2", "on", True, 1.0),
    ("fsdp=2", "det", False, 0.5), ("data=2,fsdp=2", "off", False, 0.5),
    ("data=2,fsdp=2", "on", True, 0.25)])
def test_params_and_grads_per_rank_are_their_shards(job, runs, local, mesh, tag,
                                                    shard_update, fraction):
    """After a step each rank holds, of the fp32 params and grads: under
    'fsdp' only its shards (no whole param or grad outlives a backward);
    under ``--shard_update`` alone the whole params, and its master shards
    and their grads; replicated, the whole params and grads."""
    spec = MeshSpec.parse(mesh)
    deg = {"data": spec.data, "fsdp": spec.fsdp}
    want = 0
    for lay in tensor_layouts(GPT2Config(**job["config"]), spec, shard_update):
        whole = int(np.prod(lay.view))
        n = whole
        for axis, _ in lay.placement:
            n //= deg[axis]
        fsdp = any(a == "fsdp" for a, _ in lay.placement)
        want += 4 * (2 * n if fsdp or not lay.placement else whole + 2 * n)
    held = local[0.0][2]
    replicated = held["params"] + held["grads"]
    for r in runs[mesh][tag]:
        assert r["held"]["params"] + r["held"]["grads"] == want
    assert fraction * replicated <= want < (fraction + 0.1) * replicated


def test_data_sp_dropout_run_draws_the_local_masks(runs, local):
    """Under data x sp the ring and the unfused sites hash global
    coordinates with the run's seeds, as the local run does."""
    res = runs["data=2,sp=2"]["drop"][0]
    local_metrics, local_params, _ = local[0.1]
    np.testing.assert_allclose(np.array([m[:2] for m in res["metrics"]]),
                               np.array([m[:2] for m in local_metrics]), atol=TOL, rtol=0)
    _close(res["params"], local_params)


def test_data_and_fsdp_dropout_runs_agree(runs, local):
    """data=2 and fsdp=2 give a rank the same rows and the same per-shard
    kernel seeds: the same run, summed by other collectives. Neither is
    the local run (its kernel masks are per shard) nor the dropout-0 run."""
    a = runs["data=2"]["drop"][0]["metrics"]
    b = runs["fsdp=2"]["drop"][0]["metrics"]
    np.testing.assert_allclose(np.array(a)[:, :2], np.array(b)[:, :2], atol=TOL, rtol=0)
    assert all(np.isfinite(m[0]) for m in a) and a[-1][0] < a[0][0]
    assert abs(a[0][0] - local[0.1][0][0][0]) > 1e-4
    assert abs(a[0][0] - runs["data=2"]["off"][0]["metrics"][0][0]) > 1e-4


def _cli(shard_dir, *flags):
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "gpt_2_distributed_torch.train", "--device", "cpu", *flags,
         "--data_dir", shard_dir, "--n_layer", "2", "--n_embd", "32", "--n_head", "2",
         "--vocab_size", "257", "--seq_len", "32", "--batch", "2", "--grad_accum_steps", "2",
         "--max_steps", "4", "--lr", "3e-3", "--dropout", "0.1", "--cli_every", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, OMP_NUM_THREADS="1"))


def _check_cli(out, mesh_line):
    assert out.returncode == 0, out.stdout + out.stderr
    assert mesh_line in out.stdout, out.stdout
    losses = [float(v) for v in re.findall(r"\| loss: ([0-9.]+)", out.stdout)]
    assert len(losses) == 4 and losses[-1] < losses[0], out.stdout
    assert "training done: 4 optimizer steps" in out.stdout


def test_cli_ddp_under_torchrun_descends(shard_dir):
    _check_cli(_cli(shard_dir, "--training_mode", "ddp"),
               "mesh: data=2, fsdp=1, shard_update | model: 124M")


@pytest.mark.slow
@pytest.mark.parametrize("flags, mesh_line", [
    (["--training_mode", "fsdp"], "mesh: data=1, fsdp=2 | model"),
    (["--mesh", "data=2", "--shard_update", "off"], "mesh: data=2, fsdp=1 | model"),
])
def test_cli_other_meshes_under_torchrun(shard_dir, flags, mesh_line):
    _check_cli(_cli(shard_dir, *flags), mesh_line)
