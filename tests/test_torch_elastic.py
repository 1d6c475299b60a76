"""Elastic resume of the port (``gpt_2_distributed_torch``) against the JAX
package's, on the CPU:

* ``elastic_respec`` and ``elastic_rescale_accum`` equal the JAX functions
  on a grid of saved meshes, device counts and batches: the same results
  and the same error texts;
* ``plan_cursor_migration``, ``replay_cursor_history`` and
  ``cursor_plan_digest`` equal the JAX functions on the suite's shards, for
  the JAX tests' three world pairs and a second resize in one epoch (plans
  equal as sets, digests as strings); a ``set_consumed`` dataset yields
  the JAX dataset's windows in its order and counts; old consumption plus
  the new world's complement is one epoch, as a multiset of windows;
* ``CheckpointMeta.cursor_plan`` survives a round trip; ``saved_loader``
  reads the world records that earlier port runs wrote (at data=2 and at
  sp=2, where they overstated the global batch); ``process_env``'s
  environment fallbacks; a ``--shard_update`` moment saved at data=4
  restores bit-exact at data=2 and at data=1 (the ranks simulated in one
  process);
* one gloo launch of 3 processes over a ``FileStore``:
  ``assert_pod_agreement`` passes where the ranks agree and names rank 2
  where it differs, with the JAX text; ``init_distributed`` keeps a group
  that exists;
* the CLI (fp32, dropout 0; losses within ``LOSS_TOL`` of an uninterrupted
  single-process run at the same global batch): the cursor migration at
  an unchanged device count and a second resize in the same epoch
  (in-process), a tampered plan refused; a shrink saved on two gloo
  processes at data=2 and resumed in one process with
  ``--inject_world_size 1`` (the ``--batch 3`` operating-point error
  probed first); a grow saved on one process and resumed on two at
  data=2; the multi-host flags over TCP with no torchrun environment (two
  steps, equal losses on both ranks); ``--inject_world_size`` without
  ``--resume --save_dir`` refused.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
import types
from collections import Counter

import numpy as np
import pytest
import torch

from gpt_2_distributed_torch import checkpoint as ck
from gpt_2_distributed_torch import resilience as res
from gpt_2_distributed_torch import train
from gpt_2_distributed_torch.config import GPT2Config
from gpt_2_distributed_torch.data import dataloader as dl
from gpt_2_distributed_torch.models import gpt2
from gpt_2_distributed_torch.parallel import train_step as ts
from gpt_2_distributed_torch.parallel.mesh import Mesh, MeshSpec, elastic_respec, process_env
from gpt_2_distributed_torch.parallel.sharding import take_shard, tensor_layouts
from gpt_2_distributed_tpu import train as jax_train
from gpt_2_distributed_tpu.data import dataloader as jax_dl
from gpt_2_distributed_tpu.parallel import mesh as jax_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROC_TIMEOUT_S = 180
SEQ = 32
TINY = ["--n_layer", "2", "--n_embd", "32", "--n_head", "2", "--vocab_size", "257",
        "--seq_len", str(SEQ), "--batch", "2", "--workers", "1", "--dropout", "0",
        "--lr", "1e-3", "--cli_every", "1", "--device", "cpu"]
# The resumed runs sum the same fp32 terms in other orders (other micro-batch
# groupings, the mesh's all-reduce), and AdamW's m / sqrt(v) turns roundoff
# in near-zero grads into lr-sized steps: the losses here move by up to
# ~3e-5 at lr 1e-3 (the JAX package's test allows 2e-3).
LOSS_TOL = 5e-4
CFG = GPT2Config(vocab_size=257, n_positions=32, n_embd=32, n_layer=2, n_head=2,
                 embd_dropout=0.0, attn_dropout=0.0, resid_dropout=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _error(fn, *args):
    """``fn(*args)``'s result, or its ValueError's text."""
    try:
        return fn(*args)
    except ValueError as e:
        return f"ValueError: {e}"


# --- the mesh and the grad-accum rescale ---------------------------------------


@pytest.mark.parametrize("n_devices", [1, 2, 3, 4, 6, 8, 16])
@pytest.mark.parametrize("saved", ["data=2", "fsdp=2", "data=2,fsdp=4", "data=4,fsdp=2",
                                   "data=2,fsdp=2,sp=2", "data=1,fsdp=1,sp=2,tp=2"])
def test_elastic_respec_equals_jax(saved, n_devices):
    def port(text, n):
        return elastic_respec(MeshSpec.parse(text), n).to_str()

    def jax(text, n):
        return jax_mesh.elastic_respec(jax_mesh.MeshSpec.parse(text), n).to_str()

    assert _error(port, saved, n_devices) == _error(jax, saved, n_devices)


@pytest.mark.parametrize("n_devices", [1, 2, 3, 4])
@pytest.mark.parametrize("batch", [1, 2, 3, 8])
@pytest.mark.parametrize("saved_global", [8, 10, 16])
def test_elastic_rescale_accum_equals_jax(saved_global, batch, n_devices):
    args = (saved_global, batch, n_devices)
    assert (_error(train.elastic_rescale_accum, *args)
            == _error(jax_train.elastic_rescale_accum, *args))


# --- the cursor migration -------------------------------------------------------


WORLDS = [((2, 2), (1, 1)), ((1, 1), (2, 2)), ((2, 1), (1, 2))]   # (processes, workers)
BATCH, CONSUMED = 4, 10


def _paths(shard_dir):
    return dl.get_shard_paths(shard_dir, "train")


def _as_sets(plan) -> dict:
    return {p: set(v) for p, v in plan.items() if v}


def _windows(ds, worker: int) -> list[bytes]:
    return [np.asarray(w).tobytes() for w in ds.iter_worker(worker)]


def _epoch(module, paths, epoch=0) -> Counter:
    ds = module.TokenShardDataset(paths, seq_len=SEQ, process_index=0, process_count=1,
                                  num_workers=1)
    ds.set_epoch(epoch)
    return Counter(_windows(ds, 0))


def _consumption(paths, procs, workers, batches, consumed=None, epoch=0) -> Counter:
    """Ground truth independent of the planner: the windows of the first
    ``batches`` round-robin batches of every old process's workers."""
    eaten: Counter = Counter()
    for p in range(procs):
        ds = dl.TokenShardDataset(paths, seq_len=SEQ, process_index=p, process_count=procs,
                                  num_workers=workers)
        if consumed:
            ds.set_consumed(consumed, epoch)
        ds.set_epoch(epoch)
        streams = [ds.iter_worker(w) for w in range(workers)]
        left = ds.worker_batches(BATCH)
        taken, w = 0, 0
        while taken < batches:
            if left[w] > 0:
                for _ in range(BATCH):
                    eaten[np.asarray(next(streams[w])).tobytes()] += 1
                left[w] -= 1
                taken += 1
            w = (w + 1) % workers
    return eaten


def _history(old):
    """A second resize in the same epoch: world ``old`` consumes 6 steps,
    then one process with one worker 5 more."""
    return [{"process_count": old[0], "workers": old[1], "local_batch": BATCH,
             "grad_accum_steps": 1, "steps": 6},
            {"process_count": 1, "workers": 1, "local_batch": BATCH,
             "grad_accum_steps": 1, "steps": 11}]


@pytest.mark.parametrize("old, new", WORLDS)
def test_cursor_plans_and_digests_equal_jax(shard_dir, old, new):
    paths = _paths(shard_dir)
    kw = dict(seq_len=SEQ, epoch=1, old_process_count=old[0], old_num_workers=old[1],
              old_batch_size=BATCH, consumed_batches=CONSUMED)
    plan = dl.plan_cursor_migration(paths, **kw)
    assert _as_sets(plan) == _as_sets(jax_dl.plan_cursor_migration(paths, **kw))
    assert dl.cursor_plan_digest(plan) == jax_dl.cursor_plan_digest(plan)
    history = _history(old)
    folded = dl.replay_cursor_history(paths, seq_len=SEQ, epoch=1, resizes=history)
    want = jax_dl.replay_cursor_history(paths, seq_len=SEQ, epoch=1, resizes=history)
    assert _as_sets(folded) == _as_sets(want)
    assert dl.cursor_plan_digest(folded) == jax_dl.cursor_plan_digest(want)
    assert sum(map(len, folded.values())) == (6 * old[0] + 5) * BATCH
    # The dataset of the new world under the plan: the JAX dataset's windows,
    # in its order, and its counts.
    for p in range(new[0]):
        mine = dl.TokenShardDataset(paths, seq_len=SEQ, process_index=p,
                                    process_count=new[0], num_workers=new[1])
        theirs = jax_dl.TokenShardDataset(paths, seq_len=SEQ, process_index=p,
                                          process_count=new[0], num_workers=new[1])
        for ds in (mine, theirs):
            ds.set_consumed(folded, epoch=1)
            ds.set_epoch(1)
        assert mine.worker_batches(3) == theirs.worker_batches(3)
        assert mine.batches_per_epoch(BATCH) == theirs.batches_per_epoch(BATCH)
        for w in range(new[1]):
            assert _windows(mine, w) == _windows(theirs, w)


@pytest.mark.parametrize("old, new", WORLDS + [((2, 2), (2, 1))])
def test_cursor_migration_no_window_double_read_or_drop(shard_dir, old, new):
    """Old-world consumption plus the new world's complement is exactly one
    epoch, as a multiset of window bytes; after a second resize too (the
    last case)."""
    paths = _paths(shard_dir)
    if new == (2, 1):
        plan_a = dl.replay_cursor_history(paths, SEQ, 0, _history(old)[:1])
        eaten = (_consumption(paths, old[0], old[1], 6)
                 + _consumption(paths, 1, 1, 5, consumed=plan_a))
        plan = dl.replay_cursor_history(paths, SEQ, 0, _history(old))
    else:
        eaten = _consumption(paths, old[0], old[1], CONSUMED)
        plan = dl.plan_cursor_migration(paths, seq_len=SEQ, epoch=0, old_process_count=old[0],
                                        old_num_workers=old[1], old_batch_size=BATCH,
                                        consumed_batches=CONSUMED)
    assert sum(map(len, plan.values())) == sum(eaten.values())
    rest: Counter = Counter()
    for p in range(new[0]):
        ds = dl.TokenShardDataset(paths, seq_len=SEQ, process_index=p, process_count=new[0],
                                  num_workers=new[1])
        ds.set_consumed(plan, epoch=0)
        ds.set_epoch(0)
        for w in range(new[1]):
            rest.update(_windows(ds, w))
    assert eaten + rest == _epoch(dl, paths)


def test_set_consumed_counts_clear_on_another_epoch_and_refuse_eval(shard_dir):
    paths = _paths(shard_dir)
    ds = dl.TokenShardDataset(paths, seq_len=SEQ, num_workers=1)
    full = ds.batches_per_epoch(BATCH)
    plan = dl.plan_cursor_migration(paths, seq_len=SEQ, epoch=0, old_process_count=1,
                                    old_num_workers=1, old_batch_size=BATCH,
                                    consumed_batches=5)
    ds.set_consumed(plan, epoch=0)
    ds.set_epoch(0)
    assert ds.batches_per_epoch(BATCH) == full - 5
    ds.set_epoch(1)
    assert ds.batches_per_epoch(BATCH) == full
    # The unchanged shape: the plan is the prefix the arithmetic skip jumps.
    skipped = dl.TokenShardDataset(paths, seq_len=SEQ, num_workers=1)
    migrated = dl.TokenShardDataset(paths, seq_len=SEQ, num_workers=1)
    migrated.set_consumed(plan, epoch=0)
    assert (_windows(migrated, 0)
            == [np.asarray(w).tobytes() for w in skipped.iter_worker(0, 5 * BATCH)])
    with pytest.raises(ValueError, match="shard-stride"):
        dl.TokenShardDataset(paths, seq_len=SEQ, shard_windows=True).set_consumed(plan, 0)


def test_meta_cursor_plan_round_trip_and_legacy():
    record = {"epoch": 2, "digest": "ab" * 32, "windows": 48,
              "resizes": [{"process_count": 2, "workers": 2, "local_batch": 4,
                           "grad_accum_steps": 1, "steps": 6}]}
    meta = ck.CheckpointMeta(step=9, epoch=2, batches_in_epoch=9, rng_seed=1,
                             cursor_plan=record)
    assert ck.CheckpointMeta.from_json(meta.to_json()).cursor_plan == record
    legacy = '{"step": 3, "epoch": 0, "batches_in_epoch": 3, "rng_seed": 1}'
    assert ck.CheckpointMeta.from_json(legacy).cursor_plan is None


# The world records earlier port runs wrote (process_count = device count,
# local_batch = batch, global batch = batch x devices x accum), and what
# the loader really did.
OLD_RECORDS = {
    "data=2": ({"process_count": 2, "device_count": 2, "mesh": "data=2,fsdp=1,sp=1,tp=1",
                "global_batch": 8, "grad_accum_steps": 2, "batch": 2, "local_batch": 2,
                "workers": 1}, ((1, 1, 4), 8)),
    "sp=2": ({"process_count": 2, "device_count": 2, "mesh": "data=1,fsdp=1,sp=2,tp=1",
              "global_batch": 8, "grad_accum_steps": 2, "batch": 2, "local_batch": 2,
              "workers": 2}, ((1, 2, 2), 4)),
    "data=2,fsdp=2": ({"process_count": 4, "device_count": 4,
                       "mesh": "data=2,fsdp=2,sp=1,tp=1", "global_batch": 24,
                       "grad_accum_steps": 2, "batch": 3, "local_batch": 3,
                       "workers": 2}, ((1, 2, 12), 24)),
}


@pytest.mark.parametrize("name", sorted(OLD_RECORDS))
def test_saved_loader_reads_records_written_before_it(name):
    record, want = OLD_RECORDS[name]
    assert train.saved_loader(record) == want


@pytest.mark.parametrize("env, flags, want", [
    ({}, (None, None, None), (None, 1, 0)),
    ({"MASTER_ADDR": "h", "MASTER_PORT": "7", "WORLD_SIZE": "2", "RANK": "1"},
     (None, None, None), ("h:7", 2, 1)),
    ({"MASTER_ADDR": "h", "WORLD_SIZE": "2", "RANK": "0"}, (None, None, None),
     ("h:12355", 2, 0)),
    ({"COORDINATOR_ADDRESS": "c:1", "MASTER_ADDR": "h", "NUM_PROCESSES": "4",
      "WORLD_SIZE": "2", "PROCESS_ID": "3", "RANK": "1"}, (None, None, None), ("c:1", 4, 3)),
    ({"MASTER_ADDR": "h", "WORLD_SIZE": "2", "RANK": "1"}, ("x:9", 3, 2), ("x:9", 3, 2)),
    ({}, ("x:9", 2, 2), "outside the 2 processes"),
])
def test_process_env_fallbacks(monkeypatch, env, flags, want):
    for k in ("COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT", "NUM_PROCESSES",
              "WORLD_SIZE", "PROCESS_ID", "RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            process_env(*flags)
    else:
        assert process_env(*flags) == want


def _rank_states(mesh_text: str, whole, moments):
    """Each rank's (layout, optimizer) at ``mesh_text`` with the update
    sharded over 'data' where data > 1 (``--shard_update auto``)."""
    spec = MeshSpec.parse(mesh_text)
    layouts = tensor_layouts(CFG, spec, spec.data > 1)
    out = []
    for rank in range(spec.n_devices):
        mesh = Mesh(spec, rank)
        layout = ck.StateLayout(CFG, types.SimpleNamespace(layouts=layouts, mesh=mesh))
        tensors = [take_shard(t, lay, mesh) for t, lay in zip(whole, layouts)]
        opt = ts.ScheduledAdamW(tensors, 1e-3, 0.1, (0.9, 0.95), 1e-8)
        opt.count = 5
        for t, m, lay in zip(tensors, moments, layouts):
            opt.state[t] = {"step": torch.tensor(5.0), "exp_avg": take_shard(m, lay, mesh),
                            "exp_avg_sq": take_shard(m * m, lay, mesh)}
        out.append((layout, opt))
    return out


@pytest.mark.parametrize("target", ["data=2", "data=1"])
def test_shard_update_state_saved_at_data_4_restores_bit_exact(tmp_path, target):
    rng = np.random.default_rng(11)
    whole = [torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
             for p in ts.param_list(gpt2.init_params(CFG))]
    moments = [torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
               for p in whole]
    path = str(tmp_path / ck.step_dir_name(5))
    ck._mark_inprogress(path)
    for layout, opt in _rank_states("data=4", whole, moments):
        snap = ck.snapshot_state(opt, layout, res.init_guard_state())
        ck._write_snapshot(path, snap, layout.rank)
        if layout.rank == 0:
            index = snap.index
    meta = ck.CheckpointMeta(step=5, epoch=0, batches_in_epoch=5, rng_seed=0)
    ck._commit_files(path, 5, meta, index, verify=True)
    empty = torch.empty(0)
    params = {**{k: empty for k in ("wte", "wpe", "ln_f_scale", "ln_f_bias")},
              "blocks": [{k: empty for k in gpt2.BLOCK_KEYS} for _ in range(CFG.n_layer)]}
    want = _rank_states(target, whole, moments)
    zeros = [torch.zeros_like(t) for t in whole]
    for (layout, opt), (_, ref) in zip(_rank_states(target, zeros, zeros), want):
        ck.restore_checkpoint(path, params, opt, layout)
        assert opt.count == 5
        for got, exp in zip(opt.param_groups[0]["params"], ref.param_groups[0]["params"]):
            assert torch.equal(got, exp)
            for k in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(opt.state[got][k], ref.state[exp][k])


# --- processes --------------------------------------------------------------------


OP_WORKER = r"""
import json, sys
import torch
import torch.distributed as dist
from gpt_2_distributed_torch.coordination import assert_pod_agreement
from gpt_2_distributed_torch.parallel.mesh import init_distributed

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world)
res = {}
assert_pod_agreement("elastic device count", 2.0)
res["agree"] = True
try:
    assert_pod_agreement("elastic grad_accum_steps", 8.0 if rank == 2 else 4.0)
except RuntimeError as e:
    res["disagree"] = str(e)
# A group that exists is kept: no second rendezvous at this dead address.
res["device"] = str(init_distributed("127.0.0.1:1", world, rank, torch.device("cpu")))
res["world"] = dist.get_world_size()
with open(f"{out}-{rank}.json", "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
"""

# One rank of a CLI run over a FileStore (no port): torchrun's RANK /
# WORLD_SIZE / LOCAL_RANK and a FileStore in place of its TCP store; writes
# the run's per-step losses.
CLI_WORKER = r"""
import json, os, sys
import torch
import torch.distributed as dist

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
argv = json.loads(sys.argv[5])
torch.set_num_threads(1)
os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
init = dist.init_process_group


def init_over_store(backend, **kw):
    init(backend, store=dist.FileStore(store, world), **kw)


dist.init_process_group = init_over_store
from gpt_2_distributed_torch import train

tracker = train.main(argv)
with open(f"{out}-{rank}.json", "w") as f:
    json.dump(list(tracker.buffers["loss"]), f)
"""

# One process of the multi-host flags (no torchrun environment at all).
TCP_WORKER = r"""
import json, sys
import torch
from gpt_2_distributed_torch import train

torch.set_num_threads(1)
tracker = train.main(json.loads(sys.argv[2]))
with open(sys.argv[1], "w") as f:
    json.dump(list(tracker.buffers["loss"]), f)
"""

_LAUNCH_ENV = ("COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT", "NUM_PROCESSES",
               "WORLD_SIZE", "PROCESS_ID", "RANK", "LOCAL_RANK")


def _spawn(code: str, argvs: list[list[str]], d) -> list[tuple[int, str]]:
    """One process a row of ``argvs`` running ``code``, each with a hard
    timeout; their exit codes and outputs, in order. No process outlives
    the call."""
    os.makedirs(d, exist_ok=True)
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCH_ENV}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = []
    for i, argv in enumerate(argvs):
        log = os.path.join(d, f"proc{i}.log")
        with open(log, "w") as f:
            procs.append((subprocess.Popen([sys.executable, "-c", code, *argv], cwd=REPO,
                                           env=env, stdout=f, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + PROC_TIMEOUT_S
    out = []
    try:
        for p, log in procs:
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            with open(log) as f:
                out.append((rc, f.read()))
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _gloo(code: str, world: int, d, *args: str) -> list[tuple[int, str]]:
    store = os.path.join(d, "store")
    return _spawn(code, [[str(r), str(world), store, *args] for r in range(world)], d)


def test_pod_agreement_over_gloo(tmp_path):
    for rc, out in _gloo(OP_WORKER, 3, tmp_path, str(tmp_path / "res")):
        assert rc == 0, out
    res = [json.load(open(tmp_path / f"res-{r}.json")) for r in range(3)]
    want = ("pod disagrees on elastic grad_accum_steps at startup: rank(s) 2 differ "
            "(gathered [4.0, 4.0, 8.0]); all hosts must observe the same checkpoint world "
            "record and launch flags")
    for r in res:
        assert r == {"agree": True, "disagree": want, "device": "cpu", "world": 3}


def _cli(shard_dir, *flags) -> list[str]:
    return ["--data_dir", shard_dir, *TINY, *flags]


def _losses(tracker) -> list[float]:
    return list(tracker.buffers["loss"])


@pytest.fixture(scope="module")
def reference(shard_dir):
    """Six uninterrupted steps on one process at a global batch of 8 (batch 2,
    accum 4): the trajectory every resized run is held to."""
    return _losses(train.main(_cli(shard_dir, "--grad_accum_steps", "4", "--max_steps", "6")))


def test_cli_cursor_migration_at_an_unchanged_world(shard_dir, tmp_path, reference, capsys):
    """Another --batch / --grad_accum_steps at the same device count: the
    cursor migrates, a second resize in the epoch verifies the persisted
    plan, and a plan the shards no longer reproduce is refused."""
    d = str(tmp_path)

    def run(batch, accum, steps, *extra):
        return train.main(_cli(shard_dir, "--batch", str(batch), "--grad_accum_steps",
                               str(accum), "--max_steps", str(steps), "--save_dir", d, *extra))

    first = _losses(run(4, 2, 2))
    second = _losses(run(2, 4, 4, "--resume"))
    out = capsys.readouterr().out
    assert ("[elastic] data cursor migrated: old world (processes=1, workers=1, "
            "local_batch=4) consumed 16 windows over 1 shard(s)") in out
    assert "[elastic] world resized" not in out
    third = _losses(run(1, 8, 6, "--resume"))
    out = capsys.readouterr().out
    assert "[elastic] prior cursor plan verified" in out and "1 earlier resize(s)" in out
    assert "consumed 32 windows" in out
    np.testing.assert_allclose(first + second + third, reference, atol=LOSS_TOL, rtol=0)
    meta = ck.peek_latest_meta(d)
    plan = dl.replay_cursor_history(dl.get_shard_paths(shard_dir, "train"), SEQ, 0,
                                    meta.cursor_plan["resizes"])
    assert meta.cursor_plan["digest"] == dl.cursor_plan_digest(plan)
    assert [r["steps"] for r in meta.cursor_plan["resizes"]] == [2, 4]
    step_dir = ck.latest_checkpoint(d)
    record = json.load(open(os.path.join(step_dir, "meta.json")))
    record["cursor_plan"]["digest"] = "0" * 64
    with open(os.path.join(step_dir, "meta.json"), "w") as f:
        json.dump(record, f)
    # The manifest covers meta.json: it is rewritten over the tampered record.
    res.write_manifest(step_dir, meta.step)
    with pytest.raises(SystemExit) as e:
        run(2, 4, 8, "--resume")
    assert "does not reproduce from the current shards" in str(e.value.code)


def test_cli_shrink_from_two_processes_to_one(shard_dir, tmp_path, reference, capsys):
    save_dir = str(tmp_path / "ckpt")
    argv = _cli(shard_dir, "--mesh", "data=2", "--grad_accum_steps", "2", "--max_steps", "3",
                "--save_every", "3", "--save_dir", save_dir)
    runs = _gloo(CLI_WORKER, 2, tmp_path, str(tmp_path / "loss"), json.dumps(argv))
    for rc, out in runs:
        assert rc == 0, out
    assert "training done: 3 optimizer steps" in runs[0][1]
    world = ck.peek_latest_meta(save_dir).world
    assert (world["process_count"], world["local_batch"], world["global_batch"]) == (1, 4, 8)
    saved = json.load(open(tmp_path / "loss-0.json"))
    np.testing.assert_allclose(saved, reference[:3], atol=LOSS_TOL, rtol=0)

    resume = ["--mesh", "data=2", "--grad_accum_steps", "2", "--max_steps", "6",
              "--save_dir", save_dir, "--resume", "--inject_world_size", "1"]
    # First the operating-point error: no --grad_accum_steps rebuilds the
    # global batch of 8 from --batch 3 on one device.
    bad = _cli(shard_dir, *resume)
    bad[bad.index("--batch") + 1] = "3"
    with pytest.raises(SystemExit) as e:
        train.main(bad)
    assert str(e.value.code) == "error: elastic resume: " + _error(
        jax_train.elastic_rescale_accum, 8, 3, 1)[len("ValueError: "):]
    capsys.readouterr()
    resumed = _losses(train.main(_cli(shard_dir, *resume)))
    out = capsys.readouterr().out
    assert ("[elastic] world resized: 2 -> 1 device(s) (saved mesh data=2,fsdp=1,sp=1,tp=1 "
            "-> data=1,fsdp=1,sp=1,tp=1); --grad_accum_steps 2 -> 4 holds the global batch "
            "at 8") in out
    assert ("[elastic] data cursor migrated: old world (processes=1, workers=1, "
            "local_batch=4) consumed 24 windows") in out
    assert "resumed from" in out and "step 3" in out
    assert "training done: 6 optimizer steps" in out
    np.testing.assert_allclose(resumed, reference[3:], atol=LOSS_TOL, rtol=0)


def test_cli_grow_from_one_process_to_two(shard_dir, tmp_path, reference):
    save_dir = str(tmp_path / "ckpt")
    first = _losses(train.main(_cli(shard_dir, "--grad_accum_steps", "4", "--max_steps", "3",
                                    "--save_every", "3", "--save_dir", save_dir)))
    assert first == reference[:3]
    argv = _cli(shard_dir, "--mesh", "data=2", "--grad_accum_steps", "4", "--max_steps", "6",
                "--save_dir", save_dir, "--resume")
    runs = _gloo(CLI_WORKER, 2, tmp_path, str(tmp_path / "loss"), json.dumps(argv))
    for rc, out in runs:
        assert rc == 0, out
    out = runs[0][1]
    assert ("[elastic] world resized: 1 -> 2 device(s) (saved mesh data=1,fsdp=1,sp=1,tp=1 "
            "-> data=2,fsdp=1,sp=1,tp=1); --grad_accum_steps 4 -> 2 holds the global batch "
            "at 8") in out
    assert "[elastic] data cursor migrated" in out and "consumed 24 windows" in out
    assert "[elastic]" not in runs[1][1]   # only process 0 prints
    losses = [json.load(open(tmp_path / f"loss-{r}.json")) for r in range(2)]
    assert losses[0] == losses[1]
    np.testing.assert_allclose(losses[0], reference[3:], atol=LOSS_TOL, rtol=0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_multi_host_flags_over_tcp(shard_dir, tmp_path):
    """``--coordinator_address/--num_processes/--process_id`` with no
    torchrun environment: two ranks of a ddp run, equal losses."""
    for attempt in range(2):
        port = _free_port()
        argvs = [[str(tmp_path / f"loss-{i}.json"), json.dumps(_cli(
            shard_dir, "--coordinator_address", f"127.0.0.1:{port}", "--num_processes", "2",
            "--process_id", str(i), "--training_mode", "ddp", "--grad_accum_steps", "1",
            "--max_steps", "2"))] for i in range(2)]
        runs = _spawn(TCP_WORKER, argvs, tmp_path / f"try{attempt}")
        if attempt == 0 and any(rc and "address already in use" in out.lower()
                                for rc, out in runs):
            continue   # the port was taken between the probe and the bind
        break
    for rc, out in runs:
        assert rc == 0, out
    assert "mesh: data=2, fsdp=1, shard_update" in runs[0][1]
    losses = [json.load(open(tmp_path / f"loss-{i}.json")) for i in range(2)]
    assert len(losses[0]) == 2 and losses[0] == losses[1]


def test_cli_inject_world_size_needs_resume_and_save_dir(shard_dir, capsys):
    with pytest.raises(SystemExit):
        train.main(_cli(shard_dir, "--inject_world_size", "4", "--max_steps", "1"))
    assert "--inject_world_size needs --resume and --save_dir" in capsys.readouterr().err
