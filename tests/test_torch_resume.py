"""Checkpoints and exact resume through the port's CLIs on the CPU
(``python -m gpt_2_distributed_torch.train --save_dir/--resume``, the
serve CLI's ``--ckpt``), at a tiny size with dropout 0.1:

* 2k steps straight equal k steps, a save and ``--resume`` for k more, bit
  for bit (losses, final params, AdamW moments, step count), unfused and
  with ``--fused_layers all --fused_matmul all`` (their plain versions);
* ``--inject_preempt_at`` exits 143 with a committed emergency checkpoint,
  and so does a poller's file notice; each resume is bit-exact;
* ``scripts/supervise.sh`` (unchanged) relaunches a run that
  ``--inject_fail_at`` crashed, and it ends on the straight run's state;
* ``--inject_nan_at`` with ``--max_consecutive_skips 1`` rolls back to the
  last checkpoint and completes; resume falls back past two corrupt
  checkpoints; ``--inject_save_fail_at`` retries, or leaves the
  ``save_failures`` metric; ``--keep_last_n``; a resume at another global
  batch is refused, naming the elastic slice;
* in one gloo launch (2 processes over a ``FileStore``, dropout 0): fsdp=2 saves at
  step k without any rank holding more fp32 param bytes than its shard; the
  checkpoint restores on one process and under ``data=2 --shard_update on``
  with params bit-equal to ``full_params`` at the save, the continued
  losses within 5e-5 of the uninterrupted fsdp=2 run's (bit-equal when
  restored under fsdp=2 itself), and checkpoints saved on one process and
  under ``data=2 --shard_update on`` restore under fsdp=2 bit-equal;
* the CLI under fsdp=2 (``torchrun``, gloo): a rollback while process 0's
  commit is held back restores the same step on both processes, and
  unguarded saves at the consensus boundary count every step's tokens;
* ``serve --ckpt`` streams equal ``--params_npz`` streams of the same
  weights.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpt_2_distributed_torch import checkpoint as ck
from gpt_2_distributed_torch import train
from gpt_2_distributed_torch.config import CheckpointPolicy, GPT2Config
from gpt_2_distributed_torch.models import gpt2
from gpt_2_distributed_torch.parallel import train_step as ts
from gpt_2_distributed_torch.resilience import init_guard_state
from gpt_2_distributed_torch.serving import serve
from test_torch_ring import REPO, join, spawn_gloo

TINY = ["--n_layer", "2", "--n_embd", "32", "--n_head", "2", "--vocab_size", "257",
        "--seq_len", "32", "--batch", "4", "--grad_accum_steps", "2", "--lr", "3e-3",
        "--dropout", "0.1", "--cli_every", "1", "--device", "cpu"]
MESH_TOL = 5e-5   # tests/test_torch_ddp.py: the mesh sums the same terms in another order


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(shard_dir, *flags):
    return train.main(["--data_dir", shard_dir, *TINY, *flags])


def _losses(tracker) -> list[float]:
    return list(tracker.buffers["loss"])


def _final_state(save_dir) -> dict:
    """The newest checkpoint's tensor files and step count, as bytes."""
    path = ck.latest_checkpoint(str(save_dir))
    out = {}
    for kind in ("params", "opt_state"):
        with open(os.path.join(path, kind, "rank_00000.bin"), "rb") as f:
            out[kind] = f.read()
    with open(os.path.join(path, "opt_state", "state.json")) as f:
        out["count"] = json.load(f)["count"]
    out["step"] = ck.CheckpointMeta.from_json(open(os.path.join(path, "meta.json")).read()).step
    return out


def _straight(shard_dir, tmp_path_factory, fused: bool):
    """Six steps straight, saved every 2 (with ``--fused_layers all
    --fused_matmul all`` when ``fused``): (flags, losses, final state)."""
    flags = ["--save_every", "2", "--max_steps", "6"]
    if fused:
        flags += ["--fused_layers", "all", "--fused_matmul", "all"]
    d = tmp_path_factory.mktemp("straight")
    tracker = _run(shard_dir, *flags, "--save_dir", str(d))
    return flags, _losses(tracker), _final_state(d)


@pytest.fixture(scope="module", params=["unfused", "fused"])
def straight(request, shard_dir, tmp_path_factory):
    return _straight(shard_dir, tmp_path_factory, request.param == "fused")


@pytest.fixture(scope="module")
def unfused(shard_dir, tmp_path_factory):
    return _straight(shard_dir, tmp_path_factory, False)


def test_resume_after_a_periodic_save_is_bit_exact(shard_dir, tmp_path, straight):
    flags, losses, final = straight
    first = _run(shard_dir, *flags[:2], "--max_steps", "3", *flags[4:],
                 "--save_dir", str(tmp_path))
    assert ck.latest_checkpoint(str(tmp_path)).endswith("step_0000003")
    second = _run(shard_dir, *flags, "--save_dir", str(tmp_path), "--resume")
    assert _losses(first) + _losses(second) == losses
    assert _final_state(tmp_path) == final
    assert final["count"] == final["step"] == 6


def test_preempt_exits_143_and_resumes_bit_exact(shard_dir, tmp_path, straight, capsys):
    flags, losses, final = straight
    with pytest.raises(SystemExit) as e:
        _run(shard_dir, *flags, "--save_dir", str(tmp_path), "--inject_preempt_at", "3")
    assert e.value.code == 143
    assert "[preempt] emergency checkpoint at step 3" in capsys.readouterr().out
    path = ck.latest_checkpoint(str(tmp_path))
    assert path.endswith("step_0000003") and ck._dir_state(path) == "committed"
    assert ck.resilience.verify_checkpoint(path) == []
    resumed = _run(shard_dir, *flags, "--save_dir", str(tmp_path), "--resume")
    assert _losses(resumed) == losses[3:]
    assert _final_state(tmp_path) == final


def test_poller_notice_saves_and_resumes(shard_dir, tmp_path, unfused, capsys):
    flags, losses, final = unfused
    with pytest.raises(SystemExit) as e:
        _run(shard_dir, *flags, "--save_dir", str(tmp_path), "--inject_preempt_notice_at", "2")
    assert e.value.code == 143
    assert "preemption notice" in capsys.readouterr().err
    assert ck.latest_checkpoint(str(tmp_path)).endswith("step_0000002")
    resumed = _run(shard_dir, *flags, "--save_dir", str(tmp_path), "--resume",
                   "--inject_preempt_notice_at", "2")
    assert _losses(resumed) == losses[2:]
    assert _final_state(tmp_path) == final


def test_supervise_relaunches_an_injected_crash(shard_dir, tmp_path, unfused):
    flags, _, final = unfused
    out = subprocess.run(
        ["bash", str(REPO / "scripts" / "supervise.sh"), sys.executable, "-m",
         "gpt_2_distributed_torch.train", "--data_dir", shard_dir, *TINY, *flags,
         "--save_dir", str(tmp_path), "--inject_fail_at", "3"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", RESTART_DELAY="0",
                 MAX_RESTARTS="2"))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[inject] simulated failure after step 3" in out.stdout
    assert "restart 1/2" in out.stderr
    assert "resumed from" in out.stdout and "training done: 6 optimizer steps" in out.stdout
    assert _final_state(tmp_path) == final


def test_nan_skips_escalate_to_a_rollback_that_completes(shard_dir, tmp_path, capsys):
    tracker = _run(shard_dir, "--save_every", "2", "--max_steps", "6", "--inject_nan_at", "4",
                   "--max_consecutive_skips", "1", "--save_dir", str(tmp_path))
    out = capsys.readouterr().out
    assert "skipped (nonfinite_loss)" in out
    assert "[resilience] rollback #1: restored" in out and "step_0000002" in out
    assert "training done: 6 optimizer steps" in out
    assert all(np.isfinite(_losses(tracker)))
    assert ck.latest_checkpoint(str(tmp_path)).endswith("step_0000006")
    with pytest.raises(SystemExit, match="diverged"):
        _run(shard_dir, "--save_every", "2", "--max_steps", "6", "--inject_nan_at", "2",
             "--max_consecutive_skips", "1", "--max_rollbacks", "0",
             "--save_dir", str(tmp_path / "b"))


def test_resume_falls_back_past_two_corrupt_checkpoints(shard_dir, tmp_path, capsys):
    flags = ["--save_every", "1", "--max_steps", "6"]
    straight = _losses(_run(shard_dir, *flags, "--save_dir", str(tmp_path / "a")))
    _run(shard_dir, *flags[:2], "--max_steps", "4", "--save_dir", str(tmp_path / "b"))
    p4 = tmp_path / "b" / "step_0000004" / "params" / "rank_00000.bin"
    p4.write_bytes(p4.read_bytes()[:-8])
    m3 = tmp_path / "b" / "step_0000003" / "meta.json"
    m3.write_text(m3.read_text().replace('"step": 3', '"step": 9'))
    capsys.readouterr()
    resumed = _run(shard_dir, *flags, "--save_dir", str(tmp_path / "b"), "--resume")
    out = capsys.readouterr().out
    assert out.count("discarding corrupt checkpoint") == 2
    assert "resumed from" in out and "step_0000002: step 2" in out
    assert _losses(resumed) == straight[2:]


def test_save_failures_retry_then_commit_or_leave_the_metric(shard_dir, tmp_path, capsys):
    base = ["--save_every", "2", "--max_steps", "4", "--save_retry_backoff", "0.01"]
    _run(shard_dir, *base, "--save_dir", str(tmp_path / "a"), "--inject_save_fail_at", "2")
    out = capsys.readouterr().out
    assert "failed (attempt 1/3)" in out and "[ckpt] committed step_0000002" in out
    assert [s for s, _ in ck.list_checkpoints(str(tmp_path / "a"))] == [2, 4]
    tracker = _run(shard_dir, *base, "--save_dir", str(tmp_path / "b"), "--async_save", "off",
                   "--inject_save_fail_at", "2", "--inject_save_fail_count", "5",
                   "--save_retries", "1")
    out = capsys.readouterr().out
    assert "failed permanently after 2 attempts" in out and "save_fail: 1" in out
    assert tracker.buffers["save_failures"][-1] == 1
    assert [s for s, _ in ck.list_checkpoints(str(tmp_path / "b"))] == [4]


def test_keep_last_n_retention(shard_dir, tmp_path):
    _run(shard_dir, "--save_every", "1", "--max_steps", "5", "--keep_last_n", "2",
         "--async_save", "off", "--save_dir", str(tmp_path))
    assert [s for s, _ in ck.list_checkpoints(str(tmp_path))] == [4, 5]
    assert ck.list_uncommitted(str(tmp_path)) == []


def test_resume_at_another_global_batch_is_refused(shard_dir, tmp_path):
    _run(shard_dir, "--max_steps", "2", "--save_dir", str(tmp_path))
    with pytest.raises(SystemExit) as e:
        _run(shard_dir, "--max_steps", "4", "--save_dir", str(tmp_path), "--resume",
             "--grad_accum_steps", "4")
    assert "elastic slice" in str(e.value.code) and "global batch of 8" in str(e.value.code)


def test_cli_refuses_injections_without_a_save_dir(shard_dir, capsys):
    for flag in ("--inject_fail_at", "--inject_preempt_notice_at", "--inject_save_fail_at"):
        with pytest.raises(SystemExit):
            _run(shard_dir, "--max_steps", "2", flag, "1")
        assert "needs --save_dir" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        _run(shard_dir, "--max_steps", "2", "--consensus_every", "0")
    assert "consensus_every" in capsys.readouterr().err


def test_serve_ckpt_streams_equal_params_npz_streams(shard_dir, tmp_path, capsys):
    _run(shard_dir, "--max_steps", "2", "--save_dir", str(tmp_path / "ckpt"))
    params, _ = ck.restore_params(ck.latest_checkpoint(str(tmp_path / "ckpt")))
    np.savez(tmp_path / "w.npz", **ck.export_full_params(params, 2))
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text("\n".join(json.dumps({"prompt_ids": p, "new": 6, "seed": i})
                              for i, p in enumerate([[1, 2, 3], [7] * 9, [5, 4], [200]])))
    model = ["--n_layer", "2", "--n_embd", "32", "--n_head", "2", "--vocab_size", "257",
             "--seq_len", "32", "--device", "cpu", "--requests", str(reqs)]
    streams = {}
    capsys.readouterr()
    for name, weights in (("ckpt", ["--ckpt", str(tmp_path / "ckpt")]),
                          ("npz", ["--params_npz", str(tmp_path / "w.npz")])):
        for temp in ("0", "0.9"):
            serve.main(weights + model + ["--temperature", temp])
            cap = capsys.readouterr()
            streams[name, temp] = [json.loads(line)["generated"]
                                   for line in cap.out.splitlines()]
            if name == "ckpt":
                assert "checkpoint: " in cap.err and "step 2" in cap.err
    for temp in ("0", "0.9"):
        assert streams["ckpt", temp] == streams["npz", temp]
        assert len(streams["ckpt", temp]) == 4
        assert all(len(s) == 6 for s in streams["ckpt", temp])
    with pytest.raises(SystemExit):
        serve.main(["--ckpt", str(tmp_path / "ckpt"), "--init_random"] + model)
    with pytest.raises(SystemExit, match="no verified checkpoint"):
        serve.main(["--ckpt", str(tmp_path / "none")] + model)


# --- the sharded checkpoint over gloo -------------------------------------------

STEPS, ACCUM, BATCH, SEQ, LR, K = 4, 2, 8, 32, 3e-3, 2

# One rank of the gloo group. Each phase trains on its rows of every
# micro-batch under a mesh; phase "fsdp" saves at step K through the
# CheckpointSaver (its writers' markers, rank 0's commit), recording what
# the rank holds while the state is copied out, then trains on; the other
# phases restore a checkpoint into fresh state of their own layout.
_WORKER = r"""
import copy
import sys
import torch
import torch.distributed as dist
from gpt_2_distributed_torch import checkpoint as ck
from gpt_2_distributed_torch.config import CheckpointPolicy, GPT2Config
from gpt_2_distributed_torch.coordination import ConsensusBus
from gpt_2_distributed_torch.ops.spmd import batch_axes, shard_offset
from gpt_2_distributed_torch.parallel import train_step as ts
from gpt_2_distributed_torch.parallel.mesh import Mesh, MeshSpec, activate_mesh
from gpt_2_distributed_torch.resilience import init_guard_state

rank, world, store, job, out = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world)
job = torch.load(job)
cfg = GPT2Config(**job["config"])
res = {}


def meta(step):
    return ck.CheckpointMeta(step=step, epoch=0, batches_in_epoch=step, rng_seed=0)


def phase(mesh_str, shard_update, restore=None, save=None, first=0):
    spec = MeshSpec.parse(mesh_str)
    mesh = Mesh(spec, rank)
    b = job["x"].shape[2] // (spec.data * spec.fsdp)
    r0 = shard_offset(mesh, batch_axes(mesh, b), b)
    with activate_mesh(mesh):
        params = ts.trainable_params(copy.deepcopy(job["params"]), torch.device("cpu"))
        sharded = ts.ShardedUpdate.build(params, cfg, mesh, shard_update)
        opt = ts.make_optimizer(params, job["lr"], sharded=sharded)
        step = ts.make_train_step(cfg, opt, compute_dtype=torch.float32, guard=True,
                                  sharded=sharded)
        layout = ck.StateLayout(cfg, sharded, mesh)
        guard, out_ = init_guard_state(), {}
        if restore is not None:
            _, guard = ck.restore_checkpoint(restore, params, opt, layout)
        whole = lambda: [p.detach().clone() for p in ts.param_list(sharded.full_params(params))]
        if restore is not None:
            out_["restored"] = whole()
        losses = []
        for i in range(first, job["x"].shape[0]):
            if save is not None and i == job["k"]:
                held, snapped = [], []
                real = ck.snapshot_state

                def spy(*a, **kw):
                    held.append(ts.state_bytes(params, opt, sharded)["params"])
                    snap = real(*a, **kw)
                    snapped.append(0 if snap.params is None else snap.params.nbytes)
                    return snap

                ck.snapshot_state = spy
                saver = ck.CheckpointSaver(save, layout, CheckpointPolicy(),
                                           barrier=ConsensusBus(mesh).barrier)
                saver.save(i, opt, meta(i), guard)
                saver.ensure_committed_sync(i, opt, meta(i), guard)
                saver.close()
                ck.snapshot_state = real
                at_save = whole()
                out_.update(at_save=at_save, held=held, snapped=snapped,
                            shard_bytes=sum(s.nbytes for s in sharded.shards),
                            whole_bytes=sum(p.nbytes for p in at_save))
            x = job["x"][i][:, r0:r0 + b]
            y = job["y"][i][:, r0:r0 + b]
            guard, m = step(params, guard, x, y, 0, i, torch.ones(x.shape[0]))
            losses.append(m.loss.item())
        out_["losses"] = losses
        out_["final"] = whole()
    return out_


k = job["k"]
res["fsdp"] = phase("fsdp=2", False, save=job["dirs"]["fsdp"])
res["fsdp_again"] = phase("fsdp=2", False, restore=job["dirs"]["fsdp_ckpt"], first=k)
res["su"] = phase("data=2", True, restore=job["dirs"]["fsdp_ckpt"], first=k)
res["su_save"] = phase("data=2", True, save=job["dirs"]["su"])
res["from_su"] = phase("fsdp=2", False, restore=job["dirs"]["su_ckpt"], first=job["x"].shape[0])
res["from_local"] = phase("fsdp=2", False, restore=job["dirs"]["local_ckpt"],
                          first=job["x"].shape[0])
torch.save(res, f"{out}-{rank}.pt")
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def job():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.integers(0, 257, (STEPS, ACCUM, BATCH, SEQ), dtype=np.int64))
    y = torch.from_numpy(rng.integers(0, 257, (STEPS, ACCUM, BATCH, SEQ), dtype=np.int64))
    # Dropout 0: under a data/fsdp mesh the kernels' masks follow per-shard
    # seeds (the JAX package's), so only a deterministic run compares with
    # the one-process run.
    config = dict(vocab_size=257, n_positions=SEQ, n_embd=32, n_layer=2, n_head=2,
                  embd_dropout=0.0, attn_dropout=0.0, resid_dropout=0.0)
    return dict(params=gpt2.init_params(GPT2Config(**config), seed=11), x=x, y=y,
                config=config, lr=LR, k=K)


def _local(job, restore=None, save=None, first=0):
    """The job on one process: optionally restored from ``restore`` and
    saved at step K into ``save``; (losses, params at the save or restore,
    final params)."""
    cfg = GPT2Config(**job["config"])
    params = ts.trainable_params(copy.deepcopy(job["params"]), torch.device("cpu"))
    opt = ts.make_optimizer(params, LR)
    step = ts.make_train_step(cfg, opt, compute_dtype=torch.float32, guard=True)
    layout, guard, at = ck.StateLayout(cfg), init_guard_state(), None
    if restore is not None:
        _, guard = ck.restore_checkpoint(restore, params, opt, layout)
        at = [p.detach().clone() for p in ts.param_list(params)]
    losses = []
    for i in range(first, STEPS):
        if save is not None and i == K:
            saver = ck.CheckpointSaver(save, layout, CheckpointPolicy(async_save=False))
            saver.save(i, opt, ck.CheckpointMeta(step=i, epoch=0, batches_in_epoch=i,
                                                 rng_seed=0), guard)
            saver.close()
            at = [p.detach().clone() for p in ts.param_list(params)]
        guard, m = step(params, guard, job["x"][i], job["y"][i], 0, i, torch.ones(ACCUM))
        losses.append(m.loss.item())
    return losses, at, [p.detach().clone() for p in ts.param_list(params)]


@pytest.fixture(scope="module")
def gloo(job, tmp_path_factory):
    """The local run (saving at step K), then one gloo launch of every
    mesh phase; ``(local, [rank 0's result, rank 1's])``."""
    tmp = tmp_path_factory.mktemp("gloo_ckpt")
    local = _local(job, save=str(tmp / "local"))
    dirs = {"fsdp": str(tmp / "fsdp"), "su": str(tmp / "su"),
            "local_ckpt": os.path.join(tmp / "local", ck.step_dir_name(K)),
            "fsdp_ckpt": os.path.join(tmp / "fsdp", ck.step_dir_name(K)),
            "su_ckpt": os.path.join(tmp / "su", ck.step_dir_name(K))}
    torch.save({**job, "dirs": dirs}, tmp / "job.pt")
    join(spawn_gloo(2, _WORKER, tmp, str(tmp / "job.pt"), str(tmp / "out")))
    return local, [torch.load(tmp / f"out-{r}.pt") for r in range(2)], dirs


def _equal(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_fsdp_save_holds_only_the_shards(gloo):
    _, ranks, dirs = gloo
    for r in ranks:
        fsdp = r["fsdp"]
        assert fsdp["held"] == [fsdp["shard_bytes"]]
        assert fsdp["snapped"][0] <= fsdp["shard_bytes"] < fsdp["whole_bytes"]
    path = dirs["fsdp_ckpt"]
    assert ck._dir_state(path) == "committed" and ck.resilience.verify_checkpoint(path) == []
    assert sorted(os.listdir(os.path.join(path, "params"))) == ["rank_00000.bin",
                                                                "rank_00001.bin"]
    assert not [n for n in os.listdir(path) if n.endswith(".written")]


def test_fsdp_checkpoint_restores_locally(job, gloo):
    _, ranks, dirs = gloo
    at_save = ranks[0]["fsdp"]["at_save"]
    assert _equal(at_save, ranks[1]["fsdp"]["at_save"])
    losses, restored, _ = _local(job, restore=dirs["fsdp_ckpt"], first=K)
    assert _equal(restored, at_save)
    np.testing.assert_allclose(losses, ranks[0]["fsdp"]["losses"][K:], atol=MESH_TOL, rtol=0)


def test_fsdp_checkpoint_restores_under_data2_shard_update(gloo):
    _, ranks, _ = gloo
    for r in ranks:
        assert _equal(r["su"]["restored"], r["fsdp"]["at_save"])
        np.testing.assert_allclose(r["su"]["losses"], r["fsdp"]["losses"][K:],
                                   atol=MESH_TOL, rtol=0)
        assert r["fsdp_again"]["losses"] == r["fsdp"]["losses"][K:]
        assert _equal(r["fsdp_again"]["final"], r["fsdp"]["final"])


def test_local_and_shard_update_checkpoints_restore_under_fsdp(gloo):
    local, ranks, _ = gloo
    for r in ranks:
        assert _equal(r["from_local"]["restored"], local[1])
        assert _equal(r["from_su"]["restored"], r["su_save"]["at_save"])


def _torchrun(shard_dir, *flags, env=None):
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "gpt_2_distributed_torch.train", "--training_mode", "fsdp", "--data_dir",
         shard_dir, *TINY, "--batch", "2", "--save_every", "2", "--max_steps", "6", *flags],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, OMP_NUM_THREADS="1", **(env or {})))


def test_cli_fsdp_rollback_waits_for_the_commit_on_every_rank(shard_dir, tmp_path):
    """A spike rollback under fsdp=2 while process 0 still holds the step-4
    checkpoint uncommitted (the commit-delay seam): every process waits for
    that commit and restores step 4 (the CLI exits with an error when the
    processes restore different steps)."""
    out = _torchrun(shard_dir, "--save_dir", str(tmp_path), "--inject_nan_at", "5",
                    "--max_consecutive_skips", "1", env={ck.COMMIT_DELAY_ENV: "1.0"})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "skipped (nonfinite_loss)" in out.stdout
    assert "rollback #1: restored" in out.stdout and "step_0000004 (step 4)" in out.stdout
    assert "training done: 6 optimizer steps" in out.stdout
    assert [s for s, _ in ck.list_checkpoints(str(tmp_path))] == [2, 4, 6]


def test_cli_fsdp_unguarded_saves_count_every_step_s_tokens(shard_dir, tmp_path):
    """Unguarded, the mesh loop reads a step's metrics one step late; a save
    at the consensus boundary reads them first, so each checkpoint's
    ``total_tokens`` is its step count times a step's global tokens."""
    out = _torchrun(shard_dir, "--save_dir", str(tmp_path), "--step_guard", "off")
    assert out.returncode == 0, out.stdout + out.stderr
    per_step = 2 * 2 * 2 * 32   # --batch 2 x fsdp 2 rows, 2 micro-batches, seq 32
    saved = ck.list_checkpoints(str(tmp_path))
    assert [s for s, _ in saved] == [2, 4, 6]
    for step, path in saved:
        with open(os.path.join(path, "meta.json")) as f:
            assert ck.CheckpointMeta.from_json(f.read()).total_tokens == step * per_step


@pytest.mark.slow
def test_cli_fsdp_preempt_and_resume_under_torchrun(shard_dir, tmp_path):
    """The mesh loop: saves at the consensus boundary, an injected SIGTERM
    agreed by both ranks (each exits 143 after the emergency save), and a
    resume that ends on the straight run's per-rank files."""
    straight = _torchrun(shard_dir, "--save_dir", str(tmp_path / "a"))
    assert straight.returncode == 0, straight.stdout + straight.stderr
    preempted = _torchrun(shard_dir, "--save_dir", str(tmp_path / "b"),
                          "--inject_preempt_at", "3")
    assert "[preempt] emergency checkpoint at step 3" in preempted.stdout, preempted.stderr
    assert ck._dir_state(str(tmp_path / "b" / "step_0000003")) == "committed"
    resumed = _torchrun(shard_dir, "--save_dir", str(tmp_path / "b"), "--resume")
    assert resumed.returncode == 0 and "resumed from" in resumed.stdout, resumed.stderr
    for kind in ("params", "opt_state"):
        for rank in (0, 1):
            rel = os.path.join("step_0000006", kind, f"rank_{rank:05d}.bin")
            assert (tmp_path / "a" / rel).read_bytes() == (tmp_path / "b" / rel).read_bytes()
