"""The fault detectors of a mesh run (``gpt_2_distributed_torch/coordination.py``)
against the JAX package's, on the CPU:

* the parameter fingerprint of the same params (converted from the JAX
  tree) equals JAX's ``fingerprint_params`` to relative 1e-6; it is
  bit-identical across calls, moved by ``perturb_params(x1.001)`` and left
  bit-identical by x1.0; ``mismatched_ranks`` equals the JAX function on
  its cases and on seeded random lists; ``Tracer.format_open_spans`` equals
  JAX's string for the same spans on two threads; the JAX package's seven
  watchdog tests, with ``_exit`` injected;
* one gloo launch of 4 processes over a ``FileStore`` (no port): a
  perturbation planted on the last rank names it at data=2, names its
  replica's ranks at data=2 x fsdp=2, and gives ``[]`` at fsdp=2 alone (the
  fsdp group sums its shards, as XLA does in the JAX package);
* the CLI on two independent gloo processes (each rank's own exit code is
  the result): ``--inject_desync_at`` names rank 1 and, with
  ``--max_rollbacks 0``, ends both ranks with rc 1; ``--inject_worker_fail_at``
  ends both with rc 171 at the same step; ``--inject_hang_at`` ends both
  with rc 170;
* in-process: the watchdog's emergency checkpoint of the hang's step, and
  ``--resume`` from it equal to the uninterrupted run bit for bit.

Every test leaves no watchdog thread alive and the SIGTERM handler as it
found it (an autouse fixture): a watchdog that outlived its test would
hard-exit the pytest worker.
"""

from __future__ import annotations

import functools
import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from gpt_2_distributed_tpu import coordination as jax_coord
from gpt_2_distributed_tpu.models import gpt2 as jax_gpt2
from gpt_2_distributed_tpu.obs import trace as jax_trace
from gpt_2_distributed_torch import checkpoint as ck
from gpt_2_distributed_torch import coordination, train
from gpt_2_distributed_torch.coordination import (
    HangWatchdog,
    check_fingerprints,
    fingerprint_params,
    mismatched_ranks,
    perturb_params,
)
from gpt_2_distributed_torch.models.convert import params_from_jax
from gpt_2_distributed_torch.obs import trace
from gpt_2_distributed_torch.parallel.train_step import param_list
from gpt_2_distributed_torch.resilience import (
    DATA_ABORT_EXIT_CODE,
    HANG_EXIT_CODE,
    verify_checkpoint,
)
from test_torch_ring import REPO

WATCHDOG_THREADS = ("hang-watchdog", "watchdog-emergency")
TINY = ["--n_layer", "2", "--n_embd", "32", "--n_head", "2", "--vocab_size", "257",
        "--seq_len", "32", "--grad_accum_steps", "2", "--lr", "3e-3", "--dropout", "0.1",
        "--cli_every", "1", "--device", "cpu"]
PROC_TIMEOUT_S = 120
FIRES_WITHIN_S = 30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_watchdog_outlives_a_test():
    sigterm = signal.getsignal(signal.SIGTERM)
    yield
    for t in threading.enumerate():
        if t.name in WATCHDOG_THREADS:
            t.join(timeout=10)
    alive = [t.name for t in threading.enumerate()
             if t.name in WATCHDOG_THREADS and t.is_alive()]
    assert alive == [], f"watchdog threads outlived the test: {alive}"
    assert signal.getsignal(signal.SIGTERM) is sigterm


# --- the fingerprint and the perturbation ------------------------------------


def test_fingerprint_equals_jax_and_moves_only_with_the_perturbation(tiny_config):
    jax_params = jax_gpt2.init_params(tiny_config)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))
    ours, theirs = fingerprint_params(params), jax_coord.fingerprint_params(jax_params)
    assert ours == pytest.approx(theirs, rel=1e-6, abs=0)
    assert fingerprint_params(params) == ours     # bit-identical across calls
    perturb_params(param_list(params), 1.0)
    assert fingerprint_params(params) == ours     # x1.0 is the identity
    perturb_params(param_list(params), 1.001)
    moved = fingerprint_params(params)
    assert moved != ours
    want = jax_coord.fingerprint_params(jax_coord.perturb_params(jax_params, np.float32(1.001)))
    assert moved == pytest.approx(want, rel=1e-6, abs=0)


def test_perturbation_is_in_place_on_the_optimizer_tensors():
    tensors = [torch.full((3, 4), 2.0), torch.full((5,), -1.0, dtype=torch.bfloat16)]
    held = [t.data_ptr() for t in tensors]
    perturb_params(tensors, 1.5)
    assert [t.data_ptr() for t in tensors] == held
    assert tensors[0].dtype == torch.float32 and tensors[1].dtype == torch.bfloat16
    assert torch.equal(tensors[0], torch.full((3, 4), 3.0))
    assert torch.equal(tensors[1], torch.full((5,), -1.5, dtype=torch.bfloat16))


def test_check_fingerprints_identity_on_one_process(tiny_config):
    params = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_gpt2.init_params(tiny_config)))
    assert check_fingerprints(fingerprint_params(params)) == []


def _random_lists(n: int, seed: int = 7) -> list[list[float]]:
    rng = np.random.default_rng(seed)
    return [[float(v) for v in rng.choice([0.5, 1.0, 2.0, 3.0][:int(rng.integers(1, 5))],
                                          size=int(rng.integers(1, 9)))]
            for _ in range(n)]


@pytest.mark.parametrize("values", [
    [], [1.0, 1.0, 1.0], [1.0, 2.0, 1.0, 1.0], [1.0, 2.0, 2.0, 3.0], [1.0, 2.0],
    *_random_lists(8),
])
def test_mismatched_ranks_matches_jax(values):
    assert mismatched_ranks(values) == jax_coord.mismatched_ranks(values)


# --- the open spans ----------------------------------------------------------


def test_format_open_spans_equals_jax(tmp_path):
    tracers = [trace.Tracer(str(tmp_path / "torch"), enabled=True),
               jax_trace.Tracer(str(tmp_path / "jax"), enabled=True)]
    entered, release = threading.Event(), threading.Event()

    def worker():
        with tracers[0].span("bg_commit"), tracers[1].span("bg_commit"):
            with tracers[0].span("ckpt_write"), tracers[1].span("ckpt_write"):
                entered.set()
                release.wait(30)

    t = threading.Thread(target=worker, daemon=True)
    try:
        with tracers[0].span("step"), tracers[1].span("step"):
            with tracers[0].span("device_sync"), tracers[1].span("device_sync"):
                t.start()
                assert entered.wait(30)
                ours, theirs = (tr.format_open_spans() for tr in tracers)
    finally:
        release.set()
        t.join(30)
    assert ours == theirs
    assert "step > device_sync" in ours and "bg_commit > ckpt_write" in ours
    after = [tr.format_open_spans() for tr in tracers]
    assert after[0] == after[1] == "open spans: (none)"
    for tr in tracers:
        tr.close()


def test_watchdog_dump_names_open_spans(tmp_path, capsys):
    tr = trace.configure_tracing(str(tmp_path))
    path = tr.trace_path
    try:
        wd = HangWatchdog(timeout_s=60.0, _exit=lambda code: None)
        with tr.span("step", n=7):
            with tr.span("consensus_exchange"):
                wd._fire()
    finally:
        trace.configure_tracing(None)
    out = capsys.readouterr().out
    assert "[watchdog] open spans" in out
    assert "step > consensus_exchange" in out
    with open(path) as f:
        names = [json.loads(line).get("name") for line in f]
    assert "hang_watchdog_fired" in names


# --- the watchdog (the JAX package's seven tests) ------------------------------


def _watchdog(timeout_s: float, **kw) -> tuple[HangWatchdog, list[int], threading.Event]:
    exits: list[int] = []
    exited = threading.Event()

    def record(code: int) -> None:
        exits.append(code)
        exited.set()

    return HangWatchdog(timeout_s, _exit=record, **kw), exits, exited


def test_watchdog_fires_with_hang_exit_code(capsys):
    ran = threading.Event()
    wd, exits, exited = _watchdog(0.15, on_hang=ran.set)
    wd.start()
    wd.arm()
    assert exited.wait(FIRES_WITHIN_S)
    wd.stop()
    assert wd.fired and exits == [HANG_EXIT_CODE] and ran.is_set()
    assert "no optimizer step completed in 0.15s" in capsys.readouterr().out


def test_watchdog_beat_extends_deadline_and_disarm_prevents_fire():
    # The timeout is 20 beat intervals: a fire here is the watchdog's fault,
    # never the host's load.
    wd, exits, _ = _watchdog(1.0)
    wd.start()
    wd.arm()
    for _ in range(10):
        time.sleep(0.05)
        wd.beat()
    assert not wd.fired and exits == []
    wd.disarm()
    time.sleep(1.3)
    assert not wd.fired and exits == []
    wd.stop()


def test_watchdog_unarmed_never_fires():
    wd, exits, _ = _watchdog(0.1)
    wd.start()
    time.sleep(0.4)
    wd.stop()
    assert not wd.fired and exits == []


def test_watchdog_abandons_hung_emergency_save(capsys):
    release = threading.Event()
    wd, exits, exited = _watchdog(0.1, on_hang=lambda: release.wait(60), grace_s=0.2)
    wd.start()
    wd.arm()
    try:
        assert exited.wait(FIRES_WITHIN_S)
    finally:
        release.set()    # lets the abandoned save's thread end
        wd.stop()
    assert exits == [HANG_EXIT_CODE]
    assert "abandoning it" in capsys.readouterr().out


def test_watchdog_exit_survives_failing_emergency_save(capsys):
    def boom() -> None:
        raise RuntimeError("save exploded")

    wd, exits, exited = _watchdog(0.1, on_hang=boom)
    wd.start()
    wd.arm()
    assert exited.wait(FIRES_WITHIN_S)
    wd.stop()
    assert exits == [HANG_EXIT_CODE]
    assert "emergency save failed" in capsys.readouterr().out


def test_watchdog_rejects_nonpositive_timeout():
    for t in (0.0, -1.0):
        with pytest.raises(ValueError):
            HangWatchdog(t)


def test_watchdog_stop_is_idempotent_and_restartable():
    wd, exits, _ = _watchdog(10.0)
    wd.start()
    wd.stop()
    wd.stop()
    wd.start()
    assert wd._thread is not None and wd._thread.is_alive()
    wd.stop()
    assert exits == []


# --- the hang's emergency checkpoint, in-process ------------------------------


def _final_state(save_dir) -> dict:
    path = ck.latest_checkpoint(str(save_dir))
    out = {}
    for rel in ("params/rank_00000.bin", "opt_state/rank_00000.bin", "opt_state/state.json",
                "meta.json"):
        with open(os.path.join(path, rel), "rb") as f:
            out[rel] = f.read()
    return out


# The injected exit raises in the watchdog's thread, where the real one ends
# the process; pytest reports the thread's SystemExit as a warning.
@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize("guard", ["on", "off"])
def test_watchdog_checkpoint_resumes_bit_exact(shard_dir, tmp_path, monkeypatch, capsys,
                                               guard):
    """A hang before step 4: the watchdog (its exit injected to raise) commits
    step 3 from its own thread, the run ends with rc 170, and ``--resume``
    from that checkpoint ends on the uninterrupted run's state. Unguarded,
    step 3's metrics are still pending when the watchdog saves: the meta's
    token count must include them all the same."""
    flags = ["--data_dir", shard_dir, *TINY, "--batch", "4", "--max_steps", "6",
             "--step_guard", guard]
    straight = train.main(flags + ["--save_dir", str(tmp_path / "a")])
    exits: list[int] = []

    def raise_instead(code: int) -> None:
        exits.append(code)
        raise SystemExit(code)

    monkeypatch.setattr(coordination, "HangWatchdog",
                        functools.partial(HangWatchdog, _exit=raise_instead))
    with pytest.raises(SystemExit) as e:
        train.main(flags + ["--save_dir", str(tmp_path / "b"), "--hang_timeout_s", "3",
                            "--inject_hang_at", "4"])
    assert e.value.code == HANG_EXIT_CODE and exits == [HANG_EXIT_CODE]
    out = capsys.readouterr().out
    assert "[inject] simulated hang before step 4" in out
    assert "[watchdog] no optimizer step completed in 3s" in out
    path = ck.latest_checkpoint(str(tmp_path / "b"))
    assert path.endswith("step_0000003") and ck._dir_state(path) == "committed"
    assert verify_checkpoint(path) == []
    resumed = train.main(flags + ["--save_dir", str(tmp_path / "b"), "--resume"])
    assert list(resumed.buffers["loss"]) == list(straight.buffers["loss"])[3:]
    assert _final_state(tmp_path / "b") == _final_state(tmp_path / "a")


# --- two and four processes over gloo -----------------------------------------

OP_WORKER = r"""
import json, sys
import torch
import torch.distributed as dist

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world)
from gpt_2_distributed_torch.config import GPT2Config
from gpt_2_distributed_torch.coordination import (check_fingerprints, fingerprint_params,
                                                  perturb_params)
from gpt_2_distributed_torch.models import gpt2
from gpt_2_distributed_torch.parallel.mesh import Mesh, MeshSpec
from gpt_2_distributed_torch.parallel.train_step import (ShardedUpdate, make_optimizer,
                                                         trainable_params)

config = GPT2Config(vocab_size=257, n_positions=64, n_embd=32, n_layer=2, n_head=2)
pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]


def case(spec, mesh_rank, group):
    mesh = Mesh(spec, mesh_rank, group)
    params = trainable_params(gpt2.init_params(config, seed=3), torch.device("cpu"))
    local = fingerprint_params(params)
    sharded = ShardedUpdate.build(params, config, mesh, False)
    optimizer = make_optimizer(params, 1e-3, sharded=sharded)
    before = fingerprint_params(params, sharded)
    clean = check_fingerprints(before, mesh)
    last = mesh_rank == spec.n_devices - 1
    perturb_params(optimizer.param_groups[0]["params"], 1.001 if last else 1.0)
    after = fingerprint_params(params, sharded)
    return dict(local=local, before=before, after=after, clean=clean,
                bad=check_fingerprints(after, mesh))


res = {}
if rank < 2:
    res["data=2"] = case(MeshSpec(data=2), rank, pairs[0])
else:
    res["fsdp=2"] = case(MeshSpec(fsdp=2), rank - 2, pairs[1])
res["data=2,fsdp=2"] = case(MeshSpec(data=2, fsdp=2), rank, None)
with open(f"{out}-{rank}.json", "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
"""

CLI_WORKER = r"""
import json, os, sys
import torch.distributed as dist

rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
argv = json.loads(sys.argv[4])[rank]
os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
init = dist.init_process_group


def init_over_store(backend, **kw):
    init(backend, store=dist.FileStore(store, world), **kw)


dist.init_process_group = init_over_store
from gpt_2_distributed_torch import train

train.main(argv)
"""


def _spawn(code: str, world: int, d, *args: str) -> list[tuple[subprocess.Popen, str]]:
    """``world`` independent processes running ``code`` with argv ``rank
    world store *args`` over a FileStore in ``d``; each one's stdout and
    stderr go to one file, whose path comes back beside it."""
    os.makedirs(d, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        log = os.path.join(d, f"rank{r}.log")
        with open(log, "w") as f:
            procs.append((subprocess.Popen(
                [sys.executable, "-c", code, str(r), str(world), os.path.join(d, "store"),
                 *args], cwd=REPO, env=env, stdout=f, stderr=subprocess.STDOUT), log))
    return procs


def _finish(procs) -> list[tuple[int, str]]:
    """Each process's exit code and output; kills them all past the
    deadline."""
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


def _cli(shard_dir: str, *flags: str) -> list[str]:
    """The JAX package's two-process runs (``tests/test_multihost.py``): one
    micro-batch a step, one loader worker, ten steps at most."""
    return ["--data_dir", shard_dir, *TINY, "--batch", "2", "--grad_accum_steps", "1",
            "--mesh", "data=2", "--workers", "1", "--max_steps", "10", *flags]


def test_planted_perturbation_names_the_replica_that_drifted(tmp_path):
    for rc, out in _finish(_spawn(OP_WORKER, 4, tmp_path, str(tmp_path / "res"))):
        assert rc == 0, out
    res = [json.load(open(tmp_path / f"res-{r}.json")) for r in range(4)]
    for r in res:
        for case in r.values():
            assert case["clean"] == []
            # The sharded sums add up to the one-process fingerprint.
            assert case["before"] == pytest.approx(case["local"], rel=1e-6, abs=0)
    data = [res[r]["data=2"] for r in (0, 1)]
    assert [c["bad"] for c in data] == [[1], [1]]
    fsdp = [res[r]["fsdp=2"] for r in (2, 3)]
    # The fsdp group sums its shards: both ranks read the moved value.
    assert [c["bad"] for c in fsdp] == [[], []]
    assert fsdp[0]["after"] == fsdp[1]["after"] != fsdp[0]["before"]
    mixed = [r["data=2,fsdp=2"] for r in res]
    assert [c["bad"] for c in mixed] == [[2, 3]] * 4
    assert mixed[0]["after"] == mixed[1]["after"] != mixed[2]["after"] == mixed[3]["after"]


def test_cli_desync_names_rank_1_and_both_ranks_stop(shard_dir, tmp_path):
    argv = _cli(shard_dir, "--shard_update", "off", "--desync_check_every", "2",
                "--inject_desync_at", "2", "--max_rollbacks", "0")
    (rc0, out0), (rc1, out1) = _finish(_spawn(CLI_WORKER, 2, tmp_path, json.dumps([argv] * 2)))
    assert (rc0, rc1) == (1, 1), out0 + out1
    assert "desync perturbation x1 on rank 0 before step 2" in out0
    assert "desync perturbation x1.001 on rank 1 before step 2" in out1
    assert "[coord] DESYNC at step 2: rank(s) [1]" in out0
    assert "[coord] agreed rollback before step 3" in out0
    for out in (out0, out1):
        assert "loss diverged through 1 rollbacks (--max_rollbacks 0)" in out


def test_cli_worker_failure_ends_both_ranks_with_171(shard_dir, tmp_path):
    argv = _cli(shard_dir, "--inject_worker_fail_at", "2")
    (rc0, out0), (rc1, out1) = _finish(_spawn(CLI_WORKER, 2, tmp_path, json.dumps([argv] * 2)))
    assert (rc0, rc1) == (DATA_ABORT_EXIT_CODE,) * 2, out0 + out1
    assert "[coord] local data worker failed" in out0
    assert "injected data-worker failure after 2 batches" in out0
    assert "[coord] local data worker failed" not in out1
    for out in (out0, out1):
        assert "pod-wide coordinated abort at step 2" in out


def test_cli_hang_ends_both_ranks_with_170(shard_dir, tmp_path):
    """Rank 0 sleeps before step 2; its watchdog fires from the missing
    step, rank 1's from the collective rank 0 never joins. Rank 0 gets the
    longer timeout, so its peer's watchdog fires first: under gloo a peer's
    exit makes the collective that rank 1 waits in raise at once."""
    argv = [_cli(shard_dir, "--hang_timeout_s", s, "--inject_hang_at", "2") for s in ("8", "3")]
    t0 = time.monotonic()
    (rc0, out0), (rc1, out1) = _finish(_spawn(CLI_WORKER, 2, tmp_path, json.dumps(argv)))
    elapsed = time.monotonic() - t0
    assert (rc0, rc1) == (HANG_EXIT_CODE,) * 2, out0 + out1
    assert "[inject] simulated hang before step 2" in out0
    assert "[watchdog] no optimizer step completed in 8s" in out0
    assert "[watchdog] no optimizer step completed in 3s" in out1
    # Start-up, one step, the 8 s timeout and the exit, with room for a
    # loaded host: nowhere near the injected sleep (8 x 20 + 30 s).
    assert elapsed < 90, f"the pair took {elapsed:.0f} s to exit"
