"""The port's process-isolated serving replicas on the CPU, held against the
JAX package: the request mirrors' wire form, the placement and fault flags
refused with the JAX CLIs' texts (and before any torch import), the fault
injector's firing schedules and the step watchdog, the spawner's respawn
budget, and real worker processes: a round trip with an extract mid-flight
adopted into an in-process engine, a SIGKILL and a SIGSTOP mid-decode whose
streams migrate with no token emitted twice and equal the in-process
engine's (greedy also the JAX engine's), and the serve CLI under
``--placement subprocess``. Tiny fp32 configs; the worker processes pin one
torch thread."""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_2_distributed_tpu import config as jax_config
from gpt_2_distributed_tpu import resilience as jax_resilience
from gpt_2_distributed_tpu.config import ServeConfig as JaxServeConfig
from gpt_2_distributed_tpu.models import gpt2 as jax_gpt2
from gpt_2_distributed_tpu.serving import ServingEngine as JaxServingEngine
from gpt_2_distributed_tpu.serving import serve as jax_serve
from gpt_2_distributed_tpu.serving.frontend.driver import StepWatchdog as JaxStepWatchdog
from gpt_2_distributed_torch import resilience
from gpt_2_distributed_torch.config import GPT2Config, ServeConfig
from gpt_2_distributed_torch.models.convert import load_npz, params_from_jax, save_npz
from gpt_2_distributed_torch.resilience import FaultInjector, InjectedFault, parse_fault_spec
from gpt_2_distributed_torch.serving import RequestHandle, ServingEngine, serve
from gpt_2_distributed_torch.serving.frontend import (
    Autoscaler,
    EngineDriver,
    ReplicaRouter,
    StepWatchdog,
    WorkerSpawner,
)
from gpt_2_distributed_torch.serving.frontend import worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--model", "124M", "--n_layer", "2", "--n_embd", "32", "--n_head", "2",
        "--vocab_size", "257", "--seq_len", "64", "--max_batch", "4", "--block_size", "8",
        "--num_blocks", "32", "--device", "cpu"]
REQS = [([5, 6, 7], 8), ([9, 10], 10), ([1, 2, 3, 4], 8), ([11, 12], 12)]

# A worker process computing in fp32 (the engine's compute dtype on the CPU
# is bf16 unless asked; the streams are held against fp32 engines): the
# spawner's argv with the module run through this bootstrap.
FP32_WORKER = (
    "import sys, torch\n"
    "from gpt_2_distributed_torch.serving import engine\n"
    "engine.ServingEngine.__init__.__kwdefaults__['compute_dtype'] = torch.float32\n"
    "from gpt_2_distributed_torch.serving.frontend import worker\n"
    "worker.main(sys.argv[1:])\n"
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params(tiny_config):
    return jax_gpt2.init_params(tiny_config, seed=0)


@pytest.fixture(scope="module")
def port(jax_params, tiny_config):
    cfg = GPT2Config(vocab_size=tiny_config.vocab_size, n_positions=tiny_config.n_positions,
                     n_embd=tiny_config.n_embd, n_layer=tiny_config.n_layer,
                     n_head=tiny_config.n_head)
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params)), cfg


@pytest.fixture(scope="module")
def npz(jax_params, tmp_path_factory):
    """The JAX params in the file the workers load (``--params_npz``)."""
    path = str(tmp_path_factory.mktemp("weights") / "tiny.npz")
    save_npz(path, jax.tree_util.tree_map(np.asarray, jax_params))
    return path


def _args(npz, *extra):
    return serve.build_argparser().parse_args(
        ["--params_npz", npz, "--requests", "-", *TINY, *extra])


def _spawner(npz, *extra, initial_replicas=1):
    args = _args(npz, "--placement", "subprocess", *extra)
    sc = serve.build_serve_config(args, serve.model_config_from_args(args))
    sp = worker.spawner_from_args(args, sc, initial_replicas=initial_replicas)
    assert sp.argv[1:3] == ["-m", worker.WORKER_MODULE]
    sp.argv = [sys.executable, "-c", FP32_WORKER] + sp.argv[3:]
    return sp, sc


def _engine_streams(port, sc, temperature, top_k=None, reqs=REQS, seed0=100):
    """The same requests through an in-process fp32 engine of the workers'
    configuration: the streams the workers must give."""
    params, cfg = port
    eng = ServingEngine(params, cfg, sc, device="cpu", temperature=temperature, top_k=top_k,
                        compute_dtype=torch.float32)
    hs = [eng.submit(p, n, seed=seed0 + i) for i, (p, n) in enumerate(reqs)]
    eng.run_until_idle(max_steps=500)
    return [h.generated for h in hs]


def _jax_streams(jax_params, tiny_config, reqs=REQS, seed0=100):
    eng = JaxServingEngine(jax_params, tiny_config,
                           JaxServeConfig(max_batch=4, block_size=8, num_blocks=32,
                                          attn_impl="xla"),
                           temperature=0.0, compute_dtype=jnp.float32)
    hs = [eng.submit(p, n, rng=seed0 + i) for i, (p, n) in enumerate(reqs)]
    eng.run_until_idle(max_steps=500)
    return [list(h.generated) for h in hs]


# --- the mirrors' wire form -------------------------------------------------


def test_a_mirror_carries_its_generator_state_through_the_wire(port):
    """A mirror holds the worker's generator as state, never a generator:
    ``to_wire`` passes the state through unchanged, and an engine that
    adopts the mirror builds the generator, continuing its draws exactly."""
    params, cfg = port
    gen = torch.Generator().manual_seed(7)
    torch.rand(5, generator=gen)
    state = {"device": "cpu", "state": gen.get_state().tolist()}
    h = RequestHandle(3, [1, 2, 3], 4)
    h._gen_state = state
    assert h._gen is None and h.to_wire()["generator"] is state
    r = RequestHandle.from_wire(json.loads(json.dumps(h.to_wire())), device="cpu")
    assert torch.equal(torch.rand(3, generator=r._gen), torch.rand(3, generator=gen))
    eng = ServingEngine(params, cfg, ServeConfig(max_batch=2, block_size=8, num_blocks=16),
                        device="cpu")
    eng.adopt(h)
    assert h._gen is not None and h._gen_state is None
    torch.rand(5, generator=gen.manual_seed(7))
    assert torch.equal(torch.rand(3, generator=h._gen), torch.rand(3, generator=gen))
    h2 = RequestHandle(4, [1], 2)
    h2._gen_state = {"device": "cuda", "state": [0] * 16}
    with pytest.raises(ValueError, match="cuda generator state"):
        eng.adopt(h2)


# --- flags: the JAX CLIs' refusals ------------------------------------------

# (flags, the flag a refusal names; None = accepted)
FLAG_GRID = [
    ([], None),
    (["--placement", "subprocess"], None),
    (["--placement", "bogus"], "--placement"),
    (["--placement", "subprocess", "--worker_max_respawns", "-1"], "--worker_max_respawns"),
    (["--placement", "subprocess", "--worker_max_respawns", "0"], None),
    (["--placement", "subprocess", "--worker_respawn_backoff_s", "-1"],
     "--worker_respawn_backoff_s"),
    (["--placement", "subprocess", "--worker_respawn_backoff_s", "0"], None),
    (["--placement", "subprocess", "--worker_rpc_timeout_s", "0"], "--worker_rpc_timeout_s"),
    (["--placement", "subprocess", "--worker_heartbeat_s", "0"], "--worker_heartbeat_s"),
    (["--placement", "subprocess", "--worker_connect_timeout_s", "0"],
     "--worker_connect_timeout_s"),
    (["--placement", "subprocess", "--worker_heartbeat_timeout_s", "0"],
     "--worker_heartbeat_timeout_s"),
    (["--placement", "subprocess", "--worker_heartbeat_timeout_s", "-2"],
     "--worker_heartbeat_timeout_s"),
    (["--placement", "subprocess", "--worker_heartbeat_timeout_s", "0.5"], None),
    (["--placement", "subprocess", "--worker_auth_token_file", "{missing}"],
     "--worker_auth_token_file"),
    (["--placement", "subprocess", "--worker_auth_token_file", "{empty}"],
     "--worker_auth_token_file"),
    (["--placement", "subprocess", "--worker_auth_token_file", "{token}"], None),
    (["--placement", "remote"], "--worker_pool"),
    (["--placement", "remote", "--worker_pool", "{missing}"], "--worker_pool"),
    (["--placement", "remote", "--worker_pool", "{pool}"], None),
    (["--placement", "subprocess", "--worker_pool", "{pool}"], "--worker_pool"),
    (["--request_timeout_s", "-1"], "--request_timeout_s"),
    (["--watchdog_timeout_s", "0"], "--watchdog_timeout_s"),
    (["--watchdog_timeout_s", "2.5"], None),
    (["--inject_replica_fail_at", "0"], "--inject_replica_fail_at"),
    (["--inject_replica_fail_at", "a"], "--inject_replica_fail_at"),
    (["--inject_replica_fail_at", "1:2:3"], "--inject_replica_fail_at"),
    (["--inject_replica_fail_at", "5:-1"], "--inject_replica_fail_at"),
    (["--inject_replica_fail_at", "5:1"], None),
    (["--inject_replica_hang_at", "3"], "--inject_replica_hang_at"),
    (["--inject_replica_hang_at", "3:0", "--watchdog_timeout_s", "1"], None),
    (["--inject_step_exception", "0"], "--inject_step_exception"),
    (["--inject_step_exception", "4"], None),
]


@pytest.fixture()
def flag_files(tmp_path):
    (tmp_path / "empty").write_text(" \n")
    (tmp_path / "token").write_text("s3cret\n")
    (tmp_path / "pool").write_text("h0 tcp://127.0.0.1:9000\n")
    return {k: str(tmp_path / k) for k in ("missing", "empty", "token", "pool")}


def _fill(flags, files):
    return [f.format(**files) for f in flags]


def _verdict(validate, parser, argv, capsys):
    """(exit code, the error after the program name) of a refusal, else
    (None, the injector's specs)."""
    try:
        inj = validate(parser, parser.parse_args(argv))
    except SystemExit as e:
        return e.code, capsys.readouterr().err.strip().splitlines()[-1].split(": error: ", 1)[1]
    return None, (None if inj is None else [inj.fail_at, inj.hang_at, inj.exception_at])


def test_worker_and_fault_flags_accept_and_refuse_as_the_jax_clis(flag_files, capsys):
    """Every case of the grid: the port's checks (``check_common_args``:
    ``validate_worker_flags``, then ``make_injector``) refuse exactly the
    values the JAX CLI's ``validate_worker_flags`` and ``make_injector``
    refuse, with the same text, and build the same injector otherwise."""

    def jax_check(p, args):
        jax_config.validate_worker_flags(p, args)
        return jax_serve.make_injector(p, args)

    for flags, named in FLAG_GRID:
        argv = ["--requests", "-", "--init_random"] + _fill(flags, flag_files)
        want = _verdict(jax_check, jax_serve.build_argparser(), argv, capsys)
        got = _verdict(serve.check_common_args, serve.build_argparser(), argv, capsys)
        if want[0] and "needs --worker_pool" in want[1]:
            # The JAX text names a `gpt2-tpu-worker` command, the port's its
            # worker module; the sentence before the parenthesis is the same.
            want, got = [(v[0], v[1].split(" (")[0]) for v in (want, got)]
        assert got == want, flags
        assert (want[0] == 2 and named in want[1]) if named else want[0] is None, flags


_REFUSE_SCRIPT = """
import contextlib, io, json, sys
sys.modules["torch"] = None
from gpt_2_distributed_torch.serving import serve
from gpt_2_distributed_torch.serving.frontend import server
out = []
for cli, base in ((serve, ["--requests", "-"]), (server, [])):
    for flags in json.loads(sys.argv[1]):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            try:
                cli.main(base + ["--init_random", "--device", "cpu"] + flags)
                code = 0
            except SystemExit as e:
                code = e.code
        out.append([code, err.getvalue().strip().splitlines()[-1]])
print(json.dumps(out))
"""


def test_both_clis_refuse_bad_worker_and_fault_flags_before_importing_torch(flag_files):
    """``gpt2-torch-serve`` and ``gpt2-torch-frontend`` refuse every bad
    placement, worker, watchdog and fault flag of the grid in a process
    where importing torch fails: the checks run before any model is
    built."""
    bad = [(_fill(flags, flag_files), named) for flags, named in FLAG_GRID if named]
    assert len(bad) == 21
    r = subprocess.run([sys.executable, "-c", _REFUSE_SCRIPT, json.dumps([f for f, _ in bad])],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert len(got) == 2 * len(bad)
    for (code, line), (flags, named) in zip(got, bad + bad):
        assert code == 2 and named in line, (flags, line)


def test_parse_fault_spec_equals_the_jax_parser():
    for spec in ("20", "20:1", "1", "0", "a", "1:2:3", "5:-1", "", "3:x", "7:0"):
        try:
            want = jax_resilience.parse_fault_spec(spec, "--f")
        except ValueError as e:
            want = str(e)
        try:
            got = parse_fault_spec(spec, "--f")
        except ValueError as e:
            got = str(e)
        assert got == want, spec


@pytest.mark.parametrize("kw", [
    dict(fail_at=(3, 0)), dict(fail_at=(2, None)), dict(exception_at=2),
    dict(kill_at=(4, 1)), dict(fail_at=(3, 1), exception_at=5, kill_at=(2, None)),
])
def test_fault_injector_fires_on_the_jax_schedule(kw):
    """The same specs ticked through the same (step, replica) sequence fire
    at the same ticks, once each, with the same messages."""
    ticks = [(s, r) for s in range(1, 8) for r in (0, 1, 2) if (s + r) % 4]

    def schedule(cls):
        killed = []
        inj = cls(**kw, kill_fn=killed.append)
        out = []
        for s, r in ticks:
            try:
                inj.tick(s, r)
                out.append(None)
            except Exception as e:   # noqa: BLE001 — the injected faults
                out.append(str(e))
        return out, killed

    got, want = schedule(FaultInjector), schedule(jax_resilience.FaultInjector)
    assert got == want
    assert sum(x is not None for x in got[0]) == ("fail_at" in kw) + ("exception_at" in kw)


def test_fault_injector_hang_released_and_expired():
    inj = FaultInjector(hang_at=(1, 0), hang_max_s=30.0)
    inj.release_hangs()       # what the watchdog's trip does
    t0 = time.monotonic()
    with pytest.raises(InjectedFault, match="released"):
        inj.tick(1, 0)
    assert time.monotonic() - t0 < 5
    inj = FaultInjector(hang_at=(1, 0), hang_max_s=0.05)
    with pytest.raises(InjectedFault, match="expired"):
        inj.tick(1, 0)


@pytest.mark.parametrize("cls", [StepWatchdog, JaxStepWatchdog], ids=["port", "jax"])
def test_step_watchdog_trips_once_per_arm(cls):
    """The JAX package's watchdog unit test, run on both classes."""
    with pytest.raises(ValueError):
        cls(0, lambda r: None)
    fired = []
    wd = cls(0.08, fired.append).start()
    try:
        wd.arm(3)
        deadline = time.monotonic() + 5
        while not fired and time.monotonic() < deadline:
            time.sleep(0.01)
        assert fired == [3] and wd.trips == 1
        time.sleep(0.25)              # one trip per arm: no refire
        assert fired == [3]
        wd.arm(1)
        wd.disarm()                   # disarmed in time: never fires
        time.sleep(0.25)
        assert fired == [3]
    finally:
        wd.stop()


def test_watchdog_condemns_a_hung_replica_and_its_streams_migrate(port):
    """``--inject_replica_hang_at 3:0`` under a 1 s watchdog: one trip,
    replica 0 fails when the released step returns, its streams finish on
    replica 1 equal to the in-process engine's, no token emitted twice."""
    params, cfg = port
    sc = ServeConfig(max_batch=4, block_size=8, num_blocks=32)
    router = ReplicaRouter(lambda: ServingEngine(params, cfg, sc, device="cpu",
                                                 temperature=0.9, top_k=40,
                                                 compute_dtype=torch.float32),
                           replicas=2, policy="round_robin")
    inj = FaultInjector(hang_at=(3, 0))
    driver = EngineDriver(router, watchdog_timeout_s=1.0, injector=inj)
    counts: dict[int, int] = {}
    hs = [driver.submit(p, n, seed=100 + i,
                        on_token=lambda h, _t: counts.__setitem__(h.id, counts.get(h.id, 0) + 1))
          for i, (p, n) in enumerate(REQS)]
    driver.drain()
    driver.close()
    assert inj.hang_fired and driver.watchdog_trips == 1
    assert router.replica_failures == 1 and router.failed_indices() == [0]
    assert router.migrated >= 1 and all(h.replica == 1 for h in hs)
    assert [h.generated for h in hs] == _engine_streams(port, sc, 0.9, 40)
    assert counts == {h.id: len(h.generated) for h in hs}
    assert driver._metrics()["watchdog_trips"] == 1.0


# --- the spawner ------------------------------------------------------------


def test_spawner_respawn_budget_exhaustion():
    """A spawner whose budget is spent raises BEFORE spawning anything."""
    sc = ServeConfig(max_batch=2, block_size=8, num_blocks=8)
    sp = WorkerSpawner([sys.executable, "-c", "raise SystemExit('never spawned')"], sc,
                       initial_replicas=1, max_respawns=0, respawn_backoff_s=0.0)

    class FakeRouter:
        n_failed = 1

    sp.router = FakeRouter()
    with pytest.raises(RuntimeError, match="respawn budget"):
        sp()
    assert sp.spawns == 0 and sp.respawns == 0


def test_spawner_counts_initial_spawns_and_backs_off(monkeypatch):
    """Without a router the first ``initial_replicas`` calls are initial
    spawns; respawns sleep ``backoff * 2**(n-1)`` and count."""
    sc = ServeConfig(max_batch=2, block_size=8, num_blocks=8)
    sp = WorkerSpawner([sys.executable], sc, initial_replicas=2, max_respawns=2,
                       respawn_backoff_s=0.5)
    assert not sp._is_respawn()
    sp.spawns = 2
    assert sp._is_respawn()
    slept = []
    monkeypatch.setattr(worker.time, "sleep", slept.append)
    sp._before_spawn("t")
    sp._before_spawn("t")
    assert slept == [0.5, 1.0] and sp.respawns == 2
    with pytest.raises(RuntimeError, match="budget exhausted"):
        sp._before_spawn("t")


def test_worker_env_pins_one_cpu_thread_and_finds_the_repo(monkeypatch):
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    env = resilience.worker_env("cpu", {"X": "1"})
    assert env["OMP_NUM_THREADS"] == "1" and env["X"] == "1"
    assert env["PYTHONPATH"].split(os.pathsep)[0] == REPO
    assert "OMP_NUM_THREADS" not in resilience.worker_env("cuda")
    monkeypatch.setenv("OMP_NUM_THREADS", "3")
    assert resilience.worker_env("cpu")["OMP_NUM_THREADS"] == "3"


def test_worker_argv_builds_the_resolved_config():
    args = serve.build_argparser().parse_args(
        ["--init_random", "--requests", "-", *TINY, "--num_blocks", "0", "--prefix_cache",
         "--top_k", "5", "--worker_auth_token_file", "tok"])
    sc = serve.build_serve_config(args, serve.model_config_from_args(args))
    argv = worker.worker_argv(args, sc)
    wargs = worker.build_argparser().parse_args(argv[3:] + ["--socket", "s"])
    assert serve.build_serve_config(wargs, serve.model_config_from_args(wargs)) == sc
    assert sc.num_blocks == 33 and wargs.auth_token_file == "tok" and wargs.top_k == 5
    assert (wargs.device, wargs.init_random) == ("cpu", True)


# --- real worker processes --------------------------------------------------


def test_worker_round_trip_and_extract_adopt(port, npz, jax_params, tiny_config):
    """One real worker process: its greedy streams equal the in-process
    engine's and the JAX engine's; a request extracted mid-flight crosses
    the wire and finishes in an in-process engine, equal to the
    uninterrupted stream, each token emitted once."""
    sp, sc = _spawner(npz, "--temperature", "0")
    h = sp()
    try:
        assert h.serve == sc and h.pid == h.proc.pid
        toks: dict[int, list[int]] = {}
        for i, (p, n) in enumerate(REQS):
            h.submit(p, n, seed=100 + i, rid=i,
                     on_token=lambda r, t: toks.setdefault(r.id, []).append(t))
        while h.has_work():
            h.step()
        got = [toks[i] for i in range(len(REQS))]
        assert got == _engine_streams(port, sc, 0.0) == _jax_streams(jax_params, tiny_config)
        assert h.stats["finished"] == len(REQS) and h.occupancy == 0

        streamed: list[int] = []
        mirror = h.submit([2, 3, 4], 8, seed=7, rid=50,
                          on_token=lambda _r, t: streamed.append(t))
        h.step()
        h.step()
        out = h.extract_inflight()          # terminal: the worker shuts down
        assert [r.id for r in out] == [50] and out[0] is mirror and not mirror.done
        assert mirror._gen is None and mirror.to_wire()["generator"]["device"] == "cpu"
        params, cfg = port
        eng = ServingEngine(params, cfg, sc, device="cpu", temperature=0.0,
                            compute_dtype=torch.float32)
        eng.adopt(mirror)
        eng.run_until_idle()
        assert mirror.done and mirror.finish_reason == "length"
        assert streamed == mirror.generated == _engine_streams(
            port, sc, 0.0, reqs=[([2, 3, 4], 8)], seed0=7)[0]
        assert h._dead == "extracted" and h.proc.poll() is not None
    finally:
        h.close()


def _fleet_run(npz, temperature, top_k, fault, replace=True):
    """Two workers behind a round-robin router, replica 0 killed mid-decode
    by the driver ``fault(router)`` builds, and (``replace``) an Autoscaler
    with a floor of 2 asking for the replacement. Returns (handles,
    emissions by rid, router, spawner, driver)."""
    extra = ["--temperature", str(temperature), "--worker_respawn_backoff_s", "0",
             "--worker_heartbeat_s", "0.05", "--worker_heartbeat_timeout_s", "0.5"]
    if top_k is not None:
        extra += ["--top_k", str(top_k)]
    sp, _ = _spawner(npz, *extra, initial_replicas=2)
    router = ReplicaRouter(sp, replicas=2, max_replicas=3, policy="round_robin")
    sp.router = router
    driver = fault(router)
    if replace:
        driver.autoscaler = Autoscaler(router, min_replicas=2, max_replicas=3)
    counts: dict[int, int] = {}
    hs = [driver.submit(p, n, seed=100 + i,
                        on_token=lambda h, _t: counts.__setitem__(h.id, counts.get(h.id, 0) + 1))
          for i, (p, n) in enumerate(REQS)]
    try:
        while driver.has_work():
            driver.step()
    finally:
        driver.close()
    return hs, counts, router, sp, driver


@pytest.mark.parametrize("temperature,top_k", [(0.0, None), (0.9, 40)], ids=["greedy", "sampled"])
def test_sigkill_mid_decode_migrates_with_nothing_emitted_twice(port, npz, jax_params,
                                                                tiny_config, temperature,
                                                                top_k):
    """A real SIGKILL of worker 0 at fleet step 4 (through the injector):
    the failure is contained, the autoscaler's below-floor replacement is
    the one respawn, every stream equals the in-process engine's (greedy:
    also the JAX engine's) and each token was emitted once."""
    def fault(router):
        inj = FaultInjector(kill_at=(4, 0),
                            kill_fn=lambda r: router.engines[r].kill(signal.SIGKILL))
        return EngineDriver(router, injector=inj, autoscale_every=1)

    hs, counts, router, sp, driver = _fleet_run(npz, temperature, top_k, fault)
    assert driver.injector.kill_fired
    assert router.replica_failures == 1 and router.failed_indices() == [0]
    assert router.migrated >= 1 and sp.respawns == 1 and len(router.engines) == 3
    assert router.metrics_snapshot()["worker_restarts"] == 1.0
    assert router.engines[0].proc.returncode == -signal.SIGKILL
    assert all(h.finish_reason == "length" for h in hs)
    assert counts == {h.id: len(h.generated) for h in hs}
    sc = router.engines[1].serve
    want = _engine_streams(port, sc, temperature, top_k)
    assert [h.generated for h in hs] == want
    if temperature == 0.0:
        assert want == _jax_streams(jax_params, tiny_config)


def test_sigstop_is_heartbeat_loss_and_the_frozen_worker_is_reaped(port, npz):
    """Worker 0 SIGSTOPped between two fleet steps: the next step's health
    sweep finds it silent past ``--worker_heartbeat_timeout_s`` (two
    attempts), traces ``heartbeat_loss``, SIGKILLs the frozen process and
    migrates its streams, which finish equal to the in-process engine's."""
    class Driver(EngineDriver):
        detected = None     # (failed replicas, seconds) after the stop's step

        def step(self):
            if self.steps != 3 or self.detected is not None:
                return super().step()
            self.router.engines[0].kill(signal.SIGSTOP)
            t0 = time.monotonic()
            time.sleep(0.1)     # past --worker_heartbeat_s: the sweep probes
            emitted = super().step()
            self.detected = (self.router.n_failed, time.monotonic() - t0)
            return emitted

    hs, counts, router, sp, driver = _fleet_run(npz, 0.9, 40, Driver, replace=False)
    eng0 = router.engines[0]
    assert eng0._dead == "heartbeat loss" and eng0.proc.returncode == -signal.SIGKILL
    # Found by the first sweep after the stop: two heartbeat attempts of
    # 0.5 s each, then the reap, the migration and one step.
    assert driver.detected[0] == 1 and driver.detected[1] < 2 * 0.5 + 2.0
    assert router.replica_failures == 1 and all(h.replica == 1 for h in hs)
    assert counts == {h.id: len(h.generated) for h in hs}
    assert [h.generated for h in hs] == _engine_streams(port, eng0.serve, 0.9, 40)


# A worker whose engine, from its fourth decode step on, fails as a CUDA
# context lost to a sticky error does: every step and the extract raise.
STICKY_WORKER = FP32_WORKER.replace("from gpt_2_distributed_torch.serving.frontend import worker\n", (
    "real_step = engine.ServingEngine.step\n"
    "def lost(*_):\n"
    "    raise RuntimeError('CUDA error: an illegal memory access was encountered')\n"
    "def step(self):\n"
    "    return lost() if self.stats['decode_steps'] >= 3 else real_step(self)\n"
    "engine.ServingEngine.step = step\n"
    "engine.ServingEngine.extract_inflight = lost\n"
    "from gpt_2_distributed_torch.serving.frontend import worker\n"))


def test_a_worker_lost_to_a_sticky_error_migrates_from_its_mirrors(port, npz):
    """The worker answers its fourth step and then the extract with a CUDA
    error: the replica fails, its streams resume from the frontend's
    mirrors on the other replica (here in process), equal to the
    in-process engine's, each token emitted once, and the worker is
    killed."""
    sp, sc = _spawner(npz, "--temperature", "0.9", "--top_k", "40")
    sp.argv[2] = STICKY_WORKER
    params, cfg = port
    makers = iter([sp, lambda: ServingEngine(params, cfg, sc, device="cpu", temperature=0.9,
                                             top_k=40, compute_dtype=torch.float32)])
    router = ReplicaRouter(lambda: next(makers)(), replicas=2, policy="round_robin")
    driver = EngineDriver(router)
    counts: dict[int, int] = {}
    hs = [driver.submit(p, n, seed=100 + i,
                        on_token=lambda h, _t: counts.__setitem__(h.id, counts.get(h.id, 0) + 1))
          for i, (p, n) in enumerate(REQS)]
    driver.drain()
    driver.close()
    victim = router.engines[0]
    assert router.failed_indices() == [0] and victim._dead == "extracted"
    assert victim.proc.returncode is not None and router.migrated == 2
    assert all(h.finish_reason == "length" and h.replica == 1 for h in hs)
    assert counts == {h.id: len(h.generated) for h in hs}
    assert [h.generated for h in hs] == _engine_streams(port, sc, 0.9, 40)


def test_serve_cli_under_subprocess_placement_prints_the_inprocess_records(npz, tmp_path,
                                                                           capsys):
    """``serve.main`` with ``--placement subprocess`` (one worker, bf16 as
    the CLI computes) prints the same streams as the in-process CLI, and the
    summary names where the engine ran. Traced, the worker writes its own
    trace-p{pid}.jsonl beside the frontend's, and ``scripts/obs_report.py``
    sees each request once: one route (the frontend's), one submit,
    first_token and finish (the worker's; the mirrors trace nothing)."""
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text("".join(json.dumps({"prompt_ids": p, "new": n, "seed": i}) + "\n"
                            for i, (p, n) in enumerate(REQS)))
    base = ["--params_npz", npz, "--requests", str(reqs), *TINY, "--temperature", "0.9",
            "--top_k", "40", "--stream"]
    out = {}
    trace = tmp_path / "trace"
    for placement in ("inprocess", "subprocess"):
        serve.main(base + ["--placement", placement]
                   + (["--trace_dir", str(trace)] if placement == "subprocess" else []))
        captured = capsys.readouterr()
        out[placement] = [json.loads(line) for line in captured.out.splitlines()]
        assert ("cpu worker processes" in captured.err) == (placement == "subprocess")
    strip = [[{k: v for k, v in r.items() if k not in ("ttft_ms", "queue_wait_ms")}
              for r in rs] for rs in out.values()]
    assert strip[0] == strip[1] and len(strip[0]) == sum(n for _, n in REQS) + len(REQS)
    files = sorted(os.listdir(trace))
    assert len(files) == 2 and "trace-p0.jsonl" in files, files
    r = subprocess.run([sys.executable, "scripts/obs_report.py", "--json", str(trace)],
                       cwd=REPO, capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr[-2000:]
    rows = json.loads(r.stdout)["serving"]["requests"]
    assert len(rows) == len(REQS)
    for row in rows:
        assert {k: row["events"].get(k) for k in ("route", "submit", "first_token", "finish")} \
            == {"route": 1, "submit": 1, "first_token": 1, "finish": 1}, row


def test_rpc_netchaos_and_the_frontend_side_of_worker_import_without_torch():
    code = ("import sys\n"
            "for m in ('torch', 'jax', 'gpt_2_distributed_tpu'):\n"
            "    sys.modules[m] = None\n"
            "from gpt_2_distributed_torch.serving.frontend import rpc, netchaos, worker\n"
            "from gpt_2_distributed_torch import config, resilience\n"
            "import argparse\n"
            "p = worker.build_argparser()\n"
            "print(sorted(k for k in sys.modules if k.startswith('gpt_2_distributed_torch')))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=60)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "gpt_2_distributed_torch.serving.engine" not in r.stdout


def test_worker_cli_refuses_a_bad_socket_before_importing_torch():
    code = ("import sys\nsys.modules['torch'] = None\n"
            "from gpt_2_distributed_torch.serving.frontend import worker\n"
            "worker.main(['--init_random', '--socket', 'tcp://nohost'])\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=60)
    assert r.returncode == 2 and "tcp://host:port" in r.stderr, r.stderr[-500:]


def test_validate_worker_flags_accepts_defaults():
    p = argparse.ArgumentParser()
    ns = argparse.Namespace(placement="subprocess", worker_max_respawns=3,
                            worker_respawn_backoff_s=2.0, worker_rpc_timeout_s=300.0,
                            worker_heartbeat_s=1.0, worker_connect_timeout_s=120.0,
                            worker_heartbeat_timeout_s=None, worker_auth_token_file=None,
                            worker_pool=None)
    from gpt_2_distributed_torch.config import validate_worker_flags

    with contextlib.redirect_stderr(io.StringIO()):
        validate_worker_flags(p, ns)   # must not exit


@pytest.mark.slow
def test_frontend_process_under_subprocess_placement_serves_and_drains(npz, tmp_path):
    """``gpt2-torch-frontend --placement subprocess --replicas 2``: two
    worker processes behind the HTTP server, a completion equal to the
    in-process engine's (bf16, as the CLI computes), ``/metrics`` with the
    worker plane's keys, SIGTERM draining to exit 0."""
    import http.client

    proc = subprocess.Popen(
        [sys.executable, "-m", "gpt_2_distributed_torch.serving.frontend.server",
         "--params_npz", npz, *TINY, "--temperature", "0", "--replicas", "2",
         "--placement", "subprocess", "--port", "0"],
        cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "1"}, stderr=subprocess.PIPE, text=True)
    try:
        port_ = None
        deadline = time.monotonic() + 180
        while port_ is None and time.monotonic() < deadline:
            line = proc.stderr.readline()
            if "frontend: http://" in line:
                port_ = int(line.rsplit(":", 1)[1].split()[0])
        assert port_, "server never announced its port"

        def call(method, path, payload=None):
            c = http.client.HTTPConnection("127.0.0.1", port_, timeout=60)
            c.request(method, path, json.dumps(payload) if payload else None,
                      {"Content-Type": "application/json"} if payload else {})
            r = c.getresponse()
            body = json.loads(r.read())
            c.close()
            return r.status, body

        status, body = call("POST", "/v1/completions", {"prompt_ids": [5, 6, 7], "max_tokens": 8})
        args = _args(npz, "--temperature", "0")
        sc = serve.build_serve_config(args, serve.model_config_from_args(args))
        eng = ServingEngine(load_npz(npz), serve.model_config_from_args(args), sc, device="cpu",
                            temperature=0.0)
        want = eng.submit([5, 6, 7], 8)
        eng.run_until_idle()
        assert status == 200 and body["choices"][0]["token_ids"] == want.generated
        status, m = call("GET", "/metrics")
        assert status == 200 and (m["worker_restarts"], m["serve_replicas"]) == (0.0, 2.0)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stderr.close()

