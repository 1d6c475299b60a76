"""The port's in-process front end on the CPU, held against the JAX front
end: every request lands on the replica the JAX ``ReplicaRouter`` picks
under each route policy; the ``Autoscaler`` decides as the JAX one on the
same signals; draining refuses submits and completes what is in flight; a
shed is a ``ShedError`` and an HTTP 503; invalid requests answer 400; SSE
streams, greedy and sampled, equal the serve CLI's; a failed replica's
streams migrate with no token emitted twice; and SIGTERM drains the serve
CLI (every final record printed, exit 0) and ``gpt2-torch-frontend``
(exit 0). Tiny configs, module-scoped weights, three subprocess tests."""

from __future__ import annotations

import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_2_distributed_tpu.config import ServeConfig as JaxServeConfig
from gpt_2_distributed_tpu.models import gpt2 as jax_gpt2
from gpt_2_distributed_tpu.serving import ServingEngine as JaxServingEngine
from gpt_2_distributed_tpu.serving.frontend import Autoscaler as JaxAutoscaler
from gpt_2_distributed_tpu.serving.frontend import EngineDriver as JaxEngineDriver
from gpt_2_distributed_tpu.serving.frontend import ReplicaRouter as JaxReplicaRouter
from gpt_2_distributed_tpu.serving.frontend.server import (
    build_argparser as jax_server_parser,
)
from gpt_2_distributed_torch.config import GPT2Config, ServeConfig
from gpt_2_distributed_torch.models.convert import params_from_jax
from gpt_2_distributed_torch.models.decode import generate_cached
from gpt_2_distributed_torch.resilience import PreemptionHandler
from gpt_2_distributed_torch.serving import ServingEngine, serve
from gpt_2_distributed_torch.serving.frontend import (
    ROUTE_POLICIES,
    Autoscaler,
    DrainingError,
    EngineDriver,
    ReplicaRouter,
    ShedError,
)
from gpt_2_distributed_torch.serving.frontend import server as frontend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--n_layer", "2", "--n_embd", "32", "--n_head", "2", "--vocab_size", "257",
        "--seq_len", "64"]
SUBPROCESS_ENV = {**os.environ, "OMP_NUM_THREADS": "1"}


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


def _serve(**kw):
    return {"max_batch": 4, "block_size": 8, "num_blocks": 32, "prefix_cache": True, **kw}


def _router(port, replicas=2, serve_kw=None, temperature=0.0, top_k=None, **kw):
    params, cfg = port
    sc = ServeConfig(**_serve(**(serve_kw or {})))
    return ReplicaRouter(lambda: ServingEngine(params, cfg, sc, device="cpu",
                                               temperature=temperature, top_k=top_k,
                                               compute_dtype=torch.float32),
                         replicas=replicas, **kw)


def _reference(port, prompt, new, seed, temperature=0.0, top_k=None):
    params, cfg = port
    return generate_cached(params, cfg, [prompt], seed=seed, max_new_tokens=new,
                           temperature=temperature, top_k=top_k,
                           compute_dtype=torch.float32, device="cpu")[0, len(prompt):].tolist()


# --- routing against the JAX router ------------------------------------------


def _route_trace():
    """Three 2-block prefixes visited in turn, strangers in between, and a
    1-block sticky key: (prompt, new, engine steps after the submit)."""
    rng = np.random.default_rng(0)
    pfx = [rng.integers(0, 257, 16).tolist() for _ in range(3)]
    out = []
    for i in range(12):
        p = (pfx[i % 3] + rng.integers(0, 257, 3).tolist() if i % 4 != 3
             else rng.integers(0, 257, 5 + i).tolist())
        out.append((p, 3 + i % 4, (0, 1, 3, 6)[i % 4]))
    out += [([11] * 8 + [50 + i], 3, 2) for i in range(3)]
    return out


@pytest.mark.parametrize("policy", ROUTE_POLICIES)
def test_each_request_lands_where_the_jax_router_puts_it(port, jax_params, tiny_config,
                                                         policy):
    jax_serve = JaxServeConfig(**_serve(attn_impl="xla"))
    jr = JaxReplicaRouter(lambda: JaxServingEngine(jax_params, tiny_config, jax_serve,
                                                   temperature=0.0,
                                                   compute_dtype=jnp.float32),
                          replicas=2, policy=policy)
    r = _router(port, policy=policy)
    placed = {}
    for name, router, drv in (("jax", jr, JaxEngineDriver(jr)), ("port", r, EngineDriver(r))):
        handles = []
        for i, (p, n, steps) in enumerate(_route_trace()):
            handles.append(drv.submit(p, n, **({"rng": i} if name == "jax" else {"seed": i})))
            for _ in range(steps):
                drv.step()
        drv.drain()
        placed[name] = ([h.replica for h in handles], [h.generated for h in handles],
                        router.affinity_hits, router.aggregate_hit_rate())
    assert placed["port"] == placed["jax"]
    assert set(placed["port"][0]) == {0, 1}
    if policy == "affinity":
        assert placed["port"][2] > 0
    mine, theirs = r.metrics_snapshot(), jr.metrics_snapshot()
    assert set(mine) == set(theirs)
    for k in ("serve_replicas", "route_affinity_hits", "prefix_cached_tokens", "preempted",
              "serve_queue_depth", "serve_occupancy", "serve_shed", "prefill_batched"):
        assert mine[k] == theirs[k], k


class FakeRouter:
    """The autoscaler's signal surface, scripted."""

    def __init__(self, n_active=1, max_batch=4):
        self.n_active, self.max_batch, self.max_replicas = n_active, max_batch, 8
        self.shed_count = self.slo_violations = self.replica_failures = 0
        self.queue = self.occupancy = 0

    def total_queue_depth(self):
        return self.queue

    def total_occupancy(self):
        return self.occupancy

    def grow(self):
        self.n_active += 1
        return self.n_active - 1

    def retire(self):
        self.n_active -= 1
        return self.n_active


@pytest.mark.parametrize("seed", range(4))
def test_autoscaler_decides_as_the_jax_one(seed):
    """400 ticks of random queue depth, occupancy, sheds, SLO violations and
    replica failures (some dropping the fleet below its floor): the same
    decision every tick and the same counters."""
    kw = dict(min_replicas=2, max_replicas=5, grow_queue_depth=3.0, grow_after=2,
              shrink_after=3, cooldown=2)
    runs = {}
    for name, cls in (("jax", JaxAutoscaler), ("port", Autoscaler)):
        r = FakeRouter(n_active=2)
        a = cls(r, **kw)
        sig = np.random.default_rng(seed + 100)
        decisions = []
        for _ in range(400):
            r.queue = int(sig.integers(0, 14)) if sig.random() < 0.5 else 0
            r.occupancy = int(sig.integers(0, 4 * r.n_active + 1))
            r.shed_count += int(sig.random() < 0.05)
            r.slo_violations += int(sig.random() < 0.05)
            if sig.random() < 0.03 and r.n_active > 1:
                r.replica_failures += 1
                r.n_active -= 1
            decisions.append((a.tick(), r.n_active))
        runs[name] = (decisions, a.scale_ups, a.scale_downs, a.replacements, a.ticks)
    assert runs["port"] == runs["jax"]
    actions = {d for d, _ in runs["port"][0]}
    assert {"grow", "shrink", "replace"} <= actions, actions


# --- the driver --------------------------------------------------------------


def test_drain_refuses_submits_and_completes_inflight(port):
    handler = PreemptionHandler(signals=())
    driver = EngineDriver(_router(port), preemption=handler)
    handles = [driver.submit([1, 2, 3, i], 8, seed=i) for i in range(4)]
    driver.step()
    handler.trigger("test SIGTERM")
    driver.step()
    assert driver.draining
    with pytest.raises(DrainingError):
        driver.submit([9, 9], 2)
    fut = driver.submit_threadsafe([9, 9], 2)
    driver.drain()
    with pytest.raises(DrainingError):
        fut.result(timeout=5)
    assert all(h.done and len(h.generated) == 8 for h in handles)
    assert [h.generated for h in handles] == [_reference(port, [1, 2, 3, i], 8, i)
                                              for i in range(4)]


def test_queue_slo_sheds_before_enqueue(port):
    router = _router(port, replicas=1, queue_slo_ms=1.0)
    driver = EngineDriver(router)
    driver.submit([1, 2, 3], 4)
    with pytest.raises(ShedError, match="queue wait"):
        driver.submit([4, 5, 6], 4, seed=1)
    assert router.shed_count == 1 and router.metrics_snapshot()["serve_shed"] == 1.0
    driver.drain()
    h = driver.submit([7, 8, 9], 3, seed=2)
    driver.drain()
    assert h.done and router.routed == 2


@pytest.mark.parametrize("temperature,top_k", [(0.0, None), (0.9, 40)])
def test_failed_replica_streams_migrate_with_nothing_emitted_twice(port, temperature, top_k):
    """Replica 0's step raises on the driver's fourth step: the driver
    fails it, its requests resume on replica 1 and every stream equals
    ``generate_cached(batch=1)``'s, each token emitted once."""
    router = _router(port, policy="round_robin", temperature=temperature, top_k=top_k)
    driver = EngineDriver(router)
    counts: dict[int, int] = {}

    def on_token(req, tok):
        counts[req.id] = counts.get(req.id, 0) + 1

    specs = [([1, 2, 3, i], 10, 20 + i) for i in range(6)]
    handles = [driver.submit(p, n, seed=s, on_token=on_token) for p, n, s in specs]
    real_step = router.engines[0].step

    def step():
        if driver.steps == 4:
            raise RuntimeError("injected")
        return real_step()

    router.engines[0].step = step
    driver.drain()
    assert router.replica_failures == 1 and router.migrated > 0
    assert router.n_failed == 1 and [i for i, _ in router.steppable()] == []
    assert all(h.replica == 1 and h.finish_reason == "length" for h in handles)
    assert all(h.tokens == h.prompt + h.generated for h in handles)
    assert counts == {h.id: len(h.generated) for h in handles}
    assert [h.generated for h in handles] == [_reference(port, p, n, s, temperature, top_k)
                                              for p, n, s in specs]
    assert router.metrics_snapshot()["requests_migrated"] == float(router.migrated)
    # With no healthy replica left the requests finish "failed".
    lone = _router(port, replicas=1)
    h = EngineDriver(lone).submit([1, 2], 4)
    assert lone.fail_replica(0) == 0 and h.finish_reason == "failed"


# --- HTTP --------------------------------------------------------------------


def _http(port_, method, path, payload=None, timeout=60):
    c = http.client.HTTPConnection("127.0.0.1", port_, timeout=timeout)
    body = json.dumps(payload) if payload is not None else None
    c.request(method, path, body, {"Content-Type": "application/json"} if body else {})
    r = c.getresponse()
    raw = r.read()
    headers = dict(r.getheaders())
    c.close()
    return r.status, (json.loads(raw) if raw else None), headers


def _sse(port_, payload, timeout=60, on_first=None):
    """POST a streaming completion: (status, chunks, saw [DONE])."""
    c = http.client.HTTPConnection("127.0.0.1", port_, timeout=timeout)
    c.request("POST", "/v1/completions", json.dumps({**payload, "stream": True}),
              {"Content-Type": "application/json"})
    r = c.getresponse()
    chunks, done = [], False
    for raw in r:
        line = raw.decode().rstrip("\r\n")
        if line == "data: [DONE]":
            done = True
        elif line.startswith("data: "):
            chunks.append(json.loads(line[6:]))
            if on_first is not None:
                on_first()
                on_first = None
    c.close()
    return r.status, chunks, done


def _tokens(chunks):
    return [c["choices"][0]["token"] for c in chunks if c["choices"][0]["token"] is not None]


class _Server:
    """A FrontendServer over ``router`` on a daemon thread, port 0."""

    def __init__(self, router, **driver_kw):
        self.driver = EngineDriver(router, **driver_kw)
        self.srv = frontend.FrontendServer(self.driver, port=0, model_name="tiny",
                                           default_new=8)
        self.thread = threading.Thread(target=self.srv.run, daemon=True)

    def __enter__(self):
        self.thread.start()
        assert self.srv.ready.wait(30), "server never bound"
        return self

    def __exit__(self, *exc):
        if self.thread.is_alive():
            self.srv.shutdown()
            self.thread.join(30)
        assert not self.thread.is_alive(), "server thread leaked"


def test_http_validation_health_and_shed(port):
    router = _router(port, replicas=1, serve_kw={"max_batch": 1}, queue_slo_ms=1.0)
    real_step = router.engines[0].step

    def slow_step():    # A's stream must outlast B's queueing and C's shed
        time.sleep(0.01)
        return real_step()

    router.engines[0].step = slow_step
    with _Server(router) as s:
        p = s.srv.port
        for payload, frag in (({"prompt_ids": [1], "prompt": "x"}, "exactly one"),
                              ({}, "exactly one"),
                              ({"prompt": "hello"}, "prompt_ids"),
                              ({"prompt_ids": []}, "non-empty"),
                              ({"prompt_ids": [1, 2], "max_tokens": "lots"}, "integers"),
                              ({"prompt_ids": [1], "timeout_s": -1}, "timeout_s"),
                              ({"prompt_ids": [1] * 200, "max_tokens": 4}, None)):
            status, body, _ = _http(p, "POST", "/v1/completions", payload)
            assert status == 400 and body["error"]["type"] == "invalid_request_error", payload
            if frag:
                assert frag in body["error"]["message"], payload
        assert _http(p, "GET", "/nope")[0] == 404
        assert _http(p, "DELETE", "/v1/completions")[0] == 405
        status, body, _ = _http(p, "GET", "/healthz")
        assert status == 200 and body == {"status": "ok", "replicas": 1}
        # A long stream holds the one slot; B queues behind it; C is shed.
        first, result = threading.Event(), {}
        ta = threading.Thread(target=lambda: result.setdefault("a", _sse(
            p, {"prompt_ids": [1, 2, 3], "max_tokens": 60}, on_first=first.set)))
        ta.start()
        assert first.wait(30)
        tb = threading.Thread(target=lambda: result.setdefault("b", _http(
            p, "POST", "/v1/completions", {"prompt_ids": [4, 5, 6], "max_tokens": 4})))
        tb.start()
        deadline = time.monotonic() + 30
        while _http(p, "GET", "/metrics")[1]["serve_queue_depth"] < 1:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        status, body, headers = _http(p, "POST", "/v1/completions",
                                      {"prompt_ids": [7, 8, 9], "max_tokens": 4})
        ta.join(60)
        tb.join(60)
        assert status == 503 and body["error"]["type"] == "overloaded"
        assert headers.get("Retry-After") == "1"
        assert result["b"][0] == 200 and len(result["b"][1]["choices"][0]["token_ids"]) == 4
        assert result["a"][0] == 200 and result["a"][2] and len(_tokens(result["a"][1])) == 60
        status, m, _ = _http(p, "GET", "/metrics")
        assert status == 200 and m["serve_shed"] == 1.0 and m["requests_routed"] == 2


def test_server_flags_are_the_jax_servers():
    """Every flag of the JAX front end parses in the port's, one by one,
    with the JAX flag's default (``--device`` and ``--attn_impl`` name the
    port's choices)."""
    jax_p, port_p = jax_server_parser(), frontend.build_argparser()
    port_actions = {a.dest: a for a in port_p._actions}
    for a in jax_p._actions:
        if not a.option_strings or a.dest == "help":
            continue
        mine = port_actions[a.dest]
        if a.dest not in ("device", "attn_impl", "ckpt"):
            assert (mine.default, mine.type, mine.nargs) == (a.default, a.type, a.nargs), a.dest
    assert port_actions["device"].default == "cuda"
    assert set(port_actions) - {a.dest for a in jax_p._actions} == {"params_npz"}


@pytest.mark.parametrize("temperature", ["0", "0.9"])
def test_sse_streams_equal_the_cli_streams(tmp_path, capsys, temperature):
    """The same four requests through ``serve.main --stream`` and through a
    two-replica front end built by the server's own flag wiring: the SSE
    tokens equal the CLI's streamed tokens, request by request."""
    reqs = [([1, 2, 3], 6, 0), ([7] * 10, 5, 1), ([5, 4, 3, 2, 1], 7, 2), ([9, 8], 4, 3)]
    path = tmp_path / "reqs.jsonl"
    path.write_text("".join(json.dumps({"prompt_ids": p, "new": n, "seed": s}) + "\n"
                            for p, n, s in reqs))
    common = ["--device", "cpu", "--init_random", *TINY, "--max_batch", "4",
              "--block_size", "8", "--temperature", temperature, "--top_k", "40",
              "--prefix_cache"]
    serve.main(common + ["--requests", str(path), "--stream"])
    cli: dict[int, list[int]] = {}
    for line in capsys.readouterr().out.splitlines():
        rec = json.loads(line)
        if "token" in rec:
            cli.setdefault(rec["id"], []).append(rec["token"])
    p = frontend.build_argparser()
    args = p.parse_args(common + ["--replicas", "2", "--port", "0"])
    router = ReplicaRouter(serve.engine_factory(p, args, torch.device("cpu")), replicas=2)
    with _Server(router) as s:
        for rid, (prompt, n, seed) in enumerate(reqs):
            status, chunks, done = _sse(s.srv.port, {"prompt_ids": prompt, "max_tokens": n,
                                                     "seed": seed})
            assert status == 200 and done
            assert _tokens(chunks) == cli[rid], rid
            assert chunks[-1]["choices"][0]["finish_reason"] == "length"
            status, body, _ = _http(s.srv.port, "POST", "/v1/completions",
                                    {"prompt_ids": prompt, "max_tokens": n, "seed": seed})
            assert status == 200 and body["choices"][0]["token_ids"] == cli[rid]
        m = _http(s.srv.port, "GET", "/metrics")[1]
        assert m["requests_routed"] == 8 and m["serve_replicas"] == 2


# --- SIGTERM (subprocesses) --------------------------------------------------


def test_serve_cli_sigterm_prints_every_final_record_and_exits_0(tmp_path):
    """SIGTERM after the first streamed token drains the batch: every
    final record is printed and the process exits 0."""
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text("".join(json.dumps({"prompt_ids": [1 + i, 2, 3], "new": 200, "seed": i})
                            + "\n" for i in range(6)))
    err_path = tmp_path / "stderr"
    with open(err_path, "w") as errf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "gpt_2_distributed_torch.serving.serve", "--device", "cpu",
             "--init_random", "--n_layer", "2", "--n_embd", "32", "--n_head", "2",
             "--vocab_size", "257", "--seq_len", "256", "--max_batch", "2",
             "--block_size", "8", "--temperature", "0", "--requests", str(reqs), "--stream"],
            cwd=REPO, env=SUBPROCESS_ENV, stdout=subprocess.PIPE, stderr=errf, text=True)
    try:
        first = json.loads(proc.stdout.readline())
        assert "token" in first
        proc.send_signal(signal.SIGTERM)
        # Read on through the same buffered stream the first line came from.
        rest = proc.stdout.read()
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()
    err = err_path.read_text()
    assert proc.returncode == 0, err
    assert "[preempt] received signal 15" in err
    lines = [json.loads(x) for x in rest.splitlines()]
    finals = [x for x in lines if "generated" in x]
    assert [x["id"] for x in finals] == list(range(6))
    assert all(x["finish_reason"] == "length" and len(x["generated"]) == 200 for x in finals)
    assert 1 + sum("token" in x for x in lines) == 6 * 200


def test_frontend_process_sigterm_drains_the_stream_and_exits_0():
    proc = subprocess.Popen(
        [sys.executable, "-m", "gpt_2_distributed_torch.serving.frontend.server",
         "--device", "cpu", "--init_random", *TINY, "--max_batch", "4", "--block_size", "8",
         "--temperature", "0", "--replicas", "2", "--prefix_cache", "--port", "0"],
        cwd=REPO, env=SUBPROCESS_ENV, stderr=subprocess.PIPE, text=True)
    try:
        port_ = None
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            line = proc.stderr.readline()
            if "frontend: http://" in line:
                port_ = int(line.rsplit(":", 1)[1].split()[0])
                break
        assert port_, "server never announced its port"
        status, body, _ = _http(port_, "GET", "/healthz")
        assert status == 200 and body["replicas"] == 2
        assert isinstance(_http(port_, "GET", "/metrics")[1], dict)
        first, result = threading.Event(), {}
        ta = threading.Thread(target=lambda: result.setdefault("a", _sse(
            port_, {"prompt_ids": [1, 2, 3], "max_tokens": 48}, on_first=first.set)))
        ta.start()
        assert first.wait(60)
        proc.send_signal(signal.SIGTERM)
        ta.join(120)
        status, chunks, done = result["a"]
        assert status == 200 and done and len(_tokens(chunks)) == 48
        assert proc.wait(timeout=120) == 0
        assert "drained, exiting 0" in proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stderr.close()
