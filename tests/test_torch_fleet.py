"""The port's cross-host serving fleet on the CPU, held against the JAX
package: frames byte for byte the JAX ``rpc.send_msg``'s, torn at every
header byte, mid-payload, oversize and malformed; the authenticated hello
(mutual HMAC, wrong token, missing token, stale version) and its domain
tag, which keeps the two packages' fleets apart; the ``ChaosProxy``'s
tear, partition and heal on the same port, and one-way blackhole; the
pool ledger, the ``RemoteSpawner``'s quarantine, re-admission and
refusals; a host contained as one batch (``fail_host``) and the driver's
health sweep telling a host's death from one worker's; and two real TCP
workers behind chaos proxies, host A partitioned mid-decode, its streams
finishing on host B equal to the in-process engine's with no token emitted
twice, and host A re-admitted after ``heal()``."""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import hmac
import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from gpt_2_distributed_tpu.models import gpt2 as jax_gpt2
from gpt_2_distributed_tpu.serving.frontend import rpc as jax_rpc
from gpt_2_distributed_tpu.serving.frontend import worker as jax_worker
from gpt_2_distributed_torch.config import GPT2Config, ServeConfig
from gpt_2_distributed_torch.models.convert import params_from_jax, save_npz
from gpt_2_distributed_torch.serving import ServingEngine
from gpt_2_distributed_torch.serving.frontend import (
    Autoscaler,
    ChaosProxy,
    EngineDriver,
    RemoteSpawner,
    ReplicaRouter,
    read_worker_pool,
)
from gpt_2_distributed_torch.serving.frontend.rpc import (
    MAX_FRAME_BYTES,
    WIRE_VERSION,
    WireError,
    auth_mac,
    client_hello,
    create_listener,
    dial,
    listener_addr,
    load_auth_token,
    make_nonce,
    parse_addr,
    recv_msg,
    send_msg,
    server_hello,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE = ServeConfig(max_batch=2, block_size=8, num_blocks=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- framing ----------------------------------------------------------------


def _frame(send, obj) -> bytes:
    a, b = socket.socketpair()
    try:
        send(a, obj)
        a.close()
        out = b""
        while chunk := b.recv(65536):
            out += chunk
        return out
    finally:
        b.close()


@pytest.mark.parametrize("obj", [
    {},
    {"op": "step"},
    {"op": "step", "nested": {"rid": 7, "toks": [1, 2, 3]}, "f": 1.5, "none": None,
     "uni": "héllo", "big": list(range(3000))},
    {"ok": False, "error_type": "ValueError", "error": "x" * 70000, "neg": -3e-12},
])
def test_send_msg_frames_equal_the_jax_frames(obj):
    got = _frame(send_msg, obj)
    assert got == _frame(jax_rpc.send_msg, obj)
    assert struct.unpack(">I", got[:4])[0] == len(got) - 4
    a, b = socket.socketpair()
    try:
        a.sendall(got)
        assert recv_msg(b) == obj
    finally:
        a.close()
        b.close()


def test_parse_addr_equals_the_jax_parser():
    for spec in ("/tmp/w.sock", "tcp://10.0.0.7:9000", "tcp://h:0", "tcp://nohost",
                 "tcp://:9000", "tcp://h:port", "tcp://h:70000", "tcp://[::1]:5"):
        out = []
        for mod in (jax_rpc, sys.modules[parse_addr.__module__]):
            try:
                out.append(mod.parse_addr(spec))
            except ValueError as e:
                out.append(str(e))
        assert out[0] == out[1], spec


def test_tcp_listener_dial_roundtrip():
    lsock = create_listener("tcp://127.0.0.1:0")
    try:
        spec = listener_addr(lsock)
        assert spec.startswith("tcp://127.0.0.1:")
        c = dial(spec, timeout=5)
        s, _ = lsock.accept()
        try:
            msg = {"op": "step", "toks": list(range(40)), "uni": "héllo"}
            send_msg(c, msg)
            assert recv_msg(s) == msg
            send_msg(s, {"ok": True})
            send_msg(s, {"ok": False, "n": 2})
            assert recv_msg(c) == {"ok": True}
            assert recv_msg(c) == {"ok": False, "n": 2}
        finally:
            c.close()
            s.close()
    finally:
        lsock.close()


@pytest.mark.parametrize("cut", [0, 1, 2, 3])
def test_torn_frame_at_every_header_byte_boundary(cut):
    """A connection severed ``cut`` bytes into the 4-byte length prefix is a
    WireError naming the peer and the short read, never a hang."""
    lsock = create_listener("tcp://127.0.0.1:0")
    try:
        c = dial(listener_addr(lsock), timeout=5)
        c.settimeout(10)
        s, _ = lsock.accept()
        s.sendall(struct.pack(">I", 5)[:cut])
        s.close()
        with pytest.raises(WireError) as ei:
            recv_msg(c)
        text = str(ei.value)
        assert "127.0.0.1" in text
        assert ("EOF" in text) if cut == 0 else (f"{cut}/4 bytes" in text)
        c.close()
    finally:
        lsock.close()


def test_torn_frame_mid_payload_names_progress():
    lsock = create_listener("tcp://127.0.0.1:0")
    try:
        c = dial(listener_addr(lsock), timeout=5)
        c.settimeout(10)
        s, _ = lsock.accept()
        s.sendall(struct.pack(">I", 10) + b"{abc")     # 4 of 10 bytes
        s.close()
        with pytest.raises(WireError, match=r"4/10 bytes"):
            recv_msg(c)
        c.close()
    finally:
        lsock.close()


def test_oversize_malformed_and_non_object_frames_name_length_and_peer():
    a, b = socket.socketpair()
    try:
        declared = MAX_FRAME_BYTES + 7
        a.sendall(struct.pack(">I", declared))
        with pytest.raises(WireError) as ei:
            recv_msg(b, peer="tcp-host-7:9000")
        assert (str(declared) in str(ei.value) and "tcp-host-7:9000" in str(ei.value)
                and "declares length" in str(ei.value))
        raw = b"\xff\xfe not json"
        a.sendall(struct.pack(">I", len(raw)) + raw)
        with pytest.raises(WireError, match=f"malformed {len(raw)}-byte frame from worker-3"):
            recv_msg(b, peer="worker-3")
        raw = json.dumps([1, 2, 3]).encode()
        a.sendall(struct.pack(">I", len(raw)) + raw)
        with pytest.raises(WireError, match="expected object"):
            recv_msg(b)
        with pytest.raises(WireError, match="refusing to send"):
            send_msg(a, {"x": "y" * MAX_FRAME_BYTES}, peer="w")
        a.close()
        with pytest.raises(WireError, match="EOF|closed"):
            recv_msg(b)
    finally:
        b.close()


# --- the authenticated hello ------------------------------------------------


def _hello_server(conn, token, payload, hello=server_hello, recv=recv_msg, send=send_msg):
    """Worker side of one hello exchange on a thread; ``out`` gets ``ok``
    (the verdict) and ``sent_engine`` iff engine state crossed the link."""
    out = {}

    def run():
        try:
            msg = recv(conn, peer="frontend")
            out["ok"] = hello(conn, msg, token, peer="frontend")
            if out["ok"]:
                send(conn, payload, peer="frontend")
                out["sent_engine"] = True
        except Exception as e:  # noqa: BLE001 — recorded for the assertions
            out["error"] = str(e)
        finally:
            conn.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, out


def _hello(client_token, server_token, *, jax_server=False):
    payload = {"ok": True, "wire_version": WIRE_VERSION, "pid": 4242, "engine": "state"}
    a, b = socket.socketpair()
    kw = dict(hello=jax_rpc.server_hello, recv=jax_rpc.recv_msg,
              send=jax_rpc.send_msg) if jax_server else {}
    t, out = _hello_server(b, server_token, payload, **kw)
    try:
        reply = client_hello(a, client_token, peer="worker")
    except WireError as e:
        reply = e
    finally:
        a.close()
        t.join(timeout=10)
    assert not t.is_alive()
    return reply, out, payload


def test_hello_mutual_auth_success_and_unauthenticated_success():
    for token in (b"fleet-secret", None):
        reply, out, payload = _hello(token, token)
        assert reply == payload and out == {"ok": True, "sent_engine": True}


@pytest.mark.parametrize("client,server,match", [
    (b"wrong-token", b"right-token", "mutual authentication"),
    (None, b"fleet-secret", "requires authentication"),
    (b"fleet-secret", None, "refusing to adopt an unauthenticated worker"),
])
def test_hello_refusals(client, server, match):
    """Each refusal is loud; a worker holding a token sends its engine
    payload to no frontend that failed the challenge (an unauthenticated
    worker sends it to anyone, and a token-bearing frontend refuses it)."""
    reply, out, _ = _hello(client, server)
    assert isinstance(reply, WireError) and match in str(reply)
    assert ("sent_engine" in out) == (server is None)


def test_hello_refuses_a_jax_worker_with_the_same_token():
    """Same frames, other domain tag: a port frontend and a JAX worker
    holding one token never authenticate each other."""
    reply, out, _ = _hello(b"fleet-secret", b"fleet-secret", jax_server=True)
    assert isinstance(reply, WireError) and "mutual authentication" in str(reply)
    assert "sent_engine" not in out


def test_hello_bad_client_mac_refused_loudly():
    a, b = socket.socketpair()
    t, out = _hello_server(b, b"fleet-secret", {"ok": True})
    try:
        send_msg(a, {"op": "hello", "wire_version": WIRE_VERSION})
        challenge = recv_msg(a)
        assert challenge.get("auth") == "challenge" and "proof" not in challenge
        send_msg(a, {"op": "auth", "mac": "bogus"})
        refusal = recv_msg(a)
        assert refusal["ok"] is False and "authentication failed" in refusal["error"]
    finally:
        a.close()
        t.join(timeout=10)
    assert out.get("ok") is False and "sent_engine" not in out


def test_hello_stale_wire_version_refused_before_auth():
    a, b = socket.socketpair()
    t, out = _hello_server(b, b"fleet-secret", {"ok": True})
    try:
        send_msg(a, {"op": "hello", "wire_version": WIRE_VERSION + 1, "nonce": make_nonce()})
        refusal = recv_msg(a)
        assert refusal["ok"] is False and "auth" not in refusal
        assert "wire version mismatch" in refusal["error"]
    finally:
        a.close()
        t.join(timeout=10)
    assert out.get("ok") is False and "sent_engine" not in out


def test_auth_mac_binds_role_nonce_token_and_the_ports_domain():
    token, nonce = b"tok", make_nonce()
    assert auth_mac(token, "server", nonce) != auth_mac(token, "client", nonce)
    assert auth_mac(token, "client", nonce) != auth_mac(token, "client", make_nonce())
    assert auth_mac(token, "client", nonce) != auth_mac(b"tok2", "client", nonce)
    want = hmac.new(token, f"gpt2-torch-worker-rpc-v{WIRE_VERSION}|client|{nonce}".encode(),
                    hashlib.sha256).hexdigest()
    assert auth_mac(token, "client", nonce) == want
    assert want != jax_rpc.auth_mac(token, "client", nonce)


def test_load_auth_token_strips_and_rejects_empty(tmp_path):
    p = tmp_path / "tok"
    p.write_text("  s3cret\n")
    assert load_auth_token(str(p)) == b"s3cret"
    p.write_text(" \n\t")
    with pytest.raises(ValueError, match="empty"):
        load_auth_token(str(p))


# --- the chaos proxy --------------------------------------------------------


@pytest.fixture()
def echo_upstream():
    lsock = create_listener("tcp://127.0.0.1:0")

    def pump(c):
        while True:
            try:
                data = c.recv(65536)
            except OSError:
                break
            if not data:
                break
            try:
                c.sendall(data)
            except OSError:
                break
        c.close()

    def accept_loop():
        while True:
            try:
                conn, _ = lsock.accept()
            except OSError:
                return
            threading.Thread(target=pump, args=(conn,), daemon=True).start()

    threading.Thread(target=accept_loop, daemon=True).start()
    yield listener_addr(lsock)
    lsock.close()


def _recv_all(sock, n, timeout=10.0):
    sock.settimeout(timeout)
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            break
        buf += chunk
    return buf


def test_chaos_proxy_passthrough_and_tear(echo_upstream):
    px = ChaosProxy(echo_upstream)
    try:
        c = dial(px.addr, timeout=5)
        c.sendall(b"ABCDEFGH")
        assert _recv_all(c, 8) == b"ABCDEFGH"
        px.tear(after_bytes=3)      # exactly 3 more reply bytes, then the cut
        c.sendall(b"12345678")
        assert _recv_all(c, 8) == b"123"
        c.close()
    finally:
        px.close()


def test_chaos_proxy_partition_then_heal_same_port(echo_upstream):
    px = ChaosProxy(echo_upstream)
    try:
        port = parse_addr(px.addr)[1][1]
        live = dial(px.addr, timeout=5)
        live.sendall(b"hi")
        assert _recv_all(live, 2) == b"hi"
        px.partition()
        with pytest.raises(OSError):
            dial(px.addr, timeout=1.0)
        live.settimeout(5)
        assert live.recv(1) == b""      # severed, not left dangling
        live.close()
        px.heal()
        assert parse_addr(px.addr)[1][1] == port
        c2 = dial(px.addr, timeout=5)
        c2.sendall(b"back")
        assert _recv_all(c2, 4) == b"back"
        c2.close()
    finally:
        px.close()


def test_chaos_proxy_blackhole_is_one_way(echo_upstream):
    px = ChaosProxy(echo_upstream)
    try:
        with pytest.raises(ValueError, match="up or down"):
            px.blackhole("sideways")
        c = dial(px.addr, timeout=5)
        px.blackhole("down")
        c.sendall(b"lost")
        c.settimeout(0.3)
        with pytest.raises(socket.timeout):
            c.recv(1)
        px.heal()
        c.sendall(b"found")
        assert _recv_all(c, 5) == b"found"
        c.close()
    finally:
        px.close()


# --- the pool and the remote spawner ----------------------------------------


def test_read_worker_pool_equals_the_jax_reader(tmp_path):
    p = tmp_path / "pool"
    for text in ("# fleet ledger\n\nhostA tcp://127.0.0.1:9001\nhostB tcp://127.0.0.1:9002\n"
                 "hostC tcp://127.0.0.1:9001\n",
                 "hostA tcp://1.2.3.4:5 extra\n", "# only comments\n\n"):
        p.write_text(text)
        out = []
        for read in (read_worker_pool, jax_worker.read_worker_pool):
            try:
                out.append([(e["host_id"], e["addr"], e["handle"]) for e in read(str(p))])
            except ValueError as e:
                out.append(str(e))
        assert out[0] == out[1], text
    p.write_text("hostA tcp://127.0.0.1:9001\nhostC tcp://127.0.0.1:9001\n")
    assert [e["host_id"] for e in read_worker_pool(str(p))] == ["hostC"]


def _pool(*pairs):
    return [{"host_id": h, "addr": a, "handle": None} for h, a in pairs]


def test_remote_spawner_quarantine_and_free_entries():
    sp = RemoteSpawner(_pool(("h0", "tcp://127.0.0.1:1"), ("h0", "tcp://127.0.0.1:2"),
                             ("h1", "tcp://127.0.0.1:3")), SERVE)
    assert sp.hosts_active == 2 and len(sp._free_entries()) == 3
    sp.mark_host_dead("h0")
    assert sp.hosts_active == 1
    assert [e["addr"] for e in sp._free_entries()] == ["tcp://127.0.0.1:3"]
    sp.readmit("h0")
    assert sp.hosts_active == 2 and len(sp._free_entries()) == 3

    class H:
        _dead = None

    sp.pool[2]["handle"] = H()           # a live handle: in use
    assert len(sp._free_entries()) == 2
    sp.pool[2]["handle"]._dead = "heartbeat loss"
    assert len(sp._free_entries()) == 3


def test_remote_spawner_budget_and_quarantine_give_up_loudly():
    sp = RemoteSpawner(_pool(("h0", "tcp://127.0.0.1:1")), SERVE, max_respawns=0,
                       respawn_backoff_s=0.0)

    class FakeRouter:
        n_failed = 1

    sp.router = FakeRouter()
    with pytest.raises(RuntimeError, match="respawn budget"):
        sp()
    assert sp.spawns == 0 and sp.respawns == 0
    sp = RemoteSpawner(_pool(("h0", "tcp://127.0.0.1:1"), ("h1", "tcp://127.0.0.1:2")), SERVE)
    sp.mark_host_dead("h0")
    sp.mark_host_dead("h1")
    with pytest.raises(RuntimeError, match="no adoptable worker"):
        sp()


def test_remote_spawner_poll_hosts_readmits_on_dial():
    lsock = create_listener("tcp://127.0.0.1:0")
    addr = listener_addr(lsock)
    lsock.close()                       # host down: dials refused
    sp = RemoteSpawner(_pool(("h9", addr)), SERVE)
    sp.mark_host_dead("h9")
    assert sp.poll_hosts() == [] and sp.dead_hosts == {"h9"}
    lsock = create_listener(addr)       # the same port again: the host is back
    try:
        assert sp.poll_hosts() == ["h9"]
        assert sp.dead_hosts == set() and sp.hosts_active == 1
    finally:
        lsock.close()


@pytest.fixture()
def fake_worker():
    """A torch-free stand-in for a TCP worker: a real listener and the real
    hello, a fake engine payload. Yields ``start(serve, token)`` -> addr."""
    socks = []

    def start(serve, token):
        lsock = create_listener("tcp://127.0.0.1:0")
        socks.append(lsock)
        payload = {"ok": True, "wire_version": WIRE_VERSION,
                   "serve": dataclasses.asdict(serve), "kv_pool_bytes_per_device": 0,
                   "pid": 4242, "stats": None}

        def accept_loop():
            while True:
                try:
                    conn, _ = lsock.accept()
                except OSError:
                    return
                try:
                    msg = recv_msg(conn, peer="frontend")
                    if server_hello(conn, msg, token, peer="frontend"):
                        send_msg(conn, payload, peer="frontend")
                        recv_msg(conn, peer="frontend")   # park until close
                except WireError:
                    pass
                finally:
                    conn.close()

        threading.Thread(target=accept_loop, daemon=True).start()
        return listener_addr(lsock)

    yield start
    for s in socks:
        s.close()


def test_remote_spawner_adopts_an_authenticated_worker(fake_worker):
    addr = fake_worker(SERVE, b"fleet-secret")
    sp = RemoteSpawner(_pool(("hA", addr)), SERVE, connect_timeout_s=10.0,
                       auth_token=b"fleet-secret")
    h = sp()
    assert (h.host_id, h.pid, h.proc, h.peer) == ("hA", 4242, None, addr)
    assert sp.pool[0]["handle"] is h and sp.spawns == 1
    h.close()           # remote: disconnect only, never a kill
    assert h._dead == "closed"
    with pytest.raises(RuntimeError, match="remote"):
        h.kill()


@pytest.mark.parametrize("case", ["wrong token", "ServeConfig mismatch"])
def test_remote_spawner_refuses_and_adopts_nothing(fake_worker, case):
    if case == "wrong token":
        addr, match = fake_worker(SERVE, b"worker-token"), "mutual authentication"
    else:
        addr = fake_worker(ServeConfig(max_batch=4, block_size=8, num_blocks=8), None)
        match = "different ServeConfig"
    sp = RemoteSpawner(_pool(("hA", addr)), SERVE, connect_timeout_s=10.0,
                       auth_token=b"frontend-token" if case == "wrong token" else None)
    with pytest.raises(RuntimeError, match=match):
        sp()
    assert sp.pool[0]["handle"] is None and sp.spawns == 0


# --- host failure domains with doubles --------------------------------------


class _FakeReq:
    def __init__(self, rid):
        self.id = rid
        self.generated = [1, 2, 3]
        self.replica = None
        self.finish_reason = None

    def _finish(self, reason):
        self.finish_reason = reason


class _FakeEngine:
    def __init__(self, host_id, serve):
        self.host_id = host_id
        self.serve = serve
        self.inflight = []
        self.adopted = []
        self.queue_depth = 0
        self.stats = collections.defaultdict(float)
        self.kv_pool_bytes_per_device = 0
        self.reason = None          # what check_health reports

    @property
    def occupancy(self):
        return len(self.inflight)

    def has_work(self):
        return False

    def check_health(self):
        return self.reason

    def extract_inflight(self):
        out, self.inflight = self.inflight, []
        return out

    def adopt(self, req):
        self.adopted.append(req)
        self.inflight.append(req)


class _FakeHostSpawner:
    """make_engine with the host-quarantine surface RemoteSpawner has."""

    def __init__(self, hosts):
        self.hosts = list(hosts)
        self.dead_hosts = set()
        self.marked = []
        self.polled = 0

    def __call__(self):
        return _FakeEngine(self.hosts.pop(0) if self.hosts else "spare", SERVE)

    def mark_host_dead(self, host_id):
        self.marked.append(host_id)
        self.dead_hosts.add(host_id)

    def poll_hosts(self):
        self.polled += 1
        rejoined = sorted(self.dead_hosts)
        self.dead_hosts.clear()
        return rejoined

    @property
    def hosts_active(self):
        return 2 - len(self.dead_hosts)


def test_fail_host_contains_a_domain_as_one_batch():
    """Every replica of the lost host is FAILED before the one adopt wave
    (no stream lands on a dying sibling), and the spawner is quarantined
    first."""
    sp = _FakeHostSpawner(["h0", "h0", "h1", "h1"])
    router = ReplicaRouter(sp, replicas=4, policy="round_robin")
    reqs = [_FakeReq(1), _FakeReq(2), _FakeReq(3)]
    router.engines[0].inflight.extend(reqs[:2])
    router.engines[1].inflight.append(reqs[2])
    assert router.fail_host("h0") == 3
    assert (router.host_failures, router.replica_failures, router.migrated) == (1, 2, 3)
    assert sp.marked == ["h0"] and router.active_indices() == [2, 3]
    assert router.failed_indices() == [0, 1]
    assert all(r.finish_reason is None and r.replica in (2, 3) for r in reqs)
    assert router.engines[0].adopted == [] and router.engines[1].adopted == []
    assert router.fail_host("h0") == 0 and router.fail_host("h7") == 0
    m = router.metrics_snapshot()
    assert (m["host_failures"], m["hosts_active"], m["worker_restarts"]) == (1.0, 1.0, 0.0)


def test_fail_host_last_resort_growth_lands_on_a_survivor():
    sp = _FakeHostSpawner(["h0", "h0", "h1"])
    router = ReplicaRouter(sp, replicas=2, max_replicas=3, policy="round_robin")
    reqs = [_FakeReq(1), _FakeReq(2)]
    router.engines[0].inflight.append(reqs[0])
    router.engines[1].inflight.append(reqs[1])
    assert router.fail_host("h0") == 2
    assert len(router.engines) == 3 and router.engines[2].host_id == "h1"
    assert all(r.replica == 2 for r in reqs) and router.engines[2].adopted == reqs
    assert router.poll_hosts() == ["h0"] and sp.polled == 1
    assert router.poll_hosts() == []             # nothing quarantined now


def test_a_give_up_in_last_resort_growth_finishes_the_requests_failed():
    spawned = []

    def spawn_once():
        if spawned:
            raise RuntimeError("worker respawn budget exhausted")
        spawned.append(_FakeEngine(None, SERVE))
        return spawned[-1]

    router = ReplicaRouter(spawn_once, replicas=1, max_replicas=2)
    req = _FakeReq(1)
    router.engines[0].inflight.append(req)
    assert router.fail_replica(0) == 0 and req.finish_reason == "failed"


def test_health_sweep_tells_a_hosts_death_from_one_workers():
    """All of host a's workers failing in one sweep is one host death; one
    of host b's two failing is a replica failure; a host-less handle is a
    replica failure too."""
    sp = _FakeHostSpawner(["a", "a", "b", "b", None])
    router = ReplicaRouter(sp, replicas=5, policy="round_robin")
    driver = EngineDriver(router)
    assert driver._check_worker_health() is False
    for i in (0, 1, 2, 4):
        router.engines[i].reason = "heartbeat loss"
    assert driver._check_worker_health() is True
    assert router.host_failures == 1 and sp.marked == ["a"]
    assert router.failed_indices() == [0, 1, 2, 4] and router.replica_failures == 4
    driver.close()


# --- a real TCP fleet behind chaos proxies ----------------------------------

FP32_WORKER = (
    "import sys, torch\n"
    "from gpt_2_distributed_torch.serving import engine\n"
    "engine.ServingEngine.__init__.__kwdefaults__['compute_dtype'] = torch.float32\n"
    "from gpt_2_distributed_torch.serving.frontend import worker\n"
    "worker.main(sys.argv[1:])\n"
)
REQS = [([5, 6, 7], 8), ([9, 10], 10), ([1, 2, 3, 4], 8), ([11, 12], 12)]


def test_a_partitioned_host_is_contained_and_rejoins_after_heal(tiny_config, tmp_path):
    """Workers on hosts A and B (``--socket tcp://127.0.0.1:0 --advertise``),
    each behind a ChaosProxy; A partitioned at fleet step 4: one host death,
    the streams finish on B equal to the in-process engine's (sampled), no
    token emitted twice; after ``heal()`` the dial probe re-admits A."""
    jax_params = jax.tree_util.tree_map(np.asarray, jax_gpt2.init_params(tiny_config, seed=0))
    npz = str(tmp_path / "w.npz")
    save_npz(npz, jax_params)
    ledger, token = str(tmp_path / "advertised"), str(tmp_path / "token")
    with open(token, "w") as f:
        f.write("fleet-test-secret\n")
    flags = ["--params_npz", npz, "--model", "124M", "--n_layer", "2", "--n_embd", "32",
             "--n_head", "2", "--vocab_size", "257", "--seq_len", "64", "--max_batch", "4",
             "--block_size", "8", "--num_blocks", "32", "--device", "cpu",
             "--temperature", "0.9", "--top_k", "40", "--socket", "tcp://127.0.0.1:0",
             "--advertise", ledger, "--auth_token_file", token]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", FP32_WORKER, *flags, "--host_id", h],
                              cwd=REPO, env=env, stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL) for h in ("A", "B")]
    proxies = []
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                if len(read_worker_pool(ledger)) == 2:
                    break
            except (OSError, ValueError):
                pass
            assert all(p.poll() is None for p in procs), "a worker died during startup"
            assert time.monotonic() < deadline, "the fleet never advertised"
            time.sleep(0.1)
        pool = []
        for e in sorted(read_worker_pool(ledger), key=lambda e: e["host_id"]):
            proxies.append(ChaosProxy(e["addr"]))
            pool.append({"host_id": e["host_id"], "addr": proxies[-1].addr, "handle": None})
        sc = ServeConfig(max_batch=4, block_size=8, num_blocks=32)
        sp = RemoteSpawner(pool, sc, initial_replicas=1, respawn_backoff_s=0.0,
                           heartbeat_s=0.05, heartbeat_timeout_s=1.0, connect_timeout_s=120.0,
                           auth_token=load_auth_token(token))
        router = ReplicaRouter(sp, replicas=1, max_replicas=2, policy="round_robin")
        sp.router = router
        assert [h.host_id for h in router.engines] == ["A"]   # the pool's first entry
        driver = EngineDriver(router, autoscaler=Autoscaler(router, min_replicas=1,
                                                            max_replicas=2))
        counts: dict[int, int] = {}
        hs = [driver.submit(p, n, seed=100 + i,
                            on_token=lambda h, _t: counts.__setitem__(h.id,
                                                                      counts.get(h.id, 0) + 1))
              for i, (p, n) in enumerate(REQS)]
        while driver.has_work():
            if driver.steps == 4 and not sp.dead_hosts:
                proxies[0].partition()
                time.sleep(0.1)     # past --worker_heartbeat_s: the sweep probes
            driver.step()
        assert router.host_failures == 1 and router.failed_indices() == [0]
        assert [e.host_id for e in router.engines] == ["A", "B"] and sp.respawns == 1
        assert sp.dead_hosts == {"A"} and sp.hosts_active == 1
        assert counts == {h.id: len(h.generated) for h in hs}
        params = params_from_jax(jax_params)
        cfg = GPT2Config(vocab_size=257, n_positions=64, n_embd=32, n_layer=2, n_head=2)
        eng = ServingEngine(params, cfg, sc, device="cpu", temperature=0.9, top_k=40,
                            compute_dtype=torch.float32)
        want = [eng.submit(p, n, seed=100 + i) for i, (p, n) in enumerate(REQS)]
        eng.run_until_idle()
        assert [h.generated for h in hs] == [h.generated for h in want]

        proxies[0].heal()
        deadline = time.monotonic() + 15
        while sp.dead_hosts and time.monotonic() < deadline:
            router.poll_hosts()
            time.sleep(0.1)
        assert sp.dead_hosts == set() and sp.hosts_active == 2
        driver.close()
        assert all(e._dead is not None for e in router.engines)
        assert all(p.poll() is None for p in procs)     # the fleet outlives its frontend
    finally:
        for px in proxies:
            px.close()
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
