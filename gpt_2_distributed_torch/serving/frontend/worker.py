"""Process-isolated serving replicas: one ServingEngine per worker process
(``gpt_2_distributed_tpu/serving/frontend/worker.py``).

``--placement subprocess`` moves each replica out of the frontend process
into a child hosting exactly one :class:`ServingEngine` on the frontend's
``--device`` (with ``cuda``, every worker of a host shares its first card;
on the CPU each worker runs one intra-op thread, ``resilience.worker_env``).
The frontend talks to it over a length-prefixed JSON RPC on a Unix socket
(``rpc.py``) through :class:`WorkerHandle`, which duck-types the engine
surface the ``EngineDriver`` / ``ReplicaRouter`` stack consumes — submit /
step / drain / extract / adopt / heartbeat — so ``serve.py``, ``server.py``
and the autoscaler run unchanged in every placement. ``--placement
remote`` adopts pre-started workers listening on TCP instead
(:class:`RemoteSpawner`), each host a failure domain of its own.

Why: in-process placement means shared fate. On a GPU some CUDA errors are
sticky (an illegal address in a kernel, an Xid, an ECC fault): after one
the CUDA context of the whole process is unusable, and every replica in
it dies with the HTTP server. With one process per replica the blast
radius is the process: SIGKILL, a nonzero exit, heartbeat loss or a stuck
RPC all surface as a broken or timed-out socket on the frontend side,
which trips the driver's containment path for raising steps, and that
path can no longer be wedged by the failure itself.

Exactness across the boundary: the frontend keeps a **mirror**
:class:`RequestHandle` per request in flight, updated from each step
reply (emitted tokens, first-token stamps, and the sampling generators'
states from ``ServingEngine.decode_keys``). The mirrors therefore hold
exactly what ``extract_inflight`` would capture at the last completed
step boundary, so when a worker dies *without* a goodbye (SIGKILL
mid-decode) migration proceeds from the mirrors with zero re-emitted
tokens and the resumed streams stay equal to ``generate_cached(batch=1)``.
A partly received step reply is discarded whole (framing makes torn
replies detectable), which is the same as the step never having happened.
A mirror holds its generator as the state dict the worker sent
(``RequestHandle._gen_state``) and never builds a ``torch.Generator``: a
CUDA one would open a CUDA context in the frontend. The engine that adopts
the request builds it on its own device.

Respawn: :class:`WorkerSpawner` is the router's ``make_engine``; when the
autoscaler's below-min replacement path calls ``router.grow()`` after a
failure, the spawner detects the respawn (fleet failures exceed
replacements so far), applies exponential backoff, burns one unit of the
``--worker_max_respawns`` budget, and raises RuntimeError loudly when the
budget is gone (``scripts/supervise.sh``'s MAX_RESTARTS / RESTART_DELAY /
give up loudly, applied per fleet).

The frontend side imports no torch (``config.py``, ``rpc.py`` and the
tracer are torch-free): the worker CLI binds its socket *before* the torch
import, so the parent's connect retry has something to connect to during
the slow engine build, and the CLIs validate flags before paying for it.
Run a worker as ``python -m gpt_2_distributed_torch.serving.frontend.worker``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

from gpt_2_distributed_torch.config import ServeConfig
from gpt_2_distributed_torch.obs.trace import get_tracer
from gpt_2_distributed_torch.resilience import worker_env
from gpt_2_distributed_torch.serving.frontend.rpc import (
    WIRE_VERSION,
    WireError,
    client_hello,
    create_listener,
    describe_peer,
    dial,
    listener_addr,
    load_auth_token,
    recv_msg,
    send_msg,
    server_hello,
)

WORKER_MODULE = "gpt_2_distributed_torch.serving.frontend.worker"

# ----------------------------------------------------------------- handle


class _PrefixCacheProxy:
    """Read-only stand-in for the worker engine's PrefixCache: the router's
    affinity probe only calls ``peek_run``, which becomes one RPC. Probe
    failures return 0 (cold): routing must never die with a replica."""

    def __init__(self, handle: "WorkerHandle"):
        self._handle = handle

    def peek_run(self, prompt) -> int:
        try:
            reply = self._handle._rpc({"op": "peek_run", "prompt": [int(t) for t in prompt]})
            return int(reply["run"])
        except (WireError, RuntimeError, ValueError):
            return 0


class WorkerHandle:
    """Frontend-side proxy for one worker process, duck-typing the
    ``ServingEngine`` surface the router and driver consume. All RPC is
    synchronous request-reply on one socket; any framing failure (EOF,
    timeout, torn frame) marks the handle dead and raises
    :class:`WireError`, which the driver's containment wrapper turns into
    ``fail_replica`` + migration from the request mirrors."""

    def __init__(
        self,
        proc: subprocess.Popen | None,
        sock: socket.socket,
        serve: ServeConfig,
        *,
        kv_pool_bytes_per_device: int = 0,
        rpc_timeout_s: float = 300.0,
        heartbeat_s: float = 1.0,
        heartbeat_timeout_s: float | None = None,
        stats: dict | None = None,
        host_id: str | None = None,
        peer: str | None = None,
        pid: int | None = None,
    ):
        # ``proc`` is None for remote workers: the fleet owns those
        # processes, the frontend only owns the TCP connection. A non-None
        # ``host_id`` marks the handle as belonging to a host failure
        # domain (only remote handles carry one; local placements keep
        # per-replica containment).
        self.proc = proc
        self.pid = proc.pid if proc is not None else pid
        self.host_id = host_id
        self.peer = peer or describe_peer(sock)
        self._label = (f"pid={self.pid}" if proc is not None
                       else f"{self.peer} (host {host_id or '?'})")
        self._sock = sock
        self.serve = serve
        self.kv_pool_bytes_per_device = int(kv_pool_bytes_per_device)
        self.rpc_timeout_s = float(rpc_timeout_s)
        self.heartbeat_s = float(heartbeat_s)
        # The heartbeat reply deadline is a flag: a cross-host budget must
        # not be derived from the local-socket cadence.
        self.heartbeat_timeout_s = (float(heartbeat_timeout_s) if heartbeat_timeout_s is not None
                                    else max(self.heartbeat_s * 5.0, 2.0))
        self._dead: str | None = None
        self._inflight: dict[int, object] = {}  # rid -> mirror RequestHandle
        self._stats: dict = dict(stats or {})
        self._queue_depth = 0
        self._occupancy = 0
        self._last_rpc = time.monotonic()
        self._hb_seq = 0
        self._cache_proxy = _PrefixCacheProxy(self) if serve.prefix_cache else None

    # ------------------------------------------------------------ plumbing

    def _mark_dead(self, reason: str) -> None:
        if self._dead is not None:
            return
        self._dead = reason
        try:
            self._sock.close()
        except OSError:
            pass
        # Reap the process whatever state it is in: SIGKILL also moves a
        # SIGSTOPped worker along, so a frozen child never lingers holding
        # its card memory. Remote workers have no local process: dropping
        # the connection is the whole containment (the fleet supervises
        # the process itself).
        if self.proc is None:
            return
        if self.proc.poll() is None:
            try:
                self.proc.kill()
            except OSError:
                pass
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass

    def _rpc(self, obj: dict, timeout: float | None = None) -> dict:
        """One request-reply round trip. A recv timeout is FATAL by design:
        the stream cannot be resynced once a reply may arrive late, so the
        handle is marked dead rather than risk a stale frame being read as
        the next call's reply."""
        if self._dead is not None:
            raise WireError(f"worker {self._label} is dead: {self._dead}")
        self._sock.settimeout(self.rpc_timeout_s if timeout is None else timeout)
        try:
            send_msg(self._sock, obj, peer=self.peer)
            reply = recv_msg(self._sock, peer=self.peer)
        except WireError as e:
            self._mark_dead(f"rpc {obj.get('op')!r} failed: {e}")
            raise
        self._last_rpc = time.monotonic()
        if not reply.get("ok"):
            err = reply.get("error", "worker error")
            if reply.get("error_type") == "ValueError":
                raise ValueError(err)
            raise RuntimeError(f"worker {self._label} {obj.get('op')!r}: {err}")
        return reply

    def _apply(self, reply: dict) -> None:
        """Fold a step/drain reply into the request mirrors. Fields are set
        directly, never through ``_emit``/``_finish``: the worker already
        traced the first_token and finish events into its own trace file,
        and tracing them again here would double every request row in the
        merged report."""
        for rid, ts in reply.get("first", {}).items():
            h = self._inflight.get(int(rid))
            if h is not None and h.first_token_time is None:
                h.first_token_time = float(ts)
        for rid, tok in reply.get("events", ()):
            h = self._inflight.get(int(rid))
            if h is None:
                continue
            h.generated.append(int(tok))
            if h.on_token is not None:
                h.on_token(h, int(tok))
        for rid, state in reply.get("generators", {}).items():
            h = self._inflight.get(int(rid))
            if h is not None:
                h._gen_state = state
        for f in reply.get("finished", ()):
            h = self._inflight.pop(int(f["rid"]), None)
            if h is None:
                continue
            h.first_token_time = f["first_token_time"]
            h.finish_time = f["finish_time"]
            h.queue_wait_ms = float(f["queue_wait_ms"])
            h.preemptions = int(f["preemptions"])
            h.resumes = int(f["resumes"])
            h.prefix_cached_tokens = int(f["prefix_cached_tokens"])
            h.finish_reason = f["reason"]
            h.done = True   # last: the driver's finish watch keys on it
        self._queue_depth = int(reply.get("queue_depth", 0))
        self._occupancy = int(reply.get("occupancy", 0))
        if "stats" in reply:
            self._stats = reply["stats"]

    # ------------------------------------------------------ engine surface

    def submit(self, prompt, max_new_tokens, *, seed=0, on_token=None, rid=None,
               timeout_s=None):
        # The mirror is the engine's own handle type; importing the engine
        # module imports torch but touches no device.
        from gpt_2_distributed_torch.serving.engine import RequestHandle

        prompt = [int(t) for t in prompt]
        reply = self._rpc({
            "op": "submit", "prompt": prompt, "max_new_tokens": int(max_new_tokens),
            "seed": int(seed), "rid": rid, "timeout_s": timeout_s,
        })
        req = RequestHandle(int(reply["rid"]), prompt, int(max_new_tokens), on_token)
        req._gen_state = reply["generator"]
        req.submit_time = reply["submit_time"]
        req.deadline = reply["deadline"]
        self._inflight[req.id] = req
        self._queue_depth = int(reply.get("queue_depth", 0))
        self._occupancy = int(reply.get("occupancy", 0))
        return req

    def step(self) -> int:
        reply = self._rpc({"op": "step"})
        self._apply(reply)
        return int(reply["emitted"])

    def run_until_idle(self, max_steps: int | None = None) -> int:
        reply = self._rpc({"op": "drain", "max_steps": max_steps})
        self._apply(reply)
        return int(reply["emitted"])

    def has_work(self) -> bool:
        # Exact, not cached: every live mirror is a request the worker has
        # queued or in flight. A dead worker with mirrors still reports
        # work, so the driver steps it, hits WireError, and contains it.
        return bool(self._inflight)

    @property
    def queue_depth(self) -> int:
        return self._queue_depth

    @property
    def occupancy(self) -> int:
        return self._occupancy

    @property
    def prefix_cache(self):
        return self._cache_proxy

    @property
    def stats(self) -> dict:
        return self._stats

    @stats.setter
    def stats(self, _value) -> None:
        # Resetting stats by assigning a zeroed dict becomes a reset RPC
        # across the process boundary (the value is ignored: the worker
        # zeroes its own dict and returns it).
        self._stats = self._rpc({"op": "reset_stats"})["stats"]

    def metrics_snapshot(self) -> dict:
        try:
            return self._rpc({"op": "metrics_snapshot"})["metrics"]
        except (WireError, RuntimeError):
            return {}

    def clear_prefix_cache(self) -> None:
        self._rpc({"op": "clear_prefix_cache"})

    # -------------------------------------------------- migration surface

    def extract_inflight(self) -> list:
        """Terminal: detach every live request for migration, then put the
        worker down. The preferred source is the worker itself (it holds
        admission order and the freshest accounting); when the process is
        already dead the mirrors take over: they carry the same tokens and
        generator state as of the last completed step, which is exactly the
        preempt-at-boundary state, so resumption re-emits nothing. A worker
        that answers the extract with an error (its CUDA context lost to a
        sticky error, say) is treated as dead: the mirrors take over."""
        out, seen = [], set()
        wires = None
        if self._dead is None:
            try:
                wires = self._rpc({"op": "extract"})["requests"]
            except (RuntimeError, ValueError):
                # The link broke (WireError), or the worker answered with an
                # error: after a sticky CUDA error its engine cannot even
                # read its generators back. The mirrors stand in for it.
                wires = None
        for d in wires or ():
            rid = int(d["rid"])
            h = self._inflight.pop(rid, None)
            if h is None:
                continue
            h.generated = [int(t) for t in d["generated"]]
            h._gen_state = d["generator"]
            h._pending_token = d["pending_token"]
            h.queue_wait_ms = float(d["queue_wait_ms"])
            h.preemptions = int(d["preemptions"])
            h.resumes = int(d["resumes"])
            h.prefix_cached_tokens = int(d["prefix_cached_tokens"])
            seen.add(rid)
            out.append(h)
        # Mirror fallback (a dead worker), plus any mirror the worker did
        # not report: last-known tokens and generator state, pending = the
        # last sampled token so the resume decodes it without re-emitting.
        for rid, h in list(self._inflight.items()):
            if rid in seen or h.done:
                continue
            h._pending_token = h.generated[-1] if h.generated else None
            out.append(h)
        self._inflight.clear()
        self._mark_dead("extracted")
        return out

    def adopt(self, req) -> None:
        wire = req.to_wire()
        self._rpc({"op": "adopt", "request": wire})
        # From here the handle is this worker's mirror: its generator is
        # the state the worker rebuilt, never a live one in this process.
        req._gen, req._gen_state = None, wire["generator"]
        self._inflight[req.id] = req

    # ------------------------------------------------------- supervision

    def check_health(self) -> str | None:
        """Liveness probe the driver runs every step: a non-None return is
        the failure reason and the replica must be contained. Cheap on the
        happy path: the heartbeat RPC only fires after an idle gap (active
        stepping refreshes ``_last_rpc`` constantly)."""
        if self._dead is not None:
            return self._dead
        if self.proc is not None:
            rc = self.proc.poll()
            if rc is not None:
                self._mark_dead(f"worker exit rc={rc}")
                return self._dead
        if time.monotonic() - self._last_rpc < self.heartbeat_s:
            return None
        if not self._heartbeat():
            extra = {"host_id": self.host_id} if self.host_id else {}
            get_tracer().event("heartbeat_loss", ts=time.monotonic(), pid=self.pid, **extra)
            self._mark_dead("heartbeat loss")
            return self._dead
        return None

    def _heartbeat(self, attempts: int = 2) -> bool:
        """Bounded-retry heartbeat. Replies carry the request's sequence
        number, so a reply that arrives after its attempt timed out is
        recognizably stale and drained by the next attempt instead of
        desyncing the stream (the only RPC where a late reply is safe)."""
        for _ in range(attempts):
            self._hb_seq += 1
            want = self._hb_seq
            try:
                self._sock.settimeout(self.heartbeat_timeout_s)
                send_msg(self._sock, {"op": "heartbeat", "seq": want})
                while True:
                    reply = recv_msg(self._sock)
                    if reply.get("seq") == want:
                        self._last_rpc = time.monotonic()
                        return True
                    # a stale reply from a timed-out earlier attempt: drain
            except WireError as e:
                if "timed out" in str(e):
                    continue    # retry within budget
                return False    # EOF/reset: no point retrying
        return False

    def kill(self, sig: int = signal.SIGKILL) -> None:
        """Deliver a real signal to the worker process (chaos runs)."""
        if self.proc is None:
            raise RuntimeError(
                f"worker {self._label} is remote — no local process to signal "
                "(use the network-chaos proxy instead)"
            )
        os.kill(self.pid, sig)

    def close(self) -> None:
        """Graceful shutdown: ask, wait, then escalate. A remote worker is
        only *disconnected*: its process belongs to the fleet and keeps
        listening for the next frontend."""
        if self.proc is None:
            self._mark_dead("closed")
            return
        if self._dead is None:
            try:
                self._rpc({"op": "shutdown"}, timeout=10.0)
            except (WireError, RuntimeError):
                pass
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass
        self._mark_dead("closed")


# ---------------------------------------------------------------- spawner


class _RespawnBudget:
    """The respawn accounting :class:`WorkerSpawner` and
    :class:`RemoteSpawner` share. After router construction the owner
    attaches the router (``spawner.router = router``); a spawn is a
    *respawn* when the fleet has seen more failures than the spawner has
    replaced, which is exactly when the autoscaler's below-min replacement
    path (or the router's last-resort grow) asks for a replacement rather
    than scale-up capacity. A respawn sleeps ``backoff * 2**(n-1)``
    (blocking the driver thread on purpose: a crash-looping worker must
    not spin the fleet) and burns one unit of the budget; past the budget
    it raises RuntimeError before spawning anything."""

    router = None         # attached by the owner after construction
    spawns = 0
    respawns = 0          # -> router metric "worker_restarts"

    def _is_respawn(self) -> bool:
        if self.router is not None:
            return getattr(self.router, "n_failed", 0) > self.respawns
        return self.spawns >= self.initial_replicas

    def _before_spawn(self, label: str, detail: str = "") -> None:
        if not self._is_respawn():
            return
        n = self.respawns + 1
        if n > self.max_respawns:
            raise RuntimeError(
                f"worker respawn budget exhausted: {self.respawns} respawns used of "
                f"--worker_max_respawns={self.max_respawns} — fleet degrades, giving "
                f"up on replacement (supervise.sh semantics)"
            )
        backoff = self.respawn_backoff_s * (2.0 ** (n - 1))
        get_tracer().event("worker_respawn", ts=time.monotonic(), respawn=n, backoff_s=backoff)
        print(f"[{label}] respawn {n}/{self.max_respawns} after {backoff:.1f}s "
              f"backoff{detail}", file=sys.stderr)
        if backoff > 0:
            time.sleep(backoff)
        self.respawns = n


class WorkerSpawner(_RespawnBudget):
    """``make_engine`` for subprocess placement: each call spawns one
    worker process and returns a connected :class:`WorkerHandle`."""

    def __init__(
        self,
        argv: list[str],
        serve: ServeConfig,
        *,
        initial_replicas: int = 1,
        max_respawns: int = 3,
        respawn_backoff_s: float = 2.0,
        rpc_timeout_s: float = 300.0,
        heartbeat_s: float = 1.0,
        heartbeat_timeout_s: float | None = None,
        connect_timeout_s: float = 120.0,
        auth_token: bytes | None = None,
        env: dict | None = None,
    ):
        self.argv = list(argv)
        self.serve = serve
        self.initial_replicas = int(initial_replicas)
        self.max_respawns = int(max_respawns)
        self.respawn_backoff_s = float(respawn_backoff_s)
        self.rpc_timeout_s = float(rpc_timeout_s)
        self.heartbeat_s = float(heartbeat_s)
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.connect_timeout_s = float(connect_timeout_s)
        self.auth_token = auth_token
        self.env = env
        self._socket_dir = tempfile.mkdtemp(prefix="gpt2-workers-")

    def __call__(self) -> WorkerHandle:
        self._before_spawn("worker-spawner")
        path = os.path.join(self._socket_dir, f"w{self.spawns}.sock")
        proc = subprocess.Popen(self.argv + ["--socket", path], env=self.env)
        try:
            sock = self._connect(proc, path)
            hello = self._hello(sock)
            serve = ServeConfig(**hello["serve"])
            if serve != self.serve:
                raise RuntimeError(
                    f"worker pid={proc.pid} built a different ServeConfig than the "
                    f"frontend expected: {serve} != {self.serve}"
                )
        except BaseException:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            raise
        self.spawns += 1
        get_tracer().event("worker_spawn", ts=time.monotonic(), pid=proc.pid,
                           spawn=self.spawns, respawn=self.respawns)
        return WorkerHandle(
            proc, sock, serve,
            kv_pool_bytes_per_device=hello["kv_pool_bytes_per_device"],
            rpc_timeout_s=self.rpc_timeout_s, heartbeat_s=self.heartbeat_s,
            heartbeat_timeout_s=self.heartbeat_timeout_s, stats=hello.get("stats"),
            peer=path,
        )

    def _connect(self, proc: subprocess.Popen, path: str) -> socket.socket:
        """Bounded connect retry: the worker binds and listens before its
        torch import, so the connect lands long before the engine is
        built; the hello timeout below absorbs the build itself."""
        deadline = time.monotonic() + self.connect_timeout_s
        while True:
            rc = proc.poll()
            if rc is not None:
                raise RuntimeError(f"worker died during startup (rc={rc}) before "
                                   f"binding {path}")
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                sock.connect(path)
                return sock
            except OSError:
                sock.close()
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"could not connect to worker socket {path} within "
                        f"--worker_connect_timeout_s={self.connect_timeout_s:g}s"
                    ) from None
                time.sleep(0.05)

    def _hello(self, sock: socket.socket) -> dict:
        # The hello waits out the worker's torch import, CUDA context,
        # weight load and (on a cold build dir) the kernels' nvcc.
        sock.settimeout(self.connect_timeout_s)
        return client_hello(sock, self.auth_token)


def worker_argv(args: argparse.Namespace, serve: ServeConfig) -> list[str]:
    """Worker command line from the frontend's parsed flags. The engine's
    shape comes from the RESOLVED ServeConfig (num_blocks already
    expanded), never re-derived from raw flags, so the worker provably
    builds the identical config: the spawner cross-checks it at hello."""
    argv = [sys.executable, "-m", WORKER_MODULE]
    if getattr(args, "ckpt", None):
        argv += ["--ckpt", args.ckpt]
    if getattr(args, "params_npz", None):
        argv += ["--params_npz", args.params_npz]
    if getattr(args, "init_random", False):
        argv += ["--init_random"]
    argv += ["--model", args.model]
    for k in ("n_layer", "n_embd", "n_head", "vocab_size", "seq_len"):
        v = getattr(args, k, None)
        if v is not None:
            argv += [f"--{k}", str(v)]
    argv += [
        "--max_batch", str(serve.max_batch),
        "--block_size", str(serve.block_size),
        "--num_blocks", str(serve.num_blocks),
        "--attn_impl", serve.attn_impl,
        "--prefill_chunk", str(serve.prefill_chunk),
        "--prefill_batch", str(serve.prefill_batch),
        "--admission", serve.admission,
        "--watermark_blocks", str(serve.watermark_blocks),
        "--temperature", str(args.temperature),
    ]
    if serve.eos_id is not None:
        argv += ["--eos", str(serve.eos_id)]
    if serve.prefix_cache:
        argv += ["--prefix_cache"]
    draft_preset, spec_k = serve.spec_axes()
    if draft_preset is not None:
        # The speculation shape from the RESOLVED config like the rest of
        # the engine geometry; only the draft checkpoint path is a raw flag.
        argv += ["--draft_preset", draft_preset, "--spec_k", str(spec_k)]
        if getattr(args, "draft_ckpt", None):
            argv += ["--draft_ckpt", args.draft_ckpt]
    if getattr(args, "top_k", None) is not None:
        argv += ["--top_k", str(args.top_k)]
    if getattr(args, "trace_dir", None):
        argv += ["--trace_dir", args.trace_dir,
                 "--trace_max_file_bytes", str(args.trace_max_file_bytes)]
    argv += ["--device", args.device]
    if getattr(args, "worker_auth_token_file", None):
        # The same handshake over AF_UNIX as over TCP: a token-bearing
        # frontend refuses ANY unauthenticated worker, so spawned children
        # must authenticate too.
        argv += ["--auth_token_file", args.worker_auth_token_file]
    return argv


def _supervision(args: argparse.Namespace) -> dict:
    """The supervision knobs both spawners take from the CLI flags."""
    token_file = args.worker_auth_token_file
    return dict(
        max_respawns=args.worker_max_respawns,
        respawn_backoff_s=args.worker_respawn_backoff_s,
        rpc_timeout_s=args.worker_rpc_timeout_s,
        heartbeat_s=args.worker_heartbeat_s,
        heartbeat_timeout_s=args.worker_heartbeat_timeout_s,
        connect_timeout_s=args.worker_connect_timeout_s,
        auth_token=load_auth_token(token_file) if token_file else None,
    )


def spawner_from_args(args: argparse.Namespace, serve: ServeConfig, *,
                      initial_replicas: int = 1) -> WorkerSpawner:
    """The one constructor both CLIs share for subprocess placement. Every
    worker runs on the frontend's ``--device``."""
    return WorkerSpawner(worker_argv(args, serve), serve, initial_replicas=initial_replicas,
                         env=worker_env(args.device), **_supervision(args))


# --------------------------------------------------------- remote spawner


def read_worker_pool(path: str) -> list[dict]:
    """Parse a worker-pool file: one ``host_id address`` pair per line
    (``#`` comments and blanks skipped). Workers append their own line via
    the worker CLI's ``--advertise FILE`` after binding, so the file
    doubles as a registration ledger. Duplicate addresses collapse to the
    last-registered host_id."""
    entries, seen = [], {}
    with open(path) as f:
        for ln, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) != 2:
                raise ValueError(f"{path}:{ln}: expected 'host_id address', got {line!r}")
            host_id, addr = parts
            if addr in seen:
                seen[addr]["host_id"] = host_id
                continue
            entry = {"host_id": host_id, "addr": addr, "handle": None}
            seen[addr] = entry
            entries.append(entry)
    if not entries:
        raise ValueError(f"worker pool file {path} names no workers")
    return entries


class RemoteSpawner(_RespawnBudget):
    """``make_engine`` for remote placement: each call ADOPTS one
    pre-started TCP worker from the ``--worker_pool`` fleet rather than
    spawning a process — the fleet owns worker lifecycles, the frontend
    owns connections. Respawn accounting is :class:`_RespawnBudget`'s; what
    differs is *placement*: replacements land on surviving hosts only, and
    a host the driver declared dead stays quarantined until a dial probe
    (``poll_hosts``) reaches it again, which re-admits the whole host with
    a ``host_joined`` trace event."""

    def __init__(
        self,
        pool: list[dict],
        serve: ServeConfig,
        *,
        initial_replicas: int = 1,
        max_respawns: int = 3,
        respawn_backoff_s: float = 2.0,
        rpc_timeout_s: float = 300.0,
        heartbeat_s: float = 1.0,
        heartbeat_timeout_s: float | None = None,
        connect_timeout_s: float = 120.0,
        auth_token: bytes | None = None,
    ):
        self.pool = pool
        self.serve = serve
        self.initial_replicas = int(initial_replicas)
        self.max_respawns = int(max_respawns)
        self.respawn_backoff_s = float(respawn_backoff_s)
        self.rpc_timeout_s = float(rpc_timeout_s)
        self.heartbeat_s = float(heartbeat_s)
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.connect_timeout_s = float(connect_timeout_s)
        self.auth_token = auth_token
        self.dead_hosts: set[str] = set()

    # --------------------------------------------------- host quarantine

    def mark_host_dead(self, host_id: str) -> None:
        self.dead_hosts.add(host_id)

    def readmit(self, host_id: str) -> None:
        self.dead_hosts.discard(host_id)

    def poll_hosts(self) -> list[str]:
        """Dial-probe every quarantined host; a host whose worker accepts a
        TCP connection again is re-admitted (eligible for placement on the
        next grow). Returns the re-admitted host_ids."""
        rejoined = []
        for host_id in sorted(self.dead_hosts):
            for entry in self.pool:
                if entry["host_id"] != host_id:
                    continue
                try:
                    dial(entry["addr"], timeout=1.0).close()
                except OSError:
                    continue
                self.readmit(host_id)
                rejoined.append(host_id)
                get_tracer().event("host_joined", ts=time.monotonic(), host_id=host_id)
                print(f"[remote-spawner] host {host_id} reachable again — re-admitted",
                      file=sys.stderr)
                break
        return rejoined

    @property
    def hosts_active(self) -> int:
        return len({e["host_id"] for e in self.pool} - self.dead_hosts)

    # -------------------------------------------------------- make_engine

    def _free_entries(self) -> list[dict]:
        return [e for e in self.pool
                if e["host_id"] not in self.dead_hosts
                and (e["handle"] is None or e["handle"]._dead is not None)]

    def __call__(self) -> WorkerHandle:
        self._before_spawn("remote-spawner",
                           f" (dead hosts: {sorted(self.dead_hosts) or 'none'})")
        errors = []
        for entry in self._free_entries():
            try:
                handle = self._adopt(entry)
            except (OSError, WireError, RuntimeError) as e:
                errors.append(f"{entry['addr']}: {e}")
                continue
            entry["handle"] = handle
            self.spawns += 1
            get_tracer().event("worker_spawn", ts=time.monotonic(), pid=handle.pid,
                               spawn=self.spawns, respawn=self.respawns,
                               host_id=entry["host_id"], addr=entry["addr"])
            return handle
        detail = "; ".join(errors) if errors else "every entry is in use"
        raise RuntimeError(
            f"no adoptable worker in the pool ({self.hosts_active} hosts active, "
            f"{len(self.dead_hosts)} quarantined): {detail}"
        )

    def _adopt(self, entry: dict) -> WorkerHandle:
        sock = dial(entry["addr"], timeout=self.connect_timeout_s)
        try:
            hello = client_hello(sock, self.auth_token, peer=entry["addr"])
            serve = ServeConfig(**hello["serve"])
            if serve != self.serve:
                raise RuntimeError(
                    f"worker at {entry['addr']} built a different ServeConfig than the "
                    f"frontend expected: {serve} != {self.serve}"
                )
        except BaseException:
            sock.close()
            raise
        return WorkerHandle(
            None, sock, serve,
            kv_pool_bytes_per_device=hello["kv_pool_bytes_per_device"],
            rpc_timeout_s=self.rpc_timeout_s, heartbeat_s=self.heartbeat_s,
            heartbeat_timeout_s=self.heartbeat_timeout_s, stats=hello.get("stats"),
            host_id=entry["host_id"], peer=entry["addr"], pid=hello.get("pid"),
        )


def remote_spawner_from_args(args: argparse.Namespace, serve: ServeConfig, *,
                             initial_replicas: int = 1) -> RemoteSpawner:
    """The shared constructor for ``--placement remote``: the pool file and
    the same supervision knobs as subprocess placement."""
    return RemoteSpawner(read_worker_pool(args.worker_pool), serve,
                         initial_replicas=initial_replicas, **_supervision(args))


# ------------------------------------------------------------- worker CLI


class _WorkerState:
    """Server-side bookkeeping: live handles, the per-reply token buffer
    the on_token callback fills, and which first-token stamps have been
    shipped to the frontend already."""

    def __init__(self, engine):
        self.engine = engine
        self.handles: dict[int, object] = {}
        self.buf: list[list[int]] = []
        self.first_sent: set[int] = set()

    def on_token(self, req, tok: int) -> None:
        self.buf.append([req.id, int(tok)])

    def register(self, req) -> None:
        self.handles[req.id] = req
        if req.first_token_time is not None:
            self.first_sent.add(req.id)   # adopted mid-stream: already known

    def collect(self, emitted: int, steps: int = 1) -> dict:
        """The step/drain reply: everything the frontend mirrors need to
        stay equal to a preempt-at-this-boundary snapshot."""
        eng = self.engine
        events, self.buf = self.buf, []
        first, finished = {}, []
        for rid, h in list(self.handles.items()):
            if h.first_token_time is not None and rid not in self.first_sent:
                self.first_sent.add(rid)
                first[str(rid)] = h.first_token_time
            if h.done:
                finished.append({
                    "rid": rid, "reason": h.finish_reason,
                    "finish_time": h.finish_time,
                    "first_token_time": h.first_token_time,
                    "queue_wait_ms": h.queue_wait_ms,
                    "preemptions": h.preemptions, "resumes": h.resumes,
                    "prefix_cached_tokens": h.prefix_cached_tokens,
                    "n_generated": len(h.generated),
                })
                del self.handles[rid]
                self.first_sent.discard(rid)
        return {
            "ok": True, "emitted": emitted, "steps": steps,
            "events": events, "first": first,
            "generators": {str(r): g for r, g in eng.decode_keys().items()},
            "finished": finished,
            "queue_depth": eng.queue_depth, "occupancy": eng.occupancy,
            "stats": eng.stats,
        }


def _dispatch(state: _WorkerState, msg: dict) -> tuple[dict, bool]:
    """(reply, keep_going) for one RPC."""
    from gpt_2_distributed_torch.serving.engine import RequestHandle

    eng = state.engine
    op = msg.get("op")
    if op == "heartbeat":
        return {"ok": True, "seq": msg.get("seq"), "ts": time.monotonic()}, True
    if op == "step":
        return state.collect(eng.step()), True
    if op == "drain":
        return state.collect(eng.run_until_idle(max_steps=msg.get("max_steps")), steps=-1), True
    if op == "submit":
        req = eng.submit(msg["prompt"], msg["max_new_tokens"], seed=msg["seed"],
                         on_token=state.on_token, rid=msg.get("rid"),
                         timeout_s=msg.get("timeout_s"))
        state.register(req)
        return {
            "ok": True, "rid": req.id, "generator": req.to_wire()["generator"],
            "submit_time": req.submit_time, "deadline": req.deadline,
            "queue_depth": eng.queue_depth, "occupancy": eng.occupancy,
        }, True
    if op == "extract":
        reqs = eng.extract_inflight()
        for r in reqs:
            state.handles.pop(r.id, None)
            state.first_sent.discard(r.id)
        return {"ok": True, "requests": [r.to_wire() for r in reqs]}, True
    if op == "adopt":
        req = RequestHandle.from_wire(msg["request"], state.on_token, device=eng.device)
        state.register(req)
        eng.adopt(req)
        return {"ok": True, "rid": req.id}, True
    if op == "peek_run":
        cache = eng.prefix_cache
        run = cache.peek_run(msg["prompt"]) if cache is not None else 0
        return {"ok": True, "run": int(run)}, True
    if op == "clear_prefix_cache":
        eng.clear_prefix_cache()
        return {"ok": True}, True
    if op == "reset_stats":
        eng.stats = {k: type(v)() for k, v in eng.stats.items()}
        return {"ok": True, "stats": eng.stats}, True
    if op == "metrics_snapshot":
        return {"ok": True, "metrics": eng.metrics_snapshot()}, True
    if op == "shutdown":
        return {"ok": True}, False
    return {"ok": False, "error_type": "WireError", "error": f"unknown op {op!r}"}, True


def _serve_loop(conn: socket.socket, state: _WorkerState, token: bytes | None = None) -> None:
    peer = describe_peer(conn)
    while True:
        try:
            msg = recv_msg(conn, peer=peer)
        except WireError:
            return  # frontend gone: nothing left to serve
        if msg.get("op") == "hello":
            # Version check, then (token given) the mutual HMAC challenge.
            # On refusal server_hello has already sent the error frame:
            # drop the connection with NO engine payload sent.
            if not server_hello(conn, msg, token, peer=peer):
                print(f"[worker pid={os.getpid()}] refused hello from {peer} "
                      f"(bad version or failed authentication)", file=sys.stderr)
                return
            eng = state.engine
            try:
                send_msg(conn, {
                    "ok": True, "wire_version": WIRE_VERSION, "pid": os.getpid(),
                    "serve": dataclasses.asdict(eng.serve),
                    "kv_pool_bytes_per_device": eng.kv_pool_bytes_per_device,
                    "stats": eng.stats,
                }, peer=peer)
            except WireError:
                # The peer vanished (or the link was cut) mid-handshake: a
                # fleet worker survives its clients.
                return
            continue
        try:
            reply, keep = _dispatch(state, msg)
        except Exception as e:  # noqa: BLE001 — every error crosses the wire
            reply, keep = {"ok": False, "error_type": type(e).__name__, "error": str(e)}, True
        try:
            send_msg(conn, reply)
        except WireError:
            return
        if not keep:
            return


def build_argparser() -> argparse.ArgumentParser:
    from gpt_2_distributed_torch.serving.serve import (
        add_engine_flags,
        add_model_flags,
        add_obs_flags,
    )

    p = argparse.ArgumentParser(
        description="serving replica worker: one ServingEngine behind a "
                    "length-prefixed JSON RPC. Spawned by the frontend over a "
                    "Unix socket (--placement subprocess) or run standalone "
                    "listening on tcp://host:port for a --placement remote "
                    "frontend to adopt")
    p.add_argument("--socket", required=True,
                   help="address to bind and serve RPC on: a Unix socket path, "
                        "or tcp://host:port (port 0 = ephemeral; pair with "
                        "--advertise)")
    p.add_argument("--auth_token_file", default=None,
                   help="shared-secret file: require every frontend to pass "
                        "the mutual HMAC challenge-response at hello before "
                        "any engine state moves")
    p.add_argument("--host_id", default=None,
                   help="failure-domain label reported to the fleet "
                        "(default: this machine's hostname)")
    p.add_argument("--advertise", default=None, metavar="FILE",
                   help="append 'host_id address' to FILE after binding — "
                        "registers this worker in a --worker_pool ledger "
                        "(resolves a port-0 bind)")
    add_model_flags(p)
    add_engine_flags(p)
    add_obs_flags(p)
    return p


def main(argv: list[str] | None = None) -> None:
    p = build_argparser()
    args = p.parse_args(argv)
    if sum((args.params_npz is not None, args.init_random, args.ckpt is not None)) != 1:
        p.error("exactly one of --ckpt / --params_npz / --init_random is required")
    token = load_auth_token(args.auth_token_file) if args.auth_token_file else None

    # Bind + listen BEFORE the torch import: the parent's connect succeeds
    # (backlog) while the engine is still building, and its hello timeout
    # covers the build. An orphaned socket file from a previous incarnation
    # is stale by construction (the spawner never reuses paths; TCP
    # listeners set SO_REUSEADDR). Advertise only after the bind, so the
    # ledger never names an address that was never live (and a port-0
    # bind resolves to its real port).
    is_tcp = args.socket.startswith("tcp://")
    try:
        lsock = create_listener(args.socket, backlog=8 if is_tcp else 1)
    except (ValueError, OSError) as e:
        p.error(f"--socket {args.socket!r}: {e}")
    bound = listener_addr(lsock) if is_tcp else args.socket
    if args.advertise:
        host_id = args.host_id or socket.gethostname()
        with open(args.advertise, "a") as f:
            f.write(f"{host_id} {bound}\n")
        print(f"[worker pid={os.getpid()}] advertised {host_id} {bound} in "
              f"{args.advertise}", file=sys.stderr)

    from gpt_2_distributed_torch.obs.trace import configure_tracing
    from gpt_2_distributed_torch.serving.serve import cli_device, engine_factory

    if args.trace_dir:
        # Each worker writes its own trace-p{pid}.jsonl beside the
        # frontend's; scripts/obs_report.py reads them together.
        configure_tracing(args.trace_dir, process_index=os.getpid(),
                          max_file_bytes=args.trace_max_file_bytes)
    # A worker that cannot reach its device exits: it never falls back.
    device = cli_device(args)
    engine = engine_factory(p, args, device)()
    print(f"[worker pid={os.getpid()}] engine ready on {bound} ({device})", file=sys.stderr)

    try:
        while True:
            conn, _ = lsock.accept()
            try:
                _serve_loop(conn, _WorkerState(engine), token)
            finally:
                try:
                    conn.close()
                except OSError:
                    pass
            if not is_tcp:
                # Unix placement: the spawner owns this process; its
                # disconnect IS the shutdown.
                return
            # TCP fleet worker: the frontend is gone (a partition, a
            # frontend restart, a refused hello) but the process belongs to
            # the fleet: drop any orphaned in-flight state so the next
            # frontend adopts a clean engine (the old frontend already
            # migrated those streams from its mirrors), and keep listening.
            orphans = engine.extract_inflight()
            if orphans:
                print(f"[worker pid={os.getpid()}] dropped {len(orphans)} orphaned "
                      f"streams after disconnect; listening again on {bound}",
                      file=sys.stderr)
    finally:
        try:
            lsock.close()
            if not is_tcp:
                os.unlink(args.socket)
        except OSError:
            pass
        get_tracer().close()


if __name__ == "__main__":
    main()
