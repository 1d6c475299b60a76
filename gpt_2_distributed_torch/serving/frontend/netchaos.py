"""Network-chaos harness: an in-path TCP proxy that breaks links on cue
(``gpt_2_distributed_tpu/serving/frontend/netchaos.py``).

``chip_smoke.py``'s worker phase (and ``tests/test_torch_fleet.py``) put
one :class:`ChaosProxy` between the frontend and each remote worker, then
injure the link mid-decode and assert the exactness contract holds: every
stream finishes bit-identical to the in-process reference with zero
re-emitted tokens. The proxy is deliberately dumb — it forwards bytes,
never frames — because that is what a real network does: a partition or a
mid-frame truncation does not respect message boundaries, and the framing
layer (``rpc.py``) has to make the damage detectable.

Injuries, matched to the failure taxonomy a cross-host fleet actually
sees:

* ``set_latency(s)`` / ``set_bandwidth(bps)`` — a slow link (congested
  ToR, cross-zone hop). Does not break the contract, only stretches it;
  the heartbeat budget (``--worker_heartbeat_timeout_s``) decides when
  slow becomes dead.
* ``tear(after_bytes)`` — forward exactly N more bytes toward the
  frontend, then hard-close both sides: a reply truncated mid-frame,
  byte-precise so tests can tear at every header boundary.
* ``partition()`` / ``heal()`` — hard partition: live connections are
  severed AND the listener goes down, so dial probes get
  ECONNREFUSED until ``heal()`` rebinds the same port (this is what
  lets the re-admission probe distinguish a healed host from a
  half-dead one).
* ``blackhole(direction)`` — one-way loss: bytes in one direction are
  read and silently discarded while the other direction keeps flowing —
  the nastiest case, because the sender sees a healthy TCP connection.

torch-free by the frontend-package contract: stdlib only (socket +
threading), importable with torch poisoned.
"""

from __future__ import annotations

import socket
import threading
import time

from gpt_2_distributed_torch.serving.frontend.rpc import parse_addr

_CHUNK = 65536


class ChaosProxy:
    """One listener fronting one upstream address, with fault injection
    shared by every connection through it.

    Direction names: ``"up"`` is frontend->worker (toward upstream),
    ``"down"`` is worker->frontend. The chaos runs injure ``down`` — replies
    and their token payloads — because that is the direction where a torn
    frame could corrupt stream state if the framing let it.
    """

    def __init__(self, upstream: str, *, host: str = "127.0.0.1"):
        kind, addr = parse_addr(upstream)
        if kind != "tcp":
            raise ValueError(
                f"ChaosProxy fronts TCP workers, got {upstream!r}"
            )
        self.upstream = addr
        self._host = host
        self._lock = threading.Lock()
        self._latency_s = 0.0
        self._bandwidth_bps: float | None = None
        self._tear_budget: int | None = None     # bytes left before the cut
        self._blackhole: str | None = None       # "up" | "down" | None
        self._partitioned = False
        self._closed = False
        self._conns: list[tuple[socket.socket, socket.socket]] = []
        self._listener: socket.socket | None = None
        self._port = 0
        self._accept_thread: threading.Thread | None = None
        self._bind()

    # ------------------------------------------------------------ control

    @property
    def addr(self) -> str:
        return f"tcp://{self._host}:{self._port}"

    def set_latency(self, seconds: float) -> None:
        with self._lock:
            self._latency_s = float(seconds)

    def set_bandwidth(self, bytes_per_s: float | None) -> None:
        with self._lock:
            self._bandwidth_bps = (
                float(bytes_per_s) if bytes_per_s else None
            )

    def tear(self, after_bytes: int = 0) -> None:
        """Arm a torn-frame cut: forward ``after_bytes`` more bytes in
        the ``down`` direction, then sever both sides of every
        connection mid-stream."""
        with self._lock:
            self._tear_budget = int(after_bytes)

    def blackhole(self, direction: str = "down") -> None:
        if direction not in ("up", "down"):
            raise ValueError(f"direction={direction!r}: up or down")
        with self._lock:
            self._blackhole = direction

    def partition(self) -> None:
        """Hard partition: sever live connections and stop listening —
        dials now fail outright instead of connecting to a dead link."""
        with self._lock:
            if self._partitioned:
                return
            self._partitioned = True
            listener, self._listener = self._listener, None
        if listener is not None:
            _close(listener)
        self._sever_all()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
            self._accept_thread = None

    def heal(self) -> None:
        """Undo every injury and resume listening on the SAME port, so a
        pool entry naming this proxy becomes reachable again."""
        with self._lock:
            self._latency_s = 0.0
            self._bandwidth_bps = None
            self._tear_budget = None
            self._blackhole = None
            was_partitioned, self._partitioned = self._partitioned, False
        if was_partitioned and not self._closed:
            self._bind(port=self._port)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            listener, self._listener = self._listener, None
        if listener is not None:
            _close(listener)
        self._sever_all()

    # ----------------------------------------------------------- internals

    def _bind(self, port: int = 0) -> None:
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind((self._host, port))
        lsock.listen(8)
        self._port = lsock.getsockname()[1]
        with self._lock:
            self._listener = lsock
        t = threading.Thread(target=self._accept_loop, args=(lsock,),
                             name=f"netchaos-accept:{self._port}",
                             daemon=True)
        t.start()
        self._accept_thread = t

    def _accept_loop(self, lsock: socket.socket) -> None:
        while True:
            try:
                client, _ = lsock.accept()
            except OSError:
                return      # listener closed: partition or shutdown
            try:
                up = socket.create_connection(self.upstream, timeout=10)
                up.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                client.setsockopt(socket.IPPROTO_TCP,
                                  socket.TCP_NODELAY, 1)
            except OSError:
                _close(client)
                continue
            with self._lock:
                self._conns.append((client, up))
            for src, dst, direction in ((client, up, "up"),
                                        (up, client, "down")):
                threading.Thread(
                    target=self._pump, args=(src, dst, direction),
                    name=f"netchaos-{direction}:{self._port}",
                    daemon=True,
                ).start()

    def _sever_all(self) -> None:
        with self._lock:
            conns, self._conns = self._conns, []
        for a, b in conns:
            _close(a)
            _close(b)

    def _pump(self, src: socket.socket, dst: socket.socket,
              direction: str) -> None:
        while True:
            try:
                chunk = src.recv(_CHUNK)
            except OSError:
                break
            if not chunk:
                break
            with self._lock:
                latency = self._latency_s
                bps = self._bandwidth_bps
                hole = self._blackhole
                tearing = (self._tear_budget is not None
                           and direction == "down")
                if tearing:
                    keep = min(len(chunk), self._tear_budget)
                    self._tear_budget -= keep
                    chunk = chunk[:keep]
            if hole == direction:
                continue    # silently swallowed; connection stays up
            if latency > 0:
                time.sleep(latency)
            if bps:
                time.sleep(len(chunk) / bps)
            if chunk:
                try:
                    dst.sendall(chunk)
                except OSError:
                    break
            if tearing and self._tear_budget_spent():
                # The cut: both directions die mid-frame, exactly
                # after_bytes past the arm point.
                break
        _close(src)
        _close(dst)

    def _tear_budget_spent(self) -> bool:
        with self._lock:
            return (self._tear_budget is not None
                    and self._tear_budget <= 0)


def _close(sock: socket.socket) -> None:
    # shutdown() before close(): close() alone does not tear down a
    # connection while another thread sits blocked in recv()/accept() on
    # the same socket (CPython defers the underlying close), so a "cut"
    # link would stay half-alive — the peer would never see EOF and a
    # partitioned listener could keep accepting. shutdown() severs at the
    # kernel level regardless of who is blocked where.
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass
