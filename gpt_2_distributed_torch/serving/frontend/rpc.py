"""Length-prefixed JSON-over-socket framing for the worker RPC plane
(``gpt_2_distributed_tpu/serving/frontend/rpc.py``).

One frame = a 4-byte big-endian payload length followed by that many bytes
of UTF-8 JSON. JSON keeps the wire debuggable (``socat`` a worker socket
and read the traffic) and torch-free on the frontend side; the 4-byte prefix
makes torn reads detectable — a worker SIGKILLed mid-reply (or a TCP link
severed by a partition) leaves the parent with a short read, which
surfaces as :class:`WireError`, never as a half-parsed message. Every
framing error names the peer (host:port for TCP, the socket path for
AF_UNIX) and, for a bad length prefix, the offending declared length — a
corrupt prefix on a cross-host link must be diagnosable from the log line
alone.

Transport: the same frames run over an AF_UNIX socketpair (``--placement
subprocess``) or TCP (``--placement remote``). Address specs are either a
filesystem path or ``tcp://host:port``; :func:`create_listener` /
:func:`dial` build both. The TCP path layers a shared-secret
mutual-authentication handshake over the ``WIRE_VERSION`` hello
(:func:`client_hello` / :func:`server_hello`): HMAC-SHA256
challenge–response in both directions, so an unauthenticated frontend
never receives engine state and a worker impostor is refused before any
request leaves the frontend.

This module imports neither torch nor anything from the serving package:
``worker.py`` loads it before the engine import, and the frontend uses it
without touching device state. Its frames are byte for byte the JAX
package's; the auth MACs carry this package's own domain tag, so a
frontend and a worker of the two packages never authenticate each other.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import socket
import struct

# Version of the RPC envelope (framing + verb set). A worker and frontend
# from different builds refuse each other loudly at hello time instead of
# misinterpreting frames.
WIRE_VERSION = 1

# One frame holds at most one extracted fleet's worth of requests; 64 MiB
# is ~16M tokens of JSON — far past any real payload, close enough to
# catch a corrupt length prefix before a multi-GiB allocation.
MAX_FRAME_BYTES = 64 * 1024 * 1024

_HEADER = struct.Struct(">I")

# Domain separator for the auth MACs: a MAC computed for this protocol
# can never be replayed into another HMAC-SHA256 protocol sharing the
# token, and the embedded role tag stops reflection (a challenger's own
# proof replayed back at it).
_AUTH_CONTEXT = b"gpt2-torch-worker-rpc-v%d" % WIRE_VERSION


class WireError(RuntimeError):
    """Framing-level failure: peer gone (EOF / reset), timeout, oversize
    or malformed frame, or a refused/failed hello handshake. The driver
    treats any WireError from a worker RPC as replica failure and trips
    the containment path."""


def describe_peer(sock: socket.socket) -> str:
    """Log-line description of the socket's peer: ``host:port`` for TCP,
    the bound path for AF_UNIX, a fallback for socketpairs (no name)."""
    try:
        name = sock.getpeername()
    except OSError:
        return "unknown-peer"
    if isinstance(name, tuple):
        return f"{name[0]}:{name[1]}"
    return str(name) or "unix-socketpair"


# ----------------------------------------------------------------- framing


def send_msg(sock: socket.socket, obj: dict, peer: str | None = None) -> None:
    """Serialize ``obj`` and write one frame. Raises WireError if the peer
    is gone (broken pipe / reset) or the send times out."""
    payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(payload) > MAX_FRAME_BYTES:
        raise WireError(
            f"refusing to send {len(payload)}-byte frame "
            f"(cap {MAX_FRAME_BYTES}) to {peer or describe_peer(sock)}"
        )
    try:
        sock.sendall(_HEADER.pack(len(payload)) + payload)
    except (OSError, socket.timeout) as e:
        raise WireError(
            f"send to {peer or describe_peer(sock)} failed: "
            f"{type(e).__name__}: {e}"
        ) from e


def _recv_exact(sock: socket.socket, n: int, peer: str | None) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout as e:
            raise WireError(
                f"recv from {peer or describe_peer(sock)} timed out "
                f"with {len(buf)}/{n} bytes read"
            ) from e
        except OSError as e:
            raise WireError(
                f"recv from {peer or describe_peer(sock)} failed: "
                f"{type(e).__name__}: {e}"
            ) from e
        if not chunk:
            who = peer or describe_peer(sock)
            raise WireError(
                f"peer {who} closed with {len(buf)}/{n} bytes read"
                if buf else f"peer {who} closed (EOF)"
            )
        buf.extend(chunk)
    return bytes(buf)


def recv_msg(sock: socket.socket, peer: str | None = None) -> dict:
    """Read one frame and decode it. Raises WireError on EOF, timeout,
    oversize length prefix, or malformed JSON — always naming the peer,
    and for a bad prefix the declared length it claimed."""
    (length,) = _HEADER.unpack(_recv_exact(sock, _HEADER.size, peer))
    if length > MAX_FRAME_BYTES:
        raise WireError(
            f"frame from {peer or describe_peer(sock)} declares length "
            f"{length}, exceeding cap {MAX_FRAME_BYTES} "
            "(corrupt prefix or version mismatch)"
        )
    payload = _recv_exact(sock, length, peer)
    try:
        obj = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(
            f"malformed {length}-byte frame from "
            f"{peer or describe_peer(sock)}: {e}"
        ) from e
    if not isinstance(obj, dict):
        raise WireError(
            f"frame from {peer or describe_peer(sock)} is "
            f"{type(obj).__name__}, expected object"
        )
    return obj


# --------------------------------------------------------------- transport


def parse_addr(spec: str) -> tuple[str, object]:
    """``("tcp", (host, port))`` for ``tcp://host:port`` specs,
    ``("unix", path)`` for everything else. Raises ValueError on a
    malformed TCP spec (torch-free, so CLIs refuse at parse time)."""
    if not spec.startswith("tcp://"):
        return "unix", spec
    rest = spec[len("tcp://"):]
    host, sep, port = rest.rpartition(":")
    if not sep or not host:
        raise ValueError(
            f"address {spec!r}: expected tcp://host:port"
        )
    try:
        n = int(port)
    except ValueError:
        raise ValueError(
            f"address {spec!r}: port {port!r} is not an integer"
        ) from None
    if not 0 <= n <= 65535:
        raise ValueError(f"address {spec!r}: port {n} out of range")
    return "tcp", (host, n)


def create_listener(spec: str, backlog: int = 8) -> socket.socket:
    """Bind + listen on an address spec. TCP listeners set SO_REUSEADDR
    (workers restart on the same advertised port); port 0 binds an
    ephemeral port — read it back with :func:`listener_addr`."""
    kind, addr = parse_addr(spec)
    if kind == "tcp":
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    else:
        if os.path.exists(addr):
            os.unlink(addr)
        lsock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    lsock.bind(addr)
    lsock.listen(backlog)
    return lsock


def listener_addr(lsock: socket.socket) -> str:
    """The listener's actual address spec (resolves a port-0 TCP bind)."""
    name = lsock.getsockname()
    if isinstance(name, tuple):
        return f"tcp://{name[0]}:{name[1]}"
    return str(name)


def dial(spec: str, timeout: float | None = None) -> socket.socket:
    """Connect to an address spec. TCP connections set TCP_NODELAY — the
    RPC plane is strict request-reply, so Nagle only adds latency."""
    kind, addr = parse_addr(spec)
    if kind == "tcp":
        sock = socket.create_connection(addr, timeout=timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    else:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        if timeout is not None:
            sock.settimeout(timeout)
        sock.connect(addr)
    return sock


# ------------------------------------------------------------------- auth


def make_nonce() -> str:
    return os.urandom(16).hex()


def auth_mac(token: bytes, role: str, nonce: str) -> str:
    """HMAC-SHA256 over (context | role | nonce). The role tag binds each
    MAC to one direction of the handshake."""
    msg = _AUTH_CONTEXT + b"|" + role.encode() + b"|" + nonce.encode()
    return hmac.new(token, msg, hashlib.sha256).hexdigest()


def client_hello(sock: socket.socket, token: bytes | None,
                 peer: str | None = None) -> dict:
    """Frontend side of the hello: version tag, then (with a token) the
    mutual HMAC challenge–response. Returns the worker's hello payload
    (serve config, pool bytes, stats); raises :class:`WireError` loudly on
    version mismatch, a worker that won't authenticate, a worker that
    demands auth we can't provide, or a bad token — in every case before
    any engine state has moved."""
    who = peer or describe_peer(sock)
    nonce_c = make_nonce() if token is not None else None
    msg: dict = {"op": "hello", "wire_version": WIRE_VERSION}
    if nonce_c is not None:
        msg["nonce"] = nonce_c
    send_msg(sock, msg, peer=who)
    reply = recv_msg(sock, peer=who)
    if reply.get("auth") == "challenge":
        if token is None:
            raise WireError(
                f"worker at {who} requires authentication but no "
                "--worker_auth_token_file was given — refusing"
            )
        proof = reply.get("proof")
        if not isinstance(proof, str) or not hmac.compare_digest(
            proof, auth_mac(token, "server", nonce_c)
        ):
            raise WireError(
                f"worker at {who} failed mutual authentication (bad "
                "server proof) — token mismatch or impostor; refusing "
                "to send any request state"
            )
        send_msg(sock, {"op": "auth",
                        "mac": auth_mac(token, "client", str(reply.get("nonce")))},
                 peer=who)
        reply = recv_msg(sock, peer=who)
    elif token is not None:
        raise WireError(
            f"worker at {who} did not request authentication but "
            "--worker_auth_token_file is set — refusing to adopt an "
            "unauthenticated worker"
        )
    if not reply.get("ok"):
        raise WireError(f"hello refused by {who}: {reply.get('error')}")
    if reply.get("wire_version") != WIRE_VERSION:
        raise WireError(
            f"worker at {who} speaks wire version "
            f"{reply.get('wire_version')}, frontend speaks {WIRE_VERSION} "
            "— mixed builds"
        )
    return reply


def server_hello(conn: socket.socket, msg: dict, token: bytes | None,
                 peer: str | None = None) -> bool:
    """Worker side of the hello, called on the parsed ``op=hello`` frame:
    validate the version tag, then (with a token) run the challenge.
    Returns True when the caller may send its engine payload; on any
    refusal the refusal frame has already been sent and the connection
    should be dropped — no engine state crosses an unauthenticated or
    version-mismatched link."""
    who = peer or describe_peer(conn)
    if msg.get("wire_version") != WIRE_VERSION:
        send_msg(conn, {
            "ok": False, "error_type": "WireError",
            "error": f"wire version mismatch: frontend "
                     f"{msg.get('wire_version')}, worker {WIRE_VERSION}",
        }, peer=who)
        return False
    if token is None:
        return True
    nonce_s = make_nonce()
    challenge: dict = {"ok": True, "auth": "challenge", "nonce": nonce_s}
    nonce_c = msg.get("nonce")
    if isinstance(nonce_c, str):
        # Mutual auth: prove we hold the token too, bound to the
        # frontend's nonce so the proof can't be replayed.
        challenge["proof"] = auth_mac(token, "server", nonce_c)
    send_msg(conn, challenge, peer=who)
    try:
        reply = recv_msg(conn, peer=who)
    except WireError:
        return False    # peer bailed on the challenge: refused
    mac = reply.get("mac") if reply.get("op") == "auth" else None
    if not isinstance(mac, str) or not hmac.compare_digest(
        mac, auth_mac(token, "client", nonce_s)
    ):
        send_msg(conn, {
            "ok": False, "error_type": "WireError",
            "error": "authentication failed: bad or missing HMAC "
                     "response — token mismatch",
        }, peer=who)
        return False
    return True


def load_auth_token(path: str) -> bytes:
    """Read a shared-secret token file (whitespace-stripped). Raises
    ValueError on an empty file — an empty token authenticates nothing."""
    with open(path, "rb") as f:
        token = f.read().strip()
    if not token:
        raise ValueError(f"auth token file {path!r} is empty")
    return token
