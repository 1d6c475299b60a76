"""``gpt2-torch-frontend``: the asyncio HTTP/SSE front door over the
serving engine fleet (``gpt_2_distributed_tpu/serving/frontend/server.py``).

One process, two threads: the **driver thread** owns every engine and the
card (``EngineDriver.run_forever``; the engines' host-side scheduler state
is single-threaded by design), and the **asyncio thread** owns every
socket. HTTP handlers hand prompts across with ``submit_threadsafe`` (a
Future resolved at the driver's next step boundary) and receive tokens
back via ``loop.call_soon_threadsafe`` into per-request queues — no locks
on the hot path, no engine call ever made from the event loop. The main
thread runs the event loop, so the SIGTERM handler (main thread only) is
installed there.

The API is OpenAI-style ``POST /v1/completions``::

    {"prompt_ids": [464, 3616], "max_tokens": 16, "seed": 7, "stream": true}

Requests carry token ids (``prompt``, a string, needs a tokenizer this
server lacks: it answers 400 asking for ``prompt_ids``). With ``"stream":
true`` the response is Server-Sent Events: one ``data: {...}`` chunk per
token *as the engine emits it*, a final chunk carrying ``finish_reason``,
then ``data: [DONE]``. Token streams equal ``gpt2-torch-serve --stream``'s
for the same seed and config — routing picks WHICH replica computes, never
WHAT (``tests/test_torch_frontend.py`` holds SSE against the CLI, greedy
and sampled).

Also served: ``GET /healthz`` (503 once draining, so load balancers stop
sending traffic during shutdown; ``"degraded"`` while replica failures
hold the fleet below its target size, 503 ``"unhealthy"`` when no replica
is active) and ``GET /metrics`` (the router's fleet snapshot +
driver/autoscaler counters, JSON).

A replica whose ``step()`` raises is FAILED and ejected, its in-flight
streams migrate to healthy replicas mid-SSE with zero re-emitted tokens,
and ``--autoscale`` replaces the lost capacity. Requests that exceed
``--request_timeout_s`` (or their own ``"timeout_s"`` body field) answer
504 with their blocks freed.

Admission failures map to HTTP: a router shed (``--queue_slo_ms``
exceeded) or a draining server is ``503`` with ``Retry-After``; malformed
requests and engine refusals (prompt too long, bad ``max_tokens``) are
``400``. SIGTERM is graceful: the resilience preemption flag flips the
driver into drain mode, in-flight streams run to their final token, new
submits get 503, and the process exits 0.

Usage::

    gpt2-torch-frontend --init_random --model 124M --replicas 2 \\
        --prefix_cache --port 8000    # or --ckpt <save_dir>, --params_npz
    curl -N localhost:8000/v1/completions -d \\
        '{"prompt_ids": [1, 2, 3], "max_tokens": 8, "stream": true}'

Scaling knobs: ``--replicas`` fixed fleet, ``--route`` policy
(affinity | least_loaded | round_robin), ``--ttft_slo_ms`` /
``--queue_slo_ms`` SLO targets, and ``--autoscale`` to let queue depth
and SLO pressure grow/shrink the fleet between ``--min_replicas`` and
``--max_replicas`` (see autoscale.py). ``--placement subprocess`` runs
each replica in a worker process of its own (``worker.py``) and
``--placement remote`` adopts workers from a ``--worker_pool`` fleet, each
host a failure domain: a dead worker or host costs its replicas, whose
streams migrate, never the server. ``--watchdog_timeout_s`` and the
``--inject_*`` flags are ``serve.py``'s. The flags are the JAX server's;
``--device`` defaults to cuda, and ``--serve_mesh`` other than its default
is refused (a later slice), as in ``serve.py``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal
import sys
import threading
from typing import Any

from gpt_2_distributed_torch.serving.frontend.driver import (
    DrainingError,
    EngineDriver,
)
from gpt_2_distributed_torch.serving.frontend.router import (
    ROUTE_POLICIES,
    ShedError,
)

_MAX_HEADER_LINE = 8 * 1024
_MAX_BODY_BYTES = 4 * 1024 * 1024
_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            503: "Service Unavailable", 504: "Gateway Timeout"}


class _HttpError(Exception):
    """Terminate the request with this status + JSON error body."""

    def __init__(self, status: int, message: str, *,
                 err_type: str = "invalid_request_error",
                 retry_after: int | None = None):
        super().__init__(message)
        self.status = status
        self.err_type = err_type
        self.retry_after = retry_after


class FrontendServer:
    """The asyncio front end over one :class:`EngineDriver`.

    ``run()`` owns both threads until shutdown; tests run it off-thread
    and wait on ``ready`` (``port`` holds the bound port, so ``--port 0``
    works for parallel test runs).
    """

    def __init__(
        self,
        driver: EngineDriver,
        *,
        host: str = "127.0.0.1",
        port: int = 8000,
        model_name: str = "gpt2",
        default_new: int = 64,
        default_seed: int = 0,
        join_timeout_s: float = 30.0,
    ):
        self.driver = driver
        self.host = host
        self.port = port
        self.model_name = model_name
        self.default_new = default_new
        self.default_seed = default_seed
        self.join_timeout_s = float(join_timeout_s)
        # 0 after a clean drain; 1 when the driver thread outlived the
        # shutdown join and was abandoned (main() exits with this).
        self.exit_code = 0
        self.ready = threading.Event()

    # --------------------------------------------------------- lifecycle

    def run(self) -> None:
        """Serve until drained (SIGTERM) or ``shutdown()``; returns after
        every in-flight stream has completed and sockets are closed."""
        asyncio.run(self._serve())

    def shutdown(self) -> None:
        """Programmatic clean stop (tests): finish in-flight work, then
        exit ``run()``."""
        self.driver.stop()

    def _drive(self, loop: asyncio.AbstractEventLoop,
               drained: asyncio.Event) -> None:
        try:
            self.driver.run_forever()
        finally:
            loop.call_soon_threadsafe(drained.set)

    async def _serve(self) -> None:
        loop = asyncio.get_running_loop()
        drained = asyncio.Event()
        thread = threading.Thread(
            target=self._drive, args=(loop, drained),
            name="engine-driver", daemon=True,
        )
        thread.start()
        server = await asyncio.start_server(
            self._handle_conn, self.host, self.port,
        )
        self.port = server.sockets[0].getsockname()[1]
        print(
            f"frontend: http://{self.host}:{self.port} "
            f"({self.driver.router.n_active} replica(s), "
            f"policy={self.driver.router.policy})",
            file=sys.stderr,
        )
        self.ready.set()
        async with server:
            # The driver thread is the shutdown authority: SIGTERM (or
            # shutdown()) makes run_forever drain and exit, which sets
            # `drained`; only then do we stop accepting sockets. Requests
            # that race the drain get 503 from submit, not a dead socket.
            await drained.wait()
        thread.join(timeout=self.join_timeout_s)
        if thread.is_alive():
            # A wedged driver thread (a hung kernel, a lost device)
            # can outlive the drain signal. Silently returning here would
            # report a clean exit while abandoning a live thread — say so
            # loudly and make the process exit nonzero instead.
            print(
                f"frontend: driver thread STILL ALIVE after "
                f"{self.join_timeout_s:g}s shutdown join "
                f"(--shutdown_join_s); abandoning it and exiting 1",
                file=sys.stderr,
            )
            self.exit_code = 1
        else:
            print("frontend: drained, exiting 0", file=sys.stderr)

    # ------------------------------------------------------------- http

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            try:
                method, path, body = await self._read_request(reader)
            except _HttpError as e:
                await self._respond_error(writer, e)
                return
            except (asyncio.IncompleteReadError, ConnectionError,
                    asyncio.LimitOverrunError, ValueError):
                return  # malformed / vanished client: nothing to answer
            try:
                if method == "POST" and path == "/v1/completions":
                    await self._completions(writer, body)
                elif method == "GET" and path == "/healthz":
                    await self._healthz(writer)
                elif method == "GET" and path == "/metrics":
                    await self._metrics(writer)
                elif path in ("/v1/completions", "/healthz", "/metrics"):
                    raise _HttpError(405, f"{method} not allowed on {path}")
                else:
                    raise _HttpError(404, f"no route for {path}")
            except _HttpError as e:
                await self._respond_error(writer, e)
        except (ConnectionError, asyncio.CancelledError):
            pass  # client went away mid-stream; engine finishes regardless
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:  # noqa: BLE001 — already-dead transport
                pass

    async def _read_request(
        self, reader: asyncio.StreamReader
    ) -> tuple[str, str, bytes]:
        request_line = await reader.readuntil(b"\r\n")
        if len(request_line) > _MAX_HEADER_LINE:
            raise _HttpError(400, "request line too long")
        parts = request_line.decode("latin-1").strip().split()
        if len(parts) != 3:
            raise _HttpError(400, "malformed request line")
        method, target, _version = parts
        headers: dict[str, str] = {}
        while True:
            line = await reader.readuntil(b"\r\n")
            if line in (b"\r\n", b"\n"):
                break
            if len(line) > _MAX_HEADER_LINE or len(headers) > 100:
                raise _HttpError(400, "headers too large")
            name, _, value = line.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        length = int(headers.get("content-length", "0") or "0")
        if length > _MAX_BODY_BYTES:
            raise _HttpError(413, f"body exceeds {_MAX_BODY_BYTES} bytes")
        body = await reader.readexactly(length) if length else b""
        return method, target.split("?", 1)[0], body

    async def _write_head(self, writer: asyncio.StreamWriter, status: int,
                          headers: dict[str, str]) -> None:
        lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}"]
        lines += [f"{k}: {v}" for k, v in headers.items()]
        lines += ["Connection: close", "", ""]
        writer.write("\r\n".join(lines).encode("latin-1"))
        await writer.drain()

    async def _respond_json(self, writer: asyncio.StreamWriter, status: int,
                            obj: Any, extra: dict[str, str] | None = None
                            ) -> None:
        body = json.dumps(obj).encode()
        headers = {"Content-Type": "application/json",
                   "Content-Length": str(len(body))}
        if extra:
            headers.update(extra)
        await self._write_head(writer, status, headers)
        writer.write(body)
        await writer.drain()

    async def _respond_error(self, writer: asyncio.StreamWriter,
                             e: _HttpError) -> None:
        extra = ({"Retry-After": str(e.retry_after)}
                 if e.retry_after is not None else None)
        await self._respond_json(
            writer, e.status,
            {"error": {"message": str(e), "type": e.err_type}}, extra,
        )

    # ---------------------------------------------------------- routes

    async def _healthz(self, writer: asyncio.StreamWriter) -> None:
        router = self.driver.router
        if self.driver.draining:
            # 503 pulls this replica out of a load balancer's rotation
            # while the drain completes — the whole point of healthz.
            await self._respond_json(
                writer, 503, {"status": "draining"}, {"Retry-After": "1"},
            )
        elif router.n_active == 0:
            await self._respond_json(
                writer, 503, {
                    "status": "unhealthy",
                    "replicas": 0,
                    "failed_replicas": router.n_failed,
                }, {"Retry-After": "1"},
            )
        elif router.n_failed > 0 and router.n_active < router.target_replicas:
            # Still serving, but failures hold the fleet below the size
            # the deployment asked for — 200 (keep routing traffic here)
            # with the degradation visible to anything that looks.
            await self._respond_json(writer, 200, {
                "status": "degraded",
                "replicas": router.n_active,
                "target_replicas": router.target_replicas,
                "failed_replicas": router.n_failed,
            })
        else:
            await self._respond_json(writer, 200, {
                "status": "ok",
                "replicas": router.n_active,
            })

    async def _metrics(self, writer: asyncio.StreamWriter) -> None:
        out: dict[str, Any] = dict(self.driver.router.metrics_snapshot())
        out["steps"] = self.driver.steps
        out["draining"] = self.driver.draining
        out["requests_routed"] = self.driver.router.routed
        out["prefix_hit_rate"] = round(
            self.driver.router.aggregate_hit_rate(), 4
        )
        out["failed_replicas"] = self.driver.router.n_failed
        out["watchdog_trips"] = self.driver.watchdog_trips
        # Per-replica serving mesh: spec string + device count for each
        # live engine (single-device replicas report "single" / 1).
        out["replica_meshes"] = [
            {"replica": i, "mesh": eng.serve.mesh or "single",
             "devices": eng.serve.mesh_devices}
            for i, eng in enumerate(self.driver.router.engines)
            if eng is not None
        ]
        scaler = self.driver.autoscaler
        if scaler is not None:
            out["autoscale"] = {"ticks": scaler.ticks,
                                "scale_ups": scaler.scale_ups,
                                "scale_downs": scaler.scale_downs,
                                "replacements": scaler.replacements}
        await self._respond_json(writer, 200, out)

    def _parse_completion(
        self, body: bytes
    ) -> tuple[list[int], int, int, bool, float | None]:
        """(prompt_ids, max_tokens, seed, stream, timeout_s)."""
        try:
            obj = json.loads(body.decode() or "null")
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise _HttpError(400, f"bad JSON body ({e})") from e
        if not isinstance(obj, dict):
            raise _HttpError(400, "body must be a JSON object")
        if ("prompt_ids" in obj) == ("prompt" in obj):
            raise _HttpError(
                400, "exactly one of 'prompt_ids' / 'prompt' is required"
            )
        if "prompt" in obj:
            raise _HttpError(
                400, "'prompt' needs a tokenizer this server lacks; send "
                "'prompt_ids' instead",
            )
        ids = obj["prompt_ids"]
        if (not isinstance(ids, list) or not ids
                or not all(isinstance(t, int) for t in ids)):
            raise _HttpError(
                400, "'prompt_ids' must be a non-empty list of ints"
            )
        try:
            new = int(obj.get("max_tokens", self.default_new))
            seed = int(obj.get("seed", self.default_seed))
        except (TypeError, ValueError) as e:
            raise _HttpError(
                400, f"'max_tokens' / 'seed' must be integers ({e})"
            ) from e
        timeout_s = obj.get("timeout_s")   # None -> --request_timeout_s
        if timeout_s is not None:
            try:
                timeout_s = float(timeout_s)
            except (TypeError, ValueError) as e:
                raise _HttpError(
                    400, f"'timeout_s' must be a number ({e})"
                ) from e
            if timeout_s < 0:
                raise _HttpError(400, "'timeout_s' must be >= 0")
        return ids, new, seed, bool(obj.get("stream", False)), timeout_s

    async def _completions(self, writer: asyncio.StreamWriter,
                           body: bytes) -> None:
        ids, new, seed, stream, timeout_s = self._parse_completion(body)
        if self.driver.draining:
            raise _HttpError(503, "server is draining toward shutdown",
                             err_type="overloaded", retry_after=1)

        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()

        def on_token(req, tok):
            loop.call_soon_threadsafe(q.put_nowait, ("token", tok))

        def on_finish(handle):
            loop.call_soon_threadsafe(q.put_nowait, ("finish", handle))

        try:
            handle = await asyncio.wrap_future(self.driver.submit_threadsafe(
                ids, new, seed=seed,
                on_token=on_token if stream else None, on_finish=on_finish,
                timeout_s=timeout_s,
            ))
        except ShedError as e:
            raise _HttpError(503, str(e), err_type="overloaded",
                             retry_after=1) from e
        except DrainingError as e:
            raise _HttpError(503, str(e), err_type="overloaded",
                             retry_after=1) from e
        except ValueError as e:
            raise _HttpError(400, str(e)) from e

        cid = f"cmpl-{handle.id}"
        if not stream:
            while True:
                kind, payload = await q.get()
                if kind == "finish":
                    handle = payload
                    break
            if handle.finish_reason == "timeout":
                raise _HttpError(
                    504,
                    f"request {handle.id} exceeded its deadline after "
                    f"{len(handle.generated)} token(s)",
                    err_type="timeout",
                )
            if handle.finish_reason == "failed":
                raise _HttpError(
                    503,
                    f"request {handle.id} lost its replica with no healthy "
                    f"replica to migrate to",
                    err_type="server_error", retry_after=1,
                )
            await self._respond_json(writer, 200, {
                "id": cid,
                "object": "text_completion",
                "model": self.model_name,
                "replica": handle.replica,
                "choices": [{
                    "index": 0,
                    "text": None,
                    "token_ids": list(handle.generated),
                    "finish_reason": handle.finish_reason,
                }],
                "usage": {
                    "prompt_tokens": len(ids),
                    "completion_tokens": len(handle.generated),
                    "total_tokens": len(ids) + len(handle.generated),
                },
            })
            return

        # SSE: headers first, then a data: chunk per token as emitted.
        # No Content-Length — the stream ends when the connection closes,
        # which Connection: close makes well-formed HTTP/1.1.
        await self._write_head(writer, 200, {
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
        })

        def sse(obj: Any) -> bytes:
            return f"data: {json.dumps(obj)}\n\n".encode()

        done = False
        while not done:
            kind, payload = await q.get()
            if kind == "token":
                writer.write(sse({
                    "id": cid,
                    "object": "text_completion.chunk",
                    "model": self.model_name,
                    "choices": [{
                        "index": 0,
                        "token": payload,
                        "text": None,
                        "finish_reason": None,
                    }],
                }))
                await writer.drain()
            else:
                handle = payload
                writer.write(sse({
                    "id": cid,
                    "object": "text_completion.chunk",
                    "model": self.model_name,
                    "replica": handle.replica,
                    "choices": [{
                        "index": 0,
                        "token": None,
                        "text": "",
                        "finish_reason": handle.finish_reason,
                    }],
                    "usage": {
                        "prompt_tokens": len(ids),
                        "completion_tokens": len(handle.generated),
                        "total_tokens": len(ids) + len(handle.generated),
                    },
                }))
                writer.write(b"data: [DONE]\n\n")
                await writer.drain()
                done = True


# ------------------------------------------------------------------ CLI


def build_argparser() -> argparse.ArgumentParser:
    from gpt_2_distributed_torch.serving.serve import (
        add_engine_flags,
        add_fault_flags,
        add_model_flags,
        add_obs_flags,
        add_placement_flags,
    )

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_model_flags(p)
    add_engine_flags(p)
    add_obs_flags(p)
    add_placement_flags(p)
    add_fault_flags(p)
    p.add_argument("--shutdown_join_s", type=float, default=30.0,
                   help="how long shutdown waits for the driver thread "
                        "before abandoning it and exiting 1")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000,
                   help="TCP port; 0 picks an ephemeral port")
    p.add_argument("--replicas", type=int, default=1,
                   help="engine replicas to start with")
    p.add_argument("--max_replicas", type=int, default=None,
                   help="fleet ceiling (default: --replicas, so the "
                        "autoscaler needs this to have headroom)")
    p.add_argument("--route", default="affinity", choices=ROUTE_POLICIES,
                   help="replica selection: prefix-affinity (default), "
                        "least_loaded, or round_robin (benchmark control)")
    p.add_argument("--ttft_slo_ms", type=float, default=None,
                   help="count finished requests whose TTFT exceeded this "
                        "as SLO violations (autoscaler grow pressure)")
    p.add_argument("--queue_slo_ms", type=float, default=None,
                   help="shed (503) requests whose predicted queue wait "
                        "exceeds this")
    p.add_argument("--autoscale", action="store_true",
                   help="grow/shrink replicas from queue depth + SLO "
                        "pressure (between --min_replicas and "
                        "--max_replicas)")
    p.add_argument("--min_replicas", type=int, default=1)
    p.add_argument("--grow_queue_depth", type=float, default=4.0,
                   help="per-replica queue depth that counts as pressure")
    p.add_argument("--grow_after", type=int, default=2,
                   help="consecutive pressured autoscale ticks before grow")
    p.add_argument("--shrink_after", type=int, default=8,
                   help="consecutive idle autoscale ticks before shrink")
    p.add_argument("--autoscale_cooldown", type=int, default=4,
                   help="autoscale ticks to wait after any scale action")
    p.add_argument("--autoscale_every", type=int, default=8,
                   help="engine steps between autoscaler ticks")
    return p


def main(argv: list[str] | None = None) -> None:
    p = build_argparser()
    args = p.parse_args(argv)
    from gpt_2_distributed_torch.serving.serve import (
        check_common_args,
        make_engine_source,
        make_tracker,
        setup_observability,
    )

    injector = check_common_args(p, args)
    from gpt_2_distributed_torch.obs.trace import configure_tracing
    from gpt_2_distributed_torch.resilience import PreemptionHandler
    from gpt_2_distributed_torch.serving.frontend.autoscale import Autoscaler
    from gpt_2_distributed_torch.serving.frontend.router import ReplicaRouter

    capture = setup_observability(p, args)
    tracker = make_tracker(args)
    max_replicas = args.max_replicas
    if max_replicas is None:
        max_replicas = args.replicas
    # Under a worker placement the HTTP process loads no weights and
    # touches no device: a replica's crash cannot take the server down.
    make_engine, _ = make_engine_source(p, args, initial_replicas=args.replicas)
    try:
        router = ReplicaRouter(
            make_engine,
            replicas=args.replicas, max_replicas=max_replicas,
            policy=args.route, ttft_slo_ms=args.ttft_slo_ms,
            queue_slo_ms=args.queue_slo_ms,
        )
        if args.placement != "inprocess":
            make_engine.router = router   # respawn-vs-scale-up attribution
        autoscaler = Autoscaler(
            router, min_replicas=args.min_replicas,
            max_replicas=max_replicas,
            grow_queue_depth=args.grow_queue_depth,
            grow_after=args.grow_after, shrink_after=args.shrink_after,
            cooldown=args.autoscale_cooldown,
        ) if args.autoscale else None
    except ValueError as e:
        p.error(str(e))

    handler = PreemptionHandler(
        signals=(signal.SIGTERM, signal.SIGINT),
        notice=("draining: in-flight streams will complete, new requests "
                "get 503, then exit 0"),
    ).install()
    driver = EngineDriver(
        router, tracker=tracker, metrics_every=args.metrics_every,
        profiler_capture=capture, preemption=handler, autoscaler=autoscaler,
        autoscale_every=args.autoscale_every,
        request_timeout_s=args.request_timeout_s,
        watchdog_timeout_s=args.watchdog_timeout_s, injector=injector,
    )
    server = FrontendServer(
        driver, host=args.host, port=args.port, model_name=args.model,
        default_new=args.new, default_seed=args.seed,
        join_timeout_s=args.shutdown_join_s,
    )
    try:
        server.run()
    finally:
        driver.close()
        if args.trace_dir:
            configure_tracing(None)   # closes the file; later runs trace nothing
        handler.uninstall()
    if server.exit_code:
        sys.exit(server.exit_code)


if __name__ == "__main__":
    main()
