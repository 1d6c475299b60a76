"""The shared engine-driver: ONE submit/step/drain loop behind both
serving entry points (``gpt_2_distributed_tpu/serving/frontend/driver.py``).

``gpt2-torch-serve`` (JSONL over stdin or a file) and
``gpt2-torch-frontend`` (HTTP/SSE) wrap this one loop, so the two cannot
drift in metrics cadence, capture windows or drain semantics:

* **submit** — route through the :class:`ReplicaRouter` (which may shed),
  rejecting everything once draining has begun (:class:`DrainingError`,
  a 503 at the HTTP layer). ``submit_threadsafe`` is the same thing
  callable from any thread (the asyncio server's bridge): submissions
  park in an inbox the driver thread consumes at the next step boundary,
  because the engines' host-side scheduler state is single-threaded by
  design and only the driver thread touches the engines and the card.
* **step** — one tick of the fleet: consume the inbox, step every engine
  with work (retired replicas drain through here too), tick the
  autoscaler, run finish callbacks + SLO accounting, flush the metrics
  sink every ``metrics_every`` steps, and honor the profiler capture
  window. A replica whose ``step()`` raises is failed and its requests
  migrate to healthy replicas; the loop keeps going.
* **drain** — run to idle (the JSONL path's whole life; the HTTP path's
  SIGTERM epilogue). Graceful shutdown reuses the resilience SIGTERM
  flag (:class:`resilience.PreemptionHandler`): the driver polls
  ``preempted()`` at step boundaries and flips to ``draining``: in-flight
  requests run to completion, new submits are refused, and the caller
  exits 0.
* **supervise** — under worker placements (``worker.py``) every step
  first sweeps the workers' health (a dead process, heartbeat loss): a
  failure is contained like a raising step, and when every replica of a
  remote host failed in one sweep the host is contained as one batch
  (``router.fail_host``). Quarantined hosts are dial-probed for
  re-admission at most every 2 s. ``watchdog_timeout_s`` arms a
  :class:`StepWatchdog` around each replica's step, and ``injector``
  (``resilience.FaultInjector``, tests and chaos runs only) fires its
  faults inside the same containment.
"""

from __future__ import annotations

import collections
import concurrent.futures
import sys
import threading
import time
from typing import TYPE_CHECKING, Callable, Sequence

from gpt_2_distributed_torch.obs.trace import get_tracer
from gpt_2_distributed_torch.serving.frontend.router import ReplicaRouter, ShedError

if TYPE_CHECKING:   # annotation-only: keeps this module importable
    from gpt_2_distributed_torch.serving.engine import (  # pragma: no cover
        RequestHandle,
    )  # without paying the torch import


class DrainingError(RuntimeError):
    """Submit refused: the driver is draining toward shutdown."""


class StepWatchdog:
    """Daemon thread bounding how long one replica's ``step()`` may run.

    The ``coordination.HangWatchdog`` idiom (arm/disarm around the guarded
    region, a lock-protected deadline, a check interval of
    ``min(timeout/4, 0.5)``) with one deliberate difference: firing does
    NOT kill the process. Serving a fleet, a wedged replica costs one
    replica — the watchdog dumps all-thread stacks plus the tracer's open
    spans (the "which phase hung" post-mortem), then hands the replica
    index to ``on_trip``, which condemns it so the driver fails and
    migrates it the moment (if ever) the stuck call returns. One trip per
    arm: after firing the watchdog disarms itself and keeps watching the
    NEXT armed step.
    """

    def __init__(self, timeout_s: float, on_trip: Callable[[int], None]) -> None:
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.on_trip = on_trip
        self.trips = 0
        self._armed = False
        self._replica = -1
        self._deadline = 0.0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "StepWatchdog":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, name="step-watchdog",
                                            daemon=True)
            self._thread.start()
        return self

    def arm(self, replica: int) -> None:
        with self._lock:
            self._armed = True
            self._replica = replica
            self._deadline = time.monotonic() + self.timeout_s

    def disarm(self) -> None:
        with self._lock:
            self._armed = False

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        interval = min(self.timeout_s / 4.0, 0.5)
        while not self._stop.wait(interval):
            with self._lock:
                expired = self._armed and time.monotonic() > self._deadline
                replica = self._replica
                if expired:
                    self._armed = False
            if expired:
                self._fire(replica)

    def _fire(self, replica: int) -> None:
        self.trips += 1
        print(f"[serve] watchdog: replica {replica} step exceeded "
              f"{self.timeout_s:g}s; dumping stacks, condemning the replica",
              file=sys.stderr, flush=True)
        try:
            import faulthandler
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        except Exception:
            pass
        try:
            tracer = get_tracer()
            if tracer.enabled:
                print("[serve] watchdog: " + tracer.format_open_spans(),
                      file=sys.stderr, flush=True)
            tracer.event("watchdog_fired", replica=replica, timeout_s=self.timeout_s)
        except Exception:
            pass
        try:
            self.on_trip(replica)
        except Exception as e:   # the watchdog must keep watching
            print(f"[serve] watchdog: on_trip raised {type(e).__name__}: {e}",
                  file=sys.stderr, flush=True)


class EngineDriver:
    """Owns the step loop over a :class:`ReplicaRouter` fleet."""

    def __init__(
        self,
        router: ReplicaRouter,
        *,
        tracker=None,
        metrics_every: int = 20,
        profiler_capture=None,
        preemption=None,
        autoscaler=None,
        autoscale_every: int = 1,
        request_timeout_s: float | None = None,
        watchdog_timeout_s: float | None = None,
        injector=None,
    ):
        self.router = router
        self.tracker = tracker
        self.metrics_every = max(int(metrics_every), 1)
        self.profiler_capture = profiler_capture
        self.preemption = preemption
        self.autoscaler = autoscaler
        self.autoscale_every = max(int(autoscale_every), 1)
        # Default deadline for every submit (per-request timeout_s wins).
        self.request_timeout_s = request_timeout_s
        # resilience.FaultInjector (tests, chaos runs): consulted before
        # each replica's step; None in production.
        self.injector = injector
        self.steps = 0
        self.draining = False
        self.watchdog_trips = 0
        self._last_host_poll = 0.0
        self._condemned: set[int] = set()
        self._watchdog: StepWatchdog | None = None
        if watchdog_timeout_s is not None:
            self._watchdog = StepWatchdog(watchdog_timeout_s, self._on_watchdog_trip).start()
        self._watch: list[tuple[RequestHandle, Callable | None]] = []
        self._inbox: collections.deque = collections.deque()
        self._wake = threading.Event()
        self._stop = False
        self._finished = False

    # ------------------------------------------------------------- intake

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        *,
        seed: int = 0,
        on_token: Callable[[RequestHandle, int], None] | None = None,
        on_finish: Callable[[RequestHandle], None] | None = None,
        timeout_s: float | None = None,
    ) -> RequestHandle:
        """Driver-thread submit. Raises :class:`DrainingError` once
        shutdown has begun, :class:`ShedError` from SLO admission, and
        ``ValueError`` for requests the engine itself would refuse.
        ``timeout_s`` overrides the driver-wide ``request_timeout_s``
        deadline for this request."""
        if self.draining:
            raise DrainingError(
                "draining: in-flight requests are completing; no new "
                "submits accepted"
            )
        if timeout_s is None:
            timeout_s = self.request_timeout_s
        handle = self.router.submit(
            prompt, max_new_tokens, seed=seed, on_token=on_token,
            timeout_s=timeout_s,
        )
        self._watch.append((handle, on_finish))
        return handle

    def submit_threadsafe(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        *,
        seed: int = 0,
        on_token: Callable[[RequestHandle, int], None] | None = None,
        on_finish: Callable[[RequestHandle], None] | None = None,
        timeout_s: float | None = None,
    ) -> concurrent.futures.Future:
        """Cross-thread submit: resolves to the :class:`RequestHandle` at
        the driver's next step boundary, or to the refusal exception."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        if self._finished:
            # The loop already exited: nothing will ever drain the inbox.
            fut.set_exception(DrainingError(
                "draining: the engine loop has exited"
            ))
            return fut
        self._inbox.append(
            (fut, list(prompt), max_new_tokens, seed, on_token, on_finish,
             timeout_s)
        )
        self._wake.set()
        return fut

    def _consume_inbox(self) -> None:
        while self._inbox:
            (fut, prompt, new, seed, on_token, on_finish, timeout_s) = \
                self._inbox.popleft()
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(self.submit(
                    prompt, new, seed=seed,
                    on_token=on_token, on_finish=on_finish,
                    timeout_s=timeout_s,
                ))
            except Exception as e:  # refusals travel to the caller
                fut.set_exception(e)
                # Shed submissions already traced a "shed" event with the
                # routed rid; draining/validation refusals never reached
                # the router, so trace them here with a fleet-unique rid.
                if not isinstance(e, ShedError):
                    get_tracer().event(
                        "submit_refused", rid=self.router.allocate_rid(),
                        reason=type(e).__name__, detail=str(e)[:200],
                    )

    # --------------------------------------------------------------- loop

    def _check_preemption(self) -> None:
        if (not self.draining and self.preemption is not None
                and self.preemption.preempted()):
            self.begin_drain()

    def begin_drain(self) -> None:
        """Stop accepting work; everything already accepted completes."""
        self.draining = True

    def has_work(self) -> bool:
        return bool(self._inbox) or self.router.has_work()

    def _on_watchdog_trip(self, replica: int) -> None:
        """Watchdog-thread callback: condemn the stuck replica (the step
        loop fails and migrates it the moment the stuck call returns) and
        release any injected hang so tests and chaos runs make progress."""
        self.watchdog_trips += 1
        self._condemned.add(replica)
        if self.injector is not None:
            self.injector.release_hangs()

    def _check_worker_health(self) -> bool:
        """Out-of-band liveness sweep for process-isolated replicas: a
        worker that died BETWEEN steps (SIGKILL while idle, a crash during
        someone else's step) or stopped answering heartbeats is contained
        here instead of waiting for traffic to trip over the corpse.
        Duck-typed: in-process engines have no ``check_health``. Returns
        whether any replica failed.

        Host classification (remote placement): the sweep first COLLECTS
        every failure, then groups the ones whose handles carry a
        ``host_id``. When every live worker on a host failed in this one
        sweep, that is host death, contained as a single batch through
        ``router.fail_host`` (one migration wave, never onto a dying
        sibling). A partial failure on a host stays per-replica, and
        handles without a host_id (local placements) always are."""
        already = set(self.router.failed_indices())
        failures: list[tuple[int, str, str | None]] = []
        for idx, eng in enumerate(self.router.engines):
            if idx in already:
                continue
            probe = getattr(eng, "check_health", None)
            if probe is None:
                continue
            reason = probe()
            if reason is not None:
                failures.append((idx, reason, getattr(eng, "host_id", None)))
        if not failures:
            return False
        by_host: dict[str, list[tuple[int, str]]] = {}
        for idx, reason, host in failures:
            if host is None:
                self._fail_replica(idx, reason)
            else:
                by_host.setdefault(host, []).append((idx, reason))
        for host, items in by_host.items():
            live = {i for i, eng in enumerate(self.router.engines)
                    if i not in already and getattr(eng, "host_id", None) == host}
            if {i for i, _ in items} >= live:
                self._fail_host(host, items[0][1])
            else:
                for idx, reason in items:
                    self._fail_replica(idx, reason)
        return True

    def _fail_replica(self, idx: int, reason: str) -> None:
        """Containment: eject replica ``idx`` from the fleet, migrate its
        in-flight requests to healthy replicas, keep the loop running."""
        print(
            f"[serve] replica {idx} FAILED ({reason}); "
            f"migrating its in-flight requests",
            file=sys.stderr, flush=True,
        )
        moved = self.router.fail_replica(idx, reason=reason)
        print(
            f"[serve] replica {idx}: {moved} request(s) migrated; "
            f"{self.router.n_active} replica(s) active",
            file=sys.stderr, flush=True,
        )

    def _fail_host(self, host_id: str, reason: str) -> None:
        """Containment, host-domain edition: every worker on ``host_id``
        goes down together, their streams migrate in one wave."""
        print(f"[serve] host {host_id} LOST ({reason}); containing its "
              f"replicas as one batch", file=sys.stderr, flush=True)
        moved = self.router.fail_host(host_id, reason=reason)
        print(f"[serve] host {host_id}: {moved} request(s) migrated; "
              f"{self.router.n_active} replica(s) active", file=sys.stderr, flush=True)

    def _metrics(self) -> dict[str, float]:
        return dict(watchdog_trips=float(self.watchdog_trips),
                    **self.router.metrics_snapshot())

    def step(self) -> int:
        """One fleet tick; returns tokens emitted. Ordering: capture start
        -> engine step(s) -> capture stop -> autoscaler -> finish callbacks
        -> metrics flush.

        Each replica's ``step()`` runs inside a containment wrapper: an
        exception (or a watchdog condemnation) fails THAT replica —
        ejected from routing, its requests migrated — and the fleet loop
        keeps going."""
        self._check_preemption()
        self._consume_inbox()
        self._check_worker_health()
        # Quarantined-host probes are dial attempts (up to 1 s each on a
        # blackholed link), so under load they run at most every 2 s:
        # re-admission latency stays bounded without stalling decode.
        now = time.monotonic()
        if now - self._last_host_poll >= 2.0:
            self._last_host_poll = now
            self.router.poll_hosts()
        self.steps += 1
        if self.profiler_capture is not None:
            self.profiler_capture.maybe_start(self.steps)
        emitted = 0
        wd = self._watchdog
        for idx, eng in self.router.steppable():
            if wd is not None:
                wd.arm(idx)
            try:
                if self.injector is not None:
                    self.injector.tick(self.steps, idx)
                emitted += eng.step()
            except Exception as e:
                self._fail_replica(idx, f"{type(e).__name__}: {e}")
                continue
            finally:
                if wd is not None:
                    wd.disarm()
            if idx in self._condemned:
                self._condemned.discard(idx)
                self._fail_replica(idx, f"watchdog: step exceeded {wd.timeout_s:g}s")
        if self.profiler_capture is not None:
            self.profiler_capture.maybe_stop(self.steps)
        if (self.autoscaler is not None
                and self.steps % self.autoscale_every == 0):
            self.autoscaler.tick()
        if self._watch:
            still = []
            for handle, on_finish in self._watch:
                if handle.done:
                    self.router.observe_finish(handle)
                    if on_finish is not None:
                        on_finish(handle)
                else:
                    still.append((handle, on_finish))
            self._watch = still
        if self.tracker is not None and self.steps % self.metrics_every == 0:
            self.tracker.update(self.steps, count_tokens=False, **self._metrics())
        return emitted

    def drain(self) -> int:
        """Run until the fleet is idle (the JSONL path's main loop and the
        SIGTERM epilogue). Returns total tokens emitted. Finishes with the
        final metrics flush and closes any profiler capture window."""
        total = 0
        while self.has_work():
            total += self.step()
        if self.profiler_capture is not None:
            self.profiler_capture.stop_if_active()
        if self.tracker is not None:
            self.tracker.update(self.steps + 1, count_tokens=False, **self._metrics())
        return total

    def run_forever(self, idle_wait: float = 0.01) -> None:
        """The HTTP server's driver-thread loop: step while there is work,
        park on the wake event while idle, exit once draining completes
        (or ``stop()`` is called and the fleet is idle)."""
        while True:
            if self.has_work():
                self.step()
                continue
            self._check_preemption()
            if self.draining or self._stop:
                break
            # An idle fleet still supervises its workers: a replica that
            # dies with no traffic is replaced BEFORE the next burst, so a
            # detected failure also ticks the autoscaler (below-min
            # replacement) without waiting for a step. The same sweep
            # probes quarantined hosts: a healed partition re-admits the
            # host so replacements can land there again.
            if self._check_worker_health() and self.autoscaler is not None:
                self.autoscaler.tick()
            self.router.poll_hosts()
            self._wake.wait(idle_wait)
            self._wake.clear()
        # Drain whatever raced in while breaking out.
        self.draining = True
        self.drain()
        self._finished = True
        self._consume_inbox()  # refuse (DrainingError) anything left parked
        self.close()

    def close(self) -> None:
        """Release what the driver owns (idempotent): the step watchdog's
        thread, the worker processes (or remote connections) of the
        fleet, an open profiler window and the metrics sink's TensorBoard
        writer. ``run_forever`` calls it on exit; the JSONL path calls it
        after its final drain."""
        if self._watchdog is not None:
            self._watchdog.stop()
        for eng in self.router.engines:
            closer = getattr(eng, "close", None)
            if closer is not None:
                closer()
        if self.profiler_capture is not None:
            self.profiler_capture.stop_if_active()
        if self.tracker is not None:
            self.tracker.close()

    def stop(self) -> None:
        """Ask ``run_forever`` to exit once idle (tests, clean shutdown)."""
        self._stop = True
        self._wake.set()
