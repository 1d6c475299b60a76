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

The health checks of worker processes and remote hosts, the step
watchdog and fault injection come with the process-isolation slice.
"""

from __future__ import annotations

import collections
import concurrent.futures
import sys
import threading
from typing import TYPE_CHECKING, Callable, Sequence

from gpt_2_distributed_torch.obs.trace import get_tracer
from gpt_2_distributed_torch.serving.frontend.router import ReplicaRouter, ShedError

if TYPE_CHECKING:   # annotation-only: keeps this module importable
    from gpt_2_distributed_torch.serving.engine import (  # pragma: no cover
        RequestHandle,
    )  # without paying the torch import


class DrainingError(RuntimeError):
    """Submit refused: the driver is draining toward shutdown."""


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
        self.steps = 0
        self.draining = False
        # The JAX driver's step-watchdog count, pushed under its metric
        # name; no watchdog runs in this slice.
        self.watchdog_trips = 0
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

    def _metrics(self) -> dict[str, float]:
        return dict(watchdog_trips=float(self.watchdog_trips),
                    **self.router.metrics_snapshot())

    def step(self) -> int:
        """One fleet tick; returns tokens emitted. Ordering: capture start
        -> engine step(s) -> capture stop -> autoscaler -> finish callbacks
        -> metrics flush.

        Each replica's ``step()`` runs inside a containment wrapper: an
        exception fails THAT replica — ejected from routing, its requests
        migrated — and the fleet loop keeps going."""
        self._check_preemption()
        self._consume_inbox()
        self.steps += 1
        if self.profiler_capture is not None:
            self.profiler_capture.maybe_start(self.steps)
        emitted = 0
        for idx, eng in self.router.steppable():
            try:
                emitted += eng.step()
            except Exception as e:
                self._fail_replica(idx, f"{type(e).__name__}: {e}")
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
            self._wake.wait(idle_wait)
            self._wake.clear()
        # Drain whatever raced in while breaking out.
        self.draining = True
        self.drain()
        self._finished = True
        self._consume_inbox()  # refuse (DrainingError) anything left parked
        self.close()

    def close(self) -> None:
        """Release what the driver owns (idempotent): an open profiler
        window and the metrics sink's TensorBoard writer. ``run_forever``
        calls it on exit; the JSONL path calls it after its final drain."""
        if self.profiler_capture is not None:
            self.profiler_capture.stop_if_active()
        if self.tracker is not None:
            self.tracker.close()

    def stop(self) -> None:
        """Ask ``run_forever`` to exit once idle (tests, clean shutdown)."""
        self._stop = True
        self._wake.set()
