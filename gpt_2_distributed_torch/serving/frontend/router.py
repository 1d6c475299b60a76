"""Replica router: prefix-affinity load balancing + SLO-aware admission
over N :class:`ServingEngine` replicas
(``gpt_2_distributed_tpu/serving/frontend/router.py``).

The continuous-batching engine is single-replica by construction (one KV
pool, one decode program); serving heavy traffic means running several and
deciding, per request, which one. Two forces pull on that decision:

* **Prefix affinity.** A shared prompt prefix is served from a replica's
  prefix cache only if the request lands on the replica that *has* the
  blocks. The router probes every active replica's :class:`PrefixCache` with the
  request's leading token blocks (``peek_run`` — a read that doesn't
  touch LRU order or hit counters) and prefers the deepest hit. A
  hash-keyed *sticky map* (first-block token bytes -> last replica routed)
  covers the race where the prefix's first carrier is still prefilling
  (its blocks aren't registered yet) and the prefix-cache-off deployment,
  where the map alone keeps shared-prefix traffic co-located.
* **Load.** Affinity ties, cold prefixes, and ``policy="least_loaded"``
  fall back to the replica with the fewest queued + in-flight requests
  (ties break to the lowest index, so routing is deterministic for a
  deterministic submit order). ``policy="round_robin"`` ignores both
  signals — it exists as the control arm for the affinity benchmark.

SLO-aware admission: with ``queue_slo_ms`` set, the router estimates the
chosen replica's queue wait (queued requests x an EMA of recent request
service time / slots) and **sheds** the request (:class:`ShedError`, a 503
at the HTTP layer) instead of enqueueing work that would blow the target —
bounded queues are what keep the engine's watermark admission operating in
its design regime instead of absorbing an unbounded backlog. With
``ttft_slo_ms`` set, every finished request's measured TTFT is checked
against the target and violations are counted (``slo_violations``) — the
autoscaler treats sheds and violations as grow pressure, closing the loop.

Failure containment: ``fail_replica`` permanently ejects a replica whose
``step()`` raised, extracts its in-flight requests with their preemption
state, and re-submits them to healthy replicas as recompute-prefill
resumes — the streams continue bit-identically with zero re-emitted
tokens, because migration is the engine's preemption with a different
destination engine.

Routing changes WHICH replica computes a stream, never WHAT it computes:
each engine's exactness contract (streams equal to
``generate_cached(batch=1)``) is per-request and replica-independent, so
the fleet inherits it unchanged. ``tests/test_torch_frontend.py`` asserts
it, and that every request lands on the replica the JAX router picks.

Requests carry the port engine's ``seed`` (the JAX router's ``rng``).
Host-domain failures and worker processes come with the process-isolation
slice; their metrics read 0 here.
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING, Callable, Sequence

from gpt_2_distributed_torch.obs.trace import get_tracer

if TYPE_CHECKING:   # annotation-only: keeps this module importable
    from gpt_2_distributed_torch.serving.engine import (  # pragma: no cover
        RequestHandle,
        ServingEngine,
    )  # without paying the torch import

ROUTE_POLICIES = ("affinity", "least_loaded", "round_robin")


class ShedError(RuntimeError):
    """Request refused by SLO admission — the caller should back off
    (the HTTP front end maps this to 503 + Retry-After)."""


class ReplicaRouter:
    """Routes submits across engine replicas; owns fleet-level accounting.

    Replicas are created lazily by ``make_engine`` and never destroyed:
    ``retire`` only deactivates (stops routing to) a replica, keeping its
    weights, KV pools and built kernels resident for the next ``grow``. A
    retired replica keeps stepping until its in-flight requests drain (the
    driver steps any engine with work).
    """

    def __init__(
        self,
        make_engine: Callable[[], ServingEngine],
        *,
        replicas: int = 1,
        max_replicas: int | None = None,
        policy: str = "affinity",
        ttft_slo_ms: float | None = None,
        queue_slo_ms: float | None = None,
        service_ms_prior: float = 100.0,
    ):
        if replicas < 1:
            raise ValueError(f"replicas={replicas} must be >= 1")
        self.max_replicas = max_replicas if max_replicas is not None else replicas
        if self.max_replicas < replicas:
            raise ValueError(
                f"max_replicas={self.max_replicas} < replicas={replicas}"
            )
        if policy not in ROUTE_POLICIES:
            raise ValueError(
                f"policy={policy!r}: expected one of {ROUTE_POLICIES}"
            )
        if ttft_slo_ms is not None and ttft_slo_ms <= 0:
            raise ValueError(f"ttft_slo_ms={ttft_slo_ms} must be > 0")
        if queue_slo_ms is not None and queue_slo_ms <= 0:
            raise ValueError(f"queue_slo_ms={queue_slo_ms} must be > 0")
        self._make_engine = make_engine
        self.policy = policy
        self.ttft_slo_ms = ttft_slo_ms
        self.queue_slo_ms = queue_slo_ms
        self.engines: list[ServingEngine] = []
        self._active: list[bool] = []
        self._failed: list[bool] = []
        # The fleet size the deployment asked for: /healthz reports
        # "degraded" while failures hold n_active below this.
        self.target_replicas = int(replicas)
        self.replica_failures = 0   # replicas marked FAILED, ever
        self.migrated = 0           # requests moved off failed replicas
        self._sticky: dict[bytes, int] = {}
        self._rr_next = 0
        self._next_rid = 0
        # EMA of per-request wall time (submit -> finish), seeding the
        # queue-wait estimate before the first finish lands.
        self._ema_service_ms = float(service_ms_prior)
        self.affinity_hits = 0      # routes decided by cache probe / sticky map
        self.shed_count = 0
        self.slo_violations = 0
        self.routed = 0
        self._prompt_tokens_submitted = 0
        for _ in range(replicas):
            self.grow()

    # ------------------------------------------------------------- fleet

    @property
    def n_active(self) -> int:
        return sum(self._active)

    @property
    def n_failed(self) -> int:
        return sum(self._failed)

    def active_indices(self) -> list[int]:
        return [i for i, a in enumerate(self._active) if a]

    def grow(self) -> int | None:
        """Activate one replica (reviving a parked one before building a
        new one — FAILED replicas are never revived); returns its index,
        or None at ``max_replicas``. Failed replicas still count against
        the ceiling: their pools are abandoned, not reclaimed."""
        for i, a in enumerate(self._active):
            if not a and not self._failed[i]:
                self._active[i] = True
                eng = self.engines[i]
                get_tracer().event("scale_up", replica=i,
                                   replicas=self.n_active,
                                   mesh=eng.serve.mesh or "single",
                                   devices=eng.serve.mesh_devices)
                return i
        if len(self.engines) >= self.max_replicas:
            return None
        self.engines.append(self._make_engine())
        self._active.append(True)
        self._failed.append(False)
        i = len(self.engines) - 1
        eng = self.engines[i]
        get_tracer().event("scale_up", replica=i, replicas=self.n_active,
                           mesh=eng.serve.mesh or "single",
                           devices=eng.serve.mesh_devices)
        return i

    def fail_replica(self, idx: int, reason: str = "step exception") -> int:
        """Mark replica ``idx`` FAILED and migrate its in-flight requests.

        The replica leaves routing AND the step loop permanently (unlike
        ``retire``, which parks a healthy engine). Its live requests are
        extracted with their preemption state (generated tokens, pending
        decode input, sampling generator) and re-enter healthy replicas as recompute-prefill
        resumes — bit-identical continuation, zero re-emitted tokens. If
        no replica is active the router tries ``grow()`` once; requests
        that still have nowhere to go finish with reason ``"failed"``.
        Returns the number of requests migrated.
        """
        if self._failed[idx]:
            return 0
        return self._adopt_wave(self._eject(idx, reason), idx)

    def _eject(self, idx: int, reason: str) -> list:
        """Mark one replica FAILED and pull its in-flight requests out."""
        self._failed[idx] = True
        was_active = self._active[idx]
        self._active[idx] = False
        self.replica_failures += 1
        get_tracer().event(
            "replica_fail", replica=idx, reason=reason,
            active=was_active, replicas=self.n_active,
        )
        # Sticky entries pointing at the dead replica would miss the
        # _active guard anyway; drop them so the map stays small.
        self._sticky = {k: i for k, i in self._sticky.items() if i != idx}
        try:
            reqs = self.engines[idx].extract_inflight()
        except Exception:
            reqs = []   # engine too corrupt even for host-side extraction
        return reqs

    def _adopt_wave(self, reqs: list, src: int) -> int:
        """Re-place requests ejected from replica ``src`` onto healthy
        replicas as recompute-prefill resumes — bit-identical
        continuation, zero re-emitted tokens."""
        if reqs and not self.active_indices():
            self.grow()   # last resort; None at max_replicas
        moved = 0
        tracer = get_tracer()
        for req in reqs:
            active = self.active_indices()
            if not active:
                req._finish("failed")
                continue
            dst = min(active, key=lambda i: (self._load(i), i))
            self.engines[dst].adopt(req)
            req.replica = dst
            self.migrated += 1
            moved += 1
            tracer.event("migrate", rid=req.id, src=src, dst=dst,
                         n_generated=len(req.generated))
        return moved

    def retire(self) -> int | None:
        """Deactivate the least-loaded active replica: no new routes land
        on it, in-flight work drains out through the normal step loop, and
        its compiled programs stay warm for the next ``grow``. Returns the
        index, or None when only one replica is active."""
        idx = self.active_indices()
        if len(idx) <= 1:
            return None
        victim = min(idx, key=lambda i: (self._load(i), i))
        self._active[victim] = False
        get_tracer().event("scale_down", replica=victim,
                           replicas=self.n_active)
        return victim

    def _load(self, i: int) -> int:
        eng = self.engines[i]
        return eng.queue_depth + eng.occupancy

    # ------------------------------------------------------------ routing

    def _sticky_key(self, prompt: Sequence[int]) -> bytes | None:
        import numpy as np

        bs = self.engines[0].serve.block_size
        if len(prompt) < bs:
            return None
        return np.asarray(prompt[:bs], np.int32).tobytes()

    def _route(self, prompt: Sequence[int]) -> tuple[int, int, str]:
        """(replica index, affinity blocks, how) for one prompt."""
        active = self.active_indices()
        if self.policy == "round_robin":
            i = active[self._rr_next % len(active)]
            self._rr_next += 1
            return i, 0, "round_robin"
        if self.policy == "affinity":
            best, best_blocks = [], 0
            for i in active:
                cache = self.engines[i].prefix_cache
                blocks = cache.peek_run(prompt) if cache is not None else 0
                if blocks > best_blocks:
                    best, best_blocks = [i], blocks
                elif blocks == best_blocks and best_blocks > 0:
                    best.append(i)
            if best_blocks > 0:
                return (min(best, key=lambda i: (self._load(i), i)),
                        best_blocks, "affinity")
            key = self._sticky_key(prompt)
            if key is not None:
                i = self._sticky.get(key)
                if i is not None and self._active[i]:
                    return i, 0, "sticky"
        return min(active, key=lambda i: (self._load(i), i)), 0, "least_loaded"

    def _est_queue_wait_ms(self, i: int) -> float:
        """Predicted wait for a request joining replica i's queue: queued
        requests ahead of it, served ``max_batch`` at a time, each batch
        turning over in roughly one EMA service time."""
        eng = self.engines[i]
        return (eng.queue_depth / max(eng.serve.max_batch, 1)) \
            * self._ema_service_ms

    # ------------------------------------------------------------- submit

    def allocate_rid(self) -> int:
        """A fleet-unique request id for trace events about submissions
        that never reach ``submit`` (draining/validation refusals), so
        they still get a per-request row in ``obs_report --frontend``."""
        rid = self._next_rid
        self._next_rid += 1
        return rid

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        *,
        seed: int = 0,
        on_token: Callable[[RequestHandle, int], None] | None = None,
        timeout_s: float | None = None,
    ) -> RequestHandle:
        """Route + submit one request. Raises :class:`ShedError` when the
        queue SLO predicts the wait would blow the target, and the same
        ``ValueError`` as ``ServingEngine.submit`` for invalid requests
        (bad requests are the CALLER's fault and never counted as sheds).
        """
        rid = self._next_rid
        self._next_rid += 1
        idx, aff_blocks, how = self._route(prompt)
        now = time.monotonic()
        tracer = get_tracer()
        tracer.event("route", ts=now, rid=rid, replica=idx,
                     affinity_blocks=aff_blocks, policy=how)
        if self.queue_slo_ms is not None:
            est = self._est_queue_wait_ms(idx)
            if est > self.queue_slo_ms:
                self.shed_count += 1
                tracer.event("shed", rid=rid, replica=idx,
                             est_queue_wait_ms=round(est, 2))
                raise ShedError(
                    f"request {rid} shed: predicted queue wait "
                    f"{est:.0f} ms on replica {idx} exceeds --queue_slo_ms "
                    f"{self.queue_slo_ms:.0f}"
                )
        handle = self.engines[idx].submit(
            prompt, max_new_tokens, seed=seed, on_token=on_token, rid=rid,
            timeout_s=timeout_s,
        )
        handle.replica = idx
        if how in ("affinity", "sticky"):
            self.affinity_hits += 1
        self.routed += 1
        self._prompt_tokens_submitted += len(prompt)
        key = self._sticky_key(prompt)
        if key is not None:
            self._sticky[key] = idx
        return handle

    def observe_finish(self, handle: RequestHandle) -> None:
        """Fold a finished request into the SLO accounting (the driver
        calls this once per handle, the step it completes)."""
        if handle.finish_time is not None and handle.submit_time is not None:
            wall_ms = (handle.finish_time - handle.submit_time) * 1e3
            self._ema_service_ms += 0.2 * (wall_ms - self._ema_service_ms)
        if (
            self.ttft_slo_ms is not None
            and handle.first_token_time is not None
            and (handle.first_token_time - handle.submit_time) * 1e3
            > self.ttft_slo_ms
        ):
            self.slo_violations += 1

    # ------------------------------------------------------------ queries

    def has_work(self) -> bool:
        return any(
            e.has_work() for i, e in enumerate(self.engines)
            if not self._failed[i]
        )

    def steppable(self) -> list[tuple[int, ServingEngine]]:
        """(index, engine) pairs the driver should step this tick: every
        engine with queued or in-flight requests — retired replicas
        included, so parked engines still drain; FAILED replicas excluded,
        so the step loop never touches a dead engine."""
        return [
            (i, e) for i, e in enumerate(self.engines)
            if not self._failed[i] and e.has_work()
        ]

    def total_queue_depth(self) -> int:
        return sum(e.queue_depth for e in self.engines)

    def total_occupancy(self) -> int:
        return sum(e.occupancy for e in self.engines)

    @property
    def max_batch(self) -> int:
        return self.engines[0].serve.max_batch

    def metrics_snapshot(self) -> dict[str, float]:
        """Fleet-level serving-load metrics; single-replica keys aggregate
        so the ``--tb_dir`` sink reads the same names either way (each is
        registered in ``metrics/builtin.py``). The keys are the JAX
        router's; the worker and host planes' read 0 (not ported)."""
        admitted = sum(e.stats["admitted"] for e in self.engines)
        return {
            "queue_wait_ms": sum(
                e.stats["queue_wait_ms"] for e in self.engines
            ) / max(admitted, 1),
            "preempted": float(
                sum(e.stats["preemptions"] for e in self.engines)
            ),
            "prefix_cached_tokens": float(
                sum(e.stats["prefix_hit_tokens"] for e in self.engines)
            ),
            "serve_queue_depth": float(self.total_queue_depth()),
            "serve_occupancy": float(self.total_occupancy()),
            "serve_replicas": float(self.n_active),
            "serve_shed": float(self.shed_count),
            "route_affinity_hits": float(self.affinity_hits),
            "slo_violations": float(self.slo_violations),
            "replica_failures": float(self.replica_failures),
            "requests_migrated": float(self.migrated),
            "requests_timed_out": float(
                sum(e.stats["timeouts"] for e in self.engines)
            ),
            "serve_mesh_devices": float(
                sum(e.serve.mesh_devices for e in self.engines)
            ),
            "kv_pool_bytes_per_device": float(
                max(e.kv_pool_bytes_per_device for e in self.engines)
            ),
            "prefill_batched": float(
                sum(e.stats["prefill_batched"] for e in self.engines)
            ),
            # Speculative decoding, summed over the replicas (0 where
            # none drafts).
            **{key: float(sum(e.stats[key] for e in self.engines))
               for key in ("spec_draft_tokens", "spec_accepted_tokens",
                           "spec_rollbacks", "draft_ms", "verify_ms")},
            # Worker processes and remote hosts come with the process-
            # isolation slice: in-process replicas have neither.
            "worker_restarts": 0.0,
            "host_failures": 0.0,
            "hosts_active": 0.0,
        }

    def aggregate_hit_rate(self) -> float:
        """Fleet prefix-cache hit rate: prompt tokens served from cache /
        prompt tokens submitted, across every replica (the number the
        affinity-vs-round-robin benchmark compares)."""
        hit = sum(e.stats["prefix_hit_tokens"] for e in self.engines)
        return hit / max(self._prompt_tokens_submitted, 1)
