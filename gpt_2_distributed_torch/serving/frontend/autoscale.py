"""Autoscaler: grow/shrink the replica fleet from queue-depth and SLO
signals (``gpt_2_distributed_tpu/serving/frontend/autoscale.py``).

A hysteresis state machine: one bad tick proves nothing, so every action
needs a streak of ticks that call for it.

* **Grow pressure** — per-replica queue depth at/above ``grow_queue_depth``,
  or any NEW shed / TTFT-SLO violation since the last tick (the router's
  counters; a shed means admission already judged the queue hopeless, which
  is stronger evidence than depth alone). ``grow_after`` consecutive
  pressured ticks trigger ``router.grow()``.
* **Shrink signal** — an empty queue AND total occupancy that would fit in
  one fewer replica (otherwise shrinking just re-queues work). ``shrink_after``
  consecutive idle ticks trigger ``router.retire()`` — deliberately slower
  than growth (capacity mistakes in the shrink direction cost user
  latency; in the grow direction they cost an idle replica).
* **Cooldown** — after any action, ``cooldown`` ticks pass before the next
  decision. A fresh replica changes the very signals being watched (its
  empty queue drags the mean down), so reacting to the pre-action reading
  would oscillate.
* **Replacement** — a replica FAILURE (the router's ``replica_failures``
  counter moved) is not ordinary pressure: capacity the deployment asked
  for is gone. While ``n_active`` sits below ``min_replicas`` the
  autoscaler grows immediately — no streak, no cooldown — unparking a
  retiree or building a fresh replica. Above the floor, new failures
  count as grow pressure and go through the normal hysteresis.

The autoscaler only *decides*; the router owns the mechanism (activate a
parked replica, retire the least-loaded). A retired replica keeps draining
through the driver's step loop, so shrink never drops an in-flight stream.
"""

from __future__ import annotations

from gpt_2_distributed_torch.obs.trace import get_tracer


class Autoscaler:
    """Hysteresis state machine over router load signals.

    ``router`` needs only the signal surface (duck-typed for unit tests):
    ``n_active``, ``max_batch``, ``total_queue_depth()``, ``shed_count``,
    ``slo_violations``, ``total_occupancy()``, ``grow()``, ``retire()``.
    """

    def __init__(
        self,
        router,
        *,
        min_replicas: int = 1,
        max_replicas: int | None = None,
        grow_queue_depth: float = 4.0,
        grow_after: int = 2,
        shrink_after: int = 8,
        cooldown: int = 4,
    ):
        if min_replicas < 1:
            raise ValueError(f"min_replicas={min_replicas} must be >= 1")
        if max_replicas is not None and max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas={max_replicas} < min_replicas={min_replicas}"
            )
        if grow_after < 1 or shrink_after < 1:
            raise ValueError("grow_after / shrink_after must be >= 1")
        if cooldown < 0:
            raise ValueError(f"cooldown={cooldown} must be >= 0")
        self.router = router
        self.min_replicas = min_replicas
        self.max_replicas = (max_replicas if max_replicas is not None
                             else router.max_replicas)
        self.grow_queue_depth = float(grow_queue_depth)
        self.grow_after = grow_after
        self.shrink_after = shrink_after
        self.cooldown = cooldown
        self._grow_streak = 0
        self._shrink_streak = 0
        self._cooldown_left = 0
        self._seen_sheds = router.shed_count
        self._seen_violations = router.slo_violations
        # getattr: a signal surface without the failure counter (a unit
        # test's scripted router) reads as no failures.
        self._seen_failures = getattr(router, "replica_failures", 0)
        self.scale_ups = 0
        self.scale_downs = 0
        self.replacements = 0
        self.ticks = 0

    def _pressure(self) -> bool:
        new_sheds = self.router.shed_count - self._seen_sheds
        new_viol = self.router.slo_violations - self._seen_violations
        fails = getattr(self.router, "replica_failures", 0)
        new_fails = fails - self._seen_failures
        self._seen_sheds = self.router.shed_count
        self._seen_violations = self.router.slo_violations
        self._seen_failures = fails
        depth_per_replica = (
            self.router.total_queue_depth() / max(self.router.n_active, 1)
        )
        return (depth_per_replica >= self.grow_queue_depth
                or new_sheds > 0 or new_viol > 0 or new_fails > 0)

    def _idle(self) -> bool:
        if self.router.total_queue_depth() > 0:
            return False
        fits_in_fewer = (
            self.router.total_occupancy()
            <= (self.router.n_active - 1) * self.router.max_batch
        )
        return fits_in_fewer

    def tick(self) -> str | None:
        """One scaling decision; returns "grow", "shrink", or None.

        Counter updates (shed/violation deltas) happen every tick, even
        inside cooldown — otherwise pressure that arrived *during* the
        cooldown would look new when it ends and double-trigger.
        """
        self.ticks += 1
        pressure = self._pressure()
        idle = self._idle()
        if self.router.n_active < self.min_replicas:
            # Failure dropped the fleet below its floor: replace NOW,
            # bypassing streaks and cooldown — waiting out hysteresis to
            # restore promised capacity only prolongs the degradation.
            try:
                grown = self.router.grow()
            except RuntimeError as e:
                # Building the replica failed (out of device memory, say).
                # Degrade loudly and take a cooldown so the refusal is not
                # retried every tick.
                import sys

                print(f"[autoscale] replacement failed: {e}",
                      file=sys.stderr, flush=True)
                get_tracer().event(
                    "autoscale", action="replace_failed",
                    replicas=self.router.n_active,
                )
                self._cooldown_left = self.cooldown
                grown = None
            if grown is not None:
                self.scale_ups += 1
                self.replacements += 1
                self._cooldown_left = self.cooldown
                get_tracer().event(
                    "autoscale", action="replace",
                    replicas=self.router.n_active,
                )
                return "replace"
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            return None
        if pressure:
            self._grow_streak += 1
            self._shrink_streak = 0
            if (self._grow_streak >= self.grow_after
                    and self.router.n_active < self.max_replicas):
                try:
                    self.router.grow()
                except RuntimeError as e:
                    # Building the replica failed: stay at this size.
                    import sys

                    print(f"[autoscale] grow failed: {e}",
                          file=sys.stderr, flush=True)
                    self._grow_streak = 0
                    self._cooldown_left = self.cooldown
                    return None
                self.scale_ups += 1
                self._grow_streak = 0
                self._cooldown_left = self.cooldown
                get_tracer().event(
                    "autoscale", action="grow", replicas=self.router.n_active,
                )
                return "grow"
        elif idle:
            self._shrink_streak += 1
            self._grow_streak = 0
            if (self._shrink_streak >= self.shrink_after
                    and self.router.n_active > self.min_replicas):
                self.router.retire()
                self.scale_downs += 1
                self._shrink_streak = 0
                self._cooldown_left = self.cooldown
                get_tracer().event(
                    "autoscale", action="shrink",
                    replicas=self.router.n_active,
                )
                return "shrink"
        else:
            self._grow_streak = 0
            self._shrink_streak = 0
        return None
