"""Decorator-based metric registry (``gpt_2_distributed_tpu/metrics/
registry.py``, the port's own copy).

A metric is a declarative ``MetricDefinition`` — name, collection frequency,
window-reduction strategy, TensorBoard prefix, CLI format, optional
processor (transform a pushed value) or collector (pull values from the
system) — held in a process-global ``MetricRegistry`` and attached via a
decorator.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Callable


class ReductionStrategy(enum.Enum):
    """How a metric's buffered window collapses to one value."""

    AVERAGE = "average"
    SUM = "sum"
    CURRENT = "current"  # last value wins
    MAX = "max"
    MIN = "min"

    def reduce(self, values: list[float]) -> float:
        if not values:
            raise ValueError("cannot reduce an empty window")
        if self is ReductionStrategy.AVERAGE:
            return sum(values) / len(values)
        if self is ReductionStrategy.SUM:
            return sum(values)
        if self is ReductionStrategy.CURRENT:
            return values[-1]
        if self is ReductionStrategy.MAX:
            return max(values)
        return min(values)


@dataclass(frozen=True)
class MetricDefinition:
    """One metric's declarative spec.

    ``processor`` transforms a value pushed through ``StatsTracker.update``;
    ``collector`` is a pull-style source invoked by the tracker every
    ``frequency`` steps, returning ``{metric_name: value}`` for one or more
    metrics (the perf and memory metrics). ``tb_prefix`` is the JAX
    package's TensorBoard group; the CLI line prints the ``mem/`` group on
    a line of its own. The cross-process reduction declarations come with
    the DDP slice.
    """

    name: str
    frequency: int = 1                      # collect/process every N optimizer steps
    reduction: ReductionStrategy = ReductionStrategy.AVERAGE
    tb_prefix: str = "train/"
    cli_format: str | None = "{name}: {value:.4f}"  # None = not on the CLI line
    processor: Callable[[Any], float] | None = None
    collector: Callable[..., dict[str, float]] | None = None


class MetricRegistry:
    """Name -> definition mapping with decorator registration."""

    def __init__(self) -> None:
        self._metrics: dict[str, MetricDefinition] = {}

    def register(self, definition: MetricDefinition) -> None:
        if definition.name in self._metrics:
            raise ValueError(f"metric {definition.name!r} already registered")
        self._metrics[definition.name] = definition

    def metric(self, name: str, **kwargs) -> Callable:
        """Decorator: the wrapped function becomes the metric's processor
        (or its collector, if ``collector=True`` is passed)."""
        as_collector = kwargs.pop("collector", False)

        def wrap(fn: Callable) -> Callable:
            if as_collector:
                definition = MetricDefinition(name=name, collector=fn, **kwargs)
            else:
                definition = MetricDefinition(name=name, processor=fn, **kwargs)
            self.register(definition)
            return fn

        return wrap

    def get(self, name: str) -> MetricDefinition | None:
        return self._metrics.get(name)

    def all(self) -> list[MetricDefinition]:
        return list(self._metrics.values())

    def collectors(self) -> list[MetricDefinition]:
        """Definitions that pull values themselves, deduped by collector fn
        (one collector may feed several metric names)."""
        seen: set[int] = set()
        out = []
        for d in self._metrics.values():
            if d.collector is not None and id(d.collector) not in seen:
                seen.add(id(d.collector))
                out.append(d)
        return out

    def due_collectors(self, step: int) -> list[MetricDefinition]:
        return [d for d in self.collectors() if step % d.frequency == 0]


#: Process-global default registry.
METRIC_REGISTRY = MetricRegistry()
