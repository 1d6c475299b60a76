"""StatsTracker: buffered, windowed metric runtime with a CLI sink
(``gpt_2_distributed_tpu/metrics/tracker.py``).

Values pushed via ``update(step, **metrics)`` are processed and buffered
into per-metric windows (deque, maxlen 50); pull-style collectors run at
their declared frequencies; every ``cli_every`` steps one line of training
metrics is printed (``step N | loss: ... | ...``), with memory metrics on
their own ``MEMORY:`` line, and the token-rate window resets.

Left out until the slices that need them: the TensorBoard sink (it needs
``tensorboardX``; the training CLI refuses ``--log_dir``) and the
cross-process reduction of metrics (single process here).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any

import torch

from gpt_2_distributed_torch.metrics import builtin as _builtin  # noqa: F401  (registers built-ins)
from gpt_2_distributed_torch.metrics.registry import METRIC_REGISTRY, MetricDefinition

WINDOW_SIZE = 50


class StatsTracker:
    """Training metrics runtime with a CLI sink.

    ``batch_size`` is the effective batch of one optimizer step
    (micro-batch x grad_accum), so ``tokens_per_step = batch_size x
    seq_len``, counted over all ``n_chips`` devices of a mesh.
    ``device`` is where the memory collector reads the CUDA allocator (a
    CPU device: host memory only). ``printing=False`` (every process of a
    mesh but the first) keeps the metrics and prints nothing."""

    def __init__(
        self,
        batch_size: int,
        seq_len: int,
        cli_every: int = 20,
        flops_per_token: float | None = None,
        peak_flops_per_chip: float | None = None,
        device: torch.device | None = None,
        n_chips: int = 1,
        printing: bool = True,
    ) -> None:
        self.registry = METRIC_REGISTRY
        self.cli_every = max(1, int(cli_every))
        self.device = device
        self.n_chips = n_chips
        self.printing = printing
        self.tokens_per_step = int(batch_size) * int(seq_len)
        self.flops_per_token = flops_per_token
        self.peak_flops_per_chip = peak_flops_per_chip
        self.buffers: dict[str, deque] = {}
        self.total_tokens = 0
        self.window_tokens = 0
        self.window_start_time = time.perf_counter()
        self.epoch_start_time = time.perf_counter()

    def start_epoch(self) -> None:
        """Reset the epoch wall-clock and the token-rate window."""
        self.epoch_start_time = time.perf_counter()
        self.window_start_time = time.perf_counter()
        self.window_tokens = 0

    def update(self, step: int, count_tokens: bool = True, **metrics: Any) -> None:
        """Record one optimizer step's metrics. ``count_tokens=False`` marks
        an out-of-band update (a periodic eval result) for a step whose
        training update was already recorded: it buffers the values and
        neither counts tokens, runs collectors nor prints. A name that is
        not registered (``metrics/builtin.py``) raises KeyError."""
        for name, value in metrics.items():
            d = self.registry.get(name)
            if d is None:
                raise KeyError(f"metric {name!r} is not registered (metrics/builtin.py)")
            self._buffer(name, float(d.processor(value)) if d.processor else float(value))
        if not count_tokens:
            return

        self.total_tokens += self.tokens_per_step
        self.window_tokens += self.tokens_per_step
        for d in self.registry.due_collectors(step):
            for name, v in d.collector(self).items():
                self._buffer(name, float(v))
        if step % self.cli_every == 0:
            if self.printing:
                self._print_cli(step)
            self.window_tokens = 0
            self.window_start_time = time.perf_counter()

    def _buffer(self, name: str, value: float) -> None:
        if name not in self.buffers:
            self.buffers[name] = deque(maxlen=WINDOW_SIZE)
        self.buffers[name].append(value)

    def _window_value(self, d: MetricDefinition) -> float | None:
        buf = self.buffers.get(d.name)
        if not buf:
            return None
        return d.reduction.reduce(list(buf))

    def _print_cli(self, step: int) -> None:
        """Training metrics on one line, memory on its own ``MEMORY:`` line."""
        main_parts, mem_parts = [], []
        for d in self.registry.all():
            if d.cli_format is None:
                continue
            v = self._window_value(d)
            if v is None:
                continue
            text = d.cli_format.format(name=d.name, value=v)
            (mem_parts if d.tb_prefix == "mem/" else main_parts).append(text)
        if main_parts:
            print(f"step {step:>7d} | " + " | ".join(main_parts), flush=True)
        if mem_parts:
            print("MEMORY: " + " | ".join(mem_parts), flush=True)
