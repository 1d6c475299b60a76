"""StatsTracker: buffered, windowed metric runtime with a CLI and a
TensorBoard sink (``gpt_2_distributed_tpu/metrics/tracker.py``).

Values pushed via ``update(step, **metrics)`` are processed and buffered
into per-metric windows (deque, maxlen 50); pull-style collectors run at
their declared frequencies; every ``tb_every`` steps (with a ``tb_dir``)
every metric's window, collapsed by its reduction, goes to TensorBoard
under the JAX package's tags, the writer flushed at most every 30 s; every
``cli_every`` steps one line of training metrics is printed (``step N |
loss: ... | ...``), with memory metrics on their own ``MEMORY:`` line, and
the token-rate window resets.

The TensorBoard sink needs ``tensorboardX``, imported only when a
``tb_dir`` is given; without it the tracker refuses to start. The
tracker reduces nothing across processes: the step and the eval
all-reduce loss, grad norm and eval loss themselves, and counters stay
per process, as in the JAX package.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any

import torch

from gpt_2_distributed_torch.metrics import builtin as _builtin  # noqa: F401  (registers built-ins)
from gpt_2_distributed_torch.metrics.registry import METRIC_REGISTRY, MetricDefinition

WINDOW_SIZE = 50
TB_FLUSH_INTERVAL_S = 30


def open_tb_writer(tb_dir: str):
    """A ``tensorboardX.SummaryWriter`` on ``tb_dir``; RuntimeError naming
    the missing package when it is not installed."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError as e:
        raise RuntimeError(
            f"a TensorBoard directory ({tb_dir!r}) needs the tensorboardX "
            f"package, which is not installed ({e})"
        ) from e
    return SummaryWriter(log_dir=tb_dir)


class StatsTracker:
    """Training metrics runtime with a CLI and a TensorBoard sink.

    ``batch_size`` is the effective batch of one optimizer step
    (micro-batch x grad_accum), so ``tokens_per_step = batch_size x
    seq_len``, counted over all ``n_chips`` devices of a mesh.
    ``device`` is where the memory collector reads the CUDA allocator (a
    CPU device: host memory only). ``printing=False`` (every process of a
    mesh but the first) keeps the metrics, prints nothing and writes no
    TensorBoard file. The serving sink passes ``batch_size=0`` and pushes
    every update with ``count_tokens=False``."""

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
        tb_dir: str | None = None,
        tb_every: int = 1,
    ) -> None:
        self.registry = METRIC_REGISTRY
        self.cli_every = max(1, int(cli_every))
        self.tb_every = max(1, int(tb_every))
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
        self._last_flush = time.perf_counter()
        self.writer = open_tb_writer(tb_dir) if tb_dir and printing else None

    def start_epoch(self) -> None:
        """Reset the epoch wall-clock and the token-rate window."""
        self.epoch_start_time = time.perf_counter()
        self.window_start_time = time.perf_counter()
        self.window_tokens = 0

    def update(self, step: int, count_tokens: bool = True, **metrics: Any) -> None:
        """Record one optimizer step's metrics. ``count_tokens=False`` marks
        an out-of-band update (a periodic eval result) for a step whose
        training update was already recorded: it buffers the values and
        neither counts tokens, runs collectors nor prints; on the
        ``tb_every`` cadence it writes the pushed metrics' windows. A name
        that is not registered (``metrics/builtin.py``) raises KeyError."""
        pushed = []
        for name, value in metrics.items():
            d = self.registry.get(name)
            if d is None:
                raise KeyError(f"metric {name!r} is not registered (metrics/builtin.py)")
            self._buffer(name, float(d.processor(value)) if d.processor else float(value))
            pushed.append(d)
        if not count_tokens:
            if self.writer is not None and step % self.tb_every == 0:
                for d in pushed:
                    self.writer.add_scalar(d.tb_tag, self._window_value(d), step)
            return

        self.total_tokens += self.tokens_per_step
        self.window_tokens += self.tokens_per_step
        for d in self.registry.due_collectors(step):
            for name, v in d.collector(self).items():
                self._buffer(name, float(v))
        if self.writer is not None and step % self.tb_every == 0:
            self._write_tensorboard(step)
        if step % self.cli_every == 0:
            if self.printing:
                self._print_cli(step)
            self.window_tokens = 0
            self.window_start_time = time.perf_counter()

    def close(self) -> None:
        """Flush and release the TensorBoard writer."""
        if self.writer is not None:
            self.writer.flush()
            self.writer.close()
            self.writer = None

    def _write_tensorboard(self, step: int) -> None:
        """Every metric's window collapsed by its declared reduction."""
        for d in self.registry.all():
            v = self._window_value(d)
            if v is not None:
                self.writer.add_scalar(d.tb_tag, v, step)
        now = time.perf_counter()
        if now - self._last_flush >= TB_FLUSH_INTERVAL_S:
            self.writer.flush()
            self._last_flush = now

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
