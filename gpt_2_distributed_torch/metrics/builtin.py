"""Built-in training metrics (``gpt_2_distributed_tpu/metrics/builtin.py``).

The metrics the port's training loop pushes or collects, under the JAX
package's names and formats:

* freq-1 ``train/``: loss, lr, grad_norm, epoch, batch, and the guard's
  skipped_steps / last_skip_reason / clipped_steps once nonzero, the
  loader's data_read_retries once nonzero, eval_loss;
* freq-1 ``perf/`` (collector): tokens_per_second, total_tokens, epoch_time,
  tokens_per_second_per_chip and mfu (only where the card's peak is known,
  ``utils/flops.py``);
* freq-20 ``mem/`` (collector): the CUDA caching allocator's current and
  peak allocation against the card's memory (``torch.cuda.memory_stats``),
  and the host process's resident memory.

The metrics of planes not ported yet (checkpoint saves, the multi-host
control plane, fused kernels, elastic resize, serving) come with them.
"""

from __future__ import annotations

import os
import time
from typing import TYPE_CHECKING

import torch

from gpt_2_distributed_torch.metrics.registry import (
    METRIC_REGISTRY,
    ReductionStrategy,
)

if TYPE_CHECKING:
    from gpt_2_distributed_torch.metrics.tracker import StatsTracker

GB = 1024**3
MB = 1024**2


# --- freq-1 training metrics (pushed by the training loop) ------------------

METRIC_REGISTRY.metric(
    "loss", reduction=ReductionStrategy.AVERAGE,
    cli_format="loss: {value:.4f}",
)(float)

METRIC_REGISTRY.metric(
    "lr", reduction=ReductionStrategy.CURRENT, cli_format="lr: {value:.2e}",
)(float)

METRIC_REGISTRY.metric(
    "grad_norm", reduction=ReductionStrategy.AVERAGE,
    cli_format="grad_norm: {value:.4f}",
)(float)

METRIC_REGISTRY.metric(
    "epoch", reduction=ReductionStrategy.CURRENT, cli_format="epoch: {value:.0f}",
)(float)

METRIC_REGISTRY.metric(
    "batch", reduction=ReductionStrategy.CURRENT, cli_format="batch: {value:.0f}",
)(lambda v: float(int(v)))

# The non-finite step guard: cumulative skipped steps (on the CLI line only
# once a skip happened), the SKIP_* code of the latest skip, and cumulative
# clip-then-apply steps.
METRIC_REGISTRY.metric(
    "skipped_steps", reduction=ReductionStrategy.CURRENT,
    cli_format="skipped: {value:.0f}",
)(lambda v: float(int(v)))

METRIC_REGISTRY.metric(
    "last_skip_reason", reduction=ReductionStrategy.CURRENT, cli_format=None,
)(lambda v: float(int(v)))

METRIC_REGISTRY.metric(
    "clipped_steps", reduction=ReductionStrategy.CURRENT,
    cli_format="clipped: {value:.0f}",
)(lambda v: float(int(v)))

# Data pipeline: cumulative transient shard-I/O retries, once nonzero.
METRIC_REGISTRY.metric(
    "data_read_retries", reduction=ReductionStrategy.CURRENT,
    cli_format="io_retry: {value:.0f}",
)(lambda v: float(int(v)))

# Periodic validation loss over the held-out shard (shard 0 is "val").
METRIC_REGISTRY.metric(
    "eval_loss", reduction=ReductionStrategy.CURRENT,
    tb_prefix="eval/", cli_format="eval_loss: {value:.4f}",
)(float)


# --- freq-1 performance collector ------------------------------------------


def collect_performance(tracker: "StatsTracker") -> dict[str, float]:
    """Tokens since the last CLI tick over the wall-clock since then, run
    totals, per-chip throughput and, where the peak is known, MFU."""
    now = time.perf_counter()
    dt = max(now - tracker.window_start_time, 1e-9)
    tok_s = tracker.window_tokens / dt
    out = {
        "tokens_per_second": tok_s,
        "total_tokens": float(tracker.total_tokens),
        "epoch_time": now - tracker.epoch_start_time,
        "tokens_per_second_per_chip": tok_s / tracker.n_chips,
    }
    if tracker.flops_per_token and tracker.peak_flops_per_chip:
        out["mfu"] = (
            out["tokens_per_second_per_chip"]
            * tracker.flops_per_token
            / tracker.peak_flops_per_chip
        )
    return out


for _name, _red, _fmt in (
    ("tokens_per_second", ReductionStrategy.CURRENT, "tok/s: {value:,.0f}"),
    ("total_tokens", ReductionStrategy.CURRENT, "total_tok: {value:,.0f}"),
    ("epoch_time", ReductionStrategy.CURRENT, "epoch_s: {value:.1f}"),
    ("tokens_per_second_per_chip", ReductionStrategy.CURRENT, "tok/s/chip: {value:,.0f}"),
    ("mfu", ReductionStrategy.CURRENT, "mfu: {value:.1%}"),
):
    METRIC_REGISTRY.metric(
        _name, reduction=_red, tb_prefix="perf/", cli_format=_fmt, collector=True,
    )(collect_performance)


# --- freq-20 memory collector ----------------------------------------------


def collect_memory(tracker: "StatsTracker") -> dict[str, float]:
    """The CUDA caching allocator's allocation on the tracker's device (none
    on the CPU) and the host process's resident memory."""
    out: dict[str, float] = {}
    dev = tracker.device
    if dev is not None and dev.type == "cuda":
        stats = torch.cuda.memory_stats(dev)
        in_use = stats.get("allocated_bytes.all.current", 0)
        peak = stats.get("allocated_bytes.all.peak", in_use)
        limit = torch.cuda.get_device_properties(dev).total_memory
        out["device_alloc_gb"] = in_use / GB
        out["device_limit_gb"] = limit / GB
        out["device_peak_alloc_gb"] = peak / GB
        out["device_utilization_pct"] = 100.0 * in_use / limit
    try:
        import psutil
    except ImportError:
        return out
    out["cpu_mb"] = psutil.Process(os.getpid()).memory_info().rss / MB
    return out


for _name, _red, _fmt in (
    ("device_alloc_gb", ReductionStrategy.AVERAGE, "hbm: {value:.2f}GB"),
    ("device_limit_gb", ReductionStrategy.CURRENT, None),
    ("device_peak_alloc_gb", ReductionStrategy.MAX, "hbm_peak: {value:.2f}GB"),
    ("device_utilization_pct", ReductionStrategy.AVERAGE, "hbm_util: {value:.0f}%"),
    ("cpu_mb", ReductionStrategy.SUM, "cpu: {value:.0f}MB"),
):
    METRIC_REGISTRY.metric(
        _name, frequency=20, reduction=_red, tb_prefix="mem/",
        cli_format=_fmt, collector=True,
    )(collect_memory)
