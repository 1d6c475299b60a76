"""Built-in training metrics (``gpt_2_distributed_tpu/metrics/builtin.py``).

The metrics the port's training loop pushes or collects, under the JAX
package's names and formats:

* freq-1 ``train/``: loss, lr, grad_norm, epoch, batch, and the guard's
  skipped_steps / last_skip_reason / clipped_steps once nonzero, the
  loader's data_read_retries, the saver's save_failures and the desync
  detector's desync_detected once nonzero, eval_loss; elastic_resizes and
  resume_world_delta (TensorBoard only) in a run that resumed at another
  device count than its checkpoint's;
* freq-1 ``perf/`` (collector): tokens_per_second, total_tokens, epoch_time,
  tokens_per_second_per_chip and mfu (only where the card's peak is known,
  ``utils/flops.py``);
* freq-20 ``mem/`` (collector): the CUDA caching allocator's current and
  peak allocation against the card's memory (``torch.cuda.memory_stats``),
  and the host process's resident memory;
* ``serve/`` (TensorBoard only): the serving-load metrics both serving
  entry points push through ``EngineDriver`` every ``--metrics_every``
  engine steps (``ReplicaRouter.metrics_snapshot``).
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

# Checkpoint saves (checkpoint.CheckpointSaver) that failed for good
# (retries exhausted, or a background write that died), once nonzero: the
# run goes on, with gaps in its save cadence.
METRIC_REGISTRY.metric(
    "save_failures", reduction=ReductionStrategy.CURRENT,
    cli_format="save_fail: {value:.0f}",
)(lambda v: float(int(v)))

# The desync detector (coordination.py): fingerprint checks in which some
# process's parameter fingerprint disagreed with the mesh, once nonzero.
# Each detection asks for the agreed rollback.
METRIC_REGISTRY.metric(
    "desync_detected", reduction=ReductionStrategy.CURRENT,
    cli_format="desync: {value:.0f}",
)(lambda v: float(int(v)))

# Elastic resume (train.py): pushed only by a run that resumed at another
# device count than its checkpoint was saved at. elastic_resizes is 1 for
# the life of such a run; resume_world_delta is the new minus the old
# device count, so a shrink plots negative. TensorBoard only: the
# [elastic] line narrates the resize once.
METRIC_REGISTRY.metric(
    "elastic_resizes", reduction=ReductionStrategy.CURRENT, cli_format=None,
)(lambda v: float(int(v)))
METRIC_REGISTRY.metric(
    "resume_world_delta", reduction=ReductionStrategy.CURRENT, cli_format=None,
)(lambda v: float(int(v)))

# Periodic validation loss over the held-out shard (shard 0 is "val").
METRIC_REGISTRY.metric(
    "eval_loss", reduction=ReductionStrategy.CURRENT,
    tb_prefix="eval/", cli_format="eval_loss: {value:.4f}",
)(float)


# --- serving-load metrics (pushed by the serving --tb_dir sink) ------------
# TensorBoard only (cli_format None): the serving CLI's stderr summary
# narrates totals. All CURRENT: each flush pushes the fleet's
# metrics_snapshot() as of now (the wait is a running mean, the counters
# are cumulative). The names are the JAX package's, the keys of
# serving/frontend/router.py::ReplicaRouter.metrics_snapshot plus the
# EngineDriver's watchdog_trips; those of planes not ported yet (worker
# processes, remote hosts, the step watchdog) read 0.

for _name in (
    "queue_wait_ms",            # mean enqueue->admission gap per admission
    "preempted",                # cumulative pool-pressure swap-outs
    "prefix_cached_tokens",     # cumulative prompt tokens served from cache
    "serve_queue_depth",        # requests waiting for a slot, as of the flush
    "serve_occupancy",          # occupied decode slots, as of the flush
    "serve_replicas",           # active engine replicas, as of the flush
    "serve_shed",               # cumulative SLO-admission refusals (503s)
    "route_affinity_hits",      # cumulative prefix-affinity route decisions
    "slo_violations",           # cumulative finished requests over TTFT SLO
    "replica_failures",         # cumulative replicas marked FAILED
    "requests_migrated",        # cumulative requests moved off failed replicas
    "requests_timed_out",       # cumulative deadline evictions (504s)
    "watchdog_trips",           # cumulative step-watchdog firings
    "serve_mesh_devices",       # devices across the fleet's replicas
    "kv_pool_bytes_per_device",  # largest per-device KV pool footprint
    "prefill_batched",          # cumulative extra rows batched into prefills
    "worker_restarts",          # cumulative replacement worker respawns
    "host_failures",            # cumulative whole-host domains lost
    "hosts_active",             # remote fleet hosts not quarantined
    "spec_draft_tokens",        # cumulative draft-model proposals
    "spec_accepted_tokens",     # cumulative proposals the target accepted
    "spec_rollbacks",           # cumulative verify passes with a rejection
    "draft_ms",                 # cumulative draft-pass wall time
    "verify_ms",                # cumulative target-verify wall time
):
    METRIC_REGISTRY.metric(
        _name, reduction=ReductionStrategy.CURRENT, tb_prefix="serve/",
        cli_format=None,
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
