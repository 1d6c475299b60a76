"""Training CLI of the PyTorch port (``gpt_2_distributed_tpu/train.py``):
one process on one device, or one process per device of a data / fsdp /
sequence-parallel mesh.

    python -m gpt_2_distributed_torch.train --data_dir <shards>
    torchrun --nproc_per_node 2 -m gpt_2_distributed_torch.train \
        --data_dir <shards> --training_mode ddp     # or fsdp, --mesh data=2,sp=2

The flag surface is the JAX CLI's. What this slice runs: the model and data
flags, batch / grad-accum / epochs, the learning-rate schedule, AdamW
weight decay, periodic eval, the non-finite step guard with its per-layer
clip fallback and ``--inject_nan_at``, ``--dropout``, ``--attention_impl``,
``--fused_layers``, ``--fused_matmul``, ``--device_prefetch`` (pinned host
batches copied with ``non_blocking=True`` one optimizer step ahead),
``--device``, ``--training_mode {local,dp,ddp,fsdp}``, ``--mesh
data=D,fsdp=F,sp=S`` and ``--shard_update {off,on,auto}``, and
observability: ``--trace_dir`` (span traces of the step loop,
``obs/trace.py``: ``step(n)`` holding
``data_fetch``, ``h2d``, ``step_dispatch``, ``h2d_prefetch``,
``device_sync``, ``collector`` and ``eval``, and the ``guard_skip`` event;
``scripts/obs_report.py`` folds them into per-phase shares of a step),
``--log_dir`` (TensorBoard scalars every ``--tb_every`` steps, with
tensorboardX), ``--profile`` (a ``torch.profiler`` trace of the whole run
into ``<log_dir>/profile``) or ``--xla_profile_at STEP[:NSTEPS]`` (one
over those optimizer steps into ``<log_dir>/xla_profile``).

Checkpoints and resilience (``checkpoint.py``, ``resilience.py``):
``--save_dir`` with ``--save_every`` (async by default, ``--async_save``;
``--keep_last_n``, ``--save_retries``, ``--save_retry_backoff``), a final
save at the end of every run, and ``--resume``, which continues the newest
verified checkpoint bit for bit (params, AdamW moments and step count,
guard counters, spike baseline, data cursor, token count; a checkpoint of
another global batch or device count is refused: resizing is the elastic
slice's); the spike monitor's rollback to the last verified checkpoint
(``--spike_sigma``, ``--max_consecutive_skips``, ``--max_rollbacks``);
SIGTERM or a notice from ``--preempt_poll_url`` saves one emergency
checkpoint at the next step boundary and exits 143
(``scripts/supervise.sh`` relaunches with ``--resume``); and the fault
injections ``--inject_fail_at`` (rc 13), ``--inject_preempt_at``,
``--inject_preempt_notice_at`` and ``--inject_save_fail_at`` (with
``--inject_save_fail_count``). Under a mesh every fault decision goes
through the control word every ``--consensus_every`` steps
(``coordination.py``), so all processes save, roll back or exit on the same
step; a mesh run with no ``--save_dir``, no guard, no preemption notice and
no ``--desync_check_every`` exchanges nothing and leaves SIGTERM its
default action.

The fault detectors of a mesh run (``coordination.py``):
``--desync_check_every N`` compares a parameter fingerprint across the
processes every N steps and turns a mismatch into the agreed rollback
(one value per data replica: at fsdp=2 with data=1 a drift cannot show);
``--hang_timeout_s S`` starts the hang watchdog, which exits 170 after S
seconds without a completed step, with an emergency save; a data worker
that dies under a mesh ends every process with rc 171 at the next
exchange. ``scripts/supervise.sh`` restarts after 170 and 171 and counts
the attempt. Their injections: ``--inject_desync_at``,
``--inject_hang_at`` and ``--inject_worker_fail_at``. Every flag whose
plane is not ported yet (tp meshes, elastic resize and its injection, the
multi-host launch flags, bf16 grad accumulation, remat) is refused with a
"later slice" error instead of being ignored.

Runs on CUDA unless ``--device cpu`` is given; without a visible GPU it
exits with the "no CUDA device" message. On CUDA the attention runs
through the hand-written kernels K1 (forward, with in-kernel dropout) and
K2 (backward); ``--fused_layers`` runs the layer epilogues through K4
(LN+residual+dropout), K5 (residual+dropout) and K6 (bias+GELU+dropout);
``--fused_matmul`` runs the matmul legs with their epilogues through K7
(forward, dgrad and wgrad), in place of K4-K6 on the legs it covers.
Prints the JAX CLI's ``step N | loss: ...`` lines and
``training done: N optimizer steps``.

A mesh runs one process per device, started by ``torchrun`` (``RANK``,
``WORLD_SIZE`` = the mesh's device count, ``LOCAL_RANK``): NCCL between
cards, gloo with ``--device cpu``. ``--training_mode`` picks the mesh
when ``--mesh`` is not given (``MeshSpec.for_mode``: dp/ddp every process
on 'data', fsdp every process on 'fsdp'). ``--batch`` is per device, so
an optimizer step takes ``batch x data x fsdp`` rows per micro-batch:
every process reads that global batch (the one the JAX package's
single-process run reads) and trains on its own rows and, under sp > 1,
its ``T/sp`` block of each (ring attention over the mesh, K8 per ring
step on the card). The loss is the global token mean and the grads are
summed over the mesh. Under 'fsdp' the fp32 params, their grads and the
AdamW moments are sharded (each forward gathers a tensor whole when the
model reaches it, each backward reduce-scatters its grad); with
``--shard_update`` (on, or 'auto' for data > 1 with fsdp == 1, the JAX
rule) the update is sharded over 'data' and the params stay whole
(``parallel/sharding.py``, ``parallel/train_step.py::ShardedUpdate``).
Only process 0 prints; the
mesh line is the JAX CLI's (``mesh: data=D, fsdp=F[, sp=S, tp=T][,
shard_update] | model: ...``). Under sp > 1 ``--fused_layers``/
``--fused_matmul`` other than ``off`` and ``--attention_impl``
``flash``/``dense`` are refused (later slices).
"""

from __future__ import annotations

import argparse
import math
import os
import signal
import sys
import threading
import time

import numpy as np

from gpt_2_distributed_torch.config import DEFAULT_BLOCK_ROWS, MODEL_PRESETS
from gpt_2_distributed_torch.data.dataloader import (
    DEFAULT_BATCH_SIZE,
    DEFAULT_CONTEXT_LENGTH,
    DEFAULT_NUM_WORKERS,
    DEFAULT_PREFETCH_FACTOR,
)
from gpt_2_distributed_torch.parallel.mesh import TRAINING_MODES, validate_mesh_for_config

DEFAULT_SEED = 42

# Flags whose planes come with later slices of the port, with the value
# that leaves them off; any other value is refused.
_UNPORTED = {
    "accum_dtype": "fp32", "inject_world_size": 0, "coordinator_address": None,
    "num_processes": None, "process_id": None,
}


def _claim_one_shot(save_dir: str | None, name: str, fired: set) -> bool:
    """True exactly once per resumable run for a named fault injection: a
    marker file in ``save_dir`` (it outlives supervised relaunches), or
    the in-process set ``fired`` without one."""
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        marker = os.path.join(save_dir, f".{name}")
        if os.path.exists(marker):
            return False
        with open(marker, "w") as f:
            f.write("1")
        return True
    if name in fired:
        return False
    fired.add(name)
    return True


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gpt_2_distributed_torch.train",
        description="GPT-2 pretraining with PyTorch on one GPU, or data-, "
        "fully-sharded- or sequence-parallel over several under torchrun (the "
        "port of gpt_2_distributed_tpu.train)",
    )
    p.add_argument("--data_dir", required=True, help="directory of uint16 .bin token shards")
    p.add_argument("--split", default="train")
    p.add_argument("--training_mode", default="local",
                   choices=TRAINING_MODES,
                   help="the mesh when --mesh is not given: dp/ddp every process "
                   "on 'data', fsdp every process on 'fsdp' (under torchrun)")
    p.add_argument("--mesh", default=None,
                   help="mesh shape 'data=D,fsdp=F,sp=S': one process per device "
                   "under torchrun; sp shards the sequence (ring attention); tp "
                   "comes with a later slice")
    p.add_argument("--attention_impl", default=None,
                   choices=["auto", "dense", "flash", "ring"],
                   help="'flash'/'auto': the CUDA kernels K1/K2 on the card, "
                   "their plain versions on the CPU; 'dense': plain PyTorch "
                   "attention; 'ring' (and 'auto' under --mesh sp>1): ring "
                   "attention over the sp processes, K8 on the card")
    p.add_argument("--shard_update", default="auto", choices=["off", "on", "auto"],
                   help="ZeRO-2 sharded update: grads reduce-scattered over "
                   "'data', AdamW on a 1/data shard, params all-gathered; 'auto' "
                   "is on for data>1 with fsdp=1; off at data=1")
    p.add_argument("--device_prefetch", default="on", choices=["on", "off"],
                   help="copy the next optimizer step's batch to the device "
                   "(pinned, non-blocking) while the current step runs")
    p.add_argument("--model", default="124M", choices=sorted(MODEL_PRESETS))
    p.add_argument("--n_layer", type=int, default=None)
    p.add_argument("--n_embd", type=int, default=None)
    p.add_argument("--n_head", type=int, default=None)
    p.add_argument("--vocab_size", type=int, default=None)
    p.add_argument("--seq_len", type=int, default=DEFAULT_CONTEXT_LENGTH)
    p.add_argument("--batch", type=int, default=DEFAULT_BATCH_SIZE,
                   help="micro-batch size per device")
    p.add_argument("--grad_accum_steps", type=int, default=4)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_schedule", default="constant", choices=["constant", "cosine"])
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--max_steps", type=int, default=0,
                   help="stop after N optimizer steps (0 = no cap)")
    p.add_argument("--weight_decay", type=float, default=0.1)
    p.add_argument("--eval_every", type=int, default=0,
                   help="evaluate on the val split every N optimizer steps (0 = off)")
    p.add_argument("--eval_batches", type=int, default=16,
                   help="number of val batches per evaluation")
    p.add_argument("--save_every", type=int, default=1000)
    p.add_argument("--save_dir", default=None)
    p.add_argument("--async_save", default="on", choices=["on", "off"])
    p.add_argument("--keep_last_n", type=int, default=0)
    p.add_argument("--save_retries", type=int, default=2)
    p.add_argument("--save_retry_backoff", type=float, default=0.5)
    p.add_argument("--preempt_poll_url", default=None)
    p.add_argument("--preempt_poll_interval", type=float, default=5.0)
    p.add_argument("--log_dir", default=None)
    p.add_argument("--workers", type=int, default=DEFAULT_NUM_WORKERS)
    p.add_argument("--prefetch_factor", type=int, default=DEFAULT_PREFETCH_FACTOR)
    p.add_argument("--seed", type=int, default=DEFAULT_SEED)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--inject_fail_at", type=int, default=0)
    p.add_argument("--step_guard", default="on", choices=["on", "off"],
                   help="skip (identity update) any optimizer step whose loss "
                   "or grad norm is non-finite, counted in skipped_steps")
    p.add_argument("--guard_max_grad_norm", type=float, default=0.0,
                   help="clip each layer to --guard_clip_norm and apply when a "
                   "finite grad norm exceeds this (0 = off; needs --step_guard on)")
    p.add_argument("--guard_clip_norm", type=float, default=1.0)
    p.add_argument("--spike_sigma", type=float, default=6.0)
    p.add_argument("--max_consecutive_skips", type=int, default=3)
    p.add_argument("--max_rollbacks", type=int, default=3)
    p.add_argument("--inject_nan_at", type=int, default=0,
                   help="poison micro-batch 0's loss with NaN on the optimizer "
                   "step that would complete as step N (needs --step_guard on)")
    p.add_argument("--inject_preempt_at", type=int, default=0)
    p.add_argument("--inject_save_fail_at", type=int, default=0)
    p.add_argument("--inject_save_fail_count", type=int, default=1)
    p.add_argument("--inject_preempt_notice_at", type=int, default=0)
    p.add_argument("--desync_check_every", type=int, default=0,
                   help="under a mesh, every N optimizer steps all-gather and compare "
                   "a parameter fingerprint (one fp32 sum on the device); a mismatch "
                   "names the ranks that differ, counts in desync_detected and rolls "
                   "the mesh back to the last verified checkpoint. The value is one per "
                   "data replica (an fsdp group sums its shards), so at fsdp=2 with "
                   "data=1 a drift cannot show, and under --shard_update every step "
                   "re-gathers the params from the one copy of each slice. 0 = off; "
                   "nothing to compare on one process")
    p.add_argument("--consensus_every", type=int, default=1)
    p.add_argument("--hang_timeout_s", type=float, default=0.0,
                   help="hang watchdog: if no optimizer step completes within this "
                   "many seconds, dump every thread's stack and the open trace spans, "
                   "try a bounded emergency save and exit rc 170 (scripts/supervise.sh "
                   "restarts the job and counts the attempt). It arms after the first "
                   "completed step, so the kernels' first build is outside the budget. "
                   "0 = off")
    p.add_argument("--data_read_retries", type=int, default=2)
    p.add_argument("--inject_desync_at", type=int, default=0,
                   help="fault injection: scale the last rank's fp32 master params by "
                   "1.001 just before optimizer step N (every rank runs the scaling, "
                   "by 1.0 elsewhere); needs --desync_check_every. One-shot")
    p.add_argument("--inject_hang_at", type=int, default=0,
                   help="fault injection: rank 0 sleeps just before optimizer step N; "
                   "its watchdog fires from the missing step, its peers' from the "
                   "collective it never joins (every rank exits 170); needs "
                   "--hang_timeout_s. One-shot")
    p.add_argument("--inject_world_size", type=int, default=0)
    p.add_argument("--dropout", type=float, default=None,
                   help="override every dropout rate (embedding, attention, "
                   "residual) with one value")
    p.add_argument("--inject_worker_fail_at", type=int, default=0,
                   help="fault injection: data worker 0 on rank 0 raises after "
                   "producing N batches. One process: the loader's RuntimeError, "
                   "unchanged; a mesh: every process exits 171 at the next consensus "
                   "exchange (alone, with the reason, where no exchange runs). "
                   "One-shot")
    p.add_argument("--remat", nargs="?", const="block", default=False,
                   choices=["block", "mlp", "attn", "dots"])
    p.add_argument("--accum_dtype", default="fp32", choices=["fp32", "bf16"])
    p.add_argument("--loss_impl", default="blocked", choices=["blocked", "dense"])
    p.add_argument("--fused_layers", default="off", choices=["off", "ln", "gelu", "all"])
    p.add_argument("--fused_matmul", default="off", choices=["off", "mlp", "proj", "all"])
    p.add_argument("--loss_block_rows", type=int, default=0,
                   help=f"blocked-CE chunk rows (0 = {DEFAULT_BLOCK_ROWS})")
    p.add_argument("--scan_layers", default="auto", choices=["auto", "on", "off"],
                   help="accepted for the JAX CLI's sake; eager PyTorch loops "
                   "over the layers either way")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default) or cpu")
    p.add_argument("--profile", action="store_true",
                   help="torch.profiler trace of the whole run into <log_dir>/profile")
    p.add_argument("--xla_profile_at", default=None, metavar="STEP[:NSTEPS]",
                   help="a torch.profiler window over NSTEPS (default 1) optimizer "
                   "steps from STEP into <log_dir>/xla_profile; host spans "
                   "annotate it")
    p.add_argument("--trace_dir", default=None,
                   help="write span/event trace JSONL here (obs/trace.py)")
    p.add_argument("--trace_max_file_bytes", type=int, default=64 * 1024 * 1024,
                   help="rotate trace-p*.jsonl past this size")
    p.add_argument("--cli_every", type=int, default=20)
    p.add_argument("--tb_every", type=int, default=1,
                   help="steps between TensorBoard writes (with --log_dir)")
    p.add_argument("--coordinator_address", default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    return p


def _linear(init: float, end: float, steps: int):
    """optax.linear_schedule."""
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps) / steps) + end


def make_lr_schedule(args, steps_per_epoch: int):
    """The learning rate: a constant, or a function of the optimizer's update
    count with optax's formulas (``warmup_cosine_decay_schedule`` from 0 to
    ``--lr`` and down to ``0.1 * --lr`` over the run; ``linear_schedule``
    warmup to ``--lr``)."""
    total = args.max_steps or max(1, steps_per_epoch * args.epochs)
    if args.lr_schedule == "cosine":
        warmup, peak = args.warmup_steps, args.lr
        decay_steps = total - warmup
        if not decay_steps > 0:
            raise ValueError(
                f"the cosine schedule needs more steps ({total}) than "
                f"--warmup_steps ({warmup})"
            )
        alpha = 0.0 if peak == 0.0 else 0.1
        warm = _linear(0.0, peak, warmup)

        def cosine(count):
            if count < warmup:
                return warm(count)
            c = min(count - warmup, decay_steps)
            return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps))
                           + alpha)

        return cosine
    if args.warmup_steps:
        return _linear(0.0, args.lr, args.warmup_steps)
    return args.lr


def _refuse_unported(p: argparse.ArgumentParser, args) -> None:
    for dest, off in _UNPORTED.items():
        value = getattr(args, dest)
        if value != off:
            p.error(f"--{dest} {value!r} is not ported to PyTorch yet: it comes "
                    f"in a later slice of the port")


def main(argv: list[str] | None = None):
    """Run the CLI; returns the run's ``StatsTracker`` (its ``buffers`` hold
    the last 50 steps' metrics, e.g. ``buffers["loss"]``)."""
    p = build_parser()
    args = p.parse_args(argv)
    _refuse_unported(p, args)
    if args.inject_nan_at and args.step_guard != "on":
        p.error("--inject_nan_at requires --step_guard on (an unguarded NaN "
                "update poisons the params permanently)")
    if args.guard_max_grad_norm and args.step_guard != "on":
        p.error("--guard_max_grad_norm requires --step_guard on (the clip "
                "fallback lives inside the guarded step)")
    if args.dropout is not None and not (0.0 <= args.dropout < 1.0):
        p.error(f"--dropout must be in [0, 1), got {args.dropout}")
    _check_resilience_flags(p, args)
    profile_spec = _profile_spec(p, args)
    spec = _mesh_spec(p, args)

    import torch
    import torch.distributed as dist

    from gpt_2_distributed_torch.parallel.mesh import Mesh, activate_mesh
    from gpt_2_distributed_torch.utils.device import resolve_device

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        sys.exit(f"--device {args.device}: {e}")
    # fp32 matmuls stay fp32 on the card (the JAX package's reference runs
    # at "highest" precision).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- config ------------------------------------------------------------
    overrides = {k: getattr(args, k) for k in ("n_layer", "n_embd", "n_head", "vocab_size")
                 if getattr(args, k) is not None}
    scan_layers = (args.model not in ("124M", "345M") if args.scan_layers == "auto"
                   else args.scan_layers == "on")
    try:
        config = MODEL_PRESETS[args.model].replace(
            n_positions=args.seq_len, remat=args.remat, scan_layers=scan_layers,
            loss_impl=args.loss_impl, fused_layers=args.fused_layers,
            fused_matmul=args.fused_matmul, **overrides,
        )
        if args.attention_impl:
            config = config.replace(attention_impl=args.attention_impl)
        if args.loss_block_rows:
            config = config.replace(loss_block_rows=args.loss_block_rows)
        if args.dropout is not None:
            config = config.replace(embd_dropout=args.dropout,
                                    attn_dropout=args.dropout,
                                    resid_dropout=args.dropout)
        validate_mesh_for_config(spec, config, args.model, args.seq_len)
    except ValueError as e:
        sys.exit(f"error: {e}")

    # --- processes ----------------------------------------------------------
    # One process per device: torchrun's RANK / WORLD_SIZE / LOCAL_RANK and
    # MASTER_ADDR / MASTER_PORT; NCCL between cards, gloo on the CPU.
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != spec.n_devices:
        sys.exit(f"error: --mesh {spec.to_str()} runs {spec.n_devices} process(es), one "
                 f"per device, but WORLD_SIZE is {world}: launch it with torchrun "
                 f"--nproc_per_node {spec.n_devices}")
    if world == 1:
        return _run(args, config, device, None, profile_spec)
    rank = int(os.environ["RANK"])
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            rank=rank, world_size=world)
    try:
        mesh = Mesh(spec, rank)
        with activate_mesh(mesh):
            return _run(args, config, device, mesh, profile_spec)
    finally:
        dist.destroy_process_group()


def _check_resilience_flags(p: argparse.ArgumentParser, args) -> None:
    """The checkpoint, spike-monitor and injection flags' refusals."""
    from gpt_2_distributed_torch.config import CheckpointPolicy
    from gpt_2_distributed_torch.resilience import SpikeMonitor

    try:
        CheckpointPolicy(keep_last_n=args.keep_last_n, save_retries=args.save_retries,
                         retry_backoff_s=args.save_retry_backoff)
        SpikeMonitor(sigma=args.spike_sigma, max_consecutive=args.max_consecutive_skips)
    except ValueError as e:
        p.error(str(e))
    if args.consensus_every < 1:
        p.error(f"--consensus_every={args.consensus_every} must be >= 1")
    if args.desync_check_every < 0:
        p.error(f"desync_check_every={args.desync_check_every} must be >= 0")
    if args.hang_timeout_s < 0:
        p.error(f"hang_timeout_s={args.hang_timeout_s} must be >= 0")
    if args.inject_hang_at and args.hang_timeout_s <= 0:
        p.error("--inject_hang_at requires --hang_timeout_s > 0 (otherwise the injected "
                "hang sleeps unwatched)")
    if args.inject_desync_at and not args.desync_check_every:
        p.error("--inject_desync_at requires --desync_check_every > 0 (nothing would ever "
                "detect the injected divergence)")
    if args.save_every < 0:
        p.error(f"--save_every={args.save_every} must be >= 0")
    for flag in ("inject_fail_at", "inject_preempt_notice_at", "inject_save_fail_at"):
        if getattr(args, flag) and not args.save_dir:
            p.error(f"--{flag} needs --save_dir (its one-shot marker and the "
                    f"checkpoint it exercises live there)")


def _profile_spec(p: argparse.ArgumentParser, args):
    """``--xla_profile_at`` as ``(start, n)`` or None, with the trace and
    profiler flags' refusals (the JAX CLI's)."""
    from gpt_2_distributed_torch.config import TracePolicy
    from gpt_2_distributed_torch.obs.trace import parse_profile_at

    try:
        TracePolicy(trace_dir=args.trace_dir, max_file_bytes=args.trace_max_file_bytes,
                    xla_profile_at=args.xla_profile_at)
        spec = parse_profile_at(args.xla_profile_at)
    except ValueError as e:
        p.error(str(e))
    if spec and not args.log_dir:
        p.error("--xla_profile_at needs --log_dir (the capture lands in "
                "<log_dir>/xla_profile)")
    if spec and args.profile:
        p.error("--xla_profile_at and --profile both open a torch.profiler "
                "session; profiler sessions cannot nest — pick one")
    if args.profile and not args.log_dir:
        p.error("--profile needs --log_dir (the trace lands in <log_dir>/profile)")
    return spec


def _mesh_spec(p: argparse.ArgumentParser, args):
    """``--mesh`` (or ``--training_mode``'s mesh) as a MeshSpec, with the
    combinations the port refuses."""
    from gpt_2_distributed_torch.parallel.mesh import MeshSpec, refuse_unported_axes

    try:
        spec = MeshSpec.parse(args.mesh) if args.mesh else MeshSpec.for_mode(args.training_mode)
        refuse_unported_axes(spec)
    except ValueError as e:
        p.error(str(e))
    if spec.sp > 1:
        for flag in ("fused_layers", "fused_matmul"):
            if getattr(args, flag) != "off":
                p.error(f"--{flag} {getattr(args, flag)} under --mesh sp={spec.sp} is not "
                        f"ported to PyTorch yet (the JAX package falls back to its "
                        f"unfused ops there): it comes in a later slice of the port")
        if args.attention_impl in ("flash", "dense"):
            p.error(f"--attention_impl {args.attention_impl} under --mesh sp={spec.sp} "
                    f"is not ported to PyTorch yet (the JAX package all-gathers the "
                    f"sequence for it): it comes in a later slice of the port; use "
                    f"ring or auto")
    return spec


def _run(args, config, device, mesh, profile_spec):
    """The training loop of :func:`main` on ``device``; under a mesh every
    process reads the same global batches and trains on its rows (and
    ``T/sp`` block) of each, and only the first one prints (and writes
    TensorBoard). Each process traces into its own ``trace-p{rank}.jsonl``."""
    import torch

    from gpt_2_distributed_torch.data.dataloader import (
        TokenShardDataset,
        create_dataloader,
        get_shard_paths,
    )
    from gpt_2_distributed_torch.metrics.tracker import StatsTracker
    from gpt_2_distributed_torch.models import gpt2
    from gpt_2_distributed_torch.obs.trace import (
        ProfilerCapture,
        configure_tracing,
        get_tracer,
    )
    from gpt_2_distributed_torch.ops.spmd import batch_axes, shard_offset
    from gpt_2_distributed_torch.parallel.mesh import MeshSpec, is_primary
    from gpt_2_distributed_torch.parallel.sharding import resolve_shard_update
    from gpt_2_distributed_torch.parallel.train_step import (
        ShardedUpdate,
        make_eval_step,
        make_optimizer,
        make_train_step,
        trainable_params,
    )
    from gpt_2_distributed_torch.checkpoint import (
        CheckpointMeta,
        CheckpointSaver,
        StateLayout,
        gc_checkpoints,
        restore_latest_verified,
    )
    from gpt_2_distributed_torch.config import CheckpointPolicy
    from gpt_2_distributed_torch.coordination import (
        ConsensusBus,
        HangWatchdog,
        check_fingerprints,
        decode_control_word,
        encode_control_word,
        fingerprint_params,
        perturb_params,
    )
    from gpt_2_distributed_torch.resilience import (
        DATA_ABORT_EXIT_CODE,
        PREEMPTED_EXIT_CODE,
        SKIP_REASON_NAMES,
        PreemptionHandler,
        PreemptionPoller,
        SpikeMonitor,
        init_guard_state,
    )
    from gpt_2_distributed_torch.utils.flops import device_peak_flops, flops_per_token

    primary = is_primary()
    # Tracing defaults off: get_tracer() then hands out a no-op and no
    # trace file is created.
    rank = 0 if mesh is None else mesh.rank
    if args.trace_dir:
        configure_tracing(args.trace_dir, process_index=rank,
                          max_file_bytes=args.trace_max_file_bytes)
    tracer = get_tracer()
    capture = ProfilerCapture(profile_spec, args.log_dir, rank=rank)

    def say(*a, **kw) -> None:
        if primary:
            print(*a, **kw)

    spec = MeshSpec() if mesh is None else mesh.spec
    # --batch is per device: the batch axes split a global batch of
    # batch x data x fsdp rows.
    global_batch = args.batch * spec.data * spec.fsdp
    row0 = 0 if mesh is None else shard_offset(mesh, batch_axes(mesh, args.batch), args.batch)

    def local_block(a: np.ndarray) -> np.ndarray:
        """This process's ``[..., batch, T/sp]`` block of ``[..., B, T]``
        tokens."""
        if mesh is None:
            return a
        tl = args.seq_len // mesh.sp
        return np.ascontiguousarray(a[..., row0:row0 + args.batch,
                                      mesh.sp_index * tl:(mesh.sp_index + 1) * tl])

    use_shard_update = resolve_shard_update(args.shard_update, spec)
    dataset = TokenShardDataset(
        get_shard_paths(args.data_dir, args.split), seq_len=args.seq_len,
        num_workers=args.workers, vocab_size=config.vocab_size,
        data_read_retries=args.data_read_retries,
    )
    steps_per_epoch = dataset.batches_per_epoch(global_batch) // args.grad_accum_steps
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "host CPU"
    say(f"device: {device} ({name})", flush=True)
    extra = f", sp={spec.sp}, tp={spec.tp}" if spec.sp > 1 or spec.tp > 1 else ""
    if use_shard_update:
        extra += ", shard_update"
    say(f"mesh: data={spec.data}, fsdp={spec.fsdp}{extra} | model: {args.model} "
        f"({config.num_params() / 1e6:.1f}M params) | steps/epoch: "
        f"{steps_per_epoch}", flush=True)

    try:
        schedule = make_lr_schedule(args, steps_per_epoch)
    except ValueError as e:
        sys.exit(f"error: {e}")
    params = trainable_params(gpt2.init_params(config, seed=args.seed), device)
    sharded = ShardedUpdate.build(params, config, mesh, use_shard_update)
    optimizer = make_optimizer(params, schedule, weight_decay=args.weight_decay,
                               sharded=sharded)
    use_guard = args.step_guard == "on"
    train_step = make_train_step(
        config, optimizer, guard=use_guard,
        clip_threshold=args.guard_max_grad_norm or None,
        layer_clip_norm=args.guard_clip_norm, sharded=sharded,
    )
    guard_state = init_guard_state() if use_guard else None
    monitor = (SpikeMonitor(sigma=args.spike_sigma, max_consecutive=args.max_consecutive_skips)
               if use_guard else None)
    ones_scale = torch.ones(args.grad_accum_steps, device=device)
    nan_scale = ones_scale.clone()
    nan_scale[0] = float("nan")

    # --- multi-process control plane (coordination.py) ----------------------
    # Fault decisions gate collectives, so under a mesh every process acts on
    # the agreed control word at the same step; on one process the exchange
    # is the identity and the single-process branches below run instead.
    bus = ConsensusBus(mesh, device)
    multihost = bus.process_count > 1
    consensus_k = args.consensus_every
    # The exchange runs only where something can raise a flag for it: a
    # saver, the guard (skips, rollbacks), a preemption signal the loop
    # catches or the desync check (rollbacks). Without any, a mesh run
    # installs no SIGTERM handler (the signal ends each process) and never
    # exchanges the word.
    consensus = multihost and bool(args.save_dir or use_guard or args.preempt_poll_url
                                   or args.inject_preempt_at or args.desync_check_every)

    # --- checkpoint lifecycle -----------------------------------------------
    layout = StateLayout(config, sharded, mesh)
    saver = None
    if args.save_dir:
        policy = CheckpointPolicy(async_save=args.async_save == "on",
                                  keep_last_n=args.keep_last_n, save_retries=args.save_retries,
                                  retry_backoff_s=args.save_retry_backoff)
        saver = CheckpointSaver(args.save_dir, layout, policy, barrier=bus.barrier)
        if args.inject_save_fail_at and _claim_one_shot(
                args.save_dir, f"save_fail_injected_{args.inject_save_fail_at}", set()):
            saver.inject_fail_at = args.inject_save_fail_at
            saver.inject_fail_count = args.inject_save_fail_count

    # --- resume ---------------------------------------------------------------
    world_record = {
        "process_count": spec.n_devices, "device_count": spec.n_devices,
        "mesh": spec.to_str(), "global_batch": args.batch * spec.n_devices * args.grad_accum_steps,
        "grad_accum_steps": args.grad_accum_steps, "batch": args.batch,
        "local_batch": args.batch, "workers": dataset.num_workers,
    }
    start_epoch, skip_steps, global_step, total_tokens = 0, 0, 0, 0

    def check_same_restore(restored) -> None:
        """Under a mesh every process must have restored the same step."""
        step = -1 if restored is None else restored[0].step
        if not bus.same_on_every_process(step):
            sys.exit(f"error: the processes of the mesh restored different checkpoints "
                     f"(this one: step {step}); their states would mix two steps")
    last_skip_reason_host = 0
    if args.resume and args.save_dir:
        # Prune uncommitted dirs (a crash mid-save leaves one) and apply
        # retention before picking the checkpoint.
        removed = gc_checkpoints(args.save_dir, args.keep_last_n)
        if removed:
            say("[ckpt] pruned on resume: " + ", ".join(os.path.basename(p) for p in removed))
        bus.barrier()
        t_restore = time.perf_counter()
        restored = restore_latest_verified(args.save_dir, params, optimizer, layout)
        check_same_restore(restored)
        if restored is not None:
            meta, guard, latest = restored
            mw = meta.world or {}
            if mw and (int(mw["global_batch"]) != world_record["global_batch"]
                       or int(mw["device_count"]) != world_record["device_count"]):
                sys.exit(f"error: --resume: {latest} was saved at a global batch of "
                         f"{mw['global_batch']} on {mw['device_count']} device(s) (mesh "
                         f"{mw['mesh']}); this run has {world_record['global_batch']} on "
                         f"{world_record['device_count']}: resuming at another world is "
                         f"the elastic slice's work, a later slice of the port")
            start_epoch, skip_steps = meta.epoch, meta.batches_in_epoch
            global_step, total_tokens = meta.step, meta.total_tokens
            if meta.rng_seed != args.seed:
                say(f"warning: --seed {args.seed} differs from the checkpoint's seed "
                    f"{meta.rng_seed}; using the checkpoint's so dropout resumes exactly")
            args.seed = meta.rng_seed
            if monitor is not None and meta.spike_monitor:
                monitor.load_state_dict(meta.spike_monitor)
            if use_guard and guard is not None:
                guard_state = guard
                last_skip_reason_host = guard.last_skip_reason
            say(f"resumed from {latest}: step {global_step}, epoch {start_epoch}, "
                f"{skip_steps} steps into the epoch (restore "
                f"{(time.perf_counter() - t_restore) * 1e3:.1f} ms)", flush=True)
        else:
            say(f"--resume: no checkpoint found in {args.save_dir}; starting fresh")

    try:
        tracker = StatsTracker(
            batch_size=global_batch * args.grad_accum_steps, seq_len=args.seq_len,
            cli_every=args.cli_every, flops_per_token=flops_per_token(config, args.seq_len),
            peak_flops_per_chip=device_peak_flops(device), device=device,
            n_chips=1 if mesh is None else mesh.spec.n_devices, printing=primary,
            tb_dir=args.log_dir, tb_every=args.tb_every,
        )
    except RuntimeError as e:
        sys.exit(f"--log_dir: {e}")
    tracker.total_tokens = total_tokens

    def make_meta(step: int, ep: int, batches: int) -> CheckpointMeta:
        return CheckpointMeta(
            step=step, epoch=ep, batches_in_epoch=batches, rng_seed=args.seed,
            total_tokens=tracker.total_tokens,
            spike_monitor=monitor.state_dict() if monitor else None, world=world_record)

    # --- evaluation ---------------------------------------------------------
    # The val split (shard 0), the epoch-0 permutation every time, so
    # successive evals score the same batches.
    run_eval = None
    if args.eval_every:
        val_paths = get_shard_paths(args.data_dir, "val")
        if not val_paths:
            say(f"--eval_every: no 'val' shards in {args.data_dir}; eval disabled")
        else:
            eval_dataset = TokenShardDataset(
                val_paths, seq_len=args.seq_len, num_workers=1,
                vocab_size=config.vocab_size, shard_windows=True,
                data_read_retries=args.data_read_retries,
            )
            n_eval = min(args.eval_batches, eval_dataset.batches_per_epoch(global_batch))
            if n_eval == 0:
                say("--eval_every: val split has fewer tokens than one batch "
                    f"({global_batch}x{args.seq_len}); eval disabled")
            else:
                eval_step = make_eval_step(config, sharded=sharded)
                eval_loader = create_dataloader(eval_dataset, batch_size=global_batch,
                                                prefetch_factor=args.prefetch_factor)

                def run_eval() -> float:
                    losses = []
                    for i, (xb, yb) in enumerate(eval_loader):
                        if i >= n_eval:
                            break
                        losses.append(float(eval_step(
                            params, torch.from_numpy(local_block(xb)).to(device),
                            torch.from_numpy(local_block(yb)).to(device))))
                    return float(np.mean(losses))

    lr_of = schedule if callable(schedule) else (lambda _s: args.lr)

    def to_device(micro):
        """One optimizer step's micro-batches as ``[accum, B, T]`` device
        tensors; from pinned host memory, without blocking, on the card."""
        x = torch.from_numpy(local_block(np.stack([m[0] for m in micro])))
        y = torch.from_numpy(local_block(np.stack([m[1] for m in micro])))
        if device.type == "cuda":
            return (x.pin_memory().to(device, non_blocking=True),
                    y.pin_memory().to(device, non_blocking=True))
        return x, y

    # --- preemption (resilience layer 4) ------------------------------------
    # SIGTERM only raises a flag; the loop reads it at a step boundary, saves
    # one emergency checkpoint and exits rc 143 for a supervised --resume.
    # --inject_preempt_notice_at points the poller at a file:// notice in
    # --save_dir that the loop flips to TRUE.
    preempt = PreemptionHandler()
    on_main_thread = threading.current_thread() is threading.main_thread()
    if on_main_thread and (consensus or not multihost):   # the signal module's contract
        preempt.install()
    poller, notice_path = None, None
    if args.inject_preempt_notice_at:
        notice_path = os.path.join(os.path.abspath(args.save_dir), "preempt_notice.txt")
        # FALSE on every launch: a relaunch must not re-read the last TRUE.
        os.makedirs(os.path.dirname(notice_path), exist_ok=True)
        with open(notice_path, "w") as f:
            f.write("FALSE")
    if args.preempt_poll_url or notice_path:
        poller = PreemptionPoller(
            url=args.preempt_poll_url or f"file://{notice_path}",
            interval_s=(min(args.preempt_poll_interval, 0.05) if notice_path
                        else args.preempt_poll_interval),
            handler=preempt,
        ).start()

    # --- epoch/step loop ----------------------------------------------------
    # Unguarded, metrics are read one step late: step N+1 is issued before
    # step N's loss is read back, so the host never waits on the device
    # between steps. The guarded step reads its loss and grad norm on the
    # host to decide (one sync per optimizer step), so it is flushed at once,
    # and its loss feeds the spike monitor there.
    pending = None
    rollback_requested = False
    skip_observed_last = False
    desync_count = 0
    watchdog = None

    def flush_pending() -> None:
        nonlocal pending, last_skip_reason_host, rollback_requested, skip_observed_last
        if pending is None:
            return
        p_step, p_epoch, p_batch, m = pending
        pending = None
        # The first host read of m waits for the step's device work: that
        # wait is the device_sync phase (what follows is host arithmetic).
        with tracer.span("device_sync", step=p_step):
            extra = {}
            skipped = False
            if use_guard:
                # Latched for the next consensus exchange: several flushes
                # can pass between exchanges.
                skip_observed_last = skip_observed_last or bool(m.skip_reason)
                if m.skip_reason:
                    skipped = True
                    last_skip_reason_host = m.skip_reason
                    tracer.event("guard_skip", step=p_step, reason=m.skip_reason)
                    say(f"[guard] step {p_step} skipped "
                        f"({SKIP_REASON_NAMES.get(m.skip_reason, m.skip_reason)}); "
                        f"params/opt-state unchanged (total skipped: "
                        f"{m.skipped_steps})", flush=True)
                if m.skipped_steps or last_skip_reason_host:
                    extra = {"skipped_steps": m.skipped_steps,
                             "last_skip_reason": last_skip_reason_host}
                if m.clipped:
                    say(f"[guard] step {p_step} grad norm {float(m.grad_norm):.2f} "
                        f"exceeded --guard_max_grad_norm {args.guard_max_grad_norm:g}; "
                        f"clipped per-layer to {args.guard_clip_norm:g} and applied "
                        f"(total clipped: {m.clipped_steps})", flush=True)
                if m.clipped_steps:
                    extra["clipped_steps"] = m.clipped_steps
                verdict = monitor.observe(float(m.loss), skipped=skipped)
                if verdict == "rollback":
                    rollback_requested = True
                elif verdict == "anomaly" and not skipped:
                    say(f"[guard] step {p_step} loss spike: {float(m.loss):.4f} (EMA "
                        f"{monitor.mean:.4f}, {monitor.consecutive} consecutive "
                        f"anomalies)", flush=True)
            if saver is not None and saver.failed_saves:
                extra["save_failures"] = saver.failed_saves
            if desync_count:
                extra["desync_detected"] = desync_count
            if dataset.read_retry_count:
                extra["data_read_retries"] = dataset.read_retry_count
            values = dict(lr=float(lr_of(p_step - 1)), epoch=p_epoch, batch=p_batch)
            # A skipped step's loss and grad norm are the rejected values: the
            # [guard] line reports them; the windowed averages stay clean.
            if not skipped:
                values["loss"] = float(m.loss)
                values["grad_norm"] = float(m.grad_norm)
        with tracer.span("collector", step=p_step):
            tracker.update(p_step, **values, **extra)

    # The "step" span is entered and left by hand: the loop leaves an
    # iteration through several breaks, and begin closes whatever span a
    # break path left open.
    step_span = None

    def begin_step_span() -> None:
        nonlocal step_span
        end_step_span()
        if tracer.enabled:
            step_span = tracer.span("step", n=global_step + 1)
            step_span.__enter__()

    def end_step_span() -> None:
        nonlocal step_span
        if step_span is not None:
            step_span.__exit__(None, None, None)
            step_span = None

    def save_now(step: int, ep: int, batches: int) -> None:
        saver.save(step, optimizer, make_meta(step, ep, batches), guard_state)

    def emergency_preempt_exit() -> None:
        """Flush, commit one emergency checkpoint, exit rc 143 (which
        supervise.sh relaunches without burning a restart attempt)."""
        flush_pending()
        end_step_span()
        tracer.event("preempt_exit", step=global_step)
        if watchdog is not None:
            watchdog.disarm()
        if saver is not None:
            # Wait or supersede: an in-flight async save is drained first;
            # never two writers in one step dir.
            saver.ensure_committed_sync(global_step, optimizer,
                                        make_meta(global_step, epoch, step_in_epoch),
                                        guard_state)
        say(f"[preempt] emergency checkpoint at step {global_step}; exiting rc "
            f"{PREEMPTED_EXIT_CODE} for a supervised resume", flush=True)
        raise SystemExit(PREEMPTED_EXIT_CODE)

    def coordinated_worker_abort(exc: BaseException | None) -> None:
        """The agreed abort after a data worker died on some process: every
        process gets here from the same exchange, so the emergency save's
        collectives pair up; then exit rc 171, which supervise.sh counts as
        a failed attempt."""
        flush_pending()
        end_step_span()
        tracer.event("worker_abort", step=global_step)
        if watchdog is not None:
            watchdog.disarm()
        if saver is not None:
            saver.ensure_committed_sync(global_step, optimizer,
                                        make_meta(global_step, epoch, step_in_epoch),
                                        guard_state)
        detail = f" ({exc})" if exc is not None else " (on another process)"
        print(f"[coord] data worker failed{detail}; pod-wide coordinated abort at step "
              f"{global_step}, exiting rc {DATA_ABORT_EXIT_CODE}", flush=True)
        raise SystemExit(DATA_ABORT_EXIT_CODE)

    def worker_failed(exc: RuntimeError, during: str) -> RuntimeError:
        """A loader error under a mesh: latched for the next exchange, which
        turns it into :func:`coordinated_worker_abort` on every process.
        Where no exchange runs, this process exits 171 alone."""
        cause = exc.__cause__
        detail = f"{exc}: {cause}" if cause else str(exc)
        print(f"[coord] local data worker failed{during} ({detail}); requesting pod-wide "
              f"abort", flush=True)
        if not consensus:
            print(f"[coord] no consensus exchange runs in this configuration (no "
                  f"--save_dir, --step_guard off, no preemption source, no "
                  f"--desync_check_every), so the other processes cannot be told: "
                  f"exiting rc {DATA_ABORT_EXIT_CODE} alone at step {global_step}",
                  flush=True)
            end_step_span()
            raise SystemExit(DATA_ABORT_EXIT_CODE)
        return exc

    def hang_meta() -> CheckpointMeta:
        """The emergency save's meta, read from the watchdog's thread: the
        last step's metrics may still be pending (unguarded), and it must
        not flush them, so their tokens are counted here."""
        meta = make_meta(global_step, epoch, step_in_epoch)
        if pending is not None:
            meta.total_tokens += tracker.tokens_per_step
        return meta

    def watchdog_emergency_save() -> None:
        # Best effort: a peer that is wedged may never join the commit's
        # barrier; the watchdog abandons the save after its grace window.
        if saver is not None:
            saver.ensure_committed_sync(global_step, optimizer, hang_meta(), guard_state)

    whole_run = None
    if args.profile:
        whole_run = ProfilerCapture((0, 1 << 62), args.log_dir, subdir="profile",
                                    rank=rank)
        whole_run.maybe_start(0)
    done = False
    rollbacks_done = 0
    fired: set = set()   # one-shot injections without a --save_dir
    epoch, step_in_epoch = start_epoch, skip_steps
    # Under a mesh periodic saves happen at the consensus boundary; this
    # keeps a resume or rollback from re-saving the step it restored.
    last_saved_step = global_step
    if args.hang_timeout_s > 0:
        watchdog = HangWatchdog(args.hang_timeout_s, on_hang=watchdog_emergency_save)
        watchdog.start()
    try:
        while True:
            rollback_requested = False
            for epoch in range(start_epoch, args.epochs):
                dataset.set_epoch(epoch)
                tracker.start_epoch()
                first_epoch = epoch == start_epoch
                fail_after = (args.inject_worker_fail_at
                              if args.inject_worker_fail_at and rank == 0 and _claim_one_shot(
                                  args.save_dir,
                                  f"worker_fail_injected_{args.inject_worker_fail_at}", fired)
                              else 0)
                loader_iter = iter(create_dataloader(
                    dataset, batch_size=global_batch, prefetch_factor=args.prefetch_factor,
                    skip_batches=skip_steps * args.grad_accum_steps if first_epoch else 0,
                    inject_worker_fail_after=fail_after))
                step_in_epoch = skip_steps if first_epoch else 0
                micro: list = []
                last_micro: list = []
                worker_error: RuntimeError | None = None
                prefetched = None
                first_inner = True
                while step_in_epoch < steps_per_epoch:
                    begin_step_span()
                    if prefetched is not None:
                        x, y = prefetched
                        prefetched = None
                    else:
                        # Host-local, never a collective: a process whose data
                        # worker died still reaches the exchange below, so the
                        # mesh agrees to abort instead of waiting in the step.
                        if worker_error is None:
                            try:
                                with tracer.span("data_fetch"):
                                    while len(micro) < args.grad_accum_steps:
                                        micro.append(next(loader_iter))
                            except StopIteration:
                                break
                            except RuntimeError as exc:
                                if not multihost:
                                    raise
                                worker_error = worker_failed(exc, "")
                        if worker_error is not None and len(micro) < args.grad_accum_steps:
                            # Until the next exchange every process must keep
                            # stepping in lockstep: replay the last full set
                            # (the grads are still summed over the mesh).
                            micro = [last_micro[i % len(last_micro)]
                                     for i in range(args.grad_accum_steps)] if last_micro else []
                        if micro:
                            with tracer.span("h2d"):
                                x, y = to_device(micro)
                    if micro:
                        last_micro = micro
                    micro = []
                    # The desync check: every process agrees on global_step, so
                    # the all-gather pairs up, even on a process carrying a
                    # worker error to the exchange.
                    if (multihost and args.desync_check_every and global_step > 0
                            and global_step % args.desync_check_every == 0):
                        t_fp = time.perf_counter()
                        with tracer.span("desync_check", step=global_step):
                            bad_ranks = check_fingerprints(
                                fingerprint_params(params, sharded), mesh)
                        if bad_ranks:
                            desync_count += 1
                            rollback_requested = True
                            say(f"[coord] DESYNC at step {global_step}: rank(s) {bad_ranks} "
                                f"disagree with the mesh's parameter fingerprint (check took "
                                f"{(time.perf_counter() - t_fp) * 1e3:.1f} ms); rolling back "
                                f"to the last verified checkpoint", flush=True)
                    # The consensus exchange: the only place where fault flags
                    # turn into actions under a mesh (every K steps and at
                    # each epoch's first iteration; flags latch in between).
                    if consensus and (first_inner or global_step % consensus_k == 0):
                        agreed = decode_control_word(bus.exchange(encode_control_word(
                            preempt=preempt.preempted(), rollback=rollback_requested,
                            skip=skip_observed_last, worker_error=worker_error is not None,
                            save_now=bool(saver is not None and saver.failed_saves))))
                        if agreed.worker_error:
                            coordinated_worker_abort(worker_error)
                        if agreed.preempt:
                            emergency_preempt_exit()
                        if agreed.skip and not skip_observed_last:
                            print(f"[coord] step {global_step}: another process observed "
                                  f"a guard skip this one did not: guard inputs may have "
                                  f"diverged", flush=True)
                        skip_observed_last = False
                        if agreed.rollback:
                            rollback_requested = True
                            say(f"[coord] agreed rollback before step {global_step + 1}",
                                flush=True)
                            break
                        if (saver is not None and global_step > 0
                                and global_step != last_saved_step
                                and (agreed.save_now
                                     or (args.save_every and global_step % args.save_every == 0)
                                     or (consensus_k > 1 and args.save_every
                                         and global_step - last_saved_step >= args.save_every))):
                            # Unguarded, the last step's metrics are still
                            # pending: the meta's token count needs them.
                            flush_pending()
                            save_now(global_step, epoch, step_in_epoch)
                            last_saved_step = global_step
                    first_inner = False
                    # Fault injections of the detectors themselves.
                    if (args.inject_desync_at and global_step + 1 == args.inject_desync_at
                            and _claim_one_shot(args.save_dir,
                                                f"desync_injected_{args.inject_desync_at}",
                                                fired)):
                        factor = 1.001 if rank == spec.n_devices - 1 else 1.0
                        perturb_params(optimizer.param_groups[0]["params"], factor)
                        print(f"[inject] desync perturbation x{factor:g} on rank {rank} "
                              f"before step {global_step + 1}", flush=True)
                    if (args.inject_hang_at and global_step + 1 == args.inject_hang_at
                            and rank == 0
                            and _claim_one_shot(args.save_dir,
                                                f"hang_injected_{args.inject_hang_at}", fired)):
                        print(f"[inject] simulated hang before step {global_step + 1}; the "
                              f"watchdog should fire within {args.hang_timeout_s:g}s",
                              flush=True)
                        # The watchdog's exit ends the process during this
                        # wait; an exit that returns (an injected one) ends
                        # the run here, as the real one would have.
                        horizon = time.monotonic() + args.hang_timeout_s * 20 + 30
                        while not watchdog.fired and time.monotonic() < horizon:
                            time.sleep(0.05)
                        if watchdog.fired:
                            watchdog.stop()
                            raise SystemExit(watchdog.exit_code)
                    capture.maybe_start(global_step + 1)
                    if use_guard:
                        loss_scale = ones_scale
                        if (args.inject_nan_at and global_step + 1 == args.inject_nan_at
                                and _claim_one_shot(args.save_dir,
                                                    f"nan_injected_{args.inject_nan_at}", fired)):
                            loss_scale = nan_scale
                            say(f"[inject] poisoning micro-batch 0 loss with NaN at "
                                f"step {global_step + 1}", flush=True)
                        with tracer.span("step_dispatch", step=global_step + 1):
                            guard_state, m = train_step(params, guard_state, x, y, args.seed,
                                                        global_step, loss_scale)
                    else:
                        with tracer.span("step_dispatch", step=global_step + 1):
                            m = train_step(params, x, y, args.seed, global_step)
                    global_step += 1
                    step_in_epoch += 1
                    # --device_prefetch: the next step's batch goes to the card
                    # now, while this step's work is still queued on it.
                    if (args.device_prefetch == "on" and worker_error is None
                            and step_in_epoch < steps_per_epoch
                            and not (args.max_steps and global_step >= args.max_steps)):
                        try:
                            with tracer.span("h2d_prefetch"):
                                while len(micro) < args.grad_accum_steps:
                                    micro.append(next(loader_iter))
                                prefetched = to_device(micro)
                        except StopIteration:
                            pass
                        except RuntimeError as exc:
                            if not multihost:
                                raise
                            worker_error = worker_failed(exc, " during prefetch")
                    flush_pending()
                    pending = (global_step, epoch, step_in_epoch, m)
                    if use_guard:
                        # The guarded step has already waited for its own
                        # results; a lag would only charge the next step's
                        # time to this one.
                        flush_pending()
                    if watchdog is not None:
                        # Arm-as-beat: the deadline moves only when a step
                        # completes, and the first arm comes after the first
                        # step (the kernels' first build is not a hang).
                        watchdog.arm()
                    # Stop the window once its last step has been flushed (its
                    # device work is then in the trace, not just queued).
                    capture.maybe_stop(global_step - 1)
                    # Under a mesh every local decision waits for the next
                    # exchange, so all processes act on the same step.
                    if rollback_requested and not multihost:
                        break
                    if run_eval is not None and global_step % args.eval_every == 0:
                        flush_pending()
                        if watchdog is not None:
                            watchdog.disarm()   # eval has no step cadence
                        with tracer.span("eval", step=global_step):
                            tracker.update(global_step, count_tokens=False,
                                           eval_loss=run_eval())
                        if watchdog is not None:
                            watchdog.arm()
                    if (not multihost and saver is not None and args.save_every
                            and global_step % args.save_every == 0):
                        flush_pending()
                        # Re-checked after the flush: never checkpoint a step
                        # flagged for rollback (it would restore this one).
                        if not rollback_requested:
                            save_now(global_step, epoch, step_in_epoch)
                    if rollback_requested and not multihost:
                        break
                    if args.inject_fail_at and global_step >= args.inject_fail_at:
                        marker = os.path.join(args.save_dir,
                                              f".fail_injected_{args.inject_fail_at}")
                        if not os.path.exists(marker):
                            flush_pending()
                            tracker.close()
                            if saver is not None:
                                # A crash between steps: in-flight saves land
                                # first (the commit race has its own tests).
                                saver.wait()
                            with open(marker, "w") as f:
                                f.write(str(global_step))
                            print(f"[inject] simulated failure after step {global_step}",
                                  flush=True)
                            sys.stderr.flush()
                            # A hard exit, no teardown and no final save.
                            os._exit(13)
                    if (args.inject_preempt_at and global_step >= args.inject_preempt_at
                            and _claim_one_shot(args.save_dir,
                                                f"preempt_injected_{args.inject_preempt_at}",
                                                fired)):
                        say(f"[inject] simulated preemption (SIGTERM) after step "
                            f"{global_step}", flush=True)
                        if on_main_thread:
                            os.kill(os.getpid(), signal.SIGTERM)
                        else:
                            preempt.trigger("injected preemption")
                    if (args.inject_preempt_notice_at
                            and global_step >= args.inject_preempt_notice_at
                            and _claim_one_shot(
                                args.save_dir,
                                f"preempt_notice_injected_{args.inject_preempt_notice_at}",
                                fired)):
                        say(f"[inject] preemption notice after step {global_step}",
                            flush=True)
                        with open(notice_path, "w") as f:
                            f.write("TRUE")
                        # Wait for the poller (every 50 ms here) so the save
                        # lands at this step boundary.
                        deadline = time.monotonic() + 2.0
                        while not preempt.preempted() and time.monotonic() < deadline:
                            time.sleep(0.01)
                    if not multihost and preempt.preempted():
                        emergency_preempt_exit()
                    if args.max_steps and global_step >= args.max_steps:
                        done = True
                        break
                end_step_span()
                loader_iter.close()
                if consensus:
                    # The epoch's (or run's) end: a rollback flag raised by the
                    # last step's flush, or a worker error latched after the
                    # last exchange, is agreed here, symmetrically.
                    agreed = decode_control_word(bus.exchange(encode_control_word(
                        rollback=rollback_requested, worker_error=worker_error is not None)))
                    if agreed.worker_error:
                        coordinated_worker_abort(worker_error)
                    rollback_requested = agreed.rollback
                if done or rollback_requested:
                    break
                skip_steps = 0   # later epochs start from batch 0

            if rollback_requested and not done:
                # Consecutive anomalies: restore the last verified checkpoint,
                # keep the data cursor past the offending batches, reset the
                # guard counters and the spike baseline, and go on.
                pending = None
                if watchdog is not None:
                    watchdog.disarm()   # the restore has no step cadence
                if monitor is not None:
                    monitor.reset()
                guard_state = init_guard_state() if use_guard else None
                rollbacks_done += 1
                tracer.event("rollback", step=global_step, count=rollbacks_done)
                if rollbacks_done > args.max_rollbacks:
                    sys.exit(f"error: loss diverged through {rollbacks_done} rollbacks "
                             f"(--max_rollbacks {args.max_rollbacks}); stopping")
                if saver is not None:
                    # An in-flight save may be about to commit the very
                    # checkpoint to restore: every process waits for its
                    # own writer, then for process 0's commit.
                    saver.wait()
                    bus.barrier()
                restored = (restore_latest_verified(args.save_dir, params, optimizer, layout)
                            if args.save_dir else None)
                check_same_restore(restored)
                start_epoch, skip_steps = epoch, step_in_epoch
                if restored is None:
                    say("[resilience] rollback requested but no verified checkpoint is "
                        "available; continuing in place with a reset spike baseline",
                        flush=True)
                    continue
                meta, _guard, rpath = restored
                global_step = meta.step
                last_saved_step = global_step
                tracker.total_tokens = meta.total_tokens
                say(f"[resilience] rollback #{rollbacks_done}: restored {rpath} (step "
                    f"{meta.step}); data cursor kept at epoch {epoch}, {step_in_epoch} opt "
                    f"steps in: the offending batches are skipped", flush=True)
                continue
            break

        flush_pending()
        if watchdog is not None:
            watchdog.disarm()   # the final save has no step cadence
        if saver is not None:
            # Every ending leaves a committed checkpoint of the final step:
            # a sync save now, or the in-flight save of this step drained.
            saver.ensure_committed_sync(
                global_step, optimizer,
                make_meta(global_step, min(epoch, args.epochs - 1) if args.epochs else 0,
                          step_in_epoch),
                guard_state)
    finally:
        # First, on every way out (exceptions, SystemExit, rollbacks
        # exhausted): a watchdog that outlived this call would hard-exit
        # the process that called it.
        if watchdog is not None:
            watchdog.stop()
        end_step_span()
        capture.stop_if_active()
        if whole_run is not None:
            whole_run.stop_if_active()
        tracker.close()
        if poller is not None:
            poller.stop()
        if saver is not None:
            saver.close()
        preempt.uninstall()
        if args.trace_dir:
            configure_tracing(None)   # closes the file; later runs trace nothing
    say(f"training done: {global_step} optimizer steps", flush=True)
    return tracker

if __name__ == "__main__":
    main()
