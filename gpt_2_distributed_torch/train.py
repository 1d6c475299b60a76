"""Training CLI of the PyTorch port (``gpt_2_distributed_tpu/train.py``):
one process on one device, or one process per device of a
sequence-parallel mesh.

    python -m gpt_2_distributed_torch.train --data_dir <shards>
    torchrun --nproc_per_node 2 -m gpt_2_distributed_torch.train \
        --data_dir <shards> --mesh sp=2

The flag surface is the JAX CLI's. What this slice runs: the model and data
flags, batch / grad-accum / epochs, the learning-rate schedule, AdamW
weight decay, periodic eval, the non-finite step guard with its per-layer
clip fallback and ``--inject_nan_at``, ``--dropout``, ``--attention_impl``,
``--fused_layers``, ``--fused_matmul``, ``--device_prefetch`` (pinned host
batches copied with ``non_blocking=True`` one optimizer step ahead),
``--device`` and ``--mesh sp=S``. Every
flag whose plane is not ported yet (DDP/FSDP and tp meshes, checkpoints and
resume, the spike monitor's rollback, TensorBoard and tracing, the
multi-host control plane, the other fault injections, bf16 grad
accumulation, remat) is refused with a "later slice"
error instead of being ignored.

Runs on CUDA unless ``--device cpu`` is given; without a visible GPU it
exits with the "no CUDA device" message. On CUDA the attention runs
through the hand-written kernels K1 (forward, with in-kernel dropout) and
K2 (backward); ``--fused_layers`` runs the layer epilogues through K4
(LN+residual+dropout), K5 (residual+dropout) and K6 (bias+GELU+dropout);
``--fused_matmul`` runs the matmul legs with their epilogues through K7
(forward, dgrad and wgrad), in place of K4-K6 on the legs it covers.
Prints the JAX CLI's ``step N | loss: ...`` lines and
``training done: N optimizer steps``.

``--mesh sp=S`` shards every sequence over S processes, one per device,
started by ``torchrun`` (``RANK``, ``WORLD_SIZE`` = S, ``LOCAL_RANK``):
NCCL between cards, gloo with ``--device cpu``. Every process reads the
same global batch and trains on its ``[B, T/S]`` block; attention is ring
attention over the mesh (K8 per ring step on the card), the loss the
global token mean and the grads summed over the mesh
(``parallel/train_step.py``). Only process 0 prints. Under sp > 1
``--fused_layers``/``--fused_matmul`` other than ``off`` and
``--attention_impl`` ``flash``/``dense`` are refused (later slices).
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np

from gpt_2_distributed_torch.config import DEFAULT_BLOCK_ROWS, MODEL_PRESETS
from gpt_2_distributed_torch.data.dataloader import (
    DEFAULT_BATCH_SIZE,
    DEFAULT_CONTEXT_LENGTH,
    DEFAULT_NUM_WORKERS,
    DEFAULT_PREFETCH_FACTOR,
)
from gpt_2_distributed_torch.parallel.mesh import validate_mesh_for_config

DEFAULT_SEED = 42

# Flags whose planes come with later slices of the port, with the value
# that leaves them off; any other value is refused.
_UNPORTED = {
    "training_mode": "local", "shard_update": "auto",
    "save_dir": None, "resume": False, "save_every": 1000, "async_save": "on",
    "keep_last_n": 0, "save_retries": 2, "save_retry_backoff": 0.5,
    "preempt_poll_url": None, "preempt_poll_interval": 5.0,
    "spike_sigma": 6.0, "max_consecutive_skips": 3, "max_rollbacks": 3,
    "log_dir": None, "tb_every": 1, "profile": False, "xla_profile_at": None,
    "trace_dir": None, "trace_max_file_bytes": 64 * 1024 * 1024,
    "accum_dtype": "fp32", "desync_check_every": 0, "consensus_every": 1,
    "hang_timeout_s": 0.0, "inject_fail_at": 0, "inject_preempt_at": 0,
    "inject_save_fail_at": 0, "inject_save_fail_count": 1,
    "inject_preempt_notice_at": 0, "inject_desync_at": 0, "inject_hang_at": 0,
    "inject_world_size": 0, "inject_worker_fail_at": 0,
    "coordinator_address": None, "num_processes": None, "process_id": None,
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gpt_2_distributed_torch.train",
        description="GPT-2 pretraining with PyTorch on one GPU, or sequence-"
        "parallel over several under torchrun (the port of "
        "gpt_2_distributed_tpu.train)",
    )
    p.add_argument("--data_dir", required=True, help="directory of uint16 .bin token shards")
    p.add_argument("--split", default="train")
    p.add_argument("--training_mode", default="local",
                   choices=["local", "dp", "ddp", "fsdp"],
                   help="only 'local' is ported; the others come with DDP/FSDP")
    p.add_argument("--mesh", default=None,
                   help="mesh shape 'sp=S': the sequence sharded over S processes "
                   "under torchrun (ring attention); data/fsdp/tp come with later "
                   "slices")
    p.add_argument("--attention_impl", default=None,
                   choices=["auto", "dense", "flash", "ring"],
                   help="'flash'/'auto': the CUDA kernels K1/K2 on the card, "
                   "their plain versions on the CPU; 'dense': plain PyTorch "
                   "attention; 'ring' (and 'auto' under --mesh sp>1): ring "
                   "attention over the sp processes, K8 on the card")
    p.add_argument("--shard_update", default="auto", choices=["off", "on", "auto"],
                   help="ZeRO-2 sharded update; one device: off")
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
                   help="micro-batch size")
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
    p.add_argument("--desync_check_every", type=int, default=0)
    p.add_argument("--consensus_every", type=int, default=1)
    p.add_argument("--hang_timeout_s", type=float, default=0.0)
    p.add_argument("--data_read_retries", type=int, default=2)
    p.add_argument("--inject_desync_at", type=int, default=0)
    p.add_argument("--inject_hang_at", type=int, default=0)
    p.add_argument("--inject_world_size", type=int, default=0)
    p.add_argument("--dropout", type=float, default=None,
                   help="override every dropout rate (embedding, attention, "
                   "residual) with one value")
    p.add_argument("--inject_worker_fail_at", type=int, default=0)
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
    p.add_argument("--profile", action="store_true")
    p.add_argument("--xla_profile_at", default=None)
    p.add_argument("--trace_dir", default=None)
    p.add_argument("--trace_max_file_bytes", type=int, default=64 * 1024 * 1024)
    p.add_argument("--cli_every", type=int, default=20)
    p.add_argument("--tb_every", type=int, default=1)
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
    if args.shard_update == "on":
        p.error("--shard_update on needs a data-parallel mesh, which is not "
                "ported to PyTorch yet: it comes in a later slice of the port")


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
        return _run(args, config, device, None)
    rank = int(os.environ["RANK"])
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            rank=rank, world_size=world)
    try:
        mesh = Mesh(spec, rank)
        with activate_mesh(mesh):
            return _run(args, config, device, mesh)
    finally:
        dist.destroy_process_group()


def _mesh_spec(p: argparse.ArgumentParser, args):
    """``--mesh`` as a MeshSpec, with the combinations this slice refuses."""
    from gpt_2_distributed_torch.parallel.mesh import MeshSpec, refuse_unported_axes

    try:
        spec = MeshSpec.parse(args.mesh) if args.mesh else MeshSpec()
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


def _run(args, config, device, mesh):
    """The training loop of :func:`main` on ``device``; under an sp mesh
    every process reads the same global batches and trains on its
    ``[B, T/sp]`` block of each, and only the first one prints."""
    import torch

    from gpt_2_distributed_torch.data.dataloader import (
        TokenShardDataset,
        create_dataloader,
        get_shard_paths,
    )
    from gpt_2_distributed_torch.metrics.tracker import StatsTracker
    from gpt_2_distributed_torch.models import gpt2
    from gpt_2_distributed_torch.parallel.mesh import is_primary
    from gpt_2_distributed_torch.parallel.train_step import (
        make_eval_step,
        make_optimizer,
        make_train_step,
        trainable_params,
    )
    from gpt_2_distributed_torch.resilience import SKIP_REASON_NAMES, init_guard_state
    from gpt_2_distributed_torch.utils.flops import device_peak_flops, flops_per_token

    primary = is_primary()

    def say(*a, **kw) -> None:
        if primary:
            print(*a, **kw)

    def local_block(a: np.ndarray) -> np.ndarray:
        """This process's ``[..., T/sp]`` block of ``[..., T]`` tokens."""
        if mesh is None:
            return a
        tl = args.seq_len // mesh.sp
        return np.ascontiguousarray(a[..., mesh.sp_index * tl:(mesh.sp_index + 1) * tl])

    local_batch = args.batch
    dataset = TokenShardDataset(
        get_shard_paths(args.data_dir, args.split), seq_len=args.seq_len,
        num_workers=args.workers, vocab_size=config.vocab_size,
        data_read_retries=args.data_read_retries,
    )
    steps_per_epoch = dataset.batches_per_epoch(local_batch) // args.grad_accum_steps
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "host CPU"
    where = "" if mesh is None else (f"mesh: data={mesh.spec.data}, fsdp={mesh.spec.fsdp}, "
                                     f"sp={mesh.sp}, tp={mesh.spec.tp} | ")
    say(f"device: {device} ({name}) | {where}model: {args.model} "
        f"({config.num_params() / 1e6:.1f}M params) | steps/epoch: "
        f"{steps_per_epoch}", flush=True)

    try:
        schedule = make_lr_schedule(args, steps_per_epoch)
    except ValueError as e:
        sys.exit(f"error: {e}")
    params = trainable_params(gpt2.init_params(config, seed=args.seed), device)
    optimizer = make_optimizer(params, schedule, weight_decay=args.weight_decay)
    use_guard = args.step_guard == "on"
    train_step = make_train_step(
        config, optimizer, guard=use_guard,
        clip_threshold=args.guard_max_grad_norm or None,
        layer_clip_norm=args.guard_clip_norm,
    )
    guard_state = init_guard_state() if use_guard else None
    ones_scale = torch.ones(args.grad_accum_steps, device=device)
    nan_scale = ones_scale.clone()
    nan_scale[0] = float("nan")

    tracker = StatsTracker(
        batch_size=args.batch * args.grad_accum_steps, seq_len=args.seq_len,
        cli_every=args.cli_every, flops_per_token=flops_per_token(config, args.seq_len),
        peak_flops_per_chip=device_peak_flops(device), device=device,
        n_chips=1 if mesh is None else mesh.spec.n_devices, printing=primary,
    )

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
            n_eval = min(args.eval_batches, eval_dataset.batches_per_epoch(local_batch))
            if n_eval == 0:
                say("--eval_every: val split has fewer tokens than one batch "
                    f"({local_batch}x{args.seq_len}); eval disabled")
            else:
                eval_step = make_eval_step(config)
                eval_loader = create_dataloader(eval_dataset, batch_size=local_batch,
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

    # --- epoch/step loop ----------------------------------------------------
    # Unguarded, metrics are read one step late: step N+1 is issued before
    # step N's loss is read back, so the host never waits on the device
    # between steps. The guarded step reads its loss and grad norm on the
    # host to decide (one sync per optimizer step), so it is flushed at once.
    global_step = 0
    pending = None
    last_skip_reason_host = 0

    def flush_pending() -> None:
        nonlocal pending, last_skip_reason_host
        if pending is None:
            return
        p_step, p_epoch, p_batch, m = pending
        pending = None
        extra = {}
        skipped = False
        if use_guard:
            if m.skip_reason:
                skipped = True
                last_skip_reason_host = m.skip_reason
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
        if dataset.read_retry_count:
            extra["data_read_retries"] = dataset.read_retry_count
        values = dict(lr=float(lr_of(p_step - 1)), epoch=p_epoch, batch=p_batch)
        # A skipped step's loss and grad norm are the rejected values: the
        # [guard] line reports them; the windowed averages stay clean.
        if not skipped:
            values["loss"] = float(m.loss)
            values["grad_norm"] = float(m.grad_norm)
        tracker.update(p_step, **values, **extra)

    done = False
    for epoch in range(args.epochs):
        dataset.set_epoch(epoch)
        tracker.start_epoch()
        loader_iter = iter(create_dataloader(dataset, batch_size=local_batch,
                                             prefetch_factor=args.prefetch_factor))
        step_in_epoch = 0
        micro: list = []
        prefetched = None
        while step_in_epoch < steps_per_epoch:
            if prefetched is not None:
                x, y = prefetched
                prefetched = None
            else:
                try:
                    while len(micro) < args.grad_accum_steps:
                        micro.append(next(loader_iter))
                except StopIteration:
                    break
                x, y = to_device(micro)
            micro = []
            if use_guard:
                loss_scale = ones_scale
                if args.inject_nan_at and global_step + 1 == args.inject_nan_at:
                    loss_scale = nan_scale
                    say(f"[inject] poisoning micro-batch 0 loss with NaN at "
                        f"step {global_step + 1}", flush=True)
                guard_state, m = train_step(params, guard_state, x, y, args.seed,
                                            global_step, loss_scale)
            else:
                m = train_step(params, x, y, args.seed, global_step)
            global_step += 1
            step_in_epoch += 1
            # --device_prefetch: the next step's batch goes to the card now,
            # while this step's work is still queued on it.
            if (args.device_prefetch == "on" and step_in_epoch < steps_per_epoch
                    and not (args.max_steps and global_step >= args.max_steps)):
                try:
                    while len(micro) < args.grad_accum_steps:
                        micro.append(next(loader_iter))
                    prefetched = to_device(micro)
                except StopIteration:
                    pass
            flush_pending()
            pending = (global_step, epoch, step_in_epoch, m)
            if use_guard:
                # The guarded step has already waited for its own results;
                # a lag would only charge the next step's time to this one.
                flush_pending()
            if run_eval is not None and global_step % args.eval_every == 0:
                flush_pending()
                tracker.update(global_step, count_tokens=False, eval_loss=run_eval())
            if args.max_steps and global_step >= args.max_steps:
                done = True
                break
        loader_iter.close()
        if done:
            break

    flush_pending()
    say(f"training done: {global_step} optimizer steps", flush=True)
    return tracker


if __name__ == "__main__":
    main()
