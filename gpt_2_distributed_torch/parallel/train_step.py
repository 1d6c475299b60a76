"""The training step: loss -> grad -> accumulate -> AdamW update
(``gpt_2_distributed_tpu/parallel/train_step.py``), eagerly, on one device
or as one process of a sequence-parallel mesh.

As in the JAX package:

* **Gradient accumulation** over the ``[accum, B, T]`` micro-batches of one
  optimizer step, with the loss scaled by ``1/accum`` inside the
  differentiated function, so the accumulated grads are the sum of
  ``g_i / accum`` (here summed by autograd into each param's fp32 ``.grad``).
* **The reported loss is the mean over micro-batches**; the grad norm is the
  global L2 norm of the accumulated grad, measured and never clipped unless
  the guard's clip threshold is set.
* **AdamW** with betas (0.9, 0.95), eps 1e-8 outside the square root, bias
  correction at count + 1, and decoupled weight decay on EVERY param
  (LayerNorm and biases included). ``torch.optim.AdamW`` computes optax's
  ``adamw`` update up to rounding order; :class:`ScheduledAdamW` evaluates
  the learning-rate schedule at its own update count, as optax does, so
  with warmup the first update uses ``schedule(0)``.
* **Mixed precision**: fp32 params, optimizer state and grads; the model
  casts its weights to the compute dtype (bf16) inside the forward.
* **Dropout keys** come from ``(seed, step_idx, micro-batch)``
  (``models/gpt2.py::hidden_states``), so a resumed run at step N redraws
  step N's masks.
* **Sequence parallelism.** Under an active mesh with sp > 1
  (``parallel/mesh.py``) each process holds every micro-batch's ``[B,
  T/sp]`` block and the loss stays the GLOBAL token mean, as the JAX
  package's global view computes it: one all-reduce of the valid-label
  counts per step makes each micro-batch's loss ``local sum / global
  count``; after accumulation the grads are summed over the mesh in a few
  flat buckets, and the loss too. The grad norm is taken after that, so
  the guard decides the same on every process and the params stay
  bit-identical across them.

The guarded step (``guard=True``) reads the loss and the grad norm on the
host to decide whether to apply the update: one device sync per optimizer
step (the JAX package decides on the device with ``lax.switch``). A
non-finite step does not call the optimizer at all, so params and AdamW
state — ``step`` and the schedule's count included — stay bit-unchanged.
A finite step whose grad norm exceeds ``clip_threshold`` clips each JAX
parameter leaf (a top-level param, or one block key stacked over all
layers) to L2 norm ``layer_clip_norm`` and applies.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from gpt_2_distributed_torch.config import GPT2Config
from gpt_2_distributed_torch.models import gpt2
from gpt_2_distributed_torch.ops.losses import IGNORE_INDEX
from gpt_2_distributed_torch.parallel.mesh import sp_mesh
from gpt_2_distributed_torch.resilience import (
    SKIP_NONFINITE_GRAD,
    SKIP_NONFINITE_LOSS,
    GuardState,
)

DEFAULT_WEIGHT_DECAY = 0.1
DEFAULT_BETAS = (0.9, 0.95)
DEFAULT_EPS = 1e-8
# Elements per flat bucket of the sp gradient all-reduce (128 MB of fp32):
# 124M's 148 grads go in 4 calls.
GRAD_BUCKET_ELEMS = 1 << 25


def param_leaves(params: dict) -> list[list[torch.Tensor]]:
    """The params grouped as the JAX package's pytree leaves: each
    top-level param alone, each block key over all layers (the JAX tree
    stacks per-layer params on a leading ``[L]`` axis)."""
    top = [[params[k]] for k in ("wte", "wpe", "ln_f_scale", "ln_f_bias")]
    return top + [[bp[k] for bp in params["blocks"]] for k in gpt2.BLOCK_KEYS]


def param_list(params: dict) -> list[torch.Tensor]:
    return [p for leaf in param_leaves(params) for p in leaf]


def trainable_params(params: dict, device: torch.device) -> dict:
    """``params`` (as :func:`models.gpt2.init_params` or
    ``models/convert.py`` make them) moved to ``device`` as leaf tensors
    that require grad."""
    out = {k: v if k == "blocks" else v.to(device) for k, v in params.items()}
    out["blocks"] = [{k: v.to(device) for k, v in bp.items()} for bp in params["blocks"]]
    for p in param_list(out):
        p.requires_grad_()
    return out


class ScheduledAdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` whose learning rate is ``learning_rate(count)``
    at its ``count``-th applied update (or a constant)."""

    def __init__(self, params, learning_rate: float | Callable[[int], float],
                 weight_decay: float, betas: tuple[float, float], eps: float):
        self.schedule = learning_rate if callable(learning_rate) else None
        lr = self.schedule(0) if self.schedule else learning_rate
        super().__init__(params, lr=lr, betas=betas, eps=eps,
                         weight_decay=weight_decay)
        self.count = 0

    def current_lr(self) -> float:
        return float(self.schedule(self.count)) if self.schedule else self.defaults["lr"]

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            group["lr"] = self.current_lr()
        super().step(closure)
        self.count += 1


def make_optimizer(
    params: dict,
    learning_rate: float | Callable[[int], float],
    weight_decay: float = DEFAULT_WEIGHT_DECAY,
    b1: float = DEFAULT_BETAS[0],
    b2: float = DEFAULT_BETAS[1],
    eps: float = DEFAULT_EPS,
) -> ScheduledAdamW:
    """AdamW over every param of ``params`` (the JAX ``make_optimizer``;
    torch's optimizer holds its params, so it takes them here)."""
    return ScheduledAdamW(param_list(params), learning_rate, weight_decay,
                          (b1, b2), eps)


class StepMetrics(NamedTuple):
    loss: torch.Tensor       # scalar fp32, mean over micro-batches
    grad_norm: torch.Tensor  # scalar fp32, global L2 norm of the accumulated grad


class GuardedStepMetrics(NamedTuple):
    """StepMetrics plus the anomaly-guard telemetry (guard=True steps)."""

    loss: torch.Tensor
    grad_norm: torch.Tensor
    skipped_steps: int  # cumulative updates skipped (post-step)
    skip_reason: int    # SKIP_* code for THIS step; 0 = applied
    clipped_steps: int  # cumulative clipped-then-applied steps
    clipped: int        # 1 iff THIS step was clip-applied


def _global_share(mesh, labels: torch.Tensor) -> torch.Tensor:
    """Per leading index of ``labels``, this process's share of the valid
    labels over the mesh (``local count / global count``, 0 where the
    global count is 0): a local token-mean loss times it is ``local sum /
    global count``."""
    local = (labels != IGNORE_INDEX).flatten(1).sum(1).float()
    total = local.clone()
    mesh.all_reduce_([total])
    return local / total.clamp(min=1.0)


def _all_reduce_buckets(mesh, tensors: list[torch.Tensor]) -> None:
    """Sum ``tensors`` in place over the mesh through flat buckets of at
    most GRAD_BUCKET_ELEMS elements."""
    buckets, size = [[]], 0
    for t in tensors:
        if buckets[-1] and size + t.numel() > GRAD_BUCKET_ELEMS:
            buckets.append([])
            size = 0
        buckets[-1].append(t)
        size += t.numel()
    for bucket in buckets:
        flat = torch.cat([t.reshape(-1) for t in bucket])
        mesh.all_reduce_([flat])
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def _accumulate_grads(config, compute_dtype, params, x, y, seed, step_idx,
                      loss_scale=None):
    """Forward + backward of every micro-batch of ``x, y`` ``[accum, B,
    T]`` (``T/sp`` blocks under an sp mesh), summing ``g_i / accum`` into
    each param's ``.grad`` (then over the mesh). Returns ``(mean loss,
    grad norm)`` as device scalars."""
    mesh = sp_mesh()
    accum = x.shape[0]
    inv_accum = 1.0 / accum
    share = None if mesh is None else _global_share(mesh, y)
    for p in param_list(params):
        p.grad = None
    loss_acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(accum):
        _, loss = gpt2.forward(params, config, x[i], y[i], rng=(seed, step_idx, i),
                               deterministic=False, compute_dtype=compute_dtype)
        if share is not None:
            loss = loss * share[i]
        if loss_scale is not None:
            loss = loss * loss_scale[i]
        loss = loss * inv_accum
        loss.backward()
        loss_acc = loss_acc + loss.detach()
    grads = [p.grad for p in param_list(params)]
    if mesh is not None:
        _all_reduce_buckets(mesh, grads + [loss_acc.view(1)])
    grad_norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
    return loss_acc, grad_norm


def _clip_leaves(params: dict, layer_clip_norm: float) -> None:
    """Clip each JAX leaf's gradient to L2 norm ``layer_clip_norm``."""
    for leaf in param_leaves(params):
        norm = torch.stack([p.grad.square().sum() for p in leaf]).sum().sqrt()
        scale = torch.clamp(layer_clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
        for p in leaf:
            p.grad.mul_(scale)


def make_train_step(
    config: GPT2Config,
    optimizer: ScheduledAdamW,
    compute_dtype: torch.dtype = torch.bfloat16,
    guard: bool = False,
    clip_threshold: float | None = None,
    layer_clip_norm: float = 1.0,
) -> Callable:
    """Build the train step. It updates ``params`` (and ``optimizer``) in
    place::

        metrics = step(params, x, y, seed, step_idx)

    where ``x, y`` are int ``[grad_accum, micro_batch, seq_len]`` on the
    params' device and ``seed`` is the run seed (dropout keys fold in
    ``step_idx`` and the micro-batch index). ``guard=True`` builds the
    guarded step (module docstring)::

        new_guard_state, metrics = step(params, guard_state, x, y, seed,
                                        step_idx, loss_scale)

    with ``loss_scale`` a ``[grad_accum]`` fp32 vector multiplied into each
    micro-batch's loss (all ones in production; ``--inject_nan_at`` poisons
    one entry)."""

    def train_step(params, x, y, seed, step_idx):
        loss, grad_norm = _accumulate_grads(config, compute_dtype, params, x, y,
                                            seed, step_idx)
        optimizer.step()
        return StepMetrics(loss=loss, grad_norm=grad_norm)

    if not guard:
        return train_step

    def guarded_train_step(params, guard_state: GuardState, x, y, seed, step_idx,
                           loss_scale):
        loss, grad_norm = _accumulate_grads(config, compute_dtype, params, x, y,
                                            seed, step_idx, loss_scale)
        # The one host sync of the step: the decision below needs both.
        loss_ok = bool(torch.isfinite(loss))
        finite = loss_ok and bool(torch.isfinite(grad_norm))
        huge = finite and clip_threshold is not None and float(grad_norm) > clip_threshold
        skipped = clipped = 0
        reason = 0
        if not finite:
            # Skipped: no optimizer call, so params and AdamW state (step,
            # moments, the schedule's count) stay bit-unchanged.
            skipped = 1
            reason = SKIP_NONFINITE_GRAD if loss_ok else SKIP_NONFINITE_LOSS
        else:
            if huge:
                _clip_leaves(params, layer_clip_norm)
                clipped = 1
            optimizer.step()
        new_guard = GuardState(
            skipped_steps=guard_state.skipped_steps + skipped,
            last_skip_reason=reason if skipped else guard_state.last_skip_reason,
            clipped_steps=guard_state.clipped_steps + clipped,
        )
        return new_guard, GuardedStepMetrics(
            loss=loss, grad_norm=grad_norm,
            skipped_steps=new_guard.skipped_steps, skip_reason=reason,
            clipped_steps=new_guard.clipped_steps, clipped=clipped,
        )

    return guarded_train_step


def make_eval_step(config: GPT2Config,
                   compute_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """Eval loss on a ``[B, T]`` batch (no dropout, no update); under an sp
    mesh ``x, y`` are this process's ``[B, T/sp]`` blocks and the loss is
    the global token mean."""

    @torch.no_grad()
    def eval_step(params, x, y):
        _, loss = gpt2.forward(params, config, x, y, deterministic=True,
                               compute_dtype=compute_dtype)
        mesh = sp_mesh()
        if mesh is not None:
            loss = loss * _global_share(mesh, y[None])[0]
            mesh.all_reduce_([loss])
        return loss

    return eval_step
