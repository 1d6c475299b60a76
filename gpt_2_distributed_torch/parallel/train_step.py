"""The training step: loss -> grad -> accumulate -> AdamW update
(``gpt_2_distributed_tpu/parallel/train_step.py``), eagerly, on one device
or as one process of a data / fsdp / sequence-parallel mesh.

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
* **Meshes.** Under an active mesh of more than one process
  (``parallel/mesh.py``) each process holds its rows of every micro-batch
  (the batch split over ('data', 'fsdp')) and its ``T/sp`` block of each
  row, and the loss stays the GLOBAL token mean, as the JAX package's
  global view computes it: one all-reduce of the valid-label counts per
  step makes each micro-batch's loss ``local sum / global count``.
  With the state replicated, autograd sums each micro-batch's grads into
  the full fp32 ``.grad`` and the grads are summed over the mesh in a few
  flat buckets (with the loss), and the grad norm is taken after that.
  With a sharded state (:class:`ShardedUpdate`: 'fsdp' > 1, or
  ``--shard_update`` on a 'data' axis) AdamW updates fp32 master shards
  with moments of the same shape. Under 'fsdp' the shards are the params:
  each forward gathers a tensor whole when the model reaches it and each
  backward reduce-scatters its grad onto the shard. Under
  ``--shard_update`` the whole params take the grads, which are
  reduce-scattered onto the shards once a step, and the fresh shards are
  gathered back into them. The guard decides on the global norm (each
  shard's squares counted once over the mesh, in one all-reduce with the
  loss), the per-leaf clip on each leaf's full norm. Either way every
  process decides the same and ends the step with bit-identical params.

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

from collections.abc import Sequence
from typing import Callable, NamedTuple

import torch

from gpt_2_distributed_torch.config import GPT2Config
from gpt_2_distributed_torch.models import gpt2
from gpt_2_distributed_torch.ops.losses import IGNORE_INDEX
from gpt_2_distributed_torch.parallel.mesh import AXES, DATA_AXIS, FSDP_AXIS, multi_mesh
from gpt_2_distributed_torch.parallel.sharding import (
    TOP_KEYS,
    TensorLayout,
    take_shard,
    tensor_layouts,
)
from gpt_2_distributed_torch.resilience import (
    SKIP_NONFINITE_GRAD,
    SKIP_NONFINITE_LOSS,
    GuardState,
)

DEFAULT_WEIGHT_DECAY = 0.1
DEFAULT_BETAS = (0.9, 0.95)
DEFAULT_EPS = 1e-8
# Elements per flat bucket of the gradient collectives (128 MB of fp32):
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


def _buckets(items: list, numel) -> list[list]:
    """``items`` in runs of at most GRAD_BUCKET_ELEMS elements (one item
    alone may exceed it)."""
    buckets, size = [], 0
    for it in items:
        n = numel(it)
        if not buckets or (buckets[-1] and size + n > GRAD_BUCKET_ELEMS):
            buckets.append([])
            size = 0
        buckets[-1].append(it)
        size += n
    return buckets


class _Gather(torch.autograd.Function):
    """Tensors ``idx`` of a :class:`ShardedUpdate` whole, all-gathered
    from their shards; the backward reduce-scatters their whole grads back
    onto the shards."""

    @staticmethod
    def forward(ctx, sharded, idx, *shards):
        ctx.sharded, ctx.idx = sharded, idx
        return tuple(w.reshape(sharded.shapes[i])
                     for i, w in zip(idx, sharded.gather(idx, shards)))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.sharded.scatter(ctx.idx, grads))


class _Layers(Sequence):
    """The blocks of a forward's params, each made when the forward reaches
    it."""

    def __init__(self, n: int, get: Callable[[int], dict]):
        self.n, self.get = n, get

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, layer: int) -> dict:
        if not 0 <= layer < self.n:
            raise IndexError(layer)
        return self.get(layer)


class ShardedUpdate:
    """This process's part of a sharded training state: for each tensor of
    :func:`param_list`, its fp32 master shard in the layout of
    ``parallel/sharding.py::tensor_layouts`` (this process's chunk along
    every placed dim), which AdamW holds and updates. A tensor is one of:

    * **placed on 'fsdp'** (the JAX fsdp layout: params sharded): the
      shard is the only copy, and the tensor in ``params`` is emptied.
      Each forward all-gathers it whole from the shard when the model
      reaches it (:meth:`working`: a block's tensors at that block), the
      graph holds the whole tensor (or its compute-dtype cast) until the
      backward has used it, and the backward reduce-scatters its grad onto
      the shard's ``.grad`` there and then. Between micro-batches a process
      holds 1/N of these params, grads and moments.
    * **placed on 'data' only** (``--shard_update``: params replicated, the
      update sharded): the whole param stays the model's working copy and
      takes the micro-batches' grads; :meth:`reduce_grads` reduce-scatters
      them onto the shard once a step and :meth:`gather_params` copies the
      updated shards back into it.
    * **placed nowhere** (no degree divides a dim): the shard is the param.
    """

    def __init__(self, params: dict, mesh, layouts: list[TensorLayout]):
        self.mesh = mesh
        self.layouts = layouts
        self.params = param_list(params)
        self.n_layer = len(params["blocks"])
        self.shapes = [p.shape for p in self.params]
        self.gathered = [any(a == FSDP_AXIS for a, _ in lay.placement) for lay in layouts]
        # The 'data'-only tensors: whole params, sharded update.
        self.replicated = [i for i, lay in enumerate(layouts)
                           if lay.placement and not self.gathered[i]]
        self.shards = []
        with torch.no_grad():
            for p, lay, gathered in zip(self.params, layouts, self.gathered):
                if not lay.placement:
                    self.shards.append(p)
                    continue
                self.shards.append(take_shard(p, lay, mesh).clone().requires_grad_())
                if gathered:
                    p.data = p.new_empty(0)
        self.n_leaves = max(lay.leaf for lay in layouts) + 1
        # The grads are summed over every axis over which the processes hold
        # different tokens: reduce-scattered over those that split a
        # tensor, all-reduced over the rest.
        sum_axes = mesh.axes_of(AXES)
        self.rest = [tuple(a for a in sum_axes if a not in {x for x, _ in lay.placement})
                     for lay in layouts]
        # Make every subgroup the step uses now, in the same order on every
        # process (a dict, not a set: set order follows the string hash,
        # which differs between processes).
        used = [(a,) for lay in layouts for a, _ in lay.placement] + self.rest
        for axes in dict.fromkeys(used):
            if mesh.size_of(axes) > 1:
                mesh.group_of(axes)

    @classmethod
    def build(cls, params: dict, config, mesh, shard_update: bool) -> "ShardedUpdate | None":
        """The sharded state of ``mesh``, or None where nothing is split (no
        mesh, fsdp == 1 without ``shard_update``)."""
        if mesh is None:
            return None
        layouts = tensor_layouts(config, mesh.spec, shard_update)
        if not any(lay.placement for lay in layouts):
            return None
        return cls(params, mesh, layouts)

    def _placed(self, idx: list[int], axis: str) -> list[tuple[int, int]]:
        """``(position in idx, dim)`` of every tensor of ``idx`` that
        ``axis`` splits."""
        return [(j, d) for j, i in enumerate(idx)
                for a, d in self.layouts[i].placement if a == axis]

    def gather(self, idx: list[int], shards) -> list[torch.Tensor]:
        """Tensors ``idx`` whole (in their views' shapes) from this
        process's ``shards`` of them: one all-gather of their flat
        concatenation per axis that splits them."""
        ts = list(shards)
        for axis in (DATA_AXIS, FSDP_AXIS):
            placed = self._placed(idx, axis)
            if not placed:
                continue
            n = self.mesh.shape[axis]
            flat = torch.cat([ts[j].reshape(-1) for j, _ in placed])
            full = self.mesh.all_gather(flat, (axis,)).view(n, -1)
            off = 0
            for j, d in placed:
                t = ts[j]
                parts = full[:, off:off + t.numel()].reshape(n, *t.shape)
                ts[j] = parts.movedim(0, d).flatten(d, d + 1)
                off += t.numel()
        return ts

    def scatter(self, idx: list[int], grads) -> list[torch.Tensor]:
        """The whole grads of tensors ``idx`` summed over each axis that
        splits them, cut to this process's shards: one reduce-scatter of
        their chunks per axis."""
        gs = [g.reshape(self.layouts[i].view) for i, g in zip(idx, grads)]
        for axis in (DATA_AXIS, FSDP_AXIS):
            placed = self._placed(idx, axis)
            if not placed:
                continue
            n = self.mesh.shape[axis]
            chunks = [gs[j].unflatten(d, (n, gs[j].shape[d] // n)).movedim(d, 0)
                      for j, d in placed]
            out = self.mesh.reduce_scatter(
                torch.cat([c.reshape(n, -1) for c in chunks], dim=1), (axis,))
            off = 0
            for (j, _), c in zip(placed, chunks):
                gs[j] = out[off:off + c[0].numel()].view(c.shape[1:])
                off += c[0].numel()
        return gs

    def working(self, params: dict) -> dict:
        """``params`` as one forward reads them: the 'fsdp'-placed tensors
        gathered whole from their shards through :class:`_Gather`, the top
        ones at once and a block's when the forward reaches that block, in
        one collective per axis; the others as they are."""
        top, n_layer = len(TOP_KEYS), self.n_layer

        def get(idx: list[int], tensors: list[torch.Tensor]) -> list[torch.Tensor]:
            mine = [j for j, i in enumerate(idx) if self.gathered[i]]
            if mine:
                whole = _Gather.apply(self, [idx[j] for j in mine],
                                      *(self.shards[idx[j]] for j in mine))
                for j, w in zip(mine, whole):
                    tensors[j] = w
            return tensors

        def block(layer: int) -> dict:
            bp = params["blocks"][layer]
            idx = [top + j * n_layer + layer for j in range(len(gpt2.BLOCK_KEYS))]
            return dict(zip(gpt2.BLOCK_KEYS, get(idx, [bp[k] for k in gpt2.BLOCK_KEYS])))

        out = dict(zip(TOP_KEYS, get(list(range(top)), [params[k] for k in TOP_KEYS])))
        out["blocks"] = _Layers(n_layer, block)
        return out

    @torch.no_grad()
    def full_params(self, params: dict) -> dict:
        """A whole copy of the params (the 'fsdp'-placed tensors gathered)."""
        w = self.working(params)
        return {**{k: w[k] for k in TOP_KEYS}, "blocks": list(w["blocks"])}

    def zero_grads(self) -> None:
        for t in self.params + self.shards:
            t.grad = None

    def reduce_grads(self) -> None:
        """This step's grads summed over the mesh onto the shards' ``.grad``:
        the whole grads of the 'data'-only tensors reduce-scattered over
        'data' in a few flat buckets (the 'fsdp'-placed ones are on their
        shards already), then every shard's grad all-reduced over the axes
        that do not split it."""
        for bucket in _buckets(self.replicated, lambda i: self.params[i].numel()):
            grads = self.scatter(bucket, [self.params[i].grad for i in bucket])
            for i, g in zip(bucket, grads):
                self.shards[i].grad = g
                self.params[i].grad = None
        by_axes: dict[tuple[str, ...], list[torch.Tensor]] = {}
        for s, rest in zip(self.shards, self.rest):
            if rest:
                by_axes.setdefault(rest, []).append(s.grad)
        for axes, grads in by_axes.items():
            _all_reduce_buckets(self.mesh, grads, axes)

    def leaf_sq_norms(self, loss: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(squared L2 norm of each JAX leaf's full grad, ``loss`` summed
        over the mesh), in one all-reduce: each shard's squares count on
        the one process of its replicas whose index is 0 on every axis that
        does not split it."""
        sq = [torch.zeros((), dtype=torch.float32, device=loss.device)
              for _ in range(self.n_leaves)]
        for s, lay, rest in zip(self.shards, self.layouts, self.rest):
            if all(self.mesh.axis_index(a) == 0 for a in rest):
                sq[lay.leaf] = sq[lay.leaf] + s.grad.square().sum()
        vec = self.mesh.all_reduce(torch.stack(sq + [loss]))
        return vec[:-1], vec[-1]

    def clip_leaves(self, leaf_sq: torch.Tensor, layer_clip_norm: float) -> None:
        """Clip each leaf's shards by the leaf's full norm."""
        scale = torch.clamp(layer_clip_norm / torch.clamp(leaf_sq.sqrt(), min=1e-12), max=1.0)
        for s, lay in zip(self.shards, self.layouts):
            s.grad.mul_(scale[lay.leaf])

    @torch.no_grad()
    def gather_params(self) -> None:
        """Copy the updated shards of the 'data'-only tensors, all-gathered
        over 'data' in a few flat buckets, into their whole params."""
        for bucket in _buckets(self.replicated, lambda i: self.params[i].numel()):
            whole = self.gather(bucket, [self.shards[i] for i in bucket])
            for i, w in zip(bucket, whole):
                self.params[i].copy_(w.reshape(self.shapes[i]))


def state_bytes(params: dict, optimizer, sharded: ShardedUpdate | None = None) -> dict:
    """The bytes of training state this process holds: ``params`` (the
    params and the master shards that are not params), ``grads`` (their
    ``.grad``) and ``moments`` (AdamW's two)."""
    held = {id(t): t for t in param_list(params) + (sharded.shards if sharded else [])}
    return {
        "params": sum(t.nbytes for t in held.values()),
        "grads": sum(t.grad.nbytes for t in held.values() if t.grad is not None),
        "moments": sum(st[k].nbytes for st in optimizer.state.values()
                       for k in ("exp_avg", "exp_avg_sq")),
    }


def make_optimizer(
    params: dict,
    learning_rate: float | Callable[[int], float],
    weight_decay: float = DEFAULT_WEIGHT_DECAY,
    b1: float = DEFAULT_BETAS[0],
    b2: float = DEFAULT_BETAS[1],
    eps: float = DEFAULT_EPS,
    sharded: ShardedUpdate | None = None,
) -> ScheduledAdamW:
    """AdamW over every param of ``params`` (the JAX ``make_optimizer``;
    torch's optimizer holds its params, so it takes them here), or over
    ``sharded``'s master shards."""
    tensors = sharded.shards if sharded is not None else param_list(params)
    return ScheduledAdamW(tensors, learning_rate, weight_decay, (b1, b2), eps)


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
    total = mesh.all_reduce(local.clone())
    return local / total.clamp(min=1.0)


def _all_reduce_buckets(mesh, tensors: list[torch.Tensor], axes=AXES) -> None:
    """Sum ``tensors`` in place over the mesh ``axes`` through flat buckets
    of at most GRAD_BUCKET_ELEMS elements."""
    for bucket in _buckets(tensors, torch.Tensor.numel):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        mesh.all_reduce(flat, axes)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def _accumulate_grads(config, compute_dtype, params, x, y, seed, step_idx,
                      loss_scale=None, sharded=None):
    """Forward + backward of every micro-batch of ``x, y`` ``[accum, B,
    T]`` (this process's rows and ``T/sp`` blocks under a mesh), summing
    ``g_i / accum`` into each param's ``.grad``, then over the mesh (onto
    ``sharded``'s shards when given). Returns ``(mean loss, grad norm,
    per-leaf squared norms or None)`` as device values."""
    mesh = multi_mesh()
    accum = x.shape[0]
    inv_accum = 1.0 / accum
    share = None if mesh is None else _global_share(mesh, y)
    if sharded is not None:
        sharded.zero_grads()
    else:
        for p in param_list(params):
            p.grad = None
    loss_acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(accum):
        w = params if sharded is None else sharded.working(params)
        _, loss = gpt2.forward(w, config, x[i], y[i], rng=(seed, step_idx, i),
                               deterministic=False, compute_dtype=compute_dtype)
        if share is not None:
            loss = loss * share[i]
        if loss_scale is not None:
            loss = loss * loss_scale[i]
        loss = loss * inv_accum
        loss.backward()
        loss_acc = loss_acc + loss.detach()
    if sharded is not None:
        sharded.reduce_grads()
        leaf_sq, loss_acc = sharded.leaf_sq_norms(loss_acc)
        return loss_acc, leaf_sq.sum().sqrt(), leaf_sq
    grads = [p.grad for p in param_list(params)]
    if mesh is not None:
        _all_reduce_buckets(mesh, grads + [loss_acc.view(1)])
    grad_norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
    return loss_acc, grad_norm, None


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
    sharded: ShardedUpdate | None = None,
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
    one entry).

    With ``sharded`` (the :class:`ShardedUpdate` whose shards ``optimizer``
    holds) the grads are reduced onto the shards, and the full params are
    gathered from them after each applied update."""

    def apply_update():
        optimizer.step()
        if sharded is not None:
            sharded.gather_params()

    def train_step(params, x, y, seed, step_idx):
        loss, grad_norm, _ = _accumulate_grads(config, compute_dtype, params, x, y,
                                               seed, step_idx, sharded=sharded)
        apply_update()
        return StepMetrics(loss=loss, grad_norm=grad_norm)

    if not guard:
        return train_step

    def guarded_train_step(params, guard_state: GuardState, x, y, seed, step_idx,
                           loss_scale):
        loss, grad_norm, leaf_sq = _accumulate_grads(config, compute_dtype, params, x, y,
                                                     seed, step_idx, loss_scale, sharded)
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
                if sharded is not None:
                    sharded.clip_leaves(leaf_sq, layer_clip_norm)
                else:
                    _clip_leaves(params, layer_clip_norm)
                clipped = 1
            apply_update()
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
                   compute_dtype: torch.dtype = torch.bfloat16,
                   sharded: ShardedUpdate | None = None) -> Callable:
    """Eval loss on a ``[B, T]`` batch (no dropout, no update); under a
    mesh ``x, y`` are this process's rows and ``T/sp`` blocks and the loss
    is the global token mean. With ``sharded`` the 'fsdp'-placed params
    are gathered from its shards, a block's at that block."""

    @torch.no_grad()
    def eval_step(params, x, y):
        w = params if sharded is None else sharded.working(params)
        _, loss = gpt2.forward(w, config, x, y, deterministic=True,
                               compute_dtype=compute_dtype)
        mesh = multi_mesh()
        if mesh is not None:
            loss = mesh.all_reduce(loss * _global_share(mesh, y[None])[0])
        return loss

    return eval_step
