"""Placement rules of the data/fsdp mesh (``gpt_2_distributed_tpu/parallel/
sharding.py``): which dim of each parameter leaf a mesh axis splits, and
this process's part of it.

The rules are the JAX package's, computed on the JAX tree's leaf shapes
(block leaves stacked ``[L, ...]``, the qkv weight head-explicit ``[L, C,
3, H, D]`` and its bias ``[L, 3, H, D]``) and returned as tuples of axis
names, one entry per dim (``()`` where JAX gives ``P()``):

* **param rule** (:func:`param_pspecs`): under 'fsdp' shard the largest
  dim that the degree divides, trailing dims winning ties, never the
  stacked layer axis; a leaf with no such dim stays replicated;
* **update rule** (:func:`update_pspecs`, ``--shard_update``): the param
  spec plus 'data' on the best remaining dim by the same rule;
* the batch is split over ('data', 'fsdp') and the sequence over 'sp'
  (a process's rows are ``ops/spmd.py::shard_offset`` over
  ``batch_axes``).

The port holds each JAX leaf as one tensor per layer, so a block leaf's
placement is the same dim's chunk of every layer's tensor: :func:`tensor_
layouts` gives, for each tensor of ``train_step.param_list``, the per-layer
view it is split in (the JAX leaf's shape without the layer axis; the qkv
tensors are row-major reshapes of it) and its ``(axis, dim)`` pairs.
:func:`take_shard` cuts this process's chunk out of a full tensor: along
each placed dim the chunk at its index on that axis, which is what JAX's
``NamedSharding`` holds on that device. The tp branches come with the
tensor-parallel slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpt_2_distributed_torch.models.gpt2 import BLOCK_KEYS
from gpt_2_distributed_torch.parallel.mesh import DATA_AXIS, FSDP_AXIS, MeshSpec

TOP_KEYS = ("wte", "wpe", "ln_f_scale", "ln_f_bias")


def leaf_shapes(config) -> dict:
    """The JAX tree's leaf shapes for ``config``: ``{top key: shape, ...,
    "block": {key: [L, ...] shape}}``."""
    c, l, h = config.n_embd, config.n_layer, config.n_head
    per_layer = {
        "ln1_scale": (c,), "ln1_bias": (c,), "attn_qkv_w": (c, 3, h, c // h),
        "attn_qkv_b": (3, h, c // h), "attn_proj_w": (c, c), "attn_proj_b": (c,),
        "ln2_scale": (c,), "ln2_bias": (c,), "mlp_fc_w": (c, 4 * c),
        "mlp_fc_b": (4 * c,), "mlp_proj_w": (4 * c, c), "mlp_proj_b": (c,),
    }
    shapes = {"wte": (config.vocab_size, c), "wpe": (config.n_positions, c),
              "ln_f_scale": (c,), "ln_f_bias": (c,)}
    shapes["block"] = {k: (l, *per_layer[k]) for k in BLOCK_KEYS}
    return shapes


def _best_dim(shape: tuple[int, ...], entries: list, is_block: bool, size: int) -> int | None:
    """The largest free dim of ``shape`` that ``size`` divides, trailing
    dims winning ties; never axis 0 of a block leaf."""
    best = None
    for d in range(len(shape) - 1, 0 if is_block else -1, -1):
        if entries[d] is None and shape[d] % size == 0:
            if best is None or shape[d] > shape[best]:
                best = d
    return best


def _spec(entries: list) -> tuple:
    return () if all(e is None for e in entries) else tuple(entries)


def _leaf_pspec(shape: tuple[int, ...], is_block: bool, fsdp_size: int) -> tuple:
    """The param spec of one leaf under 'fsdp'."""
    if len(shape) == 0:
        return ()
    entries: list = [None] * len(shape)
    if fsdp_size > 1:
        d = _best_dim(shape, entries, is_block, fsdp_size)
        if d is not None:
            entries[d] = FSDP_AXIS
    return _spec(entries)


def _leaf_update_pspec(shape: tuple[int, ...], is_block: bool, data_size: int,
                       fsdp_size: int) -> tuple:
    """The update-phase spec of one leaf: its param spec plus 'data' on the
    best free divisible dim; a leaf with none keeps its param spec (its
    moments stay replicated across 'data': the divisibility fallback)."""
    spec = _leaf_pspec(shape, is_block, fsdp_size)
    if data_size <= 1 or len(shape) == 0:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    d = _best_dim(shape, entries, is_block, data_size)
    if d is None:
        return spec
    entries[d] = DATA_AXIS
    return tuple(entries)


def _tree_map(config, fn) -> dict:
    shapes = leaf_shapes(config)
    out = {k: fn(shapes[k], False) for k in TOP_KEYS}
    out["block"] = {k: fn(shapes["block"][k], True) for k in BLOCK_KEYS}
    return out


def param_pspecs(config, spec: MeshSpec) -> dict:
    """The param spec of every leaf of ``config``'s JAX tree under
    ``spec`` (and, by structure, of its AdamW moments)."""
    return _tree_map(config, lambda shape, blk: _leaf_pspec(shape, blk, spec.fsdp))


def update_pspecs(config, spec: MeshSpec) -> dict:
    """The update-phase spec of every leaf under ``--shard_update``."""
    return _tree_map(config, lambda shape, blk: _leaf_update_pspec(
        shape, blk, spec.data, spec.fsdp))


def resolve_shard_update(mode: str, spec: MeshSpec) -> bool:
    """``--shard_update {off,on,auto}`` against the mesh: 'auto' is on
    exactly for data > 1 with fsdp == 1 (fsdp already shards the optimizer
    state); every mode is off at data == 1."""
    if mode not in ("off", "on", "auto"):
        raise ValueError(f"shard_update={mode!r}: expected 'off', 'on' or 'auto'")
    if mode == "off" or spec.data <= 1:
        return False
    if mode == "on":
        return True
    return spec.fsdp == 1


class TensorLayout(NamedTuple):
    """How one port tensor is split: the per-layer view of its JAX leaf and
    the ``(axis, dim of view)`` pairs that split it."""

    leaf: int                               # index of its JAX leaf (param_leaves order)
    view: tuple[int, ...]
    placement: tuple[tuple[str, int], ...]


def tensor_layouts(config, spec: MeshSpec, shard_update: bool) -> list[TensorLayout]:
    """The layout of every tensor of ``train_step.param_list`` (top keys,
    then each block key over the layers) in the optimizer's layout, that
    of the AdamW moments: the update rule with ``shard_update``, else the
    param rule."""
    specs = update_pspecs(config, spec) if shard_update else param_pspecs(config, spec)
    shapes = leaf_shapes(config)

    def layout(leaf: int, shape: tuple[int, ...], pspec: tuple) -> TensorLayout:
        return TensorLayout(leaf, shape, tuple((a, d) for d, a in enumerate(pspec) if a))

    out = [layout(i, shapes[k], specs[k]) for i, k in enumerate(TOP_KEYS)]
    for j, k in enumerate(BLOCK_KEYS):
        # The layer axis is never placed: drop it from the spec and shape.
        one = layout(len(TOP_KEYS) + j, shapes["block"][k][1:], specs["block"][k][1:])
        out += [one] * config.n_layer
    return out


def take_shard(t: torch.Tensor, layout: TensorLayout, mesh) -> torch.Tensor:
    """This process's chunk of the full tensor ``t`` (a contiguous copy, in
    the view's shape)."""
    v = t.reshape(layout.view)
    for axis, d in layout.placement:
        n = v.shape[d] // mesh.shape[axis]
        v = v.narrow(d, mesh.axis_index(axis) * n, n)
    return v.contiguous()

