"""Move GPT-2 weights between the JAX package's parameter tree and the
port's parameter dictionary, bit for bit.

The JAX tree (``gpt_2_distributed_tpu/models/gpt2.py::init_params``)
stacks every per-layer leaf on a leading ``[L, ...]`` axis and stores the
qkv weight head-explicit ``[L, C, 3, H, D]`` (bias ``[L, 3, H, D]``); the
port keeps one dictionary per layer with qkv flattened to ``[C, 3C]``.
Both sides are ``[in, out]``. Stacking, slicing and row-major reshapes
move no bits, so ``params_from_jax(params_to_jax(p))`` is the identity on
fp32 weights.

Here the JAX tree is a nested dict of numpy arrays (``np.asarray`` of each
leaf), so this module needs no JAX. :func:`save_npz` / :func:`load_npz`
keep such a tree in a ``.npz`` file under ``/``-joined keys
(``block/attn_qkv_w``) — the serving CLI's ``--params_npz``.
"""

from __future__ import annotations

import numpy as np
import torch

from gpt_2_distributed_torch.models.gpt2 import BLOCK_KEYS

_TOP_KEYS = ("wte", "wpe", "ln_f_scale", "ln_f_bias")


def params_from_jax(tree: dict) -> dict:
    """Port params (fp32 CPU tensors) from a JAX-layout tree of arrays."""
    blk = tree["block"]
    n_layer = np.asarray(blk["ln1_scale"]).shape[0]
    params = {k: torch.from_numpy(np.array(tree[k], np.float32)) for k in _TOP_KEYS}
    params["blocks"] = []
    for i in range(n_layer):
        bp = {k: torch.from_numpy(np.array(np.asarray(blk[k])[i], np.float32))
              for k in BLOCK_KEYS}
        c = bp["attn_qkv_w"].shape[0]
        bp["attn_qkv_w"] = bp["attn_qkv_w"].reshape(c, 3 * c)
        bp["attn_qkv_b"] = bp["attn_qkv_b"].reshape(3 * c)
        params["blocks"].append(bp)
    return params


def params_to_jax(params: dict, n_head: int) -> dict:
    """JAX-layout tree of numpy arrays from port params. ``n_head`` splits
    the flat qkv columns back into (3, H, D)."""
    tree = {k: params[k].detach().cpu().numpy() for k in _TOP_KEYS}
    block = {}
    for k in BLOCK_KEYS:
        block[k] = np.stack([bp[k].detach().cpu().numpy() for bp in params["blocks"]])
    n_layer, c = block["ln1_scale"].shape
    d = c // n_head
    block["attn_qkv_w"] = block["attn_qkv_w"].reshape(n_layer, c, 3, n_head, d)
    block["attn_qkv_b"] = block["attn_qkv_b"].reshape(n_layer, 3, n_head, d)
    tree["block"] = block
    return tree


def save_npz(path: str, tree: dict) -> None:
    """Write a JAX-layout tree to ``path`` under ``/``-joined keys."""
    flat = {k: tree[k] for k in _TOP_KEYS}
    flat.update({f"block/{k}": v for k, v in tree["block"].items()})
    np.savez(path, **flat)


def load_npz(path: str) -> dict:
    """Port params from a file written by :func:`save_npz`."""
    with np.load(path) as f:
        tree = {k: f[k] for k in _TOP_KEYS}
        tree["block"] = {k: f[f"block/{k}"] for k in BLOCK_KEYS}
    return params_from_jax(tree)
