"""Dense causal attention and the attention dispatch
(``gpt_2_distributed_tpu/ops/attention.py``).

The dense version is the plain PyTorch path for prefill and training:
scores from the compute-dtype operands accumulated in fp32 (bf16 x bf16
products are exact in fp32, so upcasting before the product reproduces
JAX's ``preferred_element_type=float32``), causal positions filled with the
reference's -1e4, an fp32 softmax, dropout on the probabilities, and the
probabilities cast back to the compute dtype before the product with V.

Dropout here draws its mask from the flash kernels' stream
(``ops/spmd.py::dropout_hash_bits`` with an int32 seed) instead of the JAX
dense path's ``jax.random.bernoulli``: the JAX package declares mask streams
implementation-specific, and one stream lets the plain path stand in for
the kernel path with the same masks.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from gpt_2_distributed_torch.ops.spmd import causal_dropout_keep

MASK_VALUE = -1e4


def causal_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """fp32 scaled scores ``[B, H, T, T]`` of ``[B, H, T, D]`` q and k, with
    the positions above the diagonal filled with ``MASK_VALUE``."""
    t, d = q.shape[2], q.shape[3]
    scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(d)
    causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    return scores.masked_fill(~causal, MASK_VALUE)


def dropout_probs(probs: torch.Tensor, dropout_rate: float,
                  seed: int | None) -> torch.Tensor:
    """Attention dropout on probabilities ``[B, H, T, T]``: keep
    ``dropout_hash_bits(seed, b, h, row, col) >= uint32(rate * 2^32)`` and
    divide the kept ones by the keep probability, as the flash kernels do."""
    if dropout_rate <= 0.0:
        return probs
    if seed is None:
        raise ValueError("attention dropout requires a seed")
    b, h, t, _ = probs.shape
    keep = causal_dropout_keep(seed, dropout_rate, b, h, t, probs.device)
    return torch.where(keep, probs / (1.0 - dropout_rate), 0.0)


def causal_attention(
    q: torch.Tensor,  # [B, H, T, D]
    k: torch.Tensor,
    v: torch.Tensor,
    dropout_rate: float = 0.0,
    seed: int | None = None,
) -> torch.Tensor:
    """Dense causal attention with dropout on the probabilities
    (:func:`dropout_probs`). Returns [B, H, T, D] in q's dtype."""
    probs = dropout_probs(torch.softmax(causal_scores(q, k), dim=-1), dropout_rate, seed)
    return probs.to(q.dtype) @ v


def causal_attention_bthd(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, dropout_rate: float = 0.0,
                          seed: int | None = None) -> torch.Tensor:
    """Dense causal attention over the model's [B, T, H, D] layout."""
    out = causal_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        dropout_rate, seed,
    )
    return out.transpose(1, 2)


def select_attention_impl(impl: str, device: torch.device) -> Callable[..., torch.Tensor]:
    """The attention for ``[B, T, H, D]`` q/k/v on ``device``; the callable
    takes ``(q, k, v, dropout_rate=0.0, seed=None)``.

    Serving names (``ServeConfig.attn_impl``): ``"auto"`` is the flash
    wrapper, which launches the CUDA kernels on CUDA tensors (at every
    width) and runs their plain versions on CPU tensors; ``"kernel"`` is
    the same wrapper but refuses the CPU; ``"plain"`` is the dense version
    on any device. Training names (``GPT2Config.attention_impl``):
    ``"flash"`` is the flash wrapper, ``"dense"`` the dense version.

    Under an active mesh whose 'sp' axis is > 1 (``parallel/mesh.py``),
    ``"ring"`` and ``"auto"`` give ring attention over it
    (``ops/ring_attention.py``: q/k/v are this process's ``T/sp`` blocks);
    the others are refused, since the JAX package all-gathers the sequence
    for them and the port has no such path yet. With no mesh or sp = 1,
    ``"ring"`` is the ``"auto"`` policy (a one-rank ring is local
    attention), as in the JAX package."""
    import functools

    from gpt_2_distributed_torch.ops.flash_attention import (
        flash_attention_bthd,
    )
    from gpt_2_distributed_torch.parallel.mesh import sp_mesh

    known = ("auto", "kernel", "plain", "flash", "dense", "ring")
    if impl not in known:
        raise ValueError(
            f"unknown attention impl {impl!r}; expected {'|'.join(known)}"
        )
    mesh = sp_mesh()
    if mesh is not None:
        if impl in ("ring", "auto"):
            from gpt_2_distributed_torch.ops.ring_attention import ring_attention_bthd

            return functools.partial(ring_attention_bthd, mesh=mesh)
        raise ValueError(
            f"attention impl {impl!r} under a mesh with sp={mesh.sp} is not "
            f"ported to PyTorch yet (the JAX package all-gathers the "
            f"sequence for it): it comes in a later slice of the port; use "
            f"'ring' or 'auto'"
        )
    if impl in ("plain", "dense"):
        return causal_attention_bthd
    if impl == "kernel" and device.type != "cuda":
        raise ValueError(
            "attn_impl='kernel' needs CUDA tensors: the flash kernel has "
            "no CPU build (use 'auto' or 'plain' on the CPU)"
        )
    return flash_attention_bthd
