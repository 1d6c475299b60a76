"""Dense causal attention and the prefill attention dispatch
(``gpt_2_distributed_tpu/ops/attention.py``).

The dense version is the plain PyTorch path for prefill: scores from the
compute-dtype operands accumulated in fp32 (bf16 x bf16 products are exact
in fp32, so upcasting before the product reproduces JAX's
``preferred_element_type=float32``), causal positions filled with the
reference's -1e4, an fp32 softmax, and the probabilities cast back to the
compute dtype before the product with V.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

MASK_VALUE = -1e4


def causal_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """fp32 scaled scores ``[B, H, T, T]`` of ``[B, H, T, D]`` q and k, with
    the positions above the diagonal filled with ``MASK_VALUE``."""
    t, d = q.shape[2], q.shape[3]
    scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(d)
    causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    return scores.masked_fill(~causal, MASK_VALUE)


def causal_attention(
    q: torch.Tensor,  # [B, H, T, D]
    k: torch.Tensor,
    v: torch.Tensor,
) -> torch.Tensor:
    """Dense causal attention. Returns [B, H, T, D] in q's dtype."""
    probs = torch.softmax(causal_scores(q, k), dim=-1).to(q.dtype)
    return probs @ v


def causal_attention_bthd(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Dense causal attention over the model's [B, T, H, D] layout."""
    out = causal_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    )
    return out.transpose(1, 2)


def select_attention_impl(
    impl: str, device: torch.device
) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
    """The prefill attention for ``[B, T, H, D]`` q/k/v on ``device``.

    ``"auto"`` is the flash wrapper, which launches the CUDA kernel on CUDA
    tensors (at every prefill width) and runs the dense plain version on
    CPU tensors; ``"kernel"`` is the same wrapper but refuses the CPU;
    ``"plain"`` is the dense version on any device."""
    from gpt_2_distributed_torch.ops.flash_attention import (
        flash_attention_bthd,
    )

    if impl == "plain":
        return causal_attention_bthd
    if impl == "kernel" and device.type != "cuda":
        raise ValueError(
            "attn_impl='kernel' needs CUDA tensors: the flash kernel has "
            "no CPU build (use 'auto' or 'plain' on the CPU)"
        )
    if impl in ("auto", "kernel"):
        return flash_attention_bthd
    raise ValueError(
        f"unknown attention impl {impl!r}; expected auto|kernel|plain"
    )
