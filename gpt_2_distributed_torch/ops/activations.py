"""Activation functions (``gpt_2_distributed_tpu/ops/activations.py``)."""

from __future__ import annotations

import math

import torch


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """Exact-OpenAI tanh-approximation GELU:
    ``0.5 * x * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3)))``, spelled out
    as the JAX package does."""
    c = torch.sqrt(torch.tensor(2.0 / math.pi, dtype=x.dtype, device=x.device))
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * torch.pow(x, 3.0))))
