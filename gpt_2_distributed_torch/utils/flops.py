"""Model-FLOPs accounting and MFU (``gpt_2_distributed_tpu/utils/flops.py``).

Training FLOPs per token, fwd + bwd, for one model replica:

    flops/token = 6 * N_matmul + 12 * L * C * T

where ``N_matmul`` counts the parameters that take part in matmuls (every
block weight plus the tied head's ``[C, V]`` projection; embedding lookups
are gathers) and the second term is the attention score and value products.

The peak is NVIDIA's dense bf16 tensor-core rate of the card, looked up by
``torch.cuda.get_device_name()``; a card not in the table has no peak, and
then no MFU is reported.
"""

from __future__ import annotations

import torch

from gpt_2_distributed_torch.config import GPT2Config


def flops_per_token(config: GPT2Config, seq_len: int) -> float:
    """Training FLOPs per token (fwd + bwd) for one model replica."""
    c, l, v = config.n_embd, config.n_layer, config.vocab_size
    # qkv (3C^2) + attention out-projection (C^2) + MLP (8C^2) per block,
    # plus the tied lm_head's C -> V projection.
    matmul_params = l * 12 * c * c + c * v
    return 6.0 * matmul_params + 12.0 * l * c * seq_len


# Dense bf16 FLOP/s of one card (NVIDIA's data sheet, SXM part, without
# sparsity), keyed by a prefix of torch.cuda.get_device_name().
_GPU_PEAK_FLOPS: dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def device_peak_flops(device: torch.device | None = None) -> float | None:
    """Peak dense bf16 FLOP/s of the card, or None when it is not a CUDA
    device or not in the table."""
    if device is None or device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for prefix, flops in _GPU_PEAK_FLOPS.items():
        if name.startswith(prefix):
            return flops
    return None


def mfu(
    tokens_per_sec_per_chip: float,
    config: GPT2Config,
    seq_len: int,
    peak_flops: float | None,
) -> float | None:
    """Model FLOPs utilization in [0, 1], or None when the peak is unknown."""
    if peak_flops is None or peak_flops <= 0:
        return None
    return tokens_per_sec_per_chip * flops_per_token(config, seq_len) / peak_flops
