"""The attention dropout stream (``gpt_2_distributed_tpu/ops/spmd.py``).

Only :func:`dropout_hash_bits` is carried over: the mesh helpers of the JAX
module come with the distributed slices of the port.

uint32 arithmetic in torch: the values live in int64 tensors (or Python
ints) holding uint32 values. Every product is kept exact by splitting the
left operand into 16-bit halves (:func:`mul32`), so no int64 product passes
2^48; XOR and right shifts of non-negative int64 values are the uint32
ones. The bits are therefore the JAX package's bit for bit, on the CPU and
on the card, whatever the seed or coordinate.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def mul32(x, c: int):
    """``(x * c) mod 2^32`` for a uint32 value ``x`` (int64 tensor or
    Python int) and a uint32 constant ``c``."""
    if isinstance(x, int):
        return (x * c) & M32
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & M32


def fmix32(x):
    """The murmur3 finalizer on uint32 values."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _u32(x):
    return x & M32


def dropout_hash_bits(seed, b, h, row, col):
    """uint32 random bits from a murmur3-finalizer hash of absolute
    (batch, head, row, col) coordinates mixed with ``seed``.

    The flash kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) and the
    plain attention paths draw their masks from this one stream, so the
    backward regenerates the forward's mask and the kernel path and the
    plain path agree. Each argument is a Python int or an int64 tensor;
    tensors broadcast, and the coordinate products are formed at their own
    (broadcast) shapes before the full-width finalizer. ``seed`` may be a
    negative int32: it is read as its uint32 bits, as ``astype(uint32)``
    reads it in the JAX package. Returns uint32 values in int64."""
    x = (_u32(seed) ^ mul32(_u32(b), 0x9E3779B1) ^ mul32(_u32(h), 0x85EBCA77))
    x = x ^ mul32(_u32(row), 0xC2B2AE3D) ^ mul32(_u32(col), 0x27D4EB2F)
    return fmix32(x)


def causal_dropout_keep(seed: int, rate: float, b: int, h: int, t: int,
                        device: torch.device) -> torch.Tensor:
    """Bool ``[b, h, t, t]`` keep mask of attention dropout at ``rate``:
    ``bits >= uint32(int(rate * 2^32))`` on absolute coordinates, the test
    the flash kernels apply."""
    idx = [torch.arange(n, dtype=torch.int64, device=device) for n in (b, h, t)]
    bits = dropout_hash_bits(seed, idx[0].view(b, 1, 1, 1), idx[1].view(1, h, 1, 1),
                             idx[2].view(1, 1, t, 1), idx[2].view(1, 1, 1, t))
    return bits >= int(rate * (2 ** 32))
