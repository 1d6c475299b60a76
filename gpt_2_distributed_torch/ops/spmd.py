"""The attention dropout stream and the mesh helpers the attention kernels
share (``gpt_2_distributed_tpu/ops/spmd.py``).

:func:`dropout_hash_bits` is the one dropout stream of the flash kernels
(K1/K2) and of the ring's block kernel (K8); :func:`dividing_axes` and
:func:`shard_offset` give a shard's global batch or head origin over the
mesh axes that divide that dim, which the hash takes as absolute
coordinates; :func:`shard_seed` is the JAX wrappers' other scheme, for the
kernels that hash LOCAL coordinates under a data/fsdp mesh (flash attention
and the fused epilogues): the linear shard index mixed into the seed. The
fused-path fallback registry of the JAX module has no counterpart: the port
refuses the fused layers under a sequence-parallel mesh instead of falling
back.

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

# Mesh axis names treated as batch-like (data parallel) / head-like (tensor
# parallel) by the attention kernels, as in the JAX package.
BATCH_AXIS_NAMES = ("data", "fsdp", "dp", "batch", "replica")
HEAD_AXIS_NAMES = ("tp", "model", "tensor")


def dividing_axes(mesh, names: tuple[str, ...], dim: int) -> tuple[str, ...]:
    """Greedy prefix of ``mesh``'s axes from ``names`` whose product divides
    ``dim`` (axes of size 1, or that do not divide, are left out). ``mesh``
    has ``axis_names`` and a ``shape`` mapping, as ``parallel/mesh.py``'s
    mesh and a JAX mesh do."""
    axes: list[str] = []
    prod = 1
    for a in mesh.axis_names:
        if a in names and mesh.shape[a] > 1 and dim % (prod * mesh.shape[a]) == 0:
            axes.append(a)
            prod *= mesh.shape[a]
    return tuple(axes)


def shard_offset(mesh, axes: tuple[str, ...], local_dim: int) -> int:
    """Global element origin of this process's shard along the mesh axes
    ``axes`` (row-major over them), for a local extent ``local_dim``: the
    dropout hash's absolute batch or head coordinate of local index 0."""
    off = 0
    for a in axes:
        off = off * mesh.shape[a] + mesh.axis_index(a)
    return off * local_dim


def batch_axes(mesh, local_batch: int) -> tuple[str, ...]:
    """The batch-like axes of ``mesh`` that split a batch of which this
    process holds ``local_batch`` rows: :func:`dividing_axes` over the
    GLOBAL batch (``local_batch`` times those axes' degrees), the dim the
    JAX wrappers see under their global view."""
    n = 1
    for a in mesh.axis_names:
        if a in BATCH_AXIS_NAMES:
            n *= mesh.shape[a]
    return dividing_axes(mesh, BATCH_AXIS_NAMES, local_batch * n)


def shard_seed(seed: int, mesh, axes: tuple[str, ...], rate: float) -> int:
    """The kernel seed of this process's shard: ``seed ^ (idx *
    0x9E3779B1)`` in uint32, ``idx`` the linear index of this process over
    ``axes`` (row-major), returned as the int32 of those bits — the JAX
    ``_shard_seed`` (``ops/fused_layer.py``) and the flash wrapper's
    mixing, which give every shard of a kernel that hashes local
    coordinates its own stream. At ``rate`` 0, or with no axes, ``seed``
    is returned unchanged."""
    if rate <= 0.0 or not axes:
        return seed
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.axis_index(a)
    bits = (seed & M32) ^ mul32(idx & M32, 0x9E3779B1)
    return bits - (1 << 32) if bits >= 1 << 31 else bits


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


def block_dropout_keep(seed: int, rate: float, shape: tuple[int, int, int, int],
                       origin: tuple[int, int, int, int],
                       device: torch.device) -> torch.Tensor:
    """Bool keep mask ``[b, h, rows, cols]`` of attention dropout at ``rate``
    for a block whose (batch, head, row, col) origin is ``origin``:
    ``bits >= uint32(int(rate * 2^32))`` on absolute coordinates, the test
    the flash kernels apply."""
    coords = []
    for dim, (n, o) in enumerate(zip(shape, origin)):
        view = [1, 1, 1, 1]
        view[dim] = n
        coords.append((o + torch.arange(n, dtype=torch.int64, device=device)).view(view))
    return dropout_hash_bits(seed, *coords) >= int(rate * (2 ** 32))


def causal_dropout_keep(seed: int, rate: float, b: int, h: int, t: int,
                        device: torch.device) -> torch.Tensor:
    """Bool ``[b, h, t, t]`` keep mask of attention dropout at ``rate`` over
    a whole sequence (:func:`block_dropout_keep` at the origin)."""
    return block_dropout_keep(seed, rate, (b, h, t, t), (0, 0, 0, 0), device)
