"""Paged decode attention: one query row per sequence against a block pool.

Counterpart of ``gpt_2_distributed_tpu/ops/paged_attention.py``. Every
in-flight sequence keeps its K/V in fixed-size blocks of ONE preallocated
pool (``[num_blocks, H, block_size, D]`` per layer), addressed through a
per-sequence block table:

    o[b] = softmax(q[b] . K[b]^T / sqrt(D)) . V[b]

where K[b]/V[b] are the first ``lengths[b]`` positions of sequence ``b``,
scattered across pool blocks ``block_table[b, :]``. ``lengths[b] == 0``
marks an idle slot (o = 0).

* :func:`paged_attention_plain` gathers the table's blocks into a
  contiguous ``[B, H, S, D]`` view and runs the masked fp32 softmax the
  contiguous-cache decode path runs (``models/decode.py::decode_step``) —
  the counterpart of ``paged_attention_xla``.
* :func:`paged_attention_kernel` launches ``csrc/paged_decode.cu`` on CUDA
  tensors: each sequence's keys are cut into splits of whole pool blocks
  (:func:`paged_splits`, a function of the sequence's length and the block
  size alone), one block of the kernel a (head, sequence, split), and a
  second kernel merges a sequence's splits in a fixed order. Each K/V row
  is read straight from its pool slot, only the blocks holding data are
  visited, and no gathered copy exists. On CPU tensors it uses the plain
  version. ``paged_attention_kernel.launches`` counts its calls, each of
  which launches both kernels.
* :func:`paged_attention` is the decode step's dispatch.
* :func:`paged_prefill_attention` is chunked prefill's attention: a chunk
  of query rows per sequence, starting mid-sequence, over the partly built
  block table's gathered view. Its plain version mirrors the JAX op (an
  XLA gather there); on CUDA tensors it launches K1's query-offset form
  (``ops/flash_attention.py::flash_attention_fwd_offset``), whose rows
  equal the whole-prompt prefill's bit for bit.
"""

from __future__ import annotations

import ctypes
import math

import torch

from gpt_2_distributed_torch.kernels import build
from gpt_2_distributed_torch.ops.attention import MASK_VALUE
from gpt_2_distributed_torch.ops.flash_attention import (
    flash_attention_fwd_offset,
    flash_attention_offset_plain,
)

KERNEL_HEAD_DIMS = (32, 64, 128)
# Keys a split holds, rounded up to whole pool blocks (:func:`split_blocks`).
SPLIT_KEYS = 256

_SIGNATURES = {
    "paged_decode_bf16": [
        ctypes.c_void_p, ctypes.c_longlong,       # q, q batch stride
        ctypes.c_void_p, ctypes.c_void_p,         # k_pool, v_pool
        ctypes.c_void_p, ctypes.c_void_p,         # block_table, lengths
        ctypes.c_void_p, ctypes.c_void_p,         # o, workspace
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, H, bs
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # D, M, split_blocks
        ctypes.c_void_p,                          # stream
    ],
}


def split_blocks(bs: int) -> int:
    """Pool blocks of ``bs`` positions a split of the kernel holds: the
    fewest that hold ``SPLIT_KEYS`` keys."""
    return -(-SPLIT_KEYS // bs)


def paged_splits(length: int, bs: int) -> list[tuple[int, int]]:
    """The key ranges ``[start, end)`` of a sequence of ``length`` cached
    positions, one per block of the kernel that attends to them: whole pool
    blocks from the first key, the last cut at ``length``; none for an idle
    sequence. A function of ``length`` and ``bs`` alone, so a sequence's
    bits do not depend on the batch it shares, the table width or the
    card."""
    keys = split_blocks(bs) * bs
    return [(s, min(s + keys, length)) for s in range(0, length, keys)]


def _table_view(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The contiguous per-sequence view ``[B, H, M * bs, D]`` of a pool
    ``[N, H, bs, D]`` through a block table ``[B, M]``."""
    b, m = table.shape
    _, h, bs, d = pool.shape
    return pool[table.long()].permute(0, 2, 1, 3, 4).reshape(b, h, m * bs, d)


def paged_attention_plain(
    q: torch.Tensor,            # [B, H, D] compute dtype
    k_pool: torch.Tensor,       # [N, H, bs, D]
    v_pool: torch.Tensor,       # [N, H, bs, D]
    block_table: torch.Tensor,  # [B, M] int pool indices
    lengths: torch.Tensor,      # [B] int attendable positions (0 = idle)
) -> torch.Tensor:
    """Gather-based plain version: fp32 scores, ``MASK_VALUE`` fill (which
    underflows to exactly 0 after the softmax's max-subtract), probs cast
    back to the compute dtype, idle rows zeroed."""
    d = q.shape[2]
    kc, vc = _table_view(k_pool, block_table), _table_view(v_pool, block_table)
    scores = (q.float()[:, :, None] @ kc.float().transpose(-1, -2)) / math.sqrt(d)
    kpos = torch.arange(kc.shape[2], device=q.device)
    lens = lengths.to(q.device).long()[:, None, None, None]
    scores = scores.masked_fill(kpos >= lens, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    # An idle row softmaxes an all-MASK_VALUE row to a uniform
    # distribution; zero it so o is exactly 0.
    probs = probs.masked_fill(lens == 0, 0.0)
    return (probs @ vc)[:, :, 0]


def paged_attention_kernel(
    q: torch.Tensor,            # [B, H, D] bf16, unit stride over (h, d)
    k_pool: torch.Tensor,       # [N, H, bs, D] bf16, contiguous
    v_pool: torch.Tensor,
    block_table: torch.Tensor,  # [B, M] int32, contiguous
    lengths: torch.Tensor,      # [B] int32
) -> torch.Tensor:
    """Paged decode attention through the CUDA kernel (CPU tensors: the
    plain version). Raises on a dtype, layout, shape or device the kernel
    does not take, and on a launch error."""
    if not q.is_cuda:
        return paged_attention_plain(q, k_pool, v_pool, block_table, lengths)
    b, h, d = q.shape
    n, hp, bs, dp = k_pool.shape
    if (hp, dp) != (h, d) or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"paged kernel: pools {tuple(k_pool.shape)} / {tuple(v_pool.shape)} "
            f"do not match q {tuple(q.shape)}"
        )
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"paged kernel: head dim {d} not in {KERNEL_HEAD_DIMS}")
    for name, x in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"paged kernel: {name} must be bfloat16, got {x.dtype}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("paged kernel: pools must be contiguous [N, H, bs, D]")
    if q.stride(2) != 1 or q.stride(1) != d:
        raise ValueError("paged kernel: q must be contiguous over (H, D)")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged kernel: block_table and lengths must be int32")
    if block_table.dim() != 2 or block_table.shape[0] != b or not block_table.is_contiguous():
        raise ValueError(f"paged kernel: block_table must be contiguous [{b}, M]")
    if tuple(lengths.shape) != (b,) or not lengths.is_contiguous():
        raise ValueError(f"paged kernel: lengths must be contiguous [{b}]")
    for name, x in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_table", block_table), ("lengths", lengths)):
        if x.device != q.device:
            raise ValueError(f"paged kernel: {name} on {x.device}, q on {q.device}")
    m = block_table.shape[1]
    o = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    # The splits of the longest sequence the table holds: the grid's depth.
    splits = len(paged_splits(m * bs, bs))
    # Each split's fp32 (m, l, acc[D]) where a sequence has more than one.
    ws = (torch.empty((b, h, splits, d + 2), dtype=torch.float32, device=q.device)
          if splits > 1 else None)
    lib = build.load("paged_decode", _SIGNATURES)
    code = lib.paged_decode_bf16(
        q.data_ptr(), q.stride(0), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), lengths.data_ptr(), o.data_ptr(),
        None if ws is None else ws.data_ptr(), b, h, bs, d, m, split_blocks(bs),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(code, "paged_decode_bf16")
    paged_attention_kernel.launches += 1
    return o


paged_attention_kernel.launches = 0


def paged_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """Dispatch: "auto" = the kernel wrapper (the kernel on CUDA tensors,
    the plain version on CPU tensors); "kernel" = the kernel, refusing CPU
    tensors; "plain" = the plain version on any device."""
    if impl not in ("auto", "kernel", "plain"):
        raise ValueError(
            f"paged_attention impl={impl!r}: expected 'auto', 'kernel' or 'plain'"
        )
    if q.dim() != 3:
        raise ValueError(f"q must be [B, H, D], got shape {tuple(q.shape)}")
    if k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"k_pool/v_pool must be matching [N, H, bs, D], got "
            f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}"
        )
    if impl == "plain":
        return paged_attention_plain(q, k_pool, v_pool, block_table, lengths)
    if impl == "kernel" and not q.is_cuda:
        raise ValueError(
            "paged_attention impl='kernel' needs CUDA tensors: the paged "
            "kernel has no CPU build (use 'auto' or 'plain' on the CPU)"
        )
    return paged_attention_kernel(q, k_pool, v_pool, block_table, lengths)


def paged_prefill_attention(
    q: torch.Tensor,            # [B, T, H, D]
    k_pool: torch.Tensor,       # [N, H, bs, D]
    v_pool: torch.Tensor,
    block_table: torch.Tensor,  # [B, M] int32
    start: torch.Tensor,        # [B] int32 absolute position of q[:, 0]
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """Chunked-prefill attention over a partly built block table
    (``gpt_2_distributed_tpu/ops/paged_attention.py::paged_prefill_attention``).

    Query t of sequence b sits at absolute position ``start[b] + t`` and
    attends causally over the table's contiguous view: every earlier
    position (earlier chunks and prefix-cache hits already in pool blocks)
    and the chunk's own K/V, which the caller scatters before this call.
    Returns ``[B, T, H, D]``.

    The plain version mirrors the JAX op form for form on the gathered
    view (``flash_attention_offset_plain``): fp32 scores with the scale
    applied after the product, ``MASK_VALUE`` past each query's position
    (whatever the pool holds there, stale data included, which the
    softmax's max-subtract turns into exact zeros), fp32 softmax, probs
    cast back to the compute dtype. "auto": CUDA tensors launch K1's
    query-offset form (one launch for all B rows), CPU tensors take the
    plain version; "kernel" refuses CPU tensors; "plain" is the plain
    version on any device. The kernel raises on what it does not take and
    never gives way to the plain version."""
    if impl not in ("auto", "kernel", "plain"):
        raise ValueError(
            f"paged_prefill_attention impl={impl!r}: expected 'auto', 'kernel' or 'plain'"
        )
    if q.dim() != 4:
        raise ValueError(f"q must be [B, T, H, D], got shape {tuple(q.shape)}")
    if k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"k_pool/v_pool must be matching [N, H, bs, D], got "
            f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}"
        )
    if impl == "kernel" and not q.is_cuda:
        raise ValueError(
            "paged_prefill_attention impl='kernel' needs CUDA tensors: the flash "
            "kernel has no CPU build (use 'auto' or 'plain' on the CPU)"
        )
    kc, vc = _table_view(k_pool, block_table), _table_view(v_pool, block_table)
    qh = q.transpose(1, 2)                                   # [B, H, T, D]
    if impl == "plain":
        return flash_attention_offset_plain(qh, kc, vc, start)[0].transpose(1, 2)
    # The kernel writes o straight into the [B, T, H, D] layout.
    o = torch.empty_like(q, memory_format=torch.contiguous_format).transpose(1, 2)
    return flash_attention_fwd_offset(qh, kc, vc, start, o=o)[0].transpose(1, 2)
