"""Paged KV-cache plumbing (``gpt_2_distributed_tpu/serving/paged_cache.py``):
the block pool, its allocator, and the in-place writes that move prefill
K/V into pool blocks.

Layout: one preallocated tensor per K and V, ``[L, num_blocks, H,
block_size, D]``. Block 0 is the null block: never allocated, it backs
idle slots and the padded tail of every block table, so the decode step
can index the table unconditionally — the paged kernel never reads past a
sequence's length, and the plain version masks what it gathers.

The JAX package donates the pools to each compiled step and gets new ones
back; here every write updates the pools in place.
"""

from __future__ import annotations

import collections
from typing import Iterable

import torch

from gpt_2_distributed_torch.config import GPT2Config, ServeConfig


class BlockAllocator:
    """Free-list allocator over pool blocks ``1..num_blocks-1`` (0 = null).

    ``alloc`` is all-or-nothing: the caller gets every block it asked for,
    or None with the free list untouched. A double free or a foreign id
    fails loudly. (The JAX package refcounts blocks for its prefix cache;
    the refcounts come with that cache.)"""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks={num_blocks} must be >= 2 (block 0 is reserved)"
            )
        self.num_blocks = num_blocks
        self._free = collections.deque(range(1, num_blocks))
        self._held: set[int] = set()

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """n blocks, or None (free list untouched)."""
        if n < 1:
            raise ValueError(f"alloc({n}): need at least one block")
        if n > len(self._free):
            return None
        ids = [self._free.popleft() for _ in range(n)]
        self._held.update(ids)
        return ids

    def release(self, ids: Iterable[int]) -> None:
        """Return blocks to the free list."""
        for i in ids:
            if i not in self._held:
                raise ValueError(
                    f"release({i}): not an allocated block (double free, the "
                    f"null block, or a foreign id)"
                )
            self._held.remove(i)
            self._free.append(i)


def init_pools(
    config: GPT2Config,
    serve: ServeConfig,
    dtype: torch.dtype,
    device: torch.device,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The preallocated K and V pools, ``[L, N, H, bs, D]`` zeros."""
    shape = (config.n_layer, serve.num_blocks, config.n_head,
             serve.block_size, config.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def pool_bytes(config: GPT2Config, serve: ServeConfig, itemsize: int = 2) -> int:
    """Device bytes the two pools pin."""
    return (2 * config.n_layer * serve.num_blocks * config.n_head
            * serve.block_size * config.head_dim * itemsize)


def scatter_prefill(
    k_pool: torch.Tensor,    # [L, N, H, bs, D], written in place
    v_pool: torch.Tensor,
    k: torch.Tensor,         # [L, H, Ppad, D] prefill K, Ppad = nb * bs
    v: torch.Tensor,
    block_ids: list[int],    # [nb] pool destinations
) -> None:
    """Write one sequence's prefill K/V into its pool blocks, in place."""
    l, h, ppad, d = k.shape
    bs = k_pool.shape[3]
    nb = ppad // bs
    if nb != len(block_ids) or nb * bs != ppad:
        raise ValueError(
            f"scatter_prefill: {ppad} positions do not fill {len(block_ids)} "
            f"blocks of {bs}"
        )
    ids = torch.as_tensor(block_ids, dtype=torch.long, device=k_pool.device)
    k_pool[:, ids] = k.reshape(l, h, nb, bs, d).transpose(1, 2).to(k_pool.dtype)
    v_pool[:, ids] = v.reshape(l, h, nb, bs, d).transpose(1, 2).to(v_pool.dtype)


def copy_block(k_pool: torch.Tensor, v_pool: torch.Tensor,
               src: int, dst: int) -> None:
    """Copy one pool block to another across all layers, in place (the
    prefix cache's copy-on-write, which a later slice ports)."""
    k_pool[:, dst] = k_pool[:, src]
    v_pool[:, dst] = v_pool[:, src]
