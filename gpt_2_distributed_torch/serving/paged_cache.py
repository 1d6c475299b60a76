"""Paged KV-cache plumbing (``gpt_2_distributed_tpu/serving/paged_cache.py``):
the block pool, its refcounted allocator, the prefix cache, and the
in-place writes that move prefill K/V into pool blocks.

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
import dataclasses
from typing import Iterable

import numpy as np
import torch

from gpt_2_distributed_torch.config import GPT2Config, ServeConfig


class BlockAllocator:
    """Refcounted free-list allocator over pool blocks ``1..num_blocks-1``
    (0 = null).

    ``alloc`` is all-or-nothing: the caller gets every block it asked for,
    at refcount 1, or None with the free list untouched. The prefix cache
    pins a block (``retain``) that the request which wrote it still holds;
    ``release`` drops one reference, and a block returns to the free list
    at refcount 0. A double free or a foreign id fails loudly. One shard:
    the JAX package's per-shard free lists come with the serving mesh."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks={num_blocks} must be >= 2 (block 0 is reserved)"
            )
        self.num_blocks = num_blocks
        self._free = collections.deque(range(1, num_blocks))
        self._held: dict[int, int] = {}

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """n blocks at refcount 1, or None (free list untouched)."""
        if n < 1:
            raise ValueError(f"alloc({n}): need at least one block")
        if n > len(self._free):
            return None
        ids = [self._free.popleft() for _ in range(n)]
        for i in ids:
            self._held[i] = 1
        return ids

    def retain(self, i: int) -> None:
        """Add a reference to an allocated block (the prefix cache and each
        request using the block hold one each)."""
        if i not in self._held:
            raise ValueError(f"retain({i}): not an allocated block")
        self._held[i] += 1

    def refcount(self, i: int) -> int:
        """Current reference count (0 = free or never allocated)."""
        return self._held.get(i, 0)

    def release(self, ids: Iterable[int]) -> None:
        """Drop one reference per id; blocks reaching refcount 0 return to
        the free list."""
        for i in ids:
            if i not in self._held:
                raise ValueError(
                    f"release({i}): not an allocated block (double free, the "
                    f"null block, or a foreign id)"
                )
            self._held[i] -= 1
            if self._held[i] == 0:
                del self._held[i]
                self._free.append(i)


class PrefixCache:
    """Hash-cons of full KV blocks by token prefix, LRU
    (``gpt_2_distributed_tpu/serving/paged_cache.py::PrefixCache``).

    Block ``j`` of a prompt is cached under the exact int32 bytes of
    ``tokens[:(j + 1) * block_size]``: K/V at position i depends on every
    token ``<= i``, so two requests may share a block only when their whole
    prefix up to its end matches. The cache holds one allocator reference
    per entry (``retain`` at insert). A lookup returns the longest run of
    leading full-block hits (a miss at block j ends it: block j + 1's K/V
    attended into the missed span). Eviction takes the least recently used
    entry whose block no live request holds (refcount 1).

    ``plen`` (the prompt length of the request the tokens belong to; None:
    all of them) keys a block that ends past it by its tokens AND ``plen``:
    such a block holds positions the decode step wrote, whose bits on the
    card are the decode step's, not the prefill's, so only a request with
    the same prompt (its own resume) may reuse it
    (``engine.ServingEngine._register_prefix``). Blocks wholly inside a
    prompt are keyed by their tokens alone, as in the JAX package."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        self._entries: collections.OrderedDict[bytes | tuple[bytes, int], int] = (
            collections.OrderedDict())
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def _key(tokens, end: int, plen: int | None) -> bytes | tuple[bytes, int]:
        raw = np.asarray(tokens[:end], np.int32).tobytes()
        return raw if plen is None or end <= plen else (raw, plen)

    def peek_run(self, tokens, plen: int | None = None) -> int:
        """Length in blocks of the leading full-block hit run, without
        touching the LRU order or the hit and miss counters (a probe is not
        a use)."""
        run = 0
        for j in range(len(tokens) // self.block_size):
            if self._key(tokens, (j + 1) * self.block_size, plen) not in self._entries:
                break
            run += 1
        return run

    def lookup(self, tokens, plen: int | None = None) -> list[int]:
        """The cached block ids of the leading full-block hit run (the
        caller ``retain``s each before use); hit entries move to MRU."""
        run: list[int] = []
        for j in range(len(tokens) // self.block_size):
            key = self._key(tokens, (j + 1) * self.block_size, plen)
            bid = self._entries.get(key)
            if bid is None:
                self.misses += 1
                break
            self._entries.move_to_end(key)
            self.hits += 1
            run.append(bid)
        return run

    def insert(self, tokens, j: int, block_id: int, allocator: BlockAllocator,
               plen: int | None = None) -> bool:
        """Register ``block_id`` as block ``j`` of ``tokens``. The first
        writer wins: a prefix already cached is left as it is (False)."""
        key = self._key(tokens, (j + 1) * self.block_size, plen)
        if key in self._entries:
            return False
        allocator.retain(block_id)
        self._entries[key] = block_id
        return True

    def evict_one(self, allocator: BlockAllocator) -> bool:
        """Drop the LRU entry that only the cache holds (refcount 1) and
        release its block; False when every entry is pinned by a request."""
        for key, bid in self._entries.items():
            if allocator.refcount(bid) == 1:
                del self._entries[key]
                allocator.release([bid])
                self.evictions += 1
                return True
        return False

    def clear(self, allocator: BlockAllocator) -> None:
        """Drop every unpinned entry."""
        while self.evict_one(allocator):
            pass


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


def draft_serve_view(
    serve: ServeConfig,
    n_positions: int,
    block_size: int | None = None,
) -> ServeConfig:
    """The ServeConfig of the draft model's KV pool under speculation.

    Same slots as the target (the draft's table rows pair 1:1 with the
    target's), an independent block size, and a block count that holds a
    full-context draft sequence in every slot: ``max_batch *
    max_blocks_per_seq + 1`` (the null block). Draft KV is disposable,
    rebuilt after preemption and migration, so full per-slot capacity
    gives the engine a draft allocator that never fails mid-round. ``spec``
    is cleared (the draft never speculates) and so is ``prefix_cache``.
    The engine keeps the target's block size; ``block_size`` is the JAX
    function's parameter, kept so the two views can be compared whole."""
    bs = serve.block_size if block_size is None else block_size
    m = -(-n_positions // bs)
    return dataclasses.replace(serve, spec="", block_size=bs,
                               num_blocks=serve.max_batch * m + 1, prefix_cache=False)


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
    """Copy one pool block to another across all layers, in place: the
    prefix cache's copy-on-write of a block-aligned, fully cached prompt's
    last block, which the request recomputes and writes back."""
    k_pool[:, dst] = k_pool[:, src]
    v_pool[:, dst] = v_pool[:, src]
