"""K3's split of a sequence's keys (``gpt_2_distributed_torch/csrc/
paged_decode.cu``) and its split-and-combine arithmetic, on the CPU.

The kernel gives each (head, sequence, split) one block; a split is
``split_blocks(bs)`` whole pool blocks (:func:`paged_splits`), so where a
sequence's keys are cut depends on its length and the block size alone,
never on the batch, the table width or the card: a stream's bits are the
same in a batch of 8 as alone. Inside a split each of 4 warps takes every
fourth tile of 32 keys (a lane a key) with one max and one rescale a tile;
the warps merge in order, and a sequence of two or more splits merges their
partial (m, l, acc) in split order. :func:`emulate_k3` spells that in fp32
torch; it is held to ``paged_attention_plain`` and to the JAX
``paged_attention_pallas`` in interpret mode within 1e-5 (fp32 sums in
another order), at the tiny shapes of ``tests/test_torch_ops.py`` with the
splits cut small, and at a table of 80 blocks that needs two splits of
eight tiles (two a warp) at the kernel's own split.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_2_distributed_tpu.ops import paged_attention as jax_paged
from gpt_2_distributed_torch.ops import paged_attention as paged

TILE, WARPS = 32, 4
LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lengths(bs: int) -> list[int]:
    keys = paged.split_blocks(bs) * bs
    return sorted({0, 1, max(bs - 1, 1), bs, bs + 1, keys, keys + 1, 1024})


@pytest.mark.parametrize("bs", [1, 4, 16, 100, 300])
def test_splits_cover_each_key_once_in_whole_pool_blocks(bs):
    """Every key of [0, len) in exactly one split; each split starts at a
    pool block and all but the last hold split_blocks(bs) whole blocks; the
    count is the kernel's ceil(ceil(len / bs) / split_blocks(bs)); no split
    for len 0."""
    sb = paged.split_blocks(bs)
    assert sb * bs >= paged.SPLIT_KEYS > (sb - 1) * bs
    for length in _lengths(bs):
        splits = paged.paged_splits(length, bs)
        keys = [k for s, e in splits for k in range(s, e)]
        assert keys == list(range(length))
        assert all(s % bs == 0 and s < e for s, e in splits)
        assert all(e - s == sb * bs for s, e in splits[:-1])
        assert len(splits) == -(-(-(-length // bs)) // sb)


def _merge(states):
    """fp32 (m, l, acc) states [H], [H], [H, D], merged in order; a state
    with l = 0 (no key) is skipped."""
    live = [st for st in states if bool((st[1] > 0).all())]
    if not live:
        return None
    mt = torch.stack([m for m, _, _ in live]).amax(0)
    lt = sum(l * torch.exp2(m - mt) for m, l, _ in live)
    at = sum(a * torch.exp2(m - mt)[:, None] for m, _, a in live)
    return mt, lt, at


def emulate_k3(q, kp, vp, table, lengths) -> torch.Tensor:
    """K3's split-and-combine in fp32: o [B, H, D]."""
    b, h, d = q.shape
    bs = kp.shape[2]
    qs = q.float() * (LOG2E / math.sqrt(d))
    out = torch.zeros(b, h, d)
    for i, length in enumerate(lengths.tolist()):
        parts = []
        for s0, s1 in paged.paged_splits(length, bs):
            keys = torch.arange(s0, s1)
            blocks = table[i, keys // bs].long()
            k = kp[blocks, :, keys % bs].float()          # [n, H, D]
            v = vp[blocks, :, keys % bs].float()
            s = torch.einsum("hd,nhd->hn", qs[i], k)
            warps = []
            for w in range(WARPS):
                m, l, acc = torch.full((h,), -math.inf), torch.zeros(h), torch.zeros(h, d)
                for t0 in range(w * TILE, s1 - s0, WARPS * TILE):
                    st = s[:, t0:t0 + TILE]
                    m_new = torch.maximum(m, st.amax(-1))
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(st - m_new[:, None])
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + torch.einsum("hn,nhd->hd", p, v[t0:t0 + TILE])
                    m = m_new
                warps.append((m, l, acc))
            parts.append(_merge(warps))
        if parts:
            _, lt, at = _merge(parts) if len(parts) > 1 else parts[0]
            out[i] = at / lt[:, None]
    return out


def _case(rng, b, h, d, bs, m, n_blocks, lengths):
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kp = rng.normal(size=(n_blocks, h, bs, d)).astype(np.float32)
    vp = rng.normal(size=(n_blocks, h, bs, d)).astype(np.float32)
    table = rng.permutation(np.arange(1, n_blocks))[: b * m].reshape(b, m).astype(np.int32)
    return q, kp, vp, table, np.array(lengths, np.int32)


CASES = {
    # tests/test_torch_ops.py's tiny paged shapes, an idle row included.
    "tiny": dict(b=4, h=2, d=8, bs=4, m=4, n_blocks=32, lengths=[1, 16, 0, 7]),
    # Two splits of 256 keys, each eight tiles, two a warp; idle, one key,
    # a split's edge on both sides, and the full table.
    "two splits": dict(b=5, h=2, d=8, bs=4, m=80, n_blocks=420,
                       lengths=[0, 1, 256, 257, 320]),
}


@pytest.mark.parametrize("split_keys", [8, paged.SPLIT_KEYS])
@pytest.mark.parametrize("case", list(CASES))
def test_split_and_combine_matches_plain_and_jax(case, split_keys, monkeypatch):
    """The emulation against paged_attention_plain and the JAX Pallas kernel
    (interpret mode) within 1e-5; idle rows exact zeros. With 8-key splits
    every sequence longer than two blocks of the tiny shape has two or more
    splits."""
    monkeypatch.setattr(paged, "SPLIT_KEYS", split_keys)
    arrays = _case(np.random.default_rng(len(case) + split_keys), **CASES[case])
    got = emulate_k3(*map(torch.from_numpy, arrays)).numpy()
    plain = paged.paged_attention_plain(*map(torch.from_numpy, arrays)).numpy()
    want = np.asarray(jax_paged.paged_attention_pallas(*map(jnp.asarray, arrays),
                                                       interpret=True))
    np.testing.assert_allclose(got, plain, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    idle = arrays[-1] == 0
    assert (got[idle] == 0).all() and np.abs(got[~idle]).max() > 0
    counts = [len(paged.paged_splits(int(n), CASES[case]["bs"])) for n in arrays[-1]]
    assert max(counts) >= 2 or case == "tiny" and split_keys == paged.SPLIT_KEYS
