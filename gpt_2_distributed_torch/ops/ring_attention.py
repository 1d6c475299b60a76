"""Ring attention: causal attention with the sequence sharded over the
mesh's 'sp' axis (``gpt_2_distributed_tpu/ops/ring_attention.py``, its
flash-block schedule ``_ring_local_flash``).

Each of the ``sp`` processes holds one contiguous block of Q, K and V,
``[B, T/sp, H, D]`` each; Q never moves. Step 0 attends the process's own
(diagonal) block; then ``sp - 1`` steps each first rotate K/V one hop
along the ring (process ``idx`` receives what ``idx - 1`` held, so at
step r it holds the block of ``(idx - r) % sp``) and attend it. Every
step is one launch of K8, the rectangular block kernel at global offsets
(``ops/flash_block.py``): row origin ``idx * T/sp``, column origin
``src * T/sp``, so causality and the dropout hash work on GLOBAL
coordinates. A block wholly in the queries' future (``src > idx``) still
runs — it returns o = 0 and lse = NEG_INF, whose combine weight is 0 — so
every process runs the same graph and the same sends in the same order.

The steps recombine at block granularity from each launch's (o, lse):
``m, l, acc`` in fp32 with weights ``exp2(lse - m)``, one cast at the end.
Gradients flow by plain autograd through the combine, K8's ``(do, dlse)``
backward and the exchange's backward, as in the JAX package.

The exchange is a seam ``shift(k, v) -> (k, v)``: across processes it is
``parallel/mesh.py``'s batched send/receive (:meth:`Mesh.shift`);
:func:`ring_attention_all_ranks` runs every rank's schedule in one process
with a seam that hands rank ``idx`` the block of ``(idx - r) % sp``, which
is how one card holds the ring against the whole-sequence kernels. It is a
harness for tests and the smoke run, not a training mode.

The JAX package falls back to an XLA einsum ring when ``T/sp`` fits no
128-multiple kernel tile; K8 takes any block length, so the port has one
path.
"""

from __future__ import annotations

import torch

from gpt_2_distributed_torch.ops.flash_block import flash_block
from gpt_2_distributed_torch.ops.spmd import (
    BATCH_AXIS_NAMES,
    HEAD_AXIS_NAMES,
    dividing_axes,
    shard_offset,
)


def _ring_local(q, k, v, *, sp: int, idx: int, shift, b_off: int, h_off: int,
                dropout_rate: float, seed: int | None) -> torch.Tensor:
    """One rank's ring schedule on its ``[B, Tl, H, D]`` blocks."""
    tl = q.shape[1]
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))

    def block(k_blk, v_blk, src):
        return flash_block(qh, k_blk, v_blk, idx * tl, src * tl, seed=seed,
                           b_off=b_off, h_off=h_off, dropout_rate=dropout_rate)

    # Own (diagonal) block first: every row's diagonal is attended, so its
    # lse is finite and the combine never divides by zero.
    o0, m = block(kh, vh, idx)
    acc = o0.float()
    l = torch.ones_like(m)
    for r in range(1, sp):
        kh, vh = shift(kh, vh)
        o_r, lse_r = block(kh, vh, (idx - r) % sp)
        m_new = torch.maximum(m, lse_r)
        w_old = torch.exp2(m - m_new)
        w_new = torch.exp2(lse_r - m_new)
        l = l * w_old + w_new
        acc = acc * w_old[..., None] + o_r.float() * w_new[..., None]
        m = m_new
    return (acc / l[..., None]).to(q.dtype).transpose(1, 2)


def ring_attention_bthd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        mesh, dropout_rate: float = 0.0,
                        seed: int | None = None) -> torch.Tensor:
    """Causal ring attention of this process's ``[B, T/sp, H, D]`` blocks
    over ``mesh``'s 'sp' axis (``parallel/mesh.py``); returns this rank's
    ``[B, T/sp, H, D]`` output. ``seed`` is the int attention-dropout seed,
    the same on every rank."""
    b, _, h, _ = q.shape
    b_off = shard_offset(mesh, dividing_axes(mesh, BATCH_AXIS_NAMES, b), b)
    h_off = shard_offset(mesh, dividing_axes(mesh, HEAD_AXIS_NAMES, h), h)
    return _ring_local(q, k, v, sp=mesh.sp, idx=mesh.sp_index, shift=mesh.shift,
                       b_off=b_off, h_off=h_off, dropout_rate=dropout_rate, seed=seed)


def ring_attention_all_ranks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             sp: int, dropout_rate: float = 0.0,
                             seed: int | None = None) -> torch.Tensor:
    """The ring schedule of all ``sp`` ranks in one process, over the whole
    ``[B, T, H, D]`` sequence; returns the ``[B, T, H, D]`` output. Rank
    ``idx`` attends its own block and then, at step r, the block of rank
    ``(idx - r) % sp`` as the exchange would hand it; gradients reach every
    block by autograd."""
    t = q.shape[1]
    if t % sp != 0:
        raise ValueError(
            f"ring attention needs seq_len divisible by the 'sp' axis: T={t}, sp={sp}"
        )
    tl = t // sp

    def blocks(x):
        return [x[:, i * tl:(i + 1) * tl] for i in range(sp)]

    qs, ks, vs = blocks(q), blocks(k), blocks(v)
    outs = []
    for idx in range(sp):
        step = iter(range(1, sp))

        def shift(_k, _v, idx=idx, step=step):
            src = (idx - next(step)) % sp
            return ks[src].transpose(1, 2), vs[src].transpose(1, 2)

        outs.append(_ring_local(qs[idx], ks[idx], vs[idx], sp=sp, idx=idx, shift=shift,
                                b_off=0, h_off=0, dropout_rate=dropout_rate, seed=seed))
    return torch.cat(outs, dim=1)
