"""Blocked (logit-free) cross-entropy over the tied lm_head
(``gpt_2_distributed_tpu/ops/losses.py``).

:func:`blocked_cross_entropy` contracts the final hidden states against the
tied embedding in row chunks: each chunk's ``[rows, V]`` logits live only
inside one loop iteration and are reduced at once to the log-sum-exp and
the label logit. The backward recomputes each chunk's logits from the saved
per-row lse and accumulates ``d_wte`` in fp32. In the JAX package this is a
``lax.scan`` under a custom VJP, not a Pallas kernel; here it is a Python
loop under a ``torch.autograd.Function``.

Numerics, as the JAX package's:

* chunk logits are emitted in the INPUT dtype (one rounding for bf16
  inputs: a bf16 x bf16 matmul accumulates in fp32 and rounds its output
  once), then upcast to fp32 for the log-softmax;
* labels equal to ``IGNORE_INDEX`` (-100) are masked out of the token mean
  (and out-of-range labels are clamped for the gather, as JAX's clip-mode
  gather does);
* rows are padded up to a multiple of ``block_rows`` with zeros and ignored
  labels;
* in the backward the logit grads are cast to the input dtype before the
  two products; ``dx`` is rounded to the input dtype once, ``d_wte`` is
  summed over chunks in fp32 (bf16 x bf16 products are exact in fp32, so
  upcasting before the product is JAX's ``preferred_element_type=float32``)
  and rounded to wte's dtype once.
"""

from __future__ import annotations

import torch

from gpt_2_distributed_torch.config import DEFAULT_BLOCK_ROWS

IGNORE_INDEX = -100


def _chunk_logits(x_chunk: torch.Tensor, wte: torch.Tensor) -> torch.Tensor:
    """Transient ``[R, V]`` logits in the input dtype, upcast to fp32."""
    return (x_chunk @ wte.t()).float()


def _chunks(x: torch.Tensor, labels: torch.Tensor, block_rows: int):
    """``(x_chunk, labels_chunk, start)`` over rows padded to a multiple of
    ``block_rows`` (zeros, ignored labels)."""
    n = x.shape[0]
    padded = -(-n // block_rows) * block_rows
    if padded != n:
        x = torch.cat([x, x.new_zeros(padded - n, x.shape[1])])
        labels = torch.cat([labels, labels.new_full((padded - n,), IGNORE_INDEX)])
    for start in range(0, padded, block_rows):
        yield x[start:start + block_rows], labels[start:start + block_rows], start


class _BlockedCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, wte, labels, block_rows):
        n, v = x.shape[0], wte.shape[0]
        lse = torch.empty(n, dtype=torch.float32, device=x.device)
        label_logit = torch.empty(n, dtype=torch.float32, device=x.device)
        for xc, lc, start in _chunks(x, labels, block_rows):
            logits = _chunk_logits(xc, wte)
            rows = min(block_rows, n - start)
            lse[start:start + rows] = torch.logsumexp(logits, dim=-1)[:rows]
            safe = lc.clamp(0, v - 1).long()
            label_logit[start:start + rows] = logits.gather(1, safe[:, None])[:rows, 0]
        valid = labels != IGNORE_INDEX
        count = valid.sum().clamp(min=1)
        loss = torch.where(valid, lse - label_logit, 0.0).sum() / count
        ctx.save_for_backward(x, wte, labels, lse, count)
        ctx.block_rows = block_rows
        return loss

    @staticmethod
    def backward(ctx, g):
        x, wte, labels, lse, count = ctx.saved_tensors
        n, v = x.shape[0], wte.shape[0]
        scale = (g / count).float()
        dx = torch.empty_like(x)
        dwte = torch.zeros(wte.shape, dtype=torch.float32, device=x.device)
        for xc, lc, start in _chunks(x, labels, ctx.block_rows):
            rows = min(ctx.block_rows, n - start)
            logits = _chunk_logits(xc, wte)            # same rounding as forward
            lse_c = torch.zeros(xc.shape[0], dtype=torch.float32, device=x.device)
            lse_c[:rows] = lse[start:start + rows]
            p = torch.exp(logits - lse_c[:, None])
            # p - onehot, without a [R, V] one-hot tensor.
            p[torch.arange(p.shape[0], device=p.device), lc.clamp(0, v - 1).long()] -= 1.0
            valid = lc != IGNORE_INDEX
            grad_logits = torch.where(valid[:, None], p * scale, 0.0).to(x.dtype)
            dx[start:start + rows] = (grad_logits @ wte)[:rows]
            dwte += grad_logits.float().t() @ xc.float()
        return dx, dwte.to(wte.dtype), None, None


def blocked_cross_entropy(x: torch.Tensor, wte: torch.Tensor, labels: torch.Tensor,
                          block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    """Token-mean cross-entropy of ``x @ wte^T`` against ``labels`` without
    materialising the full logits.

    x: ``[N, C]`` final hidden states (compute dtype); wte: ``[V, C]`` tied
    embedding (compute dtype); labels: ``[N]`` int, ``IGNORE_INDEX`` masked
    out. Returns a scalar fp32 loss."""
    return _BlockedCrossEntropy.apply(x, wte, labels, block_rows)
