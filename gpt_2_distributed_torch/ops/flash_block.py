"""Rectangular causal block attention at global offsets, the per-step
kernel of ring attention: the CUDA kernel ``csrc/flash_block.cu`` (K8),
its plain PyTorch version, and the autograd function over them.

Counterpart of ``gpt_2_distributed_tpu/ops/flash_block.py`` (its Pallas
forward and backward kernels and their custom VJP).
``flash_block(q, k, v, row_off, col_off) -> (o, lse)`` attends a query
block ``[B, H, Tq, D]`` whose rows sit at global positions
``row_off + r`` to one key/value block ``[B, H, Tc, D]`` at ``col_off +
c``: (r, c) attends iff ``col_off + c <= row_off + r``. It returns ``o``
normalised over this block only and the base-2 log-sum-exp ``lse``
``[B, H, Tq]`` fp32 of each row's undropped scaled scores — what a
block-level combine needs::

    o_total = sum_r exp2(lse_r - m) o_r / sum_r exp2(lse_r - m)

A row with no attended column gives exactly ``o = 0`` and ``lse =
NEG_INF``. Scores are ``bf16(q * log2(e) / sqrt(D)) . k`` (q scaled in fp32
and rounded to its dtype before the product, as the TPU kernel does).
Dropout keeps ``dropout_hash_bits(seed, b_off + b, h_off + h, row_off + r,
col_off + c) >= uint32(int(rate * 2^32))`` (``ops/spmd.py``) and divides
the kept probabilities by ``1 - rate``; ``l`` sums the undropped ones.

The pair (o, lse) is differentiable with BOTH cotangents: the backward
runs the kernel on ``delta = rowsum(do * o) - dlse * log2(e)`` (the base-2
lse cotangent in natural units folded into the flash delta), rebuilding
``p = exp2(s - lse)`` where (r, c) attends and exactly 0 elsewhere.

K8 multiplies on the tensor cores and, as the TPU kernel does, rounds the
left operand of some products to bf16: the dropped probabilities before
``P·V`` (forward), ``ds`` and ``pd`` before theirs (backward); the plain
versions keep them in fp32. :func:`flash_block_error_terms` gives the sums
of those products' absolute terms that scale the element bound the kernel
is held to, ``flash_attention.flash_tolerance``.

CUDA tensors launch K8 (bf16, D in 32/64/128, any Tq, Tc and offsets) or
raise; CPU tensors run the plain version. The kernels copy their tiles 16
bytes at a time, so the wrappers copy an input whose rows are off 16-byte
boundaries (the ring's ``transpose(1, 2)`` views are on them).
``flash_block_fwd.launches`` and ``flash_block_bwd.launches`` count kernel
launches, never plain calls.
"""

from __future__ import annotations

import ctypes
import math

import torch

from gpt_2_distributed_torch.kernels import build
from gpt_2_distributed_torch.ops.flash_attention import (
    KERNEL_HEAD_DIMS,
    LOG2E,
    _aligned_input,
    _dropout_words,
)
from gpt_2_distributed_torch.ops.spmd import block_dropout_keep

NEG_INF = -1e30  # the TPU kernel's masked fill and fully masked rows' lse

_INTS = [ctypes.c_int] * 4
_DROPOUT_ARGS = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float]  # seed, threshold, keep
_SIGNATURES = {
    "flash_block_fwd_bf16": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k, v
        ctypes.c_void_p, ctypes.c_void_p,                    # o, lse
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H Tq Tc D
        ctypes.c_void_p,                                     # int64 strides[12]
        *_INTS,                                              # row, col, b, h offsets
        *_DROPOUT_ARGS,
        ctypes.c_void_p,                                     # stream
    ],
    "flash_block_bwd_bf16": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k, v
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # do, lse, delta
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # dq, dk, dv
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H Tq Tc D
        ctypes.c_void_p,                                     # int64 strides[21]
        *_INTS,
        *_DROPOUT_ARGS,
        ctypes.c_void_p,                                     # stream
    ],
}


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """fp32 base-2 scores ``bf16(q * log2(e)/sqrt(D)) . k`` (the rounding
    to q's dtype is a no-op for fp32 q) and the scaled q itself."""
    qs = (q.float() * (LOG2E / math.sqrt(q.shape[-1]))).to(q.dtype).float()
    return qs @ k.float().transpose(-1, -2), qs


def _attends(tq: int, tc: int, row_off: int, col_off: int,
             device: torch.device) -> torch.Tensor:
    rows = row_off + torch.arange(tq, device=device)[:, None]
    cols = col_off + torch.arange(tc, device=device)[None, :]
    return cols <= rows


def _keep(seed, rate, q, tc, b_off, h_off, row_off, col_off):
    if seed is None:
        raise ValueError("flash_block dropout requires a seed")
    b, h, tq, _ = q.shape
    return block_dropout_keep(seed, rate, (b, h, tq, tc), (b_off, h_off, row_off, col_off),
                              q.device)


def flash_block_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, row_off: int, col_off: int, *,
    seed: int | None = None, b_off: int = 0, h_off: int = 0, dropout_rate: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K8's forward in plain PyTorch, in fp32 whatever the input dtype (q's
    scaled value rounded to q's dtype, as the kernel rounds it); returns
    fp32 ``(o [B, H, Tq, D], lse [B, H, Tq])`` — the reference the kernel
    is held against. Any device."""
    m, p, l = _probs(q, k, row_off, col_off, seed, b_off, h_off, dropout_rate)
    has = l > 0.0
    o = torch.where(has, (p @ v.float()) / l.clamp(min=1e-37), 0.0)
    lse = torch.where(has, m + torch.log2(l.clamp(min=1e-37)), NEG_INF)
    return o, lse[..., 0]


def _probs(q, k, row_off, col_off, seed, b_off, h_off, dropout_rate):
    """fp32 ``(m, p, l)`` of K8's forward: each row's max m of the base-2
    scores where (r, c) attends (NEG_INF where none does), the dropped and
    rescaled ``p = exp2(s - m)`` (exactly 0 where (r, c) does not attend)
    and each row's sum l of the undropped p."""
    s, _ = _scores(q, k)
    tc = k.shape[2]
    mask = _attends(q.shape[2], tc, row_off, col_off, q.device)
    m = torch.where(mask, s, NEG_INF).amax(dim=-1, keepdim=True)
    # Rows with no attended column have m == NEG_INF: exp2(s - m) there
    # would not be 0, so masked entries are forced to 0.
    p = torch.where(mask, torch.exp2(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if dropout_rate > 0.0:
        keep = _keep(seed, dropout_rate, q, tc, b_off, h_off, row_off, col_off)
        p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    return m, p, l


def _bwd_parts(q, k, v, do, lse, delta, row_off, col_off, seed, b_off, h_off,
               dropout_rate):
    """fp32 ``(qs, ds, pd)`` of K8's backward: the scaled q, ``ds = p (dp -
    delta)`` and the dropped probability ``pd``."""
    tq, tc = q.shape[2], k.shape[2]
    s, qs = _scores(q, k)
    mask = _attends(tq, tc, row_off, col_off, q.device)
    # The explicit select keeps a NEG_INF row at 0, never exp2(0) = 1.
    p = torch.where(mask, torch.exp2(s - lse[..., None]), 0.0)
    dpd = do.float() @ v.float().transpose(-1, -2)
    if dropout_rate > 0.0:
        keep = _keep(seed, dropout_rate, q, tc, b_off, h_off, row_off, col_off)
        kp = 1.0 - dropout_rate
        pd = torch.where(keep, p / kp, 0.0)
        dp = torch.where(keep, dpd / kp, 0.0)
    else:
        pd, dp = p, dpd
    return qs, p * (dp - delta[..., None]), pd


def flash_block_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, row_off: int, col_off: int, *,
    seed: int | None = None, b_off: int = 0, h_off: int = 0, dropout_rate: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8's backward in plain PyTorch, in fp32 (module docstring);
    ``delta`` is the effective ``rowsum(do * o) - dlse * log2(e)``. Returns
    fp32 ``(dq, dk, dv)``."""
    qs, ds, pd = _bwd_parts(q, k, v, do, lse, delta, row_off, col_off, seed, b_off, h_off,
                            dropout_rate)
    dq = (ds @ k.float()) / math.sqrt(q.shape[-1])
    dk = (ds.transpose(-1, -2) @ qs) * (1.0 / LOG2E)
    dv = pd.transpose(-1, -2) @ do.float()
    return dq, dk, dv


def flash_block_error_terms(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, row_off: int, col_off: int, *,
    do: torch.Tensor | None = None, lse: torch.Tensor | None = None,
    delta: torch.Tensor | None = None, seed: int | None = None, b_off: int = 0,
    h_off: int = 0, dropout_rate: float = 0.0,
) -> tuple[torch.Tensor, ...]:
    """The sums of absolute product terms, in fp32, of each element of K8's
    products whose left operand the kernel rounds to bf16:

    - ``o``:  ``sum_c P[r, c] |v[c]|``, P the normalised probability after
      dropout and its rescale;
    - ``dq``: ``sum_c |ds[r, c]| |k[c]| / sqrt(D)``;
    - ``dk``: ``sum_r |ds[r, c]| |q_s[r]| / log2(e)``, q_s the scaled q;
    - ``dv``: ``sum_r |pd[r, c]| |do[r]|``;

    with P as in :func:`flash_block_plain` and ds and pd as in
    :func:`flash_block_bwd_plain` on the given ``lse`` and ``delta``.
    Returns ``(o,)`` without ``do``, else ``(o, dq, dk, dv)``. Each scales
    ``flash_attention.flash_tolerance`` for the checks of the kernel
    against the plain version; no path of the package calls it."""
    _, p, l = _probs(q, k, row_off, col_off, seed, b_off, h_off, dropout_rate)
    o_terms = (p / l.clamp(min=1e-37)) @ v.float().abs()
    if do is None:
        return (o_terms,)
    qs, ds, pd = _bwd_parts(q, k, v, do, lse, delta, row_off, col_off, seed, b_off, h_off,
                            dropout_rate)
    ds = ds.abs()
    return (o_terms,
            (ds @ k.float().abs()) / math.sqrt(q.shape[-1]),
            (ds.transpose(-1, -2) @ qs.abs()) * (1.0 / LOG2E),
            pd.transpose(-1, -2) @ do.float().abs())


def _check(q: torch.Tensor, named: dict) -> None:
    b, h, tq, d = q.shape
    tc = named["k"].shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_block kernel: head dim {d} not in {KERNEL_HEAD_DIMS}")
    for name, x in named.items():
        if name in ("lse", "delta"):
            shape, dtype = (b, h, tq), torch.float32
            if not x.is_contiguous():
                raise ValueError(f"flash_block kernel: {name} must be contiguous")
        else:
            t = tc if name in ("k", "v", "dk", "dv") else tq
            shape, dtype = (b, h, t, d), torch.bfloat16
            if x.stride(-1) != 1:
                raise ValueError(f"flash_block kernel: {name} needs a unit stride on its last dim")
        if x.dtype != dtype:
            raise TypeError(f"flash_block kernel: {name} must be {str(dtype)[6:]}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"flash_block kernel: {name} shape {tuple(x.shape)} != {shape}")
        if x.device != q.device:
            raise ValueError(f"flash_block kernel: {name} on {x.device}, q on {q.device}")


def _strides(*xs: torch.Tensor) -> torch.Tensor:
    """The (b, h, t) element strides of each [B, H, T, D] operand, int64."""
    return torch.tensor([s for x in xs for s in x.stride()[:3]], dtype=torch.int64)


def flash_block_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, row_off: int, col_off: int, *,
    seed: int | None = None, b_off: int = 0, h_off: int = 0, dropout_rate: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` of one block (module docstring): ``o`` in q's dtype,
    ``lse`` fp32 ``[B, H, Tq]``. CUDA tensors launch K8's forward (any
    b/h/t strides, inputs whose rows are off 16-byte boundaries copied
    first); CPU tensors run the plain version."""
    if not q.is_cuda:
        o, lse = flash_block_plain(q, k, v, row_off, col_off, seed=seed, b_off=b_off,
                                   h_off=h_off, dropout_rate=dropout_rate)
        return o.to(q.dtype), lse
    b, h, tq, d = q.shape
    o = torch.empty((b, h, tq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    _check(q, {"q": q, "k": k, "v": v, "o": o})
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("flash_block dropout requires a seed")
    q, k, v = (_aligned_input(x) for x in (q, k, v))
    strides = _strides(q, k, v, o)
    lib = build.load("flash_block", _SIGNATURES)
    code = lib.flash_block_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, h, tq, k.shape[2], d, strides.data_ptr(), row_off, col_off, b_off, h_off,
        *_dropout_words(dropout_rate, seed),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(code, "flash_block_fwd_bf16")
    flash_block_fwd.launches += 1
    return o, lse


flash_block_fwd.launches = 0


def flash_block_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, row_off: int, col_off: int, *,
    seed: int | None = None, b_off: int = 0, h_off: int = 0, dropout_rate: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of one block in the inputs' dtype, from the
    forward's ``lse`` and the effective ``delta``. CUDA tensors launch
    K8's backward (its dk/dv kernel, then its dq kernel; any b/h/t strides,
    inputs whose rows are off 16-byte boundaries copied first); CPU tensors
    run the plain version."""
    kw = dict(seed=seed, b_off=b_off, h_off=h_off, dropout_rate=dropout_rate)
    if not q.is_cuda:
        dq, dk, dv = flash_block_bwd_plain(q, k, v, do, lse, delta, row_off, col_off, **kw)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    dq, dk, dv = (torch.empty(x.shape, dtype=x.dtype, device=x.device) for x in (q, k, v))
    _check(q, {"q": q, "k": k, "v": v, "do": do, "lse": lse, "delta": delta,
               "dq": dq, "dk": dk, "dv": dv})
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("flash_block dropout requires a seed")
    q, k, v, do = (_aligned_input(x) for x in (q, k, v, do))
    strides = _strides(q, k, v, do, dq, dk, dv)
    lib = build.load("flash_block", _SIGNATURES)
    b, h, tq, d = q.shape
    code = lib.flash_block_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, tq, k.shape[2], d, strides.data_ptr(), row_off, col_off, b_off, h_off,
        *_dropout_words(dropout_rate, seed),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(code, "flash_block_bwd_bf16")
    flash_block_bwd.launches += 1
    return dq, dk, dv


flash_block_bwd.launches = 0


class _FlashBlock(torch.autograd.Function):
    """(o, lse) = block attention; the backward takes both cotangents."""

    @staticmethod
    def forward(ctx, q, k, v, row_off, col_off, kw):
        o, lse = flash_block_fwd(q, k, v, row_off, col_off, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.block = (row_off, col_off, kw)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        row_off, col_off, kw = ctx.block
        if do.stride(-1) != 1:
            do = do.contiguous()
        do = do.to(q.dtype)
        delta = (do.float() * o.float()).sum(dim=-1) - dlse * LOG2E
        dq, dk, dv = flash_block_bwd(q, k, v, do, lse, delta.contiguous(), row_off,
                                     col_off, **kw)
        return dq, dk, dv, None, None, None


def flash_block(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, row_off: int, col_off: int, *,
    seed: int | None = None, b_off: int = 0, h_off: int = 0, dropout_rate: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable ``(o, lse)`` of one causal attention block at global
    coordinates, over head-major ``[B, H, T, D]`` q and k/v blocks (the JAX
    package's ``flash_block``, with the int dropout seed given directly)."""
    kw = dict(seed=seed, b_off=b_off, h_off=h_off, dropout_rate=float(dropout_rate))
    return _FlashBlock.apply(q, k, v, int(row_off), int(col_off), kw)
