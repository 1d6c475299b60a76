"""Causal flash attention with in-kernel dropout: the CUDA kernels
``csrc/flash_fwd.cu`` (K1) and ``csrc/flash_bwd.cu`` (K2), their plain
PyTorch versions, and the autograd function over them.

Counterpart of ``gpt_2_distributed_tpu/ops/flash_attention.py`` (its Pallas
forward and backward kernels and their custom VJP). The kernels run on CUDA
tensors only; a CPU tensor goes to the plain version, and a CUDA tensor
launches the kernel or raises — there is no fallback from a failed build or
launch to the plain version.

Semantics, as the JAX kernels: the forward keeps the base-2 log-sum-exp
``lse`` of each row's UNDROPPED scaled scores; dropout keeps
``dropout_hash_bits(seed, b, h, row, col) >= uint32(int(rate * 2^32))``
(``ops/spmd.py``) on absolute coordinates and divides the kept
probabilities by ``1 - rate``. The backward recomputes ``p = exp2(s - lse)``
(the normalized, undropped probability) and the same mask, with
``delta = rowsum(do * o)`` in fp32 taken in torch over the DROPPED output:
``dpd = do v^T``, ``dp = keep * dpd / kp``, ``pd = keep * p / kp``,
``ds = p (dp - delta)``, ``dq = ds k / sqrt(D)``, ``dk = ds^T q / sqrt(D)``,
``dv = pd^T do``.

The kernels multiply on the tensor cores, so, as the JAX kernels do, they
round the dropped probabilities to bf16 before ``P v``, and ``ds`` and ``pd``
before their products; the plain versions keep them in fp32. Each such
rounding moves one product term by at most 2^-8 of itself, so
:func:`flash_error_terms` gives, element by element, the sums of the
products' absolute terms that scale the checks' bound on the difference,
:func:`flash_tolerance`.

The kernels copy their tiles 16 bytes at a time, so every row of every bf16
operand must start on a 16-byte boundary: the wrappers copy an input whose
rows do not, and refuse such an ``o``.

K1's query-offset form, :func:`flash_attention_fwd_offset`, carries the
serving engine's chunked prefill (``ops/paged_attention.py::
paged_prefill_attention``): query row r of batch b sits at global position
``start[b] + r`` and attends causally over keys from position 0. It is K1
itself, keys tiled from position 0, so a row's o and lse equal the
whole-prompt form's at the same position bit for bit; its plain version is
:func:`flash_attention_offset_plain`.

``flash_attention_fwd.launches``, ``flash_attention_fwd_offset.launches``
and ``flash_attention_bwd.launches`` count kernel launches (never plain
calls), so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import math

import torch

from gpt_2_distributed_torch.kernels import build
from gpt_2_distributed_torch.ops.attention import MASK_VALUE, causal_scores, dropout_probs
from gpt_2_distributed_torch.ops.spmd import causal_dropout_keep

LOG2E = 1.4426950408889634
KERNEL_HEAD_DIMS = (32, 64, 128)

_DROPOUT_ARGS = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float]  # seed, threshold, keep
_SIGNATURES = {
    "flash_fwd_bf16": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k, v
        ctypes.c_void_p, ctypes.c_void_p,                    # o, lse
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H T D
        ctypes.c_void_p,                                     # int64 strides[12]
        *_DROPOUT_ARGS,
        ctypes.c_void_p,                                     # stream
    ],
    "flash_fwd_offset_bf16": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k, v
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # o, lse, start
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H C S D
        ctypes.c_void_p,                                     # int64 strides[12]
        ctypes.c_void_p,                                     # stream
    ],
}
_BWD_SIGNATURES = {
    "flash_bwd_bf16": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k, v
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # do, lse, delta
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # dq, dk, dv
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H T D
        ctypes.c_void_p,                                     # int64 strides[21]
        *_DROPOUT_ARGS,
        ctypes.c_void_p,                                     # stream
    ],
}


def _dropout_words(dropout_rate: float, seed: int | None) -> tuple[int, int, float]:
    """(seed as uint32, keep threshold, keep probability) for the kernels;
    threshold 0 keeps everything."""
    if dropout_rate <= 0.0:
        return 0, 0, 1.0
    if seed is None:
        raise ValueError("flash attention dropout requires a seed")
    return seed & 0xFFFFFFFF, int(dropout_rate * (2 ** 32)), 1.0 - dropout_rate


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    dropout_rate: float = 0.0, seed: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense causal attention over ``[B, H, T, D]``: fp32 scores and
    softmax, dropout on the probabilities, probabilities cast to q's dtype
    before the product with V (``ops/attention.py::causal_attention``, bit
    for bit).

    Returns ``(o, lse)``: ``o`` in q's dtype and ``lse`` the fp32 base-2
    log-sum-exp of each row's undropped scaled scores, ``[B, H, T]`` — the
    same pair the kernel writes. fp32 inputs give the fp32 reference the
    kernel is held against."""
    scores = causal_scores(q, k)
    lse = torch.logsumexp(scores, dim=-1)
    probs = dropout_probs(torch.softmax(scores, dim=-1), dropout_rate, seed)
    o = probs.to(q.dtype) @ v
    return o, lse * LOG2E


def _offset_scores(q: torch.Tensor, k: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """fp32 scaled scores ``[B, H, C, S]`` of q rows at global positions
    ``start[b] + r`` against keys from position 0, ``MASK_VALUE`` past each
    row's position."""
    c, d, s = q.shape[2], q.shape[3], k.shape[2]
    scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(d)
    qpos = start.to(q.device).long()[:, None, None, None] + torch.arange(
        c, device=q.device)[:, None]
    return scores.masked_fill(torch.arange(s, device=q.device) > qpos, MASK_VALUE)


def flash_attention_offset_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, start: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_plain` with a query offset: q ``[B, H, C, D]``
    whose row r of batch b sits at global position ``start[b] + r``, k and
    v ``[B, H, S, D]`` from position 0; key j is attended where ``j <=
    start[b] + r``. The same ops as the whole-prompt plain version (fp32
    scores over sqrt(D), ``MASK_VALUE`` fill, fp32 softmax, probabilities
    cast to q's dtype), so at ``start = 0`` and ``S = C`` it is that version
    bit for bit. Returns ``(o, lse)``, lse fp32 base-2 ``[B, H, C]``."""
    scores = _offset_scores(q, k, start)
    lse = torch.logsumexp(scores, dim=-1)
    o = torch.softmax(scores, dim=-1).to(q.dtype) @ v
    return o, lse * LOG2E


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor,
    dropout_rate: float = 0.0, seed: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of :func:`flash_attention_plain` with the JAX kernel's
    arithmetic (module docstring), in fp32 whatever the input dtype, as K2
    computes it; returns ``(dq, dk, dv)`` in the inputs' dtypes.

    ``lse`` is the forward's base-2 ``[B, H, T]`` and ``delta`` the fp32
    ``rowsum(do * o)``. The scale ``log2(e)/sqrt(D)`` is folded into q, so
    ``dk`` comes out ``log2(e)`` too large and is divided back, as in the
    JAX kernel."""
    b, h, t, d = q.shape
    scale = LOG2E / math.sqrt(d)
    qs = q.float() * scale
    causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    s = qs @ k.float().transpose(-1, -2)
    p = torch.where(causal, torch.exp2(s - lse[..., None]), 0.0)
    dpd = do.float() @ v.float().transpose(-1, -2)
    if dropout_rate > 0.0:
        if seed is None:
            raise ValueError("flash attention dropout requires a seed")
        keep = causal_dropout_keep(seed, dropout_rate, b, h, t, q.device)
        kp = 1.0 - dropout_rate
        pd = torch.where(keep, p / kp, 0.0)
        dp = torch.where(keep, dpd / kp, 0.0)
    else:
        pd, dp = p, dpd
    ds = p * (dp - delta[..., None])
    dq = (ds @ k.float()) * (scale / LOG2E)
    dk = (ds.transpose(-1, -2) @ qs) * (1.0 / LOG2E)
    dv = pd.transpose(-1, -2) @ do.float()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_error_terms(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    dropout_rate: float = 0.0, seed: int | None = None,
    do: torch.Tensor | None = None, delta: torch.Tensor | None = None,
) -> tuple[torch.Tensor, ...]:
    """The sums of absolute product terms, in fp32, of each output element
    of the kernels' products whose left operand K1 or K2 rounds to bf16:

    - ``o``:  ``sum_j P[t, j] |v[j]|``, P the normalized probability after
      dropout and its rescale;
    - ``dq``: ``sum_j |ds[t, j]| |k[j]| / sqrt(D)``;
    - ``dk``: ``sum_t |ds[t, j]| |q[t]| / sqrt(D)``;
    - ``dv``: ``sum_t |pd[t, j]| |do[t]|``;

    with p, ds and pd as in :func:`flash_attention_bwd_plain` (``delta`` the
    same fp32 ``rowsum(do * o)`` the backward takes). Returns ``(o,)``
    without ``do``, else ``(o, dq, dk, dv)``, each ``[B, H, T, D]``. A
    tolerance for the checks of the kernels against the plain versions; no
    path of the package calls it."""
    b, h, t, d = q.shape
    q, k, v = q.float(), k.float(), v.float()
    p = torch.softmax(causal_scores(q, k), dim=-1)
    o_terms = dropout_probs(p, dropout_rate, seed) @ v.abs()
    if do is None:
        return (o_terms,)
    dpd = do.float() @ v.transpose(-1, -2)
    if dropout_rate > 0.0:
        keep = causal_dropout_keep(seed, dropout_rate, b, h, t, q.device)
        kp = 1.0 - dropout_rate
        pd = torch.where(keep, p / kp, 0.0)
        dp = torch.where(keep, dpd / kp, 0.0)
    else:
        pd, dp = p, dpd
    ds = (p * (dp - delta[..., None])).abs()
    c = 1.0 / math.sqrt(d)
    return (o_terms, (ds @ k.abs()) * c, (ds.transpose(-1, -2) @ q.abs()) * c,
            pd.transpose(-1, -2) @ do.float().abs())


def flash_offset_error_terms(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             start: torch.Tensor) -> tuple[torch.Tensor]:
    """:func:`flash_error_terms`' ``(o,)`` for the query-offset form:
    ``sum_j P[r, j] |v[j]|`` in fp32, P the offset form's normalized
    probabilities. A tolerance for checks only."""
    p = torch.softmax(_offset_scores(q.float(), k.float(), start), dim=-1)
    return (p @ v.float().abs(),)


def flash_tolerance(ref: torch.Tensor, terms: torch.Tensor) -> torch.Tensor:
    """The element bound that holds a K1/K2 output x (or one of K8's
    backward, ``ops/flash_block.py``) against its plain version ``ref`` in
    fp32: ``|x - ref| <= 2^-8 |ref| + 2^-16 + 2^-8 terms``, ``terms`` from
    :func:`flash_error_terms` (K8: ``flash_block_error_terms``). bf16
    keeps 8 significant bits, so rounding to it moves a value by at most
    2^-8 of itself: 2^-8 |ref| + 2^-16 is the one rounding of the output
    plus fp32 summation noise, 2^-8 terms one rounding of each product
    term: the worst case of each rounding, with no headroom beyond the
    fact that the errors of many terms seldom align."""
    return 2.0 ** -8 * ref.abs() + 2.0 ** -16 + 2.0 ** -8 * terms


def _check_operand(name: str, x: torch.Tensor, shape, dtype=torch.bfloat16) -> None:
    if x.dtype != dtype:
        raise TypeError(f"flash kernel: {name} must be {str(dtype)[6:]}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"flash kernel: {name} shape {tuple(x.shape)} != {tuple(shape)}")
    if x.stride(-1) != 1:
        raise ValueError(f"flash kernel: {name} needs a unit stride on its last dim")


def _check_operands(q: torch.Tensor, named: dict) -> None:
    b, h, t, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel: head dim {d} not in {KERNEL_HEAD_DIMS}")
    for name, x in named.items():
        if name in ("lse", "delta"):
            _check_operand(name, x, (b, h, t), torch.float32)
            if not x.is_contiguous():
                raise ValueError(f"flash kernel: {name} must be contiguous")
        else:
            _check_operand(name, x, (b, h, t, d))
        if x.device != q.device:
            raise ValueError(f"flash kernel: {name} on {x.device}, q on {q.device}")


def _rows_aligned(x: torch.Tensor) -> bool:
    """Whether every row of a [B, H, T, D] operand starts on a 16-byte
    boundary, as the kernels' 16-byte copies need."""
    return x.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in x.stride()[:3])


def _aligned_input(x: torch.Tensor) -> torch.Tensor:
    """x itself, or a contiguous copy where its rows are off 16-byte
    boundaries."""
    return x if _rows_aligned(x) else x.clone(memory_format=torch.contiguous_format)


def _strides(*xs: torch.Tensor) -> torch.Tensor:
    """The (b, h, t) element strides of each [B, H, T, D] operand, int64."""
    return torch.tensor([s for x in xs for s in x.stride()[:3]], dtype=torch.int64)


def _launch_fwd(q, k, v, o, dropout_rate, seed):
    """Launch K1 on [B, H, T, D] views (any b/h/t strides); returns lse."""
    b, h, t, d = q.shape
    _check_operands(q, {"q": q, "k": k, "v": v, "o": o})
    if not _rows_aligned(o):
        raise ValueError("flash kernel: every row of o must start on a 16-byte boundary")
    q, k, v = (_aligned_input(x) for x in (q, k, v))
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v, o)
    lib = build.load("flash_fwd", _SIGNATURES)
    code = lib.flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, h, t, d, strides.data_ptr(), *_dropout_words(dropout_rate, seed),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(code, "flash_fwd_bf16")
    flash_attention_fwd.launches += 1
    return lse


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    dropout_rate: float = 0.0, seed: int | None = None,
    o: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal attention over ``[B, H, T, D]``; returns ``(o, lse)`` with
    ``lse`` fp32 base-2 ``[B, H, T]``. CUDA tensors launch K1 (bf16, D in
    32/64/128, any T), writing into ``o`` when given (any b/h/t strides
    that keep its rows on 16-byte boundaries); CPU tensors use the plain
    version."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, dropout_rate, seed)
    if o is None:
        o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = _launch_fwd(q, k, v, o, dropout_rate, seed)
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention_fwd_offset(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, start: torch.Tensor,
    o: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's query-offset form: q ``[B, H, C, D]`` at global positions
    ``start[b] + r`` against k, v ``[B, H, S, D]`` from position 0, causal by
    global position, no dropout; returns ``(o, lse)``, lse fp32 base-2
    ``[B, H, C]``. CUDA tensors launch K1 (bf16, D in 32/64/128, ``start``
    int32 ``[B]`` on the same device), writing into ``o`` when given (any
    b/h/t strides that keep its rows on 16-byte boundaries); CPU tensors use
    :func:`flash_attention_offset_plain`. Raises on a shape, dtype or
    device the kernel does not take and on a launch error."""
    if not q.is_cuda:
        return flash_attention_offset_plain(q, k, v, start)
    b, h, c, d = q.shape
    s = k.shape[2]
    if o is None:
        o = torch.empty_like(q, memory_format=torch.contiguous_format)
    _check_operands(q, {"q": q, "o": o})
    for name, x in (("k", k), ("v", v)):
        _check_operand(name, x, (b, h, s, d))
        if x.device != q.device:
            raise ValueError(f"flash kernel: {name} on {x.device}, q on {q.device}")
    if s < 1:
        raise ValueError("flash kernel: the offset form needs at least one key")
    if start.dtype != torch.int32 or tuple(start.shape) != (b,) or not start.is_contiguous():
        raise ValueError(f"flash kernel: start must be a contiguous int32 [{b}]")
    if start.device != q.device:
        raise ValueError(f"flash kernel: start on {start.device}, q on {q.device}")
    if not _rows_aligned(o):
        raise ValueError("flash kernel: every row of o must start on a 16-byte boundary")
    q, k, v = (_aligned_input(x) for x in (q, k, v))
    lse = torch.empty((b, h, c), dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v, o)
    lib = build.load("flash_fwd", _SIGNATURES)
    code = lib.flash_fwd_offset_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        start.data_ptr(), b, h, c, s, d, strides.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(code, "flash_fwd_offset_bf16")
    flash_attention_fwd_offset.launches += 1
    return o, lse


flash_attention_fwd_offset.launches = 0


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor,
    dropout_rate: float = 0.0, seed: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of causal flash attention over ``[B, H, T, D]``.

    CUDA tensors launch K2 (its dk/dv kernel, then its dq kernel) and get
    the three grads as views of one ``[B, T, 3, H, D]`` buffer, the layout
    of the fused qkv product's grad; CPU tensors use the plain version."""
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, do, lse, delta, dropout_rate, seed)
    b, h, t, d = q.shape
    buf = torch.empty((b, t, 3, h, d), dtype=q.dtype, device=q.device)
    dq, dk, dv = (buf[:, :, i].transpose(1, 2) for i in range(3))
    _check_operands(q, {"q": q, "k": k, "v": v, "do": do, "lse": lse,
                        "delta": delta, "dq": dq, "dk": dk, "dv": dv})
    q, k, v, do = (_aligned_input(x) for x in (q, k, v, do))
    strides = _strides(q, k, v, do, dq, dk, dv)
    lib = build.load("flash_bwd", _BWD_SIGNATURES)
    code = lib.flash_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, t, d, strides.data_ptr(), *_dropout_words(dropout_rate, seed),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(code, "flash_bwd_bf16")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) over [B, H, T, D] views; K1 forward, K2
    backward on CUDA tensors, their plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, dropout_rate, seed, bthd_out):
        o = None
        if q.is_cuda and bthd_out:
            b, h, t, d = q.shape
            o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
        o, lse = flash_attention_fwd(q, k, v, dropout_rate, seed, o=o)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.dropout = (dropout_rate, seed)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        dq, dk, dv = flash_attention_bwd(q, k, v, do, lse, delta, *ctx.dropout)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    dropout_rate: float = 0.0, seed: int | None = None,
) -> torch.Tensor:
    """Differentiable causal flash attention over ``[B, H, T, D]``, the JAX
    package's ``flash_attention`` with the kernel seed given directly
    (the JAX entry point draws it from a key). Returns o."""
    return _FlashAttention.apply(q, k, v, dropout_rate, seed, False)


def flash_attention_bthd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         dropout_rate: float = 0.0,
                         seed: int | None = None) -> torch.Tensor:
    """``[B, T, H, D]`` entry point (the model's layout); returns o.

    The kernels read and write through strides, so the head-major views of
    the fused qkv product and of o cost no copy."""
    o = _FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), dropout_rate, seed, True)
    return o.transpose(1, 2)
