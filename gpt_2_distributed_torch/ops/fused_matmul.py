"""Fused matmuls (K7): the matmul and its epilogue in one pass over the
fp32 accumulator, as the CUDA kernels of ``csrc/fused_matmul.cu``, their
plain PyTorch versions and the autograd functions over them.

Counterpart of ``gpt_2_distributed_tpu/ops/fused_matmul.py``. The kernels
run on CUDA tensors only; a CPU tensor goes to the plain version, and a
CUDA tensor launches the kernel or raises. There is no tile plan and no
fallback to unfused ops: the kernels take any row count and any width.

Semantics, as the JAX kernels:

* ``matmul_bias``: ``x @ w + b``, the bias added to the fp32 accumulator
  and the sum rounded once (the qkv leg).
* ``matmul_bias_gelu_dropout``: ``dropout(gelu_tanh(u))`` with ``u = x @ w
  + b``; the GELU runs in fp32 on the unrounded u, and u is written
  rounded (the backward's residual, whose ``gelu'`` reads it).
* ``matmul_bias_residual_dropout``: ``fp32(r) + dropout(x @ w + b)``,
  rounded once; its backward passes dy straight through as dr.
* Dropout keeps ``dropout_hash_bits(seed, 0, salt, row, col) >= uint32(int(
  rate * 2^32))`` over the absolute row of the flattened ``[N, M]`` output
  and the output column (``fused_layer.epilogue_dropout_mask``), with the
  salts below, and divides the kept fp32 values by ``fp32(1 - rate)`` —
  the JAX kernels divide by the Python float — not by the bf16 keep
  probability K4-K6 use.
* The backward forms ``du = keep * dy / (1 - rate) [* gelu'(u)]`` in fp32
  and rounds it to dy's dtype, once a leg (:func:`mm_du`, which also gives
  ``db``, the fp32 column sum of du, returned in b's dtype), and hands it to
  both products: ``dx = du @ w^T`` (:func:`mm_dgrad`) and ``dw = x^T @ du``
  (:func:`mm_wgrad`), each rounded once. The JAX kernels form du inside
  every output tile of both products (``_dgrad_tile``); the values are the
  same.

For the inference paths (``models/decode.py``, ``serving/engine.py``) the
same forward kernel has two more epilogues: :func:`linear`, the unfused
model's ``round(round(x @ w) + b)`` (the JAX package leaves those products
to XLA), and :func:`head_logits`, the tied head's fp32 ``h @ wte^T``. The
kernels sum every output element over the whole depth in one block, in a
fixed order and tile shape, so a row's result does not depend on the rows
that share the call: the engine's streams equal one-request decoding.

Each plain version takes ``dtype``, the dtype whose inner roundings it
applies (the input's by default); on fp32 copies of bf16 values with
``dtype=torch.bfloat16`` it is the fp32 reference a kernel is held to. The
forward epilogues round only their outputs.

Each kernel wrapper's ``launches`` counts kernel launches (never plain
calls); the seven training wrappers are the seven JAX kernels, and
``mm_du`` the du pass their backward kernels share.
"""

from __future__ import annotations

import ctypes

import torch

from gpt_2_distributed_torch.kernels import build
from gpt_2_distributed_torch.ops.fused_layer import (
    as_rows,
    check_operand,
    dropped,
    effective_dropout,
    gelu_core,
    gelu_grad,
)

# Per-site dropout stream salts, the hash's head coordinate (fused_layer
# owns 1/2/3).
SALT_MM_GELU = 4       # MLP fc leg activation dropout
SALT_MM_ATTN_PROJ = 5  # attention out-projection residual dropout
SALT_MM_MLP_PROJ = 6   # MLP out-projection residual dropout

TILE = 128            # output rows and columns of a kernel block
WGRAD_BLOCKS = 132    # wgrad aims at one block on each of the H100's 132 SMs
WGRAD_MIN_ROWS = 512  # ... with at least this many rows a slice
DU_CHUNK_ROWS = 32    # rows of du a block of the du pass sums db over

_EPI = {"bias": 0, "round": 1, "gelu": 2, "resid": 3}

_P, _I, _U32, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_DROP = [_U32, _U32, _U32, _F, _P]   # seed, salt, threshold, keep, stream
_SIGNATURES = {
    "mm_fwd_bf16": [_P, _I, _P, _I] + [_P] * 4 + [_I] * 4 + _DROP,
    "mm_nt_f32": [_P, _I, _P, _I, _P] + [_I] * 3 + [_P],
    "mm_du_bf16": [_P] * 3 + [_I] + [_P] * 2 + [_I] * 3 + _DROP,
    "mm_dgrad_bf16": [_P, _I, _P, _I, _P] + [_I] * 3 + [_P],
    "mm_wgrad_bf16": [_P, _I, _P, _I, _P, _P] + [_I] * 4 + [_P],
}


def _mask_scale(v: torch.Tensor, rate: float, seed: int | None, salt: int) -> torch.Tensor:
    """fp32 ``keep * v / fp32(1 - rate)`` of a site's mask; v at rate 0."""
    return dropped(v, rate, seed, salt, 1.0 - rate) if rate > 0.0 else v


def _round(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return v.to(dtype).float()


# --- plain versions ---------------------------------------------------------


def matmul_fwd_plain(kind: str, x, w, b, r=None, rate=0.0, seed=None, salt=0):
    """K7's forward over ``x [N, K] @ w [K, M]`` in fp32: ``y`` for kinds
    "bias" and "resid", ``(y, u)`` for "gelu", in x's dtype."""
    u = x.float() @ w.float() + b.float()
    if kind == "bias":
        return u.to(x.dtype)
    if kind == "gelu":
        g, _ = gelu_core(u)
        return _mask_scale(g, rate, seed, salt).to(x.dtype), u.to(x.dtype)
    return (r.float() + _mask_scale(u, rate, seed, salt)).to(x.dtype)


def du_plain(g, u=None, rate=0.0, seed=None, salt=0, dtype=None):
    """The backward's ``du = keep * g / (1 - rate) [* gelu'(u)]`` in fp32,
    rounded to ``dtype`` (g's by default) and held in fp32."""
    du = _mask_scale(g.float(), rate, seed, salt)
    if u is not None:
        du = du * gelu_grad(u.float())
    return _round(du, dtype or g.dtype)


def dgrad_product_plain(du, w, dtype):
    """The dgrad product ``du @ w^T`` over ``du [N, M]``, ``w [K, M]`` in
    fp32, rounded to ``dtype``."""
    return (du.float() @ w.float().t()).to(dtype)


def wgrad_product_plain(x, du):
    """The wgrad product ``x^T @ du`` over ``x [N, K]``, ``du [N, M]`` in
    fp32, rounded to x's dtype."""
    return (x.float().t() @ du.float()).to(x.dtype)


def matmul_dgrad_plain(g, w, u=None, rate=0.0, seed=None, salt=0, dtype=None):
    """K7's dgrad: ``dx = du @ w^T`` in g's dtype, du from ``g`` [N, M] (and
    ``u``, the GELU leg) rounded to ``dtype``."""
    return dgrad_product_plain(du_plain(g, u, rate, seed, salt, dtype), w, g.dtype)


def matmul_wgrad_plain(x, g, u=None, rate=0.0, seed=None, salt=0, dtype=None):
    """K7's wgrad: ``(dw, db)``, ``dw = x^T @ du`` in x's dtype and ``db``
    the fp32 column sum of du."""
    du = du_plain(g, u, rate, seed, salt, dtype)
    return wgrad_product_plain(x, du), du.sum(dim=0)


def linear_plain(x, w, b=None, dtype=None):
    """The unfused product ``round(round(x @ w) + b)`` in x's dtype."""
    y = _round(x.float() @ w.float(), dtype or x.dtype)
    return (y if b is None else y + b.float()).to(x.dtype)


def head_plain(h, wte):
    """fp32 logits ``h @ wte^T`` of the tied head."""
    return h.float() @ wte.float().t()


# --- kernel wrappers --------------------------------------------------------


def _checked(operands: dict, device) -> None:
    for name, (t, shape) in operands.items():
        check_operand(name, t, shape, torch.bfloat16, device, kernel="fused_matmul")


def _dropout_words(rate: float, seed: int | None, salt: int):
    """(seed as uint32, salt, keep threshold, keep probability); threshold
    0 keeps everything."""
    if rate <= 0.0:
        return 0, salt, 0, 1.0
    if seed is None:
        raise ValueError("fused_matmul dropout requires a seed")
    return seed & 0xFFFFFFFF, salt, int(rate * (2 ** 32)), 1.0 - rate


def _launch(fn: str, *args) -> None:
    lib = build.load("fused_matmul", _SIGNATURES)
    build.check(getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream), fn)


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _tma_operand(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``(t, row stride)`` as the kernels' TMA loads take a contiguous bf16
    matrix: rows a multiple of 16 bytes at a 16-byte aligned base. Where
    ``t`` is not so, a zeroed copy with its rows padded to 8 elements (the
    kernel reads only the true width)."""
    rows, cols = t.shape
    if cols % 8 == 0 and t.data_ptr() % 16 == 0:
        return t, cols
    ld = -(-cols // 8) * 8
    padded = t.new_zeros((rows, ld))
    padded[:, :cols] = t
    return padded, ld


def _fwd(epi: str, x, w, b, r=None, rate=0.0, seed=None, salt=0, want_u=False):
    """Launch the forward kernel with epilogue ``epi`` on bf16 ``x [N, K]``,
    ``w [K, M]``; returns ``(y, u)``, u None unless wanted."""
    n, k = x.shape
    m = w.shape[1]
    ops = {"x": (x, (n, k)), "w": (w, (k, m))}
    if b is not None:
        ops["b"] = (b, (m,))
    if r is not None:
        ops["r"] = (r, (n, m))
    _checked(ops, x.device)
    y = torch.empty((n, m), dtype=x.dtype, device=x.device)
    u = torch.empty_like(y) if want_u else None
    if n == 0 or m == 0:
        return y, u
    (x_t, ld_x), (w_t, ld_w) = _tma_operand(x), _tma_operand(w)
    with torch.cuda.device(x.device):
        _launch("mm_fwd_bf16", x_t.data_ptr(), ld_x, w_t.data_ptr(), ld_w, _ptr(b), _ptr(r),
                y.data_ptr(), _ptr(u), n, k, m, _EPI[epi], *_dropout_words(rate, seed, salt))
    return y, u


def mm_bias_fwd(x, w, b):
    """K7 bias forward ``x @ w + b`` over ``[N, K] @ [K, M]``: CUDA tensors
    launch the kernel (bf16), CPU tensors use the plain version."""
    if not x.is_cuda:
        return matmul_fwd_plain("bias", x, w, b)
    y, _ = _fwd("bias", x, w, b)
    mm_bias_fwd.launches += 1
    return y


def mm_gelu_fwd(x, w, b, rate=0.0, seed=None, salt=SALT_MM_GELU, want_u=True):
    """K7 gelu forward: ``(y, u)`` with ``y = dropout(gelu(u))``, ``u = x @ w
    + b`` (None unless ``want_u``)."""
    if not x.is_cuda:
        y, u = matmul_fwd_plain("gelu", x, w, b, None, rate, seed, salt)
        return y, u if want_u else None
    out = _fwd("gelu", x, w, b, None, rate, seed, salt, want_u)
    mm_gelu_fwd.launches += 1
    return out


def mm_resid_fwd(x, w, b, r, rate=0.0, seed=None, salt=SALT_MM_ATTN_PROJ):
    """K7 resid forward: ``r + dropout(x @ w + b)``."""
    if not x.is_cuda:
        return matmul_fwd_plain("resid", x, w, b, r, rate, seed, salt)
    y, _ = _fwd("resid", x, w, b, r, rate, seed, salt)
    mm_resid_fwd.launches += 1
    return y


def mm_du(g, u=None, rate=0.0, seed=None, salt=0):
    """K7's du pass, once a leg backward: ``(du, db)`` with ``du = keep * g /
    (1 - rate) [* gelu'(u)]`` rounded to g's dtype over ``g [N, M]`` and
    ``db`` the fp32 column sum of du. At rate 0 without ``u`` du is ``g``
    itself and the kernel only sums db. CUDA tensors launch the kernel,
    CPU tensors use the plain version."""
    if not g.is_cuda:
        du = du_plain(g, u, rate, seed, salt)
        return du.to(g.dtype), du.sum(dim=0)
    n, m = g.shape
    ops = {"g": (g, (n, m))}
    if u is not None:
        ops["u"] = (u, (n, m))
    _checked(ops, g.device)
    write = u is not None or rate > 0.0
    du = torch.empty_like(g) if write else g
    partial = torch.empty(-(-n // DU_CHUNK_ROWS) * m, dtype=torch.float32, device=g.device)
    db = torch.empty(m, dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        _launch("mm_du_bf16", g.data_ptr(), _ptr(u), du.data_ptr() if write else None, m,
                partial.data_ptr(), db.data_ptr(), n, m, DU_CHUNK_ROWS,
                *_dropout_words(rate, seed, salt))
    mm_du.launches += 1
    return du, db


def _dgrad(du, w, counter):
    """The dgrad product ``du [N, M] @ w [K, M]^T``: on CUDA tensors the
    kernel (bf16), counted on ``counter``; on CPU tensors the plain
    version."""
    if not du.is_cuda:
        return dgrad_product_plain(du, w, du.dtype)
    n, m = du.shape
    k = w.shape[0]
    _checked({"du": (du, (n, m)), "w": (w, (k, m))}, du.device)
    dx = torch.empty((n, k), dtype=du.dtype, device=du.device)
    if n == 0 or k == 0 or m == 0:
        return dx.zero_()
    (du_t, ld_du), (w_t, ld_w) = _tma_operand(du), _tma_operand(w)
    with torch.cuda.device(du.device):
        _launch("mm_dgrad_bf16", du_t.data_ptr(), ld_du, w_t.data_ptr(), ld_w, dx.data_ptr(),
                n, m, k)
    counter.launches += 1
    return dx


def mm_dgrad(du, w):
    """K7 dgrad of the bias and resid legs: ``dx = du @ w^T`` over the leg's
    ``du [N, M]`` from :func:`mm_du` and ``w [K, M]``."""
    return _dgrad(du, w, mm_dgrad)


def mm_dgrad_gelu(du, w):
    """K7 dgrad of the gelu leg: the same product, counted apart (du carries
    ``gelu'(u)``)."""
    return _dgrad(du, w, mm_dgrad_gelu)


def wgrad_slices(n: int, k: int, m: int) -> int:
    """How many row slices wgrad sums separately (then adds in order): a
    function of the shape alone, so a shape's grads are the same bits in
    every launch. Enough slices that the blocks fill the card where the
    weight's tiles do not, each at least ``WGRAD_MIN_ROWS`` rows."""
    tiles = -(-k // TILE) * -(-m // TILE)
    return max(1, min(WGRAD_BLOCKS // tiles, -(-n // WGRAD_MIN_ROWS)))


def _wgrad(x, du, counter):
    """The wgrad product ``x [N, K]^T @ du [N, M]``: on CUDA tensors the
    kernel (bf16), counted on ``counter``; on CPU tensors the plain
    version."""
    if not x.is_cuda:
        return wgrad_product_plain(x, du)
    n, k = x.shape
    m = du.shape[1]
    _checked({"x": (x, (n, k)), "du": (du, (n, m))}, x.device)
    dw = torch.empty((k, m), dtype=x.dtype, device=x.device)
    if n == 0 or k == 0 or m == 0:
        return dw.zero_()
    slices = wgrad_slices(n, k, m)
    partial = torch.empty(slices * k * m if slices > 1 else 0, dtype=torch.float32,
                          device=x.device)
    (x_t, ld_x), (du_t, ld_du) = _tma_operand(x), _tma_operand(du)
    with torch.cuda.device(x.device):
        _launch("mm_wgrad_bf16", x_t.data_ptr(), ld_x, du_t.data_ptr(), ld_du,
                partial.data_ptr(), dw.data_ptr(), n, k, m, slices)
    counter.launches += 1
    return dw


def mm_wgrad(x, du):
    """K7 wgrad of the bias and resid legs: ``dw = x^T @ du`` over ``x [N,
    K]`` and the leg's ``du [N, M]`` (whose db :func:`mm_du` gave)."""
    return _wgrad(x, du, mm_wgrad)


def mm_wgrad_gelu(x, du):
    """K7 wgrad of the gelu leg: the same product, counted apart."""
    return _wgrad(x, du, mm_wgrad_gelu)


def linear(x, w, b=None):
    """The unfused product ``round(round(x @ w) + b)`` over ``[..., K] @ [K,
    M]`` for the inference paths: on CUDA tensors through the forward
    kernel (so a row's bits never depend on the rows beside it), on CPU
    tensors the plain version."""
    x2 = as_rows(x)
    if not x.is_cuda:
        y = linear_plain(x2, w, b)
    else:
        y, _ = _fwd("round", x2, w, b)
        linear.launches += 1
    return y.view(*x.shape[:-1], w.shape[1])


def head_logits(h, wte):
    """fp32 logits ``h @ wte^T`` over ``h [..., C]`` and the tied embedding
    ``wte [V, C]``: on CUDA tensors through the forward kernel with wte as
    its transposed operand, on CPU tensors the plain version."""
    h2 = as_rows(h)
    if not h.is_cuda:
        out = head_plain(h2, wte)
    else:
        n, c = h2.shape
        v = wte.shape[0]
        _checked({"h": (h2, (n, c)), "wte": (wte, (v, c))}, h.device)
        out = torch.empty((n, v), dtype=torch.float32, device=h.device)
        (h_t, ld_h), (wte_t, ld_wte) = _tma_operand(h2), _tma_operand(wte)
        with torch.cuda.device(h.device):
            _launch("mm_nt_f32", h_t.data_ptr(), ld_h, wte_t.data_ptr(), ld_wte,
                    out.data_ptr(), n, c, v)
        head_logits.launches += 1
    return out.view(*h.shape[:-1], wte.shape[0])


for _wrapper in (mm_bias_fwd, mm_gelu_fwd, mm_resid_fwd, mm_du, mm_dgrad, mm_dgrad_gelu,
                 mm_wgrad, mm_wgrad_gelu, linear, head_logits):
    _wrapper.launches = 0


# --- autograd functions and entry points ------------------------------------


def _out(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return y.view(*x.shape[:-1], y.shape[-1])


class _MatmulBias(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        x2 = as_rows(x)
        ctx.save_for_backward(x2, w)
        ctx.bias_dtype = b.dtype
        return _out(mm_bias_fwd(x2, w, b), x)

    @staticmethod
    def backward(ctx, dy):
        x2, w = ctx.saved_tensors
        g = as_rows(dy)
        du, db = mm_du(g)
        dx, dw = mm_dgrad(du, w), mm_wgrad(x2, du)
        return _out(dx, dy), dw, db.to(ctx.bias_dtype)


class _MatmulGelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, rate, seed, salt, want_u):
        x2 = as_rows(x)
        y, u = mm_gelu_fwd(x2, w, b, rate, seed, salt, want_u)
        ctx.save_for_backward(x2, w, u)
        ctx.dropout = (rate, seed, salt)
        ctx.bias_dtype = b.dtype
        return _out(y, x)

    @staticmethod
    def backward(ctx, dy):
        x2, w, u = ctx.saved_tensors
        g = as_rows(dy)
        du, db = mm_du(g, u, *ctx.dropout)
        dx, dw = mm_dgrad_gelu(du, w), mm_wgrad_gelu(x2, du)
        return _out(dx, dy), dw, db.to(ctx.bias_dtype), None, None, None, None


class _MatmulResid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, r, rate, seed, salt):
        x2 = as_rows(x)
        ctx.save_for_backward(x2, w)
        ctx.dropout = (rate, seed, salt)
        ctx.bias_dtype = b.dtype
        return _out(mm_resid_fwd(x2, w, b, as_rows(r), rate, seed, salt), x)

    @staticmethod
    def backward(ctx, dy):
        x2, w = ctx.saved_tensors
        g = as_rows(dy)
        du, db = mm_du(g, None, *ctx.dropout)
        dx, dw = mm_dgrad(du, w), mm_wgrad(x2, du)
        return _out(dx, dy), dw, db.to(ctx.bias_dtype), dy, None, None, None


def matmul_bias(x, w, b):
    """``x @ w + b`` over ``[..., K] @ [K, M]`` with fp32 accumulation, the
    bias added before the one rounding (the qkv leg)."""
    return _MatmulBias.apply(x, w, b)


def matmul_bias_gelu_dropout(x, w, b, *, rate: float = 0.0, seed: int | None = None,
                             deterministic: bool = True, salt: int = SALT_MM_GELU):
    """``dropout(gelu_tanh(x @ w + b))``, the MLP fc leg in one kernel; the
    pre-activation u is kept for the backward only when a grad is wanted.
    ``seed`` is the site's int seed (the JAX entry point draws it from a
    key)."""
    rate, seed = effective_dropout(rate, seed, deterministic)
    want_u = torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, b))
    return _MatmulGelu.apply(x, w, b, rate, seed, salt, want_u)


def matmul_bias_residual_dropout(x, w, b, resid, *, rate: float = 0.0,
                                 seed: int | None = None, deterministic: bool = True,
                                 salt: int = SALT_MM_ATTN_PROJ):
    """``resid + dropout(x @ w + b)``, an out-projection leg with the
    residual add folded into the write-back; the attention and MLP legs
    pass their own salts."""
    rate, seed = effective_dropout(rate, seed, deterministic)
    return _MatmulResid.apply(x, w, b, resid, rate, seed, salt)
