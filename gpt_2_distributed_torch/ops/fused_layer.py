"""Fused layer epilogues: LN + residual + dropout (K4), residual + dropout
(K5) and bias + GELU + dropout (K6), as the CUDA kernels of
``csrc/fused_layer.cu``, their plain PyTorch versions and the autograd
functions over them.

Counterpart of ``gpt_2_distributed_tpu/ops/fused_layer.py`` (its Pallas
kernels and custom VJPs). The kernels run on CUDA tensors only; a CPU
tensor goes to the plain version, and a CUDA tensor launches the kernel or
raises. There is no fallback to unfused ops: the kernels take any number
of rows and any width (K4 up to C = 2048, every GPT-2 preset).

Semantics, as the JAX kernels:

* The dropout mask of a site is ``dropout_hash_bits(seed, 0, salt, row,
  col) >= uint32(int(rate * 2^32))`` (``ops/spmd.py``) on the absolute
  flattened row and the feature (:func:`epilogue_dropout_mask`); each op
  has its own salt, and the backward rehashes the forward's mask.
* ``fused_ln_residual_dropout``: ``r = x + dropout(o); y = LN(r)``. The
  dropped ``o / kp`` is rounded to x's dtype with ``kp`` in that dtype (a
  bf16 operand over a weakly typed float: kp = bf16(0.9) = 0.8984375), ``r``
  is rounded to x's dtype, and the statistics are fp32 over that ``r``:
  the mean, then the mean of the squared centered values. The backward
  saves ``(r, mean, rstd, scale)`` and divides in fp32.
* ``fused_residual_dropout``: ``r = x + dropout(o)`` with the same
  rounding; the backward is ``dx = dr`` and ``do = keep * dr / kp`` in dr's
  dtype (K5's rescale kernel). At rate 0 it is the bare ``x + o``.
* ``fused_bias_gelu_dropout``: ``dropout(gelu_tanh(u))`` with ``u = h + b``
  added in h's dtype and the GELU and the division in fp32. The backward
  saves ``(h, b)``. The plain versions spell the GELU in the JAX kernels'
  tanh form; K6 takes it in sigmoid form and divides by a reciprocal with
  an fma correction (``csrc/fused_layer.cu``), which
  ``tests/test_torch_gelu_forms.py`` holds to the tanh form over every
  bf16 u. K4's forward, K5 and K6 copy the dividend's sign onto that
  quotient, so a kept -0 stays -0 as in a true division
  (``tests/test_torch_res_drop_forms.py``).

Each plain version takes ``dtype``, the dtype whose roundings it applies
inside (x's or h's by default). Called on fp32 copies of bf16 values with
``dtype=torch.bfloat16`` it reproduces the kernel's inner roundings and
leaves its outputs unrounded: the fp32 reference a kernel is held to.

Each kernel wrapper's ``launches`` counts kernel launches (never plain
calls), so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from gpt_2_distributed_torch.kernels import build
from gpt_2_distributed_torch.ops.spmd import dropout_hash_bits

# Per-op dropout stream salts, the hash's head coordinate.
SALT_LN_RESID = 1
SALT_RESID = 2
SALT_GELU = 3

# tanh-GELU constants: sqrt(2/pi) and the cubic coefficient.
GELU_C0 = 0.7978845608028654
GELU_A = 0.044715

LN_MAX_WIDTH = 2048          # K4 holds a row in one warp's registers
# K4's forward gives each 8-warp block a contiguous strip of rows, at least
# one row a warp, at most LN_FWD_MAX_BLOCKS strips (:func:`ln_fwd_strips`, a
# function of N only; a row's bits depend on neither): four blocks an SM of
# the H100 (132), so up to N = 4224 every row has its own warp and all are
# in flight at once.
LN_FWD_MAX_BLOCKS = 528
LN_FWD_MIN_ROWS = 8
# The backward kernels of K4 and K6 give each block a contiguous strip of
# rows, at least two rows for each of its 8 warps, and sum their columns
# over the strips in a second pass. The strips are a function of N only
# (:func:`bwd_strips`), so the column sums' order, and their bits, depend
# on neither the card nor the width. K4: at most one block an SM of the
# H100 (132). K6: 32 strips, each cut into 256-feature slabs, so 384 blocks
# at [4096, 3072], all resident at three blocks an SM.
LN_BWD_MAX_BLOCKS = 132
GELU_BWD_MAX_STRIPS = 32
BWD_MIN_ROWS = 16

_P, _I, _U32, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_DROP = [_U32, _U32, _U32, _F, _P]   # seed, salt, threshold, keep, stream
_SIGNATURES = {
    "ln_res_fwd_bf16": [_P] * 8 + [_I, _I, _I, _F] + _DROP,
    "ln_res_bwd_bf16": [_P] * 10 + [_I, _I, _I] + _DROP,
    "res_drop_fwd_bf16": [_P] * 3 + [_I, _I] + _DROP,
    "drop_scale_bf16": [_P] * 2 + [_I, _I] + _DROP,
    "bias_gelu_fwd_bf16": [_P] * 3 + [_I, _I] + _DROP,
    "bias_gelu_bwd_bf16": [_P] * 6 + [_I, _I, _I] + _DROP,
}


def epilogue_dropout_mask(seed: int, salt: int, shape: tuple[int, int], rate: float,
                          device=None) -> torch.Tensor:
    """The bool keep-mask ``[n, c]`` a fused kernel applies at ``rate``
    (the JAX function, bit for bit, for the same seed). ``seed`` may be a
    negative int32: its uint32 bits are hashed."""
    n, c = shape
    rows = torch.arange(n, dtype=torch.int64, device=device).view(n, 1)
    cols = torch.arange(c, dtype=torch.int64, device=device).view(1, c)
    return dropout_hash_bits(seed, 0, salt, rows, cols) >= int(rate * (2 ** 32))


def _keep_prob(rate: float, dtype: torch.dtype) -> float:
    """1 - rate as ``dtype`` holds it (bf16: 0.8984375 at rate 0.1)."""
    return float(torch.tensor(1.0 - rate, dtype=dtype))


def _divide(v: torch.Tensor, kp: float) -> torch.Tensor:
    """fp32 ``v / kp``, a true division: a CUDA tensor over a Python scalar
    is computed as a product with the reciprocal."""
    return v / torch.tensor(kp, dtype=torch.float32, device=v.device)


def _round(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 ``v`` rounded to ``dtype``, held in fp32."""
    return v.to(dtype).float()


def dropped(v, rate, seed, salt, kp):
    """fp32 ``keep * v / kp`` of a site's mask."""
    keep = epilogue_dropout_mask(seed, salt, tuple(v.shape), rate, v.device)
    return torch.where(keep, _divide(v, kp), 0.0)


# --- plain versions ---------------------------------------------------------


def ln_residual_dropout_plain(x, o, scale, bias, eps=1e-5, rate=0.0, seed=None,
                              salt=SALT_LN_RESID, dtype=None):
    """K4's forward over ``[N, C]``: ``(r, y, mean, rstd)``, r and y in x's
    dtype, mean and rstd fp32 ``[N]``. ``o=None`` stands for ``o = 0`` and
    returns ``r = None``."""
    dtype = dtype or x.dtype
    od = torch.zeros_like(x, dtype=torch.float32) if o is None else o.float()
    if rate > 0.0:
        od = _round(dropped(od, rate, seed, salt, _keep_prob(rate, dtype)), dtype)
    r = _round(x.float() + od, dtype)
    mean = r.mean(dim=-1, keepdim=True)
    cent = r - mean
    rstd = torch.rsqrt(cent.square().mean(dim=-1, keepdim=True) + eps)
    y = cent * rstd * scale.float() + bias.float()
    return (None if o is None else r.to(x.dtype)), y.to(x.dtype), mean[:, 0], rstd[:, 0]


def ln_residual_dropout_bwd_plain(r, mean, rstd, scale, dr, dy, rate=0.0, seed=None,
                                  salt=SALT_LN_RESID):
    """K4's backward: ``(dx, do, dscale, dbias)``, dx and do in r's dtype,
    the column sums fp32."""
    rstd = rstd[:, None]
    rhat = (r.float() - mean[:, None]) * rstd
    dyf = dy.float()
    g = dyf * scale.float()
    m1 = g.mean(dim=-1, keepdim=True)
    m2 = (g * rhat).mean(dim=-1, keepdim=True)
    dr_tot = dr.float() + rstd * (g - m1 - rhat * m2)
    do = dropped(dr_tot, rate, seed, salt, _keep_prob(rate, torch.float32)) \
        if rate > 0.0 else dr_tot
    return (dr_tot.to(r.dtype), do.to(r.dtype), (dyf * rhat).sum(dim=0),
            dyf.sum(dim=0))


def residual_dropout_plain(x, o, rate, seed, salt=SALT_RESID, dtype=None):
    """K5's forward: ``x + dropout(o)`` in x's dtype."""
    dtype = dtype or x.dtype
    od = _round(dropped(o.float(), rate, seed, salt, _keep_prob(rate, dtype)), dtype)
    return (x.float() + od).to(x.dtype)


def dropout_scale_plain(dr, rate, seed, salt=SALT_RESID, dtype=None):
    """K5's backward rescale: ``keep * dr / kp`` with kp in ``dtype``."""
    dtype = dtype or dr.dtype
    return dropped(dr.float(), rate, seed, salt, _keep_prob(rate, dtype)).to(dr.dtype)


def gelu_core(u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """tanh-GELU of fp32 ``u``: ``(g, t)`` with t the tanh."""
    t = torch.tanh(GELU_C0 * (u + GELU_A * u * u * u))
    return 0.5 * u * (1.0 + t), t


def gelu_grad(u: torch.Tensor) -> torch.Tensor:
    """d/du of the tanh-GELU of fp32 ``u``, as the JAX kernels spell it."""
    _, t = gelu_core(u)
    return 0.5 * (1.0 + t) + 0.5 * u * (1.0 - t * t) * GELU_C0 * (1.0 + 3.0 * GELU_A * u * u)


def bias_gelu_dropout_plain(h, b, rate=0.0, seed=None, salt=SALT_GELU, dtype=None):
    """K6's forward over ``[N, F]``: ``dropout(gelu_tanh(h + b))`` in h's
    dtype."""
    dtype = dtype or h.dtype
    g, _ = gelu_core(_round(h.float() + b.float(), dtype))
    if rate > 0.0:
        g = dropped(g, rate, seed, salt, _keep_prob(rate, torch.float32))
    return g.to(h.dtype)


def bias_gelu_dropout_bwd_plain(h, b, dout, rate=0.0, seed=None, salt=SALT_GELU,
                                dtype=None):
    """K6's backward: ``(dh, db)``, dh in h's dtype, db (the fp32 column sum
    of dh) in b's dtype."""
    dtype = dtype or h.dtype
    gp = gelu_grad(_round(h.float() + b.float(), dtype))
    dg = dout.float()
    if rate > 0.0:
        dg = dropped(dg, rate, seed, salt, _keep_prob(rate, torch.float32))
    du = dg * gp
    return du.to(h.dtype), du.sum(dim=0).to(b.dtype)


# --- kernel wrappers --------------------------------------------------------


def check_operand(name: str, x: torch.Tensor, shape, dtype, device,
                  kernel: str = "fused_layer") -> None:
    """Raise unless ``x`` is a contiguous ``shape`` tensor of ``dtype`` on
    ``device``: what a kernel of ``csrc/<kernel>.cu`` takes."""
    if x.dtype != dtype:
        raise TypeError(f"{kernel} kernel: {name} must be {str(dtype)[6:]}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{kernel} kernel: {name} shape {tuple(x.shape)} != {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{kernel} kernel: {name} must be contiguous")
    if x.device != device:
        raise ValueError(f"{kernel} kernel: {name} on {x.device}, not {device}")


def _dropout_words(rate: float, seed: int | None, salt: int, kp: float):
    """(seed as uint32, salt, keep threshold, keep probability); threshold 0
    keeps everything."""
    if rate <= 0.0:
        return 0, salt, 0, 1.0
    if seed is None:
        raise ValueError("fused_layer dropout requires a seed")
    return seed & 0xFFFFFFFF, salt, int(rate * (2 ** 32)), kp


def ln_fwd_strips(n: int) -> tuple[int, int]:
    """(rows a strip, strips) of K4's forward over ``n`` rows: at most
    ``LN_FWD_MAX_BLOCKS`` strips of at least ``LN_FWD_MIN_ROWS`` rows."""
    rows = max(LN_FWD_MIN_ROWS, -(-n // LN_FWD_MAX_BLOCKS))
    return rows, -(-n // rows)


def bwd_strips(n: int, max_strips: int) -> tuple[int, int]:
    """(rows a strip, strips) of a backward kernel over ``n`` rows: at most
    ``max_strips`` strips of at least ``BWD_MIN_ROWS`` rows."""
    rows = max(BWD_MIN_ROWS, -(-n // max_strips))
    return rows, -(-n // rows)


def _launch(fn: str, *args) -> None:
    lib = build.load("fused_layer", _SIGNATURES)
    build.check(getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream), fn)


def ln_residual_dropout_fwd(x, o, scale, bias, eps=1e-5, rate=0.0, seed=None,
                            salt=SALT_LN_RESID):
    """``(r, y, mean, rstd)`` of K4 over ``[N, C]``: CUDA tensors launch the
    kernel over strips of rows (:func:`ln_fwd_strips`; bf16 x and o, fp32
    scale and bias), CPU tensors use the plain version. ``o=None`` stands
    for ``o = 0``: the kernel then reads no o and writes no r, and ``r`` is
    None."""
    if not x.is_cuda:
        return ln_residual_dropout_plain(x, o, scale, bias, eps, rate, seed, salt)
    n, c = x.shape
    if c > LN_MAX_WIDTH:
        raise ValueError(f"fused_layer kernel: LayerNorm width {c} > {LN_MAX_WIDTH}")
    for name, t, shape, dtype in (("x", x, (n, c), torch.bfloat16),
                                  ("o", o, (n, c), torch.bfloat16),
                                  ("scale", scale, (c,), torch.float32),
                                  ("bias", bias, (c,), torch.float32)):
        if t is not None:
            check_operand(name, t, shape, dtype, x.device)
    r = None if o is None else torch.empty_like(x)
    y = torch.empty_like(x)
    mean = torch.empty(n, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    with torch.cuda.device(x.device):
        _launch("ln_res_fwd_bf16", x.data_ptr(), None if o is None else o.data_ptr(),
                scale.data_ptr(), bias.data_ptr(), None if r is None else r.data_ptr(),
                y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), n, c, ln_fwd_strips(n)[0],
                eps, *_dropout_words(rate, seed, salt, _keep_prob(rate, x.dtype)))
    ln_residual_dropout_fwd.launches += 1
    return r, y, mean, rstd


ln_residual_dropout_fwd.launches = 0


def ln_residual_dropout_bwd(r, mean, rstd, scale, dr, dy, rate=0.0, seed=None,
                            salt=SALT_LN_RESID):
    """``(dx, do, dscale, dbias)`` of K4's backward (the column sums fp32):
    CUDA tensors launch the kernel and its fixed-order column-sum pass, CPU
    tensors use the plain version."""
    if not r.is_cuda:
        return ln_residual_dropout_bwd_plain(r, mean, rstd, scale, dr, dy, rate, seed, salt)
    n, c = r.shape
    if c > LN_MAX_WIDTH:
        raise ValueError(f"fused_layer kernel: LayerNorm width {c} > {LN_MAX_WIDTH}")
    for name, t, shape, dtype in (("r", r, (n, c), torch.bfloat16),
                                  ("mean", mean, (n,), torch.float32),
                                  ("rstd", rstd, (n,), torch.float32),
                                  ("scale", scale, (c,), torch.float32),
                                  ("dr", dr, (n, c), torch.bfloat16),
                                  ("dy", dy, (n, c), torch.bfloat16)):
        check_operand(name, t, shape, dtype, r.device)
    dx, do = torch.empty_like(r), torch.empty_like(r)
    rows, blocks = bwd_strips(n, LN_BWD_MAX_BLOCKS)   # a strip a block
    partial = torch.empty((blocks, 2 * c), dtype=torch.float32, device=r.device)
    sums = torch.empty(2 * c, dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        _launch("ln_res_bwd_bf16", r.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                scale.data_ptr(), dr.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                do.data_ptr(), partial.data_ptr(), sums.data_ptr(), n, c, rows,
                *_dropout_words(rate, seed, salt, _keep_prob(rate, torch.float32)))
    ln_residual_dropout_bwd.launches += 1
    return dx, do, sums[:c], sums[c:]


ln_residual_dropout_bwd.launches = 0


def _elementwise(fn: str, wrapper, out_like, operands: dict, rate, seed, salt, kp):
    """Launch one of K5's kernels or K6's forward on ``[N, width]`` bf16
    operands (the first one's shape), count it on ``wrapper`` and return
    its ``[N, width]`` output."""
    first = next(iter(operands.values()))
    n, w = first.shape
    for name, t in operands.items():
        check_operand(name, t, (w,) if name == "b" else (n, w), torch.bfloat16, first.device)
    out = torch.empty_like(out_like)
    with torch.cuda.device(first.device):
        _launch(fn, *(t.data_ptr() for t in operands.values()), out.data_ptr(), n, w,
                *_dropout_words(rate, seed, salt, kp))
    wrapper.launches += 1
    return out


def residual_dropout_fwd(x, o, rate, seed, salt=SALT_RESID):
    """K5: ``x + dropout(o)`` over ``[N, C]``; CUDA tensors launch the kernel
    (bf16), CPU tensors use the plain version."""
    if not x.is_cuda:
        return residual_dropout_plain(x, o, rate, seed, salt)
    return _elementwise("res_drop_fwd_bf16", residual_dropout_fwd, x, {"x": x, "o": o},
                        rate, seed, salt, _keep_prob(rate, x.dtype))


residual_dropout_fwd.launches = 0


def dropout_scale(dr, rate, seed, salt=SALT_RESID):
    """K5's backward rescale ``keep * dr / kp`` over ``[N, C]``; CUDA tensors
    launch the kernel (bf16), CPU tensors use the plain version."""
    if not dr.is_cuda:
        return dropout_scale_plain(dr, rate, seed, salt)
    return _elementwise("drop_scale_bf16", dropout_scale, dr, {"dr": dr},
                        rate, seed, salt, _keep_prob(rate, dr.dtype))


dropout_scale.launches = 0


def bias_gelu_dropout_fwd(h, b, rate=0.0, seed=None, salt=SALT_GELU):
    """K6: ``dropout(gelu_tanh(h + b))`` over ``[N, F]``; CUDA tensors launch
    the kernel (bf16 h and b), CPU tensors use the plain version."""
    if not h.is_cuda:
        return bias_gelu_dropout_plain(h, b, rate, seed, salt)
    return _elementwise("bias_gelu_fwd_bf16", bias_gelu_dropout_fwd, h, {"h": h, "b": b},
                        rate, seed, salt, _keep_prob(rate, torch.float32))


bias_gelu_dropout_fwd.launches = 0


def bias_gelu_dropout_bwd(h, b, dout, rate=0.0, seed=None, salt=SALT_GELU):
    """``(dh, db)`` of K6's backward; CUDA tensors launch the kernel over
    strips of rows (:func:`bwd_strips`) and the fixed-order column-sum pass,
    CPU tensors use the plain version."""
    if not h.is_cuda:
        return bias_gelu_dropout_bwd_plain(h, b, dout, rate, seed, salt)
    n, f = h.shape
    for name, t, shape in (("h", h, (n, f)), ("b", b, (f,)), ("dout", dout, (n, f))):
        check_operand(name, t, shape, torch.bfloat16, h.device)
    dh = torch.empty_like(h)
    db = torch.empty_like(b)
    rows, strips = bwd_strips(n, GELU_BWD_MAX_STRIPS)
    partial = torch.empty((strips, f), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        _launch("bias_gelu_bwd_bf16", h.data_ptr(), b.data_ptr(), dout.data_ptr(),
                dh.data_ptr(), partial.data_ptr(), db.data_ptr(), n, f, rows,
                *_dropout_words(rate, seed, salt, _keep_prob(rate, torch.float32)))
    bias_gelu_dropout_bwd.launches += 1
    return dh, db


bias_gelu_dropout_bwd.launches = 0


# --- autograd functions and entry points ------------------------------------


def as_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as contiguous ``[N, width]`` rows."""
    return t.reshape(-1, t.shape[-1]).contiguous()


class _LnResidualDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, o, scale, bias, eps, rate, seed, salt):
        r, y, mean, rstd = ln_residual_dropout_fwd(as_rows(x), as_rows(o), scale, bias,
                                                   eps, rate, seed, salt)
        ctx.save_for_backward(r, mean, rstd, scale)
        ctx.dropout = (rate, seed, salt)
        ctx.bias_dtype = bias.dtype
        return r.view(x.shape), y.view(x.shape)

    @staticmethod
    def backward(ctx, dr, dy):
        r, mean, rstd, scale = ctx.saved_tensors
        dx, do, dscale, dbias = ln_residual_dropout_bwd(
            r, mean, rstd, scale, as_rows(dr), as_rows(dy), *ctx.dropout)
        return (dx.view(dr.shape), do.view(dr.shape), dscale.to(scale.dtype),
                dbias.to(ctx.bias_dtype), None, None, None, None)


class _ResidualDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, o, rate, seed, salt):
        ctx.dropout = (rate, seed, salt)
        return residual_dropout_fwd(as_rows(x), as_rows(o), rate, seed, salt).view(x.shape)

    @staticmethod
    def backward(ctx, dr):
        do = dropout_scale(as_rows(dr), *ctx.dropout).view(dr.shape)
        return dr, do, None, None, None


class _BiasGeluDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, b, rate, seed, salt):
        h2 = as_rows(h)
        ctx.save_for_backward(h2, b)
        ctx.dropout = (rate, seed, salt)
        return bias_gelu_dropout_fwd(h2, b, rate, seed, salt).view(h.shape)

    @staticmethod
    def backward(ctx, dout):
        h, b = ctx.saved_tensors
        dh, db = bias_gelu_dropout_bwd(h, b, as_rows(dout), *ctx.dropout)
        return dh.view(dout.shape), db, None, None, None


def effective_dropout(rate: float, seed: int | None,
                      deterministic: bool) -> tuple[float, int | None]:
    """The rate that applies (0 unless training with a seed) and its seed."""
    if deterministic or seed is None or rate <= 0.0:
        return 0.0, None
    return float(rate), int(seed)


def fused_ln_residual_dropout(x, o, scale, bias, *, eps: float = 1e-5,
                              rate: float = 0.0, seed: int | None = None,
                              deterministic: bool = True,
                              salt: int = SALT_LN_RESID):
    """``r = x + dropout(o); y = layer_norm(r, scale, bias)`` over ``[..., C]``
    in one pass; returns ``(r, y)``. ``seed`` is the site's int seed (the
    JAX entry point draws it from a key)."""
    rate, seed = effective_dropout(rate, seed, deterministic)
    return _LnResidualDropout.apply(x, o, scale, bias, float(eps), rate, seed, salt)


def fused_residual_dropout(x, o, *, rate: float = 0.0, seed: int | None = None,
                           deterministic: bool = True, salt: int = SALT_RESID):
    """``x + dropout(o)`` over ``[..., C]`` with the in-kernel mask; the bare
    ``x + o`` when dropout is inactive."""
    rate, seed = effective_dropout(rate, seed, deterministic)
    if rate == 0.0:
        return x + o
    return _ResidualDropout.apply(x, o, rate, seed, salt)


def fused_bias_gelu_dropout(h, b, *, rate: float = 0.0, seed: int | None = None,
                            deterministic: bool = True, salt: int = SALT_GELU):
    """``dropout(gelu_tanh(h + b))`` over ``[..., F]``, the MLP activation
    epilogue; the GELU runs in fp32."""
    rate, seed = effective_dropout(rate, seed, deterministic)
    return _BiasGeluDropout.apply(h, b, rate, seed, salt)
