"""K5's arithmetic (``gpt_2_distributed_torch/csrc/fused_layer.cu``:
``res_drop_fwd_kernel`` and ``drop_scale_kernel``) and K6's sign of zero,
spelled in fp32 torch on the CPU and held bit for bit against the JAX
package's ops, whose Pallas kernels run in interpret mode as the JAX tests
run them.

K5 divides a kept value by kp = bf16(1 - rate) as K4's forward does: the
product with fp32(1 / kp) plus one fma correction (``divide_by_keep`` of
``tests/test_torch_gelu_forms.py``), with the dividend's sign copied onto
the quotient. The forward rounds that quotient to bf16 and adds x (r
rounded to bf16); the rescale rounds it to bf16. Over every finite bf16
input that is the port's plain version's r and do, bit for bit, and the
JAX op's r and its VJP's do wherever the input is not subnormal, with x =
+0, x = -0 (where the sign of a dropped zero shows in r) and x random, at
an odd width. XLA on the CPU takes fp32 subnormal inputs as zeros of their
sign (768 of the finite bf16 values are subnormal); the kernels, built
without fast math, and the plain versions keep them. So the JAX op is held
bit for bit to the same arithmetic on the input with its subnormals taken
as zeros (:func:`as_xla_reads`), and the kernel's arithmetic differs from
the JAX op only at subnormal inputs.

K6 divides its GELU value (forward) and dout (backward) the same way, in
fp32: without the sign copy a kept -0 (u = -0, dout = -0) becomes +0,
where the JAX kernels keep -0.

Tolerance: none; every comparison here is bit for bit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gelu_forms import divide_by_keep, every_finite_bf16, sigmoid_form

from gpt_2_distributed_tpu.ops import fused_layer as jax_fl
from gpt_2_distributed_torch.ops import fused_layer as fl

RATES = [0.1, 0.5]
# Every finite bf16 value fills [ROWS, WIDTH] (65,280 = 256 x 255: an odd
# width, which the kernels take on their masked element path).
ROWS, WIDTH = 256, 255
# x of each kind fills a block of ROWS rows of one [3 ROWS, WIDTH] call; in
# the first block the mask keeps o = -0 at both rates, so a kept -0 meets
# x = -0 there.
X_KINDS = ["-0", "+0", "random"]
BF = torch.bfloat16
TINY = 2.0 ** -126   # the least normal fp32 (and bf16) magnitude


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.to(BF).view(torch.int16)


def _jax_bits(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).view(np.int16).copy())


def _key_and_seed(i: int):
    key = jax.random.PRNGKey(i)
    return key, int(jax_fl.fold_seed(key)[0])


def _x(kind: str) -> torch.Tensor:
    """x as bf16 values in fp32: all +0, all -0, or random from a seed."""
    if kind == "random":
        rng = np.random.default_rng(13)
        return torch.from_numpy(rng.standard_normal((ROWS, WIDTH)).astype(np.float32)).to(
            BF).float()
    return torch.full((ROWS, WIDTH), 0.0 if kind == "+0" else -0.0)


def _every_bf16() -> torch.Tensor:
    v = every_finite_bf16().view(ROWS, WIDTH)
    assert torch.signbit(v[v == 0]).any()   # -0 is among them
    return v


@functools.lru_cache(maxsize=None)
def _jax_k5(rate: float):
    """The JAX op over [3 ROWS, WIDTH]: x of each kind in turn (a block of
    ROWS rows each), o and dr every finite bf16 value in every block. Returns
    (r, do) as bf16 bits, the keep mask, the seed, x and o."""
    key, seed = _key_and_seed(17)
    x = torch.cat([_x(k) for k in X_KINDS])
    o = _every_bf16().repeat(len(X_KINDS), 1)

    def f(x_, o_):
        return jax_fl.fused_residual_dropout(x_, o_, rate=rate, rng=key, deterministic=False)

    xj, oj = (jnp.asarray(t.numpy(), jnp.bfloat16) for t in (x, o))
    r, vjp = jax.vjp(f, xj, oj)
    _, do = vjp(oj)   # dr = o: every finite bf16 value
    keep = fl.epilogue_dropout_mask(seed, fl.SALT_RESID, tuple(x.shape), rate)
    return _jax_bits(r), _jax_bits(do), keep, seed, x, o


def as_xla_reads(v: torch.Tensor) -> torch.Tensor:
    """``v`` with its subnormals as zeros of their sign, as XLA on the CPU
    reads an fp32 input."""
    return torch.where(v.abs() < TINY, torch.copysign(torch.zeros_like(v), v), v)


def k5_forward(x, o, keep, kp, sign_copy=True):
    """r as the kernel forms it from bf16 values held in fp32."""
    q = divide_by_keep(o, kp)
    if sign_copy:
        q = torch.copysign(q, o)
    return (x + torch.where(keep, q.to(BF).float(), 0.0)).to(BF)


def k5_rescale(dr, keep, kp):
    """do as the kernel forms it from bf16 values held in fp32."""
    return torch.where(keep, torch.copysign(divide_by_keep(dr, kp), dr), 0.0).to(BF)


@pytest.mark.parametrize("x_kind", X_KINDS)
@pytest.mark.parametrize("rate", RATES)
def test_k5_forward_is_the_jax_op_bit_for_bit(rate, x_kind):
    """r over every finite bf16 o equals the port's plain version's bit for
    bit, and the JAX op's wherever o is not subnormal; the JAX op's r is
    the same arithmetic on o with its subnormals as zeros. Without the sign
    copy, with x = -0, r differs exactly where a kept o is -0."""
    r_j, _, keep, seed, x, o = _jax_k5(rate)
    plain = fl.residual_dropout_plain(x.to(BF), o.to(BF), rate, seed)
    i = X_KINDS.index(x_kind)
    rows = slice(i * ROWS, (i + 1) * ROWS)
    x, o, keep, r_j, plain = x[rows], o[rows], keep[rows], r_j[rows], plain[rows]
    kp = fl._keep_prob(rate, BF)
    got = k5_forward(x, o, keep, kp)
    assert torch.equal(_bits(plain), _bits(got))
    assert torch.equal(_bits(k5_forward(x, as_xla_reads(o), keep, kp)), r_j)
    normal = o.abs() >= TINY
    assert torch.equal(_bits(got)[normal | (o == 0)], r_j[normal | (o == 0)])
    differ = _bits(k5_forward(x, o, keep, kp, sign_copy=False)) != _bits(got)
    if x_kind == "-0":
        assert torch.equal(differ, keep & (o == 0) & torch.signbit(o)) and differ.any()
    else:
        assert not differ.any()


@pytest.mark.parametrize("rate", RATES)
def test_k5_rescale_is_the_jax_vjp_bit_for_bit(rate):
    """do over every finite bf16 dr, -0 included, equals the port's plain
    version bit for bit, and the JAX op's VJP wherever dr is not subnormal
    (the VJP's do is the same arithmetic on dr with its subnormals as
    zeros); a kept -0 stays -0."""
    _, do_j, keep, seed, _, dr = _jax_k5(rate)
    kp = fl._keep_prob(rate, BF)
    got = k5_rescale(dr, keep, kp)
    assert torch.equal(_bits(fl.dropout_scale_plain(dr.to(BF), rate, seed)), _bits(got))
    assert torch.equal(_bits(k5_rescale(as_xla_reads(dr), keep, kp)), do_j)
    not_sub = (dr.abs() >= TINY) | (dr == 0)
    assert torch.equal(_bits(got)[not_sub], do_j[not_sub])
    neg_zero = keep & (dr == 0) & torch.signbit(dr)
    assert neg_zero.any() and torch.signbit(got[neg_zero].float()).all()


@functools.lru_cache(maxsize=None)
def _k6_at_negative_zero(rate: float):
    """The JAX op and its VJP (interpret mode) at h = b = -0 (u = -0) and
    dout = -0 over [64, 96] bf16: (out, dh) as bits, the keep mask, kp."""
    key, seed = _key_and_seed(19)
    h = jnp.full((64, 96), -0.0, jnp.bfloat16)
    b = jnp.full((96,), -0.0, jnp.bfloat16)

    def f(h_, b_):
        return jax_fl.fused_bias_gelu_dropout(h_, b_, rate=rate, rng=key, deterministic=False)

    out, vjp = jax.vjp(f, h, b)
    dh, _ = vjp(h)   # dout = -0
    keep = fl.epilogue_dropout_mask(seed, fl.SALT_GELU, (64, 96), rate)
    assert keep.any() and not keep.all()
    return _jax_bits(out), _jax_bits(dh), keep, seed, fl._keep_prob(rate, torch.float32)


@pytest.mark.parametrize("rate", RATES)
def test_k6_forward_keeps_the_sign_of_zero(rate):
    """At u = -0 the JAX op writes -0 where kept; K6's spelling with the sign
    copy does too, without it +0. The port's plain version gives -0."""
    out_j, _, keep, seed, kp = _k6_at_negative_zero(rate)
    u = torch.full((64, 96), -0.0)
    g, _ = sigmoid_form(u)
    q = divide_by_keep(g, kp)
    with_copy = torch.where(keep, torch.copysign(q, g), 0.0)
    without = torch.where(keep, q, 0.0)
    assert torch.signbit(out_j.view(BF)[keep].float()).all()
    assert torch.equal(_bits(with_copy), out_j)
    assert not torch.signbit(without[keep]).any()
    plain = fl.bias_gelu_dropout_plain(u.to(BF), torch.full((96,), -0.0).to(BF), rate, seed)
    assert torch.equal(_bits(plain), out_j)


@pytest.mark.parametrize("rate", RATES)
def test_k6_backward_keeps_the_sign_of_zero(rate):
    """At dout = -0 (u = -0, gelu' = 0.5) the JAX VJP's dh is -0 where kept;
    K6's spelling with the sign copy gives -0, without it +0. The port's
    plain version gives -0."""
    _, dh_j, keep, seed, kp = _k6_at_negative_zero(rate)
    u = dout = torch.full((64, 96), -0.0)
    _, gp = sigmoid_form(u)
    q = divide_by_keep(dout, kp)
    with_copy = torch.where(keep, torch.copysign(q, dout), 0.0) * gp
    without = torch.where(keep, q, 0.0) * gp
    assert torch.signbit(dh_j.view(BF)[keep].float()).all()
    assert torch.equal(_bits(with_copy), dh_j)
    assert not torch.signbit(without[keep]).any()
    dh, _ = fl.bias_gelu_dropout_bwd_plain(u.to(BF), torch.full((96,), -0.0).to(BF),
                                           dout.to(BF), rate, seed)
    assert torch.equal(_bits(dh), dh_j)
