"""The port's fused layer epilogues (``gpt_2_distributed_torch/ops/fused_layer.py``)
against the JAX ops of ``gpt_2_distributed_tpu/ops/fused_layer.py``, whose
Pallas kernels run in interpret mode on the CPU. Inputs are made with numpy
from a seed; the JAX op folds its key to an int32 seed with ``fold_seed``,
and the port takes that seed. On the CPU the port runs its plain versions
(the kernels have no CPU build), so these tests hold the plain versions'
arithmetic, masks and autograd to the JAX kernels and custom VJPs.

Shapes are N, C, F = 64, 96, 192, not multiples of 128, as in
``tests/test_fused_layer.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_2_distributed_tpu.ops import fused_layer as jax_fl
from gpt_2_distributed_torch.ops import fused_layer as fl
from gpt_2_distributed_torch.ops.activations import gelu_tanh
from gpt_2_distributed_torch.ops.layers import layer_norm

N, C, F = 64, 96, 192
RATES = [0.0, 0.1]
# fp32 on both sides; the sums (LayerNorm statistics, dscale/dbias/db over
# rows) run in another order, ~1e-7 on values and grads of order 1.
FP32_TOL = 1e-5
# The bf16 outputs of the JAX LayerNorm and GELU kernels, run by XLA on the
# CPU, lie several bf16 ulps from the fp32 arithmetic their code spells
# (0.03125 at |y| in [2, 4) for the LayerNorm, 0.0078 at 0.29 for the
# GELU); tests/test_fused_layer.py holds them to the unfused ops within
# 0.04 and 0.05 for that reason. The port's outputs are held to those
# bounds against JAX, and to one rounding (2^-8 of the value) of the same
# arithmetic in float64 on the same bf16 r or u.
LN_BF16_ATOL = 0.04
GELU_BF16_ATOL = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return {
        "x": normal(N, C, scale=0.5), "o": normal(N, C, scale=0.5),
        "scale": 1.0 + normal(C, scale=0.1), "bias": normal(C, scale=0.1),
        "dr": normal(N, C), "dy": normal(N, C),
        "h": normal(N, F), "b": normal(F, scale=0.1), "dout": normal(N, F),
    }


def _key_and_seed(i: int):
    key = jax.random.PRNGKey(i)
    return key, int(jax_fl.fold_seed(key)[0])


def _t(a, dtype=torch.float32, grad=False):
    return torch.from_numpy(a).to(dtype).requires_grad_(grad)


def _close(got, want, what, tol=FP32_TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=tol, rtol=0, err_msg=what)


# Seeds at and above 2^31: the JAX seed is an int32 array whose uint32
# bits are hashed, the port's an int.
@pytest.mark.parametrize("salt", [fl.SALT_LN_RESID, fl.SALT_RESID, fl.SALT_GELU])
@pytest.mark.parametrize("seed", [0, 0x7FFFFFFF, 0x80000000, 0xDEADBEEF])
def test_epilogue_dropout_mask_bit_exact(salt, seed):
    shape = (300, 160)
    jseed = jnp.asarray(np.array([seed], np.uint32).view(np.int32))
    want = np.asarray(jax_fl.epilogue_dropout_mask(jseed, salt, shape, 0.1))
    got = fl.epilogue_dropout_mask(seed, salt, shape, 0.1).numpy()
    np.testing.assert_array_equal(got, want)
    # The same seed as a negative int32 hashes the same bits.
    signed = int(np.array([seed], np.uint32).view(np.int32)[0])
    np.testing.assert_array_equal(fl.epilogue_dropout_mask(signed, salt, shape, 0.1).numpy(),
                                  want)


@pytest.mark.parametrize("rate", RATES)
def test_ln_residual_dropout_fwd_and_grads_match_jax(arrays, rate):
    a = arrays
    key, seed = _key_and_seed(3)

    def f(x, o, scale, bias):
        return jax_fl.fused_ln_residual_dropout(x, o, scale, bias, rate=rate, rng=key,
                                                deterministic=False)

    (r_j, y_j), vjp = jax.vjp(f, *(jnp.asarray(a[k]) for k in ("x", "o", "scale", "bias")))
    grads_j = vjp((jnp.asarray(a["dr"]), jnp.asarray(a["dy"])))
    x, o, scale, bias = (_t(a[k], grad=True) for k in ("x", "o", "scale", "bias"))
    before = fl.ln_residual_dropout_bwd.launches
    r, y = fl.fused_ln_residual_dropout(x, o, scale, bias, rate=rate, seed=seed,
                                        deterministic=False)
    grads = torch.autograd.grad((r, y), (x, o, scale, bias), (_t(a["dr"]), _t(a["dy"])))
    assert fl.ln_residual_dropout_bwd.launches == before   # plain, no kernel
    _close(r, r_j, "r")
    _close(y, y_j, "y")
    for name, g, gj in zip(("dx", "do", "dscale", "dbias"), grads, grads_j):
        _close(g, gj, name)


@pytest.mark.parametrize("rate", RATES)
def test_residual_dropout_fwd_and_grads_match_jax(arrays, rate):
    a = arrays
    key, seed = _key_and_seed(5)

    def f(x, o):
        return jax_fl.fused_residual_dropout(x, o, rate=rate, rng=key, deterministic=False)

    r_j, vjp = jax.vjp(f, jnp.asarray(a["x"]), jnp.asarray(a["o"]))
    grads_j = vjp(jnp.asarray(a["dr"]))
    x, o = _t(a["x"], grad=True), _t(a["o"], grad=True)
    r = fl.fused_residual_dropout(x, o, rate=rate, seed=seed, deterministic=False)
    grads = torch.autograd.grad(r, (x, o), _t(a["dr"]))
    _close(r, r_j, "r")
    for name, g, gj in zip(("dx", "do"), grads, grads_j):
        _close(g, gj, name)


@pytest.mark.parametrize("rate", RATES)
def test_bias_gelu_dropout_fwd_and_grads_match_jax(arrays, rate):
    a = arrays
    key, seed = _key_and_seed(7)

    def f(h, b):
        return jax_fl.fused_bias_gelu_dropout(h, b, rate=rate, rng=key, deterministic=False)

    out_j, vjp = jax.vjp(f, jnp.asarray(a["h"]), jnp.asarray(a["b"]))
    grads_j = vjp(jnp.asarray(a["dout"]))
    h, b = _t(a["h"], grad=True), _t(a["b"], grad=True)
    out = fl.fused_bias_gelu_dropout(h, b, rate=rate, seed=seed, deterministic=False)
    grads = torch.autograd.grad(out, (h, b), _t(a["dout"]))
    _close(out, out_j, "out")
    for name, g, gj in zip(("dh", "db"), grads, grads_j):
        _close(g, gj, name)


@pytest.mark.parametrize("op", ["ln_residual", "residual", "bias_gelu"])
def test_fused_ops_bf16_track_jax(arrays, op):
    """bf16 operands at rate 0.1: the bf16 roundings inside (the dropped o
    over bf16(0.9), r = x + o, u = h + b) land where the JAX kernels put
    them, so the residual stream and K5's backward agree bit for bit."""
    a = arrays
    key, seed = _key_and_seed(11)
    kw = dict(rate=0.1, deterministic=False)
    j = {k: jnp.asarray(v, jnp.bfloat16) for k, v in a.items()}
    t = {k: _t(v, torch.bfloat16) for k, v in a.items()}
    if op == "ln_residual":
        scale, bias = jnp.asarray(a["scale"]), jnp.asarray(a["bias"])   # fp32, as the model's
        r_j, y_j = jax_fl.fused_ln_residual_dropout(j["x"], j["o"], scale, bias, rng=key, **kw)
        r, y = fl.fused_ln_residual_dropout(t["x"], t["o"], _t(a["scale"]), _t(a["bias"]),
                                            seed=seed, **kw)
        assert r.dtype == y.dtype == torch.bfloat16
        np.testing.assert_array_equal(r.float().numpy(), np.asarray(r_j, np.float32))
        np.testing.assert_allclose(y.float().numpy(), np.asarray(y_j, np.float32),
                                   atol=LN_BF16_ATOL, rtol=0)
        r64 = r.double().numpy()
        cent = r64 - r64.mean(-1, keepdims=True)
        y64 = cent / np.sqrt((cent ** 2).mean(-1, keepdims=True) + 1e-5) * a["scale"] + a["bias"]
        np.testing.assert_allclose(y.double().numpy(), y64, rtol=2.0 ** -8, atol=1e-6)
    elif op == "residual":
        r_j = jax_fl.fused_residual_dropout(j["x"], j["o"], rng=key, **kw)
        r = fl.fused_residual_dropout(t["x"], t["o"], seed=seed, **kw)
        np.testing.assert_array_equal(r.float().numpy(), np.asarray(r_j, np.float32))
        _, vjp = jax.vjp(lambda o: jax_fl.fused_residual_dropout(j["x"], o, rng=key, **kw),
                         j["o"])
        o = t["o"].requires_grad_()
        (do,) = torch.autograd.grad(fl.fused_residual_dropout(t["x"], o, seed=seed, **kw),
                                    o, t["dr"])
        np.testing.assert_array_equal(do.float().numpy(),
                                      np.asarray(vjp(j["dr"])[0], np.float32))
    else:
        out_j = jax_fl.fused_bias_gelu_dropout(j["h"], j["b"], rng=key, **kw)
        out = fl.fused_bias_gelu_dropout(t["h"], t["b"], seed=seed, **kw)
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(), np.asarray(out_j, np.float32),
                                   atol=GELU_BF16_ATOL, rtol=0)
        u = (t["h"] + t["b"]).double().numpy()
        g = 0.5 * u * (1 + np.tanh(fl.GELU_C0 * (u + fl.GELU_A * u ** 3)))
        keep = fl.epilogue_dropout_mask(seed, fl.SALT_GELU, (N, F), 0.1).numpy()
        np.testing.assert_allclose(out.double().numpy(), np.where(keep, g / 0.9, 0.0),
                                   rtol=2.0 ** -8, atol=1e-6)


def test_fused_ops_equal_the_unfused_ops_at_rate_zero(arrays):
    """At rate 0 the fused ops compute the unfused model's ops: LayerNorm of
    the sum (fp32, 1e-5: another order of the same sums), the tanh GELU of
    the biased input, and the bare residual add."""
    a = arrays
    x, o, scale, bias = (_t(a[k]) for k in ("x", "o", "scale", "bias"))
    r, y = fl.fused_ln_residual_dropout(x, o, scale, bias, rate=0.1, seed=3)  # deterministic
    assert torch.equal(r, x + o)
    torch.testing.assert_close(y, layer_norm(x + o, scale, bias), atol=FP32_TOL, rtol=0)
    assert torch.equal(fl.fused_residual_dropout(x, o, rate=0.1, seed=3), x + o)
    h, b = _t(a["h"]), _t(a["b"])
    torch.testing.assert_close(fl.fused_bias_gelu_dropout(h, b), gelu_tanh(h + b),
                               atol=FP32_TOL, rtol=0)
