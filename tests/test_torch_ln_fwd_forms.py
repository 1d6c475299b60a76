"""K4's forward (``gpt_2_distributed_torch/csrc/fused_layer.cu``) in the
forms the kernel computes, on the CPU.

The kernel divides a kept o by keep as K6 divides: the product with
fp32(1 / keep) plus one fma correction (``divide_by_keep`` of
``tests/test_torch_gelu_forms.py`` spells it in fp32 torch), with o's sign
copied onto the quotient, and rounds the quotient to bf16. Over every finite
bf16 o that equals the IEEE quotient rounded to bf16, bit for bit, so the
kernel's r, y, mean and rstd keep the bits of a kernel that divides.

The strips of rows the kernel's blocks take (``ln_fwd_strips``) depend on
the row count alone, and ``o=None`` (serving's LayerNorm, which reads no o
and writes no r) gives what ``o = 0`` gives.

Tolerance: none; every comparison here is bit for bit, except the JAX op's,
held within 1e-5 in fp32 as ``tests/test_torch_fused_layer.py`` holds it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gelu_forms import divide_by_keep, every_finite_bf16

from gpt_2_distributed_tpu.ops import fused_layer as jax_fl
from gpt_2_distributed_torch.ops import fused_layer as fl


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).view(torch.int16)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_the_keep_division_rounded_to_bf16_is_the_quotient_rounded(rate):
    """bf16(copysign(div_keep(od), od)) == bf16(od / kp) over every finite
    bf16 od, kp the bf16 keep probability K4 divides by; without the sign
    copy only od = -0 would differ (the fma correction turns -0 into +0)."""
    od = every_finite_bf16()
    kp = fl._keep_prob(rate, torch.bfloat16)
    want = _bits(od / torch.tensor(kp, dtype=torch.float32))
    q = divide_by_keep(od, kp)
    assert torch.equal(_bits(torch.copysign(q, od)), want)
    differ = _bits(q) != want
    assert differ.sum().item() == 1 and od[differ].item() == 0.0
    assert torch.signbit(od[differ]).item()


@pytest.mark.parametrize("n", [1, 7, 8, 9, 960, 4096, 4224, 4225, 8192, 65536])
def test_forward_strips_are_a_function_of_n_only(n):
    """The strips cover the rows, none empty, each of at least
    LN_FWD_MIN_ROWS rows (a row for each of the 8 warps), at most the cap of
    strips; up to N = 4224 a row a warp (at [4096, *] 512 strips of 8 rows),
    at [8192, *] two rows a warp."""
    rows, strips = fl.ln_fwd_strips(n)
    assert rows >= fl.LN_FWD_MIN_ROWS and strips <= fl.LN_FWD_MAX_BLOCKS
    assert (strips - 1) * rows < n <= strips * rows
    if n <= 4224:
        assert rows == fl.LN_FWD_MIN_ROWS
    if n == 4096:
        assert (rows, strips) == (8, 512)
    if n == 8192:
        assert rows == 16


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(40, 96)).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=96)).astype(np.float32)
    bias = (0.1 * rng.normal(size=96)).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_without_o_equals_a_zero_o(arrays, rate, dtype):
    """``o=None`` gives y, mean and rstd bit-equal to ``o = 0`` (at any rate:
    the dropped zero is zero), and r None."""
    x, scale, bias = (torch.from_numpy(a) for a in arrays)
    x = x.to(dtype)
    zero = fl.ln_residual_dropout_plain(x, torch.zeros_like(x), scale, bias, 1e-5, rate, 5)
    none = fl.ln_residual_dropout_plain(x, None, scale, bias, 1e-5, rate, 5)
    assert none[0] is None
    assert all(torch.equal(a, b) for a, b in zip(none[1:], zero[1:]))
    # The wrapper takes CPU tensors to the plain version, o=None included.
    got = fl.ln_residual_dropout_fwd(x, None, scale, bias, 1e-5, rate, 5)
    assert got[0] is None and all(torch.equal(a, b) for a, b in zip(got[1:], zero[1:]))


def test_plain_without_o_matches_the_jax_layer_norm_over_a_zero_branch(arrays):
    """The JAX op at rate 0 on x and a zero o (interpret mode), against the
    port's plain version without o: y within 1e-5 in fp32."""
    x, scale, bias = arrays
    _, y_j = jax_fl.fused_ln_residual_dropout(
        jnp.asarray(x), jnp.zeros_like(jnp.asarray(x)), jnp.asarray(scale),
        jnp.asarray(bias), rate=0.0, rng=jax.random.PRNGKey(0), deterministic=True,
        interpret=True)
    _, y, _, _ = fl.ln_residual_dropout_plain(torch.from_numpy(x), None,
                                              torch.from_numpy(scale),
                                              torch.from_numpy(bias))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=1e-5, rtol=0)
