"""K6's arithmetic (``gpt_2_distributed_torch/csrc/fused_layer.cu``) over
every finite bf16 input, on the CPU.

K6 computes ``dropout(gelu_tanh(u))`` and its derivative with u =
bf16(h + b), so it is a function of one 16-bit input: the 65,280 finite
bf16 values are all of its inputs. The kernels take the GELU in sigmoid
form, 0.5 (1 + tanh z) = 1 / (1 + 2^(-2 z log2 e)) with z = c0 (u + a u^3),
and divide by keep as a product with fp32(1 / keep) plus one fma
correction. :func:`sigmoid_form` and :func:`divide_by_keep` spell that
arithmetic in fp32 torch (exp2 and the reciprocal exact where the card's
are approximate, each within ~2^-22 of its value). These tests hold the
spelling against the port's plain versions (the JAX kernels' tanh form,
``gelu_core``/``gelu_grad``) and against the JAX package's
``fused_bias_gelu_dropout`` and its VJP, whose Pallas kernels run in
interpret mode as the JAX tests run them.

Tolerance: the element bound of ``chip_smoke.py``, |x - ref| <= 2^-8 |ref|
+ 2^-16, on the spelling rounded to bf16 (the kernels write bf16) against
the reference in fp32. The two forms differ in fp32 only where the tanh
form cancels (1 + t for u in [-10, -3], an absolute error below 1e-5), so
the bound is the bf16 rounding's. Where the reference is not finite in bf16
(gelu' is 0 x inf for |u| >~ 5e19 in both forms), both are the same NaN or
inf.

The last test holds the backward's strips (``bwd_strips``) to be a
function of the row count alone, so db's summation order, and its bits, do
not depend on the width or the card.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_2_distributed_tpu.ops import fused_layer as jax_fl
from gpt_2_distributed_torch.ops import fused_layer as fl

LOG2E = 1.4426950408889634
# The kernels' constants, each formed in double and rounded to fp32 once.
GELU_K = float(np.float32(-2.0 * LOG2E * fl.GELU_C0))
GELU_KA = float(np.float32(-2.0 * LOG2E * fl.GELU_C0 * fl.GELU_A))
GELU_2C0 = float(np.float32(2.0 * fl.GELU_C0))
GELU_3A = float(np.float32(3.0 * fl.GELU_A))

REL_TOL, ABS_TOL = 2.0 ** -8, 2.0 ** -16
COLSUM_TOL = 2.0 ** -11   # N 2^-24 sum|t| for N <= 4096 rows, as chip_smoke.py
RATES = [0.0, 0.1]
ROWS, WIDTH = 64, 1024


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def every_finite_bf16() -> torch.Tensor:
    """The 65,280 finite bf16 values, ascending in bit order, as fp32."""
    u = torch.arange(2 ** 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16).float()
    return u[torch.isfinite(u)]


def sigmoid_form(u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K6's ``(gelu(u), gelu'(u))`` of fp32 ``u`` as the kernels spell it:
    s = 1 / (1 + 2^(u (K + KA u^2))), g = u s, gelu' = s + 2 c0 u s (1 - s)
    (1 + 3a u u), the last product in the JAX kernel's order."""
    s = 1.0 / (1.0 + torch.exp2(u * (GELU_KA * (u * u) + GELU_K)))
    return u * s, (GELU_2C0 * u * s * (1.0 - s)) * ((GELU_3A * u) * u + 1.0) + s


def divide_by_keep(v: torch.Tensor, kp: float) -> torch.Tensor:
    """fp32 ``v / kp`` as the kernels form it: q = v * fp32(1 / kp), then
    q + fma(-q, kp, v) / kp with the remainder's fma formed exactly in
    float64 (the 48-bit products are exact there); no correction where q
    overflows."""
    keep = torch.tensor(kp, dtype=torch.float32)
    rk = torch.tensor(1.0, dtype=torch.float32) / keep
    q = v * rk
    rem = (v.double() - q.double() * keep.double()).float()
    out = (rem.double() * rk.double() + q.double()).float()
    return torch.where(torch.isinf(q), q, out)


def _holds(got: torch.Tensor, ref: torch.Tensor, tol: torch.Tensor | None = None) -> None:
    """``got`` (the spelling, rounded to bf16 here) within ``tol`` (default
    the element bound) of fp32 ``ref`` wherever ``ref`` is finite in bf16,
    and the same NaN or inf everywhere else."""
    got = got.to(torch.bfloat16).float()
    ref16 = ref.to(torch.bfloat16).float()
    fin = torch.isfinite(ref16)
    for kind in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(kind(got[~fin]), kind(ref16[~fin]))
    if tol is None:
        tol = REL_TOL * ref.abs() + ABS_TOL
    assert fin.any()
    ratio = ((got - ref).abs() / tol)[fin]
    assert ratio.max().item() <= 1.0, f"max err/tol {ratio.max().item():.3f}"


def test_sigmoid_form_holds_the_tanh_form_over_every_bf16_u():
    u = every_finite_bf16()
    assert u.numel() == 65280
    g, gp = sigmoid_form(u)
    g_ref, _ = fl.gelu_core(u)
    gp_ref = fl.gelu_grad(u)
    _holds(g, g_ref)
    _holds(gp, gp_ref)
    # The bits differ only in the negative tail, where 1 + t cancels.
    for got, ref in ((g, g_ref), (gp, gp_ref)):
        fin = torch.isfinite(ref)
        differ = fin & (got.to(torch.bfloat16) != ref.to(torch.bfloat16))
        assert differ.any() and (u[differ] < -2.0).all()


def test_the_keep_division_is_the_true_division():
    """Over the GELU's values at every bf16 u, divided and undivided, and
    over random fp32 values: the product with the reciprocal and one fma
    correction gives the correctly rounded quotient, bit for bit, down to
    2^-100; below, the remainder (~2^-24 of the value) leaves fp32's normal
    range, and the quotient may be one unit in its last place off."""
    u = every_finite_bf16()
    g, gp = sigmoid_form(u)
    rng = np.random.default_rng(0)
    rand = torch.from_numpy((rng.standard_normal(200_000) * 10.0 ** rng.uniform(
        -30, 30, 200_000)).astype(np.float32))
    for rate in (0.1, 0.25, 0.5):
        kp = fl._keep_prob(rate, torch.float32)
        for v in (u, g, gp, rand):
            v = v[torch.isfinite(v)]
            want = v / torch.tensor(kp, dtype=torch.float32)
            got = divide_by_keep(v, kp)
            exact = want.abs() >= 2.0 ** -100
            assert torch.equal(got[exact], want[exact])
            ulp = 2.0 ** -23 * want[~exact].abs() + 2.0 ** -149
            assert ((got[~exact] - want[~exact]).abs() <= ulp).all()


def _every_bf16_rows() -> np.ndarray:
    """Every finite bf16 value, zeros after them, as fp32 [ROWS, WIDTH]
    filled column by column, so each column holds ROWS neighbouring values
    and the columns of the non-finite gelu' (|u| >~ 5e19) are apart from
    the others, whose sums stay finite."""
    h = np.zeros(ROWS * WIDTH, np.float32)
    u = every_finite_bf16().numpy()
    h[:u.size] = u
    return np.ascontiguousarray(h.reshape(WIDTH, ROWS).T)


@pytest.mark.parametrize("rate", RATES)
def test_sigmoid_form_holds_jax_fused_bias_gelu_dropout(rate):
    """The JAX op and its VJP (interpret mode) on h holding every finite
    bf16 value, b = 0 and dout = 1, against the spelling: out and dh within
    the element bound, db within the column-sum bound plus the element
    bound's absolute part once a row (the tanh form rounds gelu' to 0 below
    u ~ -9, where the sigmoid form keeps its tiny value)."""
    h = _every_bf16_rows()
    b = np.zeros(WIDTH, np.float32)
    dout = np.ones_like(h)
    key = jax.random.PRNGKey(3)
    seed = int(jax_fl.fold_seed(key)[0])

    def f(h, b):
        return jax_fl.fused_bias_gelu_dropout(h, b, rate=rate, rng=key, deterministic=False,
                                              interpret=True)

    out_j, vjp = jax.vjp(f, jnp.asarray(h), jnp.asarray(b))
    dh_j, db_j = (torch.from_numpy(np.array(x, np.float32)) for x in vjp(jnp.asarray(dout)))
    out_j = torch.from_numpy(np.array(out_j, np.float32))

    g, gp = sigmoid_form(torch.from_numpy(h))
    dg = torch.from_numpy(dout)
    if rate:
        kp = fl._keep_prob(rate, torch.float32)
        keep = fl.epilogue_dropout_mask(seed, fl.SALT_GELU, h.shape, rate)
        g = torch.where(keep, divide_by_keep(g, kp), 0.0)
        dg = torch.where(keep, divide_by_keep(dg, kp), 0.0)
    dh = dg * gp
    _holds(g, out_j)
    _holds(dh, dh_j)
    terms = torch.where(torch.isfinite(dh_j), dh_j.abs(), 0.0).sum(0)
    _holds(dh.sum(0), db_j, REL_TOL * db_j.abs() + COLSUM_TOL * terms + ROWS * ABS_TOL)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 511, 512, 513, 1000, 4096, 4097, 65536])
def test_backward_strips_are_a_function_of_n_only(n):
    """The strips cover the rows, none empty, each of at least BWD_MIN_ROWS
    rows (two rows for each of the 8 warps), at most the cap of strips; the
    strips take nothing but the row count, and the 124M shape [4096, *]
    runs K6's backward on 32 strips of 128 rows and K4's on 128 of 32."""
    for cap in (fl.GELU_BWD_MAX_STRIPS, fl.LN_BWD_MAX_BLOCKS):
        rows, strips = fl.bwd_strips(n, cap)
        assert rows >= fl.BWD_MIN_ROWS and strips <= cap
        assert (strips - 1) * rows < n <= strips * rows
    if n == 4096:
        assert fl.bwd_strips(n, fl.GELU_BWD_MAX_STRIPS) == (128, 32)
        assert fl.bwd_strips(n, fl.LN_BWD_MAX_BLOCKS) == (32, 128)
