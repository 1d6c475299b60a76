"""The port's fused matmuls (``gpt_2_distributed_torch/ops/fused_matmul.py``)
against the JAX ops of ``gpt_2_distributed_tpu/ops/fused_matmul.py``, whose
Pallas kernels run in interpret mode on the CPU as ``tests/
test_fused_matmul.py`` runs them. Inputs are made with numpy from a seed;
the JAX op folds its key to an int32 seed with ``fold_seed``, and the port
takes that seed. On the CPU the port runs its plain versions (the kernel
has no CPU build), so these tests hold the plain versions' arithmetic,
masks and autograd to the JAX kernels and custom VJPs; the model-level
tests are in ``tests/test_torch_train.py``.

Shapes are N, K, M = 64, 96, 192, not multiples of 128, as in
``tests/test_fused_matmul.py`` (the JAX tile plan then runs multi-step
grids of 64 x 32 x 64 blocks).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_2_distributed_tpu.models import decode as jax_decode
from gpt_2_distributed_tpu.models import gpt2 as jax_gpt2
from gpt_2_distributed_tpu.ops import fused_layer as jax_fl
from gpt_2_distributed_tpu.ops import fused_matmul as jax_fm
from gpt_2_distributed_torch.config import GPT2Config
from gpt_2_distributed_torch.models import decode
from gpt_2_distributed_torch.models.convert import params_from_jax
from gpt_2_distributed_torch.ops import fused_layer as fl
from gpt_2_distributed_torch.ops import fused_matmul as fm

N, K, M = 64, 96, 192
# fp32 on both sides; the products sum K or N terms in another order
# (~1e-6 on values of order 1).
FP32_TOL = 1e-5
# bf16 operands: both sides accumulate exact bf16 products in fp32 and
# round each output once, so an output differs by at most one bf16 ulp
# (<= 2^-7 of its magnitude) where the two fp32 sums straddle a rounding
# boundary. The grads come from du rounded to bf16 (a rounding boundary can
# move one du element by one ulp), so they are held to that step in norm:
# ||d - d_jax|| <= 2^-7 ||d_jax||.
BF16_REL = 2.0 ** -7
KINDS = ["bias", "gelu", "resid"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(0)
    return {
        "x": (rng.normal(size=(N, K)) * 0.5).astype(np.float32),
        "w": (rng.normal(size=(K, M)) / np.sqrt(K)).astype(np.float32),
        "b": (0.1 * rng.normal(size=(M,))).astype(np.float32),
        "r": (rng.normal(size=(N, M)) * 0.5).astype(np.float32),
        "dy": rng.normal(size=(N, M)).astype(np.float32),
    }


def _key_and_seed(i: int):
    key = jax.random.PRNGKey(i)
    return key, int(jax_fl.fold_seed(key)[0])


def _t(a, dtype=torch.float32, grad=False):
    return torch.from_numpy(a).to(dtype).requires_grad_(grad)


def _jax_op(kind, rate, key, salt):
    kw = dict(rate=rate, rng=key, deterministic=False)
    if kind == "bias":
        return lambda x, w, b: jax_fm.matmul_bias(x, w, b)
    if kind == "gelu":
        return lambda x, w, b: jax_fm.matmul_bias_gelu_dropout(x, w, b, salt=salt, **kw)
    return lambda x, w, b, r: jax_fm.matmul_bias_residual_dropout(x, w, b, r, salt=salt, **kw)


def _port_op(kind, rate, seed, salt):
    kw = dict(rate=rate, seed=seed, deterministic=False, salt=salt)
    if kind == "bias":
        return lambda x, w, b: fm.matmul_bias(x, w, b)
    if kind == "gelu":
        return lambda x, w, b: fm.matmul_bias_gelu_dropout(x, w, b, **kw)
    return lambda x, w, b, r: fm.matmul_bias_residual_dropout(x, w, b, r, **kw)


def _names(kind):
    return ("x", "w", "b", "r") if kind == "resid" else ("x", "w", "b")


def _run_both(arrays, kind, rate, salt, dtype_j=jnp.float32, dtype_t=torch.float32):
    """(y, grads) of the JAX op and of the port's, the grads of every
    operand for the cotangent dy."""
    key, seed = _key_and_seed({"bias": 3, "gelu": 5, "resid": 7}[kind])
    names = _names(kind)
    y_j, vjp = jax.vjp(_jax_op(kind, rate, key, salt),
                       *(jnp.asarray(arrays[k], dtype_j) for k in names))
    grads_j = vjp(jnp.asarray(arrays["dy"], dtype_j))
    ops = [_t(arrays[k], dtype_t, grad=True) for k in names]
    y = _port_op(kind, rate, seed, salt)(*ops)
    grads = torch.autograd.grad(y, ops, _t(arrays["dy"], dtype_t))
    return (y_j, grads_j), (y, grads), ops


@pytest.mark.parametrize("kind, rate", [("bias", 0.0), ("gelu", 0.0), ("gelu", 0.1),
                                        ("resid", 0.0), ("resid", 0.1)])
def test_fused_matmul_fwd_and_grads_match_jax(arrays, kind, rate):
    salt = {"bias": 0, "gelu": fm.SALT_MM_GELU, "resid": fm.SALT_MM_MLP_PROJ}[kind]
    (y_j, grads_j), (y, grads), ops = _run_both(arrays, kind, rate, salt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), atol=FP32_TOL, rtol=0)
    for name, g, gj in zip(_names(kind), grads, grads_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), atol=FP32_TOL, rtol=0,
                                   err_msg=name)
    if rate > 0.0:
        # The dropped positions, bit for bit: a dropped GELU is exactly 0,
        # a dropped out-projection leaves exactly r.
        base_j = 0.0 if kind == "gelu" else np.asarray(arrays["r"])
        base = 0.0 if kind == "gelu" else ops[3].detach()
        dropped_j = np.asarray(y_j) == base_j
        np.testing.assert_array_equal((y.detach() == base).numpy(), dropped_j)
        assert 0.05 < dropped_j.mean() < 0.15


@pytest.mark.parametrize("kind", KINDS)
def test_fused_matmul_bf16_tracks_jax(arrays, kind):
    """bf16 operands at rate 0.1 (the bias leg at 0): outputs within one
    bf16 rounding step element by element, grads within one step in
    norm."""
    rate = 0.0 if kind == "bias" else 0.1
    salt = fm.SALT_MM_ATTN_PROJ
    (y_j, grads_j), (y, grads), _ = _run_both(arrays, kind, rate, salt, jnp.bfloat16,
                                             torch.bfloat16)
    assert y.dtype == torch.bfloat16 and all(g.dtype == torch.bfloat16 for g in grads)
    want = np.asarray(y_j, np.float32)
    err = np.abs(y.detach().float().numpy() - want)
    assert (err <= BF16_REL * np.abs(want) + 1e-6).all(), err.max()
    for name, g, gj in zip(_names(kind), grads, grads_j):
        gj = np.asarray(gj, np.float32)
        assert np.linalg.norm(g.float().numpy() - gj) <= BF16_REL * np.linalg.norm(gj), name


@pytest.mark.parametrize("salt", [fm.SALT_MM_GELU, fm.SALT_MM_ATTN_PROJ, fm.SALT_MM_MLP_PROJ])
@pytest.mark.parametrize("seed", [0x7FFFFFFF, 0xDEADBEEF])
def test_fused_matmul_masks_bit_exact(salt, seed):
    """The K7 salts' masks: the port regenerates the JAX stream, also for
    seeds at and above 2^31."""
    shape = (130, 300)
    jseed = jnp.asarray(np.array([seed], np.uint32).view(np.int32))
    want = np.asarray(jax_fl.epilogue_dropout_mask(jseed, salt, shape, 0.1))
    np.testing.assert_array_equal(fl.epilogue_dropout_mask(seed, salt, shape, 0.1).numpy(),
                                  want)


def test_plain_versions_round_where_the_kernel_does(arrays):
    """On fp32 copies of bf16 values with ``dtype=bf16`` the plain backward
    rounds du where the kernel does, so the bf16 run is that reference
    rounded once; the inference epilogues: ``linear`` is torch's unfused
    ``round(round(x @ w) + b)`` and the head the fp32 product."""
    bf = torch.bfloat16
    x, w, b, dy = (_t(arrays[k], bf) for k in ("x", "w", "b", "dy"))
    u = fm.matmul_fwd_plain("gelu", x, w, b)[1]
    key, seed = _key_and_seed(9)
    for kw in ({}, {"u": u}):
        dx = fm.matmul_dgrad_plain(dy, w, rate=0.1, seed=seed, salt=4, **kw)
        ref = fm.matmul_dgrad_plain(dy.float(), w.float(), rate=0.1, seed=seed, salt=4,
                                    dtype=bf, **{k: v.float() for k, v in kw.items()})
        assert torch.equal(dx, ref.to(bf))
        dw, db = fm.matmul_wgrad_plain(x, dy, rate=0.1, seed=seed, salt=4, **kw)
        ref_w, ref_b = fm.matmul_wgrad_plain(x.float(), dy.float(), rate=0.1, seed=seed,
                                             salt=4, dtype=bf,
                                             **{k: v.float() for k, v in kw.items()})
        assert torch.equal(dw, ref_w.to(bf)) and torch.equal(db, ref_b)
    assert torch.equal(fm.linear(x, w, b), (x.float() @ w.float()).to(bf) + b)
    assert torch.equal(fm.linear(x, w), (x.float() @ w.float()).to(bf))
    wte = _t(arrays["w"].T.copy(), bf)           # [V, C] = [M, K]
    assert torch.equal(fm.head_logits(x, wte), x.float() @ wte.float().t())
    assert fm.mm_bias_fwd.launches == fm.linear.launches == fm.head_logits.launches == 0


def test_wgrad_slices_depend_on_the_shape_only():
    # 124M at batch 4 x 1024, one wgmma block a tile and one block an SM:
    # the [768, 768] projection's 36 tiles take 3 slices (108 blocks), the
    # legs with 108 or 144 tiles fill the card alone; one-row and small
    # inputs 1.
    assert fm.wgrad_slices(4096, 768, 768) == 3
    assert fm.wgrad_slices(4096, 768, 2304) == 1
    assert fm.wgrad_slices(4096, 768, 3072) == 1
    assert fm.wgrad_slices(4096, 3072, 768) == 1
    assert fm.wgrad_slices(1, 768, 768) == 1


def _jax_dgrad_tile(g, u, seed, rate, salt, row_off, col_off):
    """The JAX kernels' du (``_dgrad_tile``) over a whole bf16 tile at
    (row_off, col_off) of the [N, M] gradient, run in a ``pallas_call`` in
    interpret mode as the JAX package's tests run its kernels on the CPU."""
    from jax.experimental import pallas as pl

    def kernel(seed_ref, g_ref, *refs):
        u_ref = refs[0] if u is not None else None
        refs[-1][...] = jax_fm._dgrad_tile(g_ref, seed_ref, rate, salt, row_off, col_off,
                                           u_ref)

    args = [jnp.asarray([seed], jnp.int32), jnp.asarray(g, jnp.bfloat16)]
    if u is not None:
        args.append(jnp.asarray(u, jnp.bfloat16))
    out = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(g.shape, jnp.bfloat16),
                         interpret=True)(*args)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_du_matches_the_jax_dgrad_tile_bit_for_bit(arrays, rate, gelu):
    """The du the port's backward forms once a leg (``du_plain``, the du
    pass's plain version and reference) is the JAX kernels' per-tile du bit
    for bit after the bf16 rounding: on the whole [N, M] gradient and on a
    tile at an offset (absolute coordinates in the mask)."""
    _, seed = _key_and_seed(11)
    bf = torch.bfloat16
    g = _t(arrays["dy"], bf)
    u = fm.matmul_fwd_plain("gelu", _t(arrays["x"], bf), _t(arrays["w"], bf),
                            _t(arrays["b"], bf))[1] if gelu else None
    du = fm.du_plain(g.float(), None if u is None else u.float(), rate, seed,
                     fm.SALT_MM_GELU, bf)
    g_np = g.float().numpy()
    u_np = None if u is None else u.float().numpy()
    want = _jax_dgrad_tile(g_np, u_np, seed, rate, fm.SALT_MM_GELU, 0, 0)
    np.testing.assert_array_equal(du.numpy(), want)
    tile = (slice(16, 48), slice(64, 192))
    want = _jax_dgrad_tile(g_np[tile], None if u_np is None else u_np[tile], seed, rate,
                           fm.SALT_MM_GELU, 16, 64)
    np.testing.assert_array_equal(du[tile].numpy(), want)
    if rate > 0.0:
        assert 0.05 < (du == 0).float().mean().item() < 0.15


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_backward_is_du_once_then_the_products(arrays, dtype, gelu, rate):
    """The decomposition the kernels use: ``mm_du`` once a leg, then dgrad
    and wgrad on that du, gives exactly the plain dgrad and wgrad (du formed
    inside each) and db; at rate 0 without GELU du is dy itself."""
    _, seed = _key_and_seed(13)
    salt = fm.SALT_MM_MLP_PROJ
    x, w, b, g = (_t(arrays[k], dtype) for k in ("x", "w", "b", "dy"))
    u = fm.matmul_fwd_plain("gelu", x, w, b)[1] if gelu else None
    du, db = fm.mm_du(g, u, rate, seed, salt)
    assert du.dtype == dtype and db.dtype == torch.float32
    if gelu:
        dx, dw = fm.mm_dgrad_gelu(du, w), fm.mm_wgrad_gelu(x, du)
    else:
        dx, dw = fm.mm_dgrad(du, w), fm.mm_wgrad(x, du)
    assert torch.equal(dx, fm.matmul_dgrad_plain(g, w, u, rate, seed, salt))
    dw_p, db_p = fm.matmul_wgrad_plain(x, g, u, rate, seed, salt)
    assert torch.equal(dw, dw_p) and torch.equal(db, db_p)
    assert torch.equal(du.float(), fm.du_plain(g, u, rate, seed, salt))
    if rate == 0.0 and not gelu:
        assert torch.equal(du, g)
    assert fm.mm_du.launches == fm.mm_dgrad.launches == fm.mm_wgrad.launches == 0


def test_greedy_generate_cached_with_fused_matmul_matches_jax(tiny_config):
    """``fused_matmul="all"`` through the decode path: prefill and every
    decode step run the K7 legs (their plain versions here; the JAX kernels
    in interpret mode there), the attention out-projection unfused on both
    sides. fp32 greedy streams equal."""
    jcfg = tiny_config.replace(fused_matmul="all")
    jax_params = jax_gpt2.init_params(jcfg, seed=1)
    prompt = [[3, 17, 42, 200, 5, 9, 250], [1, 1, 2, 3, 5, 8, 13]]
    want = jax_decode.generate_cached(jax_params, jcfg, jnp.asarray(prompt, jnp.int32),
                                      jax.random.PRNGKey(0), max_new_tokens=8,
                                      temperature=0.0, compute_dtype=jnp.float32)
    cfg = GPT2Config(vocab_size=jcfg.vocab_size, n_positions=jcfg.n_positions,
                     n_embd=jcfg.n_embd, n_layer=jcfg.n_layer, n_head=jcfg.n_head,
                     fused_matmul="all")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))
    got = decode.generate_cached(params, cfg, prompt, max_new_tokens=8, temperature=0.0,
                                 compute_dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
