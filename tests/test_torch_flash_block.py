"""The port's ``flash_block`` (K8's plain version on the CPU) against the
JAX package's ``flash_block`` in interpret mode, as
``tests/test_flash_block.py`` runs it: the same numpy inputs in fp32, the
forward ``(o, lse)``, the gradients under both cotangents ``(do, dlse)``,
and the dropout stream. The JAX kernel returns lse as ``[B, H, Tq, 1]``;
the port's is ``[B, H, Tq]``.

Tolerance: both sides compute in fp32; the JAX kernel sums online over its
128-key tiles, the plain version densely, so the sums differ in order only
(~1e-7 at these sizes): 1e-5 for o, lse and the grads. A fully masked row
is exact: o = 0 and lse = NEG_INF on both sides.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_2_distributed_tpu.ops.flash_block import flash_block as jax_flash_block
from gpt_2_distributed_tpu.ops.ring_attention import _dropout_bits_4d
from gpt_2_distributed_torch.ops import flash_block as fb
from gpt_2_distributed_torch.ops.spmd import block_dropout_keep

TOL = 1e-5

# (Tq, Tc, row_off, col_off): a full block below the diagonal, the diagonal
# block, a block wholly in the future, and Tq != Tc whose first 64 rows
# attend nothing in the block.
CASES = [(128, 128, 128, 0), (128, 128, 128, 128), (128, 128, 0, 128),
         (256, 128, 0, 64)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(tq, tc, d=32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, 2, tq, d)).astype(np.float32)
    k, v = (rng.normal(size=(1, 2, tc, d)).astype(np.float32) for _ in range(2))
    do = rng.normal(size=(1, 2, tq, d)).astype(np.float32)
    dlse = rng.normal(size=(1, 2, tq)).astype(np.float32)
    return q, k, v, do, dlse


def _jax(q, k, v, row_off, col_off, **kw):
    return jax_flash_block(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), row_off,
                           col_off, interpret=True, **kw)


@pytest.mark.parametrize("tq, tc, row_off, col_off", CASES)
def test_forward_matches_jax(tq, tc, row_off, col_off):
    q, k, v, _, _ = _inputs(tq, tc)
    o_j, lse_j = _jax(q, k, v, row_off, col_off)
    o, lse = fb.flash_block(*map(torch.from_numpy, (q, k, v)), row_off, col_off)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[..., 0], atol=TOL, rtol=0)
    dead = np.asarray(lse_j)[..., 0] == fb.NEG_INF
    assert np.array_equal(lse.numpy() == fb.NEG_INF, dead)
    assert np.all(o.numpy()[dead] == 0.0)
    if row_off < col_off and tq == tc:
        assert dead.all()


@pytest.mark.parametrize("tq, tc, row_off, col_off", CASES)
def test_grads_under_both_cotangents_match_jax(tq, tc, row_off, col_off):
    q, k, v, do, dlse = _inputs(tq, tc, seed=1)
    _, vjp = jax.vjp(lambda a, b, c: _jax(a, b, c, row_off, col_off),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp((jnp.asarray(do), jnp.asarray(dlse)[..., None]))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = fb.flash_block(qt, kt, vt, row_off, col_off)
    got = torch.autograd.grad((o, lse), (qt, kt, vt),
                              (torch.from_numpy(do), torch.from_numpy(dlse)))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0,
                                   err_msg=f"d{name}")


def test_dropout_stream_matches_jax():
    """Dropout 0.3, the same int seed, batch/head origins (3, 5): the keep
    mask equals the JAX ring's global-coordinate bits, and with v the
    identity (so o's zeros are exactly the dropped probabilities) the zero
    patterns of o are bit-equal and o agrees to the tolerance."""
    seed, rate, b_off, h_off, row_off, col_off = 12345, 0.3, 3, 5, 128, 0
    q, k, _, _, _ = _inputs(128, 128, d=128, seed=2)
    v = np.broadcast_to(np.eye(128, dtype=np.float32), (1, 2, 128, 128)).copy()
    o_j, _ = _jax(q, k, v, row_off, col_off, seed=jnp.asarray([seed], jnp.int32),
                  b_off=b_off, h_off=h_off, dropout_rate=rate)
    o, _ = fb.flash_block(*map(torch.from_numpy, (q, k, v)), row_off, col_off, seed=seed,
                          b_off=b_off, h_off=h_off, dropout_rate=rate)
    o_j = np.asarray(o_j)
    assert np.array_equal(o.numpy() == 0.0, o_j == 0.0)
    assert 0.2 < (o_j == 0.0).mean() < 0.4
    np.testing.assert_allclose(o.numpy(), o_j, atol=TOL, rtol=0)
    bits = _dropout_bits_4d(jnp.int32(seed), b_off, h_off, row_off, col_off, (1, 2, 128, 128))
    keep = block_dropout_keep(seed, rate, (1, 2, 128, 128), (b_off, h_off, row_off, col_off),
                              torch.device("cpu"))
    assert np.array_equal(keep.numpy(), np.asarray(bits >= jnp.uint32(int(rate * 2**32))))


def test_dropout_grads_match_jax():
    q, k, v, do, dlse = _inputs(128, 128, seed=3)
    kw = dict(b_off=1, h_off=2, dropout_rate=0.3)
    _, vjp = jax.vjp(lambda a, b, c: _jax(a, b, c, 128, 0, seed=jnp.asarray([77], jnp.int32),
                                          **kw), *map(jnp.asarray, (q, k, v)))
    want = vjp((jnp.asarray(do), jnp.asarray(dlse)[..., None]))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = fb.flash_block(qt, kt, vt, 128, 0, seed=77, **kw)
    got = torch.autograd.grad((o, lse), (qt, kt, vt),
                              (torch.from_numpy(do), torch.from_numpy(dlse)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)


def test_cpu_path_never_counts_a_launch():
    q, k, v, _, _ = _inputs(128, 128)
    before = (fb.flash_block_fwd.launches, fb.flash_block_bwd.launches)
    qt = torch.from_numpy(q).requires_grad_()
    o, lse = fb.flash_block(qt, torch.from_numpy(k), torch.from_numpy(v), 128, 0)
    (o.sum() + lse.sum()).backward()
    assert (fb.flash_block_fwd.launches, fb.flash_block_bwd.launches) == before
    with pytest.raises(ValueError, match="requires a seed"):
        fb.flash_block(qt, torch.from_numpy(k), torch.from_numpy(v), 0, 0, dropout_rate=0.1)
