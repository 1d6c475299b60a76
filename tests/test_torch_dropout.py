"""The training slice's ops against the JAX package on the CPU: the dropout
hash streams, inverted dropout, the flash attention autograd function (on
its plain versions) against the JAX Pallas kernels in interpret mode, and
the blocked cross-entropy. Inputs are made with numpy from a seed; each
case states its tolerance."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_2_distributed_tpu.ops import layers as jax_layers
from gpt_2_distributed_tpu.ops import losses as jax_losses
from gpt_2_distributed_tpu.ops import spmd as jax_spmd
from gpt_2_distributed_tpu.ops.flash_attention import flash_attention as jax_flash
from gpt_2_distributed_torch.ops import flash_attention as flash
from gpt_2_distributed_torch.ops import layers, losses, spmd

# Seeds and key words at or above 2^31 (the sign bit of an int32 / int64
# reinterpretation), with large coordinates, so a signed shift or a product
# past 2^63 would show.
SEEDS = [0, 0x7FFFFFFF, 0x80000000, 0xDEADBEEF, 0xFFFFFFFF]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: intra-op threads only contend with the other test
    workers sharing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", SEEDS)
def test_dropout_hash_bits_bit_exact(seed):
    rng = np.random.default_rng(seed % 1000)
    b = rng.integers(0, 2**16, size=(4, 1, 1, 1), dtype=np.uint32)
    h = rng.integers(0, 2**16, size=(1, 3, 1, 1), dtype=np.uint32)
    row = rng.integers(0, 2**32, size=(1, 1, 32, 1), dtype=np.uint64).astype(np.uint32)
    col = rng.integers(0, 2**32, size=(1, 1, 1, 40), dtype=np.uint64).astype(np.uint32)
    want = jax_spmd.dropout_hash_bits(jnp.uint32(seed), *map(jnp.asarray, (b, h, row, col)))
    got = spmd.dropout_hash_bits(seed, *(torch.from_numpy(x.astype(np.int64))
                                         for x in (b, h, row, col)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    # Python ints take the same path as tensors.
    assert spmd.dropout_hash_bits(seed, 3, 2, 2**31 + 5, 2**32 - 1) == int(
        jax_spmd.dropout_hash_bits(jnp.uint32(seed), jnp.uint32(3), jnp.uint32(2),
                                   jnp.uint32(2**31 + 5), jnp.uint32(2**32 - 1)))


@pytest.mark.parametrize("words", [(0, 42), (0x80000000, 0xFFFFFFFF), (0xDEADBEEF, 7)])
def test_hash_random_bits_and_dropout_masks_bit_exact(words):
    shape = (3, 700, 5)
    key = jnp.asarray(words, jnp.uint32)
    want = np.asarray(jax_layers.hash_random_bits(key, shape)).astype(np.int64)
    np.testing.assert_array_equal(layers.hash_random_bits(words, shape).numpy(), want)
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = layers.dropout(torch.from_numpy(x).to(dtype), 0.1, words, False)
        exp = jax_layers.dropout(jnp.asarray(x, jdtype), 0.1, key, False)
        # Same mask, same division by the keep probability in x's dtype.
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(exp.astype(jnp.float32)))


def test_site_keys_are_distinct_and_stateless():
    keys = {layers.site_key(42, step, micro, layer, site)
            for step in range(3) for micro in range(2) for layer in range(3)
            for site in range(5)}
    assert len(keys) == 3 * 2 * 3 * 5
    assert layers.site_key(2**40 + 5, 7, 1, 2, 3) == layers.site_key(2**40 + 5, 7, 1, 2, 3)
    assert 0 <= layers.attention_seed(layers.site_key(1, 2, 3, 4, 1)) < 2**31


# The flash autograd function on its plain versions (fp32 on the CPU)
# against the JAX kernels in interpret mode at the same int32 seed. Both
# compute in fp32 and differ only in the order of their sums (the JAX
# kernel's online softmax over 128-row blocks, the plain version's dense
# softmax): 2e-5 absolute on values and grads of order 1.
FLASH_TOL = 2e-5


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_autograd_matches_jax_kernels(rate):
    rng = np.random.default_rng(7)
    q, k, v, do = (rng.normal(size=(2, 3, 256, 64)).astype(np.float32) for _ in range(4))
    key = jax.random.PRNGKey(11)
    # The JAX entry point folds its key to the kernel's int32 seed so.
    seed = int(jax.random.randint(key, (1,), 0, jnp.iinfo(jnp.int32).max, jnp.int32)[0])

    def f(q, k, v):
        return jax_flash(q, k, v, dropout_rate=rate, rng=key, deterministic=False,
                         block_q=128, interpret=True)

    o_j, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    grads_j = vjp(jnp.asarray(do))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = flash.flash_attention_bwd.launches
    o = flash.flash_attention(qt, kt, vt, rate, seed if rate else None)
    grads = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do))
    assert flash.flash_attention_bwd.launches == before   # plain, no kernel
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_j), atol=FLASH_TOL, rtol=0)
    for name, g, gj in zip("qkv", grads, grads_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), atol=FLASH_TOL, rtol=0,
                                   err_msg=f"d{name}")
    if rate:
        # The mask is the kernel's: another seed moves the output by far
        # more than the tolerance.
        o_other = flash.flash_attention(qt, kt, vt, rate, seed + 1)
        assert np.abs(o_other.detach().numpy() - np.asarray(o_j)).max() > 100 * FLASH_TOL


def test_flash_bthd_views_of_one_qkv_product_get_grads_through_strides():
    # The model's layout: q, k, v are [B, T, H, D] views of one [B, T, 3C]
    # product; the grads land in that product's grad.
    rng = np.random.default_rng(3)
    b, t, h, d = 2, 40, 2, 16
    qkv = torch.from_numpy(rng.normal(size=(b, t, 3 * h * d)).astype(np.float32))
    qkv.requires_grad_()
    v5 = qkv.view(b, t, 3, h, d)
    o = flash.flash_attention_bthd(v5[:, :, 0], v5[:, :, 1], v5[:, :, 2], 0.1, 1234)
    do = torch.from_numpy(rng.normal(size=o.shape).astype(np.float32))
    (g,) = torch.autograd.grad(o, qkv, do)
    ref = qkv.detach().clone().requires_grad_()
    r5 = ref.view(b, t, 3, h, d)
    o_ref = flash.flash_attention(*(r5[:, :, i].transpose(1, 2) for i in range(3)),
                                  0.1, 1234).transpose(1, 2)
    (g_ref,) = torch.autograd.grad(o_ref, ref, do)
    assert torch.equal(o, o_ref) and torch.equal(g, g_ref)


@pytest.mark.parametrize("block_rows", [16, 64])
def test_blocked_cross_entropy_matches_jax(block_rows):
    rng = np.random.default_rng(block_rows)
    n, c, vocab = 70, 24, 97           # 70 rows: ragged against both block sizes
    x = rng.normal(size=(n, c)).astype(np.float32)
    wte = rng.normal(size=(vocab, c)).astype(np.float32) * 0.3
    labels = rng.integers(0, vocab, size=n).astype(np.int32)
    labels[[0, 5, 69]] = -100
    loss_j, (gx_j, gw_j) = jax.value_and_grad(
        lambda x, w: jax_losses.blocked_cross_entropy(x, w, jnp.asarray(labels), block_rows),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(wte))
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(wte).requires_grad_()
    loss = losses.blocked_cross_entropy(xt, wt, torch.from_numpy(labels), block_rows)
    gx, gw = torch.autograd.grad(loss, (xt, wt))
    # fp32 on both sides; sums over V=97 and N=70 in another order.
    np.testing.assert_allclose(loss.item(), float(loss_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(gx.numpy(), np.asarray(gx_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(gw.numpy(), np.asarray(gw_j), atol=1e-6, rtol=0)
