"""PyTorch port ops against the JAX package on the CPU.

Each case feeds the same numpy inputs (made from a seed) to the JAX
function and its port counterpart, in fp32, and states its tolerance.
The Pallas kernels run as the JAX package's own tests run them on the CPU:
in interpret mode. The CUDA kernels themselves have no CPU build; their
tests are in ``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_2_distributed_tpu.ops import activations as jax_act
from gpt_2_distributed_tpu.ops import attention as jax_attn
from gpt_2_distributed_tpu.ops import layers as jax_layers
from gpt_2_distributed_tpu.ops import paged_attention as jax_paged
from gpt_2_distributed_tpu.ops.flash_attention import flash_attention as jax_flash
from gpt_2_distributed_torch.ops import activations, attention, layers
from gpt_2_distributed_torch.ops import flash_attention as flash
from gpt_2_distributed_torch.ops import paged_attention as paged


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: intra-op threads only contend with the other test
    workers sharing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def test_layer_norm_and_gelu_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3
    scale = rng.normal(size=(64,)).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32)
    want = jax_layers.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    got = layers.layer_norm(_t(x), _t(scale), _t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    got_bf16 = layers.layer_norm(_t(x).bfloat16(), _t(scale), _t(bias))
    assert got_bf16.dtype == torch.bfloat16   # fp32 inside, input dtype out
    np.testing.assert_allclose(
        activations.gelu_tanh(_t(x)).numpy(),
        np.asarray(jax_act.gelu_tanh(jnp.asarray(x))), atol=1e-6, rtol=0,
    )


def _qkv(b, h, t, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, t, d)).astype(np.float32) for _ in range(3)]


def _lse2_reference(q, k):
    """fp64 base-2 log-sum-exp of each causal row's scaled scores."""
    d, t = q.shape[-1], q.shape[-2]
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k.astype(np.float64))
    s = np.where(np.tril(np.ones((t, t), bool)), s / np.sqrt(d), -np.inf)
    m = s.max(-1, keepdims=True)
    return (m[..., 0] + np.log(np.exp(s - m).sum(-1))) / np.log(2.0)


@pytest.mark.parametrize("t", [128, 256])
def test_flash_plain_matches_jax_flash_interpret(t):
    q, k, v = _qkv(1, 2, t, 32)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    o, lse = flash.flash_attention_plain(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), _lse2_reference(q, k), atol=1e-5, rtol=0)


def test_flash_plain_and_dense_match_jax_dense_at_ragged_width():
    # T = 48 is no multiple of 128: the JAX package falls back to dense
    # there, while the port's kernel takes every prefill width.
    q, k, v = _qkv(2, 3, 48, 16, seed=1)
    bthd = [x.transpose(0, 2, 1, 3) for x in (q, k, v)]
    want = np.asarray(jax_attn.causal_attention_bthd(*map(jnp.asarray, bthd)))
    got_flash = flash.flash_attention_bthd(*map(_t, bthd))
    got_dense = attention.causal_attention_bthd(*map(_t, bthd))
    np.testing.assert_allclose(got_flash.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_dense.numpy(), want, atol=1e-6, rtol=0)


def test_flash_wrapper_on_cpu_is_the_plain_version():
    q, k, v = map(_t, _qkv(1, 2, 40, 16, seed=2))
    before = flash.flash_attention_fwd.launches
    o, lse = flash.flash_attention_fwd(q, k, v)
    o_p, lse_p = flash.flash_attention_plain(q, k, v)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    assert flash.flash_attention_fwd.launches == before   # no kernel ran
    # One plain formulation for prefill: the flash plain version's o is the
    # dense attention's, bit for bit, in bf16 too.
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    assert torch.equal(flash.flash_attention_plain(qb, kb, vb)[0],
                       attention.causal_attention(qb, kb, vb))


def test_select_attention_impl_dispatch():
    cpu = torch.device("cpu")
    # The device choice is the wrapper's: "auto" hands over the flash
    # wrapper, which runs the dense plain version on CPU tensors.
    assert attention.select_attention_impl("auto", cpu) is flash.flash_attention_bthd
    assert attention.select_attention_impl("plain", cpu) is attention.causal_attention_bthd
    q, k, v = (x.transpose(1, 2) for x in map(_t, _qkv(1, 2, 24, 16, seed=3)))
    before = flash.flash_attention_fwd.launches
    assert torch.equal(attention.select_attention_impl("auto", cpu)(q, k, v),
                       attention.causal_attention_bthd(q, k, v))
    assert flash.flash_attention_fwd.launches == before
    with pytest.raises(ValueError, match="needs CUDA"):
        attention.select_attention_impl("kernel", cpu)
    # The training names (GPT2Config.attention_impl) map onto the same two.
    assert attention.select_attention_impl("flash", cpu) is flash.flash_attention_bthd
    assert attention.select_attention_impl("dense", cpu) is attention.causal_attention_bthd
    # "ring" without a mesh is the auto policy, as in the JAX package.
    assert attention.select_attention_impl("ring", cpu) is flash.flash_attention_bthd
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention.select_attention_impl("xla", cpu)


def _paged_case(rng, b=4, h=2, d=8, bs=4, m=4, n_blocks=32):
    """Random q and pools, a scrambled table of distinct non-null blocks,
    and mixed lengths with one idle slot."""
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kp = rng.normal(size=(n_blocks, h, bs, d)).astype(np.float32)
    vp = rng.normal(size=(n_blocks, h, bs, d)).astype(np.float32)
    table = rng.permutation(np.arange(1, n_blocks))[: b * m].reshape(b, m).astype(np.int32)
    lengths = np.array([1, m * bs, 0, 7], np.int32)[:b]
    return q, kp, vp, table, lengths


def _paged_port(q, kp, vp, table, lengths):
    return paged.paged_attention_plain(
        _t(q), _t(kp), _t(vp), torch.from_numpy(table), torch.from_numpy(lengths)
    ).numpy()


def test_paged_plain_matches_jax_pallas_and_xla():
    q, kp, vp, table, lengths = _paged_case(np.random.default_rng(0))
    got = _paged_port(q, kp, vp, table, lengths)
    args = tuple(map(jnp.asarray, (q, kp, vp, table, lengths)))
    for want in (jax_paged.paged_attention_pallas(*args, interpret=True),
                 jax_paged.paged_attention_xla(*args)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[2], 0.0)     # idle slot: exact zeros
    assert np.abs(got[[0, 1, 3]]).max() > 0      # neighbours unaffected


def test_paged_plain_block_placement_and_masked_tail_are_invisible():
    rng = np.random.default_rng(1)
    q, kp, vp, table, lengths = _paged_case(rng)
    base = _paged_port(q, kp, vp, table, lengths)
    b, m = table.shape
    bs = kp.shape[2]
    # The same logical K/V laid out in table order at the front of the pool.
    kc, vc = np.zeros_like(kp), np.zeros_like(vp)
    table_c = np.arange(1, 1 + b * m, dtype=np.int32).reshape(b, m)
    kc[table_c] = kp[table]
    vc[table_c] = vp[table]
    np.testing.assert_array_equal(_paged_port(q, kc, vc, table_c, lengths), base)
    # Garbage in every position past a sequence's length is bitwise invisible.
    kn, vn = kp.copy(), vp.copy()
    for i in range(b):
        for j, blk in enumerate(table[i]):
            lo = max(0, int(lengths[i]) - j * bs)
            if lo < bs:
                kn[blk, :, lo:] = 1e6
                vn[blk, :, lo:] = -1e6
    np.testing.assert_array_equal(_paged_port(q, kn, vn, table, lengths), base)


def test_paged_dispatch_on_cpu():
    q, kp, vp, table, lengths = map(torch.from_numpy, _paged_case(np.random.default_rng(2)))
    before = paged.paged_attention_kernel.launches
    auto = paged.paged_attention(q, kp, vp, table, lengths)
    plain = paged.paged_attention(q, kp, vp, table, lengths, impl="plain")
    assert torch.equal(auto, plain)
    assert paged.paged_attention_kernel.launches == before
    with pytest.raises(ValueError, match="needs CUDA"):
        paged.paged_attention(q, kp, vp, table, lengths, impl="kernel")
    with pytest.raises(ValueError, match="impl="):
        paged.paged_attention(q, kp, vp, table, lengths, impl="xla")
