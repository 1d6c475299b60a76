"""The port's data/fsdp placement rules and per-shard dropout streams
against the JAX package, in one process (no process group): each rank of
a mesh is entered in turn with ``activate_mesh(Mesh(spec, r))``.

* ``parallel/sharding.py``'s param and update specs pick the JAX rules'
  dim for every leaf, for the tiny config and the 124M preset;
* under ``MeshSpec(data=4)`` the port's K4-K7 (their plain versions here)
  on each rank's rows, with the seed of ``models/gpt2.py::_site_seed``,
  reproduce the JAX fused ops' shard_map outputs (Pallas in interpret
  mode) at dropout 0.4: the dropped positions bit for bit;
* the same for flash attention under ``MeshSpec(data=2, fsdp=4)``, to the
  K1 parity bar (2e-5) at dropout 0.1;
* the unfused dropout's rank blocks equal the global draw bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_2_distributed_tpu.ops import fused_layer as jax_fl
from gpt_2_distributed_tpu.ops import fused_matmul as jax_fm
from gpt_2_distributed_tpu.ops.flash_attention import flash_attention as jax_flash
from gpt_2_distributed_tpu.parallel import mesh as jax_mesh
from gpt_2_distributed_tpu.parallel import sharding as jax_sharding
from gpt_2_distributed_tpu.models import gpt2 as jax_gpt2
from gpt_2_distributed_tpu.config import MODEL_PRESETS as JAX_PRESETS
from gpt_2_distributed_torch.config import MODEL_PRESETS, GPT2Config
from gpt_2_distributed_torch.models import gpt2
from gpt_2_distributed_torch.ops import flash_attention as flash
from gpt_2_distributed_torch.ops import fused_layer as fl
from gpt_2_distributed_torch.ops import fused_matmul as fm
from gpt_2_distributed_torch.ops.layers import dropout, site_key
from gpt_2_distributed_torch.ops.spmd import batch_axes, shard_offset, shard_seed
from gpt_2_distributed_torch.parallel import sharding
from gpt_2_distributed_torch.parallel.mesh import Mesh, MeshSpec, activate_mesh

FLASH_TOL = 2e-5   # tests/test_torch_dropout.py's K1 parity bar
FP32_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_specs(tree) -> dict:
    """A JAX PartitionSpec tree as the port's tuples."""
    return jax.tree_util.tree_map(lambda s: tuple(s), tree,
                                  is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _tiny(tiny_config):
    return GPT2Config(vocab_size=tiny_config.vocab_size, n_positions=tiny_config.n_positions,
                      n_embd=tiny_config.n_embd, n_layer=tiny_config.n_layer,
                      n_head=tiny_config.n_head)


@pytest.mark.parametrize("model", ["tiny", "124M"])
@pytest.mark.parametrize("data, fsdp", [(1, 2), (1, 4), (1, 8), (2, 1), (4, 1), (8, 1),
                                        (2, 4), (4, 2)])
def test_placement_rules_pick_the_jax_dims(tiny_config, model, data, fsdp):
    if model == "tiny":
        jcfg, cfg = tiny_config, _tiny(tiny_config)
    else:
        jcfg, cfg = JAX_PRESETS["124M"], MODEL_PRESETS["124M"]
    shapes = jax.eval_shape(lambda: jax_gpt2.init_params(jcfg))
    mesh = jax_mesh.create_mesh(jax_mesh.MeshSpec(data, fsdp))
    spec = MeshSpec(data, fsdp)
    assert sharding.param_pspecs(cfg, spec) == _jax_specs(jax_sharding.param_pspecs(shapes, mesh))
    assert sharding.update_pspecs(cfg, spec) == _jax_specs(
        jax_sharding.update_pspecs(shapes, mesh))
    for mode in ("off", "on", "auto"):
        assert sharding.resolve_shard_update(mode, spec) == \
            jax_sharding.resolve_shard_update(mode, mesh)
    # The JAX leaf shapes the rules run on are the JAX tree's.
    want = jax.tree_util.tree_map(lambda s: tuple(s.shape), shapes)
    assert sharding.leaf_shapes(cfg) == want


def test_batch_rows_and_modes_follow_the_jax_package():
    """A rank's rows of the global batch are the block ``shard_batch``
    puts on its device, and ``for_mode`` builds the JAX meshes."""
    x = np.arange(2 * 16 * 4, dtype=np.int32).reshape(2, 16, 4)
    mesh = jax_mesh.create_mesh(jax_mesh.MeshSpec(2, 4))
    with jax_mesh.activate_mesh(mesh):
        xs = jax_sharding.shard_batch((x, x), mesh)[0]
    for shard in xs.addressable_shards:
        m = Mesh(MeshSpec(2, 4), shard.device.id)
        lo = shard_offset(m, batch_axes(m, 2), 2)
        np.testing.assert_array_equal(x[:, lo:lo + 2], np.asarray(shard.data))
    for mode in ("local", "dp", "ddp", "fsdp"):
        want = jax_mesh.MeshSpec.for_mode(mode, 4)
        assert MeshSpec.for_mode(mode, 4).to_str() == want.to_str()
    with pytest.raises(ValueError, match="unknown training_mode"):
        MeshSpec.for_mode("zero3", 4)
    with pytest.raises(ValueError, match="shard_update"):
        sharding.resolve_shard_update("yes", MeshSpec(2))


def test_take_shard_is_the_named_sharding_block(tiny_config):
    """A rank's chunk of a 2-D-split leaf (fsdp on one dim, data on
    another) is the block JAX's NamedSharding puts on that device."""
    cfg = _tiny(tiny_config)
    spec = MeshSpec(data=2, fsdp=2)
    layouts = sharding.tensor_layouts(cfg, spec, shard_update=True)
    jspecs = jax_sharding.update_pspecs(
        jax.eval_shape(lambda: jax_gpt2.init_params(tiny_config)),
        jax_mesh.create_mesh(jax_mesh.MeshSpec(2, 2)))
    top = ("wte", "wpe", "ln_f_scale", "ln_f_bias")
    for i, name in enumerate(top):
        t = torch.arange(np.prod(layouts[i].view), dtype=torch.float32).view(layouts[i].view)
        arr = jax.device_put(np.asarray(t), jax.sharding.NamedSharding(
            jax_mesh.create_mesh(jax_mesh.MeshSpec(2, 2)), jspecs[name]))
        for shard in arr.addressable_shards:
            r = shard.device.id
            got = sharding.take_shard(t, layouts[i], Mesh(spec, r))
            np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data), err_msg=name)


def test_shard_seed_is_the_jax_shard_seed():
    mesh = jax_mesh.create_mesh(jax_mesh.MeshSpec(2, 4))
    for seed in (0, 12345, 0x7FFFFFFF):
        got = [shard_seed(seed, Mesh(MeshSpec(2, 4), r), ("data", "fsdp"), 0.1)
               for r in range(8)]

        def local(s):
            return jax_fl._shard_seed(s, mesh, ("data", "fsdp"), 0.1)

        want = jax.shard_map(local, mesh=mesh, in_specs=jax.sharding.PartitionSpec(None),
                             out_specs=jax.sharding.PartitionSpec(("data", "fsdp")),
                             check_vma=False)(jnp.asarray([seed], jnp.int32))
        assert got == [int(v) for v in np.asarray(want)]
        assert shard_seed(seed, Mesh(MeshSpec(2, 4), 5), ("data", "fsdp"), 0.0) == seed


# K4-K7 under MeshSpec(data=4): x = 0, o = 1 make every kept residual
# 1/(1 - rate) and every dropped one 0, so a mask is read off the output.
B, T, C = 8, 16, 96
RATE = 0.4


def _rank_outputs(fn, spec: MeshSpec, rows: int):
    """``fn(mesh, row slice)`` on every rank of ``spec``, concatenated."""
    outs = []
    for r in range(spec.n_devices):
        mesh = Mesh(spec, r)
        with activate_mesh(mesh):
            lo = shard_offset(mesh, batch_axes(mesh, rows), rows)
            outs.append(fn(slice(lo, lo + rows)))
    return torch.cat(outs)


def _site(seed: int, rows: int) -> int:
    """The model's kernel seed of a site whose JAX int32 seed is ``seed``."""
    return gpt2._site_seed((seed, 0), RATE, rows)


@pytest.mark.parametrize("op", ["ln_residual", "residual", "bias_gelu", "mm_gelu", "mm_resid"])
def test_fused_kernels_under_a_data_mesh_match_the_jax_shard_map(op):
    rng = np.random.default_rng(5)
    key = jax.random.PRNGKey(21)
    seed = int(jax_fl.fold_seed(key)[0])
    spec, rows = MeshSpec(data=4), B // 4
    x = np.zeros((B, T, C), np.float32)
    o = np.ones((B, T, C), np.float32)
    scale = (1.0 + 0.1 * rng.normal(size=C)).astype(np.float32)
    bias = (0.1 * rng.normal(size=C)).astype(np.float32)
    h = np.ones((B, T, 2 * C), np.float32)
    hb = np.zeros(2 * C, np.float32)
    w = (rng.normal(size=(C, 2 * C)) / np.sqrt(C)).astype(np.float32)
    w2 = (rng.normal(size=(C, C)) / np.sqrt(C)).astype(np.float32)
    xm = (rng.normal(size=(B, T, C)) * 0.5).astype(np.float32)
    kw = dict(rate=RATE, rng=key, deterministic=False)
    j = jnp.asarray
    t = torch.from_numpy
    with jax_mesh.activate_mesh(jax_mesh.create_mesh(jax_mesh.MeshSpec(4, 1))):
        want = {
            "ln_residual": lambda: jax_fl.fused_ln_residual_dropout(j(x), j(o), j(scale),
                                                                   j(bias), **kw)[0],
            "residual": lambda: jax_fl.fused_residual_dropout(j(x), j(o), **kw),
            "bias_gelu": lambda: jax_fl.fused_bias_gelu_dropout(j(h), j(hb), **kw),
            "mm_gelu": lambda: jax_fm.matmul_bias_gelu_dropout(j(xm), j(w), j(hb), **kw),
            "mm_resid": lambda: jax_fm.matmul_bias_residual_dropout(j(xm), j(w2), j(bias),
                                                                    j(x), **kw),
        }[op]()
    want = np.asarray(want)

    def port(sl):
        s = _site(seed, rows)
        if op == "ln_residual":
            return fl.fused_ln_residual_dropout(t(x[sl]), t(o[sl]), t(scale), t(bias),
                                                rate=RATE, seed=s, deterministic=False)[0]
        if op == "residual":
            return fl.fused_residual_dropout(t(x[sl]), t(o[sl]), rate=RATE, seed=s,
                                             deterministic=False)
        if op == "bias_gelu":
            return fl.fused_bias_gelu_dropout(t(h[sl]), t(hb), rate=RATE, seed=s,
                                              deterministic=False)
        if op == "mm_gelu":
            return fm.matmul_bias_gelu_dropout(t(xm[sl]), t(w), t(hb), rate=RATE, seed=s,
                                               deterministic=False)
        return fm.matmul_bias_residual_dropout(t(xm[sl]), t(w2), t(bias), t(x[sl]),
                                               rate=RATE, seed=s, deterministic=False,
                                               salt=jax_fm.SALT_MM_ATTN_PROJ)

    got = _rank_outputs(port, spec, rows).numpy()
    # The dropped positions, bit for bit: a dropped residual branch leaves
    # exactly x = 0, a dropped GELU is exactly 0.
    np.testing.assert_array_equal(got == 0.0, want == 0.0)
    np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=0)
    dropped = (want == 0.0).mean()
    assert abs(dropped - RATE) < 0.05
    if op in ("ln_residual", "residual"):
        np.testing.assert_array_equal(got, want)
    # The ranks' masks differ: the shard index is mixed into the seed.
    blocks = (got == 0.0).reshape(4, -1)
    assert not any((blocks[0] == blocks[r]).all() for r in range(1, 4))


def test_flash_under_a_data_fsdp_mesh_matches_the_jax_shard_map():
    b, h, t, d = 8, 2, 256, 64
    rng = np.random.default_rng(3)
    q, k, v, do = (rng.normal(size=(b, h, t, d)).astype(np.float32) for _ in range(4))
    key = jax.random.PRNGKey(11)
    seed = int(jax.random.randint(key, (1,), 0, jnp.iinfo(jnp.int32).max, jnp.int32)[0])
    mesh = jax_mesh.create_mesh(jax_mesh.MeshSpec(2, 4))
    sh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(("data", "fsdp")))

    def f(q, k, v):
        return jax_flash(q, k, v, dropout_rate=0.1, rng=key, deterministic=False,
                         block_q=128, interpret=True)

    with jax_mesh.activate_mesh(mesh):
        args = [jax.device_put(jnp.asarray(a), sh) for a in (q, k, v)]
        o_j, vjp = jax.vjp(f, *args)
        grads_j = vjp(jax.device_put(jnp.asarray(do), sh))

    spec = MeshSpec(data=2, fsdp=4)
    outs = {n: [] for n in ("o", "dq", "dk", "dv")}
    for r in range(8):
        with activate_mesh(Mesh(spec, r)):
            qt, kt, vt = (torch.from_numpy(a[r:r + 1]).requires_grad_() for a in (q, k, v))
            s = gpt2._site_seed((seed, 0), 0.1, 1)
            o = flash.flash_attention(qt, kt, vt, 0.1, s)
            grads = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do[r:r + 1]))
        for n, val in zip(outs, (o, *grads)):
            outs[n].append(val.detach())
    for n, want in zip(outs, (o_j, *grads_j)):
        np.testing.assert_allclose(torch.cat(outs[n]).numpy(), np.asarray(want),
                                   atol=FLASH_TOL, rtol=0, err_msg=n)


def test_unfused_dropout_rank_blocks_equal_the_global_draw(tiny_config):
    """Op level, bit for bit; then the model: with the attention dropout
    off (its kernel seed is per shard) the data=2 ranks' hidden states are
    the rows of the global batch's."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(4, 16, 32)).astype(np.float32))
    key = site_key(7, 3, 1, 0, 0)
    whole = dropout(x, 0.3, key, False)
    spec = MeshSpec(data=2)
    got = []
    for r in range(2):
        mesh = Mesh(spec, r)
        lo = shard_offset(mesh, batch_axes(mesh, 2), 2)
        got.append(dropout(x[lo:lo + 2], 0.3, key, False, origin=(lo, 0, 0)))
    assert torch.equal(torch.cat(got), whole)

    cfg = _tiny(tiny_config).replace(embd_dropout=0.3, resid_dropout=0.3, attn_dropout=0.0)
    params = gpt2.init_params(cfg, seed=0)
    idx = torch.from_numpy(rng.integers(0, 257, (4, 16)))
    kw = dict(rng=(5, 2, 1), deterministic=False, compute_dtype=torch.float32)
    whole = gpt2.hidden_states(params, cfg, idx, **kw)
    blocks = []
    for r in range(2):
        with activate_mesh(Mesh(spec, r)):
            blocks.append(gpt2.hidden_states(params, cfg, idx[2 * r:2 * r + 2], **kw))
    np.testing.assert_allclose(torch.cat(blocks).numpy(), whole.numpy(), atol=FP32_TOL, rtol=0)
