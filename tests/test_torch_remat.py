"""Activation recompute (``GPT2Config.remat``) in the port on the CPU:
every mode's loss and grads equal the no-recompute run's bit for bit
(the kernels' plain versions, dropout 0.1, each fused configuration),
match the JAX package's ``remat=mode`` at dropout 0 in fp32, and the
backward really reruns what each mode drops: the attention under
"block"/"attn"/"dots", the products under "block"/"mlp"/"attn" but none
under "dots". In gloo groups of 2 processes, fsdp=2 and sp=2 steps with
``remat="block"`` equal those without, and the bf16 gradient carry runs
under both meshes and tracks their fp32 carry.
"""

from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gpt_2_distributed_tpu.models import gpt2 as jax_gpt2
from gpt_2_distributed_torch.models import gpt2
from gpt_2_distributed_torch.parallel import train_step as ts
from gpt_2_distributed_torch.parallel.mesh import Mesh, MeshSpec, activate_mesh
from test_torch_ring import join, spawn_gloo
from test_torch_train import (
    MODEL_TOL,
    _assert_tree_close,
    _batch,
    grads_as_jax_tree,
    port_config,
    trainable,
)

MODES = (True, "block", "mlp", "attn", "dots")
FUSED = (("off", "off"), ("all", "off"), ("all", "all"))
RATE = 0.1
ACCUM_TOL = 5e-2   # tests/test_train_step.py's bound for the bf16 carry


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params(tiny_config):
    return jax_gpt2.init_params(tiny_config, seed=0)


@pytest.fixture(scope="module")
def batch():
    x, y = _batch(np.random.default_rng(1), 257, 2, 20)
    return torch.from_numpy(x), torch.from_numpy(y)


def _loss_and_grads(params, cfg, batch, rng=(7, 3, 1)):
    _, loss = gpt2.forward(params, cfg, *batch, rng=rng, deterministic=False,
                           compute_dtype=torch.float32)
    return loss, torch.autograd.grad(loss, ts.param_list(params))


@pytest.mark.parametrize("fused_layers, fused_matmul", FUSED)
@pytest.mark.parametrize("mode", MODES)
def test_remat_equals_no_remat_bit_for_bit(jax_params, tiny_config, batch, mode,
                                           fused_layers, fused_matmul):
    """Dropout 0.1: the recompute redraws the same masks from the sites'
    stateless keys, so loss and every grad are the same bits."""
    cfg = port_config(tiny_config, fused_layers=fused_layers, fused_matmul=fused_matmul)
    cfg = cfg.replace(embd_dropout=RATE, attn_dropout=RATE, resid_dropout=RATE)
    params = trainable(jax_params)
    loss0, g0 = _loss_and_grads(params, cfg, batch)
    loss1, g1 = _loss_and_grads(params, cfg.replace(remat=mode), batch)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


@pytest.mark.parametrize("mode", MODES)
def test_remat_matches_jax_remat(jax_params, tiny_config, batch, mode):
    """Dropout 0, fp32: the port's loss and every grad under ``remat=mode``
    against the JAX model's under the same mode (JAX
    ``tests/test_model.py::test_remat_matches_no_remat``'s setting)."""
    jcfg = tiny_config.replace(remat=mode)
    x, y = (jnp.asarray(t.numpy()) for t in batch)
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jax_gpt2.forward(p, jcfg, x, y, compute_dtype=jnp.float32)[1])(jax_params)
    params = trainable(jax_params)
    _, loss = gpt2.forward(params, port_config(tiny_config, remat=mode), *batch,
                           compute_dtype=torch.float32)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), atol=MODEL_TOL, rtol=0)
    _assert_tree_close(grads_as_jax_tree(params, tiny_config.n_head), grads_j, MODEL_TOL,
                       f"grad under remat={mode}")


class _CountProducts(TorchDispatchMode):
    """Counts the 2-D products (``aten.mm``/``aten.addmm``) dispatched."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mode, attn_reruns, more_products", [
    (False, False, False),
    ("block", True, True),
    ("attn", True, True),
    ("mlp", False, True),
    ("dots", True, False),
])
def test_the_backward_reruns_what_the_mode_drops(jax_params, tiny_config, batch,
                                                 monkeypatch, mode, attn_reruns,
                                                 more_products):
    """Attention forwards and 2-D products dispatched during the backward:
    "block", "attn" and "dots" rerun the attention of every layer, "mlp"
    none; "dots" saves every product, so its backward dispatches exactly
    the products of the no-recompute backward."""
    calls = []
    select = gpt2.select_attention_impl

    def counting_select(impl, device):
        fn = select(impl, device)

        def attn(*a, **kw):
            calls.append(1)
            return fn(*a, **kw)

        return attn

    monkeypatch.setattr(gpt2, "select_attention_impl", counting_select)
    cfg = port_config(tiny_config, remat=mode)

    def backward_counts(cfg):
        params = trainable(jax_params)
        _, loss = gpt2.forward(params, cfg, *batch, compute_dtype=torch.float32)
        calls.clear()
        with _CountProducts() as products:
            loss.backward()
        return len(calls), products.n

    attn0, products0 = backward_counts(cfg.replace(remat=False))
    attn1, products1 = backward_counts(cfg)
    assert attn0 == 0
    assert attn1 == (tiny_config.n_layer if attn_reruns else 0)
    assert (products1 > products0) == more_products
    assert products1 >= products0


def test_recompute_runs_under_the_forwards_mesh_on_another_thread(jax_params, tiny_config,
                                                                  batch):
    """Autograd may run the backward, and so the recompute, on a thread of
    its own (it does for CUDA tensors); the recompute must see the mesh
    that was active at the forward, whose per-shard kernel seeds differ
    from the meshless ones."""
    cfg = port_config(tiny_config, fused_layers="all").replace(
        embd_dropout=RATE, attn_dropout=RATE, resid_dropout=RATE)
    mesh = Mesh(MeshSpec(data=2), 1)

    def grads(remat):
        params = trainable(jax_params)
        with activate_mesh(mesh):
            _, loss = gpt2.forward(params, cfg.replace(remat=remat), *batch, rng=(7, 3, 1),
                                   deterministic=False, compute_dtype=torch.float32)
        out = []
        worker = threading.Thread(
            target=lambda: out.append(torch.autograd.grad(loss, ts.param_list(params))))
        worker.start()
        worker.join()
        return out[0]

    assert all(torch.equal(a, b) for a, b in zip(grads(False), grads("block")))


# One rank of a gloo group of 2: for each mesh and case, 2 guarded steps of
# 2 micro-batches at dropout 0.1 on its rows (fsdp) or T/2 block (sp); the
# metrics and the whole params after the steps.
_WORKER = r"""
import copy
import sys
import torch
import torch.distributed as dist
from gpt_2_distributed_torch.config import GPT2Config
from gpt_2_distributed_torch.ops.spmd import batch_axes, shard_offset
from gpt_2_distributed_torch.parallel import train_step as ts
from gpt_2_distributed_torch.parallel.mesh import Mesh, MeshSpec, activate_mesh
from gpt_2_distributed_torch.resilience import init_guard_state

rank, world, store, job, out = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world)
job = torch.load(job)
res = {}
for text in job["meshes"]:
    spec = MeshSpec.parse(text)
    mesh = Mesh(spec, rank)
    b, tl = job["x"].shape[2] // (spec.data * spec.fsdp), job["x"].shape[3] // spec.sp
    r0, s0 = shard_offset(mesh, batch_axes(mesh, b), b), mesh.sp_index * tl
    x, y = (a[:, :, r0:r0 + b, s0:s0 + tl] for a in (job["x"], job["y"]))
    with activate_mesh(mesh):
        for remat, accum_dtype in job["cases"]:
            cfg = GPT2Config(**job["config"]).replace(remat=remat)
            params = ts.trainable_params(copy.deepcopy(job["params"]), torch.device("cpu"))
            sharded = ts.ShardedUpdate.build(params, cfg, mesh, False)
            opt = ts.make_optimizer(params, job["lr"], sharded=sharded)
            step = ts.make_train_step(cfg, opt, compute_dtype=torch.float32, guard=True,
                                      sharded=sharded,
                                      accum_dtype=getattr(torch, accum_dtype))
            guard, metrics = init_guard_state(), []
            for i in range(x.shape[0]):
                guard, m = step(params, guard, x[i], y[i], 0, i, torch.ones(x.shape[1]))
                metrics.append((m.loss.item(), m.grad_norm.item(), m.skip_reason))
            w = params if sharded is None else sharded.full_params(params)
            res[(text, remat, accum_dtype)] = (
                metrics, [p.detach().clone() for p in ts.param_list(w)])
torch.save(res, f"{out}-{rank}.pt")
dist.destroy_process_group()
"""
GLOO_MESHES = ("fsdp=2", "sp=2")
GLOO_CASES = ((False, "float32"), ("block", "float32"), (False, "bfloat16"))


@pytest.fixture(scope="module")
def gloo_runs(jax_params, tiny_config, tmp_path_factory):
    """``{(mesh, remat, accum dtype): [(metrics, params) of rank 0, of
    rank 1]}`` from one launch."""
    from gpt_2_distributed_torch.models.convert import params_from_jax

    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(0, 257, (2, 2, 4, 32)))
    y = torch.from_numpy(rng.integers(0, 257, (2, 2, 4, 32)))
    cfg = port_config(tiny_config).replace(embd_dropout=RATE, attn_dropout=RATE,
                                           resid_dropout=RATE)
    config = {f: getattr(cfg, f) for f in ("vocab_size", "n_positions", "n_embd", "n_layer",
                                           "n_head", "embd_dropout", "attn_dropout",
                                           "resid_dropout")}
    tmp = tmp_path_factory.mktemp("remat_gloo")
    torch.save(dict(params=params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params)),
                    x=x, y=y, config=config, meshes=GLOO_MESHES, cases=GLOO_CASES,
                    lr=1e-3), tmp / "job.pt")
    join(spawn_gloo(2, _WORKER, tmp, str(tmp / "job.pt"), str(tmp / "out")))
    ranks = [torch.load(tmp / f"out-{r}.pt") for r in range(2)]
    return {key: [r[key] for r in ranks] for key in ranks[0]}


@pytest.mark.parametrize("mesh", GLOO_MESHES)
def test_gloo_remat_block_equals_no_remat(gloo_runs, mesh):
    """fsdp=2 (the block's gathers outside the recompute, one
    reduce-scatter a micro-batch) and sp=2 (the ring's sends rerun inside
    the backward on both ranks): the same losses, grad norms and params
    bit for bit, and the ranks agree."""
    plain, remat = gloo_runs[(mesh, False, "float32")], gloo_runs[(mesh, "block", "float32")]
    for (m0, p0), (m1, p1) in zip(plain, remat):
        assert m0 == m1 and all(m[2] == 0 for m in m0)
        assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert remat[0][0] == remat[1][0]
    assert all(torch.equal(a, b) for a, b in zip(remat[0][1], remat[1][1]))


@pytest.mark.parametrize("mesh", GLOO_MESHES)
def test_gloo_bf16_carry_tracks_the_fp32_carry(gloo_runs, mesh):
    (m32, _), _ = gloo_runs[(mesh, False, "float32")]
    (m16, p16), (m16_1, p16_1) = gloo_runs[(mesh, False, "bfloat16")]
    np.testing.assert_allclose(np.array([m[:2] for m in m16]),
                               np.array([m[:2] for m in m32]), rtol=ACCUM_TOL, atol=ACCUM_TOL)
    assert m16 == m16_1 and all(torch.equal(a, b) for a, b in zip(p16, p16_1))


def test_remat_config_accepts_every_jax_mode():
    from gpt_2_distributed_torch.config import GPT2Config

    for mode in (False, *MODES):
        assert GPT2Config(remat=mode).remat == mode
    with pytest.raises(ValueError, match="remat='all'"):
        GPT2Config(remat="all")
