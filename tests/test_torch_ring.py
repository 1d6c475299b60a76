"""The port's ring attention against the JAX package's ``ring_attention_bthd``
on the suite's 8-device CPU mesh: through the single-process exchange seam
and through 2- and 4-process gloo groups, the output and the q/k/v grads,
with and without dropout; the dropout bits of a rank's sequence block; the
divisibility error; and the attention dispatch under a mesh.

Tolerances are the JAX ring test's own (``tests/test_ring_attention.py``):
2e-5 on the output, 1e-4 on the grads, in fp32. With dropout the port gets
the int seed the JAX ring draws from its key, so the masks are the same.
"""

from __future__ import annotations

import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_2_distributed_tpu.ops.layers import hash_random_bits as jax_hash_bits
from gpt_2_distributed_tpu.ops.ring_attention import ring_attention_bthd as jax_ring
from gpt_2_distributed_tpu.parallel import mesh as jax_mesh
from gpt_2_distributed_torch.ops import attention, layers
from gpt_2_distributed_torch.ops import flash_attention as flash
from gpt_2_distributed_torch.ops.ring_attention import ring_attention_all_ranks
from gpt_2_distributed_torch.parallel.mesh import Mesh, MeshSpec, activate_mesh

REPO = pathlib.Path(__file__).resolve().parent.parent
O_TOL, GRAD_TOL = 2e-5, 1e-4
SHAPE = (2, 64, 2, 32)   # [B, T, H, D]
RATE = 0.3
KEY = 9

# One rank of a gloo group: its T/sp block of q, k, v and the cotangent,
# the ring through the attention dispatch ("ring" under the active mesh),
# with and without dropout; writes its output block and grads.
_RING_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from gpt_2_distributed_torch.ops.attention import select_attention_impl
from gpt_2_distributed_torch.parallel.mesh import Mesh, MeshSpec, activate_mesh

rank, world, store, data, out = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world)
inp = np.load(data)
tl = inp["q"].shape[1] // world
blk = slice(rank * tl, (rank + 1) * tl)
res = {}
with activate_mesh(Mesh(MeshSpec(sp=world), rank)):
    attn = select_attention_impl("ring", torch.device("cpu"))
    for tag, rate in (("det", 0.0), ("drop", float(inp["rate"]))):
        q, k, v = (torch.from_numpy(inp[n][:, blk]).requires_grad_() for n in "qkv")
        o = attn(q, k, v, dropout_rate=rate, seed=int(inp["seed"]))
        grads = torch.autograd.grad(o, (q, k, v), torch.from_numpy(inp["do"][:, blk]))
        for name, t in zip(("o", "dq", "dk", "dv"), (o, *grads)):
            res[f"{tag}_{name}"] = t.detach().numpy()
np.savez(f"{out}-{rank}.npz", **res)
dist.destroy_process_group()
"""


def spawn_gloo(world: int, code: str, tmp: pathlib.Path, *args: str) -> list[subprocess.Popen]:
    """Start ``world`` Python processes running ``code`` with argv ``rank
    world store *args`` over a FileStore in ``tmp`` (no port)."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    store = tmp / f"store-{world}"
    return [subprocess.Popen([sys.executable, "-c", code, str(r), str(world), str(store),
                              *args], cwd=REPO, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def join(procs: list[subprocess.Popen]) -> None:
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=SHAPE).astype(np.float32) for _ in range(4)]


def _jax_seed() -> int:
    """The int32 seed the JAX ring draws from its key."""
    key = jax.random.PRNGKey(KEY)
    return int(jax.random.randint(key, (1,), 0, jnp.iinfo(jnp.int32).max, jnp.int32)[0])


@functools.lru_cache(maxsize=None)
def jax_ring_result(sp: int, rate: float):
    """JAX ring_attention_bthd on MeshSpec(sp=sp): (o, dq, dk, dv)."""
    q, k, v, do = _inputs()
    mesh = jax_mesh.create_mesh(jax_mesh.MeshSpec(data=1, fsdp=1, sp=sp))
    kw = dict(mesh=mesh, dropout_rate=rate, deterministic=rate == 0.0,
              rng=jax.random.PRNGKey(KEY))

    def f(a, b, c):
        with jax_mesh.activate_mesh(mesh):
            return jax_ring(a, b, c, **kw)

    o, vjp = jax.vjp(jax.jit(f), *map(jnp.asarray, (q, k, v)))
    return tuple(np.asarray(x) for x in (o, *vjp(jnp.asarray(do))))


def _assert_matches(got, want):
    np.testing.assert_allclose(got[0], want[0], atol=O_TOL, rtol=0, err_msg="o")
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=0, err_msg=name)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gloo_dir(tmp_path_factory):
    """Runs the ring over 2- and 4-process gloo groups (both started at
    once); each rank's results land in ``out{sp}-{rank}.npz`` there."""
    tmp = tmp_path_factory.mktemp("ring")
    q, k, v, do = _inputs()
    np.savez(tmp / "in.npz", q=q, k=k, v=v, do=do, rate=RATE, seed=_jax_seed())
    groups = [spawn_gloo(sp, _RING_WORKER, tmp, str(tmp / "in.npz"), str(tmp / f"out{sp}"))
              for sp in (2, 4)]
    for procs in groups:
        join(procs)
    return tmp


def _gathered(tmp: pathlib.Path, sp: int, tag: str):
    """The ranks' blocks of (o, dq, dk, dv) joined along the sequence."""
    ranks = [np.load(tmp / f"out{sp}-{r}.npz") for r in range(sp)]
    return tuple(np.concatenate([r[f"{tag}_{n}"] for r in ranks], axis=1)
                 for n in ("o", "dq", "dk", "dv"))


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("rate", [0.0, RATE])
def test_single_process_ring_matches_jax(sp, rate):
    q, k, v, do = (torch.from_numpy(x) for x in _inputs())
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    o = ring_attention_all_ranks(*qkv, sp=sp, dropout_rate=rate, seed=_jax_seed())
    grads = torch.autograd.grad(o, qkv, do)
    _assert_matches([t.detach().numpy() for t in (o, *grads)], jax_ring_result(sp, rate))


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("tag, rate", [("det", 0.0), ("drop", RATE)])
def test_gloo_ring_matches_jax(gloo_dir, sp, tag, rate):
    _assert_matches(_gathered(gloo_dir, sp, tag), jax_ring_result(sp, rate))


def test_dropout_changes_the_ring_output():
    """Dropout is applied (the masks are not all-keep)."""
    assert not np.allclose(jax_ring_result(2, RATE)[0], jax_ring_result(2, 0.0)[0], atol=1e-3)


@pytest.mark.parametrize("sp", [2, 4, 8])
def test_rank_dropout_bits_concatenate_to_the_global_bits(sp):
    """A rank's [B, T/sp, C] block, drawn at sequence origin idx * T/sp,
    holds exactly that slice of the global [B, T, C] tensor's bits, which
    are the JAX package's for the same key words."""
    b, t, c = 2, 64, 24
    key = (0x1234ABCD, 0x9E3779B9)
    full = layers.hash_random_bits(key, (b, t, c))
    tl = t // sp
    parts = [layers.hash_random_bits(key, (b, tl, c), origin=(0, i * tl, 0)) for i in range(sp)]
    assert torch.equal(torch.cat(parts, dim=1), full)
    want = jax_hash_bits(jnp.asarray(key, jnp.uint32), (b, t, c))
    assert np.array_equal(full.numpy(), np.asarray(want).astype(np.int64))
    x = torch.ones(b, t, c)
    dropped = [layers.dropout(x[:, i * tl:(i + 1) * tl], 0.1, key, False, (0, i * tl, 0))
               for i in range(sp)]
    assert torch.equal(torch.cat(dropped, dim=1), layers.dropout(x, 0.1, key, False))


def test_ring_needs_a_divisible_sequence():
    q = torch.zeros(1, 30, 2, 32)
    with pytest.raises(ValueError, match="divisible"):
        ring_attention_all_ranks(q, q, q, sp=4)


def test_dispatch_follows_the_jax_policy():
    cpu = torch.device("cpu")
    # No mesh, or sp = 1: "ring" is the auto policy (a one-rank ring is
    # local attention).
    assert attention.select_attention_impl("ring", cpu) is flash.flash_attention_bthd
    with activate_mesh(Mesh(MeshSpec(sp=1), 0)):
        assert attention.select_attention_impl("ring", cpu) is flash.flash_attention_bthd
        assert attention.select_attention_impl("dense", cpu) is attention.causal_attention_bthd
    mesh = Mesh(MeshSpec(sp=2), 1)
    with activate_mesh(mesh):
        for impl in ("ring", "auto"):
            fn = attention.select_attention_impl(impl, cpu)
            assert fn.keywords == {"mesh": mesh}
            assert fn.func.__name__ == "ring_attention_bthd"
        for impl in ("flash", "dense", "plain", "kernel"):
            with pytest.raises(ValueError, match="later slice"):
                attention.select_attention_impl(impl, cpu)
    assert attention.select_attention_impl("auto", cpu) is flash.flash_attention_bthd
