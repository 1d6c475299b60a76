"""The training mesh over a ``torch.distributed`` process group
(``gpt_2_distributed_tpu/parallel/mesh.py``).

The JAX package lays every execution mode out as one ('data', 'fsdp',
'sp', 'tp') device mesh under a single program. PyTorch's idiom is one
process per device: here the mesh is the process group, each process
holds one position on it, and the code that needs the mesh reads its
degrees and this process's index along each axis from :class:`Mesh`.

What the port runs: ``data`` (data parallel: the batch split, the
gradients summed), ``fsdp`` (the batch split too, and the fp32 master
weights, their gradients' reduction and the AdamW state sharded by
``parallel/sharding.py``) and ``sp`` (each process holds a contiguous
``T/sp`` block of every sequence, ring attention passes K/V blocks around
the ring), in any combination. A ``tp`` degree above 1 is refused: it
comes with the tensor-parallel slice of the port.

:class:`Mesh` runs ``all_reduce``/``all_gather``/``reduce_scatter`` over a
named set of its axes (the 'data' ranks, the 'fsdp' ranks, the (data,
fsdp) batch group, ...), through a process subgroup per set, made on
first use, its ranks ordered as :meth:`Mesh.axis_index` orders them.

The port keeps its own copies of ``MeshSpec``, of the JAX CLI's
``validate_mesh_for_config`` and of ``elastic_respec`` (the mesh of a
resized world: only 'data' moves); :func:`activate_mesh` /
:func:`active_mesh` are the registry the attention dispatch and the model
read, as in the JAX package. :func:`init_distributed` is the multi-host
bootstrap: the JAX package's flags and environment fallbacks, one process
per device.
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass

import torch
import torch.distributed as dist

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
SP_AXIS = "sp"    # sequence/context parallel (ring attention)
TP_AXIS = "tp"    # tensor (Megatron) parallel
AXES = (DATA_AXIS, FSDP_AXIS, SP_AXIS, TP_AXIS)
TRAINING_MODES = ("local", "dp", "ddp", "fsdp")


@dataclass(frozen=True)
class MeshSpec:
    """Mesh shape: data x fsdp x sp x tp parallel degrees (each default 1)."""

    data: int = 1
    fsdp: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.fsdp * self.sp * self.tp

    @classmethod
    def parse(cls, text: str) -> "MeshSpec":
        """Parse ``"data=2,fsdp=4"`` / ``"sp=2"``. Raises ValueError naming
        the valid axis vocabulary on an unknown key, a malformed entry, or a
        non-positive degree."""
        kwargs: dict[str, int] = {}
        for part in text.split(","):
            if not part.strip():
                continue
            key, _, val = part.partition("=")
            key = key.strip()
            if key not in AXES:
                raise ValueError(
                    f"unknown mesh axis {key!r} in --mesh {text!r}; valid axes "
                    f"are {', '.join(AXES)} (e.g. \"data=2,fsdp=4\")"
                )
            if key in kwargs:
                raise ValueError(f"mesh axis {key!r} given twice in {text!r}")
            try:
                degree = int(val)
            except ValueError:
                raise ValueError(
                    f"mesh axis {key!r} needs an integer degree, got {val!r} "
                    f"in --mesh {text!r}"
                ) from None
            if degree < 1:
                raise ValueError(
                    f"mesh axis {key!r} degree must be >= 1, got {degree}"
                )
            kwargs[key] = degree
        return cls(**kwargs)

    def to_str(self) -> str:
        """The inverse of :meth:`parse`: ``"data=2,fsdp=4,sp=1,tp=1"``."""
        return f"data={self.data},fsdp={self.fsdp},sp={self.sp},tp={self.tp}"

    @classmethod
    def for_mode(cls, mode: str, n_devices: int | None = None) -> "MeshSpec":
        """The mesh of a ``--training_mode``: 'local' one device, 'dp' /
        'ddp' every device on 'data', 'fsdp' every device on 'fsdp'.
        ``n_devices`` defaults to the launcher's ``WORLD_SIZE`` (one
        process per device)."""
        if n_devices is None:
            n_devices = int(os.environ.get("WORLD_SIZE", "1"))
        if mode == "local":
            return cls(1, 1)
        if mode in ("dp", "ddp"):
            return cls(n_devices, 1)
        if mode == "fsdp":
            return cls(1, n_devices)
        raise ValueError(f"unknown training_mode {mode!r}; expected one of {TRAINING_MODES}")


def elastic_respec(saved: MeshSpec, n_devices: int) -> MeshSpec:
    """Re-derive a mesh for a resized world by shrinking/growing the ``data``
    axis and keeping the model-parallel axes (fsdp/sp/tp) fixed.

    The model axes are pinned because their degrees are baked into the
    per-tensor shardings and (for sp/tp) the attention/matmul partitioning
    itself; only the batch axis can absorb a world change. Raises
    ValueError naming the fixed axes and the nearest valid device counts
    when ``n_devices`` is not a positive multiple of their product.
    """
    fixed = saved.fsdp * saved.sp * saved.tp
    data, rem = divmod(n_devices, fixed)
    if data < 1 or rem:
        below = (n_devices // fixed) * fixed
        valid = [v for v in (below, below + fixed) if v >= fixed]
        raise ValueError(
            f"cannot re-mesh {saved.to_str()} onto {n_devices} device(s): the "
            f"model-parallel axes (fsdp={saved.fsdp}, sp={saved.sp}, "
            f"tp={saved.tp}) are fixed across an elastic resize, so the "
            f"device count must be a positive multiple of {fixed}; nearest "
            f"valid device counts: {' or '.join(str(v) for v in valid)}"
        )
    return MeshSpec(data=data, fsdp=saved.fsdp, sp=saved.sp, tp=saved.tp)


def process_env(coordinator_address: str | None = None, num_processes: int | None = None,
                process_id: int | None = None) -> tuple[str | None, int, int]:
    """``(coordinator "host:port" or None, process count, process id)``:
    each argument given, else the JAX package's environment fallbacks in
    its order: ``COORDINATOR_ADDRESS``, or ``MASTER_ADDR`` with
    ``MASTER_PORT`` (default 12355); ``NUM_PROCESSES`` or ``WORLD_SIZE``;
    ``PROCESS_ID`` or ``RANK``. One process (id 0) when no count is found.
    Raises ValueError for a process id outside the count."""
    if coordinator_address is None:
        addr = os.environ.get("COORDINATOR_ADDRESS") or os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT", "12355")
        coordinator_address = f"{addr}:{port}" if addr and ":" not in addr else addr
    if num_processes is None:
        ws = os.environ.get("NUM_PROCESSES") or os.environ.get("WORLD_SIZE")
        num_processes = int(ws) if ws else 1
    if process_id is None:
        r = os.environ.get("PROCESS_ID") or os.environ.get("RANK")
        process_id = int(r) if r else 0
    if num_processes > 1 and not 0 <= process_id < num_processes:
        raise ValueError(f"--process_id {process_id} is outside the {num_processes} "
                         f"processes (0 to {num_processes - 1})")
    return coordinator_address, max(1, num_processes), process_id


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None,
                     device: torch.device | None = None) -> torch.device | None:
    """Multi-host bootstrap (the JAX package's ``init_distributed``): one
    process per device, over ``torch.distributed``.

    The arguments and their environment fallbacks are :func:`process_env`'s,
    so a ``torchrun`` launch (``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) works unchanged. One process
    (``num_processes <= 1``) initializes nothing. Otherwise a process on a
    card takes card ``LOCAL_RANK`` when it is set, else ``process_id %
    torch.cuda.device_count()``, and joins ``init_process_group`` with NCCL
    (gloo when ``device`` is the CPU) at ``tcp://<coordinator>``; without a
    coordinator the rendezvous is ``init_process_group``'s default.
    Idempotent: a process group that exists already is kept. The JAX
    function's Cloud-TPU auto-detection (``TPU_WORKER_HOSTNAMES``) has no
    counterpart on a GPU. Returns the device this process runs on.
    """
    addr, n, rank = process_env(coordinator_address, num_processes, process_id)
    if n <= 1:
        return device
    if device is not None and device.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        device = torch.device("cuda", int(local) if local else rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        kw = {"init_method": f"tcp://{addr}"} if addr else {}
        dist.init_process_group("nccl" if device is not None and device.type == "cuda"
                                else "gloo", rank=rank, world_size=n, **kw)
    return device


def refuse_unported_axes(spec: MeshSpec) -> None:
    """Raise ValueError for a degree the port does not run yet: ``tp`` > 1
    (the tensor-parallel slice)."""
    if spec.tp > 1:
        raise ValueError(
            f"mesh {spec.to_str()}: tp above 1 is not ported to PyTorch yet: "
            f"it comes in the tensor-parallel slice of the port (the port runs "
            f"data, fsdp and sp)"
        )


def validate_mesh_for_config(spec: MeshSpec, config, model_name: str,
                             seq_len: int) -> None:
    """Parse-time mesh x model validation (the JAX CLI's): a ``tp`` degree
    must divide the model's ``n_head``, an ``sp`` degree must divide
    ``--seq_len`` (each process holds a whole ``T/sp`` block)."""
    if spec.tp > 1 and config.n_head % spec.tp != 0:
        valid = [d for d in range(2, config.n_head + 1) if config.n_head % d == 0]
        raise ValueError(
            f"tp={spec.tp} does not divide n_head={config.n_head} of model "
            f"{model_name!r}: qkv/attention weights would stay replicated "
            f"across 'tp' (wasted flops). Valid tp degrees for this model: "
            f"{valid}"
        )
    if spec.sp > 1 and seq_len % spec.sp != 0:
        raise ValueError(
            f"sp={spec.sp} does not divide seq_len={seq_len}: ring attention "
            f"needs a whole T/sp sequence chunk per device"
        )


# The flat-tensor collectives under their current names (older torch has
# only the ``*_tensor`` spellings).
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


class _RingShift(torch.autograd.Function):
    """Send a stacked ``[2, ...]`` K/V buffer to the next rank of the ring
    and receive the previous rank's; the backward sends the gradient the
    other way round."""

    @staticmethod
    def forward(ctx, kv, mesh):
        ctx.mesh = mesh
        return mesh.exchange(kv.contiguous(), +1)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.exchange(g.contiguous(), -1), None


class Mesh:
    """This process's place on a mesh of ``spec.n_devices`` processes of
    ``group`` (the default group when None), ordered as the JAX package
    orders its devices: 'tp' innermost, then 'sp', 'fsdp', 'data'.

    ``shape`` maps each axis to its degree and :meth:`axis_index` gives
    this process's index along it, so ``ops/spmd.py``'s helpers read it as
    they read a JAX mesh.

    With ``torch.distributed`` initialized, :meth:`group_of` makes the
    subgroup of a set of axes the first time it is asked for it:
    ``new_group`` is collective, so every process must ask for the same
    sets in the same order, as it does when it runs the same collectives.
    Without it the mesh is a place on the grid only (a single process
    standing in for one rank); its collectives then raise."""

    axis_names = AXES

    def __init__(self, spec: MeshSpec, rank: int, group=None):
        refuse_unported_axes(spec)
        if not 0 <= rank < spec.n_devices:
            raise ValueError(f"rank {rank} is outside mesh {spec.to_str()}")
        self.spec = spec
        self.rank = rank
        self.group = group
        self.shape = {DATA_AXIS: spec.data, FSDP_AXIS: spec.fsdp,
                      SP_AXIS: spec.sp, TP_AXIS: spec.tp}
        self._live = tuple(a for a in AXES if self.shape[a] > 1)
        self._groups: dict[tuple[str, ...], object] = {}
        self._distributed = (spec.n_devices > 1 and dist.is_available()
                             and dist.is_initialized())

    def _global_rank(self, mesh_rank: int) -> int:
        return mesh_rank if self.group is None else dist.get_global_rank(self.group, mesh_rank)

    def _make_group(self, axes: tuple[str, ...]):
        """This process's subgroup over ``axes``: the processes that share
        its index on every other axis, in rank order. ``new_group`` is
        collective, so every process makes the groups of every index."""
        rest = [a for a in AXES if a not in axes]
        members: dict[tuple[int, ...], list[int]] = {}
        for m in range(self.spec.n_devices):
            members.setdefault(tuple(self._index_of(m, a) for a in rest), []).append(m)
        mine = None
        for ranks in members.values():
            g = dist.new_group([self._global_rank(m) for m in ranks])
            if self.rank in ranks:
                mine = g
        return mine

    def _index_of(self, rank: int, axis: str) -> int:
        inner = 1
        for a in reversed(AXES):
            if a == axis:
                return (rank // inner) % self.shape[a]
            inner *= self.shape[a]
        raise KeyError(axis)

    def axis_index(self, axis: str) -> int:
        return self._index_of(self.rank, axis)

    def axes_of(self, axes) -> tuple[str, ...]:
        """``axes`` (names) in mesh order, with the degree-1 ones dropped."""
        return tuple(a for a in self._live if a in axes)

    def size_of(self, axes) -> int:
        n = 1
        for a in self.axes_of(axes):
            n *= self.shape[a]
        return n

    def group_of(self, axes):
        """The process group of this process over the mesh axes ``axes``
        (the ranks that differ from it only there)."""
        axes = self.axes_of(axes)
        if not self._distributed:
            raise RuntimeError(
                f"mesh {self.spec.to_str()} has no process group: initialize "
                f"torch.distributed before constructing it"
            )
        if axes == self._live:
            return self.group
        if axes not in self._groups:
            self._groups[axes] = self._make_group(axes)
        return self._groups[axes]

    def all_reduce(self, t: torch.Tensor, axes=AXES) -> torch.Tensor:
        """Sum ``t`` in place over ``axes`` (every process of the group holds
        the same result); returns it."""
        if self.size_of(axes) > 1:
            dist.all_reduce(t, group=self.group_of(axes))
        return t

    def all_gather(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The flat ``t`` of every process of the ``axes`` group, concatenated
        in its rank order: ``[n * t.numel()]``."""
        n = self.size_of(axes)
        if n == 1:
            return t.reshape(-1)
        out = torch.empty(n * t.numel(), dtype=t.dtype, device=t.device)
        _ALL_GATHER(out, t.reshape(-1).contiguous(), group=self.group_of(axes))
        return out

    def reduce_scatter(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Sum the flat ``[n * k]`` ``t`` over the ``axes`` group and return
        this process's ``[k]`` chunk of the sum (its index in the group's
        rank order)."""
        n = self.size_of(axes)
        if n == 1:
            return t.reshape(-1)
        out = torch.empty(t.numel() // n, dtype=t.dtype, device=t.device)
        _REDUCE_SCATTER(out, t.reshape(-1).contiguous(), group=self.group_of(axes))
        return out

    @property
    def sp(self) -> int:
        return self.spec.sp

    @property
    def sp_index(self) -> int:
        return self.axis_index(SP_AXIS)

    def _sp_peer(self, hops: int) -> int:
        """Global rank of the process ``hops`` steps along this process's sp
        ring (only 'tp' is inside 'sp', so the ring's ranks are ``tp``
        apart whatever the data and fsdp degrees)."""
        inner = self.spec.tp
        peer = self.rank + ((self.sp_index + hops) % self.sp - self.sp_index) * inner
        return peer if self.group is None else dist.get_global_rank(self.group, peer)

    def exchange(self, buf: torch.Tensor, direction: int) -> torch.Tensor:
        """Send ``buf`` ``direction`` (+1 or -1) steps along the sp ring and
        return what arrives from the other side, in one batched P2P."""
        out = torch.empty_like(buf)
        ops = [dist.P2POp(dist.isend, buf, self._sp_peer(direction), self.group),
               dist.P2POp(dist.irecv, out, self._sp_peer(-direction), self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    def shift(self, k: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The ring's exchange seam: hands this rank the previous rank's
        K/V block (K and V in one message); the backward returns the
        gradients to their owners."""
        kv = _RingShift.apply(torch.stack([k, v]), self)
        return kv[0], kv[1]


class _MeshStack(threading.local):
    def __init__(self):
        self.stack: list[Mesh] = []


_ACTIVE_MESH_STACK = _MeshStack()


@contextlib.contextmanager
def activate_mesh(mesh: Mesh):
    """Enter ``mesh`` as the ambient mesh of this thread (read by
    :func:`active_mesh`)."""
    _ACTIVE_MESH_STACK.stack.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH_STACK.stack.pop()


def active_mesh() -> Mesh | None:
    """The innermost :func:`activate_mesh` mesh of this thread, or None."""
    stack = _ACTIVE_MESH_STACK.stack
    return stack[-1] if stack else None


def multi_mesh() -> Mesh | None:
    """The active mesh when it has more than one process."""
    m = active_mesh()
    return m if m is not None and m.spec.n_devices > 1 else None


def sp_mesh() -> Mesh | None:
    """The active mesh when its 'sp' axis is > 1 (ring attention applies)."""
    m = active_mesh()
    return m if m is not None and m.sp > 1 else None


def is_primary() -> bool:
    """Rank 0 of the default group, or True without one."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
