"""The training mesh over a ``torch.distributed`` process group
(``gpt_2_distributed_tpu/parallel/mesh.py``).

The JAX package lays every execution mode out as one ('data', 'fsdp',
'sp', 'tp') device mesh under a single program. PyTorch's idiom is one
process per device: here the mesh is the process group, each process
holds one position on it, and the code that needs the mesh reads its
degrees and this process's index along each axis from :class:`Mesh`.

What the port runs so far is sequence parallelism: ``sp`` processes, each
holding a contiguous ``T/sp`` block of every sequence, with ring attention
(``ops/ring_attention.py``) passing K/V blocks around the ring. A ``data``,
``fsdp`` or ``tp`` degree above 1 is refused: they come with the DDP/FSDP
and tensor-parallel slices of the port.

The port keeps its own copies of ``MeshSpec`` and of the JAX CLI's
``validate_mesh_for_config``; :func:`activate_mesh` / :func:`active_mesh`
are the registry the attention dispatch and the model read, as in the JAX
package.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass

import torch
import torch.distributed as dist

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
SP_AXIS = "sp"    # sequence/context parallel (ring attention)
TP_AXIS = "tp"    # tensor (Megatron) parallel
AXES = (DATA_AXIS, FSDP_AXIS, SP_AXIS, TP_AXIS)


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


def refuse_unported_axes(spec: MeshSpec) -> None:
    """Raise ValueError for a degree this slice of the port does not run:
    ``data``/``fsdp`` > 1 (the DDP/FSDP slice) or ``tp`` > 1 (the
    tensor-parallel slice)."""
    if spec.data > 1 or spec.fsdp > 1:
        raise ValueError(
            f"mesh {spec.to_str()}: data/fsdp degrees above 1 are not ported "
            f"to PyTorch yet: they come in the DDP/FSDP slice of the port "
            f"(this slice runs sp only)"
        )
    if spec.tp > 1:
        raise ValueError(
            f"mesh {spec.to_str()}: tp above 1 is not ported to PyTorch yet: "
            f"it comes in the tensor-parallel slice of the port (this slice "
            f"runs sp only)"
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
    they read a JAX mesh."""

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

    def axis_index(self, axis: str) -> int:
        inner = 1
        for a in reversed(AXES):
            if a == axis:
                return (self.rank // inner) % self.shape[a]
            inner *= self.shape[a]
        raise KeyError(axis)

    @property
    def sp(self) -> int:
        return self.spec.sp

    @property
    def sp_index(self) -> int:
        return self.axis_index(SP_AXIS)

    def _sp_peer(self, hops: int) -> int:
        """Global rank of the process ``hops`` steps along the sp ring."""
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

    def all_reduce_(self, tensors: list[torch.Tensor]) -> None:
        """Sum each tensor in place over the mesh (every process holds the
        result, the same on each)."""
        for t in tensors:
            dist.all_reduce(t, group=self.group)


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


def sp_mesh() -> Mesh | None:
    """The active mesh when its 'sp' axis is > 1 (ring attention applies)."""
    m = active_mesh()
    return m if m is not None and m.sp > 1 else None


def is_primary() -> bool:
    """Rank 0 of the default group, or True without one."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
