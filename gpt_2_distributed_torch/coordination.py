"""The multi-process control plane's step consensus
(``gpt_2_distributed_tpu/coordination.py``, its first part).

Every collective of a mesh must be entered by every process, so a fault
*decision* must be as symmetric as the collectives it gates: one rank
entering the emergency save (or a rollback's restore) while another steps
on hangs both. At a consensus boundary every process contributes a control
word (preempt flag, rollback request, guard skip seen, data-worker error,
save request) to one reduction over the whole mesh, and all of them act on
the agreed word: the same action on the same step.

NCCL has no bitwise-OR reduction, so :meth:`ConsensusBus.exchange` spreads
the word's bits over an int32 vector, one element a bit, and all-reduces
it with MAX: an element is 1 iff some process set that bit, which is
:func:`or_reduce_words` of the words. On one process the exchange is the
identity and dispatches nothing.

The desync detector (parameter fingerprints) and the hang watchdog come
with a later slice of the port.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from gpt_2_distributed_torch.obs.trace import get_tracer

# Control-word bits, OR-reduced across processes. Adding a bit changes the
# protocol: every process must run the same code version.
CTRL_PREEMPT = 1 << 0        # this process saw SIGTERM / a preemption notice
CTRL_ROLLBACK = 1 << 1       # this process's spike monitor asks for a rollback
CTRL_SKIP = 1 << 2           # this process observed a guard-skipped step
CTRL_WORKER_ERROR = 1 << 3   # a data-worker thread died on this process
CTRL_SAVE_NOW = 1 << 4       # this process asks for a checkpoint now

_BITS = (CTRL_PREEMPT, CTRL_ROLLBACK, CTRL_SKIP, CTRL_WORKER_ERROR, CTRL_SAVE_NOW)
_ALL_BITS = CTRL_PREEMPT | CTRL_ROLLBACK | CTRL_SKIP | CTRL_WORKER_ERROR | CTRL_SAVE_NOW


class ControlWord(NamedTuple):
    """A decoded control word: one bool a protocol bit."""

    preempt: bool = False
    rollback: bool = False
    skip: bool = False
    worker_error: bool = False
    save_now: bool = False


def encode_control_word(
    preempt: bool = False,
    rollback: bool = False,
    skip: bool = False,
    worker_error: bool = False,
    save_now: bool = False,
) -> int:
    """Pack one process's fault flags into an OR-reducible integer."""
    return (
        (CTRL_PREEMPT if preempt else 0)
        | (CTRL_ROLLBACK if rollback else 0)
        | (CTRL_SKIP if skip else 0)
        | (CTRL_WORKER_ERROR if worker_error else 0)
        | (CTRL_SAVE_NOW if save_now else 0)
    )


def decode_control_word(word: int) -> ControlWord:
    return ControlWord(
        preempt=bool(word & CTRL_PREEMPT),
        rollback=bool(word & CTRL_ROLLBACK),
        skip=bool(word & CTRL_SKIP),
        worker_error=bool(word & CTRL_WORKER_ERROR),
        save_now=bool(word & CTRL_SAVE_NOW),
    )


def or_reduce_words(words: list[int] | Any) -> int:
    """The bus's reduction: bitwise OR over the processes' words."""
    out = 0
    for w in words:
        out |= int(w)
    return out


def word_to_bits(word: int) -> list[int]:
    """``word`` as one 0/1 entry a protocol bit (the vector the bus
    reduces with MAX)."""
    return [1 if word & b else 0 for b in _BITS]


def bits_to_word(bits) -> int:
    return or_reduce_words(b for b, on in zip(_BITS, bits) if int(on))


class ConsensusBus:
    """The control-word exchange over a mesh's processes.

    ``exchange(word)`` returns the agreed word: the OR of every process's.
    With no mesh, or a mesh of one process, it returns ``word`` and
    dispatches nothing. ``exchanges`` counts the calls; the trace's
    ``consensus_exchange`` spans time them.
    """

    def __init__(self, mesh=None, device: torch.device | str = "cpu") -> None:
        self.mesh = mesh if mesh is not None and mesh.spec.n_devices > 1 else None
        self.process_count = 1 if self.mesh is None else self.mesh.spec.n_devices
        self.device = torch.device(device)
        self.exchanges = 0

    def exchange(self, word: int) -> int:
        with get_tracer().span("consensus_exchange", word=int(word)):
            if word & ~_ALL_BITS:
                raise ValueError(f"control word {word:#x} has unknown bits set")
            if self.mesh is None:
                agreed = int(word)
            else:
                bits = torch.tensor(word_to_bits(word), dtype=torch.int32, device=self.device)
                torch.distributed.all_reduce(bits, op=torch.distributed.ReduceOp.MAX,
                                             group=self.mesh.group)
                agreed = bits_to_word(bits.tolist())
            self.exchanges += 1
        return agreed

    def same_on_every_process(self, value: int) -> bool:
        """Whether every process passed the same ``value`` (one all-reduce
        of ``[value, -value]`` with MAX; True on one process)."""
        if self.mesh is None:
            return True
        both = torch.tensor([value, -value], dtype=torch.int64, device=self.device)
        torch.distributed.all_reduce(both, op=torch.distributed.ReduceOp.MAX,
                                     group=self.mesh.group)
        high, neg_low = both.tolist()
        return high == -neg_low

    def barrier(self) -> None:
        """Wait for every process of the mesh (one exchange of a zero word)."""
        if self.mesh is not None:
            self.exchange(0)
