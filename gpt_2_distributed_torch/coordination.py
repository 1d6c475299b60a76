"""The multi-process control plane (``gpt_2_distributed_tpu/coordination.py``):
the step consensus and the fault detectors of a mesh run.

**1. Step consensus** (:class:`ConsensusBus`). Every collective of a mesh
must be entered by every process, so a fault *decision* must be as
symmetric as the collectives it gates: one rank entering the emergency
save (or a rollback's restore) while another steps on hangs both. At a
consensus boundary every process contributes a control word (preempt
flag, rollback request, guard skip seen, data-worker error, save request)
to one reduction over the whole mesh, and all of them act on the agreed
word: the same action on the same step. NCCL has no bitwise-OR
reduction, so :meth:`ConsensusBus.exchange` spreads the word's bits over
an int32 vector, one element a bit, and all-reduces it with MAX: an
element is 1 iff some process set that bit, which is
:func:`or_reduce_words` of the words. On one process the exchange is the
identity and dispatches nothing.

**2. Desync detector** (:func:`fingerprint_params`,
:func:`check_fingerprints`). Every ``--desync_check_every`` steps each
process takes a parameter fingerprint, one fp32 sum of every parameter
computed on the device, and the processes all-gather and compare it. The
value is one per data replica, as in the JAX package, where XLA sums each
leaf over the devices that hold its shards: a process sums the tensors it
holds and adds the sums of the other processes that hold the other shards
of the same tensors (the 'fsdp' group, and 'data' where ``--shard_update``
splits an fsdp shard too), in rank order. A mismatch names the ranks that
differ from the most common value and asks for the agreed rollback. So a
perturbation inside one fsdp group moves the whole group's value: at
fsdp=2 with data=1 there is nothing to compare with and the check cannot
see it, in the JAX package as here. Under ``--shard_update`` each slice
of the master state exists once and every step gathers the whole params
from it, so the replicas cannot drift across a step either.

**3. Hang watchdog** (:class:`HangWatchdog`). A daemon thread that the
loop arms after each completed step; if no step completes within
``--hang_timeout_s`` (a collective that a dead or wedged peer never
joins), it dumps every thread's stack, prints the open trace spans, runs
a bounded emergency save and exits :data:`resilience.HANG_EXIT_CODE`,
which ``scripts/supervise.sh`` turns into a full-job restart.

**4. Pod agreement** (:func:`assert_pod_agreement`). The start-up barrier
of an elastic resume: every process all-gathers the device count and the
grad-accum count it re-derived from the checkpoint, and a disagreement
fails the launch, naming the ranks that differ.
"""

from __future__ import annotations

import faulthandler
import os
import sys
import threading
import time
from collections import Counter
from typing import Any, Callable, Iterable, NamedTuple

import torch

from gpt_2_distributed_torch.obs.trace import get_tracer
from gpt_2_distributed_torch.resilience import HANG_EXIT_CODE

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


# --- part 2: the desync detector ---------------------------------------------


@torch.no_grad()
def fingerprint_params(params: dict, sharded=None) -> float:
    """One fp32 scalar summarizing the parameters, computed on their device.

    Each tensor is summed in fp32, the sums are added in tensor order, and
    only the scalar crosses to the host. With ``sharded`` (a
    ``parallel/train_step.py::ShardedUpdate``) a tensor that 'fsdp' splits
    counts through this process's shard, and the shard sums of each group
    of axes are all-gathered over those axes and added in rank order, so
    every process of one data replica reads the same value and replicas
    that drifted apart read different ones. The other tensors count whole
    (the params the model reads, replicated over 'data'). The shards are
    exact chunks (a degree splits a dim only where it divides it), so no
    padding enters the sum.
    """
    from gpt_2_distributed_torch.parallel.train_step import param_list

    groups: dict[tuple[str, ...], list[torch.Tensor]] = {}
    if sharded is None:
        groups[()] = param_list(params)
    else:
        for whole, shard, lay, gathered in zip(sharded.params, sharded.shards,
                                                sharded.layouts, sharded.gathered):
            if gathered:
                axes = sharded.mesh.axes_of({a for a, _ in lay.placement})
                groups.setdefault(axes, []).append(shard)
            else:
                groups.setdefault((), []).append(whole)
    total = None
    # Insertion order follows the tensors, so every process adds the same
    # groups in the same order.
    for axes, tensors in groups.items():
        part = torch.stack([t.sum(dtype=torch.float32) for t in tensors]).sum()
        for axis in axes:
            part = sharded.mesh.all_gather(part.reshape(1), (axis,)).sum()
        total = part if total is None else total + part
    return float(total)


def _gather_f64(value: float, group=None) -> list[float]:
    """Every process's ``value`` (as float64) over ``group`` (the default
    group when None), in rank order; on the current card under NCCL, on the
    CPU under gloo."""
    import torch.distributed as dist

    from gpt_2_distributed_torch.parallel.mesh import _ALL_GATHER

    on_card = "nccl" in str(dist.get_backend(group))
    device = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")
    mine = torch.tensor([value], dtype=torch.float64, device=device)
    out = torch.empty(dist.get_world_size(group), dtype=torch.float64, device=device)
    _ALL_GATHER(out, mine, group=group)
    return [float(v) for v in out.tolist()]


def check_fingerprints(fingerprint: float, mesh=None) -> list[int]:
    """All-gather every process's fingerprint (as float64) and return the
    ranks that differ from the most common value (:func:`mismatched_ranks`);
    ``[]`` when the mesh is in sync, and always with one process.

    The comparison is exact: the same program on the same data gives the
    same bits, so any difference is a real divergence."""
    if mesh is None or mesh.spec.n_devices == 1:
        return []
    return mismatched_ranks(_gather_f64(fingerprint, mesh.group))


def assert_pod_agreement(name: str, value: float) -> None:
    """Start-up barrier of an elastic resume: every process all-gathers
    ``value`` over the default group, and a disagreement raises, naming the
    minority ranks.

    After a world resize each process peeks the checkpoint's world record
    and re-derives the mesh and the grad-accum rescale on its own; a process
    that read a stale save dir (or was launched with other flags) must fail
    here, not desync the mesh at its first collective. No-op with one
    process; with several it is also the new world's first rendezvous.
    """
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return
    with get_tracer().span("pod_barrier", barrier=name):
        gathered = _gather_f64(value)
    bad = mismatched_ranks(gathered)
    if bad:
        raise RuntimeError(
            f"pod disagrees on {name} at startup: rank(s) "
            f"{', '.join(str(r) for r in bad)} differ "
            f"(gathered {gathered}); all hosts must "
            f"observe the same checkpoint world record and launch flags"
        )


def mismatched_ranks(values: list[float]) -> list[int]:
    """Ranks whose value differs from the modal value (ties broken toward the
    lowest rank's value, so a 1v1 split blames the higher rank)."""
    if not values:
        return []
    counts = Counter(values)
    top = max(counts.values())
    modal = next(v for v in values if counts[v] == top)
    return [i for i, v in enumerate(values) if v != modal]


@torch.no_grad()
def perturb_params(params: Iterable[torch.Tensor], factor: float) -> None:
    """Scale every tensor of ``params`` in place by ``factor`` (rounded to
    fp32, as the JAX package passes it), keeping each one's dtype.

    Fault injection for the desync detector (``--inject_desync_at``):
    every process calls it at the same step and only the last one's factor
    differs from 1.0. The training loop passes the optimizer's tensors, the
    fp32 master state itself."""
    f = float(torch.tensor(factor, dtype=torch.float32))
    for t in params:
        t.mul_(f)


# --- part 3: the hang watchdog -------------------------------------------------


class HangWatchdog:
    """Daemon thread that bounds how long a mesh can sit in a dead collective.

    The training loop calls :meth:`arm` after each completed optimizer step
    (arm-as-beat: the first arm comes after the first step, so the kernels'
    first build is outside the budget) and :meth:`disarm` around phases
    with no step cadence (eval, restore, the final save). If ``timeout_s``
    passes with no beat while armed, it fires: it dumps every thread's
    stack through ``faulthandler``, prints the open trace spans, runs
    ``on_hang`` (the emergency save) on its own daemon thread, abandoned
    after ``grace_s`` (a save whose collectives are dead may hang itself),
    and exits with ``exit_code`` (:data:`resilience.HANG_EXIT_CODE`).

    ``_exit`` is injectable so tests observe the firing instead of dying.
    """

    def __init__(
        self,
        timeout_s: float,
        on_hang: Callable[[], None] | None = None,
        exit_code: int = HANG_EXIT_CODE,
        grace_s: float = 10.0,
        _exit: Callable[[int], None] = os._exit,
    ) -> None:
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.on_hang = on_hang
        self.exit_code = int(exit_code)
        self.grace_s = float(grace_s)
        self.fired = False
        self._exit = _exit
        self._armed = False
        self._deadline = 0.0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "HangWatchdog":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="hang-watchdog", daemon=True
            )
            self._thread.start()
        return self

    def arm(self) -> None:
        with self._lock:
            self._armed = True
            self._deadline = time.monotonic() + self.timeout_s

    def beat(self) -> None:
        """A step completed: push the deadline out (no-op while disarmed)."""
        with self._lock:
            if self._armed:
                self._deadline = time.monotonic() + self.timeout_s

    def disarm(self) -> None:
        with self._lock:
            self._armed = False

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        interval = min(self.timeout_s / 4.0, 0.5)
        while not self._stop.wait(interval):
            with self._lock:
                expired = self._armed and time.monotonic() > self._deadline
            if expired:
                self._fire()
                return

    def _fire(self) -> None:
        self.fired = True
        print(
            f"[watchdog] no optimizer step completed in {self.timeout_s:g}s "
            f"(collective deadlock or dead peer process?); dumping stacks and "
            f"exiting rc {self.exit_code} for a supervised full-job restart",
            flush=True,
        )
        try:
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        except Exception:  # noqa: BLE001 — a captured stderr has no fd
            pass
        # The stacks name the frame the process hangs in; the span stack
        # names the phase ("step > step_dispatch" or "step >
        # consensus_exchange").
        try:
            tracer = get_tracer()
            if tracer.enabled:
                msg = "[watchdog] " + tracer.format_open_spans()
                print(msg, flush=True)
                print(msg, file=sys.stderr, flush=True)
                tracer.event("hang_watchdog_fired", timeout_s=self.timeout_s)
        except Exception:  # noqa: BLE001 — the process is exiting
            pass
        if self.on_hang is not None:
            t = threading.Thread(
                target=self._run_on_hang, name="watchdog-emergency", daemon=True
            )
            t.start()
            t.join(self.grace_s)
            if t.is_alive():
                print(
                    f"[watchdog] emergency save did not finish within "
                    f"{self.grace_s:g}s grace; abandoning it",
                    flush=True,
                )
        self._exit(self.exit_code)

    def _run_on_hang(self) -> None:
        try:
            self.on_hang()
        except BaseException as exc:  # noqa: BLE001 — the process is exiting; log only
            print(
                f"[watchdog] emergency save failed: "
                f"{type(exc).__name__}: {exc}",
                flush=True,
            )
