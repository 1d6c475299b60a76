"""Resilience (``gpt_2_distributed_tpu/resilience.py``): the non-finite
step guard's state (layer 1) and the SIGTERM flag (layer 4).

Ported so far: the guard state and its reason codes, and
:class:`PreemptionHandler`, which the serving entry points install for
their graceful drain. The loss-spike monitor with rollback, checkpoint
integrity and training's emergency save on SIGTERM need checkpoints, which
come with the port's checkpoint slice.
"""

from __future__ import annotations

import signal
import sys
from typing import NamedTuple

# Reason codes for a skipped step (0 = never skipped).
SKIP_NONE = 0
SKIP_NONFINITE_LOSS = 1
SKIP_NONFINITE_GRAD = 2
SKIP_REASON_NAMES = {
    SKIP_NONE: "none",
    SKIP_NONFINITE_LOSS: "nonfinite_loss",
    SKIP_NONFINITE_GRAD: "nonfinite_grad",
}


class GuardState(NamedTuple):
    """Anomaly-guard counters. Host integers: the guarded step reads the
    loss and grad norm on the host to decide anyway."""

    skipped_steps: int = 0      # total updates skipped this run
    last_skip_reason: int = 0   # SKIP_* code of the latest skip
    clipped_steps: int = 0      # finite-but-huge grads clipped and applied


def init_guard_state() -> GuardState:
    return GuardState()


# --- layer 4: preemption-safe shutdown --------------------------------------

PREEMPTED_EXIT_CODE = 143  # 128 + SIGTERM: the conventional "killed by TERM" rc


class PreemptionHandler:
    """SIGTERM -> flag, checked by the driver at each step boundary.

    The serving stack uses the flag for its graceful drain: SIGTERM to
    ``gpt2-torch-serve`` / ``gpt2-torch-frontend`` finishes the in-flight
    requests, refuses new submits and exits 0 (``EngineDriver`` polls
    :meth:`preempted` between steps). ``notice`` is the announcement
    printed, once, when the flag rises; it goes to stderr, so a CLI's
    JSONL on stdout stays whole. Training's use (an emergency checkpoint,
    then exit :data:`PREEMPTED_EXIT_CODE`) comes with the checkpoint slice.
    """

    def __init__(
        self,
        signals: tuple[int, ...] = (signal.SIGTERM,),
        notice: str | None = None,
    ) -> None:
        self.signals = signals
        self.notice = notice or (
            f"will save an emergency checkpoint and exit "
            f"{PREEMPTED_EXIT_CODE} at the next step boundary"
        )
        self._flag = False
        self._prev: dict[int, object] = {}

    def _on_signal(self, signum, frame) -> None:  # noqa: ARG002 — signal API
        self.trigger(f"received signal {signum}")

    def trigger(self, reason: str) -> None:
        """Raise the flag from any source (the signal handler, a test).
        Safe from any thread (a bool store is atomic under the GIL),
        idempotent."""
        already = self._flag
        self._flag = True
        if not already:
            from gpt_2_distributed_torch.obs.trace import get_tracer

            get_tracer().event("preempt_notice", reason=reason)
            print(f"[preempt] {reason}; {self.notice}", file=sys.stderr, flush=True)

    def install(self) -> "PreemptionHandler":
        """Install the handlers (main thread only: the signal module's
        contract); re-installation resets the flag, so one handler object
        can serve repeated in-process runs."""
        self._flag = False
        for s in self.signals:
            self._prev[s] = signal.signal(s, self._on_signal)
        return self

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()

    def preempted(self) -> bool:
        return self._flag
