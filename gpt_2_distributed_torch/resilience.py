"""The non-finite step guard's state (``gpt_2_distributed_tpu/resilience.py``,
layer 1).

Only the guard state and its reason codes are ported so far. The loss-spike
monitor with rollback, checkpoint integrity and preemption handling need
checkpoints, which come with the port's resilience slice.
"""

from __future__ import annotations

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
