"""Resilience (``gpt_2_distributed_tpu/resilience.py``): the layers that
keep a long training run alive.

* **Layer 1, the non-finite step guard**: its state and reason codes
  (the guarded step itself is ``parallel/train_step.py``'s).
* **Layer 2, loss-spike rollback**: :class:`SpikeMonitor` keeps an EMA of
  the loss and flags spikes by z-score; after ``--max_consecutive_skips``
  anomalies in a row the training loop restores the last verified
  checkpoint and skips the data cursor past the offending batches.
* **Layer 3, checkpoint integrity**: :func:`write_manifest` records every
  file's size and, for files up to :data:`CRC_MAX_BYTES`, its CRC-32C in
  ``manifest.json``; :func:`verify_checkpoint` checks them, and
  ``checkpoint.restore_latest_verified`` falls back past checkpoints that
  fail.
* **Layer 4, preemption**: :class:`PreemptionHandler` turns SIGTERM into a
  flag the loop reads at each step boundary, where it saves one emergency
  checkpoint and exits :data:`PREEMPTED_EXIT_CODE` (which
  ``scripts/supervise.sh`` relaunches with ``--resume``);
  :class:`PreemptionPoller` raises the same flag from a notice endpoint
  (a ``file://`` path, or an ``http`` URL that the operator names). The
  serving entry points use the handler for their graceful drain.

The serving fleet's side: :func:`worker_env` builds a serving worker
process's environment, and :class:`FaultInjector` (with
:func:`parse_fault_spec`, the ``--inject_replica_*`` flag grammar) fires
deterministic replica faults inside the driver's containment path.
"""

from __future__ import annotations

import json
import math
import os
import signal
import sys
import threading
import urllib.request
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


# --- layer 2: the loss-spike monitor ----------------------------------------


class SpikeMonitor:
    """EMA z-score loss monitor driving the rollback policy.

    ``observe(loss, skipped)`` per optimizer step returns:

    * ``None`` — the step looks healthy (and updated the EMA baseline),
    * ``"anomaly"`` — the guard skipped the step, its loss is non-finite,
      or its z-score against the EMA baseline exceeds ``sigma``,
    * ``"rollback"`` — the ``max_consecutive``-th anomaly in a row: restore
      the last verified checkpoint and skip past the offending batches.

    Anomalous losses never update the EMA, and z-scoring only starts after
    ``warmup`` healthy observations, so a fresh run's falling loss is not
    read as a spike. Skipped or non-finite steps count from step one.
    """

    def __init__(
        self,
        sigma: float = 6.0,
        max_consecutive: int = 3,
        warmup: int = 20,
        ema_decay: float = 0.98,
    ) -> None:
        if sigma <= 0:
            raise ValueError(f"sigma must be > 0, got {sigma}")
        if max_consecutive < 1:
            raise ValueError(f"max_consecutive must be >= 1, got {max_consecutive}")
        self.sigma = float(sigma)
        self.max_consecutive = int(max_consecutive)
        self.warmup = int(warmup)
        self.ema_decay = float(ema_decay)
        self.reset()

    def reset(self) -> None:
        """Full reset (after a rollback the restored params live in an older
        loss regime, so the baseline restarts too)."""
        self.mean = 0.0
        self.var = 0.0
        self.n_healthy = 0
        self.consecutive = 0

    def state_dict(self) -> dict:
        """The EMA baseline for ``meta.json``, so a resumed run keeps its
        spike detection armed. ``consecutive`` is not saved: an anomaly
        streak must not outlive a restart."""
        return {"mean": self.mean, "var": self.var, "n_healthy": self.n_healthy}

    def load_state_dict(self, state: dict) -> None:
        """Restore a :meth:`state_dict` baseline; resets the anomaly streak."""
        self.mean = float(state["mean"])
        self.var = float(state["var"])
        self.n_healthy = int(state["n_healthy"])
        self.consecutive = 0

    def _threshold(self) -> float:
        # A floor on the std: a converged, nearly flat loss would otherwise
        # turn ordinary batch noise into huge z-scores.
        return self.sigma * max(math.sqrt(self.var), 1e-3 + 0.01 * abs(self.mean))

    def observe(self, loss: float, skipped: bool = False) -> str | None:
        loss = float(loss)
        anomaly = bool(skipped) or not math.isfinite(loss)
        if not anomaly and self.n_healthy >= self.warmup:
            # One-sided: only upward spikes are pathological.
            anomaly = (loss - self.mean) > self._threshold()
        if anomaly:
            self.consecutive += 1
            if self.consecutive >= self.max_consecutive:
                return "rollback"
            return "anomaly"
        self.consecutive = 0
        if self.n_healthy == 0:
            self.mean = loss
        else:
            delta = loss - self.mean
            self.mean += (1.0 - self.ema_decay) * delta
            self.var = self.ema_decay * (self.var + (1.0 - self.ema_decay) * delta * delta)
        self.n_healthy += 1
        return None


# --- layer 3: the checkpoint manifest ---------------------------------------

MANIFEST_NAME = "manifest.json"
# Files up to this size get a CRC-32C in the manifest; larger ones (the
# tensor files at real model sizes) are size-checked only: truncation, the
# failure this layer exists for, shows in the size, and a pure-Python CRC
# over GiB files would stall every save and restore.
CRC_MAX_BYTES = 1024 * 1024
# The commit protocol's markers (checkpoint.py) change after the manifest is
# written, so they stay out of it.
_UNLISTED = (MANIFEST_NAME, MANIFEST_NAME + ".tmp", ".INPROGRESS", "COMMITTED",
             "COMMITTED.tmp")

_CRC32C_TABLE: list[int] = []


def _crc32c_table() -> list[int]:
    if not _CRC32C_TABLE:
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            _CRC32C_TABLE.append(c)
    return _CRC32C_TABLE


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli), in pure Python (bounded by CRC_MAX_BYTES).
    Check value: ``crc32c(b"123456789") == 0xE3069283``."""
    table = _crc32c_table()
    crc = ~crc & 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ table[(crc ^ b) & 0xFF]
    return ~crc & 0xFFFFFFFF


def _file_crc32c(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(256 * 1024), b""):
            crc = crc32c(chunk, crc)
    return crc


def build_manifest(path: str, step: int) -> dict:
    """Every file under a checkpoint dir but the commit markers: relative
    path and size, and a CRC-32C for files up to CRC_MAX_BYTES."""
    entries = []
    for root, _dirs, files in os.walk(path):
        for name in sorted(files):
            fp = os.path.join(root, name)
            rel = os.path.relpath(fp, path)
            if rel in _UNLISTED:
                continue
            size = os.path.getsize(fp)
            entry: dict = {"path": rel, "size": size}
            if size <= CRC_MAX_BYTES:
                entry["crc32c"] = format(_file_crc32c(fp), "08x")
            entries.append(entry)
    entries.sort(key=lambda e: e["path"])
    return {"format": 1, "step": int(step), "entries": entries}


def write_manifest(path: str, step: int) -> str:
    """Write ``manifest.json`` via tmp + fsync + atomic rename."""
    manifest = build_manifest(path, step)
    target = os.path.join(path, MANIFEST_NAME)
    tmp = target + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, target)
    return target


def verify_checkpoint(path: str) -> list[str]:
    """The problems of one checkpoint dir (empty = verified).

    With a manifest every entry must exist with its size, and match its
    CRC-32C where one was recorded. Without one (a save that died before
    its manifest) only the structure is checked: ``meta.json`` parses and
    the ``params/`` and ``opt_state/`` dirs exist.
    """
    problems: list[str] = []
    try:
        with open(os.path.join(path, "meta.json")) as f:
            json.load(f)
    except (OSError, ValueError) as exc:
        problems.append(f"meta.json unreadable: {exc}")
    for item in ("params", "opt_state"):
        if not os.path.isdir(os.path.join(path, item)):
            problems.append(f"{item}/ missing")

    manifest_path = os.path.join(path, MANIFEST_NAME)
    if not os.path.exists(manifest_path):
        return problems
    try:
        with open(manifest_path) as f:
            entries = json.load(f)["entries"]
    except (OSError, ValueError, KeyError, TypeError) as exc:
        problems.append(f"{MANIFEST_NAME} unreadable: {exc}")
        return problems
    for entry in entries:
        rel = entry["path"]
        fp = os.path.join(path, rel)
        if not os.path.exists(fp):
            problems.append(f"{rel}: missing")
            continue
        size = os.path.getsize(fp)
        if size != entry["size"]:
            problems.append(f"{rel}: size {size} != recorded {entry['size']}")
            continue
        want = entry.get("crc32c")
        if want is not None:
            got = format(_file_crc32c(fp), "08x")
            if got != want:
                problems.append(f"{rel}: crc32c {got} != recorded {want}")
    return problems


# --- layer 4: preemption-safe shutdown --------------------------------------

PREEMPTED_EXIT_CODE = 143  # 128 + SIGTERM: the conventional "killed by TERM" rc

# The mesh fault detectors' exit codes (coordination.py). Both are restarts
# that burn a supervise.sh attempt, unlike preemption's free rc 143: a hang
# or a data-worker death is a fault, not scheduled churn.
HANG_EXIT_CODE = 170        # hang watchdog fired: no step within --hang_timeout_s
DATA_ABORT_EXIT_CODE = 171  # coordinated abort: a data worker died on some process


class PreemptionHandler:
    """SIGTERM -> flag, checked by the driver at each step boundary.

    Training saves one emergency checkpoint at the next step boundary and
    exits :data:`PREEMPTED_EXIT_CODE`, for ``scripts/supervise.sh`` to
    relaunch with ``--resume``. The serving stack uses the flag for its
    graceful drain: SIGTERM to
    ``gpt2-torch-serve`` / ``gpt2-torch-frontend`` finishes the in-flight
    requests, refuses new submits and exits 0 (``EngineDriver`` polls
    :meth:`preempted` between steps). ``notice`` is the announcement
    printed, once, when the flag rises; it goes to stderr, so a CLI's
    JSONL on stdout stays whole.
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
        """Raise the flag from any source (the signal handler,
        :class:`PreemptionPoller`, a test).
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


class PreemptionPoller:
    """Poll a preemption-notice endpoint on a daemon thread; raise the same
    flag as :class:`PreemptionHandler`.

    A cloud's metadata server can post a preemption notice seconds before
    the SIGTERM lands; polling it buys grace time for the emergency save.
    ``url`` is anything ``urllib`` opens: an ``http`` endpoint the operator
    names with ``--preempt_poll_url``, or a ``file://`` notice file. A body
    starting with TRUE is a notice; it calls ``handler.trigger`` (when a
    handler is attached) and sets the poller's own flag. Endpoint errors
    are counted in ``poll_errors`` and never raise.
    """

    def __init__(self, url: str, interval_s: float = 5.0,
                 handler: PreemptionHandler | None = None) -> None:
        self.url = url
        self.interval_s = interval_s
        self.handler = handler
        self.poll_errors = 0
        self._flag = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def poll_once(self) -> bool:
        """One synchronous check; True iff the endpoint reports preemption."""
        try:
            req = urllib.request.Request(self.url, headers={"Metadata-Flavor": "Google"})
            with urllib.request.urlopen(req, timeout=2) as resp:
                body = resp.read(64).decode("utf-8", "replace").strip()
            return body.upper().startswith("TRUE")
        except Exception:  # noqa: BLE001 — counted, never raised
            self.poll_errors += 1
            return False

    def _run(self) -> None:
        while not self._stop.is_set():
            if self.poll_once():
                self._flag = True
                print(f"[preempt] preemption notice ({self.url})", file=sys.stderr,
                      flush=True)
                if self.handler is not None:
                    self.handler.trigger("preemption notice")
                return
            self._stop.wait(self.interval_s)

    def start(self) -> "PreemptionPoller":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, name="preempt-poller",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def preempted(self) -> bool:
        return self._flag


_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker_env(device: str, extra: dict | None = None) -> dict:
    """The environment of a serving worker process
    (``forced_host_device_env`` of the JAX package, which pins virtual CPU
    devices; a torch worker has none to pin): this process's environment
    with the repo on ``PYTHONPATH``, so ``python -m`` finds the package
    from any working directory. On the CPU (``device`` "cpu") the worker's
    intra-op thread pool is pinned to one thread unless ``OMP_NUM_THREADS``
    already says otherwise: N workers each with torch's default pool (one
    thread a core) oversubscribe the host N times. ``extra`` overlays
    additional variables last. Imports no torch: the spawner builds worker
    environments before the frontend ever imports it."""
    env = dict(os.environ)
    env["PYTHONPATH"] = (_REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")).rstrip(os.pathsep)
    if device.startswith("cpu"):
        env.setdefault("OMP_NUM_THREADS", "1")
    if extra:
        env.update(extra)
    return env


class InjectedFault(RuntimeError):
    """Raised by :class:`FaultInjector` at its configured trigger point."""


def parse_fault_spec(spec: str, flag: str) -> tuple[int, int | None]:
    """Parse ``"STEP"`` or ``"STEP:REPLICA"`` (the ``--inject_*`` flag
    grammar, as ``--xla_profile_at``'s ``STEP[:N]``). Returns ``(step,
    replica)`` with ``replica=None`` meaning "first replica stepped at or
    after STEP". Raises ValueError with the JAX package's texts."""
    parts = str(spec).split(":")
    if len(parts) > 2:
        raise ValueError(f"{flag}={spec!r}: expected STEP or STEP:REPLICA")
    try:
        step = int(parts[0])
        replica = int(parts[1]) if len(parts) == 2 else None
    except ValueError:
        raise ValueError(f"{flag}={spec!r}: STEP and REPLICA must be integers") from None
    if step < 1:
        raise ValueError(f"{flag}={spec!r}: STEP must be >= 1")
    if replica is not None and replica < 0:
        raise ValueError(f"{flag}={spec!r}: REPLICA must be >= 0")
    return step, replica


class FaultInjector:
    """Deterministic fault injection for the serving fleet (tests and chaos
    runs; never constructed in production).

    The driver calls :meth:`tick(step, replica)` immediately before each
    replica's ``step()``, inside the containment wrapper and the watchdog
    window. Each configured fault fires ONCE, at the first tick whose fleet
    step is >= the spec's STEP and whose replica matches (``>=``, not
    ``==``: a replica with no work that tick would otherwise dodge the
    fault forever):

    * ``fail_at`` — raise :class:`InjectedFault`: the "replica crashed"
      scenario (containment + migration).
    * ``hang_at`` — block cooperatively until :meth:`release_hangs` (the
      watchdog's trip path calls it) or ``hang_max_s``, then raise: the
      "replica wedged" scenario, driven through the whole detect ->
      condemn -> migrate chain deterministically.
    * ``exception_at`` — replica-agnostic raise in whichever replica steps
      first at or after the step.
    * ``kill_at`` + ``kill_fn`` — call ``kill_fn(replica)`` and return
      WITHOUT raising: the "process killed from outside" scenario for
      worker placements. The kill (a SIGKILL or SIGSTOP of the worker, a
      network partition) must then be DETECTED, as a broken or timed-out
      RPC on the very step the injector let proceed, or by heartbeat loss.
    """

    def __init__(
        self,
        fail_at: tuple[int, int | None] | None = None,
        hang_at: tuple[int, int | None] | None = None,
        exception_at: int | None = None,
        hang_max_s: float = 120.0,
        kill_at: tuple[int, int | None] | None = None,
        kill_fn=None,
    ) -> None:
        self.fail_at = fail_at
        self.hang_at = hang_at
        self.exception_at = exception_at
        self.hang_max_s = float(hang_max_s)
        self.kill_at = kill_at
        self.kill_fn = kill_fn
        self.fail_fired = False
        self.hang_fired = False
        self.exception_fired = False
        self.kill_fired = False
        self._release = threading.Event()

    @staticmethod
    def _match(spec, step: int, replica: int) -> bool:
        return step >= spec[0] and (spec[1] is None or replica == spec[1])

    def release_hangs(self) -> None:
        """Unblock any in-progress (and all future) injected hangs."""
        self._release.set()

    def tick(self, step: int, replica: int) -> None:
        if (self.kill_at is not None and not self.kill_fired
                and self.kill_fn is not None
                and self._match(self.kill_at, step, replica)):
            self.kill_fired = True
            self.kill_fn(replica)
        if (self.fail_at is not None and not self.fail_fired
                and self._match(self.fail_at, step, replica)):
            self.fail_fired = True
            raise InjectedFault(f"injected replica failure (step {step}, replica {replica})")
        if (self.exception_at is not None and not self.exception_fired
                and step >= self.exception_at):
            self.exception_fired = True
            raise InjectedFault(f"injected step exception (step {step})")
        if (self.hang_at is not None and not self.hang_fired
                and self._match(self.hang_at, step, replica)):
            self.hang_fired = True
            released = self._release.wait(self.hang_max_s)
            raise InjectedFault(
                f"injected replica hang (step {step}, replica {replica}) "
                + ("released by watchdog" if released
                   else f"expired after {self.hang_max_s:g}s")
            )
