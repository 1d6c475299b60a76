"""Span-based structured tracing runtime
(``gpt_2_distributed_tpu/obs/trace.py``).

One `Tracer` per process emits JSONL records to ``trace-p{rank}.jsonl``
inside a trace directory shared by a run's processes;
``scripts/obs_report.py`` merges
the per-process files back into per-phase step breakdowns and per-request
serving waterfalls.

Design constraints, in order:

1. **Disabled must be free.** The default-constructed tracer is disabled:
   ``span()`` returns a shared singleton no-op context manager without
   allocating a span object or touching the clock, ``event()``/``counter()``
   return immediately, and no file is ever opened. Instrumentation in the
   training step loop and the serving decode loop therefore costs one
   attribute load + one branch per call site when tracing is off.
2. **Spans nest per thread.** Each thread owns a stack (``threading.local``);
   a span's parent is whatever span that same thread had open at entry.
   Cross-thread work (the front end's engine-driver thread beside its
   asyncio thread) gets its own root spans rather than false parents.
3. **Crash-readable.** Records are written line-buffered as spans *close*
   (never on open), so a hang leaves the open stack visible to
   ``open_spans()`` and a crash loses at most the spans still open.
4. **Bounded on disk.** When the live file passes ``max_file_bytes`` it is
   rotated to ``.1`` (one generation kept), so a runaway loop writes at most
   ``2 * max_file_bytes`` per process.

Timestamps are ``time.perf_counter()`` (CLOCK_MONOTONIC on Linux — the same
clock the serving engine stamps request lifecycles with, so TTFT rebuilt
from trace events matches the engine's own accounting). Each file opens with
a ``meta`` record pairing one ``perf_counter`` reading with ``time.time()``
so the report tool can align processes on the wall clock.

Host spans optionally bridge into the device timeline: while an on-demand
profiler capture is active (``--xla_profile_at``, a ``torch.profiler``
window), every open span also enters ``torch.profiler.record_function(name)``,
so the exported Chrome trace shows ``decode`` / ``step_dispatch`` /
``device_sync`` bars above the kernels they launch. Outside a capture no
annotation is ever entered. The flag keeps the JAX CLIs' name.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any

TRACE_FILE_TEMPLATE = "trace-p{rank}.jsonl"
DEFAULT_MAX_FILE_BYTES = 64 * 1024 * 1024


class _NullSpan:
    """Shared no-op span: what a disabled tracer hands every caller."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: object) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    """A live span. Created by ``Tracer.span`` only when tracing is enabled."""

    __slots__ = ("_tracer", "name", "attrs", "sid", "parent", "t0", "_ann")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.sid = 0
        self.parent: int | None = None
        self.t0 = 0.0
        self._ann = None

    def set(self, **attrs: Any) -> "_Span":
        """Attach attributes after entry (e.g. a result computed mid-span)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        tr = self._tracer
        stack = tr._stack()
        self.parent = stack[-1].sid if stack else None
        self.sid = tr._next_sid()
        stack.append(self)
        if tr._annotate:
            import torch.profiler

            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: object) -> bool:
        dur = time.perf_counter() - self.t0
        if self._ann is not None:
            self._ann.__exit__(*exc)
            self._ann = None
        tr = self._tracer
        stack = tr._stack()
        # Tolerate teardown orderings (e.g. a SystemExit unwinding through
        # several spans): pop this span wherever it sits.
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        rec = {
            "ph": "span",
            "name": self.name,
            "pid": tr.process_index,
            "tid": threading.get_ident(),
            "sid": self.sid,
            "parent": self.parent,
            "ts": self.t0,
            "dur": dur,
        }
        if self.attrs:
            rec["attrs"] = self.attrs
        tr._emit(rec)
        return False


class Tracer:
    """Per-process span/event/counter recorder with JSONL emission.

    A process normally has exactly one, reachable through ``get_tracer()``
    and configured once at startup by ``configure_tracing()``. Library code
    never constructs tracers; it calls ``get_tracer().span(...)`` and relies
    on the disabled fast path when the run didn't ask for traces.
    """

    def __init__(
        self,
        trace_dir: str | None = None,
        *,
        process_index: int = 0,
        enabled: bool = False,
        max_file_bytes: int = DEFAULT_MAX_FILE_BYTES,
    ):
        self.enabled = enabled and trace_dir is not None
        self.trace_dir = trace_dir
        self.process_index = process_index
        self.max_file_bytes = max_file_bytes
        self._annotate = False
        self._sid = 0
        self._sid_lock = threading.Lock()
        self._write_lock = threading.Lock()
        self._local = threading.local()
        # tid -> live stack, for cross-thread snapshots (open_spans).
        self._stacks: dict[int, list[_Span]] = {}
        self._file = None
        self._bytes = 0
        self.dropped_records = 0

    # -- configuration -------------------------------------------------------

    def configure(
        self,
        trace_dir: str | None,
        *,
        process_index: int = 0,
        enabled: bool = True,
        max_file_bytes: int | None = None,
    ) -> "Tracer":
        """(Re)configure in place so references captured earlier stay valid."""
        self.close()
        self.trace_dir = trace_dir
        self.process_index = process_index
        if max_file_bytes is not None:
            self.max_file_bytes = max_file_bytes
        self.enabled = enabled and trace_dir is not None
        return self

    @property
    def trace_path(self) -> str | None:
        if self.trace_dir is None:
            return None
        return os.path.join(
            self.trace_dir, TRACE_FILE_TEMPLATE.format(rank=self.process_index)
        )

    def set_annotate(self, on: bool) -> None:
        """Bridge host spans into the device timeline while a profiler
        capture is active (``torch.profiler.record_function``)."""
        self._annotate = bool(on and self.enabled)

    # -- recording -----------------------------------------------------------

    def span(self, name: str, **attrs: Any):
        """Context manager timing a phase. Nesting derives parent links."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs)

    def event(self, name: str, ts: float | None = None, **attrs: Any) -> None:
        """Instant event. ``ts`` (perf_counter/monotonic domain) may be
        passed explicitly so the record carries the *same* timestamp other
        code already took — the serving engine does this so trace-derived
        TTFT equals engine-derived TTFT exactly."""
        if not self.enabled:
            return
        rec = {
            "ph": "event",
            "name": name,
            "pid": self.process_index,
            "tid": threading.get_ident(),
            "ts": time.perf_counter() if ts is None else ts,
        }
        if attrs:
            rec["attrs"] = attrs
        self._emit(rec)

    def counter(self, name: str, value: float, **attrs: Any) -> None:
        if not self.enabled:
            return
        rec = {
            "ph": "counter",
            "name": name,
            "pid": self.process_index,
            "ts": time.perf_counter(),
            "value": value,
        }
        if attrs:
            rec["attrs"] = attrs
        self._emit(rec)

    # -- introspection -------------------------------------------------------

    def open_spans(self) -> dict[int, list[str]]:
        """Snapshot of currently-open span names per thread id, innermost
        last: what a hang dump prints so a hang names its phase."""
        with self._write_lock:
            return {
                tid: [s.name for s in stack]
                for tid, stack in self._stacks.items()
                if stack
            }

    def format_open_spans(self) -> str:
        snap = self.open_spans()
        if not snap:
            return "open spans: (none)"
        lines = ["open spans (innermost last):"]
        for tid, names in sorted(snap.items()):
            lines.append(f"  thread {tid}: " + " > ".join(names))
        return "\n".join(lines)

    # -- internals -----------------------------------------------------------

    def _stack(self) -> list[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = []
            self._local.stack = stack
            with self._write_lock:
                self._stacks[threading.get_ident()] = stack
        return stack

    def _next_sid(self) -> int:
        with self._sid_lock:
            self._sid += 1
            return self._sid

    def _open_file(self) -> None:
        path = self.trace_path
        assert path is not None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._file = open(path, "a", buffering=1, encoding="utf-8")
        self._bytes = self._file.tell()
        if self._bytes == 0:
            meta = {
                "ph": "meta",
                "pid": self.process_index,
                "wall": time.time(),
                "perf": time.perf_counter(),
                "version": 1,
            }
            line = json.dumps(meta, separators=(",", ":")) + "\n"
            self._file.write(line)
            self._bytes += len(line)

    def _emit(self, rec: dict[str, Any]) -> None:
        try:
            line = json.dumps(rec, separators=(",", ":"), default=str) + "\n"
        except (TypeError, ValueError):
            self.dropped_records += 1
            return
        with self._write_lock:
            try:
                if self._file is None:
                    self._open_file()
                if self._bytes + len(line) > self.max_file_bytes:
                    self._rotate_locked()
                self._file.write(line)
                self._bytes += len(line)
            except OSError:
                # Tracing must never take the run down with it.
                self.dropped_records += 1

    def _rotate_locked(self) -> None:
        path = self.trace_path
        assert path is not None and self._file is not None
        self._file.close()
        os.replace(path, path + ".1")
        self._file = open(path, "a", buffering=1, encoding="utf-8")
        self._bytes = 0

    def close(self) -> None:
        with self._write_lock:
            if self._file is not None:
                self._file.close()
                self._file = None
            self._bytes = 0


_GLOBAL_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer. Disabled (a pure no-op) until
    ``configure_tracing`` is called with a trace directory."""
    return _GLOBAL_TRACER


def configure_tracing(
    trace_dir: str | None,
    *,
    process_index: int = 0,
    max_file_bytes: int | None = None,
) -> Tracer:
    """Enable (trace_dir set) or disable (None) the global tracer."""
    return _GLOBAL_TRACER.configure(
        trace_dir,
        process_index=process_index,
        enabled=trace_dir is not None,
        max_file_bytes=max_file_bytes,
    )


def parse_profile_at(spec: str | None) -> tuple[int, int] | None:
    """Parse ``--xla_profile_at STEP[:NSTEPS]`` -> (start_step, n_steps).

    ``"200"`` captures step 200 only; ``"200:5"`` captures steps 200-204.
    """
    if not spec:
        return None
    head, _, tail = spec.partition(":")
    step = int(head)
    n = int(tail) if tail else 1
    if step < 0 or n < 1:
        raise ValueError(
            f"--xla_profile_at wants STEP[:NSTEPS] with STEP>=0, NSTEPS>=1; got {spec!r}"
        )
    return step, n


PROFILE_SUBDIR = "xla_profile"


class ProfilerCapture:
    """On-demand ``torch.profiler`` window: arms at ``start_step``,
    captures ``n_steps`` optimizer (or engine) steps, exports a Chrome
    trace ``trace-p{rank}.json`` into ``<out_dir>/<subdir>/`` (by default
    ``xla_profile``, the JAX CLIs' directory name), and turns the tracer's ``record_function`` bridge on for the window so
    host spans land in the device timeline. Drive it with
    ``maybe_start(step)`` / ``maybe_stop(step)`` around each step; both are
    no-ops outside the window (and when ``spec`` is None the instance is
    inert). The card's kernels are recorded where CUDA is available.
    """

    def __init__(self, spec: tuple[int, int] | None, out_dir: str | None,
                 subdir: str = PROFILE_SUBDIR, rank: int = 0):
        self.spec = spec
        self.out_dir = out_dir
        self.subdir = subdir
        self.rank = rank
        self.active = False
        self.done = spec is None or out_dir is None
        self.trace_file: str | None = None
        self._prof = None

    @property
    def profile_dir(self) -> str | None:
        if self.out_dir is None:
            return None
        return os.path.join(self.out_dir, self.subdir)

    def maybe_start(self, step: int) -> bool:
        if self.done or self.active:
            return False
        start, _ = self.spec  # type: ignore[misc]
        if step < start:
            return False
        import torch
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(self.profile_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        get_tracer().set_annotate(True)
        get_tracer().event("xla_profile_start", step=step)
        self.active = True
        return True

    def maybe_stop(self, step: int) -> bool:
        """Call with the step that just finished; stops after the window."""
        if not self.active:
            return False
        start, n = self.spec  # type: ignore[misc]
        if step < start + n - 1:
            return False
        self._stop()
        get_tracer().event("xla_profile_stop", step=step)
        return True

    def stop_if_active(self) -> None:
        """Teardown guard: end a capture the loop exited out of early."""
        if self.active:
            self._stop()

    def _stop(self) -> None:
        """Close the profiler (it waits for the device's pending records)
        and export its Chrome trace."""
        prof, self._prof = self._prof, None
        get_tracer().set_annotate(False)
        self.active = False
        self.done = True
        prof.__exit__(None, None, None)
        self.trace_file = os.path.join(
            self.profile_dir, f"trace-p{self.rank}.json")
        prof.export_chrome_trace(self.trace_file)
