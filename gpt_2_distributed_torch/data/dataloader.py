"""Streaming token-shard data pipeline (``gpt_2_distributed_tpu/data/
dataloader.py``).

The port's own copy of the JAX package's loader, batch for batch:

* flat little-endian uint16 token streams in ``*.bin`` shards, a shard
  belonging to a split iff the split name is in its file name;
* an epoch-seeded global shard permutation identical on every process, then
  a ``(process, worker)`` stride over it; non-overlapping ``seq_len``-stride
  windows within a shard, shuffled with an ``epoch ^ rank ^ worker`` seed;
  shards shorter than ``seq_len + 1`` tokens yield nothing;
* ``x = window[:-1]``, ``y = window[1:]`` as int32 ``[B, T]`` numpy arrays;
* worker threads each assemble whole batches of their own shards, and the
  loader round-robins batches across workers (drop_last per worker);
* a resume skip that is arithmetic (file sizes and the deterministic
  offset lists; nothing before the cursor is read);
* the elastic cursor migration: :func:`plan_cursor_migration` rebuilds,
  from file sizes and seeds alone, the windows a world of another loader
  shape consumed this epoch, :func:`replay_cursor_history` folds a
  same-epoch resize history into one such plan,
  :func:`cursor_plan_digest` fingerprints it (equal to the JAX package's
  digest of the same plan), and :meth:`TokenShardDataset.set_consumed`
  makes a dataset of any shape resume on exactly the complement.

Worker 0 can be made to fail after N batches (``--inject_worker_fail_at``),
through the same worker-error path a real failure takes. Left out: the
JAX package's native gather fast path (it yields the same windows).
Process identity defaults to a single process (rank 0 of 1).
"""

from __future__ import annotations

import glob
import os
import queue
import random
import threading
import time
from queue import Full
from typing import Iterator, Sequence

import numpy as np

DEFAULT_BATCH_SIZE = 4
DEFAULT_CONTEXT_LENGTH = 1024
DEFAULT_NUM_WORKERS = 2
DEFAULT_PREFETCH_FACTOR = 2


def get_shard_paths(data_dir: str, split: str, extension: str = ".bin") -> list[str]:
    """Shard files of ``split`` (split name in the file name), sorted."""
    return sorted(
        p
        for p in glob.glob(os.path.join(data_dir, f"*{extension}"))
        if split in os.path.basename(p)
    )


def _offset_seed(epoch: int, process_index: int, worker_id: int) -> int:
    """Per-(epoch, process, worker) seed for intra-shard offset shuffling."""
    return (epoch * 17) ^ (process_index * 971) ^ (worker_id * 31)


class TokenShardDataset:
    """Deterministically partitioned streaming view over uint16 token
    shards. ``shard_windows=True`` (eval) has every worker walk every shard
    and stride the windows within it instead of striding the shards."""

    def __init__(
        self,
        shard_paths: Sequence[str],
        seq_len: int = DEFAULT_CONTEXT_LENGTH,
        process_index: int = 0,
        process_count: int = 1,
        num_workers: int = DEFAULT_NUM_WORKERS,
        vocab_size: int | None = None,
        shard_windows: bool = False,
        data_read_retries: int = 2,
    ) -> None:
        if not shard_paths:
            raise ValueError("shard_paths is empty — no data to train on")
        if seq_len < 1:
            raise ValueError(f"seq_len must be >= 1, got {seq_len}")
        if data_read_retries < 0:
            raise ValueError(
                f"data_read_retries must be >= 0, got {data_read_retries}"
            )
        self.shard_paths = list(shard_paths)
        self.seq_len = int(seq_len)
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.num_workers = max(1, int(num_workers))
        # Token ids >= vocab_size are rejected here: the embedding and label
        # gathers clamp, which would turn a corrupt shard into silently
        # wrong training.
        self.vocab_size = vocab_size
        self.shard_windows = bool(shard_windows)
        # Transient-I/O retry budget per read (OSError only; corrupt tokens
        # are never retried). The counter is shared by the worker threads.
        self.data_read_retries = int(data_read_retries)
        self.read_retry_count = 0
        self._retry_lock = threading.Lock()
        self._epoch = 0
        # Elastic cursor migration (set_consumed): per-shard sets of window
        # offsets an earlier world already trained on this epoch; active
        # only for the epoch it was installed for.
        self._consumed: dict[str, frozenset] | None = None
        self._consumed_epoch: int | None = None

    def set_consumed(self, consumed: dict[str, set], epoch: int) -> None:
        """Install a consumed-window plan (:func:`plan_cursor_migration`)
        for ``epoch``: the listed ``{shard_path: {offset, ...}}`` windows are
        left out of iteration and of every window count, so a world of any
        shape resumes the epoch on exactly the complement. Shard-stride mode
        only (the eval loader has no resume cursor)."""
        if self.shard_windows:
            raise ValueError("set_consumed is only supported in shard-stride mode")
        self._consumed = {p: frozenset(offs) for p, offs in consumed.items()}
        self._consumed_epoch = int(epoch)

    def _retry_io(self, fn, what: str):
        """Run ``fn``, retrying transient ``OSError`` up to
        ``data_read_retries`` times with doubling backoff."""
        delay = 0.05
        for attempt in range(self.data_read_retries + 1):
            try:
                return fn()
            except OSError as exc:
                if attempt == self.data_read_retries:
                    raise
                with self._retry_lock:
                    self.read_retry_count += 1
                print(
                    f"[data] transient I/O error on {what} "
                    f"({type(exc).__name__}: {exc}); retry "
                    f"{attempt + 1}/{self.data_read_retries} in {delay:.2f}s",
                    flush=True,
                )
                time.sleep(delay)
                delay *= 2

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)
        if self._consumed is not None and self._epoch != self._consumed_epoch:
            # Only the checkpointed epoch was partly consumed by the old
            # world; any other epoch starts from its full window set.
            self._consumed = None
            self._consumed_epoch = None

    def worker_shards(self, worker_id: int, epoch: int | None = None) -> list[str]:
        """The shard slice owned by ``(self.process_index, worker_id)`` this
        epoch: ``perm[process * num_workers + worker :: process_count *
        num_workers]`` of the ``random.Random(epoch)`` permutation."""
        epoch = self._epoch if epoch is None else epoch
        perm = list(self.shard_paths)
        random.Random(epoch).shuffle(perm)
        if self.shard_windows:
            return perm
        start = self.process_index * self.num_workers + worker_id
        stride = self.process_count * self.num_workers
        return perm[start::stride]

    def _window_slice(self, worker_id: int) -> tuple[int, int]:
        """(start, stride) over a shard's shuffled offset list for this
        (process, worker) — the whole list in shard-stride mode."""
        if not self.shard_windows:
            return 0, 1
        return (
            self.process_index * self.num_workers + worker_id,
            self.process_count * self.num_workers,
        )

    def _iter_one_shard(
        self, path: str, epoch: int, worker_id: int, start_offset_index: int = 0
    ) -> Iterator[np.ndarray]:
        """Yield ``seq_len + 1``-token uint16 windows from one shard, from
        ``start_offset_index`` of its shuffled offset list."""
        tokens = self._retry_io(
            lambda: np.memmap(path, dtype="<u2", mode="r"), f"memmap {path}"
        )
        n = tokens.shape[0]
        offsets = list(range(0, n - self.seq_len - 1, self.seq_len))
        if self.shard_windows:
            random.Random(_offset_seed(epoch, 0, 0)).shuffle(offsets)
            start, stride = self._window_slice(worker_id)
            offsets = offsets[start::stride]
        else:
            random.Random(
                _offset_seed(epoch, self.process_index, worker_id)
            ).shuffle(offsets)
            consumed = self._consumed.get(path) if self._consumed else None
            if consumed:
                # The migration: windows the old world trained on are left
                # out, after the shuffle, the survivors in shuffled order.
                offsets = [o for o in offsets if o not in consumed]
        window_len = self.seq_len + 1
        for off in offsets[start_offset_index:]:
            window = self._retry_io(
                lambda: np.array(tokens[off : off + window_len], dtype=np.uint16),
                f"read {path}",
            )
            if self.vocab_size is not None:
                top = int(window.max())
                if top >= self.vocab_size:
                    raise ValueError(
                        f"shard {path} contains token id {top} >= vocab_size "
                        f"{self.vocab_size} (offset {off}); data is corrupt or "
                        f"tokenized with a different vocabulary"
                    )
            yield window

    def _shard_num_windows(self, path: str, worker_id: int = 0) -> int:
        """This (process, worker)'s window count of one shard from its file
        size alone."""
        n = _shard_token_count(path)
        total = len(range(0, n - self.seq_len - 1, self.seq_len))
        if not self.shard_windows and self._consumed:
            # Consumed offsets come from the same enumeration, so the count
            # shrinks one for one.
            total -= min(len(self._consumed.get(path, ())), total)
        start, stride = self._window_slice(worker_id)
        return len(range(start, total, stride))

    def iter_worker(
        self, worker_id: int, skip_samples: int = 0
    ) -> Iterator[np.ndarray]:
        """One worker's windows this epoch, its shards in permuted order,
        skipping the first ``skip_samples`` windows arithmetically (whole
        shards by their window counts, never opened)."""
        epoch = self._epoch
        for path in self.worker_shards(worker_id, epoch):
            if skip_samples > 0:
                n_windows = self._shard_num_windows(path, worker_id)
                if skip_samples >= n_windows:
                    skip_samples -= n_windows
                    continue
            yield from self._iter_one_shard(
                path, epoch, worker_id, start_offset_index=skip_samples
            )
            skip_samples = 0

    def worker_batches(self, batch_size: int) -> list[int]:
        """Per-worker whole-batch counts this epoch (drop_last per worker),
        from file sizes only."""
        counts = []
        for w in range(self.num_workers):
            samples = sum(
                self._shard_num_windows(p, w) for p in self.worker_shards(w)
            )
            counts.append(samples // batch_size)
        return counts

    def batches_per_epoch(self, batch_size: int) -> int:
        """Exact number of batches the loader yields this epoch."""
        return sum(self.worker_batches(batch_size))


def _shard_token_count(path: str) -> int:
    return os.path.getsize(path) // 2  # uint16


_STOP = object()


class _WorkerError:
    """Carrier for an exception raised inside a worker thread; re-raised in
    the consuming thread so a failure fails the epoch loudly."""

    def __init__(self, exc: BaseException) -> None:
        self.exc = exc


def _simulate_round_robin_skip(
    counts: list[int], to_skip: int
) -> tuple[list[int], list[int], int]:
    """Replay the consumer's round-robin over per-worker batch *counts*.

    Returns ``(skipped_per_worker, live_worker_ids, rotation_index)``, the
    consumer's state after ``to_skip`` batches, mid-skip worker exhaustion
    included. Full rotations are applied in chunks, so the cost is
    O(workers x shard exhaustions), not O(to_skip)."""
    live = list(range(len(counts)))
    rem = list(counts)
    skipped = [0] * len(counts)
    i = 0
    n = 0
    while live and n < to_skip:
        min_rem = min(rem[w] for w in live)
        # Whole safe rotations: none exhausts, and we stay under to_skip.
        rounds = min(min_rem - 1, (to_skip - n) // len(live) - 1)
        if rounds > 0:
            for w in live:
                rem[w] -= rounds
                skipped[w] += rounds
            n += rounds * len(live)
            continue
        pos = i % len(live)
        w = live[pos]
        if rem[w] == 0:
            live.pop(pos)
            i = pos
            continue
        rem[w] -= 1
        skipped[w] += 1
        n += 1
        i = pos + 1
    return skipped, live, i


def plan_cursor_migration(
    shard_paths: Sequence[str],
    seq_len: int,
    epoch: int,
    old_process_count: int,
    old_num_workers: int,
    old_batch_size: int,
    consumed_batches: int,
    consumed: dict[str, set] | None = None,
) -> dict[str, set]:
    """The windows an OLD world consumed this epoch, ``{shard_path:
    {offset, ...}}``, rebuilt from file sizes and seeds alone (no token
    reads).

    A resize changes the ``(process, worker)`` partitioning: the owned
    shard slices and the ``epoch ^ rank ^ worker`` offset seeds, and the
    batch a worker assembles. So the arithmetic prefix skip of another
    loader shape reads other streams. For each old process the round-robin
    replay splits ``consumed_batches`` (per process: optimizer steps into
    the epoch x the old grad-accum) over its workers, and each worker's
    share maps to the head of its shuffled offset lists, shard by shard in
    owned order. The plan feeds :meth:`TokenShardDataset.set_consumed` on a
    dataset of any new shape.

    ``consumed`` is an earlier plan the old world itself resumed on (a
    second resize in one epoch): the replay then walks the same filtered
    offset lists and counts that world's loader walked
    (:func:`replay_cursor_history`).
    """
    plan: dict[str, set] = {}
    for p in range(old_process_count):
        old = TokenShardDataset(
            shard_paths,
            seq_len=seq_len,
            process_index=p,
            process_count=old_process_count,
            num_workers=old_num_workers,
        )
        old.set_epoch(epoch)
        if consumed:
            old.set_consumed(consumed, epoch)
        counts = old.worker_batches(old_batch_size)
        skipped, _, _ = _simulate_round_robin_skip(counts, consumed_batches)
        for w in range(old.num_workers):
            samples = skipped[w] * old_batch_size
            for path in old.worker_shards(w, epoch):
                if samples <= 0:
                    break
                n = _shard_token_count(path)
                offsets = list(range(0, n - seq_len - 1, seq_len))
                random.Random(_offset_seed(epoch, p, w)).shuffle(offsets)
                if consumed:
                    # As _iter_one_shard: shuffle first, then drop the
                    # consumed windows, keeping the survivors' order.
                    gone = consumed.get(path, ())
                    offsets = [o for o in offsets if o not in gone]
                take = min(samples, len(offsets))
                if take:
                    plan.setdefault(path, set()).update(offsets[:take])
                samples -= take
    return plan


def cursor_plan_digest(plan: dict[str, set]) -> str:
    """The sha256 of a consumed-window plan, keyed by shard basename (a
    data root may move between machines) with sorted offsets: two
    reconstructions agree iff they name the same windows. Byte for byte the
    JAX package's digest. Persisted in ``CheckpointMeta.cursor_plan`` and
    re-verified on the next same-epoch resize."""
    import hashlib
    import json

    canon = sorted(
        (os.path.basename(path), sorted(int(o) for o in offs))
        for path, offs in plan.items()
        if offs
    )
    return hashlib.sha256(json.dumps(canon, separators=(",", ":")).encode()).hexdigest()


def replay_cursor_history(
    shard_paths: Sequence[str],
    seq_len: int,
    epoch: int,
    resizes: Sequence[dict],
) -> dict[str, set]:
    """Fold a same-epoch resize history into one consumed-window plan.

    ``resizes`` is the record ``CheckpointMeta.cursor_plan`` carries: one
    entry per world that trained part of this epoch, in order, each with
    its loader shape (``process_count``, ``workers``, ``local_batch``),
    ``grad_accum_steps`` and ``steps``, the optimizer steps into the epoch
    at which it handed over. Each world's consumption is replayed on the
    complement of everything consumed before it, so the union is exact at
    any resize depth.
    """
    plan: dict[str, set] = {}
    prev_steps = 0
    for r in resizes:
        steps = int(r["steps"])
        step_plan = plan_cursor_migration(
            shard_paths,
            seq_len=seq_len,
            epoch=epoch,
            old_process_count=int(r["process_count"]),
            old_num_workers=int(r["workers"]),
            old_batch_size=int(r["local_batch"]),
            consumed_batches=(steps - prev_steps) * int(r["grad_accum_steps"]),
            consumed=plan or None,
        )
        for path, offs in step_plan.items():
            plan.setdefault(path, set()).update(offs)
        prev_steps = steps
    return plan


class _WorkerThread(threading.Thread):
    """Fills a bounded queue with complete ``[B, seq_len+1]`` uint16 batches."""

    def __init__(
        self,
        dataset: TokenShardDataset,
        worker_id: int,
        batch_size: int,
        prefetch_factor: int,
        skip_samples: int = 0,
        inject_fail_after: int = 0,
    ) -> None:
        super().__init__(daemon=True, name=f"shard-loader-{worker_id}")
        self.dataset = dataset
        self.worker_id = worker_id
        self.batch_size = batch_size
        self.skip_samples = skip_samples
        # Fault injection (--inject_worker_fail_at): raise in this thread
        # after producing N batches, so the failure takes the real
        # _WorkerError -> consumer re-raise path (0 = off).
        self.inject_fail_after = int(inject_fail_after)
        self.queue: queue.Queue = queue.Queue(maxsize=max(1, prefetch_factor))
        self._stop_event = threading.Event()

    def run(self) -> None:
        try:
            produced = 0
            buf: list[np.ndarray] = []
            for sample in self.dataset.iter_worker(
                self.worker_id, skip_samples=self.skip_samples
            ):
                if self._stop_event.is_set():
                    return
                buf.append(sample)
                if len(buf) == self.batch_size:
                    self._put(np.stack(buf))
                    buf = []
                    produced += 1
                    if self.inject_fail_after and produced >= self.inject_fail_after:
                        raise RuntimeError(
                            f"injected data-worker failure after "
                            f"{produced} batches"
                        )
            # drop_last: a trailing partial batch is discarded.
            self._put(_STOP)
        except BaseException as exc:  # noqa: BLE001 — re-raised by the consumer
            self._put(_WorkerError(exc))

    def _put(self, item) -> None:
        while not self._stop_event.is_set():
            try:
                self.queue.put(item, timeout=0.1)
                return
            except Full:
                continue

    def signal_stop(self) -> None:
        """Set the stop event only (non-blocking)."""
        self._stop_event.set()

    def stop(self) -> None:
        self.signal_stop()
        # Drain so a blocked put() observes the stop event. Best effort: a
        # leaked iterator finalised at interpreter shutdown may find the
        # queue module's globals torn down.
        try:
            while True:
                self.queue.get_nowait()
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException:  # noqa: BLE001 — see comment
            pass


class DataLoader:
    """One epoch of ``(x, y)`` int32 ``[B, T]`` batches, prefetched by worker
    threads and round-robined across them. Iterate once per epoch (call
    ``dataset.set_epoch`` first)."""

    def __init__(
        self,
        dataset: TokenShardDataset,
        batch_size: int = DEFAULT_BATCH_SIZE,
        prefetch_factor: int = DEFAULT_PREFETCH_FACTOR,
        skip_batches: int = 0,
        inject_worker_fail_after: int = 0,
    ) -> None:
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.prefetch_factor = int(prefetch_factor)
        # One-shot resume skip, consumed by the first iteration only.
        self._pending_skip = int(skip_batches)
        # Fault injection: worker 0 raises after producing N batches (0 = off).
        self._inject_worker_fail_after = int(inject_worker_fail_after)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        to_skip, self._pending_skip = self._pending_skip, 0
        if to_skip > 0:
            counts = self.dataset.worker_batches(self.batch_size)
            skipped, live_ids, i = _simulate_round_robin_skip(counts, to_skip)
        else:
            skipped = [0] * self.dataset.num_workers
            live_ids = list(range(self.dataset.num_workers))
            i = 0

        workers = [
            _WorkerThread(
                self.dataset, w, self.batch_size, self.prefetch_factor,
                skip_samples=skipped[w] * self.batch_size,
                inject_fail_after=(
                    self._inject_worker_fail_after if w == 0 else 0
                ),
            )
            for w in range(self.dataset.num_workers)
        ]
        for w in workers:
            w.start()
        live = [workers[w] for w in live_ids]
        try:
            while live:
                pos = i % len(live)
                worker = live[pos]
                item = worker.queue.get()
                if item is _STOP:
                    # The next worker slides into the exhausted one's
                    # position, so the rotation continues from `pos`.
                    live.pop(pos)
                    i = pos
                    continue
                if isinstance(item, _WorkerError):
                    raise RuntimeError(
                        f"data worker {worker.worker_id} failed"
                    ) from item.exc
                i = pos + 1
                batch = item.astype(np.int32)
                yield batch[:, :-1], batch[:, 1:]
        finally:
            # Signal every worker before any (interruptible) drain.
            for w in workers:
                w.signal_stop()
            for w in workers:
                w.stop()


def create_dataloader(
    dataset: TokenShardDataset,
    batch_size: int = DEFAULT_BATCH_SIZE,
    prefetch_factor: int = DEFAULT_PREFETCH_FACTOR,
    skip_batches: int = 0,
    inject_worker_fail_after: int = 0,
) -> DataLoader:
    return DataLoader(
        dataset,
        batch_size=batch_size,
        prefetch_factor=prefetch_factor,
        skip_batches=skip_batches,
        inject_worker_fail_after=inject_worker_fail_after,
    )
