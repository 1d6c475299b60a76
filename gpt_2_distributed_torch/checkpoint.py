"""Checkpoint save and restore of the PyTorch port
(``gpt_2_distributed_tpu/checkpoint.py``).

* **Sharded-native.** Each process writes the blocks of the training state
  it owns: for every tensor, its chunk in the optimizer's layout
  (``parallel/sharding.py::take_shard``'s block under 'fsdp' or
  ``--shard_update``, the whole tensor otherwise), written once, by the
  process whose index is 0 on every mesh axis that does not split it.
  Nothing is gathered to save. ``index.json`` records every tensor's
  global shape (the JAX leaf's per-layer shape, the ``view`` of
  ``tensor_layouts``) and where each of its blocks lies. A restore reads
  each process's own region back from whichever blocks overlap it, so a
  checkpoint restores under any layout of the same global shapes (saved
  under fsdp=2, restored on one process or under ``data=2 --shard_update
  on``, and back).
* **Complete resume state.** The fp32 params (the optimizer's master
  tensors), the AdamW moments, the optimizer's step count (the learning-
  rate schedule's), the guard counters, and ``meta.json``
  (:class:`CheckpointMeta`, the JAX package's record: step, epoch, batches
  consumed in the epoch, seed, tokens, the spike monitor's baseline and
  the world it was saved at). The loader's ``skip_batches`` puts the data
  cursor back and the dropout keys are stateless in (seed, step,
  micro-batch), so a resumed run continues bit for bit.
* **Storage.** Raw little-endian fp32 files, one per process and kind:
  ``params/rank_RRRRR.bin`` (its blocks, concatenated in tensor order) and
  ``opt_state/rank_RRRRR.bin`` (each block's two moments), with
  ``opt_state/state.json`` (step count, guard counters) from process 0.
  ``torch.load``/``safetensors`` are not needed; restores read through
  ``numpy.memmap``. The JAX package's migration of an older qkv layout has
  no counterpart: the port never wrote another layout.
* **Layout.** ``{save_dir}/step_{step:07d}/`` directories, as in the JAX
  package.
* **Commit protocol.** A save writes ``.INPROGRESS`` first and
  ``COMMITTED`` last (tmp + fsync + atomic rename, after ``index.json``,
  ``meta.json`` and ``manifest.json`` are written and read back). A dir
  with ``.INPROGRESS`` and no ``COMMITTED`` is an interrupted or failed
  save: the listings never surface it and :func:`gc_checkpoints` prunes
  it; a dir with neither marker is a legacy checkpoint, trusted after
  verification. Under a mesh every other writer leaves a
  ``.rank_RRRRR.written`` marker holding the save's token when its files
  are complete; process 0 commits once every writer's marker holds it.
* **Non-blocking saves.** :class:`CheckpointSaver` copies the state to the
  host (the only part the step loop waits for, into pinned buffers kept
  between saves) and writes and commits on a background thread. Failures
  retry with exponential backoff; exhausted retries become a warning and
  ``failed_saves`` instead of ending the run.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from dataclasses import asdict, dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from gpt_2_distributed_torch import resilience
from gpt_2_distributed_torch.config import CheckpointPolicy
from gpt_2_distributed_torch.models.gpt2 import BLOCK_KEYS
from gpt_2_distributed_torch.obs.trace import get_tracer
from gpt_2_distributed_torch.parallel.mesh import AXES, Mesh, MeshSpec, is_primary
from gpt_2_distributed_torch.parallel.sharding import TOP_KEYS, tensor_layouts
from gpt_2_distributed_torch.resilience import GuardState

STEP_DIR_RE = re.compile(r"^step_(\d{7,})$")

# Commit-protocol markers: .INPROGRESS written FIRST, COMMITTED LAST.
COMMITTED_NAME = "COMMITTED"
INPROGRESS_NAME = ".INPROGRESS"
INDEX_NAME = "index.json"
STATE_NAME = os.path.join("opt_state", "state.json")

# Test seam: seconds process 0 sleeps between the tensor write and the
# commit, so a test can see a checkpoint that is written but uncommitted
# (and, under a mesh, the other processes' writes done before it commits).
COMMIT_DELAY_ENV = "GPT2_TORCH_INJECT_COMMIT_DELAY_S"
# How long process 0 waits for the other writers' markers before the
# commit attempt fails (and is retried).
WRITERS_TIMEOUT_S = 600.0


def step_dir_name(step: int) -> str:
    return f"step_{step:07d}"


@dataclass
class CheckpointMeta:
    """Everything beyond the tensors needed for an exact resume: the JAX
    package's record, field for field, so either package reads the
    other's ``meta.json``."""

    step: int                 # optimizer steps completed
    epoch: int                # epoch in progress
    batches_in_epoch: int     # optimizer steps consumed within `epoch`
    rng_seed: int             # the run's base seed
    total_tokens: int = 0
    # SpikeMonitor.state_dict(); None for guard-off runs (and for files
    # written before the field existed).
    spike_monitor: dict | None = None
    # The world the checkpoint was saved at: process_count, device_count,
    # mesh ("data=D,fsdp=F,sp=S,tp=T"), global_batch, grad_accum_steps,
    # batch, local_batch, workers.
    world: dict | None = None
    # The elastic slice's data-cursor history; always None in the port.
    cursor_plan: dict | None = None

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "CheckpointMeta":
        return cls(**json.loads(text))


def tensor_names(n_layer: int) -> list[str]:
    """The name of each tensor of ``train_step.param_list`` (top keys, then
    each block key over the layers)."""
    return list(TOP_KEYS) + [f"blocks/{layer}/{k}" for k in BLOCK_KEYS
                             for layer in range(n_layer)]


class StateLayout:
    """Where a run's training state lives: each optimizer tensor's layout
    (``sharded.layouts``, or every tensor whole) and the mesh whose
    processes hold it (None for one process).

    The optimizer's tensors are the state: the master shards under a
    :class:`~gpt_2_distributed_torch.parallel.train_step.ShardedUpdate`,
    the params themselves otherwise."""

    def __init__(self, config, sharded=None, mesh=None):
        if sharded is not None:
            self.layouts, mesh = sharded.layouts, sharded.mesh
        else:
            self.layouts = tensor_layouts(config, MeshSpec(), False)
        self.mesh = mesh if mesh is not None and mesh.spec.n_devices > 1 else None
        self.spec = self.mesh.spec if self.mesh is not None else MeshSpec()
        self.rank = self.mesh.rank if self.mesh is not None else 0
        self.names = tensor_names(config.n_layer)
        self.n_layer = config.n_layer

    def _region(self, i: int, place: Mesh | None) -> tuple[list[int], list[int]]:
        lay = self.layouts[i]
        offset, shape = [0] * len(lay.view), list(lay.view)
        for axis, d in lay.placement:
            n = lay.view[d] // place.shape[axis]
            offset[d], shape[d] = place.axis_index(axis) * n, n
        return offset, shape

    def region(self, i: int) -> tuple[list[int], list[int]]:
        """This process's ``(offset, shape)`` of tensor ``i`` in its view."""
        return self._region(i, self.mesh)

    def blocks_of(self, rank: int) -> list[tuple[int, list[int], list[int]]]:
        """``(tensor, offset, shape)`` of every block process ``rank``
        writes: its region of each tensor for which its index is 0 on every
        live axis that does not split that tensor."""
        place = Mesh(self.spec, rank) if self.mesh is not None else None
        out = []
        for i, lay in enumerate(self.layouts):
            placed = {a for a, _ in lay.placement}
            if place is not None and any(place.axis_index(a) for a in AXES
                                         if a not in placed and place.shape[a] > 1):
                continue
            out.append((i, *self._region(i, place)))
        return out

    def shape(self, i: int) -> tuple[int, ...]:
        """Tensor ``i``'s whole shape in the port's params (the qkv weight
        and bias flatten the view's (3, H, D))."""
        view = self.layouts[i].view
        if self.names[i].endswith("attn_qkv_w"):
            return (view[0], int(np.prod(view[1:])))
        if self.names[i].endswith("attn_qkv_b"):
            return (int(np.prod(view)),)
        return tuple(view)

    def index(self, moments: bool) -> dict:
        """``index.json``: every tensor's global view, its port shape and
        its blocks, each with the writer and its element offset there."""
        tensors = [{"name": n, "view": list(lay.view), "shape": list(self.shape(i)),
                    "blocks": []}
                   for i, (n, lay) in enumerate(zip(self.names, self.layouts))]
        for rank in range(self.spec.n_devices):
            at = 0
            for i, offset, shape in self.blocks_of(rank):
                tensors[i]["blocks"].append(
                    {"rank": rank, "offset": offset, "shape": shape, "at": at})
                at += int(np.prod(shape))
        return {"format": 1, "dtype": "float32", "mesh": self.spec.to_str(),
                "n_layer": self.n_layer, "moments": moments, "tensors": tensors}


def _rank_file(kind: str, rank: int) -> str:
    return os.path.join(kind, f"rank_{rank:05d}.bin")


def _marker_name(rank: int) -> str:
    return f".rank_{rank:05d}.written"


def _write_file(path: str, data) -> None:
    """``data`` (bytes, or a C-contiguous array) to ``path`` via tmp +
    fsync + atomic rename."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _write_json(path: str, obj) -> None:
    _write_file(path, json.dumps(obj, indent=2).encode())


# --- the commit protocol ------------------------------------------------------


def _dir_state(path: str) -> str:
    """The commit-protocol state of one step dir: ``"committed"`` (the
    COMMITTED sentinel exists), ``"uncommitted"`` (.INPROGRESS without
    COMMITTED: an interrupted or failed save, never trusted) or
    ``"legacy"`` (neither marker; verification decides at restore)."""
    if os.path.exists(os.path.join(path, COMMITTED_NAME)):
        return "committed"
    if os.path.exists(os.path.join(path, INPROGRESS_NAME)):
        return "uncommitted"
    return "legacy"


def is_committed_checkpoint(path: str) -> bool:
    """True when ``path`` holds a checkpoint a restore may surface:
    committed, or legacy with a ``meta.json``."""
    if _dir_state(path) == "uncommitted":
        return False
    return os.path.exists(os.path.join(path, "meta.json"))


def _mark_inprogress(path: str) -> None:
    """Open a save on ``path``: drop a stale COMMITTED (a re-save un-commits
    the dir until its own commit lands) and write .INPROGRESS first."""
    os.makedirs(os.path.join(path, "params"), exist_ok=True)
    os.makedirs(os.path.join(path, "opt_state"), exist_ok=True)
    if not is_primary():
        return
    committed = os.path.join(path, COMMITTED_NAME)
    if os.path.exists(committed):
        os.remove(committed)
    with open(os.path.join(path, INPROGRESS_NAME), "w") as f:
        f.write(f"{time.time():.3f}\n")


def _commit_files(path: str, step: int, meta: CheckpointMeta, index: dict,
                  verify: bool = False) -> None:
    """The commit: ``index.json`` and ``meta.json``, the manifest, an
    optional read-back verification, then COMMITTED (tmp + fsync + rename)
    and .INPROGRESS cleared. Process 0 only; raises on any failure, so the
    sentinel is written only when everything before it succeeded."""
    if not is_primary():
        return
    _write_json(os.path.join(path, INDEX_NAME), index)
    with open(os.path.join(path, "meta.json"), "w") as f:
        f.write(meta.to_json())
    resilience.write_manifest(path, step)
    if verify:
        problems = resilience.verify_checkpoint(path)
        if problems:
            raise RuntimeError("post-write verification failed: " + "; ".join(problems))
    _write_json(os.path.join(path, COMMITTED_NAME),
                {"step": int(step), "committed_at": time.time()})
    inprogress = os.path.join(path, INPROGRESS_NAME)
    if os.path.exists(inprogress):
        os.remove(inprogress)


def list_checkpoints(save_dir: str, committed_only: bool = True) -> list[tuple[int, str]]:
    """``(step, path)`` of every checkpoint with a ``meta.json`` under
    ``save_dir``, ascending; uncommitted dirs are hidden unless
    ``committed_only`` is False."""
    if not os.path.isdir(save_dir):
        return []
    out = []
    for name in os.listdir(save_dir):
        m = STEP_DIR_RE.match(name)
        path = os.path.join(save_dir, name)
        if not (m and os.path.exists(os.path.join(path, "meta.json"))):
            continue
        if committed_only and _dir_state(path) == "uncommitted":
            continue
        out.append((int(m.group(1)), path))
    return sorted(out)


def peek_latest_meta(save_dir: str) -> CheckpointMeta | None:
    """The newest restorable checkpoint's meta, without reading tensors;
    checkpoints whose ``meta.json`` does not parse are skipped."""
    for _, path in reversed(list_checkpoints(save_dir)):
        try:
            with open(os.path.join(path, "meta.json")) as f:
                return CheckpointMeta.from_json(f.read())
        except (OSError, ValueError, TypeError, KeyError):
            continue
    return None


def list_uncommitted(save_dir: str) -> list[str]:
    """Step dirs whose save never committed (.INPROGRESS without
    COMMITTED), with or without a ``meta.json``."""
    if not os.path.isdir(save_dir):
        return []
    out = []
    for name in sorted(os.listdir(save_dir)):
        path = os.path.join(save_dir, name)
        if STEP_DIR_RE.match(name) and os.path.isdir(path):
            if _dir_state(path) == "uncommitted":
                out.append(path)
    return out


def latest_checkpoint(save_dir: str) -> str | None:
    ckpts = list_checkpoints(save_dir)
    return ckpts[-1][1] if ckpts else None


def gc_checkpoints(save_dir: str, keep_last_n: int = 0,
                   protect: frozenset[str] | set[str] = frozenset()) -> list[str]:
    """Retention; returns the removed paths (process 0 acts, the others
    do nothing). Always prunes uncommitted dirs; with ``keep_last_n > 0``
    also all but the newest ``keep_last_n`` committed checkpoints, so the
    newest committed one is never removed. ``protect`` paths are skipped."""
    if not is_primary():
        return []
    protect = {os.path.abspath(p) for p in protect}
    removed: list[str] = []
    for path in list_uncommitted(save_dir):
        if os.path.abspath(path) in protect:
            continue
        shutil.rmtree(path, ignore_errors=True)
        removed.append(path)
    if keep_last_n > 0:
        for _step, path in list_checkpoints(save_dir)[:-keep_last_n]:
            if os.path.abspath(path) in protect:
                continue
            shutil.rmtree(path, ignore_errors=True)
            removed.append(path)
    return removed


# --- writing ------------------------------------------------------------------


class _Snapshot(NamedTuple):
    """One process's part of a checkpoint, on the host."""

    params: torch.Tensor | None    # its blocks, flat fp32, in tensor order
    moments: torch.Tensor | None   # each block's exp_avg then exp_avg_sq
    state: dict                    # opt_state/state.json (process 0)
    index: dict                    # index.json (process 0)


def _opt_tensors(optimizer) -> list[torch.Tensor]:
    return optimizer.param_groups[0]["params"]


def _host_buffer(pool: dict, key: str, n: int, pin: bool) -> torch.Tensor:
    buf = pool.get(key)
    if buf is None or buf.numel() != n:
        buf = torch.empty(n, dtype=torch.float32, pin_memory=pin)
        pool[key] = buf
    return buf


def snapshot_state(optimizer, layout: StateLayout, guard: GuardState | None = None,
                   pool: dict | None = None) -> _Snapshot:
    """Copy this process's blocks of the params and moments to the host
    (into ``pool``'s buffers when given, pinned on the card) and describe
    the checkpoint. Returns after the copies have landed."""
    pool = {} if pool is None else pool
    tensors = _opt_tensors(optimizer)
    mine = layout.blocks_of(layout.rank)
    moments = bool(optimizer.state)
    on_card = tensors[0].is_cuda
    n = sum(int(np.prod(shape)) for _, _, shape in mine)
    params = _host_buffer(pool, "params", n, on_card) if mine else None
    mom = _host_buffer(pool, "moments", 2 * n, on_card) if mine and moments else None
    at = 0
    with torch.no_grad():
        for i, _, shape in mine:
            k = int(np.prod(shape))
            t = tensors[i]
            params[at:at + k].copy_(t.reshape(-1), non_blocking=on_card)
            if mom is not None:
                st = optimizer.state[t]
                mom[2 * at:2 * at + k].copy_(st["exp_avg"].reshape(-1), non_blocking=on_card)
                mom[2 * at + k:2 * (at + k)].copy_(st["exp_avg_sq"].reshape(-1),
                                                   non_blocking=on_card)
            at += k
    if on_card:
        torch.cuda.current_stream(tensors[0].device).synchronize()
    steps = {float(st["step"]) for st in optimizer.state.values()}
    state = {"count": optimizer.count,
             "adam_step": steps.pop() if len(steps) == 1 else None,
             "guard": None if guard is None else guard._asdict()}
    return _Snapshot(params, mom, state, layout.index(moments))


def _write_snapshot(path: str, snap: _Snapshot, rank: int) -> None:
    """This process's files of ``snap`` under ``path``."""
    if snap.params is not None:
        _write_file(os.path.join(path, _rank_file("params", rank)), snap.params.numpy())
    if snap.moments is not None:
        _write_file(os.path.join(path, _rank_file("opt_state", rank)), snap.moments.numpy())
    if rank == 0:
        _write_json(os.path.join(path, STATE_NAME), snap.state)


def _writers(index: dict) -> set[int]:
    return {b["rank"] for t in index["tensors"] for b in t["blocks"]}


def _await_writers(path: str, ranks: set[int], token: str, timeout: float) -> None:
    """Wait until every rank of ``ranks`` has marked its files complete for
    the save ``token``; then clear the markers."""
    deadline = time.monotonic() + timeout
    pending = set(ranks)
    while pending:
        for r in sorted(pending):
            try:
                with open(os.path.join(path, _marker_name(r))) as f:
                    if f.read() == token:
                        pending.discard(r)
            except OSError:
                pass
        if not pending:
            break
        if time.monotonic() > deadline:
            raise TimeoutError(f"writers {sorted(pending)} did not finish within {timeout:g} s")
        time.sleep(0.02)
    for r in ranks:
        try:
            os.remove(os.path.join(path, _marker_name(r)))
        except OSError:
            pass


# --- reading ------------------------------------------------------------------


class _Reader:
    """Regions of a checkpoint's tensors, read from the blocks that overlap
    them (memory-mapped, each file opened once)."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, INDEX_NAME)) as f:
            self.index = json.load(f)
        if self.index.get("format") != 1 or self.index.get("dtype") != "float32":
            raise ValueError(f"{path}: unknown checkpoint format")
        self._maps: dict[tuple[str, int], np.memmap] = {}

    def _map(self, kind: str, rank: int) -> np.memmap:
        key = (kind, rank)
        if key not in self._maps:
            self._maps[key] = np.memmap(os.path.join(self.path, _rank_file(kind, rank)),
                                        dtype="<f4", mode="r")
        return self._maps[key]

    def read(self, i: int, offset: list[int], shape: list[int], what: str = "param"
             ) -> torch.Tensor:
        """Tensor ``i``'s region ``(offset, shape)`` of its view: the param
        (``what="param"``) or a moment (``"exp_avg"``, ``"exp_avg_sq"``)."""
        out = np.empty(shape, np.float32)
        covered = 0
        for b in self.index["tensors"][i]["blocks"]:
            lo = [max(o, bo) for o, bo in zip(offset, b["offset"])]
            hi = [min(o + s, bo + bs) for o, s, bo, bs in
                  zip(offset, shape, b["offset"], b["shape"])]
            if any(a >= z for a, z in zip(lo, hi)):
                continue
            k = int(np.prod(b["shape"]))
            if what == "param":
                flat = self._map("params", b["rank"])[b["at"]:b["at"] + k]
            else:
                start = 2 * b["at"] + (k if what == "exp_avg_sq" else 0)
                flat = self._map("opt_state", b["rank"])[start:start + k]
            if flat.size != k:
                raise ValueError(f"{self.path}: rank {b['rank']}'s file is short")
            src = flat.reshape(b["shape"])[tuple(slice(a - bo, z - bo) for a, z, bo in
                                                 zip(lo, hi, b["offset"]))]
            out[tuple(slice(a - o, z - o) for a, z, o in zip(lo, hi, offset))] = src
            covered += int(np.prod([z - a for a, z in zip(lo, hi)]))
        if covered != out.size:
            raise ValueError(f"{self.path}: tensor {self.index['tensors'][i]['name']} "
                             f"is not covered by its blocks")
        return torch.from_numpy(out)

    def check_model(self, layout: StateLayout) -> None:
        got = [(t["name"], tuple(t["view"])) for t in self.index["tensors"]]
        want = [(n, tuple(lay.view)) for n, lay in zip(layout.names, layout.layouts)]
        if got != want:
            raise ValueError(f"checkpoint {self.path} holds another model's tensors than "
                             f"this run's (names or shapes differ)")


def _read_meta(path: str) -> CheckpointMeta:
    with open(os.path.join(path, "meta.json")) as f:
        return CheckpointMeta.from_json(f.read())


def restore_checkpoint(path: str, params: dict, optimizer, layout: StateLayout
                       ) -> tuple[CheckpointMeta, GuardState | None]:
    """Restore one checkpoint into a run's state, in place: each optimizer
    tensor gets this process's region in ``layout`` (on its device), every
    whole param the whole tensor, the AdamW moments and step count their
    values. Returns ``(meta, guard state or None)``."""
    from gpt_2_distributed_torch.parallel.train_step import param_list

    meta = _read_meta(path)
    reader = _Reader(path)
    reader.check_model(layout)
    with open(os.path.join(path, STATE_NAME)) as f:
        state = json.load(f)
    tensors = _opt_tensors(optimizer)
    with torch.no_grad():
        regions = [layout.region(i) for i in range(len(tensors))]
        for i, t in enumerate(tensors):
            t.copy_(reader.read(i, *regions[i]).reshape(t.shape))
        for i, p in enumerate(param_list(params)):
            if p is not tensors[i] and p.numel() == int(np.prod(layout.layouts[i].view)):
                view = list(layout.layouts[i].view)
                p.copy_(reader.read(i, [0] * len(view), view).reshape(p.shape))
        optimizer.state.clear()
        if reader.index["moments"]:
            step = state["adam_step"]
            for i, t in enumerate(tensors):
                optimizer.state[t] = {
                    "step": torch.tensor(float(step), dtype=torch.float32),
                    "exp_avg": reader.read(i, *regions[i], "exp_avg").reshape(t.shape)
                    .to(t.device),
                    "exp_avg_sq": reader.read(i, *regions[i], "exp_avg_sq").reshape(t.shape)
                    .to(t.device),
                }
    optimizer.count = int(state["count"])
    guard = None if state.get("guard") is None else GuardState(**state["guard"])
    return meta, guard


def restore_params(path: str, device: torch.device | str = "cpu", config=None
                   ) -> tuple[dict, CheckpointMeta]:
    """The whole params of one checkpoint (fp32, on ``device``) as the
    port's params dict, and its meta; the optimizer state is not read. With
    ``config`` the shapes are checked against its model's."""
    meta = _read_meta(path)
    reader = _Reader(path)
    n_layer = reader.index["n_layer"]
    tensors = reader.index["tensors"]
    if config is not None:
        from gpt_2_distributed_torch.parallel.sharding import leaf_shapes

        shapes = leaf_shapes(config)
        want = [list(shapes[k]) for k in TOP_KEYS] + [
            list(shapes["block"][k][1:]) for k in BLOCK_KEYS for _ in range(config.n_layer)]
        if n_layer != config.n_layer or [t["view"] for t in tensors] != want:
            raise ValueError(f"checkpoint {path} does not hold this model's params "
                             f"(n_layer {n_layer} against {config.n_layer}, or other "
                             f"widths)")
    out: dict = {"blocks": [{} for _ in range(n_layer)]}
    for i, t in enumerate(tensors):
        whole = reader.read(i, [0] * len(t["view"]), t["view"]).reshape(t["shape"])
        whole = whole.to(device)
        if t["name"].startswith("blocks/"):
            _, layer, key = t["name"].split("/")
            out["blocks"][int(layer)][key] = whole
        else:
            out[t["name"]] = whole
    return out, meta


def restore_latest_verified(save_dir: str, params: dict, optimizer, layout: StateLayout
                            ) -> tuple[CheckpointMeta, GuardState | None, str] | None:
    """Restore the newest checkpoint that passes verification, falling back
    past corrupt ones and saying what it discarded (on process 0).
    Returns ``(meta, guard state, path)``, or None when none survives."""
    if is_primary():
        for path in list_uncommitted(save_dir):
            print(f"[resilience] skipping uncommitted checkpoint {path} (no "
                  f"{COMMITTED_NAME} sentinel: the save was interrupted or failed "
                  f"before its commit)", flush=True)
    candidates = list(reversed(list_checkpoints(save_dir)))
    for i, (_step, path) in enumerate(candidates):
        problems = resilience.verify_checkpoint(path)
        if problems:
            if is_primary():
                print(f"[resilience] discarding corrupt checkpoint {path}: "
                      + "; ".join(problems), flush=True)
            continue
        try:
            meta, guard = restore_checkpoint(path, params, optimizer, layout)
        except (OSError, ValueError, KeyError, TypeError) as exc:
            if i == len(candidates) - 1:
                raise
            if is_primary():
                print(f"[resilience] discarding unreadable checkpoint {path}: "
                      f"{type(exc).__name__}: {exc}", flush=True)
            continue
        return meta, guard, path
    return None


def latest_verified_checkpoint(save_dir: str) -> str | None:
    """The newest committed checkpoint under ``save_dir`` that passes
    verification (a step dir itself is returned as it is when it holds
    ``meta.json`` and verifies)."""
    if os.path.exists(os.path.join(save_dir, "meta.json")):
        candidates = [save_dir]
    else:
        candidates = [p for _, p in reversed(list_checkpoints(save_dir))]
    for path in candidates:
        problems = resilience.verify_checkpoint(path)
        if not problems:
            return path
        print(f"[resilience] discarding corrupt checkpoint {path}: " + "; ".join(problems),
              flush=True)
    return None


# --- the saver ----------------------------------------------------------------


class CheckpointSaver:
    """Checkpoint lifecycle: async writes, the commit, retries, retention.

    :meth:`save` copies this process's blocks to the host (the step loop's
    stall, ``save_block_ms``); in async mode a background thread writes
    the files, marks them complete (under a mesh), and process 0 commits
    once every writer is done, then runs retention. Sync mode does the same
    before returning. A save that exhausts its retries counts in
    ``failed_saves`` and warns; it never raises, and its dir stays
    uncommitted (skipped by restores, pruned by retention).

    Under a mesh every process calls :meth:`save`, :meth:`wait` and
    :meth:`ensure_committed_sync` at the same steps; ``barrier`` (the
    consensus bus's) lines them up where a sync save must end with the
    commit on every process.
    """

    def __init__(self, save_dir: str, layout: StateLayout,
                 policy: CheckpointPolicy | None = None,
                 barrier: Callable[[], None] | None = None):
        self.save_dir = os.path.abspath(save_dir)
        self.layout = layout
        self.policy = policy or CheckpointPolicy()
        self.barrier = barrier or (lambda: None)
        self.rank = layout.rank
        self.multi = layout.mesh is not None
        self.failed_saves = 0
        self.committed_steps: list[int] = []
        self.last_error: str | None = None
        self.save_block_ms = 0.0       # step-loop stall of the last save()
        self.commit_ms = 0.0           # write + commit of the last committed save
        # Fault injection (--inject_save_fail_at): the first
        # `inject_fail_count` attempts of the save of step `inject_fail_at` raise.
        self.inject_fail_at = 0
        self.inject_fail_count = 0
        self._commit_thread: threading.Thread | None = None
        self._api_lock = threading.RLock()
        self._pool: dict = {}
        self._seq = 0
        self._last_step: int | None = None

    def _say(self, msg: str) -> None:
        if self.rank == 0:
            print(msg, flush=True)

    # ---- fault injection and retries ---------------------------------------

    def _maybe_inject(self, step: int) -> None:
        if self.inject_fail_count > 0 and step == self.inject_fail_at:
            self.inject_fail_count -= 1
            raise IOError(f"injected save failure (step {step})")

    def _with_retries(self, step: int, what: str, fn: Callable[[], None]) -> bool:
        """``fn`` under the policy's retries and backoff; True on success.
        A permanent failure counts in ``failed_saves`` and warns."""
        delay = self.policy.retry_backoff_s
        for attempt in range(self.policy.save_retries + 1):
            try:
                self._maybe_inject(step)
                fn()
                return True
            except Exception as exc:  # noqa: BLE001 — a save never ends the run
                self.last_error = f"{type(exc).__name__}: {exc}"
                if attempt < self.policy.save_retries:
                    self._say(f"[ckpt] {what} failed (attempt {attempt + 1}/"
                              f"{self.policy.save_retries + 1}): {self.last_error}; "
                              f"retrying in {delay:.2f}s")
                    time.sleep(delay)
                    delay *= 2
        self.failed_saves += 1
        self._say(f"[ckpt] WARNING: {what} failed permanently after "
                  f"{self.policy.save_retries + 1} attempts ({self.last_error}); "
                  f"training continues without this checkpoint")
        return False

    # ---- save paths ----------------------------------------------------------

    def _write_and_commit(self, path: str, step: int, snap: _Snapshot,
                          meta: CheckpointMeta, token: str) -> bool:
        """This process's files; under a mesh its marker; on process 0 the
        commit once every writer is done, then retention."""
        t0 = time.perf_counter()

        def write() -> None:
            _write_snapshot(path, snap, self.rank)
            if self.multi and self.rank != 0 and snap.params is not None:
                _write_file(os.path.join(path, _marker_name(self.rank)), token.encode())

        tracer = get_tracer()
        with tracer.span("ckpt_write", step=step):
            if not self._with_retries(step, f"write {step_dir_name(step)}", write):
                return False
        if self.rank != 0:
            return True
        delay_s = float(os.environ.get(COMMIT_DELAY_ENV, "0") or 0)
        if delay_s > 0:
            time.sleep(delay_s)

        def commit() -> None:
            if self.multi:
                _await_writers(path, _writers(snap.index) - {0}, token, WRITERS_TIMEOUT_S)
            _commit_files(path, step, meta, snap.index, verify=True)

        with tracer.span("ckpt_commit_files", step=step):
            if not self._with_retries(step, f"commit {step_dir_name(step)}", commit):
                return False
        self.commit_ms = (time.perf_counter() - t0) * 1e3
        self.committed_steps.append(step)
        self._say(f"[ckpt] committed {step_dir_name(step)}")
        removed = gc_checkpoints(self.save_dir, self.policy.keep_last_n, protect={path})
        if removed:
            self._say("[ckpt] gc removed " + ", ".join(os.path.basename(p) for p in removed))
        return True

    def _begin(self, step: int, optimizer, guard) -> tuple[str, _Snapshot, str]:
        self._seq += 1
        self._last_step = step
        path = os.path.join(self.save_dir, step_dir_name(step))
        _mark_inprogress(path)
        return path, snapshot_state(optimizer, self.layout, guard, self._pool), \
            f"{step}:{self._seq}"

    def save(self, step: int, optimizer, meta: CheckpointMeta,
             guard: GuardState | None = None) -> str | None:
        """Save one checkpoint per the policy. Async: copy to the host and
        return; the write and commit run in the background. Sync: write and
        commit before returning. Returns the step dir (None when a sync
        save failed for good)."""
        t0 = time.perf_counter()
        with self._api_lock, get_tracer().span("ckpt_snapshot", step=step,
                                               sync=not self.policy.async_save):
            # One save in flight: the host buffers are reused.
            self.wait()
            path, snap, token = self._begin(step, optimizer, guard)
            if not self.policy.async_save:
                ok = self._write_and_commit(path, step, snap, meta, token)
                if self.multi:
                    self.barrier()
                self.save_block_ms = (time.perf_counter() - t0) * 1e3
                return path if ok else None
            self._say(f"[ckpt] async save initiated ({step_dir_name(step)})")
            self._commit_thread = threading.Thread(
                target=self._commit_async, args=(path, step, snap, meta, token),
                name=f"ckpt-commit-{step}", daemon=True)
            self._commit_thread.start()
            self.save_block_ms = (time.perf_counter() - t0) * 1e3
            return path

    def _commit_async(self, path: str, step: int, snap: _Snapshot, meta: CheckpointMeta,
                      token: str) -> None:
        with get_tracer().span("ckpt_commit", step=step) as span:
            if not self._write_and_commit(path, step, snap, meta, token):
                span.set(failed=True)

    # ---- draining and emergencies ----------------------------------------------

    def wait(self, timeout: float | None = None) -> None:
        """Block until the in-flight async save (if any) has finished."""
        t = self._commit_thread
        if t is not None:
            t.join(timeout)
            if not t.is_alive():
                self._commit_thread = None

    def ensure_committed_sync(self, step: int, optimizer, meta: CheckpointMeta,
                              guard: GuardState | None = None) -> str | None:
        """Emergency or final save: a committed checkpoint of ``step``
        before returning, never racing an in-flight save on the same dir
        (wait or supersede: the in-flight save is drained first; if it
        committed this very step, done, else a sync save over it)."""
        with self._api_lock:
            self.wait()
            self.barrier()
            path = os.path.join(self.save_dir, step_dir_name(step))
            if self._last_step == step and is_committed_checkpoint(path):
                return path
            t0 = time.perf_counter()
            with get_tracer().span("ckpt_emergency_save", step=step):
                path, snap, token = self._begin(step, optimizer, guard)
                ok = self._write_and_commit(path, step, snap, meta, token)
                self.barrier()
            self.save_block_ms = (time.perf_counter() - t0) * 1e3
            return path if ok else None

    def close(self) -> None:
        with self._api_lock:
            self.wait()
            self._pool.clear()


def export_full_params(params: dict, n_head: int, sharded=None) -> dict[str, np.ndarray]:
    """The whole params as host numpy in the JAX package's pytree layout,
    flat under ``/``-joined keys (``block/attn_qkv_w`` stacked ``[L, C, 3,
    H, D]``): the JAX ``export_full_params`` of the same weights, and the
    inverse of ``models/convert.py::params_from_jax``. Under fsdp pass the
    run's ``sharded`` (its tensors are gathered: a collective)."""
    from gpt_2_distributed_torch.models.convert import params_to_jax

    whole = params if sharded is None else sharded.full_params(params)
    tree = params_to_jax(whole, n_head)
    out = {k: tree[k] for k in TOP_KEYS}
    out.update({f"block/{k}": v for k, v in tree["block"].items()})
    return out
