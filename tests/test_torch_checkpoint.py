"""The port's checkpoint plane against the JAX package's, unit by unit
(``gpt_2_distributed_torch/checkpoint.py``, ``resilience.py``,
``coordination.py``):

* CRC-32C, the manifest of one directory tree and tamper detection equal
  the JAX package's;
* the commit-protocol listings (``_dir_state``, ``list_checkpoints``,
  ``latest_checkpoint``, ``list_uncommitted``, ``gc_checkpoints``) give the
  same answers on the same layouts: committed, uncommitted, legacy (no
  markers), a crash between write and commit;
* ``meta.json`` loads across the two packages, legacy JSON included;
* ``SpikeMonitor`` gives the same verdicts and state on the same sequences;
* the control word's encoding and reduction (and the port's bit vector,
  reduced with MAX) equal the JAX OR-reduce;
* ``export_full_params`` of converted JAX params equals JAX's bit for bit;
* a checkpoint written under any data/fsdp/shard_update layout restores
  bit-exactly under any other (the ranks simulated in one process);
* the saver: retries, exhausted retries, an async save invisible until
  committed, an emergency save that waits out or supersedes an async one
  (``tests/test_checkpoint.py``'s saver cases).

Tiny config (vocab 257, 2 layers, C 32, 2 heads), fp32, on the CPU.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import types

import numpy as np
import pytest
import torch

from gpt_2_distributed_torch import checkpoint as ck
from gpt_2_distributed_torch import coordination as coord
from gpt_2_distributed_torch import resilience as res
from gpt_2_distributed_torch.config import CheckpointPolicy, GPT2Config
from gpt_2_distributed_torch.models import gpt2
from gpt_2_distributed_torch.models.convert import params_from_jax
from gpt_2_distributed_torch.parallel import train_step as ts
from gpt_2_distributed_torch.parallel.mesh import Mesh, MeshSpec
from gpt_2_distributed_torch.parallel.sharding import take_shard, tensor_layouts
from gpt_2_distributed_tpu import checkpoint as jax_ck
from gpt_2_distributed_tpu import coordination as jax_coord
from gpt_2_distributed_tpu import resilience as jax_res
from gpt_2_distributed_tpu.models import gpt2 as jax_gpt2

CFG = GPT2Config(vocab_size=257, n_positions=32, n_embd=32, n_layer=2, n_head=2,
                 embd_dropout=0.0, attn_dropout=0.0, resid_dropout=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meta(step: int) -> ck.CheckpointMeta:
    return ck.CheckpointMeta(step=step, epoch=0, batches_in_epoch=step, rng_seed=0)


@pytest.fixture(scope="module")
def trained():
    """Params, optimizer and guard state after two guarded AdamW steps."""
    params = ts.trainable_params(gpt2.init_params(CFG, seed=3), torch.device("cpu"))
    opt = ts.make_optimizer(params, 1e-3)
    step = ts.make_train_step(CFG, opt, compute_dtype=torch.float32, guard=True)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 257, (2, 2, 4, 16)))
    y = torch.from_numpy(rng.integers(0, 257, (2, 2, 4, 16)))
    guard = res.init_guard_state()
    for i in range(2):
        guard, _ = step(params, guard, x[i], y[i], 0, i, torch.ones(2))
    return params, opt, guard


def _fresh_state(seed: int = 9):
    params = ts.trainable_params(gpt2.init_params(CFG, seed=seed), torch.device("cpu"))
    return params, ts.make_optimizer(params, 1e-3)


def _state_equal(a, b) -> bool:
    (pa, oa), (pb, ob) = a, b
    same = all(torch.equal(x, y) for x, y in zip(ts.param_list(pa), ts.param_list(pb)))
    for x, y in zip(ts.param_list(pa), ts.param_list(pb)):
        same = same and all(torch.equal(oa.state[x][k], ob.state[y][k])
                            for k in ("step", "exp_avg", "exp_avg_sq"))
    return same and oa.count == ob.count


# --- manifest and CRC ---------------------------------------------------------


def test_crc32c_check_value_and_random_bytes_equal_jax():
    assert res.crc32c(b"123456789") == 0xE3069283
    data = np.random.default_rng(1).integers(0, 256, 4099, dtype=np.uint8).tobytes()
    assert res.crc32c(data) == jax_res.crc32c(data)
    assert res.crc32c(data[100:], res.crc32c(data[:100])) == jax_res.crc32c(data)


def _tree(root) -> None:
    """A checkpoint-like tree: small and large files, a nested dir, and the
    commit markers the manifest must leave out."""
    os.makedirs(root / "params", exist_ok=True)
    os.makedirs(root / "opt_state" / "deep", exist_ok=True)
    (root / "meta.json").write_text(_meta(4).to_json())
    (root / "params" / "rank_00000.bin").write_bytes(bytes(range(256)) * 9)
    (root / "opt_state" / "deep" / "big.bin").write_bytes(b"\x07" * (res.CRC_MAX_BYTES + 5))
    (root / "opt_state" / "state.json").write_text("{}")
    (root / ".INPROGRESS").write_text("1\n")
    (root / "COMMITTED").write_text("{}")


def test_build_manifest_equals_jax_and_catches_tampering(tmp_path):
    _tree(tmp_path)
    assert res.build_manifest(str(tmp_path), 4) == jax_res.build_manifest(str(tmp_path), 4)
    names = {e["path"] for e in res.build_manifest(str(tmp_path), 4)["entries"]}
    assert "COMMITTED" not in names and ".INPROGRESS" not in names
    assert res.CRC_MAX_BYTES == jax_res.CRC_MAX_BYTES
    res.write_manifest(str(tmp_path), 4)
    assert res.verify_checkpoint(str(tmp_path)) == jax_res.verify_checkpoint(str(tmp_path)) == []
    # A flipped byte in a CRC'd file, a truncated large file, a missing file.
    data = bytearray((tmp_path / "params" / "rank_00000.bin").read_bytes())
    data[10] ^= 1
    (tmp_path / "params" / "rank_00000.bin").write_bytes(bytes(data))
    big = tmp_path / "opt_state" / "deep" / "big.bin"
    big.write_bytes(big.read_bytes()[:-1])
    os.remove(tmp_path / "opt_state" / "state.json")
    got = res.verify_checkpoint(str(tmp_path))
    assert got == jax_res.verify_checkpoint(str(tmp_path)) and len(got) == 3
    assert any("crc32c" in p for p in got) and any("size" in p for p in got)


# --- the commit protocol's listings -------------------------------------------


def _layouts(root) -> None:
    """Step dirs of every commit state: 1 legacy (no markers), 2 and 4
    committed, 3 a crash between write and commit (complete, marked in
    progress), 5 uncommitted without a meta, 6 committed without a meta,
    and names that are not step dirs."""
    def step_dir(step, meta=True, markers=()):
        d = root / ck.step_dir_name(step)
        os.makedirs(d / "params")
        os.makedirs(d / "opt_state")
        if meta:
            (d / "meta.json").write_text(_meta(step).to_json())
        for m in markers:
            (d / m).write_text("1\n")

    step_dir(1)
    step_dir(2, markers=("COMMITTED",))
    step_dir(3, markers=(".INPROGRESS",))
    step_dir(4, markers=("COMMITTED",))
    step_dir(5, meta=False, markers=(".INPROGRESS",))
    step_dir(6, meta=False, markers=("COMMITTED",))
    os.makedirs(root / "step_12")
    (root / "notes.txt").write_text("x")


@pytest.mark.parametrize("keep", [0, 1, 2, 5])
def test_listings_and_gc_equal_jax(tmp_path, keep):
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    os.makedirs(mine)
    _layouts(mine)
    shutil.copytree(mine, theirs)
    for d in sorted(os.listdir(mine)):
        assert ck._dir_state(str(mine / d)) == jax_ck._dir_state(str(theirs / d)), d
        assert (ck.is_committed_checkpoint(str(mine / d))
                == jax_ck.is_committed_checkpoint(str(theirs / d))), d

    def rel(x, base):
        if isinstance(x, list):
            return [rel(v, base) for v in x]
        if isinstance(x, tuple):
            return tuple(rel(v, base) for v in x)
        return os.path.relpath(x, base) if isinstance(x, str) else x

    for committed_only in (True, False):
        assert rel(ck.list_checkpoints(str(mine), committed_only), mine) == rel(
            jax_ck.list_checkpoints(str(theirs), committed_only), theirs)
    assert rel(ck.latest_checkpoint(str(mine)), mine) == rel(
        jax_ck.latest_checkpoint(str(theirs)), theirs) == "step_0000004"
    assert rel(ck.list_uncommitted(str(mine)), mine) == rel(
        jax_ck.list_uncommitted(str(theirs)), theirs)
    assert ck.peek_latest_meta(str(mine)) == ck.CheckpointMeta(
        **json.loads(jax_ck.peek_latest_meta(str(theirs)).to_json()))
    protect = {str(mine / "step_0000003")}
    got = ck.gc_checkpoints(str(mine), keep, protect=protect)
    want = jax_ck.gc_checkpoints(str(theirs), keep,
                                 protect={str(theirs / "step_0000003")})
    assert sorted(rel(got, mine)) == sorted(rel(want, theirs))
    assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs))
    # The newest committed checkpoint survives every retention.
    assert ck.latest_checkpoint(str(mine)).endswith("step_0000004")


def test_meta_json_loads_across_packages():
    full = ck.CheckpointMeta(step=7, epoch=1, batches_in_epoch=3, rng_seed=42,
                             total_tokens=1024, spike_monitor={"mean": 1.5, "var": 0.25,
                                                               "n_healthy": 30},
                             world={"process_count": 2, "device_count": 2,
                                    "mesh": "data=1,fsdp=2,sp=1,tp=1", "global_batch": 16,
                                    "grad_accum_steps": 2, "batch": 4, "local_batch": 4,
                                    "workers": 4})
    theirs = jax_ck.CheckpointMeta.from_json(full.to_json())
    assert json.loads(theirs.to_json()) == json.loads(full.to_json())
    assert ck.CheckpointMeta.from_json(theirs.to_json()) == full
    legacy = json.dumps({"step": 3, "epoch": 0, "batches_in_epoch": 3, "rng_seed": 1,
                         "total_tokens": 96})
    assert (json.loads(ck.CheckpointMeta.from_json(legacy).to_json())
            == json.loads(jax_ck.CheckpointMeta.from_json(legacy).to_json()))
    assert ck.CheckpointMeta.from_json(legacy).world is None


# --- the spike monitor ----------------------------------------------------------


SEQUENCES = {
    "warmup cliff": ([(float(v), False) for v in np.linspace(11.0, 4.0, 15)], {}),
    "upward spike": ([(1.0, False)] * 25 + [(50.0, False), (0.2, False), (1.0, False)],
                     {"warmup": 10}),
    "skip escalation": ([(float("nan"), True)] * 4 + [(1.0, False), (2.0, True)],
                        {"max_consecutive": 3}),
    "noisy": ([(float(v), False) for v in
               3.0 + 0.05 * np.random.default_rng(2).standard_normal(40)]
              + [(9.0, False), (9.0, False), (9.0, False), (float("inf"), False)],
              {"warmup": 5, "sigma": 4.0, "max_consecutive": 2}),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_spike_monitor_verdicts_and_state_equal_jax(name):
    seq, kw = SEQUENCES[name]
    mine, theirs = res.SpikeMonitor(**kw), jax_res.SpikeMonitor(**kw)
    for loss, skipped in seq:
        assert mine.observe(loss, skipped) == theirs.observe(loss, skipped)
        assert mine.state_dict() == theirs.state_dict()
        assert mine.consecutive == theirs.consecutive
    mine.reset(), theirs.reset()
    assert mine.state_dict() == theirs.state_dict()
    assert mine.observe(float("nan"), True) == theirs.observe(float("nan"), True)
    state = {"mean": 2.5, "var": 0.125, "n_healthy": 40, "consecutive": 2}
    mine.load_state_dict(state), theirs.load_state_dict(state)
    assert (mine.observe(60.0), mine.consecutive) == (theirs.observe(60.0), theirs.consecutive)
    with pytest.raises(ValueError):
        res.SpikeMonitor(sigma=0.0)
    with pytest.raises(ValueError):
        res.SpikeMonitor(max_consecutive=0)


# --- the control word ----------------------------------------------------------


def test_control_word_and_reduction_equal_jax():
    flags = ("preempt", "rollback", "skip", "worker_error", "save_now")
    for word in range(32):
        kw = dict(zip(flags, (bool(word >> i & 1) for i in range(5))))
        assert coord.encode_control_word(**kw) == jax_coord.encode_control_word(**kw) == word
        assert tuple(coord.decode_control_word(word)) == tuple(
            jax_coord.decode_control_word(word))
        assert coord.bits_to_word(coord.word_to_bits(word)) == word
    rng = np.random.default_rng(3)
    for _ in range(50):
        words = [int(w) for w in rng.integers(0, 32, rng.integers(1, 9))]
        want = jax_coord.or_reduce_words(words)
        assert coord.or_reduce_words(words) == want
        # What the bus all-reduces: the bit vectors under MAX.
        vecs = torch.tensor([coord.word_to_bits(w) for w in words])
        assert coord.bits_to_word(vecs.max(0).values.tolist()) == want
    bus = coord.ConsensusBus()
    assert bus.exchange(0b10110) == 0b10110 and bus.exchanges == 1
    with pytest.raises(ValueError, match="unknown bits"):
        bus.exchange(1 << 7)


# --- export -------------------------------------------------------------------


def test_export_full_params_equals_jax_bit_for_bit():
    import jax

    from gpt_2_distributed_tpu.config import GPT2Config as JaxConfig

    jcfg = JaxConfig(vocab_size=257, n_positions=32, n_embd=32, n_layer=2, n_head=2)
    jparams = jax_gpt2.init_params(jcfg, seed=5)
    want = jax_ck.export_full_params(jparams)
    got = ck.export_full_params(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)),
                                CFG.n_head)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


# --- save and restore ---------------------------------------------------------


def _sync_save(save_dir, step: int, opt, layout, guard) -> str:
    """One synchronous save through the saver; its step dir."""
    saver = ck.CheckpointSaver(str(save_dir), layout, CheckpointPolicy(async_save=False))
    try:
        return saver.save(step, opt, _meta(step), guard)
    finally:
        saver.close()


def test_restore_round_trip_is_bit_exact(tmp_path, trained):
    params, opt, guard = trained
    layout = ck.StateLayout(CFG)
    path = _sync_save(tmp_path, 2, opt, layout, guard)
    assert res.verify_checkpoint(path) == [] and ck.is_committed_checkpoint(path)
    fresh = _fresh_state()
    meta, got_guard = ck.restore_checkpoint(path, *fresh, layout)
    assert meta == _meta(2) and got_guard == guard
    assert _state_equal((params, opt), fresh)
    whole, meta2 = ck.restore_params(path, config=CFG)
    assert meta2 == meta
    assert all(torch.equal(a, b) for a, b in zip(ts.param_list(params), ts.param_list(whole)))
    with pytest.raises(ValueError, match="this model"):
        ck.restore_params(path, config=CFG.replace(n_layer=3))


LAYOUTS = {
    # name: (mesh, --shard_update)
    "local": ("data=1", False),
    "fsdp=2": ("fsdp=2", False),
    "data=2 shard_update": ("data=2", True),
    "data=2,fsdp=2 shard_update": ("data=2,fsdp=2", True),
    "data=2": ("data=2", False),
}


def _rank_states(name: str, whole: list[torch.Tensor], moments: list[torch.Tensor]):
    """Each rank's (layout, optimizer) under layout ``name``: its master
    tensors and moments cut from the whole ones by ``take_shard``, as a
    ``ShardedUpdate`` holds them (every tensor whole without one)."""
    spec = MeshSpec.parse(LAYOUTS[name][0])
    layouts = tensor_layouts(CFG, spec, LAYOUTS[name][1])
    sharded = any(lay.placement for lay in layouts)
    out = []
    for rank in range(spec.n_devices):
        mesh = Mesh(spec, rank)
        if sharded:
            layout = ck.StateLayout(CFG, types.SimpleNamespace(layouts=layouts, mesh=mesh))
        else:
            layout = ck.StateLayout(CFG, mesh=mesh)

        def cut(t, lay):
            return take_shard(t, lay, mesh) if sharded else t.clone()

        tensors = [cut(t, lay) for t, lay in zip(whole, layout.layouts)]
        opt = ts.ScheduledAdamW(tensors, 1e-3, 0.1, (0.9, 0.95), 1e-8)
        opt.count = 5
        for t, m, lay in zip(tensors, moments, layout.layouts):
            opt.state[t] = {"step": torch.tensor(5.0), "exp_avg": cut(m, lay),
                            "exp_avg_sq": cut(m * m, lay)}
        out.append((layout, opt))
    return out


def _empty_params() -> dict:
    e = torch.empty(0)
    return {**{k: e for k in ("wte", "wpe", "ln_f_scale", "ln_f_bias")},
            "blocks": [{k: e for k in gpt2.BLOCK_KEYS} for _ in range(CFG.n_layer)]}


@pytest.mark.parametrize("source", sorted(LAYOUTS))
def test_any_layout_restores_under_any_other(tmp_path, source):
    """Every rank of ``source`` writes its blocks into one step dir (rank 0
    commits); every rank of every layout reads its region back bit for bit,
    moments included."""
    rng = np.random.default_rng(4)
    whole = [torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
             for p in ts.param_list(gpt2.init_params(CFG))]
    moments = [torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
               for p in whole]
    path = str(tmp_path / ck.step_dir_name(5))
    ck._mark_inprogress(path)
    states = _rank_states(source, whole, moments)
    for layout, opt in states:
        snap = ck.snapshot_state(opt, layout, res.init_guard_state())
        ck._write_snapshot(path, snap, layout.rank)
        if layout.rank == 0:
            index = snap.index
    # Each block is written once: the blocks of a tensor tile its view.
    for t in index["tensors"]:
        assert sum(int(np.prod(b["shape"])) for b in t["blocks"]) == int(np.prod(t["view"]))
    ck._commit_files(path, 5, _meta(5), index, verify=True)
    assert ck.is_committed_checkpoint(path) and res.verify_checkpoint(path) == []
    for target in sorted(LAYOUTS):
        for layout, opt in _rank_states(target, [torch.zeros_like(t) for t in whole],
                                        [torch.zeros_like(t) for t in whole]):
            meta, guard = ck.restore_checkpoint(path, _empty_params(), opt, layout)
            assert meta.step == 5 and guard == res.init_guard_state() and opt.count == 5
            want = _rank_states(target, whole, moments)[layout.rank][1]
            for got_t, want_t in zip(opt.param_groups[0]["params"],
                                     want.param_groups[0]["params"]):
                assert torch.equal(got_t, want_t), (target, layout.rank)
                for k in ("exp_avg", "exp_avg_sq", "step"):
                    assert torch.equal(opt.state[got_t][k], want.state[want_t][k])
    restored, _ = ck.restore_params(path, config=CFG)
    assert all(torch.equal(a, b.reshape(a.shape))
               for a, b in zip(ts.param_list(restored), whole))


def test_restore_latest_verified_falls_back_past_corrupt(tmp_path, trained, capsys):
    params, opt, guard = trained
    layout = ck.StateLayout(CFG)
    for s in (1, 2, 3):
        _sync_save(tmp_path, s, opt, layout, guard)
    p3 = tmp_path / "step_0000003" / "params" / "rank_00000.bin"
    p3.write_bytes(p3.read_bytes()[:-4])
    (tmp_path / "step_0000002" / "meta.json").write_text("{not json")
    fresh = _fresh_state()
    meta, _, path = ck.restore_latest_verified(str(tmp_path), *fresh, layout)
    assert meta.step == 1 and path.endswith("step_0000001")
    out = capsys.readouterr().out
    assert out.count("discarding corrupt checkpoint") == 2
    assert _state_equal((params, opt), fresh)


# --- the saver (tests/test_checkpoint.py's cases) -------------------------------


def test_async_save_invisible_until_committed(tmp_path, trained, monkeypatch):
    params, opt, guard = trained
    # Process 0 holds the written checkpoint uncommitted for this long.
    monkeypatch.setenv(ck.COMMIT_DELAY_ENV, "3.0")
    saver = ck.CheckpointSaver(str(tmp_path), ck.StateLayout(CFG), CheckpointPolicy())
    try:
        path = saver.save(1, opt, _meta(1), guard)
        state = os.path.join(path, ck.STATE_NAME)   # the write's last file
        deadline = time.monotonic() + 30
        while not os.path.exists(state) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert os.path.exists(state), "the background write never finished"
        assert os.path.exists(os.path.join(path, ck.INPROGRESS_NAME))
        assert not os.path.exists(os.path.join(path, ck.COMMITTED_NAME))
        assert ck.latest_checkpoint(str(tmp_path)) is None
        assert ck.list_uncommitted(str(tmp_path)) == [path]
        saver.wait(timeout=60)
        assert saver.committed_steps == [1] and saver.failed_saves == 0
        assert ck.latest_checkpoint(str(tmp_path)) == path
        fresh = _fresh_state()
        ck.restore_checkpoint(path, *fresh, ck.StateLayout(CFG))
        assert _state_equal((params, opt), fresh)
    finally:
        saver.close()


def test_saver_retries_transient_failure_then_succeeds(tmp_path, trained, capsys):
    _, opt, guard = trained
    saver = ck.CheckpointSaver(str(tmp_path), ck.StateLayout(CFG),
                               CheckpointPolicy(save_retries=2, retry_backoff_s=0.01))
    saver.inject_fail_at, saver.inject_fail_count = 5, 1
    try:
        path = saver.save(5, opt, _meta(5), guard)
        saver.wait(timeout=60)
        assert saver.failed_saves == 0 and saver.committed_steps == [5]
        assert ck.is_committed_checkpoint(path)
    finally:
        saver.close()
    out = capsys.readouterr().out
    assert "failed (attempt 1/3)" in out and "retrying" in out and "WARNING" not in out


@pytest.mark.parametrize("async_save", [True, False])
def test_saver_exhausted_retries_degrade_without_raising(tmp_path, trained, capsys,
                                                         async_save):
    _, opt, guard = trained
    saver = ck.CheckpointSaver(str(tmp_path), ck.StateLayout(CFG),
                               CheckpointPolicy(async_save=async_save, save_retries=1,
                                                retry_backoff_s=0.01))
    saver.inject_fail_at, saver.inject_fail_count = 7, 10
    try:
        ret = saver.save(7, opt, _meta(7), guard)
        saver.wait(timeout=60)
        assert (ret is None) == (not async_save)
        assert saver.failed_saves == 1 and saver.committed_steps == []
        assert "injected save failure" in saver.last_error
        assert ck.latest_checkpoint(str(tmp_path)) is None
        assert ck.gc_checkpoints(str(tmp_path)) == [str(tmp_path / "step_0000007")]
    finally:
        saver.close()
    out = capsys.readouterr().out
    assert "failed permanently after 2 attempts" in out
    assert "training continues without this checkpoint" in out


def test_emergency_save_waits_out_in_flight_async_save(tmp_path, trained, monkeypatch):
    _, opt, guard = trained
    monkeypatch.setenv(ck.COMMIT_DELAY_ENV, "0.3")
    saver = ck.CheckpointSaver(str(tmp_path), ck.StateLayout(CFG), CheckpointPolicy())
    try:
        saver.save(2, opt, _meta(2), guard)
        path = saver.ensure_committed_sync(2, opt, _meta(2), guard)
        assert ck.is_committed_checkpoint(path)
        assert saver.committed_steps == [2]   # one commit, not two
    finally:
        saver.close()


def test_emergency_save_supersedes_failed_async_save(tmp_path, trained):
    params, opt, guard = trained
    saver = ck.CheckpointSaver(str(tmp_path), ck.StateLayout(CFG),
                               CheckpointPolicy(save_retries=0, retry_backoff_s=0.01))
    saver.inject_fail_at, saver.inject_fail_count = 3, 1
    try:
        saver.save(3, opt, _meta(3), guard)
        saver.wait(timeout=60)
        assert saver.failed_saves == 1 and saver.committed_steps == []
        path = saver.ensure_committed_sync(3, opt, _meta(3), guard)
        assert ck.is_committed_checkpoint(path) and saver.committed_steps == [3]
        assert res.verify_checkpoint(path) == [] == jax_res.verify_checkpoint(path)
        fresh = _fresh_state()
        ck.restore_checkpoint(path, *fresh, ck.StateLayout(CFG))
        assert _state_equal((params, opt), fresh)
    finally:
        saver.close()
