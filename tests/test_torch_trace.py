"""The port's tracing and metric sinks on the CPU, held against the JAX
package: the ``Tracer`` writes the JAX tracer's records for the same calls;
the serving engine's spans and events carry the JAX engine's names and
attributes in three scenarios (reserve whole-prompt, chunked with the
prefix cache, watermark with preemption); the trace-derived TTFT equals
the handle's exactly; tracing changes no token; a default run writes no
file and enters no profiler annotation; ``scripts/obs_report.py`` reads the
port's serving and training traces as it reads the JAX ones; the profiler
window writes a Chrome trace; and the TensorBoard sinks write the JAX
tracker's tags. Tiny fp32 configs, weights through ``params_from_jax``."""

from __future__ import annotations

import argparse
import glob
import json
import os
import struct
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_2_distributed_tpu import train as jax_train
from gpt_2_distributed_tpu.config import ServeConfig as JaxServeConfig
from gpt_2_distributed_tpu.metrics.registry import METRIC_REGISTRY as JAX_REGISTRY
from gpt_2_distributed_tpu.metrics.tracker import StatsTracker as JaxStatsTracker
from gpt_2_distributed_tpu.models import gpt2 as jax_gpt2
from gpt_2_distributed_tpu.obs import trace as jax_trace
from gpt_2_distributed_tpu.serving import ServingEngine as JaxServingEngine
from gpt_2_distributed_torch import train
from gpt_2_distributed_torch.config import GPT2Config, ServeConfig, TracePolicy
from gpt_2_distributed_torch.models.convert import params_from_jax
from gpt_2_distributed_torch.models.decode import generate_cached
from gpt_2_distributed_torch.obs import trace
from gpt_2_distributed_torch.serving import ServingEngine, serve
from gpt_2_distributed_torch.serving.frontend import EngineDriver, ReplicaRouter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBS_REPORT = os.path.join(REPO, "scripts", "obs_report.py")
TINY = ["--n_layer", "2", "--n_embd", "32", "--n_head", "2", "--vocab_size", "257"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tracing_off():
    """Every test leaves both global tracers as runs start: disabled, no
    file open, so no other test in this worker writes a trace."""
    yield
    trace.configure_tracing(None)
    jax_trace.configure_tracing(None)


@pytest.fixture(scope="module")
def jax_params(tiny_config):
    return jax_gpt2.init_params(tiny_config, seed=0)


@pytest.fixture(scope="module")
def port(jax_params, tiny_config):
    cfg = GPT2Config(vocab_size=tiny_config.vocab_size, n_positions=tiny_config.n_positions,
                     n_embd=tiny_config.n_embd, n_layer=tiny_config.n_layer,
                     n_head=tiny_config.n_head)
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params)), cfg


def read_records(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


# --- the Tracer --------------------------------------------------------------


class _Clock:
    """A deterministic stand-in for time.perf_counter / time.time: both
    tracers then write byte-comparable records (and rotate at the same
    record)."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        self.t += 0.25
        return self.t

    def time(self):
        return 1.75e9


def _script(tr):
    """The same calls, for either package's Tracer: nesting, attrs set
    after entry, events with and without a stamp, counters, open spans
    (this thread and another), then enough records to rotate."""
    snaps = []
    with tr.span("step", n=1):
        with tr.span("data_fetch"):
            pass
        with tr.span("device_sync", step=1) as sp:
            sp.set(late=True)
            snaps.append(tr.open_spans()[threading.get_ident()])
        tr.event("guard_skip", step=1, reason=2)
        tr.event("first_token", ts=123.5, rid=7)
        tr.counter("queue_depth", 3, replica=0)
    entered, release = threading.Event(), threading.Event()

    def worker():
        with tr.span("bg"):
            entered.set()
            release.wait(5)

    t = threading.Thread(target=worker)
    with tr.span("outer"):
        t.start()
        assert entered.wait(5)
        snaps.append(sorted(tr.open_spans().values()))
    release.set()
    t.join(5)
    for i in range(30):
        tr.event("filler", ts=float(i), i=i, pad="x" * 64)
    tr.close()
    return snaps


def test_tracer_writes_the_jax_tracers_records(tmp_path, monkeypatch):
    out = {}
    for name, mod in (("jax", jax_trace), ("port", trace)):
        clock = _Clock()
        monkeypatch.setattr(mod.time, "perf_counter", clock.perf_counter)
        monkeypatch.setattr(mod.time, "time", clock.time)
        d = tmp_path / name
        tr = mod.Tracer(str(d), enabled=True, max_file_bytes=4096)
        snaps = _script(tr)
        monkeypatch.undo()
        files = sorted(os.listdir(d))
        recs = {f: read_records(d / f) for f in files}
        for rs in recs.values():
            for r in rs:
                r.pop("tid", None)   # two threads of this process; ids differ
        out[name] = (files, recs, snaps, tr.dropped_records)
    assert out["port"] == out["jax"]
    files, recs, snaps, dropped = out["port"]
    assert files == ["trace-p0.jsonl", "trace-p0.jsonl.1"]     # rotated once
    assert snaps[0] == ["step", "device_sync"] and snaps[1] == [["bg"], ["outer"]]
    assert dropped == 0
    names = [r["name"] for r in recs["trace-p0.jsonl.1"] if r["ph"] != "meta"]
    assert names[:8] == ["data_fetch", "device_sync", "guard_skip", "first_token",
                         "queue_depth", "step", "outer", "bg"]


def test_disabled_tracer_is_free_and_policy_checks_as_jax():
    tr = trace.Tracer()
    assert tr.span("a") is tr.span("b") is trace._NULL_SPAN
    tr.event("x")
    assert tr.open_spans() == {} and tr._file is None
    assert TracePolicy().enabled is False and TracePolicy("d").enabled
    for bad in (100, 4095):
        with pytest.raises(ValueError, match="max_file_bytes"):
            TracePolicy(max_file_bytes=bad)
    assert trace.parse_profile_at("3:2") == jax_trace.parse_profile_at("3:2") == (3, 2)
    assert trace.parse_profile_at("7") == (7, 1) and trace.parse_profile_at(None) is None
    with pytest.raises(ValueError, match="STEP"):
        trace.parse_profile_at("-1")


# --- the serving engine ------------------------------------------------------

PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11], [42], [5, 6],
           [200, 201, 202, 3, 4, 5, 6, 7, 8], list(range(30, 43))]
NEWS = [10, 7, 12, 1, 9, 6]
PFX = list(range(200, 208))
# The prefix cache and chunks: sharers of one 8-token block, the block
# alone (block-aligned and fully cached: a copy-on-write), and strangers.
CACHED = [(PFX + [1, 2, 3], 6), ([9, 9, 9, 9], 4), (PFX + [4, 5], 7), ([3] * 13, 6),
          (PFX + [6, 7, 8, 9, 10, 11], 3), (PFX, 4)]


def _churn():
    rng = np.random.default_rng(7)
    specs = []
    for i in range(8):
        pl, nw = (5, 9, 13, 17)[i % 4], (6, 12)[i % 2]
        p = (PFX + rng.integers(1, 257, pl - 8).tolist() if i % 3 != 2 and pl > 8
             else rng.integers(1, 257, pl).tolist())
        specs.append((p, nw))
    return specs


SCENARIOS = {
    "reserve_whole": (list(zip(PROMPTS, NEWS)), dict(num_blocks=32)),
    "chunked_cache": (CACHED, dict(num_blocks=32, prefix_cache=True, prefill_chunk=3,
                                   prefill_batch=2)),
    "watermark_preempt": (_churn(), dict(num_blocks=8, prefix_cache=True,
                                         admission="watermark")),
}
# Attributes that depend on time or on block ids; everything else must match.
VOLATILE = {"dur_ms", "queue_wait_ms", "src", "dst"}


def _signature(records):
    return [(r["ph"], r["name"],
             {k: v for k, v in r.get("attrs", {}).items() if k not in VOLATILE})
            for r in records if r["ph"] != "meta"]


@pytest.fixture(scope="module")
def jax_traces(jax_params, tiny_config, tmp_path_factory):
    """Each scenario through the JAX engine once a module, traced."""
    out = {}
    for name, (specs, kw) in SCENARIOS.items():
        d = tmp_path_factory.mktemp(f"jax-{name}")
        jax_trace.configure_tracing(str(d))
        eng = JaxServingEngine(jax_params, tiny_config,
                               JaxServeConfig(max_batch=4, block_size=8, attn_impl="xla", **kw),
                               temperature=0.0, compute_dtype=jnp.float32)
        hs = [eng.submit(p, n, rng=i) for i, (p, n) in enumerate(specs)]
        eng.run_until_idle(max_steps=2000)
        jax_trace.configure_tracing(None)
        out[name] = (str(d), [h.generated for h in hs], dict(eng.stats))
    return out


def _port_run(port, specs, kw, trace_dir=None, temperature=0.0, top_k=None):
    params, cfg = port
    if trace_dir is not None:
        trace.configure_tracing(str(trace_dir))
    eng = ServingEngine(params, cfg, ServeConfig(max_batch=4, block_size=8, **kw),
                        device="cpu", temperature=temperature, top_k=top_k,
                        compute_dtype=torch.float32)
    hs = [eng.submit(p, n, seed=i) for i, (p, n) in enumerate(specs)]
    eng.run_until_idle(max_steps=2000)
    trace.configure_tracing(None)
    return eng, hs


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_trace_equals_the_jax_engines(port, jax_traces, tmp_path, scenario):
    """Span and event names in order, with every attribute that depends
    neither on time nor on block ids, equal to the JAX engine's; the
    trace-derived TTFT equals each handle's exactly."""
    specs, kw = SCENARIOS[scenario]
    jax_dir, jax_tokens, jax_stats = jax_traces[scenario]
    eng, hs = _port_run(port, specs, kw, tmp_path)
    assert [h.generated for h in hs] == jax_tokens
    recs = read_records(tmp_path / "trace-p0.jsonl")
    jax_recs = read_records(os.path.join(jax_dir, "trace-p0.jsonl"))
    assert _signature(recs) == _signature(jax_recs)
    names = {r.get("name") for r in recs}
    want = {"reserve_whole": {"engine_step", "admit", "prefill", "decode", "submit",
                              "prefill_chunk", "first_token", "finish"},
            "chunked_cache": {"prefix_hit", "cow"},
            "watermark_preempt": {"grow", "preempt", "resume", "prefix_hit"}}[scenario]
    assert want <= names, want - names
    for k in ("preemptions", "cow_copies", "prefix_hit_tokens", "decode_steps"):
        assert eng.stats[k] == jax_stats[k], k
    ev = {}
    for r in recs:
        if r["ph"] == "event" and r["name"] in ("submit", "first_token"):
            ev.setdefault(r["attrs"]["rid"], {})[r["name"]] = r["ts"]
    for h in hs:
        assert ev[h.id]["first_token"] - ev[h.id]["submit"] == \
            h.first_token_time - h.submit_time
    # Every engine_step holds admit and prefill, and decode when rows decoded.
    spans = [r for r in recs if r["ph"] == "span"]
    kids = {}
    for r in spans:
        kids.setdefault(r["parent"], []).append(r["name"])
    steps = [r for r in spans if r["name"] == "engine_step"]
    assert all({"admit", "prefill"} <= set(kids[s["sid"]]) for s in steps)
    assert sum(kids[s["sid"]].count("decode") for s in steps) == eng.stats["decode_steps"]


@pytest.mark.parametrize("temperature,top_k", [(0.0, None), (0.9, 40)])
def test_tracing_changes_no_token(port, tmp_path, temperature, top_k):
    specs, kw = SCENARIOS["watermark_preempt"]
    _, on = _port_run(port, specs, kw, tmp_path, temperature, top_k)
    _, off = _port_run(port, specs, kw, None, temperature, top_k)
    params, cfg = port
    refs = [generate_cached(params, cfg, [p], seed=i, max_new_tokens=n,
                            temperature=temperature, top_k=top_k,
                            compute_dtype=torch.float32, device="cpu")[0, len(p):].tolist()
            for i, (p, n) in enumerate(specs)]
    assert [h.generated for h in on] == [h.generated for h in off] == refs


def test_default_run_writes_no_file_and_enters_no_annotation(port, tmp_path, monkeypatch):
    """Tracing off, and tracing on without a profiler window: no
    ``record_function`` is ever entered; tracing off writes nothing."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered outside a profiler window")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.chdir(tmp_path)
    specs, kw = SCENARIOS["reserve_whole"]
    _port_run(port, specs, kw)
    assert list(tmp_path.iterdir()) == [] and trace.get_tracer()._file is None
    _port_run(port, specs, kw, tmp_path / "on")
    assert os.listdir(tmp_path / "on") == ["trace-p0.jsonl"]


def _report(trace_dir):
    out = subprocess.run([sys.executable, OBS_REPORT, "--json", str(trace_dir)],
                         capture_output=True, text=True, timeout=60, cwd=REPO)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)


def test_obs_report_reads_the_port_serving_trace_as_the_jax_one(port, jax_traces, tmp_path):
    specs, kw = SCENARIOS["watermark_preempt"]
    _, hs = _port_run(port, specs, kw, tmp_path)
    mine, theirs = _report(tmp_path), _report(jax_traces["watermark_preempt"][0])
    assert set(mine["engine_steps"]["phases"]) == set(theirs["engine_steps"]["phases"])
    assert mine["engine_steps"]["n_steps"] == theirs["engine_steps"]["n_steps"]
    rows = {r["rid"]: r for r in mine["serving"]["requests"]}
    for h in hs:
        assert rows[h.id]["first_token_ms"] == pytest.approx(
            (h.first_token_time - h.submit_time) * 1e3, abs=1e-9)
        assert rows[h.id]["events"] == {
            k: v for k, v in next(r for r in theirs["serving"]["requests"]
                                  if r["rid"] == h.id)["events"].items()}


# --- the training loop -------------------------------------------------------

TRAIN = ["--seq_len", "32", "--batch", "4", "--max_steps", "4", "--eval_every", "2",
         "--cli_every", "1"]


ATTRIBUTION_STEPS = 12


def _attributed_pct_after_first(trace_dir) -> float:
    """The share of the ``step`` spans' wall that their child spans cover,
    over every step but the first (which carries the one-time set-up)."""
    spans = [r for r in read_records(trace_dir / "trace-p0.jsonl") if r["ph"] == "span"]
    steps = {r["sid"]: r for r in spans if r["name"] == "step" and r["attrs"]["n"] > 1}
    covered = sum(r["dur"] for r in spans if r.get("parent") in steps)
    return 100.0 * covered / sum(r["dur"] for r in steps.values())


def test_training_trace_phases_and_attribution(shard_dir, tmp_path):
    """The port's step spans against a JAX training run's (the same
    flags): the same phase names, one ``step`` span an optimizer step, at
    least 90% of the step wall attributed over the steps after the first
    (12 steps, so that one stall of the host between two spans cannot
    decide it); and the losses equal an untraced run's bit for bit."""
    flags = ["--data_dir", shard_dir, "--n_layer", "1", "--n_embd", "32", "--n_head", "2",
             "--vocab_size", "257", "--grad_accum_steps", "1", "--eval_batches", "1",
             "--step_guard", "off"] + TRAIN + ["--max_steps", str(ATTRIBUTION_STEPS)]
    jax_train.main(flags + ["--trace_dir", str(tmp_path / "jax")])
    jax_trace.configure_tracing(None)
    traced = train.main(flags + ["--device", "cpu", "--trace_dir", str(tmp_path / "port")])
    plain = train.main(flags + ["--device", "cpu"])
    assert list(traced.buffers["loss"]) == list(plain.buffers["loss"])
    mine, theirs = _report(tmp_path / "port"), _report(tmp_path / "jax")
    assert set(mine["train_steps"]["phases"]) == set(theirs["train_steps"]["phases"]) == {
        "data_fetch", "h2d", "step_dispatch", "h2d_prefetch", "device_sync", "collector",
        "eval"}
    assert mine["train_steps"]["n_steps"] == ATTRIBUTION_STEPS
    assert _attributed_pct_after_first(tmp_path / "port") >= 90.0


def test_guard_skip_event_and_profiler_window(shard_dir, tmp_path):
    """``--inject_nan_at 2`` under the guard gives one ``guard_skip``
    event; ``--xla_profile_at 2:2`` writes a Chrome trace under
    ``<log_dir>/xla_profile`` whose annotations are the step's spans;
    ``--profile`` and ``--xla_profile_at`` exclude each other."""
    flags = ["--data_dir", shard_dir, "--device", "cpu", *TINY, "--grad_accum_steps", "2",
             "--inject_nan_at", "2", "--log_dir", str(tmp_path / "log"),
             "--xla_profile_at", "2:2", "--trace_dir", str(tmp_path / "tr")] + TRAIN
    train.main(flags)
    events = [r for r in read_records(tmp_path / "tr" / "trace-p0.jsonl")
              if r["ph"] == "event"]
    assert [(e["name"], e["attrs"]) for e in events if e["name"] == "guard_skip"] == [
        ("guard_skip", {"step": 2, "reason": 1})]
    assert [e["attrs"]["step"] for e in events if e["name"].startswith("xla_profile")] == [2, 3]
    (path,) = glob.glob(str(tmp_path / "log" / "xla_profile" / "*.json"))
    ann = {e["name"] for e in json.load(open(path))["traceEvents"]
           if e.get("cat") == "user_annotation"}
    assert {"step_dispatch", "device_sync", "collector"} <= ann
    for bad in (["--profile", "--xla_profile_at", "1"], ["--xla_profile_at", "1"],
                ["--profile"], ["--trace_max_file_bytes", "100", "--trace_dir", "t"]):
        argv = ["--data_dir", shard_dir, "--device", "cpu", *bad]
        if "--profile" in bad and "--xla_profile_at" in bad:
            argv += ["--log_dir", str(tmp_path)]
        with pytest.raises(SystemExit) as e:
            train.main(argv)
        assert e.value.code == 2


# --- the TensorBoard sinks ---------------------------------------------------


def tb_scalars(log_dir) -> dict[str, list[tuple[int, float]]]:
    """Every scalar of the event files under ``log_dir`` (TFRecord: length,
    its crc, the Event proto, its crc)."""
    from tensorboardX.proto import event_pb2

    out: dict[str, list] = {}
    for path in sorted(glob.glob(os.path.join(str(log_dir), "events.out.tfevents.*"))):
        data = open(path, "rb").read()
        i = 0
        while i < len(data):
            (n,) = struct.unpack("<Q", data[i:i + 8])
            ev = event_pb2.Event.FromString(data[i + 12:i + 12 + n])
            i += 12 + n + 4
            for v in ev.summary.value:
                out.setdefault(v.tag, []).append((ev.step, v.simple_value))
    return out


def test_tensorboard_sinks_write_the_jax_trackers_tags(shard_dir, port, tmp_path):
    """Training (``--log_dir``) and serving (``--tb_dir``): every tag is the
    JAX registry's tag for that metric, and the JAX tracker, given the same
    serving snapshot, drops none of its names."""
    flags = ["--data_dir", shard_dir, "--device", "cpu", *TINY, "--grad_accum_steps", "2",
             "--log_dir", str(tmp_path / "train"), "--tb_every", "2"] + TRAIN
    tracker = train.main(flags)
    tags = tb_scalars(tmp_path / "train")
    assert {"train/loss", "train/lr", "perf/tokens_per_second", "eval/eval_loss"} <= set(tags)
    assert [s for s, _ in tags["train/loss"]] == [2, 4]
    assert tags["train/loss"][-1][1] == pytest.approx(
        sum(tracker.buffers["loss"]) / len(tracker.buffers["loss"]), rel=1e-6)

    params, cfg = port
    router = ReplicaRouter(lambda: ServingEngine(params, cfg, ServeConfig(
        max_batch=4, block_size=8, num_blocks=32), device="cpu", temperature=0.0),
        replicas=2)
    sink = serve.make_tracker(argparse.Namespace(tb_dir=str(tmp_path / "serve")))
    driver = EngineDriver(router, tracker=sink, metrics_every=3)
    for i, (p, n) in enumerate(zip(PROMPTS, NEWS)):
        driver.submit(p, n, seed=i)
    driver.drain()
    driver.close()
    tags.update(tb_scalars(tmp_path / "serve"))
    assert {f"serve/{k}" for k in driver._metrics()} <= set(tags)
    for tag in tags:
        group, name = tag.split("/", 1)
        assert JAX_REGISTRY.get(name).tb_tag == tag
    jax_sink = JaxStatsTracker(str(tmp_path / "jax"), batch_size=0, seq_len=0)
    jax_sink.update(1, count_tokens=False, **driver._metrics())
    jax_sink.close()
    assert jax_sink.dropped_metrics == {}
    assert tags["serve/serve_replicas"][-1][1] == 2.0
    assert tags["serve/serve_occupancy"][-1][1] == 0.0
