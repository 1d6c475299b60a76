"""Serving CLI of the PyTorch port: run a batch of requests through the
continuous-batching engine, streaming results as JSON lines.

Requests come from a JSONL file or stdin, one object per line::

    {"prompt_ids": [464, 3616], "new": 64, "seed": 7}

Per-line fields default to ``--new`` / ``--seed``; an optional
``timeout_s`` sets that request's deadline (``--request_timeout_s`` for
lines without one: an overdue request is evicted with finish reason
"timeout" and its KV blocks freed). Output is JSONL on stdout:
with ``--stream`` a ``{"id", "token"}`` line per token as it is produced,
and always a final record per request with the JAX CLI's keys
(``id``, ``generated``, ``text``, ``finish_reason``, ``ttft_ms``,
``queue_wait_ms``, ``preempted``, ``prefix_cached_tokens``). All requests
are submitted up front and served up to ``--max_batch`` at a time.

Weights come from ``--ckpt`` (a training run's ``--save_dir``, whose
newest verified checkpoint is read onto the serving device, or one
``step_*`` dir), ``--params_npz`` (a JAX-layout tree saved with
``models/convert.py::save_npz``) or ``--init_random`` (seeded init). The
engine runs on CUDA; ``--device cpu`` runs it on the CPU, and without a
visible GPU nothing else runs.

``--prefix_cache`` shares KV blocks across requests whose prompts share a
prefix; ``--prefill_chunk N`` prefills prompts in N-token chunks between
decode steps, ``--prefill_batch B`` of them a step in one dispatch.
``--admission watermark`` grants KV blocks as requests grow, keeping
``--watermark_blocks`` free at admission, and preempts the newest request
when the pool runs out; it resumes later by recomputing its prefill, with
no token emitted twice. The summary line on stderr counts the preemptions.

``--draft_preset P [--spec_k K] [--draft_ckpt D]`` serves speculatively: a
draft model of preset P (strictly fewer params than the target; it takes
the target's vocab and context) proposes K tokens a round (default 4) and
the target verifies them in one pass. Greedy streams stay those of plain
decoding, sampled streams stay distributed as the target's. The draft's
weights come from ``--draft_ckpt`` (read as ``--ckpt`` is), else from a
seeded init, which is correct but rarely accepted.

The step loop is ``serving/frontend/driver.py``'s ``EngineDriver`` over a
one-replica ``ReplicaRouter``, the loop the HTTP front end
(``gpt2-torch-frontend``) runs too. SIGTERM drains: the requests in
flight run to completion, every final record is printed, and the process
exits 0. ``--trace_dir`` writes span/event traces (``obs/trace.py``; read
them with ``scripts/obs_report.py``), ``--xla_profile_at STEP[:NSTEPS]``
opens a ``torch.profiler`` window over those engine steps (a Chrome trace
under ``<trace_dir or tb_dir>/xla_profile``), and ``--tb_dir`` writes the
serving-load metrics to TensorBoard every ``--metrics_every`` engine steps
(it needs ``tensorboardX``).

The parser takes every flag of the JAX CLI, under the same names, types
and defaults. Serving meshes, replica placement, the step watchdog and
fault injection come with later slices of the port: any other value than
the default of those flags is refused.

Usage::

    python -m gpt_2_distributed_torch.serving.serve --init_random \\
        --requests reqs.jsonl --stream [--trace_dir traces]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

# Flags of the JAX CLIs whose planes come with later slices of the port,
# with the value that leaves them off; any other value is refused.
_UNPORTED = {
    "serve_mesh": "",
    "placement": "inprocess", "worker_max_respawns": 3,
    "worker_respawn_backoff_s": 2.0, "worker_rpc_timeout_s": 300.0,
    "worker_heartbeat_s": 1.0, "worker_connect_timeout_s": 120.0,
    "worker_heartbeat_timeout_s": None, "worker_auth_token_file": None,
    "worker_pool": None, "watchdog_timeout_s": None,
    "inject_replica_fail_at": None, "inject_replica_hang_at": None,
    "inject_step_exception": None,
}
PLACEMENTS = ("inprocess", "subprocess", "remote")


def add_model_flags(p: argparse.ArgumentParser) -> None:
    """Weights and model-shape flags, shared with ``gpt2-torch-frontend``."""
    from gpt_2_distributed_torch.config import MODEL_PRESETS

    p.add_argument("--params_npz", default=None,
                   help="weights: a JAX-layout .npz (models/convert.py)")
    p.add_argument("--init_random", action="store_true",
                   help="serve seeded-init weights instead of --params_npz")
    p.add_argument("--ckpt", default=None,
                   help="weights: a training --save_dir (its newest verified "
                   "checkpoint) or one step_* dir")
    p.add_argument("--model", default="124M", choices=sorted(MODEL_PRESETS))
    p.add_argument("--n_layer", type=int, default=None)
    p.add_argument("--n_embd", type=int, default=None)
    p.add_argument("--n_head", type=int, default=None)
    p.add_argument("--vocab_size", type=int, default=None)
    p.add_argument("--seq_len", type=int, default=None)


def add_engine_flags(p: argparse.ArgumentParser) -> None:
    """ServeConfig and sampling flags, shared with the front end."""
    from gpt_2_distributed_torch.config import ATTN_IMPLS

    p.add_argument("--new", type=int, default=64,
                   help="default max_new_tokens for requests without one")
    p.add_argument("--seed", type=int, default=0,
                   help="default sampling seed for requests without one")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--eos", type=int, default=None,
                   help="token id that finishes a request early")
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--block_size", type=int, default=16)
    p.add_argument("--num_blocks", type=int, default=0,
                   help="KV pool blocks; 0 = max_batch worst-case sequences")
    p.add_argument("--attn_impl", default="auto", choices=list(ATTN_IMPLS),
                   help="attention: CUDA kernels on the card (auto), kernels "
                        "only (kernel), or the plain PyTorch versions (plain)")
    p.add_argument("--prefill_chunk", type=int, default=0,
                   help="prefill chunk width; 0 = whole-prompt prefill")
    p.add_argument("--prefill_batch", type=int, default=1,
                   help="chunked mode: in-progress prefills advanced per step")
    p.add_argument("--serve_mesh", default="",
                   help="serving mesh spec 'data:N[,tp:M]' (later slice)")
    p.add_argument("--prefix_cache", action="store_true",
                   help="reuse KV blocks across shared prompt prefixes")
    p.add_argument("--admission", default="reserve",
                   choices=["reserve", "watermark"],
                   help="block grant policy: worst-case reservation, or "
                   "lazy growth with preemption under pool pressure")
    p.add_argument("--watermark_blocks", type=int, default=1,
                   help="free-block floor for --admission watermark")
    p.add_argument("--draft_preset", default=None,
                   help="speculative decoding: draft-model preset (must be "
                        "smaller than --model); greedy streams stay "
                        "bit-identical, sampled streams stay "
                        "target-distributed")
    p.add_argument("--spec_k", type=int, default=None,
                   help="draft tokens per verify pass (default 4; needs "
                        "--draft_preset)")
    p.add_argument("--draft_ckpt", default=None,
                   help="draft-model checkpoint dir; seeded init when "
                        "omitted (a random draft is correct, just "
                        "rarely accepted)")


def add_obs_flags(p: argparse.ArgumentParser) -> None:
    """Metrics, tracing and profiling flags, and the device; shared with
    the front end."""
    p.add_argument("--tb_dir", default=None,
                   help="TensorBoard dir for serving-load metrics (needs "
                        "tensorboardX)")
    p.add_argument("--metrics_every", type=int, default=20,
                   help="engine steps between --tb_dir metric flushes")
    p.add_argument("--trace_dir", default=None,
                   help="write span/event trace JSONL here (obs/trace.py)")
    p.add_argument("--trace_max_file_bytes", type=int, default=64 * 1024 * 1024,
                   help="rotate trace-p*.jsonl past this size")
    p.add_argument("--xla_profile_at", default=None, metavar="STEP[:NSTEPS]",
                   help="a torch.profiler window over NSTEPS (default 1) "
                        "engine steps from STEP, its Chrome trace written "
                        "under --trace_dir (or --tb_dir)/xla_profile")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")


def add_placement_flags(p: argparse.ArgumentParser) -> None:
    """Replica placement and worker supervision flags (later slice)."""
    p.add_argument("--placement", default="inprocess", choices=list(PLACEMENTS),
                   help="replica placement")
    p.add_argument("--worker_max_respawns", type=int, default=3)
    p.add_argument("--worker_respawn_backoff_s", type=float, default=2.0)
    p.add_argument("--worker_rpc_timeout_s", type=float, default=300.0)
    p.add_argument("--worker_heartbeat_s", type=float, default=1.0)
    p.add_argument("--worker_connect_timeout_s", type=float, default=120.0)
    p.add_argument("--worker_heartbeat_timeout_s", type=float, default=None)
    p.add_argument("--worker_auth_token_file", default=None)
    p.add_argument("--worker_pool", default=None)


def add_fault_flags(p: argparse.ArgumentParser) -> None:
    """Request deadlines; the watchdog and fault injection (later slice)."""
    p.add_argument("--request_timeout_s", type=float, default=None,
                   help="per-request deadline from submission (queue wait "
                        "included) for requests without their own "
                        "'timeout_s'; overdue requests are evicted with "
                        "finish reason 'timeout' and their KV blocks freed")
    p.add_argument("--watchdog_timeout_s", type=float, default=None,
                   help="fail a replica whose single step exceeds this")
    p.add_argument("--inject_replica_fail_at", default=None, metavar="STEP[:REPLICA]")
    p.add_argument("--inject_replica_hang_at", default=None, metavar="STEP[:REPLICA]")
    p.add_argument("--inject_step_exception", type=int, default=None, metavar="STEP")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_model_flags(p)
    p.add_argument("--requests", required=True,
                   help="JSONL request file, or '-' for stdin")
    add_engine_flags(p)
    p.add_argument("--stream", action="store_true",
                   help="emit a JSON line per token as it is generated")
    add_obs_flags(p)
    add_placement_flags(p)
    add_fault_flags(p)
    return p


def _refuse_unported(p: argparse.ArgumentParser, args: argparse.Namespace) -> None:
    for dest, off in _UNPORTED.items():
        value = getattr(args, dest)
        if value != off:
            p.error(f"--{dest} {value!r} is not ported to PyTorch yet: it comes "
                    f"in a later slice of the port")


def model_config_from_args(args: argparse.Namespace):
    """GPT2Config from --model plus overrides."""
    from gpt_2_distributed_torch.config import MODEL_PRESETS

    overrides = {k: getattr(args, k)
                 for k in ("n_layer", "n_embd", "n_head", "vocab_size")
                 if getattr(args, k) is not None}
    if args.seq_len is not None:
        overrides["n_positions"] = args.seq_len
    return MODEL_PRESETS[args.model].replace(**overrides)


def build_serve_config(args: argparse.Namespace, config):
    """ServeConfig from the engine flags (0 blocks = worst case)."""
    from gpt_2_distributed_torch.config import ServeConfig

    probe = ServeConfig(max_batch=args.max_batch, block_size=args.block_size)
    num_blocks = args.num_blocks or (
        1 + args.max_batch * probe.max_blocks_per_seq(config.n_positions)
    )
    spec = f"draft:{args.draft_preset},k:{args.spec_k or 4}" if args.draft_preset else ""
    return ServeConfig(max_batch=args.max_batch, block_size=args.block_size,
                       num_blocks=num_blocks, attn_impl=args.attn_impl,
                       eos_id=args.eos, prefill_chunk=args.prefill_chunk,
                       prefix_cache=args.prefix_cache,
                       prefill_batch=args.prefill_batch,
                       admission=args.admission,
                       watermark_blocks=args.watermark_blocks, spec=spec)


def read_requests(path: str, args: argparse.Namespace) -> list[tuple]:
    """(prompt_ids, new, seed, timeout_s) per JSONL line; exits on a bad line."""
    specs = []
    lines = sys.stdin if path == "-" else open(path, encoding="utf-8")
    with lines:
        for ln, line in enumerate(lines, 1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                sys.exit(f"--requests line {ln}: bad JSON ({e})")
            if "prompt_ids" not in obj:
                sys.exit(f"--requests line {ln}: 'prompt_ids' is required "
                         f"(text prompts need a tokenizer this CLI lacks)")
            timeout_s = obj.get("timeout_s")
            specs.append(([int(t) for t in obj["prompt_ids"]],
                          int(obj.get("new", args.new)),
                          int(obj.get("seed", args.seed)),
                          None if timeout_s is None else float(timeout_s)))
    if not specs:
        sys.exit("--requests: no requests")
    return specs


def setup_observability(p: argparse.ArgumentParser, args: argparse.Namespace):
    """Tracing and profiler-window wiring shared by serve and the front
    end. Returns the armed :class:`ProfilerCapture` (inert when
    unconfigured); exits through ``p.error`` on an invalid flag."""
    from gpt_2_distributed_torch.config import TracePolicy
    from gpt_2_distributed_torch.obs.trace import (
        ProfilerCapture,
        configure_tracing,
        parse_profile_at,
    )

    try:
        policy = TracePolicy(trace_dir=args.trace_dir,
                             max_file_bytes=args.trace_max_file_bytes,
                             xla_profile_at=args.xla_profile_at)
        spec = parse_profile_at(policy.xla_profile_at)
    except ValueError as e:
        p.error(str(e))
    profile_root = args.trace_dir or args.tb_dir
    if spec and not profile_root:
        p.error("--xla_profile_at needs --trace_dir or --tb_dir for output")
    if policy.enabled:
        configure_tracing(policy.trace_dir, max_file_bytes=policy.max_file_bytes)
    return ProfilerCapture(spec, profile_root)


def make_tracker(args: argparse.Namespace):
    """The --tb_dir serving sink, or None. Exits when tensorboardX is
    missing."""
    if not args.tb_dir:
        return None
    from gpt_2_distributed_torch.metrics.tracker import StatsTracker

    # batch/seq 0: the serving sink never counts training tokens; every
    # update is out-of-band (count_tokens=False), TensorBoard only.
    try:
        return StatsTracker(batch_size=0, seq_len=0, tb_dir=args.tb_dir)
    except RuntimeError as e:
        sys.exit(f"--tb_dir: {e}")


def cli_device(args: argparse.Namespace):
    """``--device`` as a torch device; exits when it is not there."""
    from gpt_2_distributed_torch.utils.device import resolve_device

    try:
        return resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        sys.exit(f"--device {args.device}: {e}")


def engine_factory(p: argparse.ArgumentParser, args: argparse.Namespace, device):
    """A function building one in-process replica on ``device`` over one
    copy of the weights (``--init_random``, ``--ckpt`` or ``--params_npz``)
    and of the draft model's, under ``--draft_preset``."""
    from gpt_2_distributed_torch.models import gpt2
    from gpt_2_distributed_torch.models.convert import load_npz
    from gpt_2_distributed_torch.serving.engine import ServingEngine

    config = model_config_from_args(args)
    try:
        serve = build_serve_config(args, config)
    except ValueError as e:
        p.error(str(e))
    if args.init_random:
        params = gpt2.init_params(config)
    elif args.ckpt:
        params = load_checkpoint_params(args.ckpt, config, device)
    else:
        params = load_npz(args.params_npz)
    draft_config, draft_params = load_draft_model(args, config, device)

    def make_engine():
        return ServingEngine(params, config, serve, temperature=args.temperature,
                             top_k=args.top_k, device=device,
                             draft_params=draft_params, draft_config=draft_config)

    return make_engine


def load_draft_model(args: argparse.Namespace, config, device):
    """``(draft_config, draft_params)`` of ``--draft_preset``, or ``(None,
    None)`` when speculation is off. The draft takes the target's vocab
    and context (acceptance compares distributions over one token space;
    the draft re-encodes the whole committed prefix) and keeps its
    preset's depth and width. Its weights come from ``--draft_ckpt``, else
    from a seeded init: a random draft is still correct, it is just rarely
    accepted."""
    if args.draft_preset is None:
        return None, None
    from gpt_2_distributed_torch.config import MODEL_PRESETS
    from gpt_2_distributed_torch.models import gpt2

    draft_config = MODEL_PRESETS[args.draft_preset].replace(
        vocab_size=config.vocab_size, n_positions=config.n_positions)
    if args.draft_ckpt:
        return draft_config, load_checkpoint_params(args.draft_ckpt, draft_config, device,
                                                    "draft checkpoint", "--draft_ckpt")
    return draft_config, gpt2.init_params(draft_config)


def load_checkpoint_params(ckpt: str, config, device, label: str = "checkpoint",
                           flag: str = "--ckpt"):
    """The params of ``--ckpt`` (or the draft's ``--draft_ckpt``) on
    ``device``: the step dir itself, or the newest checkpoint under a save
    dir that passes verification. Exits when there is none or it holds
    another model."""
    import os

    from gpt_2_distributed_torch.checkpoint import latest_verified_checkpoint, restore_params

    path = latest_verified_checkpoint(os.path.abspath(ckpt))
    if path is None:
        sys.exit(f"no verified {label} found under {ckpt!r}")
    try:
        params, meta = restore_params(path, device, config)
    except ValueError as e:
        sys.exit(f"{flag}: {e}")
    print(f"{label}: {path} (step {meta.step})", file=sys.stderr)
    return params


def check_common_args(p: argparse.ArgumentParser, args: argparse.Namespace) -> None:
    """The refusals both serving CLIs share."""
    from gpt_2_distributed_torch.config import validate_spec_flags

    _refuse_unported(p, args)
    validate_spec_flags(p, args)
    if sum((args.params_npz is not None, args.init_random, args.ckpt is not None)) != 1:
        p.error("exactly one of --ckpt / --params_npz / --init_random is required")
    if args.request_timeout_s is not None and args.request_timeout_s < 0:
        p.error(f"--request_timeout_s={args.request_timeout_s} must be >= 0")


DRAIN_NOTICE = ("draining: in-flight requests will complete, new submits "
                "are refused, then exit 0")


def main(argv: list[str] | None = None) -> None:
    p = build_argparser()
    args = p.parse_args(argv)
    check_common_args(p, args)

    from gpt_2_distributed_torch.obs.trace import configure_tracing
    from gpt_2_distributed_torch.resilience import PreemptionHandler
    from gpt_2_distributed_torch.serving.frontend.driver import EngineDriver
    from gpt_2_distributed_torch.serving.frontend.router import ReplicaRouter

    device = cli_device(args)
    capture = setup_observability(p, args)
    tracker = make_tracker(args)
    specs = read_requests(args.requests, args)
    router = ReplicaRouter(engine_factory(p, args, device), replicas=1)
    # SIGTERM = finish what was accepted, exit 0. Every request below is
    # submitted before the loop starts, so the flag can only stop further
    # submits: a TERM during the batch drains instead of cutting streams.
    handler = PreemptionHandler(notice=DRAIN_NOTICE).install()
    driver = EngineDriver(router, tracker=tracker, metrics_every=args.metrics_every,
                          profiler_capture=capture, preemption=handler,
                          request_timeout_s=args.request_timeout_s)

    def on_token(req, tok):
        if args.stream:
            print(json.dumps({"id": req.id, "token": tok}), flush=True)

    t0 = time.monotonic()
    handles = []
    try:
        for ids, new, seed, timeout_s in specs:
            try:
                handles.append(driver.submit(ids, new, seed=seed, on_token=on_token,
                                             timeout_s=timeout_s))
            except ValueError as e:
                sys.exit(f"request {len(handles)}: {e}")
        driver.drain()
    finally:
        driver.close()
        if args.trace_dir:
            configure_tracing(None)   # closes the file; later runs trace nothing
        handler.uninstall()
    wall = time.monotonic() - t0

    eng = router.engines[0]
    for h in handles:
        print(json.dumps({
            "id": h.id,
            "generated": h.generated,
            "text": None,
            "finish_reason": h.finish_reason,
            "ttft_ms": (round((h.first_token_time - h.submit_time) * 1e3, 2)
                        if h.first_token_time is not None else None),
            "queue_wait_ms": round(h.queue_wait_ms, 2),
            "preempted": h.preemptions,
            "prefix_cached_tokens": h.prefix_cached_tokens,
        }), flush=True)
    toks = sum(len(h.generated) for h in handles)
    print(f"{len(handles)} requests, {toks} tokens, {wall:.3f}s "
          f"({toks / wall:.0f} tok/s), {eng.stats['decode_steps']} decode "
          f"steps on {device}, {eng.stats['preemptions']} preemptions, "
          f"{eng.stats['prefix_hit_tokens']} prefix-cached tokens", file=sys.stderr)


if __name__ == "__main__":
    main()
