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

Weights come from ``--params_npz`` (a JAX-layout tree saved with
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

The parser takes every flag of the JAX CLI, under the same names, types
and defaults. Serving meshes, speculation, checkpoints, metrics and
tracing sinks, replica placement and fault injection come with later
slices of the port: any other value than the default of those flags is
refused.

Usage::

    python -m gpt_2_distributed_torch.serving.serve --init_random \\
        --requests reqs.jsonl --stream
"""

from __future__ import annotations

import argparse
import json
import sys
import time

# Flags of the JAX CLI whose planes come with later slices of the port,
# with the value that leaves them off; any other value is refused.
_UNPORTED = {
    "ckpt": None, "serve_mesh": "",
    "draft_preset": None, "spec_k": None, "draft_ckpt": None,
    "tb_dir": None, "metrics_every": 20, "trace_dir": None,
    "trace_max_file_bytes": 64 * 1024 * 1024, "xla_profile_at": None,
    "placement": "inprocess", "worker_max_respawns": 3,
    "worker_respawn_backoff_s": 2.0, "worker_rpc_timeout_s": 300.0,
    "worker_heartbeat_s": 1.0, "worker_connect_timeout_s": 120.0,
    "worker_heartbeat_timeout_s": None, "worker_auth_token_file": None,
    "worker_pool": None, "watchdog_timeout_s": None,
    "inject_replica_fail_at": None, "inject_replica_hang_at": None,
    "inject_step_exception": None,
}
PLACEMENTS = ("inprocess", "subprocess", "remote")


def build_argparser() -> argparse.ArgumentParser:
    from gpt_2_distributed_torch.config import ATTN_IMPLS, MODEL_PRESETS

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--params_npz", default=None,
                   help="weights: a JAX-layout .npz (models/convert.py)")
    p.add_argument("--init_random", action="store_true",
                   help="serve seeded-init weights instead of --params_npz")
    p.add_argument("--model", default="124M", choices=sorted(MODEL_PRESETS))
    p.add_argument("--n_layer", type=int, default=None)
    p.add_argument("--n_embd", type=int, default=None)
    p.add_argument("--n_head", type=int, default=None)
    p.add_argument("--vocab_size", type=int, default=None)
    p.add_argument("--seq_len", type=int, default=None)
    p.add_argument("--requests", required=True,
                   help="JSONL request file, or '-' for stdin")
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
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--stream", action="store_true",
                   help="emit a JSON line per token as it is generated")
    p.add_argument("--prefill_chunk", type=int, default=0,
                   help="prefill chunk width; 0 = whole-prompt prefill")
    p.add_argument("--prefill_batch", type=int, default=1,
                   help="chunked mode: in-progress prefills advanced per step")
    p.add_argument("--prefix_cache", action="store_true",
                   help="reuse KV blocks across shared prompt prefixes")
    p.add_argument("--admission", default="reserve",
                   choices=["reserve", "watermark"],
                   help="block grant policy: worst-case reservation, or "
                   "lazy growth with preemption under pool pressure")
    p.add_argument("--watermark_blocks", type=int, default=1,
                   help="free-block floor for --admission watermark")
    p.add_argument("--request_timeout_s", type=float, default=None,
                   help="per-request deadline from submission (queue wait "
                        "included) for lines without 'timeout_s'; overdue "
                        "requests are evicted with finish reason 'timeout' "
                        "and their KV blocks freed")
    _add_unported_flags(p)
    return p


def _add_unported_flags(p: argparse.ArgumentParser) -> None:
    """The JAX CLI's flags of later slices (``_UNPORTED``), with its names,
    types and defaults."""
    p.add_argument("--ckpt", default=None,
                   help="checkpoint dir (later slice; use --params_npz)")
    p.add_argument("--serve_mesh", default="",
                   help="serving mesh spec 'data:N[,tp:M]'")
    p.add_argument("--draft_preset", default=None,
                   help="speculative decoding: draft-model preset")
    p.add_argument("--spec_k", type=int, default=None,
                   help="draft tokens per verify pass")
    p.add_argument("--draft_ckpt", default=None, help="draft-model checkpoint dir")
    p.add_argument("--tb_dir", default=None,
                   help="TensorBoard dir for serving-load metrics")
    p.add_argument("--metrics_every", type=int, default=20,
                   help="engine steps between --tb_dir metric flushes")
    p.add_argument("--trace_dir", default=None, help="span/event trace JSONL dir")
    p.add_argument("--trace_max_file_bytes", type=int, default=64 * 1024 * 1024,
                   help="rotate trace files past this size")
    p.add_argument("--xla_profile_at", default=None, metavar="STEP[:NSTEPS]",
                   help="profiler capture window")
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
    p.add_argument("--watchdog_timeout_s", type=float, default=None,
                   help="fail a replica whose single step exceeds this")
    p.add_argument("--inject_replica_fail_at", default=None, metavar="STEP[:REPLICA]")
    p.add_argument("--inject_replica_hang_at", default=None, metavar="STEP[:REPLICA]")
    p.add_argument("--inject_step_exception", type=int, default=None, metavar="STEP")


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
    return ServeConfig(max_batch=args.max_batch, block_size=args.block_size,
                       num_blocks=num_blocks, attn_impl=args.attn_impl,
                       eos_id=args.eos, prefill_chunk=args.prefill_chunk,
                       prefix_cache=args.prefix_cache,
                       prefill_batch=args.prefill_batch,
                       admission=args.admission,
                       watermark_blocks=args.watermark_blocks)


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


def main(argv: list[str] | None = None) -> None:
    p = build_argparser()
    args = p.parse_args(argv)
    _refuse_unported(p, args)
    if (args.params_npz is None) == (not args.init_random):
        p.error("exactly one of --params_npz / --init_random is required")
    if args.request_timeout_s is not None and args.request_timeout_s < 0:
        p.error(f"--request_timeout_s={args.request_timeout_s} must be >= 0")

    from gpt_2_distributed_torch.models import gpt2
    from gpt_2_distributed_torch.models.convert import load_npz
    from gpt_2_distributed_torch.serving.engine import ServingEngine
    from gpt_2_distributed_torch.utils.device import resolve_device

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        sys.exit(f"--device {args.device}: {e}")
    config = model_config_from_args(args)
    specs = read_requests(args.requests, args)
    params = (gpt2.init_params(config) if args.init_random
              else load_npz(args.params_npz))
    try:
        serve = build_serve_config(args, config)
    except ValueError as e:
        p.error(str(e))
    engine = ServingEngine(params, config, serve, temperature=args.temperature,
                           top_k=args.top_k, device=device)

    def on_token(req, tok):
        if args.stream:
            print(json.dumps({"id": req.id, "token": tok}), flush=True)

    t0 = time.monotonic()
    handles = []
    for ids, new, seed, timeout_s in specs:
        if timeout_s is None:
            timeout_s = args.request_timeout_s
        try:
            handles.append(engine.submit(ids, new, seed=seed, on_token=on_token,
                                         timeout_s=timeout_s))
        except ValueError as e:
            sys.exit(f"request {len(handles)}: {e}")
    engine.run_until_idle()
    wall = time.monotonic() - t0

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
          f"({toks / wall:.0f} tok/s), {engine.stats['decode_steps']} decode "
          f"steps on {device}, {engine.stats['preemptions']} preemptions, "
          f"{engine.stats['prefix_hit_tokens']} prefix-cached tokens", file=sys.stderr)


if __name__ == "__main__":
    main()
