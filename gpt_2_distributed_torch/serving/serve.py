"""Serving CLI of the PyTorch port: run a batch of requests through the
continuous-batching engine, streaming results as JSON lines.

Requests come from a JSONL file or stdin, one object per line::

    {"prompt_ids": [464, 3616], "new": 64, "seed": 7}

Per-line fields default to ``--new`` / ``--seed``; an optional
``timeout_s`` sets that request's deadline. Output is JSONL on stdout:
with ``--stream`` a ``{"id", "token"}`` line per token as it is produced,
and always a final record per request with the JAX CLI's keys
(``id``, ``generated``, ``text``, ``finish_reason``, ``ttft_ms``,
``queue_wait_ms``, ``preempted``, ``prefix_cached_tokens``). All requests
are submitted up front and served up to ``--max_batch`` at a time.

Weights come from ``--params_npz`` (a JAX-layout tree saved with
``models/convert.py::save_npz``) or ``--init_random`` (seeded init). The
engine runs on CUDA; ``--device cpu`` runs it on the CPU, and without a
visible GPU nothing else runs.

Usage::

    python -m gpt_2_distributed_torch.serving.serve --init_random \\
        --requests reqs.jsonl --stream
"""

from __future__ import annotations

import argparse
import json
import sys
import time


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
    return p


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
                       eos_id=args.eos)


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
    if (args.params_npz is None) == (not args.init_random):
        p.error("exactly one of --params_npz / --init_random is required")

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
          f"steps on {device}", file=sys.stderr)


if __name__ == "__main__":
    main()
