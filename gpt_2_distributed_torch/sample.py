"""Sampling CLI of the PyTorch port: generate from a checkpoint the port's
trainer saved (``gpt2-torch-sample``; the port of
``gpt_2_distributed_tpu/sample.py``, with the same flags, defaults and
exit messages). Usage::

    gpt2-torch-sample --ckpt runs/ckpt --prompt "The meaning of life" --new 64
    gpt2-torch-sample --ckpt runs/ckpt/step_0001000 --prompt_ids 464,3616 \\
        --temperature 0 --decode_path cached

``--ckpt`` accepts either one checkpoint directory (``step_NNNNNNN``) or a
save dir, in which case the latest checkpoint is used; a checkpoint of
another format (the JAX package's orbax trees) is refused. The model's
architecture comes from ``--model`` and the override flags, as in
``train.py`` (``--seq_len`` is ``n_positions``): the checkpoint stores
tensors, not architecture.

Text prompts and continuations need tiktoken's GPT-2 BPE; ``--prompt_ids``
works offline and prints token ids. ``--decode_path reforward`` (and
``auto``, as in the JAX CLI) samples without a KV cache
(``models/generate.py::generate``: the whole causal forward once a token),
``cached`` with one (``models/decode.py::generate_cached``). ``--stream``
prints each token as the serving engine produces it (paged KV decode over
blocks of 16 positions; the same tokens as ``--decode_path cached`` for
the same ``--seed``).

Runs on CUDA unless ``--device cpu`` is given; without a visible GPU it
exits with the "no CUDA device" message.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_argparser() -> argparse.ArgumentParser:
    from gpt_2_distributed_torch.config import MODEL_PRESETS

    p = argparse.ArgumentParser(prog="gpt2-torch-sample",
                                description=__doc__.split("\n")[0])
    p.add_argument("--ckpt", required=True,
                   help="checkpoint dir (step_NNNNNNN) or save dir (uses latest)")
    p.add_argument("--model", default="124M", choices=sorted(MODEL_PRESETS))
    p.add_argument("--n_layer", type=int, default=None)
    p.add_argument("--n_embd", type=int, default=None)
    p.add_argument("--n_head", type=int, default=None)
    p.add_argument("--vocab_size", type=int, default=None)
    p.add_argument(
        "--seq_len", type=int, default=None,
        help="n_positions the checkpoint was trained with, when it differs "
        "from the preset (train.py --seq_len resizes wpe)",
    )
    p.add_argument("--prompt", default=None, help="text prompt (needs tiktoken BPE)")
    p.add_argument("--prompt_ids", default=None,
                   help="comma-separated token ids (offline alternative)")
    p.add_argument("--new", type=int, default=64, help="tokens to generate")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--decode_path", default="auto", choices=["auto", "cached", "reforward"],
        help="'cached' = KV-cache prefill + decode, 'reforward' = the whole "
        "causal forward again for every token; 'auto' picks reforward, as "
        "the JAX CLI does",
    )
    p.add_argument(
        "--stream", action="store_true",
        help="print tokens as they are generated, via the serving engine's "
        "paged-KV decode; same tokens as --decode_path cached for the same "
        "--seed",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def _checkpoint_path(ckpt: str) -> str:
    """``ckpt`` itself when it is one checkpoint, else the latest one under
    it; exits when there is none."""
    from gpt_2_distributed_torch.checkpoint import latest_checkpoint

    path = os.path.abspath(ckpt)
    if not os.path.exists(os.path.join(path, "meta.json")):
        latest = latest_checkpoint(path)
        if latest is None:
            sys.exit(f"no checkpoint found under {path!r}")
        path = latest
    return path


def _prompt_ids(args, vocab_size: int):
    """``(ids, encoder or None)`` from ``--prompt`` / ``--prompt_ids``;
    exits on a missing, doubled, empty or out-of-vocab prompt."""
    if (args.prompt is None) == (args.prompt_ids is None):
        sys.exit("exactly one of --prompt / --prompt_ids is required")
    enc = None
    if args.prompt is not None:
        try:
            import tiktoken

            enc = tiktoken.get_encoding("gpt2")
        except Exception as e:  # noqa: BLE001 — network-gated BPE fetch
            sys.exit(f"--prompt needs tiktoken's GPT-2 BPE ({e}); "
                     "use --prompt_ids offline")
        ids = enc.encode_ordinary(args.prompt)
    else:
        try:
            ids = [int(t) for t in args.prompt_ids.split(",") if t.strip()]
        except ValueError:
            sys.exit(f"--prompt_ids must be comma-separated integers, got "
                     f"{args.prompt_ids!r}")
    if not ids:
        sys.exit("empty prompt")
    bad = [t for t in ids if not 0 <= t < vocab_size]
    if bad:
        sys.exit(f"prompt ids out of vocab range: {bad[:5]}")
    return ids, enc


def main(argv: list[str] | None = None) -> None:
    from gpt_2_distributed_torch.serving.serve import cli_device, model_config_from_args

    args = build_argparser().parse_args(argv)
    config = model_config_from_args(args)
    path = _checkpoint_path(args.ckpt)
    ids, enc = _prompt_ids(args, config.vocab_size)
    if args.stream and args.decode_path == "reforward":
        sys.exit("--stream decodes through the serving engine's paged KV "
                 "path; drop --decode_path reforward")
    device = cli_device(args)

    from gpt_2_distributed_torch.checkpoint import restore_params

    try:
        params, meta = restore_params(path, device, config)
    except (OSError, ValueError) as e:
        sys.exit(f"--ckpt: {e}")
    print(f"checkpoint: {path} (step {meta.step}, "
          f"{meta.total_tokens:,} tokens trained)", file=sys.stderr)

    if args.stream:
        from gpt_2_distributed_torch.config import ServeConfig
        from gpt_2_distributed_torch.serving.engine import ServingEngine

        block_size = 16
        need = -(-(len(ids) + args.new - 1) // block_size)
        serve = ServeConfig(max_batch=1, block_size=block_size, num_blocks=need + 1)
        eng = ServingEngine(params, config, serve, temperature=args.temperature,
                            top_k=args.top_k, device=device)
        if enc is not None:
            print(args.prompt, end="", flush=True)

            def on_token(_req, tok):
                print(enc.decode([tok]), end="", flush=True)
        else:
            print(",".join(str(t) for t in ids), end="", flush=True)

            def on_token(_req, tok):
                print(f",{tok}", end="", flush=True)

        try:
            eng.submit(ids, args.new, seed=args.seed, on_token=on_token)
        except ValueError as e:
            sys.exit(str(e))
        eng.run_until_idle()
        print(flush=True)
        return

    from gpt_2_distributed_torch.models.decode import generate_cached
    from gpt_2_distributed_torch.models.generate import generate

    fn = generate_cached if args.decode_path == "cached" else generate
    try:
        out = fn(params, config, [ids], seed=args.seed, max_new_tokens=args.new,
                 temperature=args.temperature, top_k=args.top_k, device=device)
    except ValueError as e:
        sys.exit(str(e))
    out_ids = out[0].tolist()
    if enc is not None:
        print(enc.decode(out_ids))
    else:
        print(",".join(str(t) for t in out_ids))


if __name__ == "__main__":
    main()
