"""Synthetic token shards for tests and smoke runs
(``gpt_2_distributed_tpu/data/synthetic.py``): the same files, byte for
byte, from the same arguments.

Flat little-endian uint16 token streams named
``{dataset}_{split}_{index:06d}.bin``, shard 0 the "val" split.
"""

from __future__ import annotations

import json
import os

import numpy as np

GPT2_EOT = 50256  # tiktoken gpt2 <|endoftext|>


def write_token_shard_uint16(path: str, tokens: np.ndarray) -> None:
    """Write a flat little-endian uint16 token stream."""
    tokens = np.asarray(tokens)
    if tokens.min(initial=0) < 0 or tokens.max(initial=0) > np.iinfo(np.uint16).max:
        raise ValueError("token ids out of uint16 range")
    tokens.astype("<u2").tofile(path)


def write_synthetic_shards(
    data_dir: str,
    num_shards: int = 3,
    tokens_per_shard: int = 32_768,
    vocab_size: int = 50257,
    dataset_name: str = "synthetic",
    seed: int = 0,
) -> list[str]:
    """Write ``num_shards`` shards (shard 0 "val", the rest "train") plus a
    ``metadata.json`` index; returns the shard paths.

    The tokens are mostly ascending runs (next = cur + 1 mod vocab) of 64
    from random starts, with an end-of-text id every ``tokens_per_shard //
    17`` tokens, so a model can push the loss well below ln(vocab)."""
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(num_shards):
        split = "val" if i == 0 else "train"
        starts = rng.integers(0, vocab_size, size=tokens_per_shard // 64 + 1)
        ramp = np.arange(tokens_per_shard)
        tokens = (
            (starts.repeat(64)[:tokens_per_shard] + ramp % 64) % vocab_size
        ).astype(np.uint16)
        # The end-of-text id stays inside a reduced test vocabulary.
        eot = min(GPT2_EOT, vocab_size - 1)
        tokens[:: max(1, tokens_per_shard // 17)] = eot
        path = os.path.join(data_dir, f"{dataset_name}_{split}_{i:06d}.bin")
        write_token_shard_uint16(path, tokens)
        paths.append(path)
    with open(os.path.join(data_dir, "metadata.json"), "w") as f:
        json.dump(
            {
                "dataset": dataset_name,
                "num_shards": num_shards,
                "tokens_per_shard": tokens_per_shard,
                "dtype": "uint16",
                "shards": [os.path.basename(p) for p in paths],
            },
            f,
            indent=2,
        )
    return paths
