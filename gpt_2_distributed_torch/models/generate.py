"""Sampling, generation-argument checks and the uncached sampler
(``gpt_2_distributed_tpu/models/generate.py``).

:func:`sample_token` is THE sampling rule of the one-shot samplers
(:func:`generate` here, ``models/decode.py::generate_cached``) and of the
serving engine, so they cannot drift apart. Randomness comes from explicit
``torch.Generator``s, one draw of ``V`` exponentials per sampled row, so a
row's token depends only on its own logits and its own generator's state —
never on which other rows share the call.
"""

from __future__ import annotations

from typing import Sequence

import torch

from gpt_2_distributed_torch.config import GPT2Config
from gpt_2_distributed_torch.models import gpt2
from gpt_2_distributed_torch.ops.attention import select_attention_impl
from gpt_2_distributed_torch.utils.device import resolve_device


def sample_token(
    logits: torch.Tensor,                 # [B, V] fp32
    generators: Sequence[torch.Generator] | None,
    temperature: float,
    top_k: int | None,
) -> torch.Tensor:
    """Greedy (``temperature=0``: argmax, first index on ties), temperature
    or top-k sampling of ``[B, V]`` logits -> ``[B]`` int64.

    Top-k keeps every logit tied with the k-th largest. Sampling is
    Gumbel-max written with exponentials: row ``b`` takes
    ``argmax(logits / T - log(E))`` for ``E ~ Exp(1)`` drawn from
    ``generators[b]`` — exactly a draw from ``softmax(logits / T)``."""
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    out = []
    for row, gen in zip(logits, generators, strict=True):
        e = torch.empty_like(row).exponential_(generator=gen)
        z = row / temperature - e.log()
        # A top-k-dropped logit stays out even if its draw is E = 0.
        out.append(z.masked_fill(row == float("-inf"), float("-inf")).argmax())
    return torch.stack(out)


def check_generation_args(
    config: GPT2Config,
    prompt_len: int,
    max_new_tokens: int,
    top_k: int | None,
    batch: int | None = None,
) -> int:
    """Shared validation of every generation surface; returns the total
    sequence length. Same ValueErrors as the JAX package."""
    if batch is not None and batch < 1:
        raise ValueError(f"batch={batch} must be >= 1")
    if prompt_len < 1:
        raise ValueError(f"prompt_len={prompt_len} must be >= 1")
    if max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens={max_new_tokens} must be >= 1 (a request that "
            f"generates nothing is rejected at admission, not served)"
        )
    total = prompt_len + max_new_tokens
    if total > config.n_positions:
        raise ValueError(
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
            f"exceeds n_positions ({config.n_positions})"
        )
    if top_k is not None and not (1 <= top_k <= config.vocab_size):
        raise ValueError(
            f"top_k={top_k} must be in [1, vocab_size={config.vocab_size}]"
        )
    return total


@torch.no_grad()
def generate(
    params: dict,
    config: GPT2Config,
    prompt,                      # [B, P] int (tensor or nested lists)
    seed: int = 0,
    max_new_tokens: int = 32,
    temperature: float = 1.0,
    top_k: int | None = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Sampling without a KV cache; returns ``[B, P + max_new_tokens]``
    ids on the CPU. Runs on CUDA unless ``device="cpu"`` is passed.

    Each step runs the whole causal forward over the ``t`` ids so far
    (the inference paths of ``models/gpt2.py``; on the card attention is
    the flash kernel over ``[B, H, t, D]``) and takes the next token from
    row ``t - 1``, sliced before the tied head, so no ``[B, t, V]`` logits
    are made. The JAX package runs the forward over a buffer padded to the
    final length for ``lax.scan``'s static shapes; a causal row does not
    see the padding, so here the forward covers ``ids[:, :t]`` only.
    Sampling draws from one ``torch.Generator`` seeded with ``seed``, row
    by row, in :func:`models.decode.generate_cached`'s order: the two give
    the same ids wherever their logits pick the same tokens."""
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=dev)
    b, p = prompt.shape
    total = check_generation_args(config, p, max_new_tokens, top_k, batch=b)
    w = gpt2.compute_weights(params, compute_dtype, dev)
    gens = [torch.Generator(device=dev).manual_seed(seed)] * b
    attn_fn = select_attention_impl("auto", dev)
    ids = torch.zeros((b, total), dtype=torch.long, device=dev)
    ids[:, :p] = prompt
    positions = torch.arange(total, device=dev)[None]
    for t in range(p, total):
        x = gpt2.embed(w, config, ids[:, :t], positions[:, :t])
        h = gpt2.final_norm(w, config, gpt2.infer_layers(w, config, x, attn_fn))
        ids[:, t] = sample_token(gpt2.logits_fp32(w, h[:, t - 1]), gens, temperature, top_k)
    return ids.cpu()
