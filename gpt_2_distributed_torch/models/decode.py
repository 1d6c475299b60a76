"""KV-cache autoregressive decoding (``gpt_2_distributed_tpu/models/decode.py``).

* :func:`prefill` runs the prompt through the block stack once and returns
  the post-ln_f hidden states plus each layer's K/V; its attention goes
  through :func:`ops.attention.select_attention_impl`, so on the card the
  prompt runs through the flash kernel.
* :func:`decode_step` processes one token row against a contiguous
  ``[L, B, H, S, D]`` cache, masking positions past ``pos`` with the
  reference's -1e4. The cache is updated IN PLACE (JAX returns a new
  cache; here the write costs no copy).
* :func:`generate_cached` is the one-shot sampler built from the two — the
  serving engine's exactness oracle: a request's engine stream equals its
  ``generate_cached(batch=1)`` stream.

The JAX package runs the layers as a ``lax.scan`` over stacked params;
here a Python loop walks the per-layer dictionaries. Eval mode only.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gpt_2_distributed_torch.config import GPT2Config
from gpt_2_distributed_torch.models import gpt2
from gpt_2_distributed_torch.models.generate import (
    check_generation_args,
    sample_token,
)
from gpt_2_distributed_torch.ops.attention import MASK_VALUE, select_attention_impl
from gpt_2_distributed_torch.ops.layers import layer_norm
from gpt_2_distributed_torch.utils.device import resolve_device


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, H, S, D] compute dtype
    v: torch.Tensor  # [L, B, H, S, D]


def prefill(
    w: dict,
    config: GPT2Config,
    prompt: torch.Tensor,  # [B, P] int
    total: int,
    attn_impl: str = "auto",
) -> tuple[torch.Tensor, KVCache]:
    """Run the prompt through the block stack once; return the post-ln_f
    hidden states [B, P, C] and a cache of width ``total`` holding K/V for
    positions [0, P). ``w`` is the compute copy of the weights
    (:func:`gpt2.compute_weights`)."""
    b, p = prompt.shape
    h, d = config.n_head, config.head_dim
    dtype = w["wte"].dtype
    positions = torch.arange(p, device=prompt.device)
    x = gpt2.embed(w, config, prompt, positions[None])
    attn_fn = select_attention_impl(attn_impl, x.device)
    kcs = torch.zeros((config.n_layer, b, h, total, d), dtype=dtype, device=x.device)
    vcs = torch.zeros_like(kcs)
    for layer, bp in enumerate(w["blocks"]):
        y = layer_norm(x, bp["ln1_scale"], bp["ln1_bias"], config.layer_norm_eps)
        q, k, v = gpt2.qkv_proj(config, y, bp)              # [B, P, H, D]
        o = attn_fn(q, k, v).reshape(b, p, config.n_embd)
        x = x + gpt2.attn_out(o, bp)
        x = gpt2.mlp_sublayer(config, x, bp)
        kcs[layer, :, :, :p] = k.transpose(1, 2)
        vcs[layer, :, :, :p] = v.transpose(1, 2)
    return gpt2.final_norm(w, config, x), KVCache(k=kcs, v=vcs)


def decode_step(
    w: dict,
    config: GPT2Config,
    token: torch.Tensor,  # [B] int — token at position `pos`
    pos: int,
    cache: KVCache,
) -> torch.Tensor:
    """Process one token per row against the cache, writing its K/V at
    ``pos`` in place. Returns logits [B, V] fp32. Attention covers cache
    positions ``<= pos`` only."""
    b = token.shape[0]
    c, d = config.n_embd, config.head_dim
    total = cache.k.shape[3]
    x = gpt2.embed(w, config, token[:, None],
                   torch.full((1, 1), pos, device=token.device))  # [B, 1, C]
    mask = torch.arange(total, device=x.device) <= pos
    for layer, bp in enumerate(w["blocks"]):
        y = layer_norm(x, bp["ln1_scale"], bp["ln1_bias"], config.layer_norm_eps)
        q, k, v = gpt2.qkv_proj(config, y, bp)              # [B, 1, H, D]
        kc, vc = cache.k[layer], cache.v[layer]             # [B, H, S, D]
        kc[:, :, pos] = k[:, 0]
        vc[:, :, pos] = v[:, 0]
        scores = (q.transpose(1, 2).float() @ kc.float().transpose(-1, -2)) / math.sqrt(d)
        scores = scores.masked_fill(~mask, MASK_VALUE)      # [B, H, 1, S]
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        o = (probs @ vc).transpose(1, 2).reshape(b, 1, c)
        x = x + gpt2.attn_out(o, bp)
        x = gpt2.mlp_sublayer(config, x, bp)
    x = gpt2.final_norm(w, config, x)
    return gpt2.logits_fp32(w, x[:, 0])


@torch.no_grad()
def generate_cached(
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
    """KV-cached sampling; returns ``[B, P + max_new_tokens]`` ids on the
    CPU. Runs on CUDA unless ``device="cpu"`` is passed.

    One ``torch.Generator`` seeded with ``seed`` serves the batch; each
    sampled token draws from it row by row (``sample_token``), so at
    batch 1 the draws are exactly those a serving-engine request with the
    same seed makes."""
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=dev)
    b, p = prompt.shape
    total = check_generation_args(config, p, max_new_tokens, top_k, batch=b)
    w = gpt2.compute_weights(params, compute_dtype, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    gens = [gen] * b

    h, cache = prefill(w, config, prompt, total)
    ids = torch.zeros((b, total), dtype=torch.long, device=dev)
    ids[:, :p] = prompt
    ids[:, p] = sample_token(gpt2.logits_fp32(w, h[:, -1]), gens, temperature, top_k)
    for t in range(p + 1, total):
        logits = decode_step(w, config, ids[:, t - 1], t - 1, cache)
        ids[:, t] = sample_token(logits, gens, temperature, top_k)
    return ids.cpu()
