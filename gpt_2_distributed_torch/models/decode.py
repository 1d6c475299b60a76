"""KV-cache autoregressive decoding (``gpt_2_distributed_tpu/models/decode.py``).

* :func:`prefill` runs the prompt through the block stack once and returns
  the post-ln_f hidden states plus each layer's K/V; its attention goes
  through :func:`ops.attention.select_attention_impl`, so on the card the
  prompt runs through the flash kernel.
* :func:`decode_step` processes one token row against a contiguous
  ``[L, B, H, S, D]`` cache, masking positions past ``pos`` with the
  reference's -1e4. The cache is updated IN PLACE (JAX returns a new
  cache; here the write costs no copy).
* :func:`paged_decode_step` processes one token per row against paged
  ``[L, N, H, bs, D]`` pools through ``ops/paged_attention.py`` (on the
  card the paged kernel, K3): the serving engine's decode step.
* :func:`generate_cached` is the one-shot sampler built from them — the
  serving engine's exactness oracle: a request's engine stream equals its
  ``generate_cached(batch=1)`` stream. On the CPU it decodes with
  :func:`decode_step`; on the card it lays its cache out as a block pool
  with an identity table and decodes with :func:`paged_decode_step`, so
  both sides run the same attention kernel. Every product, LayerNorm and
  the head run the inference paths of ``models/gpt2.py``, whose results
  for a row do not depend on the rows beside it.

The JAX package runs the layers as a ``lax.scan`` over stacked params;
here a Python loop walks the per-layer dictionaries. Eval mode only.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gpt_2_distributed_torch.config import GPT2Config, ServeConfig
from gpt_2_distributed_torch.models import gpt2
from gpt_2_distributed_torch.models.generate import (
    check_generation_args,
    sample_token,
)
from gpt_2_distributed_torch.ops.attention import MASK_VALUE, select_attention_impl
from gpt_2_distributed_torch.ops.paged_attention import paged_attention
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
    positions = torch.arange(p, device=prompt.device)
    x = gpt2.embed(w, config, prompt, positions[None])
    kcs = torch.zeros((config.n_layer, b, config.n_head, total, config.head_dim),
                      dtype=w["wte"].dtype, device=x.device)
    vcs = torch.zeros_like(kcs)
    x = gpt2.infer_layers(w, config, x, select_attention_impl(attn_impl, x.device),
                          (kcs, vcs))
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
        y = gpt2.norm(x, bp["ln1_scale"], bp["ln1_bias"], config.layer_norm_eps, infer=True)
        q, k, v = gpt2.qkv_proj(config, y, bp, infer=True)  # [B, 1, H, D]
        kc, vc = cache.k[layer], cache.v[layer]             # [B, H, S, D]
        kc[:, :, pos] = k[:, 0]
        vc[:, :, pos] = v[:, 0]
        scores = (q.transpose(1, 2).float() @ kc.float().transpose(-1, -2)) / math.sqrt(d)
        scores = scores.masked_fill(~mask, MASK_VALUE)      # [B, H, 1, S]
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        o = (probs @ vc).transpose(1, 2).reshape(b, 1, c)
        x = x + gpt2.attn_out(o, bp, infer=True)
        x = gpt2.mlp_sublayer(config, x, bp, infer=True)
    x = gpt2.final_norm(w, config, x)
    return gpt2.logits_fp32(w, x[:, 0])


def paged_decode_step(
    w: dict,
    config: GPT2Config,
    tokens: torch.Tensor,       # [B] int — each row's token at its position
    positions: torch.Tensor,    # [B] int64
    k_pool: torch.Tensor,       # [L, N, H, bs, D]
    v_pool: torch.Tensor,
    block_table: torch.Tensor,  # [B, M] int32
    lengths: torch.Tensor,      # [B] int32 attendable positions, 0 = idle row
    attn_impl: str = "auto",
) -> torch.Tensor:
    """Process one token per row against paged pools: each row writes its
    K/V at its position's slot (``block_table[b, pos // bs]``, ``pos %
    bs``), in place, BEFORE attending (the row attends to itself), then
    attends over its ``lengths[b]`` positions. An idle row, whose table row
    is zeros, scribbles on block 0. The block index is clamped to the
    table's last column, as the JAX draft step does: a row at a position
    past the table (a speculative draft step past the context end) writes
    into its last block and never indexes out of range. Returns logits
    [B, V] fp32."""
    b = tokens.shape[0]
    bs = k_pool.shape[3]
    col = (positions // bs).clamp(max=block_table.shape[1] - 1)
    blk = block_table.long().gather(1, col[:, None])[:, 0]
    off = positions % bs
    x = gpt2.embed(w, config, tokens[:, None], positions[:, None])   # [B, 1, C]
    for layer, bp in enumerate(w["blocks"]):
        y = gpt2.norm(x, bp["ln1_scale"], bp["ln1_bias"], config.layer_norm_eps, infer=True)
        q, k, v = gpt2.qkv_proj(config, y, bp, infer=True)           # [B, 1, H, D]
        kp, vp = k_pool[layer], v_pool[layer]                        # [N, H, bs, D]
        kp[blk, :, off] = k[:, 0]
        vp[blk, :, off] = v[:, 0]
        o = paged_attention(q[:, 0], kp, vp, block_table, lengths, impl=attn_impl)
        x = x + gpt2.attn_out(o.reshape(b, 1, config.n_embd), bp, infer=True)
        x = gpt2.mlp_sublayer(config, x, bp, infer=True)
    x = gpt2.final_norm(w, config, x)
    return gpt2.logits_fp32(w, x[:, 0])


def _as_pools(cache: KVCache, block_size: int):
    """The contiguous cache as paged pools ``[L, B * nb, H, bs, D]`` (its
    width padded to ``nb`` whole blocks) and the identity table ``[B, nb]``
    int32: sequence b owns blocks ``b * nb .. b * nb + nb - 1``."""
    layers, b, h, s, d = cache.k.shape
    nb = -(-s // block_size)

    def pool(c):
        c = torch.nn.functional.pad(c, (0, 0, 0, nb * block_size - s))
        c = c.view(layers, b, h, nb, block_size, d).transpose(2, 3)
        return c.reshape(layers, b * nb, h, block_size, d).contiguous()

    table = torch.arange(b * nb, dtype=torch.int32, device=cache.k.device).view(b, nb)
    return pool(cache.k), pool(cache.v), table


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
    block_size: int = ServeConfig.block_size,
) -> torch.Tensor:
    """KV-cached sampling; returns ``[B, P + max_new_tokens]`` ids on the
    CPU. Runs on CUDA unless ``device="cpu"`` is passed.

    One ``torch.Generator`` seeded with ``seed`` serves the batch; each
    sampled token draws from it row by row (``sample_token``), so at
    batch 1 the draws are exactly those a serving-engine request with the
    same seed makes. On CUDA the decode attention runs the paged kernel
    over pool blocks of ``block_size`` positions, the engine's
    ``ServeConfig.block_size`` whose streams this one is to equal (the
    kernel's order of summation follows the blocks)."""
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
    if dev.type == "cuda":
        k_pool, v_pool, table = _as_pools(cache, block_size)
        del cache
    for t in range(p + 1, total):
        if dev.type == "cuda":
            pos = torch.full((b,), t - 1, dtype=torch.long, device=dev)
            logits = paged_decode_step(w, config, ids[:, t - 1], pos, k_pool, v_pool, table,
                                       (pos + 1).int())
        else:
            logits = decode_step(w, config, ids[:, t - 1], t - 1, cache)
        ids[:, t] = sample_token(logits, gens, temperature, top_k)
    return ids.cpu()
