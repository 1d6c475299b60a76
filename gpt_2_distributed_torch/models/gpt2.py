"""GPT-2 as plain parameter dictionaries plus functions on tensors.

Counterpart of ``gpt_2_distributed_tpu/models/gpt2.py`` (pre-LN GPT-2,
learned positions, fused qkv, tanh GELU, tied lm_head), eval mode only: the
serving path has no dropout. The training forward comes with the training
slice.

Two dictionaries of the same structure:

* **params** — the fp32 master weights, ``{"wte", "wpe", "blocks": [one
  dict per layer], "ln_f_scale", "ln_f_bias"}``. Weights are ``[in, out]``
  and the qkv weight is the JAX package's head-explicit ``[C, 3, H, D]``
  flattened to ``[C, 3C]`` (a row-major reshape, so the two are the same
  matrix); ``models/convert.py`` moves params to and from the JAX tree.
* **weights** — the compute copy :func:`compute_weights` makes once per
  engine or sampler call: matmul weights, biases and embeddings cast to
  the compute dtype (bf16 on the card, as the JAX package casts them per
  step), LayerNorm parameters left fp32 (the norm runs in fp32), plus
  ``head``, the tied lm_head ``wte`` rounded to the compute dtype and held
  in fp32, so logits are fp32 sums of exact bf16 x bf16 products like
  JAX's ``preferred_element_type=float32``.

Seeded init draws N(0, 0.02) from a ``torch.Generator`` on the CPU; it
cannot reproduce ``jax.random``'s bits, so parity with the JAX package is
always tested through weights carried across with ``models/convert.py``.
"""

from __future__ import annotations

import torch

from gpt_2_distributed_torch.config import GPT2Config
from gpt_2_distributed_torch.ops.activations import gelu_tanh
from gpt_2_distributed_torch.ops.layers import layer_norm

INIT_SEED = 42

BLOCK_KEYS = (
    "ln1_scale", "ln1_bias", "attn_qkv_w", "attn_qkv_b", "attn_proj_w",
    "attn_proj_b", "ln2_scale", "ln2_bias", "mlp_fc_w", "mlp_fc_b",
    "mlp_proj_w", "mlp_proj_b",
)
_FP32_KEYS = {"ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias",
              "ln_f_scale", "ln_f_bias"}


def init_params(config: GPT2Config, seed: int = INIT_SEED) -> dict:
    """Seeded fp32 init on the CPU: N(0, initializer_range) for every linear
    and embedding weight, zero biases, LayerNorm at (1, 0)."""
    c, v, p = config.n_embd, config.vocab_size, config.n_positions
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=gen) * config.initializer_range

    params = {"wte": normal(v, c), "wpe": normal(p, c), "blocks": []}
    for _ in range(config.n_layer):
        params["blocks"].append({
            "ln1_scale": torch.ones(c), "ln1_bias": torch.zeros(c),
            "attn_qkv_w": normal(c, 3 * c), "attn_qkv_b": torch.zeros(3 * c),
            "attn_proj_w": normal(c, c), "attn_proj_b": torch.zeros(c),
            "ln2_scale": torch.ones(c), "ln2_bias": torch.zeros(c),
            "mlp_fc_w": normal(c, 4 * c), "mlp_fc_b": torch.zeros(4 * c),
            "mlp_proj_w": normal(4 * c, c), "mlp_proj_b": torch.zeros(c),
        })
    params["ln_f_scale"] = torch.ones(c)
    params["ln_f_bias"] = torch.zeros(c)
    return params


def compute_weights(params: dict, dtype: torch.dtype,
                    device: torch.device) -> dict:
    """The compute copy of ``params`` on ``device`` (see module docstring)."""
    def cast(key, x):
        return x.to(device=device, dtype=torch.float32 if key in _FP32_KEYS else dtype)

    w = {key: cast(key, params[key])
         for key in ("wte", "wpe", "ln_f_scale", "ln_f_bias")}
    w["blocks"] = [{key: cast(key, bp[key]) for key in BLOCK_KEYS}
                   for bp in params["blocks"]]
    w["head"] = w["wte"].float()
    return w


def embed(w: dict, config: GPT2Config, tokens: torch.Tensor,
          positions: torch.Tensor) -> torch.Tensor:
    """wte[tokens] + wpe[positions] in the compute dtype. Ids are clamped
    into range (the JAX package's ``mode="clip"`` gathers): a stray id
    becomes a wrong embedding, never an indexing error."""
    tok = w["wte"][tokens.long().clamp(0, config.vocab_size - 1)]
    pos = w["wpe"][positions.long().clamp(0, config.n_positions - 1)]
    return tok + pos


def qkv_proj(config: GPT2Config, y: torch.Tensor, bp: dict):
    """Fused qkv projection of ``y`` [B, T, C] -> (q, k, v), each a
    [B, T, H, D] view of one [B, T, 3C] product."""
    b, t, _ = y.shape
    qkv = y @ bp["attn_qkv_w"] + bp["attn_qkv_b"]
    qkv = qkv.view(b, t, 3, config.n_head, config.head_dim)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def attn_out(o: torch.Tensor, bp: dict) -> torch.Tensor:
    """Attention out-projection of ``o`` [B, T, C]."""
    return o @ bp["attn_proj_w"] + bp["attn_proj_b"]


def mlp_sublayer(config: GPT2Config, x: torch.Tensor, bp: dict) -> torch.Tensor:
    """x + mlp(ln2(x)), eval mode."""
    y = layer_norm(x, bp["ln2_scale"], bp["ln2_bias"], config.layer_norm_eps)
    y = gelu_tanh(y @ bp["mlp_fc_w"] + bp["mlp_fc_b"])
    return x + (y @ bp["mlp_proj_w"] + bp["mlp_proj_b"])


def final_norm(w: dict, config: GPT2Config, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, w["ln_f_scale"], w["ln_f_bias"], config.layer_norm_eps)


def logits_fp32(w: dict, h: torch.Tensor) -> torch.Tensor:
    """Tied-head logits in fp32 from hidden states ``h`` [..., C]."""
    return h.float() @ w["head"].t()
