"""GPT-2 as plain parameter dictionaries plus functions on tensors.

Counterpart of ``gpt_2_distributed_tpu/models/gpt2.py`` (pre-LN GPT-2,
learned positions, fused qkv, tanh GELU, tied lm_head). The serving path
(``models/decode.py``, ``serving/engine.py``) runs the block helpers in eval
mode on a precast weight copy; the training forward (:func:`forward`,
:func:`hidden_states`) casts the fp32 params per call, has every dropout
site of the JAX model, and ends in the blocked cross-entropy.

The inference helpers take ``infer=True``: their unfused products go
through K7's forward kernel with the unfused roundings
(``ops/fused_matmul.py::linear``), their LayerNorms through K4 at rate 0
(:func:`norm`) and the head through K7 (:func:`logits_fp32`), so on the
card a row's logits do not depend on how many rows share a call, which is
what keeps the serving engine's streams equal to ``generate_cached(batch=
1)``'s. Training keeps torch's matmuls and LayerNorm for what the JAX
package leaves to XLA. With ``fused_matmul`` set, training and inference
both dispatch the fused legs to K7 as the JAX model does.

Two dictionaries of the same structure:

* **params** — the fp32 master weights, ``{"wte", "wpe", "blocks": [one
  dict per layer], "ln_f_scale", "ln_f_bias"}``. Weights are ``[in, out]``
  and the qkv weight is the JAX package's head-explicit ``[C, 3, H, D]``
  flattened to ``[C, 3C]`` (a row-major reshape, so the two are the same
  matrix); ``models/convert.py`` moves params to and from the JAX tree.
* **weights** — the compute copy :func:`compute_weights` makes once per
  engine or sampler call: matmul weights, biases and embeddings cast to
  the compute dtype (bf16 on the card, as the JAX package casts them per
  step), LayerNorm parameters left fp32 (the norm runs in fp32). The tied
  head reads ``wte`` in the compute dtype, so logits are fp32 sums of
  exact bf16 x bf16 products like JAX's ``preferred_element_type=float32``.

Seeded init draws N(0, 0.02) from a ``torch.Generator`` on the CPU; it
cannot reproduce ``jax.random``'s bits, so parity with the JAX package is
always tested through weights carried across with ``models/convert.py``.
"""

from __future__ import annotations

import torch

from gpt_2_distributed_torch.config import GPT2Config
from gpt_2_distributed_torch.ops import fused_matmul as fm
from gpt_2_distributed_torch.ops.activations import gelu_tanh
from gpt_2_distributed_torch.ops.attention import select_attention_impl
from gpt_2_distributed_torch.ops.fused_layer import (
    as_rows,
    fused_bias_gelu_dropout,
    fused_ln_residual_dropout,
    fused_residual_dropout,
    ln_residual_dropout_fwd,
)
from gpt_2_distributed_torch.ops.layers import (
    SITE_ATTN,
    SITE_ATTN_RESID,
    SITE_EMBD,
    SITE_MLP_ACT,
    SITE_MLP_RESID,
    attention_seed,
    dropout,
    layer_norm,
    site_key,
)
from gpt_2_distributed_torch.ops.losses import IGNORE_INDEX, blocked_cross_entropy
from gpt_2_distributed_torch.ops.spmd import batch_axes, shard_offset, shard_seed
from gpt_2_distributed_torch.parallel.mesh import active_mesh

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
    return w


def embed(w: dict, config: GPT2Config, tokens: torch.Tensor,
          positions: torch.Tensor) -> torch.Tensor:
    """wte[tokens] + wpe[positions] in the compute dtype. Ids are clamped
    into range (the JAX package's ``mode="clip"`` gathers): a stray id
    becomes a wrong embedding, never an indexing error."""
    tok = w["wte"][tokens.long().clamp(0, config.vocab_size - 1)]
    pos = w["wpe"][positions.long().clamp(0, config.n_positions - 1)]
    return tok + pos


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
           infer: bool) -> torch.Tensor:
    """``x @ w + b`` of the unfused model: on the inference paths K7's
    forward with the unfused roundings, in training torch's matmul."""
    if infer:
        return fm.linear(x, w, b)
    return x @ w if b is None else x @ w + b


def norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
         infer: bool) -> torch.Tensor:
    """LayerNorm over the last axis. On the inference paths on the card it
    is K4 at rate 0 with no branch (``o=None``: no o read, no r written):
    one warp a row, so a row's bits do not depend on how many rows share
    the call, as torch's reductions' split does."""
    if not (infer and x.is_cuda):
        return layer_norm(x, scale, bias, eps)
    return ln_residual_dropout_fwd(as_rows(x), None, scale, bias, eps)[1].view(x.shape)


def qkv_proj(config: GPT2Config, y: torch.Tensor, bp: dict, infer: bool = False):
    """Fused qkv projection of ``y`` [B, T, C] -> (q, k, v), each a
    [B, T, H, D] view of one [B, T, 3C] product; with ``fused_matmul="all"``
    through K7's bias kernel."""
    b, t, _ = y.shape
    if config.fused_matmul == "all":
        qkv = fm.matmul_bias(y, bp["attn_qkv_w"], bp["attn_qkv_b"])
    else:
        qkv = linear(y, bp["attn_qkv_w"], bp["attn_qkv_b"], infer)
    qkv = qkv.view(b, t, 3, config.n_head, config.head_dim)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def attn_out(o: torch.Tensor, bp: dict, infer: bool = False) -> torch.Tensor:
    """Attention out-projection of ``o`` [B, T, C], unfused (the decode
    paths keep it so under any ``fused_matmul``, as the JAX package does)."""
    return linear(o, bp["attn_proj_w"], bp["attn_proj_b"], infer)


def _gelu_fused(config: GPT2Config) -> bool:
    return config.fused_layers in ("gelu", "all")


def _ln_fused(config: GPT2Config) -> bool:
    return config.fused_layers in ("ln", "all")


def _mm_fc_fused(config: GPT2Config) -> bool:
    return config.fused_matmul in ("mlp", "all")


def _mm_proj_fused(config: GPT2Config) -> bool:
    return config.fused_matmul in ("proj", "all")


def _site_seed(key: tuple[int, int] | None, rate: float = 0.0,
               batch: int = 1) -> int | None:
    """A kernel's int seed from its site's key words. Under a data/fsdp
    mesh the kernels (flash attention, K4-K7) hash this process's LOCAL
    coordinates, so, as the JAX package's shard_map wrappers do, the seed
    is the per-shard seed of ``ops/spmd.py::shard_seed`` over the batch
    axes of a ``batch``-row block (unchanged at ``rate`` 0, with no mesh,
    and under sp > 1, where the ring hashes global coordinates)."""
    if key is None:
        return None
    seed = attention_seed(key)
    mesh = active_mesh()
    if mesh is None or mesh.sp > 1:
        return seed
    return shard_seed(seed, mesh, batch_axes(mesh, batch), rate)


def _mlp_core(config: GPT2Config, y: torch.Tensor, bp: dict, rate: float,
              key: tuple[int, int] | None, infer: bool = False,
              origin: tuple[int, ...] | None = None) -> torch.Tensor:
    """fc matmul -> bias -> tanh-GELU -> activation dropout ([B, T, 4C]).

    With ``fused_matmul`` in ("mlp", "all") the matmul and its epilogue are
    one kernel (K7, ``ops/fused_matmul.py``); else with ``fused_layers`` in
    ("gelu", "all") the bias add, GELU and dropout run as one epilogue over
    the matmul output (K6, ``ops/fused_layer.py``); both in eval mode too
    (at rate 0). Otherwise the unfused composition."""
    seed = _site_seed(key, rate, y.shape[0])
    if _mm_fc_fused(config):
        return fm.matmul_bias_gelu_dropout(y, bp["mlp_fc_w"], bp["mlp_fc_b"], rate=rate,
                                           seed=seed, deterministic=rate == 0.0)
    if _gelu_fused(config):
        return fused_bias_gelu_dropout(linear(y, bp["mlp_fc_w"], None, infer),
                                       bp["mlp_fc_b"], rate=rate, seed=seed,
                                       deterministic=rate == 0.0)
    y = gelu_tanh(linear(y, bp["mlp_fc_w"], bp["mlp_fc_b"], infer))
    return dropout(y, rate, key, rate == 0.0, origin)


def mlp_sublayer(config: GPT2Config, x: torch.Tensor, bp: dict,
                 rate: float = 0.0, keys=(None, None), infer: bool = False,
                 origin: tuple[int, ...] | None = None) -> torch.Tensor:
    """x + dropout(proj(dropout(gelu(fc(ln2(x)))))): dropout after the
    activation and after the projection, with ``keys`` the two sites' key
    words and ``origin`` x's place in the global tensor (a sequence-
    parallel rank's block); eval mode (no dropout) when ``rate`` is 0.
    With ``fused_matmul`` in ("proj", "all") the projection, its dropout
    and the residual add are K7's resid kernel."""
    y = norm(x, bp["ln2_scale"], bp["ln2_bias"], config.layer_norm_eps, infer)
    y = _mlp_core(config, y, bp, rate, keys[0], infer, origin)
    if _mm_proj_fused(config):
        return fm.matmul_bias_residual_dropout(
            y, bp["mlp_proj_w"], bp["mlp_proj_b"], x, rate=rate,
            seed=_site_seed(keys[1], rate, x.shape[0]),
            deterministic=rate == 0.0, salt=fm.SALT_MM_MLP_PROJ)
    y = linear(y, bp["mlp_proj_w"], bp["mlp_proj_b"], infer)
    return x + dropout(y, rate, keys[1], rate == 0.0, origin)


def final_norm(w: dict, config: GPT2Config, x: torch.Tensor) -> torch.Tensor:
    """The inference paths' final LayerNorm."""
    return norm(x, w["ln_f_scale"], w["ln_f_bias"], config.layer_norm_eps, infer=True)


def logits_fp32(w: dict, h: torch.Tensor) -> torch.Tensor:
    """Tied-head logits in fp32 from hidden states ``h`` [..., C] (K7's
    forward on the card)."""
    return fm.head_logits(h, w["wte"])


# --- training forward -------------------------------------------------------


def _cast_block(bp: dict, dtype: torch.dtype) -> dict:
    """One layer's fp32 params with the matmul weights and biases cast to
    the compute dtype (differentiably: the grads land on the fp32 params);
    LayerNorm parameters stay fp32."""
    return {k: v if k in _FP32_KEYS else v.to(dtype) for k, v in bp.items()}


def _attention(config: GPT2Config, x: torch.Tensor, bp: dict, rate: float,
               key: tuple[int, int] | None) -> torch.Tensor:
    """attn(ln1(x)) [B, T, C], the attention sublayer before its
    out-projection; ``rate`` is the attention-probability dropout."""
    b, t, c = x.shape
    y = layer_norm(x, bp["ln1_scale"], bp["ln1_bias"], config.layer_norm_eps)
    q, k, v = qkv_proj(config, y, bp)
    attn_fn = select_attention_impl(config.attention_impl, x.device)
    seed = _site_seed(key, rate, b) if rate > 0.0 else None
    return attn_fn(q, k, v, dropout_rate=rate, seed=seed).reshape(b, t, c)


def _mlp_half_fused(config: GPT2Config, x: torch.Tensor, y2: torch.Tensor, bp: dict,
                    rate: float, keys) -> torch.Tensor:
    """The MLP sublayer on the pre-normalized ``y2``, closing the block
    with the fused residual+dropout kernel (K5). ``keys`` are the
    activation and out-projection sites'."""
    y = _mlp_core(config, y2, bp, rate, keys[0])
    y = y @ bp["mlp_proj_w"] + bp["mlp_proj_b"]
    return fused_residual_dropout(x, y, rate=rate, seed=_site_seed(keys[1], rate, x.shape[0]),
                                  deterministic=rate == 0.0)


def _block(config: GPT2Config, x: torch.Tensor, bp: dict, layer: int,
           rng: tuple[int, int, int] | None, deterministic: bool,
           origin: tuple[int, int, int]) -> torch.Tensor:
    """One pre-LN block, x + attn(ln1(x)); x + mlp(ln2(x)), with the JAX
    model's dropout sites: attention probabilities (inside the attention),
    attention out-projection, MLP activation, MLP out-projection. With
    ``fused_matmul`` in ("proj", "all") the attention out-projection, its
    dropout and the residual add are K7's resid kernel (salt 5), and the
    LayerNorm after it runs unfused whatever ``fused_layers`` says; else
    with ``fused_layers`` in ("ln", "all") the attention half ends in the
    fused LN+residual+dropout junction (K4), which hands ``(r, ln2(r))`` to
    the MLP half. ``origin`` is x's place in the global ``[B, T, C]`` (the
    unfused dropout sites hash global coordinates)."""
    train = not deterministic

    def key(site):
        return site_key(*rng, layer, site) if train else None

    resid_rate = config.resid_dropout if train else 0.0
    mlp_keys = (key(SITE_MLP_ACT), key(SITE_MLP_RESID))
    o = _attention(config, x, bp, config.attn_dropout if train else 0.0, key(SITE_ATTN))
    if _mm_proj_fused(config):
        x = fm.matmul_bias_residual_dropout(
            o, bp["attn_proj_w"], bp["attn_proj_b"], x, rate=resid_rate,
            seed=_site_seed(key(SITE_ATTN_RESID), resid_rate, x.shape[0]),
            deterministic=not train,
            salt=fm.SALT_MM_ATTN_PROJ)
    elif _ln_fused(config):
        x, y2 = fused_ln_residual_dropout(
            x, attn_out(o, bp), bp["ln2_scale"], bp["ln2_bias"], eps=config.layer_norm_eps,
            rate=resid_rate, seed=_site_seed(key(SITE_ATTN_RESID), resid_rate, x.shape[0]),
            deterministic=not train)
        return _mlp_half_fused(config, x, y2, bp, resid_rate, mlp_keys)
    else:
        x = x + dropout(attn_out(o, bp), resid_rate, key(SITE_ATTN_RESID), resid_rate == 0.0,
                        origin)
    return mlp_sublayer(config, x, bp, resid_rate, mlp_keys, origin=origin)


def hidden_states(
    params: dict,
    config: GPT2Config,
    idx: torch.Tensor,  # [B, T] int token ids
    *,
    rng: tuple[int, int, int] | None = None,
    deterministic: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Backbone forward from the fp32 ``params``: embeddings -> block stack
    -> final LayerNorm; returns ``[B, T, C]`` in ``compute_dtype``.

    ``rng`` is ``(run seed, optimizer step, micro-batch)``: every dropout
    site's key words come from it and the site's (layer, site) through
    :func:`ops.layers.site_key`, statelessly, so the same step redraws the
    same masks. ``deterministic=False`` (training) needs it.

    Under an active mesh (``parallel/mesh.py``) ``idx`` is this process's
    block of the global batch: its rows from ``shard_offset`` over the
    batch axes, and under sp > 1 its ``T/sp`` block of the sequence, whose
    first position is ``sp_index * T/sp``. The positions and every unfused
    dropout site's bits are those of that slice of the global ``[B, T,
    C]`` (the JAX package hashes the global view), the kernel sites take
    the per-shard seed (:func:`_site_seed`), and under sp > 1 attention
    runs the ring over the mesh."""
    b, t = idx.shape
    mesh = active_mesh()
    seq0, t_global, row0 = 0, t, 0
    if mesh is not None:
        seq0, t_global = mesh.sp_index * t, mesh.sp * t
        row0 = shard_offset(mesh, batch_axes(mesh, b), b)
    if t_global > config.n_positions:
        raise ValueError(
            f"sequence length {t_global} exceeds n_positions {config.n_positions}"
        )
    if (mesh is not None and mesh.sp > 1
            and (config.fused_layers, config.fused_matmul) != ("off", "off")):
        raise ValueError(
            f"fused_layers={config.fused_layers!r} / fused_matmul={config.fused_matmul!r} "
            f"under a mesh with sp={mesh.sp} is not ported to PyTorch yet (the JAX "
            f"package falls back to its unfused ops there): it comes in a later slice "
            f"of the port; use 'off'"
        )
    if not deterministic and rng is None:
        raise ValueError("training-mode forward (deterministic=False) needs rng")
    origin = (row0, seq0, 0)
    w = {"wte": params["wte"].to(compute_dtype), "wpe": params["wpe"].to(compute_dtype)}
    x = embed(w, config, idx, seq0 + torch.arange(t, device=idx.device)[None])
    if not deterministic:
        x = dropout(x, config.embd_dropout, site_key(*rng, 0, SITE_EMBD), False, origin)
    for layer, bp in enumerate(params["blocks"]):
        x = _block(config, x, _cast_block(bp, compute_dtype), layer, rng,
                   deterministic, origin)
    return layer_norm(x, params["ln_f_scale"], params["ln_f_bias"],
                      config.layer_norm_eps)


def forward(
    params: dict,
    config: GPT2Config,
    idx: torch.Tensor,                   # [B, T] int token ids
    labels: torch.Tensor | None = None,  # [B, T] next-token ids, -100 = ignore
    *,
    rng: tuple[int, int, int] | None = None,
    deterministic: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
    return_logits: bool = False,
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """Forward pass from the fp32 ``params``; returns ``(logits [B, T, V]
    fp32 | None, loss fp32 | None)``, as the JAX package's ``forward``.

    With labels and no ``return_logits`` (the training path) the loss is the
    blocked cross-entropy (``loss_impl="blocked"``) and no ``[B, T, V]``
    logits are made; ``loss_impl="dense"`` takes the full fp32 logits."""
    x = hidden_states(params, config, idx, rng=rng, deterministic=deterministic,
                      compute_dtype=compute_dtype)
    wte = params["wte"].to(compute_dtype)
    if labels is not None and not return_logits and config.loss_impl == "blocked":
        loss = blocked_cross_entropy(x.reshape(-1, config.n_embd), wte,
                                     labels.reshape(-1), config.loss_block_rows)
        return None, loss
    # fp32 sums of the compute-dtype products (exact for bf16 operands).
    logits = x.float() @ wte.float().t()
    loss = cross_entropy(logits, labels) if labels is not None else None
    if labels is not None and not return_logits:
        return None, loss
    return logits, loss


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Flat token-mean cross-entropy with ignore_index -100, in fp32."""
    logits = logits.float()
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, 0).clamp(0, logits.shape[-1] - 1).long()
    ll = torch.log_softmax(logits, dim=-1).gather(-1, safe[..., None])[..., 0]
    ll = torch.where(valid, ll, 0.0)
    return -(ll.sum() / valid.sum().clamp(min=1))
