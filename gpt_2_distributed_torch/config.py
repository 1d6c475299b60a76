"""Model and serving configuration for the PyTorch/CUDA port.

The port keeps its own copy of the JAX package's configuration surface
(``gpt_2_distributed_tpu/config.py``) rather than importing it: the field
names, defaults, validation messages and presets are the same, so a reader
can move between the two packages, but nothing here depends on JAX.

Only what the serving path of this slice reads is carried over. The
training fields (dropout rates, ``remat``, ``scan_layers``, the
fused-kernel switches, the blocked-loss knobs) come with the training
slice of the port. The ``ServeConfig`` options whose engine code is
not ported yet are still fields — so a caller moving from the JAX engine
sees them — but a non-default value is refused at construction instead of
being ignored.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class GPT2Config:
    """Architecture hyperparameters for a GPT-2 style decoder-only LM.

    Defaults are GPT-2 124M (vocab 50257, 1024 positions, width 768, 12
    layers, 12 heads, LN eps 1e-5, init std 0.02). The dropout rates join
    with the training slice: serving runs in eval mode."""

    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02

    def __post_init__(self) -> None:
        if self.n_embd % self.n_head != 0:
            raise ValueError(
                f"n_embd={self.n_embd} must be divisible by n_head={self.n_head}"
            )

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    def replace(self, **kwargs) -> "GPT2Config":
        return dataclasses.replace(self, **kwargs)


ATTN_IMPLS = ("auto", "kernel", "plain")


def _later_slice(field: str, value) -> ValueError:
    return ValueError(
        f"ServeConfig.{field}={value!r} is not ported to the PyTorch engine "
        f"yet: it comes in a later slice of the port"
    )


@dataclass(frozen=True)
class ServeConfig:
    """Serving-engine shape and scheduler policy.

    * ``max_batch`` — in-flight decode slots.
    * ``block_size`` — KV positions per pool block.
    * ``num_blocks`` — pool capacity. Block 0 is the reserved null block:
      idle slots and table tails park there. Usable KV capacity is
      ``(num_blocks - 1) * block_size`` positions.
    * ``attn_impl`` — attention dispatch for prefill and decode: "auto"
      (the hand-written CUDA kernels for CUDA tensors, the plain PyTorch
      versions for CPU tensors), "kernel" (CUDA kernels only; refuses CPU
      tensors) or "plain" (the plain versions on any device).
    * ``eos_id`` — generation stops when this token is sampled; None = run
      every request to its max_new_tokens.

    ``prefill_chunk``, ``prefix_cache``, ``admission``, ``mesh`` and
    ``spec`` mirror the JAX engine's options; only their defaults (whole-
    prompt prefill, no prefix cache, worst-case block reservation, one
    device, no speculation) are ported so far.
    """

    max_batch: int = 8
    block_size: int = 16
    num_blocks: int = 256
    attn_impl: str = "auto"
    eos_id: int | None = None
    prefill_chunk: int = 0
    prefix_cache: bool = False
    admission: str = "reserve"
    mesh: str = ""
    spec: str = ""

    def __post_init__(self) -> None:
        if self.max_batch < 1:
            raise ValueError(f"max_batch={self.max_batch} must be >= 1")
        if self.block_size < 1:
            raise ValueError(f"block_size={self.block_size} must be >= 1")
        if self.num_blocks < 2:
            raise ValueError(
                f"num_blocks={self.num_blocks} must be >= 2 (block 0 is the "
                f"reserved null block)"
            )
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(
                f"attn_impl={self.attn_impl!r}: expected one of "
                f"{', '.join(ATTN_IMPLS)}"
            )
        if self.eos_id is not None and self.eos_id < 0:
            raise ValueError(f"eos_id={self.eos_id} must be >= 0")
        if self.prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk={self.prefill_chunk} must be >= 0 "
                f"(0 disables chunking)"
            )
        if self.admission not in ("reserve", "watermark"):
            raise ValueError(
                f"admission={self.admission!r}: expected 'reserve' or "
                f"'watermark'"
            )
        for field, default in (("prefill_chunk", 0), ("prefix_cache", False),
                               ("admission", "reserve"), ("mesh", ""),
                               ("spec", "")):
            value = getattr(self, field)
            if value != default:
                raise _later_slice(field, value)

    def max_blocks_per_seq(self, n_positions: int) -> int:
        """Static block-table width: enough blocks for a full-context
        sequence."""
        return -(-n_positions // self.block_size)


# The standard GPT-2 family.
MODEL_PRESETS: dict[str, GPT2Config] = {
    "124M": GPT2Config(n_layer=12, n_embd=768, n_head=12),
    "345M": GPT2Config(n_layer=24, n_embd=1024, n_head=16),
    "774M": GPT2Config(n_layer=36, n_embd=1280, n_head=20),
    "1.5B": GPT2Config(n_layer=48, n_embd=1600, n_head=25),
}
