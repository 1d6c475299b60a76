"""Model, training and serving configuration for the PyTorch/CUDA port.

The port keeps its own copy of the JAX package's configuration surface
(``gpt_2_distributed_tpu/config.py``) rather than importing it: the field
names, defaults, validation messages and presets are the same, so a reader
can move between the two packages, but nothing here depends on JAX.

Fields whose code paths are not ported yet are still fields — so a caller
moving from the JAX package sees them — but a non-default value is refused
at construction instead of being ignored: the ``ServeConfig`` options
named in its docstring.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

# Row-chunk default for the blocked cross-entropy (``ops/losses.py``).
DEFAULT_BLOCK_ROWS = 1024


def _later_slice(owner: str, field: str, value) -> ValueError:
    return ValueError(
        f"{owner}.{field}={value!r} is not ported to PyTorch yet: it comes "
        f"in a later slice of the port"
    )


@dataclass(frozen=True)
class GPT2Config:
    """Architecture and training hyperparameters for a GPT-2 style
    decoder-only LM.

    Defaults are GPT-2 124M (vocab 50257, 1024 positions, width 768, 12
    layers, 12 heads, 0.1 dropouts, LN eps 1e-5, init std 0.02).

    Training fields, with the JAX package's meanings:

    * ``embd_dropout`` / ``attn_dropout`` / ``resid_dropout`` — dropout on
      the embedding sum, on the attention probabilities (inside the flash
      kernel), and on the attention out-projection, the MLP activation and
      the MLP out-projection.
    * ``attention_impl`` — "flash" (the flash autograd function: the CUDA
      kernels K1/K2 for CUDA tensors, their plain versions on the CPU),
      "dense" (plain PyTorch dense attention on any device), "auto" (the
      same as "flash"; the JAX package's "auto" picks dense off the TPU,
      while the port's flash wrapper already runs its plain version on
      the CPU), "ring" (ring attention over the active mesh's 'sp' axis,
      ``ops/ring_attention.py``: K8 on the card; without an sp mesh the
      "auto" policy). Under an sp mesh "auto" is "ring" too.
    * ``loss_impl`` — "blocked" (the logit-free chunked cross-entropy,
      ``ops/losses.py``) or "dense" (full fp32 logits).
    * ``loss_block_rows`` — row-chunk size of the blocked cross-entropy.
    * ``scan_layers`` — has no PyTorch counterpart: the JAX package chooses
      between a ``lax.scan`` over stacked layer params and an unrolled
      loop, while eager PyTorch loops over the per-layer dictionaries either
      way. Both values are accepted and run the same code.
    * ``fused_layers`` — "off", or the fused layer epilogues of
      ``ops/fused_layer.py`` (CUDA kernels K4-K6, their plain versions on
      the CPU): "ln" for the LN+residual+dropout junction after the
      attention and the block-closing residual+dropout, "gelu" for the
      MLP's bias+GELU+dropout, "all" for both.
    * ``fused_matmul`` — "off", or the fused matmuls of
      ``ops/fused_matmul.py`` (CUDA kernel K7, its plain versions on the
      CPU): "mlp" for the fc leg's matmul+bias+GELU+dropout, "proj" for
      the attention and MLP out-projections' matmul+bias+dropout+residual,
      "all" for both and the qkv matmul+bias. A fused leg takes the place
      of the ``fused_layers`` epilogue on the same leg.
    * ``remat`` — activation checkpointing (``models/gpt2.py``): False
      saves everything; True/"block" recomputes each whole block in the
      backward; "mlp" or "attn" only that half of each block; "dots"
      saves the 2-D matmul outputs of both halves and recomputes the rest.
    """

    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    embd_dropout: float = 0.1
    attn_dropout: float = 0.1
    resid_dropout: float = 0.1
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    remat: bool | str = False
    scan_layers: bool = True
    attention_impl: str = "auto"
    loss_impl: str = "blocked"
    fused_layers: str = "off"
    fused_matmul: str = "off"
    loss_block_rows: int = DEFAULT_BLOCK_ROWS

    def __post_init__(self) -> None:
        if self.n_embd % self.n_head != 0:
            raise ValueError(
                f"n_embd={self.n_embd} must be divisible by n_head={self.n_head}"
            )
        if self.attention_impl not in ("auto", "dense", "flash", "ring"):
            raise ValueError(
                f"attention_impl={self.attention_impl!r}: expected "
                "'auto', 'dense', 'flash' or 'ring'"
            )
        if self.fused_layers not in ("off", "ln", "gelu", "all"):
            raise ValueError(
                f"fused_layers={self.fused_layers!r}: expected "
                "'off', 'ln', 'gelu' or 'all'"
            )
        if self.fused_matmul not in ("off", "mlp", "proj", "all"):
            raise ValueError(
                f"fused_matmul={self.fused_matmul!r}: expected "
                "'off', 'mlp', 'proj' or 'all'"
            )
        if self.loss_impl not in ("blocked", "dense"):
            raise ValueError(
                f"loss_impl={self.loss_impl!r}: expected 'blocked' or 'dense'"
            )
        if self.loss_block_rows < 1:
            raise ValueError(
                f"loss_block_rows={self.loss_block_rows} must be >= 1"
            )
        if self.remat not in (False, True, "block", "mlp", "attn", "dots"):
            raise ValueError(
                f"remat={self.remat!r}: expected False, True, 'block', "
                f"'mlp', 'attn' or 'dots'"
            )

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    def replace(self, **kwargs) -> "GPT2Config":
        return dataclasses.replace(self, **kwargs)

    def num_params(self, include_embeddings: bool = True) -> int:
        """Exact parameter count (lm_head is tied to wte, so it adds nothing)."""
        c, l, v, p = self.n_embd, self.n_layer, self.vocab_size, self.n_positions
        per_block = (2 * (2 * c) + c * 3 * c + 3 * c + c * c + c
                     + c * 4 * c + 4 * c + 4 * c * c + c)
        n = l * per_block + 2 * c
        if include_embeddings:
            n += v * c + p * c
        return n


ATTN_IMPLS = ("auto", "kernel", "plain")


@dataclass(frozen=True)
class CheckpointPolicy:
    """Checkpoint-lifecycle policy (``checkpoint.CheckpointSaver``), the JAX
    package's.

    * ``async_save`` — periodic saves copy the state to the host (the only
      part the step loop waits for) and write and commit it on a background
      thread. Emergency and final saves always finish before returning.
    * ``keep_last_n`` — retention: keep only the newest N *committed*
      checkpoints (0 = keep everything). The newest committed checkpoint is
      never deleted; uncommitted (failed or interrupted) save dirs are
      always pruned.
    * ``save_retries`` / ``retry_backoff_s`` — a failed save is retried this
      many times, the delay doubling each attempt; a save that exhausts its
      retries becomes a warning and the ``save_failures`` metric instead of
      ending the run.
    """

    async_save: bool = True
    keep_last_n: int = 0
    save_retries: int = 2
    retry_backoff_s: float = 0.5

    def __post_init__(self) -> None:
        if self.keep_last_n < 0:
            raise ValueError(f"keep_last_n={self.keep_last_n} must be >= 0")
        if self.save_retries < 0:
            raise ValueError(f"save_retries={self.save_retries} must be >= 0")
        if self.retry_backoff_s < 0:
            raise ValueError(
                f"retry_backoff_s={self.retry_backoff_s} must be >= 0"
            )


@dataclass(frozen=True)
class TracePolicy:
    """Structured-tracing policy (``obs/trace.py``), the JAX package's.

    Default disabled: the tracer is then a pure no-op (shared null span, no
    file ever opened), so instrumented hot paths cost one branch per call
    site.

    * ``trace_dir`` — where per-process ``trace-p{rank}.jsonl`` files land
      (None = tracing off). Read back with ``scripts/obs_report.py``.
    * ``max_file_bytes`` — rotation bound per process: the live file plus
      one ``.1`` generation, so disk use is capped at twice this.
    * ``xla_profile_at`` — on-demand ``torch.profiler`` window,
      ``STEP[:NSTEPS]`` (None = no capture); host spans enter
      ``torch.profiler.record_function`` while it is open.
    """

    trace_dir: str | None = None
    max_file_bytes: int = 64 * 1024 * 1024
    xla_profile_at: str | None = None

    @property
    def enabled(self) -> bool:
        return self.trace_dir is not None

    def __post_init__(self) -> None:
        if self.max_file_bytes < 4096:
            raise ValueError(
                f"max_file_bytes={self.max_file_bytes} must be >= 4096 "
                f"(one meta record + headroom)"
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

    * ``prefill_chunk`` — 0 prefills a prompt whole inside admission; N > 0
      prefills it in N-token chunks, one a step, between decode steps.
    * ``prefix_cache`` — share full KV blocks across requests whose prompts
      share a prefix (refcounted, LRU-evicted under pool pressure).
    * ``prefill_batch`` — chunked mode: in-progress prefills advanced per
      step, in one dispatch.
    * ``admission`` — "reserve" grants a request's worst-case blocks at
      admission; "watermark" grants them as the request grows and
      preempts the newest admission when the pool runs out (it resumes by
      recomputing its prefill).
    * ``watermark_blocks`` — watermark mode: blocks an admission leaves
      free while any slot is occupied, for the decoding rows to grow into.
    * ``spec`` — speculative decoding, ``"draft:<preset>,k:<K>"`` (see
      :func:`parse_serve_spec`; ``""`` = off): a draft model proposes K
      tokens a round and the target verifies them in one pass.

    ``mesh`` mirrors the JAX engine's option; only its default (one
    device) is ported so far.
    """

    max_batch: int = 8
    block_size: int = 16
    num_blocks: int = 256
    attn_impl: str = "auto"
    eos_id: int | None = None
    prefill_chunk: int = 0
    prefix_cache: bool = False
    admission: str = "reserve"
    watermark_blocks: int = 1
    mesh: str = ""
    prefill_batch: int = 1
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
        if self.watermark_blocks < 0:
            raise ValueError(
                f"watermark_blocks={self.watermark_blocks} must be >= 0"
            )
        if not 1 <= self.prefill_batch <= self.max_batch:
            raise ValueError(
                f"prefill_batch={self.prefill_batch} must be in "
                f"[1, max_batch={self.max_batch}]"
            )
        self.spec_axes()  # raises on a malformed spec
        if self.mesh != "":
            raise _later_slice("ServeConfig", "mesh", self.mesh)

    def spec_axes(self) -> tuple[str | None, int]:
        """Parse ``spec`` into ``(draft_preset, k)`` (``""`` -> (None, 0));
        see :func:`parse_serve_spec`."""
        return parse_serve_spec(self.spec)

    @property
    def spec_k(self) -> int:
        """Draft run length per verify pass (0 = speculation off)."""
        return self.spec_axes()[1]

    def max_blocks_per_seq(self, n_positions: int) -> int:
        """Static block-table width: enough blocks for a full-context
        sequence."""
        return -(-n_positions // self.block_size)

    @property
    def mesh_devices(self) -> int:
        """Devices one replica spans: 1 (serving meshes are not ported)."""
        return 1


def parse_serve_spec(spec: str) -> tuple[str | None, int]:
    """Parse a speculative-decoding spec into ``(draft_preset, k)``
    (``""`` -> (None, 0): speculation off).

    Accepts ``"draft:<preset>,k:<K>"`` (``=`` also accepted as the
    separator). Both keys are required when the spec is non-empty: a draft
    model with no run length (or the reverse) is a configuration bug, not
    a default. The preset name is validated against :data:`MODEL_PRESETS`
    here; the draft-smaller-than-target check needs the target's config
    and lives in :func:`validate_spec_flags` and the engine constructor."""
    if not spec:
        return None, 0
    draft: str | None = None
    k: int | None = None
    seen: set[str] = set()
    for part in spec.split(","):
        name, _, val = part.replace("=", ":").partition(":")
        name = name.strip()
        val = val.strip()
        if name not in ("draft", "k"):
            raise ValueError(
                f"spec={spec!r}: unknown key {name!r} (speculation specs "
                f"use 'draft' and 'k' only)"
            )
        if name in seen:
            raise ValueError(f"spec={spec!r}: duplicate key {name!r}")
        seen.add(name)
        if name == "draft":
            if val not in MODEL_PRESETS:
                raise ValueError(
                    f"spec={spec!r}: unknown draft preset {val!r} "
                    f"(expected one of {', '.join(MODEL_PRESETS)})"
                )
            draft = val
        else:
            try:
                k = int(val)
            except ValueError:
                raise ValueError(
                    f"spec={spec!r}: key 'k' needs an integer, got {val!r}"
                ) from None
            if k < 1:
                raise ValueError(
                    f"spec={spec!r}: k={k} must be >= 1 (use spec='' to "
                    f"disable speculation)"
                )
    if draft is None or k is None:
        raise ValueError(
            f"spec={spec!r}: both 'draft' and 'k' are required "
            f"(e.g. 'draft:124M,k:4')"
        )
    return draft, k


# Replica placement modes of the serving front ends: ``inprocess`` builds
# every ServingEngine inside the frontend process (the default: no RPC,
# shared fate); ``subprocess`` hosts one engine per worker process behind
# the RPC supervision plane (a process's blast radius); ``remote`` adopts
# pre-started workers listening on tcp://host:port (named by a
# --worker_pool file), whose hosts are failure domains of their own.
PLACEMENTS = ("inprocess", "subprocess", "remote")


def validate_worker_flags(p, args) -> None:
    """The serving CLIs' checks of ``--placement`` and the ``--worker_*``
    flags, after parsing and before anything imports torch, with the JAX
    CLIs' texts (the speculation half of the JAX function is
    :func:`validate_spec_flags`). A bad auth token file is refused here
    too: a fleet that cannot authenticate must not get as far as spawning."""
    if args.placement not in PLACEMENTS:
        p.error(f"--placement must be one of {'|'.join(PLACEMENTS)}, got {args.placement!r}")
    for flag, value, floor in (
        ("worker_max_respawns", args.worker_max_respawns, ">= 0"),
        ("worker_respawn_backoff_s", args.worker_respawn_backoff_s, ">= 0"),
        ("worker_rpc_timeout_s", args.worker_rpc_timeout_s, "> 0"),
        ("worker_heartbeat_s", args.worker_heartbeat_s, "> 0"),
        ("worker_connect_timeout_s", args.worker_connect_timeout_s, "> 0"),
    ):
        if value < 0 or (floor == "> 0" and value == 0):
            p.error(f"--{flag} must be {floor}, got {value}")
    hb_timeout = args.worker_heartbeat_timeout_s
    if hb_timeout is not None and hb_timeout <= 0:
        p.error(f"--worker_heartbeat_timeout_s must be > 0, got {hb_timeout}")
    if args.worker_auth_token_file is not None:
        from gpt_2_distributed_torch.serving.frontend.rpc import load_auth_token

        try:
            load_auth_token(args.worker_auth_token_file)
        except (OSError, ValueError) as e:
            p.error(f"--worker_auth_token_file: {e}")
    pool = args.worker_pool
    if args.placement == "remote":
        if not pool:
            p.error(
                "--placement remote needs --worker_pool (a file of "
                "'host_id address' lines naming the fleet; workers "
                "append themselves with the worker CLI's --advertise: "
                "python -m gpt_2_distributed_torch.serving.frontend.worker)"
            )
        if not os.path.exists(pool):
            p.error(f"--worker_pool {pool!r}: file not found")
    elif pool:
        p.error(f"--worker_pool only makes sense with --placement remote, "
                f"not {args.placement!r}")


def validate_spec_flags(p, args) -> None:
    """The serving CLIs' checks of ``--spec_k``, ``--draft_preset`` and
    ``--draft_ckpt``, after parsing: ``--spec_k >= 1``; ``--spec_k`` and
    ``--draft_ckpt`` need ``--draft_preset``; the preset is known; the
    draft has strictly fewer params than the target after the model
    overrides. Exits through ``p.error`` with the JAX CLIs' texts."""
    spec_k = args.spec_k
    if spec_k is not None and spec_k < 1:
        p.error(f"--spec_k must be >= 1, got {spec_k}")
    draft = args.draft_preset
    if draft is None:
        if spec_k is not None:
            p.error("--spec_k needs --draft_preset (speculation is opt-in "
                    "via the draft model)")
        if args.draft_ckpt:
            p.error("--draft_ckpt needs --draft_preset")
        return
    if draft not in MODEL_PRESETS:
        p.error(
            f"--draft_preset must be one of "
            f"{'|'.join(MODEL_PRESETS)}, got {draft!r}"
        )
    target = MODEL_PRESETS.get(args.model)
    if target is not None:
        overrides = {field: getattr(args, flag) for flag, field in (
            ("n_layer", "n_layer"), ("n_embd", "n_embd"), ("n_head", "n_head"),
            ("vocab_size", "vocab_size"), ("seq_len", "n_positions"),
        ) if getattr(args, flag) is not None}
        try:
            target = target.replace(**overrides)
        except ValueError:
            target = None  # malformed model flags fail elsewhere
    if target is not None and MODEL_PRESETS[draft].num_params() >= target.num_params():
        p.error(
            f"--draft_preset {draft} "
            f"({MODEL_PRESETS[draft].num_params():,} params) must be "
            f"smaller than the target model "
            f"({target.num_params():,} params): a draft at least as "
            f"large as the target cannot speed up verification"
        )


# The standard GPT-2 family.
MODEL_PRESETS: dict[str, GPT2Config] = {
    "124M": GPT2Config(n_layer=12, n_embd=768, n_head=12),
    "345M": GPT2Config(n_layer=24, n_embd=1024, n_head=16),
    "774M": GPT2Config(n_layer=36, n_embd=1280, n_head=20),
    "1.5B": GPT2Config(n_layer=48, n_embd=1600, n_head=25),
}
