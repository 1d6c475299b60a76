"""Continuous-batching decode engine over the paged KV cache
(``gpt_2_distributed_tpu/serving/engine.py``, whole-prompt mode).

* **Admission at step boundaries.** A FIFO queue feeds free slots. Each
  admission reserves the request's worst-case block need
  (``ceil((P + max_new - 1) / block_size)``) all-or-nothing, so an
  in-flight request can never run out of blocks mid-decode; if the queue
  head does not fit, nothing behind it jumps the queue.
* **Whole-prompt prefill** runs inside admission: the prompt, right-padded
  to the block bucket ``pb = ceil(P / bs) * bs`` (capped at
  ``n_positions``), goes through ``models/decode.py::prefill`` — on the
  card through the flash kernel — the first token is sampled from hidden
  row ``P - 1``, and the K/V land in the request's pool blocks. Padding is
  causally inert: it sits after every real position.
* **One decode step** for every slot per engine step: each active row
  writes its K/V at its own position, in place, BEFORE attending (the row
  attends to itself), then attends over its pages through
  ``ops/paged_attention.py`` — on the card the paged kernel. Idle rows
  are steered to the null block with length 0, which the kernel turns
  into exact zeros.
* **Eviction** on EOS, on length, or past a request's deadline releases
  its blocks and zeroes its table row.
* **Streaming**: every sampled token goes through the request's
  ``on_token`` callback in the step that produces it.

Sampling: each request owns a ``torch.Generator`` seeded from its seed, on
the engine's device, drawn once per sampled token in the same order as
``generate_cached(batch=1)``, and each row is sampled on its own — so a
request's stream never depends on which requests share its batch. On the
CPU the engine's streams equal ``generate_cached(batch=1)``'s token for
token (``tests/test_torch_serving.py``).

Not ported yet (refused by ``ServeConfig``): chunked prefill, the prefix
cache, watermark admission with preemption, serving meshes and
speculative decoding, and with them the migration surface
(``extract_inflight`` / ``adopt``, the request wire form).
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Sequence

import numpy as np
import torch

from gpt_2_distributed_torch.config import GPT2Config, ServeConfig
from gpt_2_distributed_torch.kernels import build
from gpt_2_distributed_torch.models import decode, gpt2
from gpt_2_distributed_torch.models.generate import (
    check_generation_args,
    sample_token,
)
from gpt_2_distributed_torch.ops.layers import layer_norm
from gpt_2_distributed_torch.ops.paged_attention import paged_attention
from gpt_2_distributed_torch.serving.paged_cache import (
    BlockAllocator,
    init_pools,
    pool_bytes,
    scatter_prefill,
)
from gpt_2_distributed_torch.utils.device import resolve_device


class RequestHandle:
    """One submitted request: its prompt, its growing output, and the
    accounting the serving CLI reads."""

    def __init__(
        self,
        rid: int,
        prompt: list[int],
        max_new_tokens: int,
        on_token: Callable[["RequestHandle", int], None] | None = None,
    ):
        self.id = rid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.on_token = on_token
        self.generated: list[int] = []
        self.done = False
        self.finish_reason: str | None = None  # "eos" | "length" | "timeout"
        self.deadline: float | None = None     # monotonic; None = no deadline
        self.submit_time: float | None = None
        self.first_token_time: float | None = None
        self.queue_wait_ms = 0.0
        self.preemptions = 0          # always 0 until preemption is ported
        self.prefix_cached_tokens = 0  # always 0 until the prefix cache is
        self._gen: torch.Generator | None = None
        self._blocks: list[int] | None = None
        self._enqueue_time: float | None = None

    def _emit(self, tok: int) -> None:
        if self.first_token_time is None:
            self.first_token_time = time.monotonic()
        if self.on_token is not None:
            self.on_token(self, tok)

    def _finish(self, reason: str) -> None:
        self.done = True
        self.finish_reason = reason


class ServingEngine:
    """Continuous-batching serving engine. See the module docstring.

    Typical loop::

        eng = ServingEngine(params, config, ServeConfig(max_batch=8))
        h = eng.submit(prompt_ids, max_new_tokens=64, seed=0)
        eng.run_until_idle()
        print(h.generated)

    ``params`` are the fp32 master weights (``models/gpt2.py``); the engine
    keeps its own compute-dtype copy on ``device``, which defaults to CUDA.
    """

    def __init__(
        self,
        params: dict,
        config: GPT2Config,
        serve: ServeConfig | None = None,
        *,
        temperature: float = 0.0,
        top_k: int | None = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device | None = None,
    ):
        serve = serve if serve is not None else ServeConfig()
        check_generation_args(config, 1, 1, top_k, batch=serve.max_batch)
        self.device = resolve_device(device)
        # fp32 products in full fp32 on the card, stated rather than left
        # to defaults: the fp32 logits that sampling reads must not pass
        # through TF32.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self.serve = serve
        self.temperature = float(temperature)
        self.top_k = top_k
        self.w = gpt2.compute_weights(params, compute_dtype, self.device)
        if self.device.type == "cuda" and serve.attn_impl != "plain":
            # Build the kernels now (parallel nvcc, skipped once built) so
            # the first request's TTFT never includes a compile.
            build.build(["flash_fwd", "paged_decode"])

        self._m = serve.max_blocks_per_seq(config.n_positions)
        self.k_pool, self.v_pool = init_pools(config, serve, compute_dtype,
                                              self.device)
        self.allocator = BlockAllocator(serve.num_blocks)
        # Scheduler state lives on the host as numpy; each decode step
        # ships it to the device in a few small copies.
        self.block_table = np.zeros((serve.max_batch, self._m), np.int32)
        self.pos = np.zeros((serve.max_batch,), np.int64)
        self.tokens = np.zeros((serve.max_batch,), np.int64)
        self.active = np.zeros((serve.max_batch,), bool)

        self._slots: list[RequestHandle | None] = [None] * serve.max_batch
        self._queue: collections.deque[RequestHandle] = collections.deque()
        self._next_id = 0
        self._deadlines = False
        self.stats = {
            "admitted": 0, "finished": 0, "prefills": 0, "decode_steps": 0,
            "tokens_out": 0, "timeouts": 0, "prefill_ms": 0.0,
            "decode_ms": 0.0, "queue_wait_ms": 0.0,
        }

    @property
    def kv_pool_bytes(self) -> int:
        """Device bytes of the two KV pools."""
        return pool_bytes(self.config, self.serve, self.k_pool.element_size())

    # ------------------------------------------------------------- intake

    def _blocks_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        # Positions 0 .. P+max_new-2 get written (the last sampled token is
        # emitted but never processed); worst case ignores early EOS.
        return -(-(prompt_len + max_new_tokens - 1) // self.serve.block_size)

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        *,
        seed: int = 0,
        on_token: Callable[[RequestHandle, int], None] | None = None,
        timeout_s: float | None = None,
    ) -> RequestHandle:
        """Queue a request, validated here with the same ValueErrors as
        ``generate_cached``. ``seed`` seeds the request's sampling
        generator; ``timeout_s`` sets a deadline counted from submission
        (queue wait included), after which the request is evicted with
        finish reason ``"timeout"``."""
        prompt = [int(t) for t in prompt]
        check_generation_args(
            self.config, len(prompt), max_new_tokens, self.top_k, batch=1
        )
        need = self._blocks_needed(len(prompt), max_new_tokens)
        usable = self.serve.num_blocks - 1
        if need > usable:
            raise ValueError(
                f"request needs {need} KV blocks but the pool only has "
                f"{usable} allocatable (num_blocks={self.serve.num_blocks}, "
                f"block_size={self.serve.block_size}) — it could never be "
                f"admitted"
            )
        if timeout_s is not None and timeout_s < 0:
            raise ValueError(f"timeout_s must be >= 0, got {timeout_s}")
        req = RequestHandle(self._next_id, prompt, max_new_tokens, on_token)
        self._next_id += 1
        req._gen = torch.Generator(device=self.device).manual_seed(int(seed))
        req.submit_time = time.monotonic()
        if timeout_s is not None:
            req.deadline = req.submit_time + timeout_s
            self._deadlines = True
        req._enqueue_time = req.submit_time
        self._queue.append(req)
        return req

    def _try_admit(self) -> None:
        """Admit queued requests into free slots, FIFO, while blocks last."""
        while self._queue:
            slot = next((s for s, r in enumerate(self._slots) if r is None), None)
            if slot is None:
                break
            req = self._queue[0]
            ids = self.allocator.alloc(
                self._blocks_needed(len(req.prompt), req.max_new_tokens)
            )
            if ids is None:
                break   # head waits for evictions; nothing jumps the queue
            self._queue.popleft()
            now = time.monotonic()
            wait_ms = (now - req._enqueue_time) * 1e3
            req.queue_wait_ms += wait_ms
            self.stats["queue_wait_ms"] += wait_ms
            self.stats["admitted"] += 1
            req._blocks = ids
            self._slots[slot] = req
            self.block_table[slot, :] = 0
            self.block_table[slot, :len(ids)] = ids
            self._prefill_whole(slot, req)

    # ------------------------------------------------------------ prefill

    @torch.no_grad()
    def _prefill_whole(self, slot: int, req: RequestHandle) -> None:
        """Bucketed whole-prompt forward, first-token sample, block scatter."""
        bs = self.serve.block_size
        p = len(req.prompt)
        nb = -(-p // bs)                       # blocks prefill fills
        pb = nb * bs                           # scatter width
        pf = min(pb, self.config.n_positions)  # forward width
        t0 = time.monotonic()
        prompt = torch.zeros((1, pf), dtype=torch.long)
        prompt[0, :p] = torch.tensor(req.prompt)
        h, cache = decode.prefill(self.w, self.config, prompt.to(self.device),
                                  pf, self.serve.attn_impl)
        # Row p-1 is the real last position; rows past it are padding.
        logits0 = gpt2.logits_fp32(self.w, h[:, p - 1])
        first = sample_token(logits0, [req._gen], self.temperature, self.top_k)
        k, v = cache.k[:, 0], cache.v[:, 0]    # [L, H, pf, D]
        if pb > pf:
            # The last block straddles n_positions: the forward cannot run
            # past the position table, but the scatter writes whole blocks.
            # Zero-pad; decode overwrites the tail before it is attendable.
            pad = (0, 0, 0, pb - pf)
            k, v = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
        scatter_prefill(self.k_pool, self.v_pool, k, v, req._blocks[:nb])
        first_i = int(first[0])                # the device sync
        self.stats["prefill_ms"] += (time.monotonic() - t0) * 1e3
        self.stats["prefills"] += 1

        req.generated.append(first_i)
        self.stats["tokens_out"] += 1
        req._emit(first_i)
        if self.serve.eos_id is not None and first_i == self.serve.eos_id:
            self._evict(slot, "eos")
        elif len(req.generated) >= req.max_new_tokens:
            self._evict(slot, "length")
        else:
            self.tokens[slot] = first_i
            self.pos[slot] = p
            self.active[slot] = True

    # -------------------------------------------------------------- churn

    def _evict(self, slot: int, reason: str) -> None:
        req = self._slots[slot]
        req._finish(reason)
        self.allocator.release(req._blocks)
        req._blocks = None
        self._slots[slot] = None
        # Table row back to the null block; the slot decodes as a no-op
        # (length 0) until the next admission overwrites it.
        self.block_table[slot, :] = 0
        self.pos[slot] = 0
        self.active[slot] = False
        self.stats["finished"] += 1

    def _evict_overdue(self) -> int:
        """Evict every request past its deadline — slotted rows and queued
        requests alike. Free when no live request carries a deadline."""
        if not self._deadlines:
            return 0
        now = time.monotonic()
        evicted = 0
        for slot, req in enumerate(self._slots):
            if req is not None and req.deadline is not None and now >= req.deadline:
                self._evict(slot, "timeout")
                self.stats["timeouts"] += 1
                evicted += 1
        overdue = [r for r in self._queue
                   if r.deadline is not None and now >= r.deadline]
        for req in overdue:
            self._queue.remove(req)
            req._finish("timeout")
            self.stats["finished"] += 1
            self.stats["timeouts"] += 1
            evicted += 1
        self._deadlines = any(
            r is not None and r.deadline is not None
            for r in list(self._slots) + list(self._queue)
        )
        return evicted

    def has_work(self) -> bool:
        """Anything queued or in flight."""
        return bool(self._queue) or any(s is not None for s in self._slots)

    @property
    def occupancy(self) -> int:
        return sum(s is not None for s in self._slots)

    # ------------------------------------------------------------- decode

    @torch.no_grad()
    def decode_logits(self, attn_impl: str | None = None) -> torch.Tensor:
        """One decode step's forward for every slot, without sampling or
        scheduler updates: writes this step's K/V into the pools and
        returns [max_batch, V] fp32 logits. ``attn_impl`` overrides
        ``ServeConfig.attn_impl`` (to hold the kernel path against the
        plain one on the same pool state)."""
        impl = self.serve.attn_impl if attn_impl is None else attn_impl
        cfg, w, dev = self.config, self.w, self.device
        bsz = self.serve.max_batch
        bs = self.serve.block_size
        lengths = np.where(self.active, self.pos + 1, 0).astype(np.int32)
        blk = self.block_table[np.arange(bsz), self.pos // bs]
        blk = np.where(self.active, blk, 0)    # idle rows scribble on block 0
        off = self.pos % bs
        pos_d = torch.from_numpy(self.pos).to(dev)
        blk_d = torch.from_numpy(blk.astype(np.int64)).to(dev)
        off_d = torch.from_numpy(off).to(dev)
        table_d = torch.from_numpy(self.block_table).to(dev)
        lengths_d = torch.from_numpy(lengths).to(dev)

        x = gpt2.embed(w, cfg, torch.from_numpy(self.tokens).to(dev)[:, None],
                       pos_d[:, None])                        # [B, 1, C]
        for layer, bp in enumerate(w["blocks"]):
            y = layer_norm(x, bp["ln1_scale"], bp["ln1_bias"], cfg.layer_norm_eps)
            q, k, v = gpt2.qkv_proj(cfg, y, bp)               # [B, 1, H, D]
            kp, vp = self.k_pool[layer], self.v_pool[layer]   # [N, H, bs, D]
            kp[blk_d, :, off_d] = k[:, 0]
            vp[blk_d, :, off_d] = v[:, 0]
            o = paged_attention(q[:, 0], kp, vp, table_d, lengths_d,
                                impl=impl)                    # [B, H, D]
            x = x + gpt2.attn_out(o.reshape(bsz, 1, cfg.n_embd), bp)
            x = gpt2.mlp_sublayer(cfg, x, bp)
        x = gpt2.final_norm(w, cfg, x)
        return gpt2.logits_fp32(w, x[:, 0])

    @torch.no_grad()
    def step(self) -> int:
        """One engine step: evict overdue requests, admit what fits
        (prefilling each), then one decode step for every active row.
        Returns tokens emitted this step."""
        self._evict_overdue()
        emitted_before = self.stats["tokens_out"]
        self._try_admit()
        if not self.active.any():
            return self.stats["tokens_out"] - emitted_before

        was_active = self.active.copy()
        t0 = time.monotonic()
        logits = self.decode_logits()
        if self.temperature == 0.0:
            next_tokens = sample_token(logits, None, 0.0, self.top_k)
        else:
            # Each row on its own with its request's generator: a row's
            # draw never depends on its batch mates.
            next_tokens = torch.zeros(logits.shape[0], dtype=torch.long,
                                      device=logits.device)
            for slot in np.flatnonzero(was_active):
                next_tokens[slot] = sample_token(
                    logits[slot:slot + 1], [self._slots[slot]._gen],
                    self.temperature, self.top_k,
                )[0]
        toks = next_tokens.cpu().numpy()            # the device sync
        self.stats["decode_ms"] += (time.monotonic() - t0) * 1e3
        self.stats["decode_steps"] += 1

        self.tokens = np.where(was_active, toks, self.tokens)
        self.pos = np.where(was_active, self.pos + 1, self.pos)
        for slot in np.flatnonzero(was_active):
            req = self._slots[slot]
            t = int(toks[slot])
            req.generated.append(t)
            self.stats["tokens_out"] += 1
            req._emit(t)
            if self.serve.eos_id is not None and t == self.serve.eos_id:
                self._evict(slot, "eos")
            elif len(req.generated) >= req.max_new_tokens:
                self._evict(slot, "length")
        return self.stats["tokens_out"] - emitted_before

    def run_until_idle(self, max_steps: int | None = None) -> int:
        """Drive ``step`` until the queue and every slot drain. Returns
        total tokens emitted. Terminates: ``submit`` only accepts requests
        that fit an empty pool."""
        total = 0
        steps = 0
        while self.has_work():
            total += self.step()
            steps += 1
            if max_steps is not None and steps > max_steps:
                raise RuntimeError(
                    f"run_until_idle: exceeded max_steps={max_steps} with "
                    f"{len(self._queue)} queued / {self.occupancy} in flight"
                )
        return total

    # ------------------------------------------------------------ metrics

    def metrics_snapshot(self) -> dict[str, float]:
        """Current serving-load metrics."""
        adm = max(self.stats["admitted"], 1)
        return {
            "queue_wait_ms": self.stats["queue_wait_ms"] / adm,
            "serve_queue_depth": float(len(self._queue)),
            "serve_occupancy": float(self.occupancy),
            "kv_pool_bytes": float(self.kv_pool_bytes),
            "decode_steps": float(self.stats["decode_steps"]),
            "tokens_out": float(self.stats["tokens_out"]),
        }
