"""Continuous-batching decode engine over the paged KV cache
(``gpt_2_distributed_tpu/serving/engine.py``).

* **Admission at step boundaries.** A FIFO queue feeds free slots; if the
  queue head does not fit, unpinned prefix-cache entries are evicted (LRU)
  and, failing that, nothing behind it jumps the queue. Two grant policies
  (``ServeConfig.admission``):

  - ``"reserve"`` takes the request's worst-case block need
    (``ceil((P + max_new - 1) / block_size)``, less the blocks it shares
    from the prefix cache) all-or-nothing, so an in-flight request never
    runs out of blocks mid-decode;
  - ``"watermark"`` grants what the prefill writes plus the first decode
    position and, while a slot is occupied, leaves ``watermark_blocks``
    free. Before each decode step ``_grow_tables`` gives a block to every
    row about to write past its last one, oldest admission first; on
    exhaustion the newest admission is **preempted**: its blocks are
    freed and it is requeued at the head, its last sampled token carried
    as the pending decode input.
* **Recompute resume.** A preempted (or migrated) request is prefilled
  again over its work prompt ``prompt + generated[:-1]`` through the chunk
  path, in whole-prompt mode too. Its prefill neither emits nor samples:
  the pending token becomes the decode input and the request's generator
  is not drawn. The positions the decode step wrote (``>= len(prompt)``)
  attend as the decode step did, through the paged attention of
  ``ops/paged_attention.py`` (K3 on the card) as one-row sequences of
  length ``pos + 1``, so every layer's K/V there get the decode step's
  bits and the stream stays equal to the uninterrupted one on the card.
* **Prefix caching** (``ServeConfig.prefix_cache``): full prompt blocks are
  hash-consed by token prefix (``paged_cache.PrefixCache``) over
  refcounted blocks. A hit run is pinned before the grant and prefill
  starts after it; a block-aligned, fully cached prompt copies its last
  block (copy-on-write) and recomputes its last position for the logits.
  A request registers its full work-prompt blocks when its prefill
  completes (first writer wins). A block that holds decode-written
  positions is keyed by its tokens and the request's prompt length, so
  only that request's own later resume reuses it (see
  ``_register_prefix``).
* **Whole-prompt prefill** (no hit, ``prefill_chunk = 0``, not a resume)
  runs inside admission: the prompt, right-padded to the block bucket
  ``pb = ceil(P / bs) * bs`` (capped at ``n_positions``), goes through
  ``models/decode.py::prefill`` — on the card through the flash kernel —
  the first token is sampled from hidden row ``P - 1``, and the K/V land in
  the request's pool blocks. Padding is causally inert: it sits after
  every real position.
* **Chunked prefill** (:func:`chunk_prefill`) starts mid-sequence: each
  row's K/V are scattered into its blocks at position granularity and its
  queries attend over the partly built table
  (``ops/paged_attention.py::paged_prefill_attention``, on the card K1's
  query-offset form). It carries every prefix-cache continuation, every
  resume and, with ``prefill_chunk = N``, every prompt: one step advances
  up to ``prefill_batch`` prefills, oldest admission first, by one N-token
  chunk each in one dispatch, before the decode step, so a long prompt no
  longer stalls every stream. Prefilling rows hold their slot but do not
  decode.
* **One decode step** for every slot per engine step: each active row
  writes its K/V at its own position, in place, BEFORE attending (the row
  attends to itself), then attends over its pages through
  ``ops/paged_attention.py`` — on the card the paged kernel. Idle rows
  are steered to the null block with length 0, which the kernel turns
  into exact zeros.
* **Eviction** on EOS, on length, or past a request's deadline releases
  its blocks and zeroes its table row.
* **Streaming**: every sampled token goes through the request's
  ``on_token`` callback in the step that produces it, once.
* **Migration**: ``extract_inflight`` detaches every live request in
  admission order with the state ``_preempt`` saves (also from an engine
  whose ``step`` raised: its allocator is then not trusted), ``adopt``
  queues one on another engine with the same ``ServeConfig``, and
  ``RequestHandle.to_wire``/``from_wire`` carry a request across a
  process boundary as JSON. A migrated stream resumes as a preempted one
  does, with zero tokens re-emitted. The replica router
  (``serving/frontend/router.py``) moves a failed replica's requests so.
* **Tracing** (``obs/trace.py``, off unless configured): ``step`` is an
  ``engine_step(n)`` span holding ``admit``, ``prefill``, ``grow``
  (watermark mode) and ``decode(rows)``, and the request lifecycle events
  ``submit``, ``admit``, ``prefill_chunk``, ``prefix_hit``, ``cow``,
  ``preempt``, ``resume``, ``first_token`` and ``finish`` carry the JAX
  engine's names and attributes (a speculative step holds ``draft(rows,
  k)`` and ``verify(rows, k)`` in place of ``decode``, and emits one
  ``spec_accept`` event a row a round). The handle's events reuse its own
  ``time.monotonic()`` stamps (the tracer's ``perf_counter`` is the same
  clock on Linux), so a TTFT rebuilt from the trace equals the handle's
  exactly. No span closes on a device sync of its own: ``decode`` ends
  after the step's one existing sync, the sampled tokens' copy.

Sampling: each request owns a ``torch.Generator`` seeded from its seed, on
the engine's device, drawn once per sampled token in the same order as
``generate_cached(batch=1)``, and each row is sampled on its own — so a
request's stream never depends on which requests share its batch. The
generator stays on the handle through preemption and travels in the wire
form (its state bytes), so nothing is captured from the engine. The
engine's streams equal ``generate_cached(batch=1)``'s token for token, on
the CPU (``tests/test_torch_serving.py``) and on the card: there every
product, LayerNorm and the head run kernels whose result for a row does
not depend on the rows beside it (``models/gpt2.py``), and both sides
decode through the paged kernel (``models/decode.py``).

A request's generator is drawn once for its first token, on its final
prefill chunk only (never for a pad row or a resume), so chunking and
cache hits leave its draws where ``generate_cached(batch=1)`` makes them;
every op of the chunk path gives a row the bits the whole-prompt path (or,
for a decode-written position, the decode step) gives it on the card.

**Speculative decoding** (``ServeConfig.spec = "draft:<preset>,k:<K>"``,
with ``draft_params=``/``draft_config=``): each step is a round of
:meth:`ServingEngine._spec_round` in place of the decode step. A smaller
draft model keeps its own pool (``paged_cache.draft_serve_view``: full
capacity for every slot, so a draft grant never fails), rebuilt from the
committed tokens after admission, preemption or migration by one chunk
pass (the draft catch-up), and proposes K tokens by K+1 decode steps over
that pool (the last writes K/V only). The target verifies the K+1-token
window in one ``paged_decode_step``-shaped pass over the window's rows
flattened, so on the card every window query attends through the paged
kernel (K3) and gets the decode step's bits: the verify's logits at a
position are, bit for bit, what the decode step would give there, and a
greedy stream equals ``generate_cached(batch=1)``'s for any K. The host
accepts in fp64 (``_spec_accept``: greedy, the verify argmax; sampled, the
accept/resample rule, whose emitted tokens are distributed as the
target's). A sampled round draws its ``3K + 1`` uniforms from the
request's generator, so sampled streams are distributed as plain
decoding's but not equal to them. Draft K/V is never serialized: the wire
form is unchanged and requests migrate between speculative and plain
engines both ways.

Not ported yet (refused by ``ServeConfig``): serving meshes.
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
from gpt_2_distributed_torch.obs.trace import get_tracer
from gpt_2_distributed_torch.ops.paged_attention import (
    paged_attention,
    paged_prefill_attention,
)
from gpt_2_distributed_torch.serving.paged_cache import (
    BlockAllocator,
    PrefixCache,
    copy_block,
    draft_serve_view,
    init_pools,
    pool_bytes,
    scatter_prefill,
)
from gpt_2_distributed_torch.utils.device import resolve_device


# Version tag of the serialized request form (``RequestHandle.to_wire``).
# Bump on any change of a field's meaning: ``from_wire`` refuses unknown
# versions, so a stale worker never adopts a payload it would misread.
REQUEST_WIRE_VERSION = 1


def _generator_state(gen: torch.Generator | None) -> dict | None:
    """A sampling generator's state as JSON-able data: its device type and
    its state bytes (a CUDA Philox generator's seed and offset, or a CPU
    Mersenne generator's whole state; the two are not interchangeable)."""
    if gen is None:
        return None
    return {"device": gen.device.type, "state": gen.get_state().tolist()}


def _generator_from_state(d: dict | None, device: torch.device) -> torch.Generator | None:
    """The generator :func:`_generator_state` describes, rebuilt on
    ``device``. Raises ValueError when its device type is not ``device``'s."""
    if d is None:
        return None
    if d["device"] != device.type:
        raise ValueError(
            f"request wire: a {d['device']} generator state cannot be adopted "
            f"on a {device.type} engine (the generators' states differ in kind)"
        )
    gen = torch.Generator(device=device)
    gen.set_state(torch.tensor(d["state"], dtype=torch.uint8))
    return gen


class RequestHandle:
    """One submitted request: its prompt, its growing output, and the
    accounting the serving CLI reads (timestamps, queue wait, preemption
    and resume counts, prefix-cache hits)."""

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
        # "eos" | "length" | "timeout" (deadline exceeded) | "failed"
        # (replica lost with no healthy replica to migrate to)
        self.finish_reason: str | None = None
        self.deadline: float | None = None     # monotonic; None = no deadline
        self.submit_time: float | None = None
        self.first_token_time: float | None = None
        self.finish_time: float | None = None
        self.queue_wait_ms = 0.0      # cumulative: every (re)queue -> admit gap
        self.preemptions = 0          # times swapped out for pool pressure
        self.resumes = 0              # re-admissions after a preemption
        self.prefix_cached_tokens = 0  # prompt tokens skipped at 1st admission
        self.replica: int | None = None  # set by the replica router on route
        self._gen: torch.Generator | None = None
        self._blocks: list[int] | None = None
        self._enqueue_time: float | None = None
        self._admit_order = -1        # monotone per admission; newest = victim
        self._work: np.ndarray | None = None  # the tokens this admission prefills
        self._prefill_pos: int | None = None  # next work position; None = done
        self._pending_token: int | None = None  # resume: decode input, no emit

    @property
    def tokens(self) -> list[int]:
        """Prompt + generated so far."""
        return list(self.prompt) + list(self.generated)

    def _emit(self, tok: int) -> None:
        if self.first_token_time is None:
            self.first_token_time = time.monotonic()
            # ts is the handle's own stamp, so a trace-derived TTFT equals
            # first_token_time - submit_time exactly.
            get_tracer().event("first_token", ts=self.first_token_time, rid=self.id)
        if self.on_token is not None:
            self.on_token(self, tok)

    def _finish(self, reason: str) -> None:
        self.done = True
        self.finish_reason = reason
        self.finish_time = time.monotonic()
        get_tracer().event("finish", ts=self.finish_time, rid=self.id, reason=reason,
                           n_generated=len(self.generated))

    def to_wire(self) -> dict:
        """The migration state ``extract_inflight`` leaves on the handle as
        JSON-able data: generated tokens, the generator's state, the pending
        decode input, so the request resumes on another process bit for bit
        with zero re-emitted tokens. Timestamps are CLOCK_MONOTONIC, which
        is machine-wide on Linux, so deadlines and queue-wait accounting
        stay valid across processes on one host."""
        return {
            "v": REQUEST_WIRE_VERSION,
            "rid": self.id,
            "prompt": list(self.prompt),
            "max_new_tokens": self.max_new_tokens,
            "generated": list(self.generated),
            "generator": _generator_state(self._gen),
            "pending_token": self._pending_token,
            "deadline": self.deadline,
            "submit_time": self.submit_time,
            "first_token_time": self.first_token_time,
            "queue_wait_ms": self.queue_wait_ms,
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            "prefix_cached_tokens": self.prefix_cached_tokens,
        }

    @classmethod
    def from_wire(
        cls,
        d: dict,
        on_token: Callable[["RequestHandle", int], None] | None = None,
        *,
        device: str | torch.device | None = None,
    ) -> "RequestHandle":
        """Rebuild a handle from :meth:`to_wire` output, its generator on
        ``device`` (the adopting engine's; CUDA unless the CPU is asked
        for). Raises ValueError on an unknown version tag and on a
        generator state of another device type: adopting a payload whose
        fields would be misread would silently corrupt a stream."""
        v = d.get("v")
        if v != REQUEST_WIRE_VERSION:
            raise ValueError(
                f"unknown request wire version {v!r} "
                f"(this build speaks {REQUEST_WIRE_VERSION})"
            )
        req = cls(int(d["rid"]), [int(t) for t in d["prompt"]],
                  int(d["max_new_tokens"]), on_token)
        req.generated = [int(t) for t in d["generated"]]
        req._gen = _generator_from_state(d["generator"], resolve_device(device))
        if d["pending_token"] is not None:
            req._pending_token = int(d["pending_token"])
        req.deadline = d["deadline"]
        req.submit_time = d["submit_time"]
        req.first_token_time = d["first_token_time"]
        req.queue_wait_ms = float(d["queue_wait_ms"])
        req.preemptions = int(d["preemptions"])
        req.resumes = int(d["resumes"])
        req.prefix_cached_tokens = int(d["prefix_cached_tokens"])
        return req


@torch.no_grad()
def chunk_prefill(
    w: dict,
    config: GPT2Config,
    k_pool: torch.Tensor,   # [L, N, H, bs, D], written in place
    v_pool: torch.Tensor,
    bt: np.ndarray,         # [R, M] int32: one block-table row per request
    chunk: np.ndarray,      # [R, C] int tokens, right-padded per row
    start: np.ndarray,      # [R] int: work position of chunk[r, 0]
    clen: np.ndarray,       # [R] int: real tokens per row (0 = pad row)
    attn_impl: str = "auto",
    decode_from: np.ndarray | None = None,  # [R] int: first decode-written position
) -> torch.Tensor:
    """R prefill chunks straight into the pools in one dispatch
    (``_chunk_prefill_impl`` of the JAX engine): each row's K/V for
    positions ``[start_r, start_r + clen_r)`` are scattered into its blocks
    at position granularity, and its queries attend over the partly built
    table. Returns the ``[R, V]`` fp32 logits at each row's ``start + clen -
    1`` (row 0's for a pad row); sampling is the caller's, so a request's
    generator is drawn on its final chunk only.

    Padded positions (``i >= clen_r``) are never scattered (only the valid
    positions are selected: indexed assignment has no drop mode), and a
    valid position's block is never the null block. Embeddings clip
    positions past ``n_positions`` (a final chunk straddling it) as the
    JAX gathers do. Every op gives a row what the whole-prompt prefill
    (``models/decode.py::prefill``) gives it: the products, LayerNorms and
    head through the row-invariant inference helpers of ``models/gpt2.py``,
    the attention through ``paged_prefill_attention`` over the table's
    blocks up to the furthest valid position.

    ``decode_from[r]`` is the first of row r's positions that the decode
    step wrote in the uninterrupted run (a resume's prompt length; None:
    no row has any). A valid query at or past it attends through
    ``paged_attention`` — K3 on the card, as the decode step does — as a
    one-row sequence of length ``pos + 1`` over its row's blocks, in one
    call a layer for all such queries; its K/V at the next layer then get
    the decode step's bits, since K3's result for a sequence does not
    depend on the sequences beside it. Those queries' rows of the chunk
    attention are computed and replaced."""
    bt, chunk = np.asarray(bt, np.int32), np.asarray(chunk)
    start, clen = np.asarray(start, np.int64), np.asarray(clen, np.int64)
    r, c = chunk.shape
    bs = k_pool.shape[3]
    dev = k_pool.device
    pos = start[:, None] + np.arange(c)[None]                     # [R, C]
    rows, cols = np.nonzero(np.arange(c)[None] < clen[:, None])   # valid positions
    vpos = pos[rows, cols]
    blk = bt[rows, vpos // bs]
    if (blk == 0).any():
        raise ValueError("chunk_prefill: a valid position maps to the null block")
    nb = min(bt.shape[1], max(1, -(-int((start + clen).max()) // bs)))

    def dev_tensor(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    sel = (dev_tensor(rows, torch.long), dev_tensor(cols, torch.long))
    blk_d, off_d = dev_tensor(blk, torch.long), dev_tensor(vpos % bs, torch.long)
    table = dev_tensor(bt[:, :nb], torch.int32)
    start_d = dev_tensor(start, torch.int32)
    decoded = np.zeros(len(rows), bool)
    if decode_from is not None:
        decoded = vpos >= np.asarray(decode_from, np.int64)[rows]
    if decoded.any():
        drows, dcols = rows[decoded], cols[decoded]
        dsel = (dev_tensor(drows, torch.long), dev_tensor(dcols, torch.long))
        dtable = dev_tensor(bt[drows, :nb], torch.int32)
        dlen = dev_tensor(vpos[decoded] + 1, torch.int32)
    x = gpt2.embed(w, config, dev_tensor(chunk, torch.long), dev_tensor(pos, torch.long))
    for layer, bp in enumerate(w["blocks"]):
        y = gpt2.norm(x, bp["ln1_scale"], bp["ln1_bias"], config.layer_norm_eps, infer=True)
        q, k, v = gpt2.qkv_proj(config, y, bp, infer=True)       # [R, C, H, D]
        kp, vp = k_pool[layer], v_pool[layer]                    # [N, H, bs, D]
        kp[blk_d, :, off_d] = k[sel]
        vp[blk_d, :, off_d] = v[sel]
        o = paged_prefill_attention(q, kp, vp, table, start_d, impl=attn_impl)
        if decoded.any():
            o[dsel] = paged_attention(q[dsel], kp, vp, dtable, dlen, impl=attn_impl)
        x = x + gpt2.attn_out(o.reshape(r, c, config.n_embd), bp, infer=True)
        x = gpt2.mlp_sublayer(config, x, bp, infer=True)
    last = dev_tensor(np.maximum(clen - 1, 0), torch.long)
    h = gpt2.final_norm(w, config, x[torch.arange(r, device=dev), last])
    return gpt2.logits_fp32(w, h)


def _spec_probs(logits, temperature: float, top_k: int | None) -> np.ndarray:
    """fp64 next-token distribution(s) from fp32 logits with
    ``sample_token``'s semantics: the k-th largest value as the threshold,
    a strict-less mask (ties at the threshold stay), then temperature. On
    the host, because the acceptance rule needs the draft's and the
    target's probabilities of given tokens, and in fp64 so its arithmetic
    adds no rounding of its own."""
    l = np.asarray(logits, np.float64)
    if top_k is not None:
        kth = np.partition(l, -top_k, axis=-1)[..., -top_k][..., None]
        l = np.where(l < kth, -np.inf, l)
    l = l / temperature
    l = l - l.max(axis=-1, keepdims=True)
    e = np.exp(l)
    return e / e.sum(axis=-1, keepdims=True)


def _spec_cdf_sample(probs: np.ndarray, u: float) -> int:
    """Inverse-CDF draw from one fp64 distribution with uniform ``u``;
    ``u`` scales by the actual mass (fp64 sums are not exactly 1) and the
    index clamps to the vocab."""
    c = np.cumsum(probs)
    return min(int(np.searchsorted(c, u * c[-1], side="right")), len(c) - 1)


def _greedy_accept(argmaxes, d_toks) -> tuple[list[int], int]:
    """Greedy acceptance from the verify window's argmaxes ``[K+1]``:
    accept while the draft token equals the argmax; the first mismatch
    emits the argmax itself (the correction), a clean sweep the bonus
    argmax. Every emitted token is a target argmax."""
    emit: list[int] = []
    for i, d in enumerate(d_toks):
        emit.append(int(argmaxes[i]))
        if emit[-1] != int(d):
            return emit, i
    emit.append(int(argmaxes[len(d_toks)]))
    return emit, len(d_toks)


def _spec_accept(
    vlogits: np.ndarray,            # [K+1, V] fp32 target verify logits
    d_toks: np.ndarray,             # [K] int draft proposals
    q_dists: list[np.ndarray] | None,  # K fp64 draft distributions (None = greedy)
    unis: np.ndarray | None,        # [3K+1] fp64 round uniforms (None = greedy)
    temperature: float,
    top_k: int | None,
) -> tuple[list[int], int]:
    """One row's acceptance rule -> (emitted tokens, accepted count).

    Greedy (``q_dists`` None): :func:`_greedy_accept` on the window's
    argmaxes; the engine calls that itself with ``sample_token``'s
    argmaxes, so this branch is kept for the exact comparison with the
    JAX package's function, which takes both forms. Sampled (the
    Leviathan/Chen rule): accept draft token ``d`` with probability
    ``min(1, p(d)/q(d))``; on rejection resample from ``max(p - q, 0)``
    renormalized; after a clean sweep the bonus token comes from the last
    target distribution. Each decision takes the round uniform reserved
    for it (accept coins at ``[K, 2K)``, residual draws at ``[2K, 3K)``,
    the bonus at ``3K``; the draft's own draws take ``[0, K)``), so the
    emitted tokens are distributed as sequential target sampling."""
    k = len(d_toks)
    if q_dists is None:
        return _greedy_accept(np.asarray(vlogits).argmax(axis=-1), d_toks)
    emit: list[int] = []
    for i in range(k):
        p = _spec_probs(vlogits[i], temperature, top_k)
        d = int(d_toks[i])
        if unis[k + i] * q_dists[i][d] < p[d]:
            emit.append(d)
            continue
        r = np.maximum(p - q_dists[i], 0.0)
        z = float(r.sum())
        # z == 0 only where q dominates p everywhere it lost (an fp64
        # corner of measure zero); p keeps the draw in the target support.
        r = r / z if z > 0.0 else p
        emit.append(_spec_cdf_sample(r, unis[2 * k + i]))
        return emit, i
    p = _spec_probs(vlogits[k], temperature, top_k)
    emit.append(_spec_cdf_sample(p, unis[3 * k]))
    return emit, k


class ServingEngine:
    """Continuous-batching serving engine. See the module docstring.

    Typical loop::

        eng = ServingEngine(params, config, ServeConfig(max_batch=8))
        h = eng.submit(prompt_ids, max_new_tokens=64, seed=0)
        eng.run_until_idle()
        print(h.generated)

    ``params`` are the fp32 master weights (``models/gpt2.py``); the engine
    keeps its own compute-dtype copy on ``device``, which defaults to CUDA
    (there the compute dtype is bf16, the kernels' type). With
    ``serve.spec`` set, ``draft_params``/``draft_config`` are the draft
    model's (strictly fewer params than the target, the same vocab, at
    least its context).
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
        draft_params: dict | None = None,
        draft_config: GPT2Config | None = None,
    ):
        serve = serve if serve is not None else ServeConfig()
        check_generation_args(config, 1, 1, top_k, batch=serve.max_batch)
        _, self._spec_k = serve.spec_axes()
        if self._spec_k:
            if draft_params is None or draft_config is None:
                raise ValueError(
                    f"spec={serve.spec!r} enables speculative decoding but "
                    f"no draft model was provided "
                    f"(draft_params= / draft_config=)"
                )
            if draft_config.num_params() >= config.num_params():
                raise ValueError(
                    f"draft model ({draft_config.num_params():,} params) "
                    f"must be smaller than the target "
                    f"({config.num_params():,} params)"
                )
            if draft_config.vocab_size != config.vocab_size:
                raise ValueError(
                    f"draft vocab_size={draft_config.vocab_size} must match "
                    f"the target's {config.vocab_size}: acceptance compares "
                    f"distributions over one token space"
                )
            if draft_config.n_positions < config.n_positions:
                raise ValueError(
                    f"draft n_positions={draft_config.n_positions} must "
                    f"cover the target's {config.n_positions}: the draft "
                    f"re-encodes the full committed prefix"
                )
        elif draft_params is not None or draft_config is not None:
            raise ValueError(
                "draft model provided but serve.spec is empty — "
                "speculation is opt-in via ServeConfig.spec "
                "('draft:<preset>,k:<K>')"
            )
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
        if self.device.type == "cuda":
            # Build the kernels now (parallel nvcc, skipped once built) so
            # the first request's TTFT never includes a compile.
            build.build(["flash_fwd", "paged_decode", "fused_matmul", "fused_layer"])

        self._m = serve.max_blocks_per_seq(config.n_positions)
        self.k_pool, self.v_pool = init_pools(config, serve, compute_dtype,
                                              self.device)
        self.allocator = BlockAllocator(serve.num_blocks)
        self._cache = PrefixCache(serve.block_size) if serve.prefix_cache else None
        self.draft_config = draft_config
        if self._spec_k:
            # The draft's own weights, pool and tables. Its pool holds a
            # full-context sequence in every slot, so a draft grant never
            # fails. Draft K/V is disposable: rebuilt from the committed
            # tokens (the catch-up) after admission, preemption and
            # adoption, never serialized.
            self.draft_w = gpt2.compute_weights(draft_params, compute_dtype, self.device)
            self._draft_serve = draft_serve_view(serve, config.n_positions)
            self._draft_m = self._draft_serve.max_blocks_per_seq(config.n_positions)
            self.dk_pool, self.dv_pool = init_pools(draft_config, self._draft_serve,
                                                    compute_dtype, self.device)
            self._draft_alloc = BlockAllocator(self._draft_serve.num_blocks)
            self.draft_table = np.zeros((serve.max_batch, self._draft_m), np.int32)
            self._draft_blocks: list[list[int] | None] = [None] * serve.max_batch
            # Positions [0, _draft_pos) of a slot hold draft K/V of its
            # committed tokens; every round ends with it equal to ``pos``,
            # and 0 means a catch-up is due.
            self._draft_pos = np.zeros((serve.max_batch,), np.int64)
        # Scheduler state lives on the host as numpy; each decode step
        # ships it to the device in a few small copies.
        self.block_table = np.zeros((serve.max_batch, self._m), np.int32)
        self.pos = np.zeros((serve.max_batch,), np.int64)
        self.tokens = np.zeros((serve.max_batch,), np.int64)
        self.active = np.zeros((serve.max_batch,), bool)

        self._slots: list[RequestHandle | None] = [None] * serve.max_batch
        self._queue: collections.deque[RequestHandle] = collections.deque()
        self._next_id = 0
        self._admit_seq = 0
        self._deadlines = False
        self.stats = {
            "admitted": 0, "finished": 0, "prefills": 0, "prefill_chunks": 0,
            "prefill_dispatches": 0, "prefill_batched": 0, "decode_steps": 0,
            "tokens_out": 0, "timeouts": 0, "prefix_hit_tokens": 0,
            "cow_copies": 0, "prefill_ms": 0.0, "decode_ms": 0.0,
            "queue_wait_ms": 0.0, "preemptions": 0, "resumes": 0,
            # Chunk dispatches whose decode-written rows attend through
            # the paged attention (K3 once a layer on the card).
            "resume_dispatches": 0,
            # Speculation: proposals, accepted proposals, rounds that
            # rejected one, and the draft and verify walls.
            "spec_draft_tokens": 0, "spec_accepted_tokens": 0,
            "spec_rollbacks": 0, "draft_ms": 0.0, "verify_ms": 0.0,
            # Speculative rounds whose draft catch-up ran (K1's offset
            # form once a draft layer on the card).
            "spec_catchups": 0,
        }
        get_tracer().event("engine_mesh", mesh="single", devices=1, data=1, tp=1)

    @property
    def kv_pool_bytes(self) -> int:
        """Device bytes of the two KV pools."""
        return pool_bytes(self.config, self.serve, self.k_pool.element_size())

    @property
    def kv_pool_bytes_per_device(self) -> int:
        """The pools' bytes on each device the engine spans (one device)."""
        return self.kv_pool_bytes

    # ------------------------------------------------------------- intake

    def _blocks_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        # Positions 0 .. P+max_new-2 get written (the last sampled token is
        # emitted but never processed); worst case ignores early EOS. The
        # formula holds through preemption: a resumed request's work prompt
        # plus its remaining tokens end at the same last position.
        return -(-(prompt_len + max_new_tokens - 1) // self.serve.block_size)

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        *,
        seed: int = 0,
        on_token: Callable[[RequestHandle, int], None] | None = None,
        rid: int | None = None,
        timeout_s: float | None = None,
    ) -> RequestHandle:
        """Queue a request, validated here with the same ValueErrors as
        ``generate_cached``. ``seed`` seeds the request's sampling
        generator; ``rid`` overrides the engine's id counter (a router
        assigns ids unique across its replicas; left None, ids count 0, 1,
        2, ... in submit order); ``timeout_s`` sets a deadline counted from
        submission (queue wait included), after which the request is
        evicted with finish reason ``"timeout"``."""
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
        if rid is None:
            rid = self._next_id
            self._next_id += 1
        req = RequestHandle(rid, prompt, max_new_tokens, on_token)
        req._gen = torch.Generator(device=self.device).manual_seed(int(seed))
        req.submit_time = time.monotonic()
        if timeout_s is not None:
            req.deadline = req.submit_time + timeout_s
            self._deadlines = True
        req._enqueue_time = req.submit_time
        self._queue.append(req)
        get_tracer().event("submit", ts=req.submit_time, rid=req.id,
                           prompt_len=len(prompt), max_new_tokens=max_new_tokens)
        return req

    def _alloc_blocks(self, n: int, floor: int = 0) -> list[int] | None:
        """n blocks while leaving ``floor`` free, evicting unpinned
        prefix-cache entries (LRU) under pressure; None when even that
        does not free enough."""
        while True:
            if self.allocator.available >= n + floor:
                return self.allocator.alloc(n) if n else []
            if self._cache is None or not self._cache.evict_one(self.allocator):
                return None

    def _admit_one(self, slot: int, req: RequestHandle) -> bool:
        """Place the queue head into ``slot``: prefix-cache lookup, block
        grant (reserve or watermark), copy-on-write of a block-aligned fully
        cached prompt's last block, then prefill (inline in whole-prompt
        mode, deferred to ``_prefill_tick`` in chunked mode). A preempted or
        migrated request prefills its work prompt ``prompt +
        generated[:-1]`` through the chunk path. False, with every pin
        undone, when the blocks are not there."""
        bs = self.serve.block_size
        resuming = req._pending_token is not None
        work = np.asarray(req.prompt + req.generated[:-1], np.int32)
        p_work = len(work)
        need_total = self._blocks_needed(len(req.prompt), req.max_new_tokens)
        shared: list[int] = []
        cow_src: int | None = None
        s0 = 0
        if self._cache is not None:
            hits = self._cache.lookup(work, len(req.prompt))
            if hits and len(hits) * bs == p_work:
                # Whole prompt cached and block-aligned: the last block must
                # be private (position p_work - 1 is recomputed for its
                # logits and written back), so it is copied.
                cow_src = hits.pop()
                s0 = p_work - 1
            else:
                s0 = len(hits) * bs
            shared = hits
            # Pin what is reused BEFORE allocating: eviction under pressure
            # takes exactly the unpinned (refcount 1) entries.
            for b in shared + ([cow_src] if cow_src is not None else []):
                self.allocator.retain(b)
        if self.serve.admission == "watermark":
            # What the prefill writes plus the first decode position; the
            # floor keeps room for the rows already decoding to grow.
            n_alloc = min(-(-(p_work + 1) // bs), need_total) - len(shared)
            floor = self.serve.watermark_blocks if self.occupancy else 0
        else:
            n_alloc, floor = need_total - len(shared), 0
        ids = self._alloc_blocks(max(n_alloc, 0), floor)
        if ids is None:
            self.allocator.release(shared + ([cow_src] if cow_src is not None else []))
            return False
        tracer = get_tracer()
        if cow_src is not None:
            copy_block(self.k_pool, self.v_pool, cow_src, ids[0])
            self.allocator.release([cow_src])   # the copy's pin
            self.stats["cow_copies"] += 1
            tracer.event("cow", rid=req.id, src=cow_src, dst=ids[0])

        now = time.monotonic()
        wait_ms = (now - req._enqueue_time) * 1e3
        req.queue_wait_ms += wait_ms
        self.stats["queue_wait_ms"] += wait_ms
        req._admit_order = self._admit_seq
        self._admit_seq += 1
        self.stats["admitted"] += 1
        tracer.event("admit", ts=now, rid=req.id, slot=slot, queue_wait_ms=wait_ms)
        if resuming or (req.generated and req._pending_token is None):
            req.resumes += 1
            self.stats["resumes"] += 1
            tracer.event("resume", ts=now, rid=req.id, slot=slot)
        if s0:
            self.stats["prefix_hit_tokens"] += s0
            if not req.generated:
                req.prefix_cached_tokens = s0
            tracer.event("prefix_hit", ts=now, rid=req.id, tokens=s0)
        blocks = shared + ids
        req._blocks = blocks
        req._work, req._prefill_pos = work, s0
        self._slots[slot] = req
        self.block_table[slot, :] = 0
        self.block_table[slot, :len(blocks)] = blocks
        self.pos[slot] = 0
        self.active[slot] = False
        if self.serve.prefill_chunk == 0:
            # Whole-prompt mode: prefill completes inside admission.
            if s0 == 0 and not resuming:
                self._prefill_whole(slot, req)
            else:
                while self._slots[slot] is req and req._prefill_pos is not None:
                    self._prefill_step(slot, req)
        return True

    def _try_admit(self) -> None:
        """Admit queued requests into free slots, FIFO, while blocks last."""
        while self._queue:
            slot = next((s for s, r in enumerate(self._slots) if r is None), None)
            if slot is None or not self._admit_one(slot, self._queue[0]):
                break   # the head waits; nothing jumps the queue
            self._queue.popleft()

    # ------------------------------------------------------------ prefill

    @torch.no_grad()
    def _prefill_whole(self, slot: int, req: RequestHandle) -> None:
        """Bucketed whole-prompt forward, first-token sample, block scatter
        (fresh admissions with no cache hit; continuations go through the
        chunk path, which starts mid-sequence)."""
        bs = self.serve.block_size
        p = len(req._work)
        nb = -(-p // bs)                       # blocks prefill fills
        pb = nb * bs                           # scatter width
        pf = min(pb, self.config.n_positions)  # forward width
        t0 = time.monotonic()
        prompt = torch.zeros((1, pf), dtype=torch.long)
        prompt[0, :p] = torch.from_numpy(req._work)
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
        dur_ms = (time.monotonic() - t0) * 1e3
        self.stats["prefill_ms"] += dur_ms
        self.stats["prefills"] += 1
        self.stats["prefill_dispatches"] += 1
        get_tracer().event("prefill_chunk", rid=req.id, n_tokens=p, dur_ms=dur_ms,
                           whole=True)
        req._prefill_pos = None
        self._register_prefix(req)
        self._activate(slot, req, p, first_i)

    def _prefill_step(self, slot: int, req: RequestHandle) -> None:
        """Advance one request's prefill by one chunk; whole-prompt mode's
        continuation or resume width is the remainder bucketed to a block
        multiple (a row's bits do not depend on the width)."""
        if self.serve.prefill_chunk:
            width = self.serve.prefill_chunk
        else:
            bs = self.serve.block_size
            width = min(-(-(len(req._work) - req._prefill_pos) // bs) * bs, self._m * bs)
        self._prefill_rows([slot], width, 1)

    @torch.no_grad()
    def _prefill_rows(self, slots: list[int], width: int, pad_rows: int) -> None:
        """Advance each slot's prefill by one chunk of ``width`` in ONE
        dispatch, rows padded to ``pad_rows`` with ``clen = 0``. A request
        whose prefill completes draws its first token here, once; a resume
        draws nothing (its pending token is the decode input). A dispatch
        with no sampled row is not waited for: the decode step queues
        behind it on the stream."""
        r = max(pad_rows, len(slots))
        bt = np.zeros((r, self._m), np.int32)
        chunk = np.zeros((r, width), np.int64)
        start = np.zeros((r,), np.int64)
        clen = np.zeros((r,), np.int64)
        decode_from = np.zeros((r,), np.int64)
        done = []
        for i, slot in enumerate(slots):
            req = self._slots[slot]
            s = req._prefill_pos
            cl = min(width, len(req._work) - s)
            bt[i] = self.block_table[slot]
            chunk[i, :cl] = req._work[s:s + cl]
            start[i], clen[i] = s, cl
            decode_from[i] = len(req.prompt)   # work positions past it: decoded
            if s + cl == len(req._work):
                done.append(i)
        t0 = time.monotonic()
        logits = chunk_prefill(self.w, self.config, self.k_pool, self.v_pool,
                               bt, chunk, start, clen, self.serve.attn_impl,
                               decode_from)
        firsts = {i: sample_token(logits[i:i + 1], [self._slots[slots[i]]._gen],
                                  self.temperature, self.top_k)
                  for i in done if self._slots[slots[i]]._pending_token is None}
        firsts = {i: int(t[0]) for i, t in firsts.items()}   # the device sync, if any
        dur_ms = (time.monotonic() - t0) * 1e3
        self.stats["prefill_ms"] += dur_ms
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_batched"] += max(len(slots) - 1, 0)
        self.stats["resume_dispatches"] += bool((start + clen > decode_from).any())
        tracer = get_tracer()
        for i, slot in enumerate(slots):
            req = self._slots[slot]
            self.stats["prefill_chunks"] += 1
            tracer.event("prefill_chunk", rid=req.id, n_tokens=int(clen[i]),
                         dur_ms=dur_ms, whole=False)
            if i not in done:
                req._prefill_pos += int(clen[i])
                continue
            self.stats["prefills"] += 1
            req._prefill_pos = None
            self._register_prefix(req)
            self._activate(slot, req, len(req._work), firsts.get(i))

    def _activate(self, slot: int, req: RequestHandle, p_work: int,
                  first: int | None) -> None:
        """Prefill done: emit the sampled first token (a fresh request) or
        restore the pending token (a resume: already emitted, already past
        the EOS and length gates; no re-emit, no draw), then open the
        decode row (or evict on EOS or length)."""
        if req._pending_token is not None:
            self.tokens[slot] = req._pending_token
            req._pending_token = None
        else:
            req.generated.append(first)
            self.stats["tokens_out"] += 1
            req._emit(first)
            if self.serve.eos_id is not None and first == self.serve.eos_id:
                self._evict(slot, "eos")
                return
            if len(req.generated) >= req.max_new_tokens:
                self._evict(slot, "length")
                return
            self.tokens[slot] = first
        self.pos[slot] = p_work
        self.active[slot] = True

    def _register_prefix(self, req: RequestHandle) -> None:
        """Hash-cons every full block of the work prompt into the prefix
        cache (first writer wins; hits re-register as no-ops).

        A resume's work prompt holds decode-written positions. On the card
        their K/V carry the decode step's bits (the paged kernel's sum
        order), where a fresh request whose prompt holds the same tokens
        gets the prefill's (the flash kernel's), and its
        ``generate_cached(batch=1)`` reference prefills them too. So a
        block ending past ``len(prompt)`` is keyed by its tokens and the
        prompt length: the request's own later resume reuses it, a fresh
        prompt equal to ``prompt + generated`` does not. The JAX engine,
        whose resume and prefill share one attention, keys by tokens
        alone."""
        if self._cache is None:
            return
        for j in range(len(req._work) // self.serve.block_size):
            self._cache.insert(req._work, j, req._blocks[j], self.allocator,
                               len(req.prompt))

    def _prefill_tick(self) -> None:
        """Chunked mode: advance up to ``prefill_batch`` in-progress
        prefills, oldest admission first, by one chunk each in one
        dispatch, rows padded to ``prefill_batch``."""
        if self.serve.prefill_chunk == 0:
            return
        cands = sorted((req._admit_order, s) for s, req in enumerate(self._slots)
                       if req is not None and req._prefill_pos is not None)
        if cands:
            self._prefill_rows([s for _, s in cands[:self.serve.prefill_batch]],
                               self.serve.prefill_chunk, self.serve.prefill_batch)

    # -------------------------------------------------------------- churn

    def _release_slot(self, slot: int) -> None:
        req = self._slots[slot]
        self.allocator.release(req._blocks)
        req._blocks = None
        req._work, req._prefill_pos = None, None
        self._slots[slot] = None
        # Table row back to the null block; the slot decodes as a no-op
        # (length 0) until the next admission overwrites it.
        self.block_table[slot, :] = 0
        self.pos[slot] = 0
        self.active[slot] = False
        if self._spec_k and self._draft_blocks[slot] is not None:
            # Draft K/V dies with the slot; the next occupant catches up.
            self._draft_alloc.release(self._draft_blocks[slot])
            self._draft_blocks[slot] = None
            self.draft_table[slot, :] = 0
            self._draft_pos[slot] = 0

    def _evict(self, slot: int, reason: str) -> None:
        self._slots[slot]._finish(reason)
        self._release_slot(slot)
        self.stats["finished"] += 1

    def _preempt(self, slot: int) -> None:
        """Swap a request out: free its blocks and requeue it at the head,
        its generated tokens to be recomputed by the resume's prefill. The
        last sampled token (already emitted) is carried as the pending
        decode input, so the resume neither re-emits nor samples; the
        generator stays on the handle where it is."""
        req = self._slots[slot]
        req.preemptions += 1
        self.stats["preemptions"] += 1
        req._pending_token = req.generated[-1] if req.generated else None
        self._release_slot(slot)
        req._enqueue_time = time.monotonic()
        get_tracer().event("preempt", ts=req._enqueue_time, rid=req.id, slot=slot,
                           n_generated=len(req.generated))
        self._queue.appendleft(req)

    def _grow_tables(self) -> None:
        """Watermark mode, before each decode step: every active row about
        to write into an unallocated block gets one. On pool exhaustion the
        NEWEST admission is preempted (possibly a prefilling one) and the
        grant retried; oldest-first order means an old request takes from
        newer ones, never the reverse, so the oldest always runs to
        completion and the engine cannot livelock."""
        bs = self.serve.block_size
        order = sorted((s for s, r in enumerate(self._slots)
                        if r is not None and self.active[s]),
                       key=lambda s: self._slots[s]._admit_order)
        for slot in order:
            req = self._slots[slot]
            if req is None or not self.active[slot]:
                continue    # preempted by an older row's growth
            # The last position the request can ever write bounds the
            # grant, so the final block count equals the reserve grant's;
            # a speculative round writes up to spec_k positions past pos
            # before the next grow.
            last = min(int(self.pos[slot]) + self._spec_k,
                       len(req.prompt) + req.max_new_tokens - 2)
            while last // bs >= len(req._blocks):
                ids = self._alloc_blocks(1)
                if ids is not None:
                    req._blocks.append(ids[0])
                    self.block_table[slot, len(req._blocks) - 1] = ids[0]
                    continue
                victim = max((s for s, r in enumerate(self._slots) if r is not None),
                             key=lambda s: self._slots[s]._admit_order)
                self._preempt(victim)
                if victim == slot:
                    break   # preempted itself (submit guarantees one request fits)

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

    # ---------------------------------------------------------- migration

    def extract_inflight(self) -> list[RequestHandle]:
        """Detach every live request for migration to another engine, in
        admission order (slotted rows first, then the queue), with exactly
        the state ``_preempt`` leaves: generated tokens, the pending decode
        input, and the generator on the handle. ``adopt`` on an engine with
        the same ``ServeConfig`` resumes each stream bit for bit with zero
        re-emitted tokens. Block release is best-effort: the engine may be
        a failed one, whose allocator is not trusted and whose pools are
        abandoned with it; the requests' state is on their handles."""
        out = []
        for slot in sorted((s for s, r in enumerate(self._slots) if r is not None),
                           key=lambda s: self._slots[s]._admit_order):
            req = self._slots[slot]
            req._pending_token = req.generated[-1] if req.generated else None
            try:
                self._release_slot(slot)
            except Exception:
                self._slots[slot] = None
            out.append(req)
        out.extend(self._queue)
        self._queue.clear()
        return out

    def decode_keys(self) -> dict[int, dict]:
        """The generator state of every decoding request, keyed by rid, in
        the wire form's ``"generator"`` shape: what ``extract_inflight``
        would carry for it after this step. Queued and prefilling requests
        are absent: their generators have not moved since they last
        sampled."""
        return {req.id: _generator_state(req._gen)
                for req in self._slots
                if req is not None and req._prefill_pos is None}

    def adopt(self, req: RequestHandle) -> None:
        """Queue a request extracted from another engine (with the same
        ``ServeConfig``; it already passed ``submit``'s gates there). The
        handle carries over whole: id, callback, emitted tokens and
        generator, which must live on this engine's device type."""
        if req._gen is not None and req._gen.device.type != self.device.type:
            raise ValueError(
                f"adopt: request {req.id}'s generator is on {req._gen.device.type}, "
                f"the engine on {self.device.type}"
            )
        req._enqueue_time = time.monotonic()
        if req.deadline is not None:
            self._deadlines = True
        self._queue.append(req)

    def has_work(self) -> bool:
        """Anything queued or in flight."""
        return bool(self._queue) or any(s is not None for s in self._slots)

    @property
    def queue_depth(self) -> int:
        """Requests accepted but not yet admitted to a slot."""
        return len(self._queue)

    @property
    def occupancy(self) -> int:
        """Occupied decode slots (prefilling rows included)."""
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
        dev = self.device
        # Inactive rows (idle, or still prefilling) hold position 0 and get
        # a zeroed table row: they write to the null block 0 and attend to
        # nothing (length 0).
        lengths = np.where(self.active, self.pos + 1, 0).astype(np.int32)
        table = np.where(self.active[:, None], self.block_table, 0).astype(np.int32)
        return decode.paged_decode_step(
            self.w, self.config, torch.from_numpy(self.tokens).to(dev),
            torch.from_numpy(self.pos).to(dev), self.k_pool, self.v_pool,
            torch.from_numpy(table).to(dev), torch.from_numpy(lengths).to(dev),
            impl)

    @torch.no_grad()
    def step(self) -> int:
        """One engine step: evict overdue requests, admit what fits
        (whole-prompt mode prefills each inline), advance one prefill tick
        (chunked mode), grow block tables and preempt under pressure
        (watermark mode), then one decode step for every active row.
        Returns tokens emitted this step."""
        tracer = get_tracer()
        if not tracer.enabled:
            return self._step_impl(tracer)
        with tracer.span("engine_step", n=int(self.stats["decode_steps"])):
            return self._step_impl(tracer)

    def _step_impl(self, tracer) -> int:
        self._evict_overdue()
        emitted_before = self.stats["tokens_out"]
        with tracer.span("admit"):
            self._try_admit()
        with tracer.span("prefill"):
            self._prefill_tick()
        if not self.active.any():
            return self.stats["tokens_out"] - emitted_before
        if self.serve.admission == "watermark":
            with tracer.span("grow"):
                self._grow_tables()
            if not self.active.any():
                return self.stats["tokens_out"] - emitted_before
        if self._spec_k:
            self._spec_round(tracer)
            return self.stats["tokens_out"] - emitted_before

        was_active = self.active.copy()
        with tracer.span("decode", rows=int(was_active.sum())):
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

    def _spec_round(self, tracer) -> None:
        """One speculative round for every active row (K = ``spec_k``):

        1. the draft catch-up, for rows whose draft K/V trails ``pos``
           (fresh admissions, resumes, adoptions): their committed tokens
           through :func:`chunk_prefill` over the draft pool, its logits discarded;
        2. K+1 draft decode steps: step i takes the token at ``pos + i``
           (the pending token, then each proposal) and proposes the next;
           the last one only writes ``d_K``'s K/V, so the draft frontier
           lands on the new ``pos`` whatever is accepted;
        3. one target verify of the window ``[pending, d_1 .. d_K]`` at
           ``pos ..``: :meth:`_verify_logits`, whose logits at a position
           are the decode step's there;
        4. acceptance on the host (``_spec_accept``), then the emit loop
           with the EOS and length gates. A later emission after a stop is
           dropped: sequential decoding never makes it.

        Target K/V written past the accepted prefix stays in the pool,
        past every length that attends to it, until overwritten."""
        k_spec = self._spec_k
        dev = self.device
        act = np.flatnonzero(self.active)        # slot order
        rows = len(act)
        for slot in act:
            if self._draft_blocks[slot] is None:
                ids = self._draft_alloc.alloc(self._draft_m)
                self._draft_blocks[slot] = ids
                self.draft_table[slot, :] = ids
        sampled = self.temperature > 0
        if sampled:
            # 3K+1 uniforms a row, from its request's generator, once a
            # round in slot order: K draft draws, K accept coins, K
            # residual draws and the bonus.
            unis = torch.stack([
                torch.rand(3 * k_spec + 1, dtype=torch.float64, device=dev,
                           generator=self._slots[s]._gen) for s in act]).cpu().numpy()

        t0 = time.monotonic()
        with tracer.span("draft", rows=rows, k=k_spec):
            lag = self.pos[act] - self._draft_pos[act]
            if (lag > 0).any():
                self._draft_catch_up(act[lag > 0])
            pos0 = self.pos[act]
            cap = self._draft_m * self._draft_serve.block_size
            table = torch.from_numpy(self.draft_table[act]).to(dev)
            cur = torch.from_numpy(self.tokens[act]).to(dev)
            d_toks = torch.zeros((rows, k_spec), dtype=torch.long, device=dev)
            q_list: list[np.ndarray] = []
            for i in range(k_spec + 1):
                # Past the context a step writes into the last draft block
                # (paged_decode_step clamps the column) and attends to the
                # whole table, as the JAX draft step does.
                lengths = np.minimum(pos0 + i + 1, cap).astype(np.int32)
                logits = decode.paged_decode_step(
                    self.draft_w, self.draft_config, cur, torch.from_numpy(pos0 + i).to(dev),
                    self.dk_pool, self.dv_pool, table, torch.from_numpy(lengths).to(dev),
                    self.serve.attn_impl)
                if i == k_spec:
                    break     # K/V only: its proposal is never used
                if sampled:
                    q = _spec_probs(logits.cpu().numpy(), self.temperature, self.top_k)
                    q_list.append(q)
                    cur = torch.tensor([_spec_cdf_sample(q[j], unis[j, i])
                                        for j in range(rows)], device=dev)
                else:
                    cur = sample_token(logits, None, 0.0, self.top_k)
                d_toks[:, i] = cur
            d_host = d_toks.cpu().numpy()        # the draft's device sync
        t1 = time.monotonic()
        self.stats["draft_ms"] += (t1 - t0) * 1e3
        self.stats["spec_draft_tokens"] += k_spec * rows

        with tracer.span("verify", rows=rows, k=k_spec):
            vtoks = np.concatenate([self.tokens[act, None], d_host], axis=1)
            logits = self._verify_logits(act, vtoks)
            if sampled:
                vlogits = logits.view(rows, k_spec + 1, -1).cpu().numpy()
            else:
                # The argmax generate_cached takes, ties broken alike.
                argmaxes = sample_token(logits, None, 0.0, self.top_k).view(
                    rows, k_spec + 1).cpu().numpy()          # the device sync
        t2 = time.monotonic()
        self.stats["verify_ms"] += (t2 - t1) * 1e3
        self.stats["decode_ms"] += (t2 - t0) * 1e3
        self.stats["decode_steps"] += 1

        now = time.monotonic()
        for j, slot in enumerate(act):
            req = self._slots[slot]
            if sampled:
                emit, accepted = _spec_accept(vlogits[j], d_host[j],
                                              [q[j] for q in q_list], unis[j],
                                              self.temperature, self.top_k)
            else:
                emit, accepted = _greedy_accept(argmaxes[j], d_host[j])
            self.stats["spec_accepted_tokens"] += accepted
            if accepted < k_spec:
                self.stats["spec_rollbacks"] += 1
            tracer.event("spec_accept", ts=now, rid=req.id, drafted=k_spec,
                         accepted=accepted)
            done = None
            n_emitted = 0
            for t in emit:
                req.generated.append(t)
                n_emitted += 1
                self.stats["tokens_out"] += 1
                req._emit(t)
                if self.serve.eos_id is not None and t == self.serve.eos_id:
                    done = "eos"
                    break
                if len(req.generated) >= req.max_new_tokens:
                    done = "length"
                    break
            if done is not None:
                self._evict(slot, done)
                continue
            self.pos[slot] += n_emitted
            self.tokens[slot] = emit[n_emitted - 1]
            self._draft_pos[slot] = self.pos[slot]

    def _draft_catch_up(self, slots: np.ndarray) -> None:
        """Rebuild the draft K/V of ``slots`` from ``_draft_pos`` up to
        ``pos`` in one chunk pass over the draft pool (its logits
        discarded), the chunk as wide as the longest lag, in whole draft
        blocks."""
        bs = self._draft_serve.block_size
        start = self._draft_pos[slots]
        clen = self.pos[slots] - start
        width = min(-(-int(clen.max()) // bs) * bs, self._draft_m * bs)
        chunk = np.zeros((len(slots), width), np.int64)
        for i, slot in enumerate(slots):
            req = self._slots[slot]
            seq = req.prompt + req.generated
            chunk[i, :clen[i]] = seq[start[i]:start[i] + clen[i]]
        chunk_prefill(self.draft_w, self.draft_config, self.dk_pool, self.dv_pool,
                      self.draft_table[slots], chunk, start, clen, self.serve.attn_impl)
        self.stats["spec_catchups"] += 1

    def _verify_logits(self, slots: np.ndarray, vtoks: np.ndarray,
                       attn_impl: str | None = None) -> torch.Tensor:
        """The target's logits ``[R * (K+1), V]`` fp32 over each slot's
        window ``vtoks[r]`` at positions ``pos_r ..``, in one
        ``paged_decode_step`` over the R x (K+1) rows flattened: row (r, i)
        carries ``vtoks[r, i]`` at ``pos_r + i`` with its slot's table row
        and length ``pos_r + i + 1``. Every row's K/V are written before
        the layer's one paged attention, and a row's result does not
        depend on its batch mates (K3, K7's forward and K4 are
        row-invariant on the card), so each row's logits are, bit for
        bit, the decode step's at that position.

        Rows past the request's grant (a zero table entry) write into the
        null block and attend through it, as the JAX verify does; they
        predict tokens past the request's last one, so they move only the
        acceptance counters. Rows at or past ``n_positions`` idle: length
        0 over the null block (a write at the clamped column would land in
        the last real block; JAX drops it and attends the row over the
        whole table, so a round that reaches the context end may count
        its acceptances differently). ``attn_impl`` overrides
        ``ServeConfig.attn_impl``, as in :meth:`decode_logits`."""
        impl = self.serve.attn_impl if attn_impl is None else attn_impl
        r, t = vtoks.shape
        vpos = self.pos[slots, None] + np.arange(t)[None]             # [R, K+1]
        tab = self.block_table[slots]                                 # [R, M]
        live = vpos < self.config.n_positions
        table = np.where(live[..., None], tab[:, None], 0).reshape(r * t, self._m)
        lengths = np.where(live, vpos + 1, 0).reshape(-1).astype(np.int32)
        dev = self.device
        return decode.paged_decode_step(
            self.w, self.config, torch.from_numpy(vtoks.reshape(-1)).to(dev),
            torch.from_numpy(vpos.reshape(-1)).to(dev), self.k_pool, self.v_pool,
            torch.from_numpy(np.ascontiguousarray(table)).to(dev),
            torch.from_numpy(lengths).to(dev), impl)

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
            "preempted": float(self.stats["preemptions"]),
            "prefix_cached_tokens": float(self.stats["prefix_hit_tokens"]),
            "serve_queue_depth": float(len(self._queue)),
            "serve_occupancy": float(self.occupancy),
            "kv_pool_bytes": float(self.kv_pool_bytes),
            "prefill_batched": float(self.stats["prefill_batched"]),
            "decode_steps": float(self.stats["decode_steps"]),
            "tokens_out": float(self.stats["tokens_out"]),
            "spec_draft_tokens": float(self.stats["spec_draft_tokens"]),
            "spec_accepted_tokens": float(self.stats["spec_accepted_tokens"]),
            "spec_rollbacks": float(self.stats["spec_rollbacks"]),
            "draft_ms": float(self.stats["draft_ms"]),
            "verify_ms": float(self.stats["verify_ms"]),
        }

    @property
    def prefix_cache(self) -> PrefixCache | None:
        """The engine's prefix cache (None when ``prefix_cache`` is off)."""
        return self._cache

    def clear_prefix_cache(self) -> None:
        """Drop every unpinned prefix-cache entry and return its blocks."""
        if self._cache is not None:
            self._cache.clear(self.allocator)
