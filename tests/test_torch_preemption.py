"""Watermark admission, preemption with a recompute resume, and the
migration surface of the port's serving engine on the CPU: greedy streams,
preemption and resume counts, prefix-cache hits and the allocator's final
count equal to the JAX engine's in its watermark and churn scenarios;
sampled, preempted and migrated streams equal to the port's
``generate_cached(batch=1)`` with no token emitted twice; the request wire
form through JSON; the registration rule that keeps decode-written blocks
from fresh prompts; the decode-written rows of a resume's chunk through
the paged attention; and ``--admission``/``--watermark_blocks`` through
the serve CLI. Tiny fp32 configs, one JAX engine per scenario a module."""

from __future__ import annotations

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_2_distributed_tpu.config import ServeConfig as JaxServeConfig
from gpt_2_distributed_tpu.models import gpt2 as jax_gpt2
from gpt_2_distributed_tpu.serving import ServingEngine as JaxServingEngine
from gpt_2_distributed_torch.config import GPT2Config, ServeConfig
from gpt_2_distributed_torch.models import gpt2
from gpt_2_distributed_torch.models.convert import params_from_jax
from gpt_2_distributed_torch.models.decode import generate_cached
from gpt_2_distributed_torch.ops.paged_attention import paged_attention_kernel
from gpt_2_distributed_torch.serving import RequestHandle, ServingEngine, engine
from gpt_2_distributed_torch.serving.engine import REQUEST_WIRE_VERSION, chunk_prefill


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params(tiny_config):
    return jax_gpt2.init_params(tiny_config, seed=0)


@pytest.fixture(scope="module")
def port(jax_params, tiny_config):
    cfg = GPT2Config(vocab_size=tiny_config.vocab_size, n_positions=tiny_config.n_positions,
                     n_embd=tiny_config.n_embd, n_layer=tiny_config.n_layer,
                     n_head=tiny_config.n_head)
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params)), cfg


def _serve(**kw):
    return {"max_batch": 4, "block_size": 8, "num_blocks": 8, "admission": "watermark",
            "watermark_blocks": 1, **kw}


def _engine(port, temperature=0.0, top_k=None, **kw):
    params, cfg = port
    return ServingEngine(params, cfg, ServeConfig(**_serve(**kw)), device="cpu",
                         temperature=temperature, top_k=top_k, compute_dtype=torch.float32)


def _reference(port, prompt, new, seed, temperature=0.0, top_k=None):
    params, cfg = port
    return generate_cached(params, cfg, [prompt], seed=seed, max_new_tokens=new,
                           temperature=temperature, top_k=top_k,
                           compute_dtype=torch.float32, device="cpu")[0, len(prompt):].tolist()


def _counting(counts):
    def on_token(req, tok):
        counts[req.id] = counts.get(req.id, 0) + 1
    return on_token


# The JAX package's scenarios (tests/test_serving.py): six 3-token prompts
# of 14 new tokens over 7 allocatable blocks, and the churn of 8 requests,
# some sharing an 8-token block, with the prefix cache on.
WATERMARK = [([3 * i + 1, 3 * i + 2, 3 * i + 3], 14) for i in range(6)]


def _churn_specs():
    rng = np.random.default_rng(7)
    pfx = list(range(200, 208))
    plens, news = (5, 9, 13, 17), (6, 12)
    specs = []
    for i in range(8):
        pl, nw = plens[i % 4], news[i % 2]
        p = (pfx + rng.integers(1, 257, pl - 8).tolist() if i % 3 != 2 and pl > 8
             else rng.integers(1, 257, pl).tolist())
        specs.append((p, nw))
    return specs


CHURN = _churn_specs()


@pytest.fixture(scope="module")
def jax_runs(jax_params, tiny_config):
    """Each JAX scenario once a module: tokens, per-handle preemptions and
    resumes, and the engine's counts."""
    runs = {}

    def run(name, chunk=0):
        if (name, chunk) not in runs:
            specs, kw = ((WATERMARK, {}) if name == "watermark"
                         else (CHURN, {"prefix_cache": True, "prefill_chunk": chunk}))
            eng = JaxServingEngine(jax_params, tiny_config,
                                   JaxServeConfig(**_serve(attn_impl="xla", **kw)),
                                   temperature=0.0, compute_dtype=jnp.float32)
            hs = [eng.submit(p, n, rng=i) for i, (p, n) in enumerate(specs)]
            eng.run_until_idle(max_steps=2000)
            cached = len(eng._cache) if eng._cache is not None else 0
            runs[name, chunk] = {
                "tokens": [h.generated for h in hs],
                "per_handle": [(h.preemptions, h.resumes) for h in hs],
                "stats": {k: eng.stats[k] for k in ("preemptions", "resumes",
                                                    "prefix_hit_tokens")},
                "available": eng.allocator.available, "cached": cached,
            }
        return runs[name, chunk]

    return run


@pytest.mark.parametrize("name,chunk", [("watermark", 0), ("churn", 0), ("churn", 5)])
def test_greedy_streams_and_counts_equal_the_jax_engine(port, jax_runs, name, chunk):
    """(a) six requests, 7 usable blocks: growth exhausts the pool and
    preempts the newest; (b) the churn with the prefix cache, whole-prompt
    and in chunks of 5. Tokens, preemption and resume counts (per handle
    and in total), prefix-hit tokens and the allocator's final count
    equal the JAX engine's, and nothing is emitted twice."""
    specs, kw = ((WATERMARK, {}) if name == "watermark"
                 else (CHURN, {"prefix_cache": True, "prefill_chunk": chunk}))
    want = jax_runs(name, chunk)
    counts = {}
    eng = _engine(port, **kw)
    hs = [eng.submit(p, n, seed=i, on_token=_counting(counts)) for i, (p, n) in enumerate(specs)]
    eng.run_until_idle(max_steps=2000)
    assert [h.generated for h in hs] == want["tokens"]
    assert [(h.preemptions, h.resumes) for h in hs] == want["per_handle"]
    assert {k: eng.stats[k] for k in want["stats"]} == want["stats"]
    assert eng.stats["preemptions"] > 0 and eng.stats["preemptions"] == eng.stats["resumes"]
    assert eng.metrics_snapshot()["preempted"] == eng.stats["preemptions"]
    assert counts == {h.id: len(h.generated) for h in hs}
    assert all(h.done and h.submit_time <= h.first_token_time <= h.finish_time for h in hs)
    cached = len(eng.prefix_cache) if eng.prefix_cache is not None else 0
    assert (eng.allocator.available, cached) == (want["available"], want["cached"])
    assert eng.allocator.available == eng.serve.num_blocks - 1 - cached
    if name == "churn":
        assert eng.stats["prefix_hit_tokens"] > 0 and eng.stats["resume_dispatches"] > 0
    # CPU tensors never reach a kernel.
    assert paged_attention_kernel.launches == 0


@pytest.mark.parametrize("chunk", [0, 5])
def test_sampled_churn_streams_equal_generate_cached_batch1(port, chunk):
    """(c) The churn sampled at temperature 0.9, top-k 40: every stream,
    preempted or not, equals the one-request sampler's."""
    eng = _engine(port, temperature=0.9, top_k=40, prefix_cache=True, prefill_chunk=chunk)
    hs = [eng.submit(p, n, seed=1000 + i) for i, (p, n) in enumerate(CHURN)]
    eng.run_until_idle(max_steps=2000)
    assert eng.stats["preemptions"] > 0
    for i, (h, (p, n)) in enumerate(zip(hs, CHURN)):
        assert h.generated == _reference(port, p, n, 1000 + i, 0.9, 40), h.id


@pytest.mark.parametrize("chunk,steps,decoding", [(0, 4, True), (3, 7, True), (3, 2, False)],
                         ids=["whole_mid_decode", "chunked_mid_decode", "chunked_mid_prefill"])
def test_a_resume_draws_nothing_from_the_generator(port, chunk, steps, decoding):
    """(d) One sampled request preempted after ``steps`` engine steps (in
    chunks of 3, two steps are mid-prefill, before the first token): its
    stream equals the unpreempted one's, its generator's state after the
    resume prefill is the state before it (mid-prefill, the prefill draws
    the first token as usual), and no token is emitted twice."""
    prompt, new = [5, 9, 2, 7, 1, 8, 3, 3, 6, 4], 12
    counts = {}
    eng = _engine(port, temperature=1.0, num_blocks=16, prefill_chunk=chunk)
    h = eng.submit(prompt, new, seed=3, on_token=_counting(counts))
    for _ in range(steps):
        eng.step()
    assert bool(h.generated) == decoding
    eng._preempt(0)
    state = h._gen.get_state().clone()
    assert h._pending_token == (h.generated[-1] if h.generated else None)
    while eng._slots[0] is not h or h._prefill_pos is not None:
        eng._try_admit()
        eng._prefill_tick()
    if decoding:
        assert torch.equal(h._gen.get_state(), state)   # the resume drew nothing
    eng.run_until_idle()
    # Preempted before its first token, it is re-admitted as a fresh
    # request: the JAX engine counts no resume then either.
    assert (h.preemptions, h.resumes) == (1, int(decoding))
    assert h.generated == _reference(port, prompt, new, 3, 1.0)
    assert counts[h.id] == len(h.generated) == new


def _wire_handle():
    h = RequestHandle(41, [5, 6, 7], 12)
    h.generated = [9, 8, 7]
    h._gen = torch.Generator().manual_seed(123)
    torch.rand(5, generator=h._gen)   # a generator that has moved
    h._pending_token = 7
    h.deadline = 12345.6
    h.submit_time = 12000.0
    h.first_token_time = 12000.5
    h.queue_wait_ms = 3.25
    h.preemptions = 1
    h.resumes = 1
    h.prefix_cached_tokens = 8
    return h


def test_request_wire_form_through_json():
    """(e) Round trip through JSON: the rebuilt handle's wire form equals the
    first, its generator continues the original's draws; a handle with no
    generator round-trips as None; an unknown version and a generator
    state of another device type are refused."""
    h = _wire_handle()
    w = h.to_wire()
    assert w["v"] == REQUEST_WIRE_VERSION and w["generator"]["device"] == "cpu"
    r = RequestHandle.from_wire(json.loads(json.dumps(w)), device="cpu")
    assert (r.id, r.prompt, r.max_new_tokens, r.generated) == (41, [5, 6, 7], 12, [9, 8, 7])
    assert r._pending_token == 7 and r.deadline == 12345.6
    assert (r.preemptions, r.resumes, r.prefix_cached_tokens) == (1, 1, 8)
    assert r.to_wire() == w
    assert torch.equal(torch.rand(7, generator=r._gen), torch.rand(7, generator=h._gen))

    bare = RequestHandle(1, [2, 3], 4)
    b = RequestHandle.from_wire(json.loads(json.dumps(bare.to_wire())), device="cpu")
    assert b._gen is None and b.generated == [] and b._pending_token is None

    with pytest.raises(ValueError, match="wire version"):
        RequestHandle.from_wire({**w, "v": 99}, device="cpu")
    cuda_state = {"device": "cuda", "state": list(range(16))}
    with pytest.raises(ValueError, match="cuda generator state cannot be adopted on a cpu"):
        RequestHandle.from_wire({**w, "generator": cuda_state}, device="cpu")


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_extract_inflight_and_adopt_resume_every_stream(port, temperature):
    """(f) An engine stopped with requests mid-decode, mid-prefill and
    queued: ``extract_inflight`` (admission order: slots, then the queue)
    through ``to_wire``, JSON and ``from_wire`` into a second engine with
    the same ``ServeConfig``; every stream equals the uninterrupted one
    with zero re-emitted tokens, and ``decode_keys`` held each decoding
    request's generator state as the wire carries it."""
    specs = [([11, 12, 13, 14, 15, 16, 17], 9), (list(range(20, 45)), 6),
             ([3, 4], 8), ([7] * 12, 5), ([1, 2, 3], 4)]
    top_k = 40 if temperature else None
    kw = dict(max_batch=2, num_blocks=32, prefill_chunk=8, prefix_cache=True)
    counts = {}
    src = _engine(port, temperature, top_k, **kw)
    hs = [src.submit(p, n, seed=50 + i, on_token=_counting(counts))
          for i, (p, n) in enumerate(specs)]
    for _ in range(4):
        src.step()
    states = {h._prefill_pos is None for h in src._slots}
    assert states == {True, False} and len(src._queue) == 3   # decoding, prefilling, queued
    keys = src.decode_keys()
    moved = src.extract_inflight()
    assert [h.id for h in moved] == [0, 1, 2, 3, 4] and not src.has_work()
    assert src.allocator.available == src.serve.num_blocks - 1 - len(src.prefix_cache)
    wires = [json.loads(json.dumps(h.to_wire())) for h in moved]
    assert {w["rid"]: w["generator"] for w in wires if w["rid"] in keys} == keys
    dst = _engine(port, temperature, top_k, **kw)
    adopted = [RequestHandle.from_wire(w, _counting(counts), device="cpu") for w in wires]
    for h in adopted:
        dst.adopt(h)
    dst.run_until_idle(max_steps=500)
    for h, (p, n), i in zip(adopted, specs, range(5)):
        assert h.generated == _reference(port, p, n, 50 + i, temperature, top_k), h.id
    assert counts == {i: n for i, (_, n) in enumerate(specs)}   # nothing re-emitted
    assert dst.stats["resumes"] == sum(bool(w["generated"]) for w in wires)


def test_adopt_refuses_a_generator_of_another_device_type(port):
    eng = _engine(port)
    h = RequestHandle(3, [1, 2], 4)
    h._gen = types.SimpleNamespace(device=torch.device("cuda"))   # no card here
    with pytest.raises(ValueError, match="generator is on cuda, the engine on cpu"):
        eng.adopt(h)


def test_decode_written_blocks_are_kept_from_fresh_prompts(port):
    """(g) A request preempted after 12 tokens resumes over ``prompt +
    generated[:-1]``; its blocks holding decode-written positions are
    registered under its prompt length. Its own second resume reuses them;
    a fresh request whose prompt is ``prompt + generated[:10]`` hits only
    the prompt's block, and its stream equals ``generate_cached``."""
    prompt = [31, 41, 59, 26, 53, 58, 97, 93]           # one block of 8
    eng = _engine(port, num_blocks=24, prefix_cache=True)
    a = eng.submit(prompt, 30)
    while len(a.generated) < 12:
        eng.step()
    eng._preempt(0)
    eng.step()                                           # resumed: 8 + 11 work tokens
    assert a.resumes == 1 and eng.stats["prefix_hit_tokens"] == 8
    assert eng.prefix_cache.peek_run(prompt + a.generated[:11], len(prompt)) == 2
    while len(a.generated) < 20:
        eng.step()
    eng._preempt(0)
    eng.step()                                           # its own decode-written block hit
    assert a.resumes == 2 and eng.stats["prefix_hit_tokens"] == 8 + 16
    eng.run_until_idle()
    assert a.generated == _reference(port, prompt, 30, 0)
    fresh = prompt + a.generated[:10]
    assert eng.prefix_cache.peek_run(fresh) == 1
    b = eng.submit(fresh, 6)
    eng.run_until_idle()
    assert b.prefix_cached_tokens == 8
    assert b.generated == _reference(port, fresh, 6, 0)


def test_chunk_prefill_routes_decode_written_rows_through_paged_attention(port, monkeypatch):
    """A resume's chunk with ``decode_from`` inside it: the pools and fp32
    logits equal the chunk attention's for every row within 1e-5 (the two
    attentions agree in fp32; on the card they differ in sum order), and
    the decode-written rows go through ``paged_attention``."""
    params, cfg = port
    w = gpt2.compute_weights(params, torch.float32, torch.device("cpu"))
    rng = np.random.default_rng(5)
    pools = [torch.from_numpy(rng.standard_normal(
        (cfg.n_layer, 12, cfg.n_head, 8, cfg.head_dim)).astype(np.float32)) for _ in range(2)]
    bt = np.zeros((2, 8), np.int32)
    bt[0, :4], bt[1, :3] = [3, 7, 1, 9], [2, 5, 11]
    chunk = rng.integers(0, cfg.vocab_size, (2, 16))
    start, clen = np.array([6, 0]), np.array([16, 13])
    real, calls = engine.paged_attention, []
    monkeypatch.setattr(engine, "paged_attention",
                        lambda q, *a, **k: calls.append(q.shape[0]) or real(q, *a, **k))
    out = {}
    for name, decode_from in (("chunk", None), ("routed", np.array([10, 9]))):
        kp, vp = pools[0].clone(), pools[1].clone()
        out[name] = (chunk_prefill(w, cfg, kp, vp, bt, chunk, start, clen, "auto",
                                   decode_from), kp, vp)
    assert calls == [12 + 4] * cfg.n_layer   # rows 10..21 of row 0, 9..12 of row 1
    for got, want in zip(out["routed"], out["chunk"]):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_cli_admission_watermark_reports_preemptions(tmp_path, capsys):
    """(h) ``--admission watermark --watermark_blocks 2``: the two flags keep
    the JAX CLI's types, choices and defaults, reach the engine, and the
    summary line counts the preemptions the final records report."""
    from gpt_2_distributed_tpu.serving import serve as jax_serve
    from gpt_2_distributed_torch.serving import serve

    jax_actions = {a.dest: a for a in jax_serve.build_argparser()._actions}
    for a in serve.build_argparser()._actions:
        if a.dest in ("admission", "watermark_blocks"):
            want = jax_actions[a.dest]
            assert (a.default, a.type, a.choices, a.nargs) == (want.default, want.type,
                                                               want.choices, want.nargs)
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text("\n".join(json.dumps({"prompt_ids": [3 * i + 1, 3 * i + 2], "new": 14})
                              for i in range(4)))
    serve.main(["--device", "cpu", "--init_random", "--n_layer", "1", "--n_embd", "32",
                "--n_head", "2", "--vocab_size", "257", "--seq_len", "32",
                "--max_batch", "3", "--block_size", "4", "--num_blocks", "12",
                "--temperature", "0", "--admission", "watermark", "--watermark_blocks", "2",
                "--requests", str(reqs)])
    out = capsys.readouterr()
    finals = [json.loads(x) for x in out.out.splitlines()]
    preempted = sum(f["preempted"] for f in finals)
    assert preempted > 0 and [len(f["generated"]) for f in finals] == [14] * 4
    assert f"{preempted} preemptions" in out.err
