"""The port's prefix cache and chunked, batched prefill on the CPU: the
refcounted allocator and ``PrefixCache`` run through the same scenarios as
the JAX package's with the same results, greedy engine streams with the
cache on and every chunk and batch setting equal to the JAX engine's
tokens with its ``prefix_hit_tokens`` and ``cow_copies``, sampled streams
equal to the port's ``generate_cached(batch=1)``, the copy-on-write of a
block-aligned fully cached prompt, LRU eviction under pool pressure, and
the three options through ``ServeConfig`` and the serve CLI."""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_2_distributed_tpu.config import ServeConfig as JaxServeConfig
from gpt_2_distributed_tpu.models import gpt2 as jax_gpt2
from gpt_2_distributed_tpu.serving import BlockAllocator as JaxBlockAllocator
from gpt_2_distributed_tpu.serving import PrefixCache as JaxPrefixCache
from gpt_2_distributed_tpu.serving import ServingEngine as JaxServingEngine
from gpt_2_distributed_torch.config import GPT2Config, ServeConfig
from gpt_2_distributed_torch.models.convert import params_from_jax
from gpt_2_distributed_torch.models.decode import generate_cached
from gpt_2_distributed_torch.serving import BlockAllocator, PrefixCache, ServingEngine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------ allocator and cache units


def _refcounts(alloc_cls, cache_cls):
    a = alloc_cls(8)
    [b] = a.alloc(1)
    out = [a.refcount(b)]
    a.retain(b)
    out.append(a.refcount(b))
    a.release([b])                  # the writer is done; the cache holds it
    out += [a.refcount(b), a.available]
    a.release([b])
    out += [a.refcount(b), a.available]
    for bad in (lambda: a.release([b]), lambda: a.retain(b), lambda: a.release([0])):
        with pytest.raises(ValueError) as e:
            bad()
        out.append(str(e.value))
    return out


def _longest_run(alloc_cls, cache_cls):
    a, c = alloc_cls(16), cache_cls(4)
    toks = list(range(12))          # exactly 3 full blocks
    ids = a.alloc(3)
    out = [c.insert(toks, j, b, a) for j, b in enumerate(ids)]
    out.append([a.refcount(b) for b in ids])
    out.append(c.peek_run(toks))
    out += [c.lookup(toks), c.lookup(toks[:4] + [99] * 8), c.lookup(toks[:3]),
            c.lookup([99] + toks[1:])]
    out += [c.insert(toks, 0, ids[0], a), a.refcount(ids[0]), c.hits, c.misses]
    return out


def _evict_pinned(alloc_cls, cache_cls):
    a, c = alloc_cls(16), cache_cls(4)
    toks = list(range(8))
    ids = a.alloc(2)
    for j, b in enumerate(ids):
        c.insert(toks, j, b, a)
    a.release([ids[0]])             # a request dropped block 0 only
    out = [c.evict_one(a), a.refcount(ids[0]), c.evict_one(a), len(c)]
    a.release([ids[1]])
    c.clear(a)
    return out + [len(c), a.available, c.evictions]


def _lru_order(alloc_cls, cache_cls):
    a, c = alloc_cls(16), cache_cls(2)
    [b1] = a.alloc(1)
    c.insert([1, 2], 0, b1, a)
    a.release([b1])
    [b2] = a.alloc(1)
    c.insert([3, 4], 0, b2, a)
    a.release([b2])
    out = [c.peek_run([3, 4])]      # a probe does not reorder
    out.append(c.lookup([1, 2]))    # a use does: b2 is now the LRU entry
    out += [c.evict_one(a), a.refcount(b2), a.refcount(b1)]
    return out


@pytest.mark.parametrize("scenario", [_refcounts, _longest_run, _evict_pinned, _lru_order],
                         ids=lambda f: f.__name__.strip("_"))
def test_allocator_and_cache_match_the_jax_package(scenario):
    want = scenario(JaxBlockAllocator, JaxPrefixCache)
    got = scenario(BlockAllocator, PrefixCache)
    assert got == want
    if scenario is _longest_run:
        ids = got[5]
        assert got[:5] == [True, True, True, [2, 2, 2], 3] and got[6] == ids[:1]
        assert got[7] == got[8] == [] and got[9] is False and got[10] == 2
    if scenario is _evict_pinned:
        assert got == [True, 0, False, 1, 0, 15, 2]


# ------------------------------------------------------------- the engines

# A 16-token shared prefix (two blocks of 8) served first, then eight
# requests together: sharers with suffixes of 1 to 30 tokens, one of which
# shares 40 tokens with the first sharer (a hit that whole-prompt mode
# registers in time and chunked mode, admitting both at once, does not),
# the prefix alone (block-aligned full hit: copy-on-write), an 8-token
# prefix of the prefix (aligned one-block hit) and a stranger. Four slots,
# so the queue admits the last ones as earlier ones finish.
PREFIX = [int(t) for t in np.random.default_rng(0).integers(0, 257, 16)]
SUFFIXES = [[9] * 30, [5, 6, 7], [9] * 24 + [7], [], [1], list(range(40, 51)), None]
PROMPTS = [PREFIX] + [PREFIX + s if s is not None else PREFIX[:8] for s in SUFFIXES] + [
    [3, 1, 4, 1, 5, 9, 2, 6, 5]]
NEWS = [4, 6, 5, 7, 5, 3, 8, 6, 5]
SETTINGS = [(0, 1), (0, 2), (3, 1), (3, 2), (16, 1), (16, 2)]


def _serve(**kw):
    return {"max_batch": 4, "block_size": 8, "num_blocks": 40, "prefix_cache": True, **kw}


def _drive(eng, submit):
    """The first request alone to completion, then the rest together."""
    first = submit(eng, 0)
    eng.run_until_idle(max_steps=300)
    rest = [submit(eng, i) for i in range(1, len(PROMPTS))]
    eng.run_until_idle(max_steps=300)
    return [first] + rest


@pytest.fixture(scope="module")
def jax_params(tiny_config):
    return jax_gpt2.init_params(tiny_config, seed=0)


@pytest.fixture(scope="module")
def port(jax_params, tiny_config):
    cfg = GPT2Config(vocab_size=tiny_config.vocab_size, n_positions=tiny_config.n_positions,
                     n_embd=tiny_config.n_embd, n_layer=tiny_config.n_layer,
                     n_head=tiny_config.n_head)
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params)), cfg


@pytest.fixture(scope="module")
def jax_runs(jax_params, tiny_config):
    """The JAX engine's streams and cache stats, one engine per chunk
    setting, each run once for the module."""
    runs = {}

    def run(chunk, batch):
        if (chunk, batch) not in runs:
            eng = JaxServingEngine(jax_params, tiny_config,
                                   JaxServeConfig(**_serve(attn_impl="xla", prefill_chunk=chunk,
                                                           prefill_batch=batch)),
                                   temperature=0.0, compute_dtype=jnp.float32)
            handles = _drive(eng, lambda e, i: e.submit(PROMPTS[i], NEWS[i], rng=i))
            runs[chunk, batch] = ([h.generated for h in handles],
                                  [h.prefix_cached_tokens for h in handles],
                                  {k: eng.stats[k] for k in ("prefix_hit_tokens", "cow_copies",
                                                             "prefill_dispatches",
                                                             "prefill_batched")})
        return runs[chunk, batch]

    return run


@pytest.mark.parametrize("chunk,batch", SETTINGS)
def test_greedy_streams_and_cache_stats_equal_the_jax_engine(port, jax_runs, chunk, batch):
    """Whole-prompt mode (prefill_batch plays no part there, so (0, 2) is
    held to the JAX engine's (0, 1) run) and chunks of 3 and 16, one or two
    prefills a step: the port's tokens, per-request cached tokens, hit
    tokens, copies, dispatches and batched rows equal the JAX engine's."""
    params, cfg = port
    eng = ServingEngine(params, cfg, ServeConfig(**_serve(prefill_chunk=chunk,
                                                          prefill_batch=batch)),
                        device="cpu", temperature=0.0, compute_dtype=torch.float32)
    handles = _drive(eng, lambda e, i: e.submit(PROMPTS[i], NEWS[i], seed=i))
    tokens, cached, stats = jax_runs(chunk, 1 if chunk == 0 else batch)
    assert [h.generated for h in handles] == tokens
    assert [h.prefix_cached_tokens for h in handles] == cached
    assert {k: eng.stats[k] for k in stats} == stats
    assert stats["prefix_hit_tokens"] > 0 and stats["cow_copies"] >= 1
    snap = eng.metrics_snapshot()
    assert snap["prefix_cached_tokens"] == stats["prefix_hit_tokens"]
    assert snap["prefill_batched"] == stats["prefill_batched"]
    # Every request's blocks came back; only the cache's entries are held.
    held = len(eng.prefix_cache)
    assert eng.allocator.available == eng.serve.num_blocks - 1 - held
    eng.clear_prefix_cache()
    assert eng.allocator.available == eng.serve.num_blocks - 1 and len(eng.prefix_cache) == 0


@pytest.mark.parametrize("chunk,batch", [(0, 1), (3, 2), (16, 1)])
def test_sampled_streams_equal_generate_cached_batch1(port, chunk, batch):
    """Each request's generator is drawn once, on its final chunk: chunked
    and cache-hit streams equal the one-request sampler's."""
    params, cfg = port
    refs = [generate_cached(params, cfg, [p], seed=100 + i, max_new_tokens=n,
                            temperature=0.9, top_k=40, device="cpu")[0, len(p):].tolist()
            for i, (p, n) in enumerate(zip(PROMPTS, NEWS))]
    eng = ServingEngine(params, cfg, ServeConfig(**_serve(prefill_chunk=chunk,
                                                          prefill_batch=batch)),
                        device="cpu", temperature=0.9, top_k=40)
    handles = _drive(eng, lambda e, i: e.submit(PROMPTS[i], NEWS[i], seed=100 + i))
    assert [h.generated for h in handles] == refs
    assert eng.stats["prefix_hit_tokens"] > 0


def test_cow_of_an_aligned_cached_prompt_keeps_the_shared_block(port):
    """The prefix alone again: its last block is copied, position 15 is
    recomputed into the copy, and the cached block's bits stay as they
    were; the stream equals the first run's."""
    params, cfg = port
    eng = ServingEngine(params, cfg, ServeConfig(**_serve()), device="cpu", temperature=0.0)
    a = eng.submit(PREFIX, 6)
    eng.run_until_idle()
    src = eng.prefix_cache.lookup(PREFIX)[-1]
    before = eng.k_pool[:, src].clone(), eng.v_pool[:, src].clone()
    b = eng.submit(PREFIX, 6)
    eng.step()                        # admitted: the copy is made and position 15 rewritten
    dst = int(eng.block_table[0, 1])  # slot 0's second block: the copy
    assert dst != src and eng.stats["cow_copies"] == 1
    assert b.prefix_cached_tokens == 15 and eng.stats["prefix_hit_tokens"] == 15
    eng.run_until_idle()
    assert torch.equal(eng.k_pool[:, src], before[0]) and torch.equal(eng.v_pool[:, src], before[1])
    assert b.generated == a.generated
    assert eng.allocator.refcount(src) == 1        # the cache's reference only


def test_lru_eviction_lets_a_blocked_head_admit(port):
    """A pool of 9 usable blocks: after two requests leave their blocks to
    the cache, the third needs more than the free list holds; evicting
    unpinned entries (oldest first) admits it, and its stream is exact."""
    params, cfg = port
    serve = ServeConfig(**_serve(num_blocks=10))
    eng = ServingEngine(params, cfg, serve, device="cpu", temperature=0.0)
    first = eng.submit(list(range(1, 25)), 2)       # 3 full blocks cached
    eng.run_until_idle()
    second = eng.submit(list(range(100, 124)), 2)   # 3 more
    eng.run_until_idle()
    assert len(eng.prefix_cache) == 6 and eng.allocator.available == 3
    third = eng.submit(list(range(200, 240)), 8)    # 47 positions: 6 blocks
    eng.run_until_idle()
    assert third.finish_reason == "length" and eng.prefix_cache.evictions == 3
    # The oldest entries went: the first prompt's blocks, not the second's.
    assert eng.prefix_cache.peek_run(list(range(1, 25))) == 0
    assert eng.prefix_cache.peek_run(list(range(100, 124))) == 3
    ref = generate_cached(params, cfg, [list(range(200, 240))], max_new_tokens=8,
                          temperature=0.0, device="cpu")[0, 40:].tolist()
    assert third.generated == ref and first.done and second.done


@pytest.mark.parametrize("option", [{"prefill_chunk": 4}, {"prefix_cache": True},
                                    {"prefill_batch": 2},
                                    {"prefill_chunk": 16, "prefix_cache": True,
                                     "prefill_batch": 3}])
def test_serve_config_accepts_the_ported_options(option):
    serve = ServeConfig(max_batch=4, **option)
    assert all(getattr(serve, k) == v for k, v in option.items())
    with pytest.raises(ValueError, match="later slice"):
        ServeConfig(mesh="data:2", **option)


def test_cli_serves_with_prefix_cache_and_chunks(tmp_path, capsys):
    """``--prefix_cache --prefill_chunk 3 --prefill_batch 2``: the flags
    keep the JAX CLI's types and defaults, reach the engine, and a request
    that shares the first one's prefix reports its cached tokens."""
    from gpt_2_distributed_tpu.serving import serve as jax_serve
    from gpt_2_distributed_torch.serving import serve

    jax_actions = {a.dest: a for a in jax_serve.build_argparser()._actions}
    for a in serve.build_argparser()._actions:
        if a.dest in ("prefix_cache", "prefill_chunk", "prefill_batch"):
            want = jax_actions[a.dest]
            assert (a.default, a.type, a.nargs) == (want.default, want.type, want.nargs)
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text("\n".join(json.dumps({"prompt_ids": p, "new": 3, "seed": i})
                              for i, p in enumerate([PREFIX, PREFIX + [1, 2]])))
    serve.main(["--device", "cpu", "--init_random", "--n_layer", "1", "--n_embd", "32",
                "--n_head", "2", "--vocab_size", "257", "--seq_len", "64",
                "--max_batch", "1", "--block_size", "8", "--temperature", "0",
                "--prefix_cache", "--prefill_chunk", "3", "--prefill_batch", "1",
                "--requests", str(reqs)])
    finals = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [f["prefix_cached_tokens"] for f in finals] == [0, 16]
    assert [len(f["generated"]) for f in finals] == [3, 3]
    with pytest.raises(SystemExit):
        serve.main(["--init_random", "--device", "cpu", "--max_batch", "2",
                    "--prefill_batch", "3", "--requests", str(reqs)])
