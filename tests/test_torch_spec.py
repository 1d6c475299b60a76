"""Speculative decoding in the port's serving engine on the CPU, held
against the JAX package: the host acceptance rule (``_spec_probs``,
``_spec_cdf_sample``, ``_spec_accept``) equal to JAX's on seeded inputs,
the JAX package's Monte-Carlo marginal and engine histogram checks
against the port, ``parse_serve_spec``, the engine's and the CLIs'
refusals with JAX's texts (the CLIs with ``jax`` poisoned), the draft
pool's view, greedy streams and spec counters equal to the JAX
speculative engine's and to ``generate_cached(batch=1)`` for k = 1, 2, 4,
under chunked prefill with prefix hits and under watermark preemption,
with a self-slice draft that accepts, migration across the spec/plain boundary both ways, a request that ends
at the last context position, the verify window through the paged
attention only, ``--draft_ckpt``, and the spans, events and
``speculation_summary``. Tiny fp32 configs with a one-layer draft whose
params are converted from the JAX draft's; one JAX engine a scenario a
module."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_2_distributed_tpu import config as jax_config
from gpt_2_distributed_tpu.models import gpt2 as jax_gpt2
from gpt_2_distributed_tpu.serving import ServingEngine as JaxServingEngine
from gpt_2_distributed_tpu.serving import engine as jax_engine
from gpt_2_distributed_tpu.serving.paged_cache import draft_serve_view as jax_draft_view
from gpt_2_distributed_torch import config
from gpt_2_distributed_torch.config import GPT2Config, ServeConfig, parse_serve_spec
from gpt_2_distributed_torch.models import decode
from gpt_2_distributed_torch.models.convert import params_from_jax
from gpt_2_distributed_torch.models.decode import generate_cached
from gpt_2_distributed_torch.obs import trace
from gpt_2_distributed_torch.serving import ServingEngine, engine
from gpt_2_distributed_torch.serving.paged_cache import draft_serve_view

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_config(c) -> GPT2Config:
    return GPT2Config(vocab_size=c.vocab_size, n_positions=c.n_positions, n_embd=c.n_embd,
                      n_layer=c.n_layer, n_head=c.n_head)


def _convert(jax_params) -> dict:
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))


@pytest.fixture(scope="module")
def models(tiny_config):
    """The JAX target and one-layer draft (seeds 0 and 1), and the port's
    copies of both; under "slice", the same with the JAX self-slice draft
    (the target's first layer with its embeddings and final LayerNorm),
    which accepts most of its tokens."""
    jax_draft_config = tiny_config.replace(n_layer=1)
    jp = jax_gpt2.init_params(tiny_config, seed=0)
    jdp = jax_gpt2.init_params(jax_draft_config, seed=1)
    jsp = dict(jp, block=jax.tree_util.tree_map(lambda a: a[:1], jp["block"]))
    port = (_convert(jp), _port_config(tiny_config))
    return {
        "jax": (jp, tiny_config, jdp, jax_draft_config),
        "port": port + (_convert(jdp), _port_config(jax_draft_config)),
        "slice": {"jax": (jp, tiny_config, jsp, jax_draft_config),
                  "port": port + (_convert(jsp), _port_config(jax_draft_config))},
    }


PROMPTS = [list(map(int, np.random.default_rng(3).integers(1, 256, size=n)))
           for n in (5, 11, 17, 3)]


def _serve_kw(**kw) -> dict:
    return {"max_batch": 4, "block_size": 8, "num_blocks": 32, **kw}


def _port_engine(models, temperature=0.0, top_k=None, draft=True, **kw):
    params, cfg, dparams, dcfg = models["port"]
    extra = {"draft_params": dparams, "draft_config": dcfg} if draft else {}
    return ServingEngine(params, cfg, ServeConfig(**_serve_kw(**kw)), device="cpu",
                         temperature=temperature, top_k=top_k,
                         compute_dtype=torch.float32, **extra)


def _reference(models, prompt, new):
    params, cfg, _, _ = models["port"]
    return generate_cached(params, cfg, [prompt], max_new_tokens=new, temperature=0.0,
                           compute_dtype=torch.float32, device="cpu")[0, len(prompt):].tolist()


COUNTERS = ("spec_draft_tokens", "spec_accepted_tokens", "spec_rollbacks", "decode_steps",
            "preemptions", "resumes", "prefix_hit_tokens")


def _scenario(name: str):
    """(serve kwargs, request batches, new tokens) of the JAX package's
    scenarios (tests/test_serving_spec.py): k = 1, 2, 4; chunked prefill
    with an 8-token shared prefix, the first request alone; watermark
    preemption over a 17-token shared prefix, in a pool of 8 blocks (the
    JAX test's 16 preempt nothing) so that two requests are preempted and
    resumed; the self-slice draft at k = 2, 4, 12 tokens a request."""
    if name.startswith("k"):
        return {"spec": f"draft:124M,k:{name[1:]}"}, [PROMPTS], 8
    if name.startswith("slice"):
        return {"spec": f"draft:124M,k:{name[-1]}"}, [PROMPTS], 12
    if name == "chunked":
        reqs = [PROMPTS[1][:8] + p for p in PROMPTS]
        return ({"spec": "draft:124M,k:2", "prefill_chunk": 8, "prefix_cache": True},
                [reqs[:1], reqs[1:]], 8)
    reqs = [PROMPTS[2] + p for p in PROMPTS]
    return ({"num_blocks": 8, "spec": "draft:124M,k:2", "prefill_chunk": 8,
             "prefix_cache": True, "admission": "watermark", "watermark_blocks": 1},
            [reqs], 12)


SCENARIOS = ("k1", "k2", "k4", "chunked", "watermark", "slice_k2", "slice_k4")


def _drive(eng, batches, new, submit):
    hs = []
    for batch in batches:
        hs += [submit(eng, p, new, len(hs)) for p in batch]
        eng.run_until_idle(max_steps=1000)
    return hs


@pytest.fixture(scope="module")
def jax_runs(models):
    """Each scenario through the JAX speculative engine once a module."""
    runs = {}

    def run(name):
        if name not in runs:
            kw, batches, new = _scenario(name)
            jp, jcfg, jdp, jdcfg = (models["slice"] if name.startswith("slice")
                                    else models)["jax"]
            eng = JaxServingEngine(jp, jcfg, jax_config.ServeConfig(**_serve_kw(
                attn_impl="xla", **kw)), temperature=0.0, compute_dtype=jnp.float32,
                draft_params=jdp, draft_config=jdcfg)
            hs = _drive(eng, batches, new, lambda e, p, n, i: e.submit(p, n, rng=i))
            runs[name] = ([h.generated for h in hs], [h.preemptions for h in hs],
                          {k: eng.stats[k] for k in COUNTERS})
        return runs[name]

    return run


# ------------------------------------------------------- host acceptance


def _accept_case(kind: str, seed: int):
    """Seeded inputs of one round at K = 3 over a vocab of 11."""
    rng = np.random.default_rng(seed)
    k, v = 3, 11
    vlogits = (rng.normal(size=(k + 1, v)) * 2).astype(np.float32)
    if kind == "greedy":
        d = vlogits[:k].argmax(-1).astype(np.int32)
        d[rng.integers(0, k + 1):] = rng.integers(0, v)   # a mismatch somewhere, or none
        return vlogits, d, None, None, 0.0, None
    top_k = 4 if kind == "top_k" else None
    qlogits = rng.normal(size=(k, v)) * 1.5
    if seed % 3 == 0:
        qlogits[:] = vlogits[:k]          # a draft equal to the target: all accepted
    unis = rng.random(3 * k + 1)
    q = [jax_engine._spec_probs(qlogits[i], 1.0, top_k) for i in range(k)]
    d = np.array([jax_engine._spec_cdf_sample(q[i], unis[i]) for i in range(k)], np.int32)
    return vlogits, d, q, unis, 1.0, top_k


@pytest.mark.parametrize("kind", ["greedy", "sampled", "top_k"])
def test_acceptance_rule_equals_the_jax_one(kind):
    """``_spec_probs``, ``_spec_cdf_sample`` and ``_spec_accept`` give the
    JAX functions' results exactly, over 200 seeded rounds each."""
    outcomes = set()
    for seed in range(200):
        vlogits, d, q, unis, temp, top_k = _accept_case(kind, seed)
        if q is not None:
            for i in range(len(d)):
                want = jax_engine._spec_probs(vlogits[i], temp, top_k)
                assert np.array_equal(engine._spec_probs(vlogits[i], temp, top_k), want)
                assert (engine._spec_cdf_sample(want, unis[i])
                        == jax_engine._spec_cdf_sample(want, unis[i]))
        got = engine._spec_accept(vlogits, d, q, unis, temp, top_k)
        assert got == jax_engine._spec_accept(vlogits, d, q, unis, temp, top_k)
        outcomes.add(got[1])
    assert outcomes == {0, 1, 2, 3}     # every accepted count, the clean sweep too


def test_accept_resample_marginal_is_target_distribution():
    """The JAX package's fp64 Monte-Carlo pin, on the port's rule: the
    first emitted token of a k = 1 round is distributed as p (TV < 0.02
    over 20000 trials) and the acceptance rate is sum(min(p, q)); with
    top_k 3 every emitted token stays in the target's support."""
    rng = np.random.default_rng(0)
    vocab = 7
    vlogits = rng.normal(size=(2, vocab)).astype(np.float32) * 2.0
    q = engine._spec_probs(rng.normal(size=vocab) * 1.5, 1.0, None)
    p = engine._spec_probs(vlogits[0], 1.0, None)
    trials = 20_000
    unis = rng.random((trials, 4))
    counts = np.zeros(vocab)
    accepted_total = 0
    for t in range(trials):
        d = engine._spec_cdf_sample(q, unis[t, 0])
        emit, accepted = engine._spec_accept(vlogits, np.array([d]), [q], unis[t], 1.0, None)
        counts[emit[0]] += 1
        accepted_total += accepted
    tv = 0.5 * np.abs(counts / trials - p).sum()
    assert tv < 0.02, (tv, counts / trials, p)
    assert accepted_total / trials == pytest.approx(float(np.minimum(p, q).sum()), abs=0.02)

    rng = np.random.default_rng(1)
    vlogits = rng.normal(size=(2, 9)).astype(np.float32)
    q = engine._spec_probs(rng.normal(size=9), 1.0, 3)
    support = set(np.flatnonzero(engine._spec_probs(vlogits[0], 1.0, 3) > 0).tolist())
    for _ in range(2_000):
        u = rng.random(4)
        d = engine._spec_cdf_sample(q, u[0])
        assert engine._spec_accept(vlogits, np.array([d]), [q], u, 1.0, 3)[0][0] in support


def test_sampled_engine_distribution_matches_plain():
    """The JAX package's engine-level check on the port: over 200 requests
    of 4 tokens at temperature 1.0 and vocab 13, the pooled histogram of a
    speculative engine (k = 2, a one-layer draft) is within TV 0.15 of a
    plain engine's. Both models take the port's own seeded init."""
    from gpt_2_distributed_torch.models import gpt2

    cfg = GPT2Config(vocab_size=13, n_positions=32, n_embd=16, n_layer=2, n_head=2)
    params = gpt2.init_params(cfg, seed=0)
    dparams = gpt2.init_params(cfg.replace(n_layer=1), seed=1)

    def harvest(**kw):
        eng = ServingEngine(params, cfg, ServeConfig(**_serve_kw(max_batch=8, **kw)),
                            device="cpu", temperature=1.0, compute_dtype=torch.float32,
                            **({"draft_params": dparams, "draft_config": cfg.replace(n_layer=1)}
                               if kw else {}))
        hs = [eng.submit([1, 2, 3], 4, seed=i) for i in range(200)]
        eng.run_until_idle(max_steps=3000)
        toks = [t for h in hs for t in h.generated]
        assert len(toks) == 800
        return np.bincount(toks, minlength=13)

    hist_on, hist_off = harvest(spec="draft:124M,k:2"), harvest()
    tv = 0.5 * np.abs(hist_on / 800 - hist_off / 800).sum()
    assert tv < 0.15, (tv, hist_on, hist_off)


# ------------------------------------------------------ config, refusals

SPECS = ["", "draft:124M,k:4", "draft=124M,k=2", " k:3 , draft:345M ", "draft:124M",
         "k:4", "draft:124M,k:0", "draft:124M,k:x", "draft:bogus,k:4",
         "draft:124M,k:4,extra:1", "draft:124M,draft:124M,k:4"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_serve_spec_equals_the_jax_one(spec):
    """Values, and the refusals' texts, of ``parse_serve_spec`` and
    ``ServeConfig(spec=...)`` equal the JAX package's."""
    def outcome(parse, serve_config):
        try:
            return parse(spec), serve_config(spec=spec).spec_k
        except ValueError as e:
            return str(e)

    want = outcome(jax_config.parse_serve_spec, jax_config.ServeConfig)
    assert outcome(parse_serve_spec, ServeConfig) == want


def test_draft_serve_view_equals_the_jax_one():
    for kw, n_positions, bs in (({}, 64, None), ({"max_batch": 4, "block_size": 8,
                                                  "num_blocks": 19}, 64, None),
                                ({"max_batch": 3, "block_size": 16, "prefix_cache": True,
                                  "spec": "draft:124M,k:2"}, 1024, 32)):
        got = draft_serve_view(ServeConfig(**kw), n_positions, bs)
        want = jax_draft_view(jax_config.ServeConfig(**kw), n_positions, bs)
        assert got.spec == "" and got.prefix_cache is False
        assert {f: getattr(got, f) for f in ("max_batch", "block_size", "num_blocks",
                                             "admission", "prefill_chunk", "spec",
                                             "prefix_cache")} == {
            f: getattr(want, f) for f in ("max_batch", "block_size", "num_blocks",
                                          "admission", "prefill_chunk", "spec",
                                          "prefix_cache")}


REFUSALS = {
    "no draft": ({"spec": "draft:124M,k:2"}, None),
    "draft without spec": ({}, "draft"),
    "draft not smaller": ({"spec": "draft:124M,k:2"}, "target"),
    "vocab": ({"spec": "draft:124M,k:2"}, {"vocab_size": 259}),
    "n_positions": ({"spec": "draft:124M,k:2"}, {"n_positions": 32}),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_engine_refusals_equal_the_jax_ones(models, case):
    jp, jcfg, jdp, jdcfg = models["jax"]
    params, cfg, dparams, dcfg = models["port"]
    kw, draft = REFUSALS[case]
    if draft is None:
        jd, pd = {}, {}
    elif draft == "draft":
        jd = {"draft_params": jdp, "draft_config": jdcfg}
        pd = {"draft_params": dparams, "draft_config": dcfg}
    elif draft == "target":
        jd = {"draft_params": jp, "draft_config": jcfg}
        pd = {"draft_params": params, "draft_config": cfg}
    else:
        jc = jcfg.replace(n_layer=1, **draft)
        jd = {"draft_params": jax_gpt2.init_params(jc, seed=1), "draft_config": jc}
        pd = {"draft_params": _convert(jd["draft_params"]), "draft_config": _port_config(jc)}
    with pytest.raises(ValueError) as want:
        JaxServingEngine(jp, jcfg, jax_config.ServeConfig(**_serve_kw(attn_impl="xla", **kw)),
                         **jd)
    with pytest.raises(ValueError) as got:
        ServingEngine(params, cfg, ServeConfig(**_serve_kw(**kw)), device="cpu", **pd)
    assert str(got.value) == str(want.value)


CLI_BAD = (
    ["--draft_preset", "124M", "--spec_k", "0"],
    ["--spec_k", "2"],
    ["--draft_preset", "bogus"],
    ["--draft_preset", "124M"],                  # not smaller than the 124M target
    ["--draft_preset", "345M", "--model", "345M", "--n_layer", "2"],
    ["--draft_ckpt", "ckpt"],
)

_REFUSE_SCRIPT = """
import contextlib, io, json, sys
from gpt_2_distributed_torch.serving import serve
from gpt_2_distributed_torch.serving.frontend import server
out = []
for cli, base in ((serve, ["--requests", "-"]), (server, [])):
    for flags in json.loads(sys.argv[1]):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            try:
                cli.main(base + ["--init_random", "--device", "cpu"] + flags)
                code = 0
            except SystemExit as e:
                code = e.code
        out.append([code, err.getvalue().strip().splitlines()[-1]])
print(json.dumps(out))
"""


def test_cli_spec_refusals_equal_the_jax_texts_with_jax_poisoned(tmp_path, capsys):
    """``gpt2-torch-serve`` and ``gpt2-torch-frontend`` refuse a bad
    speculation flag after parsing, before any model is built, with the
    JAX CLI's text, in a process where importing ``jax`` raises."""
    from gpt_2_distributed_tpu.serving import serve as jax_serve

    want = []
    for flags in CLI_BAD:
        p = jax_serve.build_argparser()
        args = p.parse_args(["--requests", "-", "--init_random"] + flags)
        with pytest.raises(SystemExit) as e:
            jax_config.validate_worker_flags(p, args)
        want.append([e.value.code, capsys.readouterr().err.strip().splitlines()[-1]])
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("raise ImportError('no jax here')\n")
    env = dict(os.environ, PYTHONPATH=str(tmp_path) + os.pathsep + REPO)
    r = subprocess.run([sys.executable, "-c", _REFUSE_SCRIPT, json.dumps(CLI_BAD)],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    # The front end's program name differs; the message after it does not.
    strip = [[code, line.split(": error: ", 1)[1]] for code, line in got]
    assert strip == [[c, line.split(": error: ", 1)[1]] for c, line in want] * 2


# ------------------------------------------------------------ greedy streams


@pytest.mark.parametrize("name", SCENARIOS)
def test_greedy_streams_and_counters_equal_the_jax_engine(models, jax_runs, name):
    """k = 1, 2, 4; chunked prefill with prefix hits (the first request
    alone registers the shared prefix); watermark preemption; the
    self-slice draft at k = 2, 4, which must accept and sweep clean (the
    seeded drafts accept little). Every stream
    equals the JAX speculative engine's and ``generate_cached(batch=1)``'s,
    and the speculation, decode-step, preemption, resume and prefix-hit
    counts (per request too) equal the JAX engine's."""
    kw, batches, new = _scenario(name)
    eng = _port_engine(models["slice"] if name.startswith("slice") else models, **kw)
    counts = {}

    def on_token(req, tok):
        counts[req.id] = counts.get(req.id, 0) + 1

    hs = _drive(eng, batches, new, lambda e, p, n, i: e.submit(p, n, seed=i,
                                                               on_token=on_token))
    tokens, preemptions, stats = jax_runs(name)
    assert [h.generated for h in hs] == tokens
    assert tokens == [_reference(models, p, new) for batch in batches for p in batch]
    assert {k: eng.stats[k] for k in COUNTERS} == stats
    assert [h.preemptions for h in hs] == preemptions
    assert counts == {h.id: new for h in hs}                 # nothing emitted twice
    assert stats["spec_draft_tokens"] > 0
    if name == "chunked":
        assert stats["prefix_hit_tokens"] > 0
    if name == "watermark":
        assert stats["preemptions"] > 0
    if name.startswith("slice"):
        # Multi-token commits and, where no row rolled back, the bonus token.
        assert stats["spec_accepted_tokens"] > 0
        assert stats["spec_draft_tokens"] // int(name[-1]) > stats["spec_rollbacks"]
    assert eng._draft_alloc.available == eng._draft_serve.num_blocks - 1


@pytest.mark.parametrize("direction", ["spec_to_plain", "plain_to_spec"])
def test_greedy_migration_across_the_spec_boundary(models, direction):
    """Requests extracted after two steps of one engine and adopted by
    the other, through the JSON wire form, finish with
    ``generate_cached(batch=1)``'s streams and no token emitted twice."""
    first, second = ((True, False) if direction == "spec_to_plain" else (False, True))
    streams: dict[int, list[int]] = {}

    def on_token(req, tok):
        streams.setdefault(req.id, []).append(tok)

    a = _port_engine(models, draft=first, **({"spec": "draft:124M,k:2"} if first else {}))
    hs = [a.submit(p, 16, seed=i, on_token=on_token) for i, p in enumerate(PROMPTS)]
    for _ in range(2):
        a.step()
    moved = a.extract_inflight()
    assert len(moved) == 4 and all(0 < len(h.generated) < 16 for h in moved)
    b = _port_engine(models, draft=second, **({"spec": "draft:124M,k:2"} if second else {}))
    for req in moved:
        b.adopt(engine.RequestHandle.from_wire(json.loads(json.dumps(req.to_wire())),
                                               req.on_token, device="cpu"))
    b.run_until_idle(max_steps=500)
    want = [_reference(models, p, 16) for p in PROMPTS]
    assert [streams[h.id] for h in hs] == want


def test_a_request_ending_at_the_last_context_position(models):
    """k = 4 with prompt + new = n_positions: the last rounds' windows
    straddle the context end (masked verify rows, draft steps past the
    table), and the stream is ``generate_cached(batch=1)``'s."""
    p = [int(t) for t in np.random.default_rng(9).integers(1, 256, size=57)]
    eng = _port_engine(models, spec="draft:124M,k:4")
    hs = [eng.submit(p, 7), eng.submit(p[:40], 24, seed=1)]
    eng.run_until_idle(max_steps=100)
    assert [h.generated for h in hs] == [_reference(models, p, 7),
                                         _reference(models, p[:40], 24)]


def test_every_verify_query_goes_through_the_paged_attention(models, monkeypatch):
    """A round's verify calls ``paged_attention`` once a target layer with
    every row of the flattened window, R x (K+1); ``paged_prefill_attention``
    is reached only by the draft's catch-up, over the draft pool."""
    eng = _port_engine(models, spec="draft:124M,k:3")
    target = eng.k_pool.untyped_storage().data_ptr()
    calls = {"verify": [], "draft": [], "prefill_target": 0, "prefill_draft": 0}
    real_paged, real_prefill = decode.paged_attention, engine.paged_prefill_attention

    def paged(q, kp, *a, **k):
        same = kp.untyped_storage().data_ptr() == target
        calls["verify" if same else "draft"].append(q.shape[0])
        return real_paged(q, kp, *a, **k)

    def prefill(q, kp, *a, **k):
        same = kp.untyped_storage().data_ptr() == target
        calls["prefill_target" if same else "prefill_draft"] += 1
        return real_prefill(q, kp, *a, **k)

    monkeypatch.setattr(decode, "paged_attention", paged)
    monkeypatch.setattr(engine, "paged_prefill_attention", prefill)
    hs = [eng.submit(p, 8, seed=i) for i, p in enumerate(PROMPTS)]
    eng.run_until_idle(max_steps=500)
    layers = eng.config.n_layer
    assert calls["prefill_target"] == 0
    assert calls["prefill_draft"] == eng.stats["spec_catchups"] * eng.draft_config.n_layer
    assert len(calls["verify"]) == layers * eng.stats["decode_steps"]
    assert sum(calls["verify"]) == layers * 4 * eng.stats["spec_draft_tokens"] // 3
    assert len(calls["draft"]) == eng.draft_config.n_layer * 4 * eng.stats["decode_steps"]
    assert [h.generated for h in hs] == [_reference(models, p, 8) for p in PROMPTS]


# -------------------------------------------------------------------- CLI


def _detached(params: dict) -> dict:
    return {k: ([{kk: vv.detach().clone() for kk, vv in b.items()} for b in v]
                if k == "blocks" else v.detach().clone()) for k, v in params.items()}


def test_draft_ckpt_serves_the_streams_of_the_same_params(models, tmp_path, monkeypatch,
                                                          capsys):
    """``--draft_preset --draft_ckpt`` reads the draft through the port's
    ``restore_params``: sampled streams (which depend on the draft) equal
    an engine's given those params directly, and differ from the
    seeded-init draft's. The presets are patched to tiny entries."""
    from gpt_2_distributed_torch import checkpoint as ck
    from gpt_2_distributed_torch import resilience as res
    from gpt_2_distributed_torch.config import CheckpointPolicy
    from gpt_2_distributed_torch.models import gpt2
    from gpt_2_distributed_torch.parallel import train_step as ts
    from gpt_2_distributed_torch.serving import serve

    target = GPT2Config(vocab_size=257, n_positions=32, n_embd=32, n_layer=2, n_head=2)
    draft = target.replace(n_layer=1)
    monkeypatch.setitem(config.MODEL_PRESETS, "345M", target)
    monkeypatch.setitem(config.MODEL_PRESETS, "124M", draft)
    dparams = ts.trainable_params(gpt2.init_params(draft, seed=5), torch.device("cpu"))
    opt = ts.make_optimizer(dparams, 1e-2)
    step = ts.make_train_step(draft, opt, compute_dtype=torch.float32, guard=True)
    rng = np.random.default_rng(0)
    guard = res.init_guard_state()
    guard, _ = step(dparams, guard, torch.from_numpy(rng.integers(0, 257, (2, 4, 16))),
                    torch.from_numpy(rng.integers(0, 257, (2, 4, 16))), 0, 0, torch.ones(2))
    saver = ck.CheckpointSaver(str(tmp_path / "draft"), ck.StateLayout(draft),
                               CheckpointPolicy(async_save=False))
    try:
        saver.save(1, opt, ck.CheckpointMeta(step=1, epoch=0, batches_in_epoch=1,
                                             rng_seed=0), guard)
    finally:
        saver.close()
    reqs = tmp_path / "reqs.jsonl"
    prompts = [[3, 4, 5], [9] * 11, [7, 1]]
    reqs.write_text("\n".join(json.dumps({"prompt_ids": p, "new": 10, "seed": i})
                              for i, p in enumerate(prompts)))
    argv = ["--device", "cpu", "--init_random", "--model", "345M", "--draft_preset", "124M",
            "--spec_k", "3", "--temperature", "1.0", "--max_batch", "2",
            "--requests", str(reqs)]

    def cli(extra):
        serve.main(argv + extra)
        out = capsys.readouterr()
        return [json.loads(x)["generated"] for x in out.out.splitlines()
                if x.startswith("{")], out.err

    got, err = cli(["--draft_ckpt", str(tmp_path / "draft")])
    assert "draft checkpoint: " in err
    seeded, _ = cli([])
    eng = ServingEngine(gpt2.init_params(target), target,
                        ServeConfig(max_batch=2, block_size=16, num_blocks=5,
                                    spec="draft:124M,k:3"),
                        device="cpu", temperature=1.0, draft_params=_detached(dparams),
                        draft_config=draft)
    hs = [eng.submit(p, 10, seed=i) for i, p in enumerate(prompts)]
    eng.run_until_idle()
    assert got == [h.generated for h in hs] and got != seeded


# ---------------------------------------------------------- observability


def test_spans_events_and_summary_agree_with_the_stats(models, tmp_path):
    """A traced speculative run writes a ``draft`` and a ``verify`` span a
    round and one ``spec_accept`` event a row a round with JAX's
    attributes; ``scripts/obs_report.py``'s ``speculation_summary`` (and
    ``build_report``) read back the engine's counters, and the engine's
    and the router's ``metrics_snapshot`` carry them."""
    from gpt_2_distributed_torch.serving.frontend.router import ReplicaRouter
    from scripts.obs_report import build_report, load_trace_dir, speculation_summary

    trace.configure_tracing(str(tmp_path))
    try:
        router = ReplicaRouter(lambda: _port_engine(models, spec="draft:124M,k:2"),
                               replicas=1)
        eng = router.engines[0]
        hs = [eng.submit(p, 8, seed=i) for i, p in enumerate(PROMPTS)]
        eng.run_until_idle(max_steps=500)
    finally:
        trace.configure_tracing(None)
    assert all(h.done for h in hs)
    records = load_trace_dir(str(tmp_path))
    spans = [r for r in records if r.get("ph") == "span"]
    rounds = eng.stats["decode_steps"]
    for name in ("draft", "verify"):
        mine = [r for r in spans if r["name"] == name]
        assert len(mine) == rounds and all(r["attrs"]["k"] == 2 for r in mine)
    assert not [r for r in spans if r["name"] == "decode"]
    evs = [r["attrs"] for r in records
           if r.get("ph") == "event" and r["name"] == "spec_accept"]
    assert {tuple(sorted(a)) for a in evs} == {("accepted", "drafted", "rid")}
    summary = speculation_summary(records)
    assert summary["n_rounds"] == len(evs) == eng.stats["spec_draft_tokens"] // 2
    assert summary["draft_tokens"] == eng.stats["spec_draft_tokens"]
    assert summary["accepted_tokens"] == eng.stats["spec_accepted_tokens"]
    assert sum(a["accepted"] < 2 for a in evs) == eng.stats["spec_rollbacks"]
    assert build_report(str(tmp_path))["speculation"] == summary
    for snap in (eng.metrics_snapshot(), router.metrics_snapshot()):
        for key in ("spec_draft_tokens", "spec_accepted_tokens", "spec_rollbacks",
                    "draft_ms", "verify_ms"):
            assert snap[key] == float(eng.stats[key]), key
    assert eng.stats["draft_ms"] > 0 and eng.stats["verify_ms"] > 0
