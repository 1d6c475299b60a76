"""The port's serving path on the CPU: allocator and pool units, the
unported ``ServeConfig`` options refused loudly and the watermark and
speculation options accepted, engine greedy streams
equal to the JAX engine's, engine streams equal to the port's own
``generate_cached(batch=1)`` (greedy and sampled, any batch mix), and the
JSONL CLI."""

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

from gpt_2_distributed_tpu.config import ServeConfig as JaxServeConfig
from gpt_2_distributed_tpu.models import gpt2 as jax_gpt2
from gpt_2_distributed_tpu.serving import ServingEngine as JaxServingEngine
from gpt_2_distributed_torch.config import GPT2Config, ServeConfig
from gpt_2_distributed_torch.models.convert import params_from_jax
from gpt_2_distributed_torch.models.decode import generate_cached
from gpt_2_distributed_torch.ops.flash_attention import flash_attention_fwd
from gpt_2_distributed_torch.ops.paged_attention import paged_attention_kernel
from gpt_2_distributed_torch.serving import BlockAllocator, ServingEngine
from gpt_2_distributed_torch.serving.paged_cache import copy_block, scatter_prefill

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Staggered prompt lengths (1 to 13: one and two blocks of 8) and budgets.
PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11], [42], [5, 6],
           [200, 201, 202, 3, 4, 5, 6, 7, 8], list(range(30, 43))]
NEWS = [10, 7, 12, 1, 9, 6]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: intra-op threads only contend with the other test
    workers sharing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params(tiny_config):
    return jax_gpt2.init_params(tiny_config, seed=0)


@pytest.fixture(scope="module")
def port(jax_params, tiny_config):
    cfg = GPT2Config(vocab_size=tiny_config.vocab_size,
                     n_positions=tiny_config.n_positions,
                     n_embd=tiny_config.n_embd, n_layer=tiny_config.n_layer,
                     n_head=tiny_config.n_head)
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params)), cfg


def _serve(**kw):
    return ServeConfig(**{"max_batch": 4, "block_size": 8, "num_blocks": 32, **kw})


def _run(params, cfg, serve, seeds, **kw):
    eng = ServingEngine(params, cfg, serve, device="cpu", **kw)
    handles = [eng.submit(p, n, seed=s) for p, n, s in zip(PROMPTS, NEWS, seeds)]
    eng.run_until_idle(max_steps=200)
    return eng, handles


class TestBlockAllocator:
    def test_null_block_reserved_and_all_or_nothing(self):
        a = BlockAllocator(8)
        assert a.available == 7
        ids = a.alloc(7)
        assert sorted(ids) == list(range(1, 8))   # block 0 never handed out
        assert a.alloc(1) is None
        a.release(ids[:3])
        assert a.alloc(4) is None and a.available == 3   # untouched on refusal
        assert len(a.alloc(3)) == 3

    def test_double_free_and_foreign_ids_are_loud(self):
        a = BlockAllocator(8)
        ids = a.alloc(2)
        a.release(ids)
        assert a.available == 7
        with pytest.raises(ValueError, match="double free"):
            a.release([ids[1]])
        with pytest.raises(ValueError, match="not an allocated block"):
            a.release([0])
        with pytest.raises(ValueError, match="need at least one"):
            a.alloc(0)
        with pytest.raises(ValueError, match="num_blocks=1"):
            BlockAllocator(1)


def test_scatter_prefill_and_copy_block_write_in_place():
    l, n, h, bs, d = 2, 6, 2, 4, 3
    kp, vp = torch.zeros(l, n, h, bs, d), torch.zeros(l, n, h, bs, d)
    k = torch.arange(l * h * 2 * bs * d, dtype=torch.float32).reshape(l, h, 2 * bs, d)
    scatter_prefill(kp, vp, k, -k, [4, 2])
    assert torch.equal(kp[:, 4], k[:, :, :bs])
    assert torch.equal(kp[:, 2], k[:, :, bs:])
    assert torch.equal(vp[:, 2], -k[:, :, bs:])
    assert kp[:, [0, 1, 3, 5]].abs().sum() == 0
    copy_block(kp, vp, 2, 5)
    assert torch.equal(kp[:, 5], kp[:, 2]) and torch.equal(vp[:, 5], vp[:, 2])
    with pytest.raises(ValueError, match="do not fill"):
        scatter_prefill(kp, vp, k, k, [1])


@pytest.mark.parametrize("option", [
    {"mesh": "data:2,tp:2"}, {"mesh": "tp:2"}, {"mesh": "data:2"},
    {"mesh": "data:2", "spec": "draft:124M,k:2"},
])
def test_unported_serve_options_are_refused(option):
    with pytest.raises(ValueError, match="later slice"):
        ServeConfig(**option)


@pytest.mark.parametrize("option", [
    {"spec": "draft:124M,k:2"}, {"spec": "draft:124M,k:4"}, {"spec": "draft:345M,k:3"},
])
def test_spec_serve_options_are_accepted(option):
    """Speculation is ported: the spec options once refused here parse as
    the JAX ServeConfig parses them."""
    serve = ServeConfig(**option)
    assert serve.spec_axes() == JaxServeConfig(**option).spec_axes()
    assert serve.spec_k == int(option["spec"][-1])


@pytest.mark.parametrize("option", [
    {"admission": "watermark"}, {"watermark_blocks": 2},
    {"admission": "watermark", "watermark_blocks": 4},
])
def test_watermark_serve_options_are_accepted(option):
    serve = ServeConfig(**option)
    assert all(getattr(serve, k) == v for k, v in option.items())


@pytest.mark.parametrize("option", [
    {"watermark_blocks": -1}, {"prefill_batch": 0}, {"prefill_batch": 9},
    {"max_batch": 2, "prefill_batch": 3},
])
def test_serve_config_validates_as_the_jax_config(option):
    """``watermark_blocks`` and ``prefill_batch`` default as in the JAX
    ServeConfig and refuse an invalid value with its message."""
    port, jax_cfg = ServeConfig(), JaxServeConfig()
    assert (port.watermark_blocks, port.prefill_batch) == (jax_cfg.watermark_blocks,
                                                           jax_cfg.prefill_batch) == (1, 1)
    with pytest.raises(ValueError) as want:
        JaxServeConfig(**option)
    with pytest.raises(ValueError) as got:
        ServeConfig(**option)
    assert str(got.value) == str(want.value)


def _jax_serve_parser():
    from gpt_2_distributed_tpu.serving import serve as jax_serve

    return jax_serve.build_argparser()


def _flag_value(action) -> list[str]:
    """Arguments that give ``action`` a value its type and choices take."""
    if action.nargs == 0:
        return [action.option_strings[0]]
    if action.choices:
        value = list(action.choices)[-1]
    elif action.type in (int, float):
        value = action.type(7)
    else:
        value = "x"
    return [action.option_strings[0], str(value)]


def test_cli_parses_every_jax_serve_flag():
    """Every flag of the JAX serve CLI parses in the port's, one by one and
    all together, with the JAX flag's type and default."""
    from gpt_2_distributed_torch.serving import serve

    jax_p, port_p = _jax_serve_parser(), serve.build_argparser()
    actions = [a for a in jax_p._actions if a.option_strings and a.dest != "help"]
    assert len(actions) == 48
    port_actions = {a.dest: a for a in port_p._actions}
    argv = []
    for a in actions:
        # A value the port takes (--attn_impl names the port's kernels).
        one = _flag_value(port_actions.get(a.dest, a))
        port_p.parse_args(["--requests", "r.jsonl"] + one)   # exits on an unknown flag
        argv += one
        if a.dest in serve._UNPORTED or a.dest in ("request_timeout_s", "admission",
                                                   "watermark_blocks", "tb_dir",
                                                   "metrics_every", "trace_dir",
                                                   "trace_max_file_bytes",
                                                   "xla_profile_at"):
            assert port_actions[a.dest].default == a.default, a.dest
            assert port_actions[a.dest].type == a.type, a.dest
            assert port_actions[a.dest].nargs == a.nargs, a.dest
    port_p.parse_args(argv)


def test_cli_refuses_each_unported_flag(capsys):
    from gpt_2_distributed_torch.serving import serve

    port_actions = {a.dest: a for a in serve.build_argparser()._actions}
    # 23 until the tracing and metric sinks were ported (tb_dir,
    # metrics_every, trace_dir, trace_max_file_bytes and xla_profile_at),
    # 18 until checkpoints were (ckpt), 17 until speculation was
    # (draft_preset, spec_k, draft_ckpt).
    assert len(serve._UNPORTED) == 14
    for dest in serve._UNPORTED:
        with pytest.raises(SystemExit) as e:
            serve.main(["--requests", "r.jsonl", "--init_random"]
                       + _flag_value(port_actions[dest]))
        assert e.value.code == 2
        assert f"--{dest}" in capsys.readouterr().err


def test_engine_refuses_a_missing_gpu(port):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    params, cfg = port
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(params, cfg, _serve())


def test_greedy_streams_equal_the_jax_engine(jax_params, tiny_config, port):
    jeng = JaxServingEngine(
        jax_params, tiny_config,
        JaxServeConfig(max_batch=4, block_size=8, num_blocks=32, attn_impl="xla"),
        temperature=0.0, compute_dtype=jnp.float32,
    )
    jh = [jeng.submit(p, n, rng=i) for i, (p, n) in enumerate(zip(PROMPTS, NEWS))]
    jeng.run_until_idle(max_steps=200)
    params, cfg = port
    eng, handles = _run(params, cfg, _serve(), range(len(PROMPTS)),
                        temperature=0.0, compute_dtype=torch.float32)
    assert [h.generated for h in handles] == [h.generated for h in jh]
    assert eng.stats["decode_steps"] == jeng.stats["decode_steps"]
    assert all(h.finish_reason == "length" for h in handles)
    assert eng.allocator.available == eng.serve.num_blocks - 1   # no leak


@pytest.mark.parametrize("temperature,top_k,dtype", [
    (0.0, None, torch.float32), (0.9, 40, torch.float32),
    (0.0, None, torch.bfloat16), (1.0, None, torch.bfloat16),
])
def test_streams_equal_generate_cached_batch1(port, temperature, top_k, dtype):
    params, cfg = port
    seeds = [100 + i for i in range(len(PROMPTS))]
    launches = (flash_attention_fwd.launches, paged_attention_kernel.launches)
    refs = [generate_cached(params, cfg, [p], seed=s, max_new_tokens=n,
                            temperature=temperature, top_k=top_k,
                            compute_dtype=dtype, device="cpu")[0, len(p):].tolist()
            for p, n, s in zip(PROMPTS, NEWS, seeds)]
    # Two batch mixes: 4 slots (queueing, mid-stream admissions) and 2.
    for serve in (_serve(), _serve(max_batch=2)):
        _, handles = _run(params, cfg, serve, seeds, temperature=temperature,
                          top_k=top_k, compute_dtype=dtype)
        assert [h.generated for h in handles] == refs
    # CPU tensors never reach a kernel.
    assert (flash_attention_fwd.launches, paged_attention_kernel.launches) == launches


def test_eos_and_deadline_evictions(port):
    params, cfg = port
    eng = ServingEngine(params, cfg, _serve(), device="cpu", temperature=0.0)
    probe = eng.submit(PROMPTS[0], 5)
    eng.run_until_idle()
    eos = probe.generated[2]
    upto = probe.generated.index(eos) + 1     # greedy streams may repeat
    eng = ServingEngine(params, cfg, _serve(eos_id=eos), device="cpu",
                        temperature=0.0)
    h = eng.submit(PROMPTS[0], 5)
    late = eng.submit(PROMPTS[1], 5, timeout_s=0.0)
    eng.run_until_idle()
    assert h.finish_reason == "eos" and h.generated == probe.generated[:upto]
    assert late.finish_reason == "timeout" and eng.stats["timeouts"] == 1
    assert eng.allocator.available == eng.serve.num_blocks - 1
    snap = eng.metrics_snapshot()
    assert snap["serve_queue_depth"] == 0 and snap["serve_occupancy"] == 0
    small = ServingEngine(params, cfg, _serve(num_blocks=4), device="cpu")
    with pytest.raises(ValueError, match="could never be admitted"):
        small.submit([1] * 30, 4)   # 33 positions: 5 blocks of 8 > 3 usable


def test_cli_serves_jsonl_on_the_cpu(tmp_path):
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text("\n".join(json.dumps({"prompt_ids": p, "new": n, "seed": i})
                              for i, (p, n) in enumerate(zip(PROMPTS[:3], NEWS))))
    out = subprocess.run(
        [sys.executable, "-m", "gpt_2_distributed_torch.serving.serve",
         "--device", "cpu", "--init_random", "--n_layer", "2", "--n_embd", "32",
         "--n_head", "2", "--vocab_size", "257", "--seq_len", "64",
         "--max_batch", "2", "--block_size", "8", "--temperature", "0",
         "--requests", str(reqs), "--stream"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert out.returncode == 0, out.stderr
    lines = [json.loads(x) for x in out.stdout.splitlines()]
    finals = [x for x in lines if "generated" in x]
    streamed = [x for x in lines if "token" in x]
    assert [set(x) for x in finals] == [{
        "id", "generated", "text", "finish_reason", "ttft_ms",
        "queue_wait_ms", "preempted", "prefix_cached_tokens",
    }] * 3
    assert [len(x["generated"]) for x in finals] == NEWS[:3]
    assert len(streamed) == sum(NEWS[:3])
    assert "decode steps on cpu" in out.stderr


def test_cli_request_timeout_evicts_overdue_requests(tmp_path, capsys):
    """``--request_timeout_s 0``: a request without its own ``timeout_s``
    is overdue at the first step and evicted before its first token; a
    line's own ``timeout_s`` wins and that request is served."""
    from gpt_2_distributed_torch.serving import serve

    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text(json.dumps({"prompt_ids": PROMPTS[0], "new": 5}) + "\n"
                    + json.dumps({"prompt_ids": PROMPTS[1], "new": 4, "timeout_s": 600}))
    serve.main(["--device", "cpu", "--init_random", "--n_layer", "1", "--n_embd", "32",
                "--n_head", "2", "--vocab_size", "257", "--seq_len", "32",
                "--max_batch", "2", "--block_size", "8", "--temperature", "0",
                "--request_timeout_s", "0", "--requests", str(reqs)])
    finals = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert finals[0]["finish_reason"] == "timeout" and finals[0]["generated"] == []
    assert finals[0]["ttft_ms"] is None
    assert finals[1]["finish_reason"] != "timeout" and len(finals[1]["generated"]) == 4
    with pytest.raises(SystemExit):
        serve.main(["--init_random", "--request_timeout_s", "-1", "--requests", str(reqs)])
