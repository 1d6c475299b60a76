"""The port's sampling CLI (``gpt2-torch-sample``) end to end on the CPU:
the port's trainer saves a checkpoint, the CLI samples from it through
each decode path (the port's copy of ``tests/test_sample_cli.py``)."""

from __future__ import annotations

import os
import shutil
import sys
import types

import pytest
import torch

from gpt_2_distributed_torch import sample as sample_mod
from gpt_2_distributed_torch import train as train_mod

MODEL_FLAGS = [
    "--n_layer", "2",
    "--n_embd", "32",
    "--n_head", "2",
    "--vocab_size", "257",
    "--seq_len", "32",
    "--device", "cpu",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained_ckpt(tmp_path_factory):
    """A save dir with the port's checkpoints of steps 2 and 3."""
    from gpt_2_distributed_torch.data.synthetic import write_synthetic_shards

    data = tmp_path_factory.mktemp("data")
    write_synthetic_shards(str(data), num_shards=2, tokens_per_shard=20_000,
                           vocab_size=257, seed=0)
    ckpt = tmp_path_factory.mktemp("ckpt")
    train_mod.main(["--data_dir", str(data), *MODEL_FLAGS, "--batch", "4",
                    "--grad_accum_steps", "1", "--max_steps", "3", "--save_every", "2",
                    "--async_save", "off", "--save_dir", str(ckpt)])
    return str(ckpt)


def run_sample(capsys, *argv):
    sample_mod.main(list(argv))
    return capsys.readouterr().out.strip()


def test_sample_from_save_dir_both_paths_agree(capsys, trained_ckpt):
    common = ["--ckpt", trained_ckpt, *MODEL_FLAGS,
              "--prompt_ids", "5,6,7", "--new", "6", "--temperature", "0"]
    cached = run_sample(capsys, *common, "--decode_path", "cached")
    reforward = run_sample(capsys, *common)  # auto -> reforward
    ids = [int(t) for t in cached.split(",")]
    assert len(ids) == 9 and ids[:3] == [5, 6, 7]
    assert all(0 <= t < 257 for t in ids)
    assert cached == reforward
    assert run_sample(capsys, *common, "--decode_path", "reforward") == reforward


def test_sample_stream_matches_cached_path(capsys, trained_ckpt):
    """``--stream`` decodes through the serving engine's paged KV cache and
    prints the same stream as the cached path, greedy and sampled."""
    for flags in (["--temperature", "0"],
                  ["--temperature", "0.9", "--top_k", "40", "--seed", "11"]):
        common = ["--ckpt", trained_ckpt, *MODEL_FLAGS, "--prompt_ids", "5,6,7",
                  "--new", "6", *flags]
        cached = run_sample(capsys, *common, "--decode_path", "cached")
        assert run_sample(capsys, *common, "--stream") == cached


def test_sample_stream_rejects_reforward(capsys, trained_ckpt):
    with pytest.raises(SystemExit) as exc:
        run_sample(capsys, "--ckpt", trained_ckpt, *MODEL_FLAGS, "--prompt_ids", "5",
                   "--stream", "--decode_path", "reforward")
    assert "drop --decode_path reforward" in str(exc.value.code)


@pytest.mark.parametrize("argv, message", [
    (["--prompt_ids", "5", "--prompt", "both"],
     "exactly one of --prompt / --prompt_ids is required"),
    ([], "exactly one of --prompt / --prompt_ids is required"),
    (["--prompt_ids", "999"], "prompt ids out of vocab range: [999]"),
    (["--prompt_ids", ""], "empty prompt"),
    (["--prompt_ids", "5", "--new", "40"], "exceeds n_positions (32)"),
])
def test_sample_rejects_bad_args(capsys, trained_ckpt, argv, message):
    with pytest.raises(SystemExit) as exc:
        run_sample(capsys, "--ckpt", trained_ckpt, *MODEL_FLAGS, *argv)
    assert message in str(exc.value.code)


def test_sample_rejects_a_missing_checkpoint(capsys, tmp_path):
    with pytest.raises(SystemExit) as exc:
        run_sample(capsys, "--ckpt", str(tmp_path / "nothing"), *MODEL_FLAGS,
                   "--prompt_ids", "5")
    assert "no checkpoint found under" in str(exc.value.code)


def test_text_prompt_without_the_bpe_exits_with_the_jax_message(capsys, trained_ckpt,
                                                                monkeypatch):
    """tiktoken's BPE is fetched over the network on first use; a host
    without it gets the JAX CLI's exit, and nothing is fetched here."""
    fake = types.ModuleType("tiktoken")

    def get_encoding(name):
        raise RuntimeError("no BPE file")

    fake.get_encoding = get_encoding
    monkeypatch.setitem(sys.modules, "tiktoken", fake)
    with pytest.raises(SystemExit) as exc:
        run_sample(capsys, "--ckpt", trained_ckpt, *MODEL_FLAGS, "--prompt", "hello")
    assert str(exc.value.code) == ("--prompt needs tiktoken's GPT-2 BPE (no BPE file); "
                                   "use --prompt_ids offline")


def test_save_dir_resolves_to_its_latest_checkpoint(capsys, trained_ckpt):
    common = [*MODEL_FLAGS, "--prompt_ids", "5,6,7", "--new", "4", "--temperature", "0"]
    sample_mod.main(["--ckpt", trained_ckpt, *common])
    err = capsys.readouterr().err
    assert os.path.join(trained_ckpt, "step_0000003") + " (step 3," in err
    sample_mod.main(["--ckpt", os.path.join(trained_ckpt, "step_0000002"), *common])
    assert "(step 2," in capsys.readouterr().err


def test_a_checkpoint_of_another_format_is_refused(capsys, trained_ckpt, tmp_path):
    """A step dir without the port's index (the JAX package's orbax trees
    have none) is refused, as ``gpt2-torch-serve --ckpt`` refuses it."""
    other = tmp_path / "step_0000003"
    shutil.copytree(os.path.join(trained_ckpt, "step_0000003"), other)
    os.remove(other / "index.json")
    with pytest.raises(SystemExit) as exc:
        run_sample(capsys, "--ckpt", str(other), *MODEL_FLAGS, "--prompt_ids", "5")
    assert "unknown checkpoint format" in str(exc.value.code)


def test_sample_needs_a_gpu_unless_told_otherwise(capsys, trained_ckpt):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    argv = ["--ckpt", trained_ckpt, *MODEL_FLAGS[:-2], "--prompt_ids", "5"]
    with pytest.raises(SystemExit) as exc:
        run_sample(capsys, *argv)
    assert "no CUDA device" in str(exc.value.code)


def test_flags_are_the_jax_clis():
    """The JAX CLI's 16 flags under the same names, types, choices and
    defaults; ``--device`` defaults to cuda, as every port entry point."""
    from gpt_2_distributed_tpu import sample as jax_sample

    def flags(parser):
        return {a.dest: a for a in parser._actions if a.dest != "help"}

    port, jax_flags = flags(sample_mod.build_argparser()), flags(jax_sample.build_argparser())
    assert port.keys() == jax_flags.keys() and len(port) == 16
    for dest, a in jax_flags.items():
        b = port[dest]
        assert (b.option_strings, b.type, b.choices, b.required, b.nargs) == (
            a.option_strings, a.type, a.choices, a.required, a.nargs), dest
        if dest != "device":
            assert b.default == a.default, dest
    assert port["device"].default == "cuda"
