"""The PyTorch port stands alone: it imports with JAX and the JAX package
made unimportable, no module of it (nor ``chip_smoke.py``) names either,
and its entry points refuse a host without a GPU unless asked for the CPU.
"""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "gpt_2_distributed_torch"
FORBIDDEN = ("jax", "jaxlib", "gpt_2_distributed_tpu")


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


# Modules the poisoned import must cover by name (the list above is found
# by walking the package; these pin the ones later slices added).
REQUIRED = (
    "gpt_2_distributed_torch.checkpoint",
    "gpt_2_distributed_torch.coordination",
    "gpt_2_distributed_torch.obs.trace",
    "gpt_2_distributed_torch.resilience",
    "gpt_2_distributed_torch.serving.frontend.driver",
    "gpt_2_distributed_torch.serving.frontend.router",
    "gpt_2_distributed_torch.serving.frontend.autoscale",
    "gpt_2_distributed_torch.serving.frontend.server",
    "gpt_2_distributed_torch.serving.frontend.rpc",
    "gpt_2_distributed_torch.serving.frontend.netchaos",
    "gpt_2_distributed_torch.serving.frontend.worker",
)


def test_port_imports_with_jax_poisoned():
    assert set(REQUIRED) <= set(_port_modules())
    code = (
        "import sys\n"
        + "".join(f"sys.modules[{m!r}] = None\n" for m in FORBIDDEN)
        + "import importlib\n"
        + f"for m in {_port_modules()!r}:\n"
        + "    importlib.import_module(m)\n"
        + "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in
                                        [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]))
def test_no_jax_import_anywhere_in_the_port(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_serve_cli_without_device_refuses_a_gpuless_host(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    from gpt_2_distributed_torch.serving import serve

    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text('{"prompt_ids": [1, 2], "new": 2}\n')
    with pytest.raises(SystemExit) as exc:
        serve.main(["--init_random", "--n_layer", "1", "--n_embd", "32",
                    "--n_head", "2", "--vocab_size", "64", "--seq_len", "16",
                    "--requests", str(reqs)])
    assert "no CUDA device" in str(exc.value.code)
