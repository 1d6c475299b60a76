"""Step time of the training CLI's control-word exchange on two GPUs.

Under a mesh the loop all-reduces its control word every
``--consensus_every`` steps (``coordination.py::ConsensusBus``) and reads
the result on the host. This script runs chip_smoke.py's two-card
training at 124M (``train_argv``, 16 steps, 4 x [4, 1024] a rank) with
the exchange every step (``--consensus_every 1``, the default) and, as the
control, once at the start (``--consensus_every 1000000``), in pairs whose
order alternates (every, once, once, every, ...) for:

- ``ddp``: ``--training_mode ddp`` with ``--fused_layers all
  --fused_matmul all``;
- ``fsdp``: ``--training_mode fsdp``;
- ``unguarded``: ``ddp``'s run with ``--step_guard off`` and a
  ``--save_dir`` (no periodic save; the run's final save ends it):
  unguarded, the loop reads a step's metrics one step late, and the
  exchange makes the host wait for the last step before it issues the
  next.

    python scripts/torch_consensus_ab.py [--pairs N] [RUN ...]

runs N pairs (default 2) of each named run (default all three).

Prints the card (``nvidia-smi`` name and power limit), then one JSON line
a run: the median ms/step and tok/s over both cards (chip_smoke.py's
``phase_ddp_training`` reading: the middle of the 16 steps' tok/s), and
the first and last losses, equal between a pair when the exchange changes
nothing but time. Exits nonzero with fewer than two GPUs.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (train_argv; it imports the package lazily)

CONFIGS = {
    "ddp": (["--training_mode", "ddp"], "all", "all", False),
    "fsdp": (["--training_mode", "fsdp"], "off", "off", False),
    "unguarded": (["--training_mode", "ddp", "--step_guard", "off"], "all", "all", True),
}
EVERY, ONCE = "1", "1000000"


def worker(argv: list[str]) -> None:
    """One rank under ``torch.distributed.run``: ``train.main(argv)``;
    rank 0 prints its step rates and losses."""
    import os

    from gpt_2_distributed_torch import train

    tracker = train.main(argv)
    if int(os.environ["RANK"]) == 0:
        print("ab_worker " + json.dumps({
            "tokens_per_second": list(tracker.buffers["tokens_per_second"]),
            "tokens_per_step": tracker.tokens_per_step,
            "losses": list(tracker.buffers["loss"]),
        }), flush=True)


def run(data_dir: str, save_root: str, label: str, every: str, turn: int) -> dict:
    flags, fused_layers, fused_matmul, save = CONFIGS[label]
    argv = chip_smoke.train_argv(data_dir, fused_layers, fused_matmul) + flags + [
        "--consensus_every", every]
    if save:
        argv += ["--save_dir", f"{save_root}/{label}-{every}-{turn}"]
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", __file__, "--worker", *argv],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    if proc.returncode != 0:
        sys.exit(f"{label} --consensus_every {every} exited with {proc.returncode}:\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    rec = next(json.loads(line.split(" ", 1)[1]) for line in proc.stdout.splitlines()
               if line.startswith("ab_worker "))
    tok_s = sorted(rec["tokens_per_second"])[len(rec["tokens_per_second"]) // 2]
    return {"run": label, "consensus_every": int(every), "turn": turn,
            "ms_step": rec["tokens_per_step"] / tok_s * 1e3, "tok_s": tok_s,
            "steps": len(rec["losses"]), "first_loss": rec["losses"][0],
            "last_loss": rec["losses"][-1], "wall_s": time.monotonic() - t0}


def main() -> None:
    if "--worker" in sys.argv[1:]:
        worker(sys.argv[sys.argv.index("--worker") + 1:])
        return
    args = sys.argv[1:]
    pairs = 2
    if "--pairs" in args:
        i = args.index("--pairs")
        pairs = int(args[i + 1])
        del args[i:i + 2]
    labels = args or list(CONFIGS)
    unknown = set(labels) - set(CONFIGS)
    if unknown:
        sys.exit(f"unknown runs {sorted(unknown)}; choose from {sorted(CONFIGS)}")
    if torch.cuda.device_count() < 2:
        sys.exit(f"needs two GPUs; this machine has {torch.cuda.device_count()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    from gpt_2_distributed_torch.data.synthetic import write_synthetic_shards
    from gpt_2_distributed_torch.kernels import build

    build.build(["flash_fwd", "flash_bwd", "fused_layer", "fused_matmul"])
    with tempfile.TemporaryDirectory() as data_dir, tempfile.TemporaryDirectory() as saves:
        write_synthetic_shards(data_dir, num_shards=8, tokens_per_shard=262144, seed=0)
        order = [e for p in range(pairs) for e in ((EVERY, ONCE) if p % 2 == 0
                                                   else (ONCE, EVERY))]
        for label in labels:
            for turn, every in enumerate(order):
                print(json.dumps(run(data_dir, saves, label, every, turn)), flush=True)


if __name__ == "__main__":
    main()
