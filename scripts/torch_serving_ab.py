"""Serving time of the PyTorch/CUDA port from two checkouts, in turns, on one
GPU: chip_smoke.py's serving workload (124M at full width, random weights
from seed 0, bf16, max_batch 8, block_size 16, 513 blocks; 8 prompts of 1
to 960 tokens, 64 new tokens greedy, then 16 sampled at temperature 1.0).

    python scripts/torch_serving_ab.py OLD_ROOT NEW_ROOT

Runs OLD, NEW, NEW, OLD, each in its own process that imports
``gpt_2_distributed_torch`` from that root, and prints for each run the
card (``nvidia-smi`` name and power limit), the mean time to first token
and the decode ms per step of both workloads, as one JSON line each.
Exits nonzero without a GPU.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def worker(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from gpt_2_distributed_torch.config import MODEL_PRESETS, ServeConfig
    from gpt_2_distributed_torch.models import gpt2
    from gpt_2_distributed_torch.serving import ServingEngine

    config = MODEL_PRESETS["124M"]
    serve = ServeConfig(max_batch=8, block_size=16, num_blocks=513)
    params = gpt2.init_params(config, seed=0)
    rng = torch.Generator().manual_seed(7)
    prompts = [torch.randint(0, config.vocab_size, (p,), generator=rng).tolist()
               for p in (1, 17, 100, 208, 400, 512, 777, 960)]
    out = {"root": root}
    for label, temperature, new, seed0 in (("greedy", 0.0, 64, 0), ("sampled", 1.0, 16, 50)):
        eng = ServingEngine(params, config, serve, temperature=temperature)
        eng.submit([1, 2, 3], 2)
        eng.run_until_idle()               # warm-up: allocator, handles
        before = dict(eng.stats)
        t0 = time.monotonic()
        handles = [eng.submit(p, new, seed=seed0 + i) for i, p in enumerate(prompts)]
        eng.run_until_idle()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        steps = eng.stats["decode_steps"] - before["decode_steps"]
        ttft = [(h.first_token_time - h.submit_time) * 1e3 for h in handles]
        out[label] = {
            "mean_ttft_ms": sum(ttft) / len(ttft),
            "decode_ms_per_step": (eng.stats["decode_ms"] - before["decode_ms"]) / steps,
            "tok_s": sum(len(h.generated) for h in handles) / wall,
        }
    return out


def main() -> None:
    if sys.argv[1] == "--worker":
        print(json.dumps(worker(sys.argv[2])), flush=True)
        return
    old, new = sys.argv[1:3]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    for root in (old, new, new, old):
        run = subprocess.run([sys.executable, __file__, "--worker", root],
                             capture_output=True, text=True)
        if run.returncode != 0:
            sys.exit(f"serving run from {root} failed:\n{run.stderr[-4000:]}")
        print(run.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
