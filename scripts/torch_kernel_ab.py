"""Device times of K6's forward and backward, K4's backward (whose column
pass K6 now shares) and, as controls, K8's forward and backward, from two
checkouts of the PyTorch/CUDA port, in turns, on one GPU, at
chip_smoke.py's timed shapes:

- K6 forward and backward [4096, 3072] and K4 backward [4096, 768],
  dropout 0.1, each backward's two passes (the rows, the column sums)
  timed apart, with PyTorch's tanh ``gelu`` and ``gelu_backward`` on the
  same inputs beside K6;
- K8 forward and backward: one full [4, 12, 512|512, 64] block below the
  diagonal (sp = 2 at 124M), dropout 0.1, with nonzero do and dlse.

    python scripts/torch_kernel_ab.py OLD_ROOT NEW_ROOT

Runs OLD, NEW, NEW, OLD, each in its own process that imports
``gpt_2_distributed_torch`` from that root (its kernels built under that
root's ``build/``), and prints the card (``nvidia-smi`` name and power
limit), then one JSON line a run: each kernel's median device time over 20
launches on a flushed L2 (chip_smoke.py's ``time_ms``), the passes' mean
times from torch.profiler (``kernels_apart_ms``), and a hash of K4
backward's outputs (dx, do, dscale, dbias), equal between two trees whose
K4 backward gives the same bits. Exits nonzero without a GPU.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (timing helpers; it imports the package lazily)


def worker(root: str) -> dict:
    sys.path.insert(0, root)
    from gpt_2_distributed_torch.ops import flash_block as fb
    from gpt_2_distributed_torch.ops import fused_layer as fl

    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    out = {"root": root}
    q, k, v, do = (randn(4, 12, 512, 64) for _ in range(4))
    kw = dict(seed=chip_smoke.ATTN_SEED, dropout_rate=chip_smoke.DROPOUT)
    o, lse = fb.flash_block_fwd(q, k, v, 512, 0, **kw)
    delta = ((do.float() * o.float()).sum(-1) - randn(4, 12, 512, dtype=torch.float32)
             * chip_smoke.LOG2E).contiguous()
    out["k8_fwd_ms"] = chip_smoke.time_ms(lambda: fb.flash_block_fwd(q, k, v, 512, 0, **kw),
                                          flush)
    out["k8_bwd_ms"] = chip_smoke.time_ms(
        lambda: fb.flash_block_bwd(q, k, v, do, lse, delta, 512, 0, **kw), flush)

    n, c, f = chip_smoke.FUSED_SHAPES[0]
    seed, rate = chip_smoke.FUSED_SEED, chip_smoke.DROPOUT
    x, o, dr, dy = (randn(n, c) for _ in range(4))
    scale = 1 + randn(c, scale=0.1, dtype=torch.float32)
    bias = randn(c, scale=0.1, dtype=torch.float32)
    r, _, mean, rstd = fl.ln_residual_dropout_fwd(x, o, scale, bias, 1e-5, rate, seed)

    def k4_bwd():
        return fl.ln_residual_dropout_bwd(r, mean, rstd, scale, dr, dy, rate, seed)

    out["k4_bwd_sha256"] = hashlib.sha256(
        b"".join(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
                 for t in k4_bwd())).hexdigest()[:16]
    out["k4_bwd_ms"] = chip_smoke.time_ms(k4_bwd, flush)
    out["k4_bwd_passes_ms"] = chip_smoke.kernels_apart_ms(
        k4_bwd, flush, chip_smoke.BWD_PASSES["ln_residual_dropout_bwd"])
    h, dout, b = randn(n, f), randn(n, f), randn(f, scale=0.1)
    u = h + b

    def k6_bwd():
        return fl.bias_gelu_dropout_bwd(h, b, dout, rate, seed)

    out["k6_fwd_ms"] = chip_smoke.time_ms(
        lambda: fl.bias_gelu_dropout_fwd(h, b, rate, seed), flush)
    out["gelu_ms"] = chip_smoke.time_ms(
        lambda: torch.nn.functional.gelu(u, approximate="tanh"), flush)
    out["k6_bwd_ms"] = chip_smoke.time_ms(k6_bwd, flush)
    out["k6_bwd_passes_ms"] = chip_smoke.kernels_apart_ms(
        k6_bwd, flush, chip_smoke.BWD_PASSES["bias_gelu_dropout_bwd"])
    out["gelu_backward_ms"] = chip_smoke.time_ms(
        lambda: torch.ops.aten.gelu_backward(dout, u, approximate="tanh"), flush)
    return out


def main() -> None:
    if sys.argv[1] == "--worker":
        print(json.dumps(worker(sys.argv[2])), flush=True)
        return
    if not torch.cuda.is_available():
        sys.exit("torch_kernel_ab: no CUDA device")
    old, new = sys.argv[1:3]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    for root in (old, new, new, old):
        run = subprocess.run([sys.executable, __file__, "--worker", root],
                             capture_output=True, text=True)
        if run.returncode != 0:
            sys.exit(f"kernel run from {root} failed:\n{run.stderr[-4000:]}")
        print(run.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
