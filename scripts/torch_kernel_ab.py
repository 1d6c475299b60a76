"""Device times of K1's whole-prompt form, K5 (residual dropout, its
backward rescale), K4's forward and K3 (paged decode) and, as controls,
K6's forward and backward and K4's backward, from two checkouts of the
PyTorch/CUDA port, in turns, on one GPU, at chip_smoke.py's timed shapes:

- K1 (the flash forward) at the training shape [4, 12, 1024, 64] with
  dropout 0.1 and at the prefill shape [1, 12, 1024, 64], with hashes of
  its o and lse;

- K5's forward and rescale [4096, 768] and [1000, 1600] at dropout 0.1,
  beside PyTorch's ``torch.add(x, o)`` and ``torch.mul(dr, s)`` in bf16 at
  [4096, 768] (the same bytes; another function, so controls, not
  yardsticks);
- K4 forward [4096, 768] at dropout 0.1 and at rate 0 (with a zero o, and
  where the tree takes it, with ``o=None``), PyTorch's ``layer_norm`` on
  the same rows beside it; [1000, 1600] at dropout 0.1; serving's [960,
  768] and [8, 768] with a zero o (and ``o=None``);
- K3 at chip_smoke.py's "full" (8 x 1024 keys) and "mixed" lengths, 12
  heads, D 64, blocks of 16;
- K6 forward and backward [4096, 3072] and K4 backward [4096, 768],
  dropout 0.1.

    python scripts/torch_kernel_ab.py OLD_ROOT NEW_ROOT

Runs OLD, NEW, NEW, OLD, each in its own process that imports
``gpt_2_distributed_torch`` from that root (its kernels built under that
root's ``build/``), and prints the card (``nvidia-smi`` name and power
limit), then one JSON line a run: each kernel's median device time over 20
launches on a flushed L2 (chip_smoke.py's ``time_ms``, after a write of the
flush buffer), the memory-bound rows of K5, K4's forward and K3 and the
controls also after a read of it (``_read``), and hashes of outputs, equal
between two trees that give the same bits: K5's (dropout 0.1, both
shapes), K4 forward's (r, y, mean, rstd at dropout 0.1 and at rate 0), K4
backward's (dx, do, dscale, dbias), K6's on random inputs, and K5's and
K6's on chip_smoke.py's ``signed_zero_case`` at [256, 768] (-0 planted),
K6's also with the sign bits of out and dh cleared in the planted columns
(``unsigned``: equal when two trees' outputs differ in nothing but sign
bits there; dout is -0 in those columns, u in their even rows). Exits
nonzero
without a GPU.
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


def digest(tensors) -> str:
    return hashlib.sha256(b"".join(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
                                   for t in tensors if t is not None)).hexdigest()[:16]


def worker(root: str) -> dict:
    sys.path.insert(0, root)
    from gpt_2_distributed_torch.ops import flash_attention as fa
    from gpt_2_distributed_torch.ops import fused_layer as fl
    from gpt_2_distributed_torch.ops import paged_attention as pa

    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    def timed(name, fn, both=False):
        out[f"{name}_ms"] = chip_smoke.time_ms(fn, flush)
        if both:
            out[f"{name}_read_ms"] = chip_smoke.time_ms(fn, flush, read_flush=True)

    out = {"root": root}
    b1, h1, t1, d1 = chip_smoke.TRAIN_SHAPE
    for tag, batch, r in (("train", b1, chip_smoke.DROPOUT), ("prefill", 1, 0.0)):
        q1, k1, v1 = (randn(batch, h1, t1, d1) for _ in range(3))
        out[f"k1_{tag}_sha256"] = digest(fa.flash_attention_fwd(q1, k1, v1, r,
                                                                chip_smoke.ATTN_SEED))
        timed(f"k1_{tag}", lambda: fa.flash_attention_fwd(q1, k1, v1, r, chip_smoke.ATTN_SEED))
    n, c, f = chip_smoke.FUSED_SHAPES[0]
    seed, rate, eps = chip_smoke.FUSED_SEED, chip_smoke.DROPOUT, 1e-5
    x, o, dr, dy = (randn(n, c) for _ in range(4))
    scale = 1 + randn(c, scale=0.1, dtype=torch.float32)
    bias = randn(c, scale=0.1, dtype=torch.float32)
    zero = torch.zeros_like(o)
    takes_none = hasattr(fl, "ln_fwd_strips")   # K4's forward takes o=None

    def k4(xs, os, r=0.0):
        return fl.ln_residual_dropout_fwd(xs, os, scale, bias, eps, r, seed)

    out["k4_fwd_sha256"] = digest(k4(x, o, rate))
    out["k4_fwd_rate0_sha256"] = digest(k4(x, o))
    timed("k4_fwd", lambda: k4(x, o, rate), both=True)
    timed("k4_fwd_rate0", lambda: k4(x, o), both=True)
    timed("k4_fwd_zero_o", lambda: k4(x, zero), both=True)
    if takes_none:
        timed("k4_fwd_none", lambda: k4(x, None), both=True)
    r = k4(x, o)[0]
    sc16, bi16 = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
    timed("layer_norm", lambda: torch.nn.functional.layer_norm(r, (c,), sc16, bi16, eps),
          both=True)
    for rows in (960, 8):
        timed(f"k4_fwd_{rows}_zero_o", lambda: k4(x[:rows], zero[:rows]))
        if takes_none:
            timed(f"k4_fwd_{rows}_none", lambda: k4(x[:rows], None))
    x16, o16 = randn(1000, 1600), randn(1000, 1600)
    s16, b16 = 1 + randn(1600, scale=0.1, dtype=torch.float32), randn(
        1600, scale=0.1, dtype=torch.float32)
    timed("k4_fwd_1000x1600", lambda: fl.ln_residual_dropout_fwd(
        x16, o16, s16, b16, eps, rate, seed))

    for name, lengths in chip_smoke.PAGED_CASES:
        args = chip_smoke.paged_case(lengths, gen)
        timed(f"k3_{name}", lambda: pa.paged_attention_kernel(*args), both=True)

    rr, _, mean, rstd = k4(x, o, rate)

    def k4_bwd():
        return fl.ln_residual_dropout_bwd(rr, mean, rstd, scale, dr, dy, rate, seed)

    out["k4_bwd_sha256"] = digest(k4_bwd())
    timed("k4_bwd", k4_bwd)
    h, dout, b = randn(n, f), randn(n, f), randn(f, scale=0.1)
    out["k6_sha256"] = digest([fl.bias_gelu_dropout_fwd(h, b, rate, seed),
                               *fl.bias_gelu_dropout_bwd(h, b, dout, rate, seed)])
    timed("k6_fwd", lambda: fl.bias_gelu_dropout_fwd(h, b, rate, seed))
    timed("k6_bwd", lambda: fl.bias_gelu_dropout_bwd(h, b, dout, rate, seed))

    dr16 = randn(1000, 1600)
    for tag, (xs, os, ds) in (("", (x, o, dr)), ("_1000x1600", (x16, o16, dr16))):
        out[f"k5_fwd{tag}_sha256"] = digest([fl.residual_dropout_fwd(xs, os, rate, seed)])
        out[f"k5_scale{tag}_sha256"] = digest([fl.dropout_scale(ds, rate, seed)])
        timed(f"k5_fwd{tag}", lambda: fl.residual_dropout_fwd(xs, os, rate, seed), both=True)
        timed(f"k5_scale{tag}", lambda: fl.dropout_scale(ds, rate, seed), both=True)
    timed("add", lambda: torch.add(x, o), both=True)
    timed("mul", lambda: torch.mul(dr, 1.0 / 0.9), both=True)

    z = chip_smoke.signed_zero_case(256, 768)
    out["k5_zeros_sha256"] = digest([fl.residual_dropout_fwd(z["x"], z["o"], rate, seed),
                                     fl.dropout_scale(z["dr"], rate, seed)])
    k6_zeros = [fl.bias_gelu_dropout_fwd(z["h"], z["b"], rate, seed),
                *fl.bias_gelu_dropout_bwd(z["h"], z["b"], z["dout"], rate, seed)]
    out["k6_zeros_sha256"] = digest(k6_zeros)
    out["k6_zeros_unsigned_sha256"] = digest(
        [torch.where(z["planted"], t.abs(), t) for t in k6_zeros[:2]] + k6_zeros[2:])
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
