"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

In order, and failing (nonzero exit, no result line) at the first check
that does not hold:

1. prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and builds every kernel of the serving path from
   ``gpt_2_distributed_torch/csrc`` with one ``nvcc`` per source, in
   parallel;
2. K1, the flash-attention forward: the kernel against its plain version
   at [1, 12, T, 64] bf16 for T in 1024, 512, 208, 16 (208 and 16 ragged),
   element by element, plus a planted fault (one key tile swapped) that
   the check must reject; then times the kernel, the plain version and
   PyTorch's ``scaled_dot_product_attention`` (the yardstick; the port
   never calls it) with CUDA events, each launch on a flushed L2;
3. K3, paged decode: the kernel against its plain version at the serving
   pool shape (8 sequences, 12 heads, D 64, 513 blocks of 16) with mixed
   lengths including an idle slot, shuffled block placement, then all
   lengths 1024, plus a planted fault (one table entry swapped); times
   both versions the same way;
4. serves 8 requests (prompts of 1 to 960 tokens, 64 new tokens each)
   greedily, then the same 8 prompts sampled at temperature 1.0 (16 new
   tokens each), through ``ServingEngine`` at the full width of the 124M
   preset with random weights, bf16, max_batch 8, block_size 16, 513
   blocks; checks every request finished with its tokens and that the two
   runs launched K1 12 times per prefill and K3 12 times per decode step;
   prints how many greedy streams equal ``generate_cached(batch=1)``'s;
   then holds one prefill and one decode step of the kernel path against
   the plain path on the same pool state (fp32 logits);
5. prints the ``kernels`` JSON line, then the device line last.

``--profile`` adds, after step 4, a ``torch.profiler`` window over one
admission step (a 960-token prefill and one decode step) and over 8 decode
steps at batch 8, and
prints each window's wall time, device-busy time and its top kernels.

Every time here is measured on the card in this run; every bound is
computed from this run's shapes and the H100 SXM peaks (3.35 TB/s,
989 TFLOP/s bf16).
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

# Tolerances, each with its reason:
# Each kernel is held against its plain version run on the same values in
# fp32 (bf16 -> fp32 is exact), which keeps scores, probabilities and o in
# fp32. The kernel also computes in fp32 and differs from that reference
# by its one rounding of o to bf16 (at most half a bf16 ulp, <= 2^-8 |o|)
# plus fp32 summation-order noise (~1e-6 at |o| < 4). So, element by
# element, |o - ref| <= O_REL_TOL * |ref| + O_ABS_TOL.
O_REL_TOL = 2.0 ** -8
O_ABS_TOL = 2.0 ** -16
# lse is fp32 in both; only the order of the fp32 sums differs.
LSE_TOL = 1e-4
# Whole-model logits (std ~0.55 at this init) after 12 bf16 layers whose
# attention differs by the roundings above.
LOGITS_TOL = 0.1


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, flush: torch.Tensor, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each after a
    write of ``flush`` (larger than the 50 MB L2) so inputs come from HBM.

    A spin of ~1 ms on the stream before each start event keeps the card
    busy while the host enqueues ``fn``, so the interval between the two
    events holds ``fn``'s device work and not the host's launch latency."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


def held(o: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """Max |o - ref| and the largest ratio of an element's error to its
    tolerance (<= 1 passes)."""
    err = (o.float() - ref).abs()
    return err.max().item(), (err / (O_REL_TOL * ref.abs() + O_ABS_TOL)).max().item()


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_flash(flush) -> dict:
    from gpt_2_distributed_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_attention_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    row = None
    for t in (1024, 512, 208, 16):
        q, k, v = (torch.randn(1, 12, t, 64, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        o, lse = flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash_attention_plain(q.float(), k.float(), v.float())
        err_o, ratio = held(o, o_ref)
        err_lse = (lse - lse_ref).abs().max().item()
        print(f"K1 T={t}: max|o - plain| {err_o:.3e}, max err/tol {ratio:.3f}, "
              f"max|lse - plain| {err_lse:.3e} (tol {LSE_TOL:.0e})", flush=True)
        if not (ratio <= 1.0 and err_lse <= LSE_TOL):
            fail(f"K1 disagrees with its plain version at T={t}")
        max_err = max(max_err, err_o)
        if t == 1024:
            # Planted fault: key tile 5 replaced by tile 6, as a kernel that
            # loaded the wrong tile would see it. The check must reject it.
            k_bad = k.clone()
            k_bad[:, :, 320:384] = k[:, :, 384:448]
            _, ratio_bad = held(flash_attention_fwd(q, k_bad, v)[0], o_ref)
            print(f"K1 planted fault (one key tile swapped): max err/tol "
                  f"{ratio_bad:.1f}", flush=True)
            if ratio_bad <= 1.0:
                fail("the K1 check lets a planted fault through")
        ms = time_ms(lambda: flash_attention_fwd(q, k, v), flush)
        plain_ms = time_ms(lambda: flash_attention_plain(q, k, v), flush)
        lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True), flush)
        nbytes = 4 * q.numel() * 2 + lse.numel() * 4
        flops = 4 * 12 * 64 * t * (t + 1) / 2   # QK^T and PV on the causal half
        b_ms, b_by = bound_ms(nbytes, flops)
        print(f"K1 T={t}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})", flush=True)
        if row is None:   # the T = 1024 shape goes into the kernels line
            row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by)
    row["max_abs_err"] = max_err
    return row


def paged_case(lengths, gen, n=513, h=12, bs=16, d=64):
    """Pools of random bf16, and a table of shuffled distinct blocks."""
    b = len(lengths)
    m = 1024 // bs
    q = torch.randn(b, h, d, generator=gen, device="cuda", dtype=torch.bfloat16)
    kp = torch.randn(n, h, bs, d, generator=gen, device="cuda", dtype=torch.bfloat16)
    vp = torch.randn(n, h, bs, d, generator=gen, device="cuda", dtype=torch.bfloat16)
    perm = torch.randperm(n - 1, generator=torch.Generator().manual_seed(1)) + 1
    table = torch.zeros(b, m, dtype=torch.int32)
    used = 0
    for i, ln in enumerate(lengths):
        nb = -(-ln // bs)
        table[i, :nb] = perm[used:used + nb].int()
        used += nb
    return (q, kp, vp, table.cuda(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def phase_paged(flush) -> dict:
    from gpt_2_distributed_torch.ops.paged_attention import (
        paged_attention_kernel,
        paged_attention_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    max_err = 0.0
    row = None
    for name, lengths in (("mixed", [0, 1, 17, 1024, 300, 555, 64, 999]),
                          ("full", [1024] * 8)):
        args = paged_case(lengths, gen)
        q, kp, vp, table, lens = args
        o = paged_attention_kernel(*args)
        torch.cuda.synchronize()
        o_ref = paged_attention_plain(q.float(), kp.float(), vp.float(), table, lens)
        err, ratio = held(o, o_ref)
        idle = [i for i, ln in enumerate(lengths) if ln == 0]
        zeros_ok = all(torch.equal(o[i], torch.zeros_like(o[i])) for i in idle)
        print(f"K3 {name} lengths {lengths}: max|o - plain| {err:.3e}, max "
              f"err/tol {ratio:.3f}, idle rows exact zeros: {zeros_ok}", flush=True)
        if not (ratio <= 1.0 and zeros_ok):
            fail(f"K3 disagrees with its plain version ({name} lengths)")
        max_err = max(max_err, err)
        if name == "full":
            # Planted fault: sequence 0's sixth block swapped for sequence
            # 1's. The check must reject it.
            bad = table.clone()
            bad[0, 5] = table[1, 5]
            _, ratio_bad = held(paged_attention_kernel(q, kp, vp, bad, lens), o_ref)
            print(f"K3 planted fault (one table entry swapped): max err/tol "
                  f"{ratio_bad:.1f}", flush=True)
            if ratio_bad <= 1.0:
                fail("the K3 check lets a planted fault through")
        ms = time_ms(lambda: paged_attention_kernel(*args), flush)
        plain_ms = time_ms(lambda: paged_attention_plain(*args), flush)
        h, d = 12, 64
        s = sum(lengths)
        nbytes = 2 * s * h * d * 2 + 2 * 2 * len(lengths) * h * d + 4 * (
            sum(-(-ln // 16) for ln in lengths) + len(lengths))
        b_ms, b_by = bound_ms(nbytes, 4 * s * h * d)
        print(f"K3 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.5f} ms ({b_by})", flush=True)
        row = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                   bound_by=b_by)   # the full-length shape goes into the line
    row["max_abs_err"] = max_err
    return row


def profile_window(label: str, fn) -> None:
    """Wall time, summed device time and top kernels of ``fn``'s window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        n = fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profile {label}: {n} step(s), wall {wall_ms / n:.3f} ms/step, "
          f"device busy {busy_ms / n:.3f} ms/step "
          f"({100 * busy_ms / wall_ms:.1f}% of wall)", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3 / n:9.4f} ms/step  "
              f"{e.count / n:6.1f}/step  {e.key[:90]}", flush=True)


def phase_serving(profile_steps: bool) -> tuple[int, int]:
    from gpt_2_distributed_torch.config import MODEL_PRESETS, ServeConfig
    from gpt_2_distributed_torch.models import decode, gpt2
    from gpt_2_distributed_torch.ops.flash_attention import flash_attention_fwd
    from gpt_2_distributed_torch.ops.paged_attention import paged_attention_kernel
    from gpt_2_distributed_torch.serving import ServingEngine

    config = MODEL_PRESETS["124M"]
    serve = ServeConfig(max_batch=8, block_size=16, num_blocks=513)
    t0 = time.monotonic()
    params = gpt2.init_params(config, seed=0)
    eng = ServingEngine(params, config, serve, temperature=0.0)
    eng_s = ServingEngine(params, config, serve, temperature=1.0)
    print(f"serving: 124M (L={config.n_layer} C={config.n_embd} "
          f"H={config.n_head} V={config.vocab_size}), bf16, "
          f"KV pools {eng.kv_pool_bytes / 1e6:.1f} MB per engine, set-up "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    rng = torch.Generator().manual_seed(7)
    # Warm-up (allocator, cuBLAS handles), outside the counted run.
    for e in (eng, eng_s):
        e.submit([1, 2, 3], 2)
        e.run_until_idle()

    lengths = [1, 17, 100, 208, 400, 512, 777, 960]
    prompts = [torch.randint(0, config.vocab_size, (p,), generator=rng).tolist()
               for p in lengths]

    def run(e, label, new_tokens, seed0):
        before = dict(e.stats)
        t0 = time.monotonic()
        handles = [e.submit(p, new_tokens, seed=seed0 + i)
                   for i, p in enumerate(prompts)]
        e.run_until_idle()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        prefills = e.stats["prefills"] - before["prefills"]
        steps = e.stats["decode_steps"] - before["decode_steps"]
        decode_ms = e.stats["decode_ms"] - before["decode_ms"]
        toks = sum(len(h.generated) for h in handles)
        ttft = [(h.first_token_time - h.submit_time) * 1e3 for h in handles]
        print(f"serving {label}: {len(handles)} requests, {toks} tokens in "
              f"{wall:.3f} s ({toks / wall:.1f} tok/s), mean TTFT "
              f"{sum(ttft) / len(ttft):.2f} ms, {steps} decode steps at "
              f"{decode_ms / steps:.3f} ms/step, {prefills} prefills", flush=True)
        for h in handles:
            if h.finish_reason != "length" or len(h.generated) != new_tokens:
                fail(f"{label} request {h.id} finished {h.finish_reason!r} "
                     f"with {len(h.generated)} tokens")
            if not all(0 <= t < config.vocab_size for t in h.generated):
                fail(f"{label} request {h.id} emitted a token outside the vocab")
        return handles, prefills, steps

    flash_attention_fwd.launches = 0
    paged_attention_kernel.launches = 0
    greedy, pf_g, st_g = run(eng, "greedy", 64, 0)
    _, pf_s, st_s = run(eng_s, "sampled (temperature 1.0)", 16, 50)
    k1, k3 = flash_attention_fwd.launches, paged_attention_kernel.launches
    prefills, steps = pf_g + pf_s, st_g + st_s
    print(f"serving: launches K1 {k1}, K3 {k3} over {prefills} prefills and "
          f"{steps} decode steps", flush=True)
    n_layer = config.n_layer
    if not (k1 > 0 and k3 > 0 and k1 == n_layer * prefills
            and k3 == n_layer * steps):
        fail(f"launch counts K1 {k1} / K3 {k3} != {n_layer} x {prefills} "
             f"prefills / {n_layer} x {steps} decode steps")
    del eng_s

    # The engine's exactness oracle, on the card. Batch 1 and batch 8 (and
    # the prompt width against its block bucket) run different matmul and
    # attention tiles, so bit-identical streams are not required here: the
    # count is printed. The CPU tests require them.
    same = 0
    for h, p in zip(greedy, prompts):
        ids = decode.generate_cached(params, config, [p], max_new_tokens=64,
                                     temperature=0.0)
        same += ids[0, len(p):].tolist() == h.generated
    print(f"serving: {same} of {len(greedy)} greedy engine streams equal "
          f"generate_cached(batch=1)'s", flush=True)

    # Kernel path against plain path on the same state: one prefill, then
    # one decode step over the pools of 8 freshly admitted requests.
    with torch.no_grad():
        prompt = torch.tensor([prompts[-1]], device="cuda")
        pf = 960
        h_k, _ = decode.prefill(eng.w, config, prompt, pf, "kernel")
        h_p, _ = decode.prefill(eng.w, config, prompt, pf, "plain")
        lk, lp = gpt2.logits_fp32(eng.w, h_k[:, -1]), gpt2.logits_fp32(eng.w, h_p[:, -1])
        err_prefill = (lk - lp).abs().max().item()
        for i, p in enumerate(prompts):
            eng.submit(p, 8, seed=100 + i)
        eng.step()
        dk = eng.decode_logits("kernel")
        dp = eng.decode_logits("plain")
        err_decode = (dk - dp).abs().max().item()
        finite = bool(torch.isfinite(lk).all() and torch.isfinite(dk).all())
    eng.run_until_idle()
    if profile_steps:
        eng.submit(prompts[-1], 2)
        profile_window("admission (prefill T=960 + 1 decode)", lambda: (eng.step(), 1)[1])
        eng.run_until_idle()
        for i, p in enumerate(prompts):
            eng.submit(p, 16, seed=200 + i)
        eng.step()
        profile_window("decode batch 8",
                       lambda: sum((eng.step(), 1)[1] for _ in range(8)))
        eng.run_until_idle()
    print(f"serving: kernel vs plain fp32 logits: prefill max|diff| "
          f"{err_prefill:.3e}, decode max|diff| {err_decode:.3e} "
          f"(tol {LOGITS_TOL}, logits std {lp.std().item():.3f}), finite {finite}",
          flush=True)
    if not (finite and err_prefill <= LOGITS_TOL and err_decode <= LOGITS_TOL):
        fail("kernel path logits disagree with the plain path")
    return k1, k3


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from gpt_2_distributed_torch.kernels import build

    t0 = time.monotonic()
    reports = build.build(["flash_fwd", "paged_decode"])
    print(f"kernels built in {time.monotonic() - t0:.1f} s", flush=True)
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32, device="cuda")
    k1_row = phase_flash(flush)
    k3_row = phase_paged(flush)
    del flush
    k1, k3 = phase_serving("--profile" in sys.argv[1:])

    kernels = [
        dict(name="flash_attention_fwd", route="cuda",
             source="gpt_2_distributed_torch/csrc/flash_fwd.cu",
             replaces="gpt_2_distributed_tpu/ops/flash_attention.py:175",
             launches=k1, **k1_row),
        dict(name="paged_attention_kernel", route="cuda",
             source="gpt_2_distributed_torch/csrc/paged_decode.cu",
             replaces="gpt_2_distributed_tpu/ops/paged_attention.py:177",
             launches=k3, **k3_row),
    ]
    for k in kernels:
        k["kernel_ms"] = k["ms"]
        if not all(math.isfinite(k[x]) for x in ("ms", "plain_ms", "bound_ms")):
            fail(f"non-finite timing for {k['name']}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
