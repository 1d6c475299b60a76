"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

In order, and failing (nonzero exit, no result line) at the first check
that does not hold:

1. prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and builds every kernel of the serving and training
   paths from ``gpt_2_distributed_torch/csrc`` with one ``nvcc`` per
   source, in parallel;
2. K1, the flash-attention forward: the kernel against its plain version
   at [1, 12, T, 64] bf16 for T in 1024, 512, 208, 16 (208 and 16 ragged),
   element by element within a bound scaled by the sums of the products'
   absolute terms (K1 and K2 round P, ds and pd to bf16 as the TPU kernels
   do; ``flash_tolerance``), plus a planted fault (one key tile swapped)
   that the check must reject, its ratio printed; then times the kernel,
   the plain version and PyTorch's ``scaled_dot_product_attention`` (the
   yardstick; the port never calls it) with CUDA events, each launch on a
   flushed L2, with TFLOP/s of the causal products beside each;
   then, at the training shape [4, 12, 1024, 64], K1 with dropout 0.1
   against its plain version with the same seed, two launches
   bit-identical (planted fault: seed + 1), and K2, the flash backward, at
   dropout 0 and 0.1: dq, dk, dv against the plain backward in fp32 on the
   same lse and delta, two launches bit-identical, a planted fault (one key
   tile of v swapped), times beside SDPA's forward and backward;
3. K8, the ring's block kernel (``csrc/flash_block.cu``): forward and
   backward (with nonzero ``do`` and ``dlse``) against their plain
   versions in fp32 on the same bf16 values (both on the tensor cores,
   rounding P, ds and pd to bf16 as the TPU kernel does, within K1/K2's
   term-scaled bound with K8's terms, ``flash_block_error_terms``, each
   check's ratio printed), at [4, 12, 512, 64] (sp = 2)
   and [4, 12, 256, 64] (sp = 4) below, on and above the diagonal (the
   last exactly o = 0, lse = NEG_INF and zero grads) and a ragged
   [208 | 160] block, dropout 0 and 0.1, launches bit-identical,
   planted faults (seed + 1, col_off one tile off); times beside the plain
   version and SDPA with the block's boolean mask; then the package's
   ring schedule for all sp ranks in one process, through the
   single-process exchange seam, against K1/K2 over the whole sequence
   with the same seed ([4, 12, 1024, 64] at sp 2 and 4, [1, 12, 8192, 64]
   at sp 8), with K8 launched sp^2 times each way per call;
4. K3, paged decode: the kernel against its plain version at the serving
   pool shape (8 sequences, 12 heads, D 64, 513 blocks of 16) with mixed
   lengths including an idle slot, shuffled block placement, then all
   lengths 1024; two launches bit-identical, each sequence alone (B = 1,
   with the batch's table width and with its own blocks only) bit-equal
   to its row in the batch, planted faults (a table entry swapped inside
   a split and at a split's first block); times both versions the same
   way, "mixed" beside "full";
5. the fused layer epilogues of ``csrc/fused_layer.cu``: K4
   (LN+residual+dropout) forward and backward, K5 (residual+dropout)
   forward and its backward mask-scale, K6 (bias+GELU+dropout) forward
   and backward, at [4096, 768] / [4096, 3072] (124M, batch 4 x 1024) and
   at the ragged [1000, 1600] / [1000, 6400] (1.5B widths), dropout 0 and
   0.1: each against its plain version run in fp32 on the same values,
   element by element, K4's forward, K5's two kernels and the backward
   kernels twice and bit-identical, a planted fault per kernel (seed + 1);
   K4's forward at rate 0 row-invariant (rows of N = 1 and N = 8 calls
   bit-equal to N = 4096) and, with ``o=None``, bit-equal to a zero o at
   [8, 768] and [960, 768]; K5 and K6 with -0 planted at kept and dropped
   positions (x, o, dr, u = h + b and dout), their bits against the plain
   versions' (``signed_zeros_held``: K5 everywhere, K6 where u = -0);
   times at the 124M shape beside the plain version and the nearest
   PyTorch call (K4's forward also at rate 0, with ``o=None``, at
   serving's [960, 768] and [8, 768] and at [1000, 1600]; K5 also at
   [1000, 1600]), and the two
   passes (the rows, the column sums) of K4's and K6's backward apart with
   ``torch.profiler``; then both K6 kernels on h holding every finite bf16
   value ([64, 1024], b = 0, dout = 1) at dropout 0 and 0.1, against the
   plain versions wherever their values are finite in bf16, with the same
   non-finite values elsewhere, printing how many outputs differ in bits
   from the plain (tanh) form;
6. K7, the fused matmuls of ``csrc/fused_matmul.cu``: the forward (on
   ``wgmma`` from TMA-fed stages) with its bias, gelu and resid
   epilogues, the backward's du pass (against
   ``du_plain``: equal, within one bf16 ulp with the GELU; db; seed + 1
   rejected), dgrad and wgrad (each with and without the GELU) at the
   124M legs (qkv [4096, 768] -> 2304, attention
   proj -> 768, fc -> 3072, MLP proj [4096, 3072] -> 768) and the ragged
   1.5B legs [1000, 1600] -> 6400 and [1000, 6400] -> 1600, dropout 0 and
   0.1: each against its plain version run in fp32 on the same values,
   element by element within a bound that counts the fp32 summation of
   the contraction, every kernel twice and bit-identical, planted faults
   (seed + 1, one 64-deep stage of the contraction zeroed); the inference
   epilogues (the unfused product, the tied head) the same way and a row's
   bits alone, in a batch of 8 and inside 960 rows equal; times at the
   124M legs beside the plain version and ``torch.addmm``/``matmul``
   (dgrad and wgrad rows: the du pass and the product, as the TPU kernel's
   function, with the product alone beside it; the du pass alone);
7. K1's query-offset form (chunked prefill's attention): at starts 0, 16,
   512 and 944 with chunks of 16 and 256 rows over 1024 keys whose entries
   past the chunk hold random data, against its plain version in fp32
   within K1's term-scaled bound (``flash_offset_error_terms``), its rows
   bit-equal to K1's whole-prompt rows at the same positions, two launches
   bit-identical, four starts in one launch bit-equal to each alone, a
   planted fault (starts one block late); times at chunk 256 from 512 and
   chunk 16 from 944 beside the plain version and SDPA with the boolean
   offset mask;
8. the prefix cache and chunked, batched prefill (``phase_prefix_serving``)
   at 124M, ServeConfig(max_batch=8, block_size=16, num_blocks=513): a
   512-token prefix served first, then 8 requests of it plus suffixes of 0
   (a block-aligned full hit, copied on write) to 448 tokens, greedy (32 new
   tokens) and sampled at temperature 1.0 (16), on engines with the cache
   in whole-prompt mode (A), with chunks of 256, 4 a dispatch (B) and with
   no cache (OFF), and phase_serving's 8 prompts with chunks of 256 and no
   cache (C); requires every stream to equal ``generate_cached(batch=1)``'s,
   4095 or more prefix-hit tokens and a copy on write in A and B, and the
   launches of the offset form (12 a chunk dispatch), K1, K3, K7's forward
   and K4 equal to those the stats imply; prints each engine's mean TTFT,
   decode ms/step, dispatches and batched rows; holds one chunk dispatch's
   logits through the kernel against the plain attention and bit-equal to
   the whole-prompt prefill's; then, 5 runs an engine in turns (medians and
   ranges), the shared-prefix TTFT with the cache off and on (each run's
   streams equal to the first's) and the engine steps while a 960-token
   prompt is admitted whole (OFF) or in chunks of 256 (C) among 7 decoding
   streams;
9. watermark admission with preemption (``phase_preempt_serving``) at
   124M, ServeConfig(max_batch=8, block_size=16, num_blocks=54,
   admission="watermark", watermark_blocks=1): 8 prompts of 95 to 431
   tokens, greedy (96 new tokens) and then sampled at temperature 1.0 (32),
   on an engine in whole-prompt mode (W) and one with chunks of 256, 4 a
   dispatch, and the prefix cache (C); requires every stream to equal
   ``generate_cached(batch=1)``'s (a stream that differs prints its first
   differing step and the logits there), 4 or more preemptions an engine,
   a resume for each preemption of a request that had sampled, ``on_token``
   once a token, the allocator back to its free count, and the launches of
   K1, its offset form, K3 (also once a layer for each resume dispatch's
   decode-written rows), K7's forward and K4 equal to those the stats
   imply; prints each engine's preemptions, resumes, decode ms/step and
   step walls; then one request preempted after 40 decode steps and
   resumed: the K and V of its decode-written positions, layer by layer,
   against the decode step's bits (the engine's resume must change none),
   and with K1's offset form alone; then a migration: an engine of C's
   configuration stopped after one step with requests decoding,
   prefilling and queued, ``extract_inflight`` through ``to_wire``, JSON
   and ``from_wire`` into a second engine, every sampled stream equal to
   the uninterrupted one's and no token emitted twice;
10. serves 8 requests (prompts of 1 to 960 tokens, 64 new tokens each)
   greedily, then the same 8 prompts sampled at temperature 1.0 (16 new
   tokens each), through ``ServingEngine`` at the full width of the 124M
   preset with random weights, bf16, max_batch 8, block_size 16, 513
   blocks; checks every request finished with its tokens and the launches
   per prefill and decode step (K1 or K3 12 times, K7's forward 49 times,
   K4 25 times, with ``o=None``); requires every greedy and sampled stream to equal
   ``generate_cached(batch=1)``'s, printing for a stream that differs its
   first differing step and the logits there; then holds one prefill and
   one decode step of the kernel attention against the plain attention on
   the same pool state (fp32 logits);
11. speculative serving (``phase_spec_serving``): the serve CLI in this
   process with ``--model 345M --init_random --draft_preset 124M
   --spec_k 4``, greedy, 64 new tokens for the 8 prompts of 10 (the
   960-token one ends at position 1024, so its last round straddles the
   context end), and the same requests through an engine whose draft is
   the 345M's first 12 layers with its embeddings and final LayerNorm,
   which must accept at least one token: every stream equal to the 345M
   ``generate_cached(batch=1)``'s, and the launches the stats imply (K3
   24 a verify round and 12 a draft step, K+1 draft steps a round; K1 24
   a target prefill; K1's offset form 12 a draft catch-up; K7's forward
   and K4 for every forward); the kernel path against the plain path at
   16 heads and C 1024 (the 960-token 345M prefill, the sliced draft's
   catch-up of 8 rows, one verify window of 8 x 5 rows); a sampled run
   (temperature 1.0, 16 tokens) twice, equal; then the acceptance rate, the draft and verify ms a
   round and tok/s beside the plain 345M engine's on the same requests;
12. one 124M training micro-batch [4, 1024] with dropout 0.1 through the
   kernel path (K1/K2) and the plain path (dense attention), same params,
   batch and seeds, then at dropout 0 with ``fused_layers`` "all" (K4-K6)
   and with ``fused_matmul`` "all" over it (K7), each against "off": the
   loss and every grad;
13. trains: ``train.main()`` on synthetic shards at 124M full width, seq
   1024, batch 4, accum 4, dropout 0.1, 16 steps and one eval of 4
   batches, with ``--fused_layers off``, with ``all``, and with
   ``--fused_matmul all --fused_layers all``; checks finite losses, a
   first loss near ln 50257, a falling loss, no skipped step, and the
   exact launches: K1 = 12 x (micro-batches + eval batches), K2 = 12 x
   micro-batches in every run; with the fused layers alone K4 and K6
   forward = 12 x (micro-batches + eval batches), K4 and K6 backward, K5
   and its mask-scale = 12 x micro-batches; with the fused matmuls none of
   K4-K6, and K7's bias and gelu forward once and its resid forward twice
   a layer and batch, its du pass, dgrad and wgrad once a leg and
   micro-batch; prints each run's ms/step, tok/s and MFU, and the
   ``fused_matmul all`` step beside the ``fused_layers all`` step;
14. checkpoints and exact resume (``phase_resume``), at 124M with
   ``--fused_matmul all --fused_layers all`` as in 13: run A saves every 8
   steps with ``--async_save on`` (its losses bit-equal to 13's
   ``fused_matmul all`` run, no save failure, every checkpoint committed
   and verified); run B the same with ``--inject_preempt_at 9`` (exit 143,
   a committed emergency checkpoint of step 9, its losses A's first 9);
   run C ``--resume`` on B's dir to step 16 (its losses A's last 7, its
   final params, AdamW moments and step count bit-equal to A's final
   checkpoint); B and C launch together what A launches; then the serve CLI
   in this process with ``--ckpt`` on C's dir, greedy, 16 new tokens for
   phase_serving's first 4 prompts, every stream equal to
   ``generate_cached(batch=1)``'s on the params ``restore_params`` returns
   and the launches of K1, K3, K7's forward and K4 those its decode steps
   imply; prints a checkpoint's bytes, the step loop's stall for an async
   and a sync save, the commit time and the restore time;
15. the fault detectors of a mesh run (``phase_detectors``): the
   parameter fingerprint of the 124M params on the card, twice
   bit-identical, moved by ``perturb_params`` x1.001, bit-identical after
   x1.0, within 2^-20 sum|p| of the fp64 sum, and its median time over 20
   calls (the cost of one ``--desync_check_every`` check but its one small
   all-gather); then run A of 14 in a subprocess (``--detector_worker``)
   with ``--hang_timeout_s 10 --inject_hang_at 9 --trace_dir``: exit 170,
   a ``[watchdog]`` line naming the open spans, a committed and verified
   checkpoint of step 8 written by the watchdog's emergency save, the
   launches of 8 steps, the seconds from the last beat to the exit; then
   ``--resume`` on that dir in this process to step 16: its losses A's
   last 8 and its final params, AdamW moments and step count A's by
   sha256. With two or more cards, two ranks as independent processes
   over NCCL at data=2: ``--shard_update off --desync_check_every 2
   --inject_desync_at 2 --max_rollbacks 0`` names rank 1 and ends both
   ranks with rc 1, ``--inject_worker_fail_at 2`` ends both with rc 171 at
   the same step; on one card it prints that these runs need two GPUs and
   that the CPU tests hold them over gloo;
16. elastic resume (``phase_elastic``), at 124M with ``--fused_matmul all
   --fused_layers all``, dropout 0 and one loader worker: run E0 (batch
   4, accum 4, 16 steps, a save at step 8) and run E1, ``--resume`` on a
   copy of E0's step-8 checkpoint at batch 2, accum 8 (the same global
   batch, another loader shape): the ``[elastic] data cursor migrated``
   line, E1's final ``cursor_plan`` digest equal to
   ``replay_cursor_history``'s recomputed here (its milliseconds
   printed), E1's 8 losses within ELASTIC_LOSS_TOL of E0's last 8 (the
   largest difference printed), E1's launches those of its 64
   micro-batches. With two or more cards: a shrink, run S saving step 8
   at ``--mesh data=2 --batch 4 --grad_accum_steps 2`` as two independent
   processes over NCCL, resumed in this process on one card with ``--mesh
   data=2 --inject_world_size 1`` (``world resized: 2 -> 1``,
   ``--grad_accum_steps 2 -> 4``, the migrated cursor, losses within the
   bound of E0's last 8), and a grow, E0's step 8 resumed under
   ``--training_mode ddp`` on two cards (``--grad_accum_steps 4 -> 2``,
   equal losses on both ranks within the bound of E0's last 8); on one
   card it prints that these runs need two GPUs and that the CPU tests
   hold them over gloo; prints the phase's wall time;
17. the front end (``phase_frontend``): the serving CLI
   (``serving/serve.py`` on ``EngineDriver`` over a one-replica
   ``ReplicaRouter``) in subprocesses at 124M with random weights, greedy,
   64 new tokens for phase_serving's 8 prompts: untraced and SIGTERM'd
   after its first streamed token (every final record printed, exit 0),
   with ``--trace_dir``, and with ``--trace_dir --xla_profile_at 3:2
   --prefix_cache --prefill_chunk 256 --prefill_batch 4``; every stream
   equal to ``generate_cached(batch=1)``'s, every engine_step span holding
   admit and prefill and decode exactly when it decoded, the decode spans
   numbering the decode steps, the TTFT that ``scripts/obs_report.py``
   derives equal to each record's ``ttft_ms``, the profiler window's
   Chrome trace holding the decode annotation and the K3 and K7 kernels;
   prints tok/s of each run, the decode span's ms and each phase's share
   of the engine_step wall; then ``gpt2-torch-frontend`` with 2 replicas
   on port 0: /healthz, /metrics, 4 SSE streams at once equal to the
   CLI's, SIGTERM mid-stream, the streams completing and exit 0; then 2
   replicas in this process behind the affinity router with the prefix
   cache (8 sharers of a 512-token prefix among 4 strangers, greedy and
   sampled): every stream equal to ``generate_cached(batch=1)``'s, the
   sharers on one replica, the launches of K1, its offset form, K3, K7's
   forward and K4 equal to those the stats imply; then a traced training
   run of the "off" configuration: one ``step`` span an optimizer step,
   90% or more of the step wall attributed to named phases, the losses
   equal to the untraced run's bit for bit;
18. process isolation (``phase_workers``): a frontend in a child process
   (``--workers_frontend``) drives worker processes of this script
   (``--serve_worker``, the worker CLI with its launches and stats
   reported at its exit) at 124M on cuda, the 8 prompts of 10, max_batch
   8: a greedy fleet of two workers (the first building the serving
   kernels into an empty directory: the cold spawn) SIGKILLs worker 0 at
   fleet step 10 through ``FaultInjector(kill_at, kill_fn)``, an
   Autoscaler with a floor of 2 spawns the replacement (``worker_restarts``
   1), then hangs replica 1 at step 5 under a 3 s ``watchdog_timeout_s``
   (one trip, the replica failed and its streams migrated), then times
   the step RPC at batch 8 on the last worker; a sampled fleet
   (temperature 0.9, top-k 40) the same SIGKILL, then a SIGSTOP of worker
   1 found as heartbeat loss (two attempts of a 1 s
   ``--worker_heartbeat_timeout_s``) and the frozen process reaped; two TCP
   workers on hosts A and B (``--advertise``, an auth token) behind
   ``ChaosProxy``s, host A partitioned at step 10 (one host death,
   ``host_failures`` 1) and re-admitted after ``heal()``. Every stream
   equal to ``generate_cached(batch=1)``'s computed in this process, each
   token emitted once, ``scripts/obs_report.py``'s worker lifecycle rows
   (8 spawns, 3 respawns, a host lost and joined), one ``watchdog_fired``
   event, ``torch.cuda.is_initialized()`` false in the frontend at its end,
   and each reporting worker's launches those its stats imply; prints the
   median step wall through a worker against in process at batch 8 (the
   RPC's cost a step), spawn-to-ready cold and warm, and the ms from each
   fault to the migrated streams' next token;
19. with two or more cards, trains ``--mesh sp=2`` the same way through
    ``torch.distributed.run`` (NCCL; two ranks of this script in
    ``--sp_worker`` mode): finite, falling losses equal on both ranks, K8
    launched 12 x 2 x (micro-batches + eval batches) forward and 12 x 2 x
    micro-batches backward per rank, K1 = K2 = 0; prints its ms/step
    beside the local step's. On one card it prints that the NCCL ring
    needs two GPUs and that the CPU tests hold that path over gloo;
20. data-parallel and fully-sharded training: every rank of a data=2 x
    fsdp=2 mesh in this process (``phase_ddp_ranks``), K1, K2 and K4-K7 on
    its rows at 124M shapes with the per-shard seed against their plain
    versions, the ranks' masks all different, the unfused dropout's rank
    blocks equal to the global draw; then, with two or more cards, three
    runs of ``train.main()`` as in 13 through ``torch.distributed.run``
    (NCCL; ``--ddp_worker`` mode): ``--training_mode ddp`` (the update
    sharded by ``auto``) with ``--fused_layers all --fused_matmul all``,
    ``--training_mode fsdp`` and ``--mesh data=2 --shard_update off``:
    finite, falling losses equal on both ranks, the final params
    bit-identical across ranks, each rank's launches those its
    micro-batches imply, its AdamW moments 1/2 of the replicated layout's
    under fsdp and the sharded update, its fp32 params and grads 1/2 of
    the replicated layout's under fsdp, and the fsdp run's peak
    allocation below the replicated run's by at least half the state it
    sheds; prints ms/step and tok/s beside the local steps'. On one card
    it prints that the NCCL runs need two GPUs and that the CPU tests hold
    them over gloo;
21. prints the ``kernels`` JSON line, then the device line last.

``--profile`` times K2's two kernels (dk/dv, dq) apart with
``torch.profiler`` and adds profiler windows over one serving admission
step (a 960-token prefill and one decode step), one chunked admission
step (a 256-token chunk of a 960-token prompt and one decode step at
batch 7), 8 decode steps at batch 8 and one 124M optimizer step of each training run, and over rank 0's whole
sp=2 training run (set-up and eval included, divided by its 16 steps)
and rank 0's middle step of each two-card DDP/FSDP run (with its top host
operators),
and prints each window's wall time, device-busy time and its top kernels.

Every time here is measured on the card in this run; every bound is
computed from this run's shapes and the H100 SXM peaks (3.35 TB/s,
989 TFLOP/s bf16, 67 TFLOP/s fp32 outside the tensor cores).
"""

from __future__ import annotations

import collections
import json
import math
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
LOG2E = 1.4426950408889634

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
# K1 and K2 multiply on the tensor cores and, as the TPU kernels do, round
# the left operand of some products to bf16 where the plain versions keep
# fp32: the dropped probabilities before P v (K1), ds before dq and dk and
# pd before dv (K2). A bf16 rounding moves a product term by at most 2^-8
# of itself, so on top of the bound above each element of o, dq, dk and dv
# may move by 2^-8 times the sum of its product's absolute terms
# (``flash_error_terms``: sum_j P[t, j] |v[j]| for o with P the normalized
# probability after dropout, sum |ds| |k| / sqrt(D), sum |ds| |q| / sqrt(D),
# sum |pd| |do|): ``flash_tolerance``, |x - ref| <= 2^-8 |ref| + 2^-16 +
# 2^-8 terms, against the plain versions in fp32 on the same bf16 values,
# lse and delta. The scores stay fp32 sums of exact bf16 products, so lse
# keeps LSE_TOL. K8 rounds P, ds and pd the same way and is held to the
# same bound with its own terms (``flash_block_error_terms``: sum_c P[r, c]
# |v[c]|, sum |ds| |k| / sqrt(D), sum |ds| |q_s| / log2(e) with q_s the
# scaled q, sum |pd| |do|).

# Whole 124M model, one micro-batch, kernel path against plain path: the
# plain path's backward takes bf16 matmul outputs, where K2 keeps fp32 up
# to its bf16 ds and pd, and the two sum in other orders; those roundings
# (~2^-9 relative) move the loss (~10.8) by
# ~1e-3 and each grad tensor by ~1e-2 of its norm through 12 layers. The
# same bounds hold fused_layers "all" against "off": K6 keeps the GELU in
# fp32 where the unfused GELU rounds each of its bf16 steps; and
# fused_matmul "all" against "off": K7 adds the bias and the residual to
# the fp32 accumulator where the unfused model rounds the product first.
MODEL_LOSS_TOL = 0.02
MODEL_GRAD_TOL = 0.05

# The fused epilogues K4-K6 are held the same way, against their plain
# versions run in fp32 on the same bf16 values with the kernels' inner bf16
# roundings. Their column sums (dscale, dbias, db) add the same fp32 terms
# in other orders: each side lies within N 2^-24 sum|t| of the exact sum
# (the recursive-summation bound), so for N <= 4096 rows
# |d - ref| <= rel |ref| + COLSUM_TOL sum|t|, rel being db's one bf16
# rounding (O_REL_TOL) and 0 for the fp32 dscale and dbias.
COLSUM_TOL = 2.0 ** -11
# The epilogues do a few tens of fp32 and uint32 operations an element
# (the hash ~10, LayerNorm or tanh-GELU and its derivative ~10-25), timed
# against the CUDA cores' fp32 peak: a tenth of their byte time or less.
FP32_FLOPS_PER_S = 67e12

TRAIN_SHAPE = (4, 12, 1024, 64)   # [B, H, T, D] of 124M at batch 4, seq 1024
DROPOUT = 0.1
ATTN_SEED = 0x5EED1234
FUSED_SEED = 0x5EED4321
# [N, C, F] of the fused epilogues: 124M at batch 4 x 1024 (timed), and the
# 1.5B widths at a ragged row count.
FUSED_SHAPES = ((4096, 768, 3072), (1000, 1600, 6400))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, flush: torch.Tensor, iters: int = 20, warmup: int = 3,
            read_flush: bool = False) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each after a
    write of ``flush`` (larger than the 50 MB L2) so inputs come from HBM;
    with ``read_flush``, after a read of it instead (``flush.sum()``), which
    leaves the L2 holding clean lines rather than dirty ones.

    A spin of ~1 ms on the stream before each start event keeps the card
    busy while the host enqueues ``fn``, so the interval between the two
    events holds ``fn``'s device work and not the host's launch latency."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        if read_flush:
            flush.sum()
        else:
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


def held_flash(got: torch.Tensor, ref: torch.Tensor,
               terms: torch.Tensor) -> tuple[float, float]:
    """Max |got - ref| of a K1/K2 output and the largest ratio of an
    element's error to its term-scaled tolerance (<= 1 passes)."""
    from gpt_2_distributed_torch.ops.flash_attention import flash_tolerance

    err = (got.float() - ref).abs()
    return err.max().item(), (err / flash_tolerance(ref, terms)).max().item()


def bound_ms(nbytes: float, flops: float,
             peak: float = BF16_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def held_colsum(d: torch.Tensor, ref: torch.Tensor, terms: torch.Tensor,
                floor: float = 0.0) -> tuple[float, float]:
    """Max |d - ref| of a column sum and the largest ratio of an element's
    error to its tolerance, ``terms`` being the column's sum of |t| and
    ``floor`` an absolute part (a column of zeros, exact, has ratio 0)."""
    rel = O_REL_TOL if d.dtype == torch.bfloat16 else 0.0
    err = (d.float() - ref).abs()
    ratio = torch.where(err == 0, 0.0, err / (rel * ref.abs() + COLSUM_TOL * terms + floor))
    return err.max().item(), ratio.max().item()


def phase_flash(flush) -> None:
    """K1 without dropout at the serving path's prefill shapes."""
    from gpt_2_distributed_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_attention_plain,
        flash_error_terms,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    for t in (1024, 512, 208, 16):
        q, k, v = (torch.randn(1, 12, t, 64, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        o, lse = flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash_attention_plain(q.float(), k.float(), v.float())
        (terms,) = flash_error_terms(q, k, v)
        err_o, ratio = held_flash(o, o_ref, terms)
        err_lse = (lse - lse_ref).abs().max().item()
        print(f"K1 T={t}: max|o - plain| {err_o:.3e}, max err/tol {ratio:.3f}, "
              f"max|lse - plain| {err_lse:.3e} (tol {LSE_TOL:.0e})", flush=True)
        if not (ratio <= 1.0 and err_lse <= LSE_TOL):
            fail(f"K1 disagrees with its plain version at T={t}")
        if t == 1024:
            # Planted fault: key tile 5 replaced by tile 6, as a kernel that
            # loaded the wrong tile would see it. The check must reject it.
            k_bad = k.clone()
            k_bad[:, :, 320:384] = k[:, :, 384:448]
            _, ratio_bad = held_flash(flash_attention_fwd(q, k_bad, v)[0], o_ref, terms)
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
        print(f"K1 T={t}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms ({flops / lib_ms / 1e9:.1f} TFLOP/s), "
              f"bound {b_ms:.5f} ms ({b_by})", flush=True)


def sdpa_bwd(q, k, v, do, rate):
    """PyTorch's fused attention backward on the same inputs (the yardstick
    ``library_ms`` of K2; the port never calls it): the forward runs once
    outside the timed region, each timed call is one backward."""
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qg, kg, vg, dropout_p=rate, is_causal=True)
    return lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True)


def kernels_apart_ms(fn, flush, parts: dict[str, str], iters: int = 20) -> dict[str, float]:
    """Mean device time of each kernel that ``fn`` launches over ``iters``
    calls, each after an L2 flush, from torch.profiler: ``parts`` maps a
    label to a piece of the kernel's name (K2's dk/dv and dq kernels, K4
    backward's two passes)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        for label, piece in parts.items():
            if e.device_type == DeviceType.CUDA and piece in e.key:
                split[label] = e.self_device_time_total / e.count / 1e3
    return split


def phase_flash_train(flush, profile: bool) -> tuple[dict, dict]:
    """K1 with dropout and K2 at the training shape [4, 12, 1024, 64]; with
    ``profile`` also K2's two kernels timed apart."""
    from gpt_2_distributed_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
        flash_attention_fwd,
        flash_attention_plain,
        flash_error_terms,
    )

    b, h, t, d = TRAIN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, do = (torch.randn(b, h, t, d, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    seed = ATTN_SEED
    causal = 2 * b * h * d * t * (t + 1) / 2    # one causal [T, T] x [T, D] product

    # K1 with dropout, against its plain version in fp32 with the same seed.
    o, lse = flash_attention_fwd(q, k, v, DROPOUT, seed)
    torch.cuda.synchronize()
    o_ref, lse_ref = flash_attention_plain(q.float(), k.float(), v.float(), DROPOUT, seed)
    (terms,) = flash_error_terms(q, k, v, DROPOUT, seed)
    err_o, ratio = held_flash(o, o_ref, terms)
    err_lse = (lse - lse_ref).abs().max().item()
    again = flash_attention_fwd(q, k, v, DROPOUT, seed)
    same = torch.equal(again[0], o) and torch.equal(again[1], lse)
    print(f"K1 dropout {DROPOUT} {list(TRAIN_SHAPE)}: max|o - plain| {err_o:.3e}, "
          f"max err/tol {ratio:.3f}, max|lse - plain| {err_lse:.3e}; two launches "
          f"bit-identical: {same}", flush=True)
    if not (ratio <= 1.0 and err_lse <= LSE_TOL and same):
        fail("K1 with dropout disagrees with its plain version or with itself")
    # Planted fault: the next seed draws another mask.
    _, ratio_bad = held_flash(flash_attention_fwd(q, k, v, DROPOUT, seed + 1)[0], o_ref, terms)
    print(f"K1 dropout planted fault (seed + 1): max err/tol {ratio_bad:.1f}", flush=True)
    if ratio_bad <= 1.0:
        fail("the K1 dropout check lets a planted fault through")
    ms = time_ms(lambda: flash_attention_fwd(q, k, v, DROPOUT, seed), flush)
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, DROPOUT, seed), flush)
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, dropout_p=DROPOUT, is_causal=True), flush)
    b_ms, b_by = bound_ms(4 * q.numel() * 2 + lse.numel() * 4, 2 * causal)
    print(f"K1 dropout: kernel {ms:.4f} ms ({2 * causal / ms / 1e9:.1f} TFLOP/s), plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms ({2 * causal / lib_ms / 1e9:.1f} "
          f"TFLOP/s), bound {b_ms:.5f} ms ({b_by})", flush=True)
    k1_row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                  bound_by=b_by, max_abs_err=err_o)

    # K2 at dropout 0 and 0.1: both sides take K1's lse and the same delta.
    max_err = 0.0
    for rate in (0.0, DROPOUT):
        o, lse = flash_attention_fwd(q, k, v, rate, seed)
        delta = (do.float() * o.float()).sum(-1)
        grads = flash_attention_bwd(q, k, v, do, lse, delta, rate, seed)
        again = flash_attention_bwd(q, k, v, do, lse, delta, rate, seed)
        torch.cuda.synchronize()
        same = all(torch.equal(g, a) for g, a in zip(grads, again))
        refs = flash_attention_bwd_plain(q.float(), k.float(), v.float(), do.float(),
                                         lse, delta, rate, seed)
        terms = flash_error_terms(q, k, v, rate, seed, do=do, delta=delta)[1:]
        checks = [held_flash(g, r, w) for g, r, w in zip(grads, refs, terms)]
        print(f"K2 dropout {rate}: max|d - plain| dq {checks[0][0]:.3e} dk "
              f"{checks[1][0]:.3e} dv {checks[2][0]:.3e}; max err/tol "
              f"{max(c[1] for c in checks):.3f}; two launches bit-identical: {same}",
              flush=True)
        if not (same and all(c[1] <= 1.0 for c in checks)):
            fail(f"K2 at dropout {rate} disagrees with its plain version or "
                 f"with itself")
        max_err = max([max_err] + [c[0] for c in checks])
        # Planted fault: v's key tile 5 replaced by tile 6 (dq and dk see it
        # through do . v^T).
        v_bad = v.clone()
        v_bad[:, :, 320:384] = v[:, :, 384:448]
        bad = flash_attention_bwd(q, k, v_bad, do, lse, delta, rate, seed)
        ratio_bad = max(held_flash(g, r, w)[1] for g, r, w in zip(bad, refs, terms))
        print(f"K2 dropout {rate} planted fault (one v tile swapped): max "
              f"err/tol {ratio_bad:.1f}", flush=True)
        if ratio_bad <= 1.0:
            fail("the K2 check lets a planted fault through")
        ms = time_ms(lambda: flash_attention_bwd(q, k, v, do, lse, delta, rate, seed),
                     flush)
        plain_ms = time_ms(lambda: flash_attention_bwd_plain(
            q, k, v, do, lse, delta, rate, seed), flush)
        lib_ms = time_ms(sdpa_bwd(q, k, v, do, rate), flush)
        # Reads q, k, v, do (bf16), lse, delta (fp32); writes dq, dk, dv;
        # five causal products (s, do v^T, dq, dk, dv).
        b_ms, b_by = bound_ms(7 * q.numel() * 2 + 2 * lse.numel() * 4, 5 * causal)
        print(f"K2 dropout {rate}: kernel {ms:.4f} ms ({5 * causal / ms / 1e9:.1f} TFLOP/s "
              f"of the five products), plain {plain_ms:.4f} ms, sdpa backward {lib_ms:.4f} ms "
              f"({5 * causal / lib_ms / 1e9:.1f} TFLOP/s), bound {b_ms:.5f} ms ({b_by})",
              flush=True)
        if profile:
            split = kernels_apart_ms(
                lambda: flash_attention_bwd(q, k, v, do, lse, delta, rate, seed), flush,
                {"dk/dv": "flash_bwd_dkdv", "dq": "flash_bwd_dq"})
            print(f"K2 dropout {rate} kernels apart (torch.profiler, mean of 20 launches on "
                  f"a flushed L2): " + ", ".join(f"{n} {t:.4f} ms" for n, t in split.items()),
                  flush=True)
        k2_row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                      bound_by=b_by)   # the dropout-0.1 case goes into the line
    k2_row["max_abs_err"] = max_err
    return k1_row, k2_row


# K8's cases: (label, Tq, Tc, row_off, col_off) at [4, 12, T, 64]: the
# blocks a rank meets in the ring at sp = 2 (T/sp = 512) and sp = 4 (256) —
# below the diagonal (full), on it (triangular), above it (fully masked) —
# and a ragged block whose first 48 rows attend nothing in it.
BLOCK_CASES = tuple(
    (f"sp={sp} {where}", tl, tl, row, col)
    for sp, tl in ((2, 512), (4, 256))
    for where, row, col in (("below", tl, 0), ("diagonal", tl, tl), ("above", 0, tl))
) + (("ragged", 208, 160, 0, 48),)
# The ring on one card against K1/K2 over the whole sequence. The ring
# rounds each step's o_r to bf16 and combines in fp32, then rounds once
# more; K8 rounds q * scale to bf16 where K1 keeps it in fp32; the ring's
# dk and dv are sums of sp bf16 partial grads. So the two differ by a few
# bf16 roundings (2^-9 relative each): the output is held to a relative L2
# error of 2^-7 (two roundings' worth of headroom over the ~2^-8 expected)
# and each grad to 2^-6.
RING_O_TOL = 2.0 ** -7
RING_GRAD_TOL = 2.0 ** -6
RING_CASES = ((4, 1024, 2), (4, 1024, 4), (1, 8192, 8))   # (B, T, sp) at H 12, D 64


def rel_l2(x: torch.Tensor, ref: torch.Tensor) -> float:
    return ((x.float() - ref.float()).norm() / ref.float().norm()).item()


def phase_flash_block(flush) -> tuple[dict, dict]:
    """K8, the ring's block kernel, against its plain version (fp32 on the
    same bf16 values) at BLOCK_CASES, dropout 0 and 0.1, forward and
    backward under nonzero (do, dlse), both within the term-scaled bound
    (``held_flash``); a fully masked block exactly o = 0, lse = NEG_INF and
    zero grads; two launches of each bit-identical;
    planted faults (seed + 1, col_off one tile off); times at the full
    sp = 2 block beside the plain version and SDPA with the block's boolean
    mask (the yardstick; the port never calls it, and it gives no lse)."""
    from gpt_2_distributed_torch.ops import flash_block as fb

    b, h, d = 4, 12, 64
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {"flash_block_fwd": dict(max_abs_err=0.0), "flash_block_bwd": dict(max_abs_err=0.0)}

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    for label, tq, tc, row, col in BLOCK_CASES:
        q, do = randn(b, h, tq, d), randn(b, h, tq, d)
        k, v = randn(b, h, tc, d), randn(b, h, tc, d)
        dlse = randn(b, h, tq, dtype=torch.float32)
        for rate in (0.0, DROPOUT):
            kw = dict(seed=ATTN_SEED, dropout_rate=rate)
            o, lse = fb.flash_block_fwd(q, k, v, row, col, **kw)
            o2, lse2 = fb.flash_block_fwd(q, k, v, row, col, **kw)
            delta = ((do.float() * o.float()).sum(-1) - dlse * LOG2E).contiguous()
            grads = fb.flash_block_bwd(q, k, v, do, lse, delta, row, col, **kw)
            again = fb.flash_block_bwd(q, k, v, do, lse, delta, row, col, **kw)
            torch.cuda.synchronize()
            o_ref, lse_ref = fb.flash_block_plain(q, k, v, row, col, **kw)
            refs = fb.flash_block_bwd_plain(q, k, v, do, lse, delta, row, col, **kw)
            o_terms, *terms = fb.flash_block_error_terms(q, k, v, row, col, do=do, lse=lse,
                                                         delta=delta, **kw)
            err_o, ratio = held_flash(o, o_ref, o_terms)
            dead = lse_ref == fb.NEG_INF
            dead_exact = (torch.equal(lse == fb.NEG_INF, dead)
                          and not torch.count_nonzero(o[dead.unsqueeze(-1).expand_as(o)]))
            err_lse = (lse - lse_ref)[~dead].abs().max().item() if (~dead).any() else 0.0
            checks = [held_flash(g, r, w) for g, r, w in zip(grads, refs, terms)]
            same_fwd = torch.equal(o, o2) and torch.equal(lse, lse2)
            same = all(torch.equal(g, a) for g, a in zip(grads, again))
            print(f"K8 {label} [{b}, {h}, {tq}|{tc}, {d}] at ({row}, {col}) dropout {rate}: "
                  f"max|o - plain| {err_o:.3e}, max err/tol {ratio:.3f}, max|lse - plain| "
                  f"{err_lse:.3e}, {int(dead.sum())} fully masked rows exact: {dead_exact}, "
                  f"two launches bit-identical: {same_fwd}; "
                  f"backward max|d - plain| dq {checks[0][0]:.3e} dk {checks[1][0]:.3e} dv "
                  f"{checks[2][0]:.3e}, err/tol dq {checks[0][1]:.3f} dk {checks[1][1]:.3f} dv "
                  f"{checks[2][1]:.3f}, two launches bit-identical: {same}", flush=True)
            if not (ratio <= 1.0 and err_lse <= LSE_TOL and dead_exact and same_fwd and same
                    and all(c[1] <= 1.0 for c in checks)):
                fail(f"K8 disagrees with its plain version or with itself ({label}, "
                     f"dropout {rate})")
            if row < col and tq == tc and any(torch.count_nonzero(x) for x in (o, *grads)):
                fail(f"K8's fully masked block ({label}) is not exactly zero")
            rows["flash_block_fwd"]["max_abs_err"] = max(rows["flash_block_fwd"]["max_abs_err"],
                                                         err_o)
            rows["flash_block_bwd"]["max_abs_err"] = max(
                [rows["flash_block_bwd"]["max_abs_err"]] + [c[0] for c in checks])
            if label == "sp=2 diagonal" and rate > 0.0:
                # Planted faults: the next seed, and the key block placed one
                # tile later; the check must reject both, forward and backward.
                for what, row_, col_, seed_ in (("seed + 1", row, col, ATTN_SEED + 1),
                                                ("col_off + 64", row, col + 64, ATTN_SEED)):
                    kw_ = dict(seed=seed_, dropout_rate=rate)
                    bad_o = fb.flash_block_fwd(q, k, v, row_, col_, **kw_)[0]
                    bad_g = fb.flash_block_bwd(q, k, v, do, lse, delta, row_, col_, **kw_)
                    r_o = held_flash(bad_o, o_ref, o_terms)[1]
                    r_g = max(held_flash(g, r, w)[1] for g, r, w in zip(bad_g, refs, terms))
                    print(f"K8 planted fault ({what}): forward max err/tol {r_o:.1f}, "
                          f"backward {r_g:.1f}", flush=True)
                    if r_o <= 1.0 or r_g <= 1.0:
                        fail(f"the K8 check lets a planted fault through ({what})")
            if label == "sp=2 below" and rate > 0.0:
                mask = torch.ones(tq, tc, dtype=torch.bool, device="cuda")
                full = 2 * b * h * tq * tc * d     # one [Tq, Tc] x [., D] product
                fwd_ms = time_ms(lambda: fb.flash_block_fwd(q, k, v, row, col, **kw), flush)
                fwd_plain = time_ms(lambda: fb.flash_block_plain(q, k, v, row, col, **kw), flush)
                fwd_lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, dropout_p=rate), flush)
                fwd_b, fwd_by = bound_ms(4 * q.numel() * 2 + lse.numel() * 4, 2 * full)
                bwd_ms = time_ms(lambda: fb.flash_block_bwd(q, k, v, do, lse, delta, row, col,
                                                            **kw), flush)
                bwd_plain = time_ms(lambda: fb.flash_block_bwd_plain(
                    q, k, v, do, lse, delta, row, col, **kw), flush)
                qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
                out = torch.nn.functional.scaled_dot_product_attention(
                    qg, kg, vg, attn_mask=mask, dropout_p=rate)
                bwd_lib = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                                              retain_graph=True), flush)
                # Reads q, k, v, do, lse, delta; writes dq, dk, dv; five products.
                bwd_b, bwd_by = bound_ms(7 * q.numel() * 2 + 2 * lse.numel() * 4, 5 * full)
                print(f"K8 forward [{b}, {h}, {tq}|{tc}, {d}] full block, dropout {rate}: "
                      f"kernel {fwd_ms:.4f} ms, plain {fwd_plain:.4f} ms, sdpa with mask "
                      f"{fwd_lib:.4f} ms, bound {fwd_b:.5f} ms ({fwd_by}); backward: kernel "
                      f"{bwd_ms:.4f} ms, plain {bwd_plain:.4f} ms, sdpa backward with mask "
                      f"{bwd_lib:.4f} ms, bound {bwd_b:.5f} ms ({bwd_by})", flush=True)
                rows["flash_block_fwd"].update(ms=fwd_ms, plain_ms=fwd_plain, library_ms=fwd_lib,
                                               bound_ms=fwd_b, bound_by=fwd_by)
                rows["flash_block_bwd"].update(ms=bwd_ms, plain_ms=bwd_plain, library_ms=bwd_lib,
                                               bound_ms=bwd_b, bound_by=bwd_by)
    return rows["flash_block_fwd"], rows["flash_block_bwd"]


def phase_ring() -> dict[str, int]:
    """The package's ring schedule for all sp ranks in one process, through
    the single-process exchange seam, against K1/K2 over the whole sequence
    with the same seed, at RING_CASES with dropout 0.1: the output and dq,
    dk, dv. Counts K8's launches of each ring call (zeroed just before it):
    sp^2 forward and sp^2 backward. Returns the launches over all cases."""
    from gpt_2_distributed_torch.ops import flash_attention as fa
    from gpt_2_distributed_torch.ops import flash_block as fb
    from gpt_2_distributed_torch.ops.ring_attention import ring_attention_all_ranks

    total = {"flash_block_fwd": 0, "flash_block_bwd": 0}
    gen = torch.Generator(device="cuda").manual_seed(6)
    for b, t, sp in RING_CASES:
        q, k, v, do = (torch.randn(b, t, 12, 64, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))

        def run(attn):
            qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
            o = attn(qg, kg, vg)
            return (o, *torch.autograd.grad(o, (qg, kg, vg), do))

        ref = run(lambda a, b_, c: fa.flash_attention_bthd(a, b_, c, DROPOUT, ATTN_SEED))
        fb.flash_block_fwd.launches = fb.flash_block_bwd.launches = 0
        got = run(lambda a, b_, c: ring_attention_all_ranks(
            a, b_, c, sp=sp, dropout_rate=DROPOUT, seed=ATTN_SEED))
        torch.cuda.synchronize()
        launches = (fb.flash_block_fwd.launches, fb.flash_block_bwd.launches)
        total["flash_block_fwd"] += launches[0]
        total["flash_block_bwd"] += launches[1]
        errs = [rel_l2(g, r) for g, r in zip(got, ref)]
        finite = all(torch.isfinite(g).all() for g in got)
        print(f"ring on one card [{b}, {t}, 12, 64] sp={sp} dropout {DROPOUT}: relative L2 "
              f"against K1/K2 o {errs[0]:.3e} (tol {RING_O_TOL:.2e}), dq {errs[1]:.3e} dk "
              f"{errs[2]:.3e} dv {errs[3]:.3e} (tol {RING_GRAD_TOL:.2e}); K8 launches "
              f"forward {launches[0]}, backward {launches[1]} (sp^2 = {sp * sp})", flush=True)
        if not (finite and errs[0] <= RING_O_TOL and max(errs[1:]) <= RING_GRAD_TOL):
            fail(f"the one-card ring at sp={sp} disagrees with K1/K2")
        if launches != (sp * sp, sp * sp):
            fail(f"the ring at sp={sp} launched K8 {launches} times, not sp^2 each way")
    return total


FUSED_WRAPPERS = (
    # (wrapper name in ops/fused_layer.py, the TPU function it replaces)
    ("ln_residual_dropout_fwd", "gpt_2_distributed_tpu/ops/fused_layer.py:229"),
    ("ln_residual_dropout_bwd", "gpt_2_distributed_tpu/ops/fused_layer.py:267"),
    ("residual_dropout_fwd", "gpt_2_distributed_tpu/ops/fused_layer.py:414"),
    ("dropout_scale", "gpt_2_distributed_tpu/ops/fused_layer.py:465"),
    ("bias_gelu_dropout_fwd", "gpt_2_distributed_tpu/ops/fused_layer.py:487"),
    ("bias_gelu_dropout_bwd", "gpt_2_distributed_tpu/ops/fused_layer.py:499"),
)


# The two passes of K4's and K6's backward, by a piece of each kernel's name.
BWD_PASSES = {
    "ln_residual_dropout_bwd": {"rows": "ln_res_bwd", "column sums": "column_sum_kernel"},
    "bias_gelu_dropout_bwd": {"rows": "bias_gelu_bwd", "column sums": "column_sum_kernel"},
}


def phase_fused(flush) -> dict[str, dict]:
    """K4 (forward, backward), K5 (forward, backward rescale) and K6
    (forward, backward) against their plain versions at FUSED_SHAPES, at
    dropout 0 and 0.1 (K5 at 0.1), element by element; K4's and K5's
    kernels and the backward kernels twice, bit-identical; a planted fault
    per kernel (seed + 1); the signed zeros of K5 and K6
    (``signed_zeros_held``); then times at the 124M shape, dropout 0.1.
    Returns each wrapper's row of the kernels line."""
    from gpt_2_distributed_torch.ops import fused_layer as fl

    bf, eps = torch.bfloat16, 1e-5
    max_err = {name: 0.0 for name, _ in FUSED_WRAPPERS}
    rows = {}

    def hold(name, label, pairs, same=None):
        """pairs: (kind, kernel output, reference[, column terms]) with kind
        "elem", "stat" or "col"; ``same``: whether two launches gave the
        same bits. Fails unless every one holds."""
        ratio, err = 0.0, 0.0
        for kind, got, ref, *terms in pairs:
            if kind == "elem":
                e, q = held(got, ref)
            elif kind == "stat":
                e = (got - ref).abs().max().item()
                q = e / LSE_TOL
            else:
                e, q = held_colsum(got, ref, terms[0])
            err, ratio = max(err, e), max(ratio, q)
        max_err[name] = max(max_err[name], err)
        text = f"{name} {label}: max|d - plain| {err:.3e}, max err/tol {ratio:.3f}"
        if same is not None:
            text += f", two launches bit-identical: {same}"
        print(text, flush=True)
        if not (ratio <= 1.0 and same is not False):
            fail(f"{name} disagrees with its plain version ({label})")

    def planted(name, got, ref):
        _, ratio_bad = held(got, ref)
        print(f"{name} planted fault (seed + 1): max err/tol {ratio_bad:.1f}", flush=True)
        if ratio_bad <= 1.0:
            fail(f"the {name} check lets a planted fault through")

    for n, c, f in FUSED_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(n)

        def randn(*shape, scale=1.0, dtype=bf):
            return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

        x, o, dr, dy = (randn(n, c) for _ in range(4))
        scale = 1 + randn(c, scale=0.1, dtype=torch.float32)
        bias = randn(c, scale=0.1, dtype=torch.float32)
        h, dout, b = randn(n, f), randn(n, f), randn(f, scale=0.1)
        seed = FUSED_SEED
        for rate in (0.0, DROPOUT):
            label = f"[{n}, {c}] dropout {rate}"
            r, y, mean, rstd = fl.ln_residual_dropout_fwd(x, o, scale, bias, eps, rate, seed)
            again = fl.ln_residual_dropout_fwd(x, o, scale, bias, eps, rate, seed)
            ref = fl.ln_residual_dropout_plain(x.float(), o.float(), scale, bias, eps, rate,
                                               seed, dtype=bf)
            hold("ln_residual_dropout_fwd", label, [
                ("elem", r, ref[0]), ("elem", y, ref[1]), ("stat", mean, ref[2]),
                ("stat", rstd, ref[3])],
                same=all(torch.equal(g, a) for g, a in zip((r, y, mean, rstd), again)))
            grads = fl.ln_residual_dropout_bwd(r, mean, rstd, scale, dr, dy, rate, seed)
            again = fl.ln_residual_dropout_bwd(r, mean, rstd, scale, dr, dy, rate, seed)
            refs = fl.ln_residual_dropout_bwd_plain(r.float(), mean, rstd, scale, dr.float(),
                                                    dy.float(), rate, seed)
            rhat = (r.float() - mean[:, None]) * rstd[:, None]
            hold("ln_residual_dropout_bwd", label, [
                ("elem", grads[0], refs[0]), ("elem", grads[1], refs[1]),
                ("col", grads[2], refs[2], (dy.float() * rhat).abs().sum(0)),
                ("col", grads[3], refs[3], dy.float().abs().sum(0))],
                same=all(torch.equal(g, a) for g, a in zip(grads, again)))
            label = f"[{n}, {f}] dropout {rate}"
            out = fl.bias_gelu_dropout_fwd(h, b, rate, seed)
            out_ref = fl.bias_gelu_dropout_plain(h.float(), b.float(), rate, seed, dtype=bf)
            hold("bias_gelu_dropout_fwd", label, [("elem", out, out_ref)])
            dh, db = fl.bias_gelu_dropout_bwd(h, b, dout, rate, seed)
            dh2, db2 = fl.bias_gelu_dropout_bwd(h, b, dout, rate, seed)
            dh_p, db_p = fl.bias_gelu_dropout_bwd_plain(h.float(), b.float(), dout.float(),
                                                        rate, seed, dtype=bf)
            hold("bias_gelu_dropout_bwd", label, [
                ("elem", dh, dh_p), ("col", db, db_p, dh_p.abs().sum(0))],
                same=torch.equal(dh, dh2) and torch.equal(db, db2))
        if c == 768:
            check_ln_fwd_rows(x, o, scale, bias, eps)
            if not signed_zeros_held():
                fail("a K5 or K6 kernel writes another zero than its plain version")
        # K5 runs at dropout > 0 only (at 0 the op is the bare add).
        label = f"[{n}, {c}] dropout {DROPOUT}"
        r5 = fl.residual_dropout_fwd(x, o, DROPOUT, seed)
        r5_ref = fl.residual_dropout_plain(x.float(), o.float(), DROPOUT, seed, dtype=bf)
        hold("residual_dropout_fwd", label, [("elem", r5, r5_ref)],
             same=same_bits(r5, fl.residual_dropout_fwd(x, o, DROPOUT, seed)))
        do = fl.dropout_scale(dr, DROPOUT, seed)
        do_ref = fl.dropout_scale_plain(dr.float(), DROPOUT, seed, dtype=bf)
        hold("dropout_scale", label, [("elem", do, do_ref)],
             same=same_bits(do, fl.dropout_scale(dr, DROPOUT, seed)))
        # Planted faults: the next seed draws other masks.
        planted("ln_residual_dropout_fwd",
                fl.ln_residual_dropout_fwd(x, o, scale, bias, eps, DROPOUT, seed + 1)[0], ref[0])
        planted("ln_residual_dropout_bwd",
                fl.ln_residual_dropout_bwd(r, mean, rstd, scale, dr, dy, DROPOUT, seed + 1)[1],
                refs[1])
        planted("residual_dropout_fwd", fl.residual_dropout_fwd(x, o, DROPOUT, seed + 1), r5_ref)
        planted("dropout_scale", fl.dropout_scale(dr, DROPOUT, seed + 1), do_ref)
        planted("bias_gelu_dropout_fwd", fl.bias_gelu_dropout_fwd(h, b, DROPOUT, seed + 1),
                out_ref)
        planted("bias_gelu_dropout_bwd",
                fl.bias_gelu_dropout_bwd(h, b, dout, DROPOUT, seed + 1)[0], dh_p)
        if rows:
            continue

        # Times at the 124M shape, dropout 0.1, beside the plain versions
        # (on the bf16 tensors, as the CPU path runs them) and the nearest
        # single PyTorch call. Bytes: each input read once, each output
        # written once; operations per element as FP32_FLOPS_PER_S says.
        nc, nf = n * c, n * f
        sc16, bi16 = scale.to(bf), bias.to(bf)
        _, mean_l, rstd_l = torch.native_layer_norm(r, (c,), sc16, bi16, eps)
        u = h + b
        cases = {
            "ln_residual_dropout_fwd": (
                lambda: fl.ln_residual_dropout_fwd(x, o, scale, bias, eps, DROPOUT, seed),
                lambda: fl.ln_residual_dropout_plain(x, o, scale, bias, eps, DROPOUT, seed),
                lambda: torch.nn.functional.layer_norm(r, (c,), sc16, bi16, eps),
                8 * nc + 8 * c + 8 * n, 30 * nc),
            "ln_residual_dropout_bwd": (
                lambda: fl.ln_residual_dropout_bwd(r, mean, rstd, scale, dr, dy, DROPOUT, seed),
                lambda: fl.ln_residual_dropout_bwd_plain(r, mean, rstd, scale, dr, dy,
                                                         DROPOUT, seed),
                lambda: torch.ops.aten.native_layer_norm_backward(
                    dy, r, (c,), mean_l, rstd_l, sc16, bi16, [True, True, True]),
                10 * nc + 8 * n + 12 * c, 35 * nc),
            "residual_dropout_fwd": (
                lambda: fl.residual_dropout_fwd(x, o, DROPOUT, seed),
                lambda: fl.residual_dropout_plain(x, o, DROPOUT, seed),
                None, 6 * nc, 15 * nc),
            "dropout_scale": (
                lambda: fl.dropout_scale(dr, DROPOUT, seed),
                lambda: fl.dropout_scale_plain(dr, DROPOUT, seed),
                None, 4 * nc, 13 * nc),
            "bias_gelu_dropout_fwd": (
                lambda: fl.bias_gelu_dropout_fwd(h, b, DROPOUT, seed),
                lambda: fl.bias_gelu_dropout_plain(h, b, DROPOUT, seed),
                lambda: torch.nn.functional.gelu(u, approximate="tanh"),
                4 * nf + 2 * f, 30 * nf),
            "bias_gelu_dropout_bwd": (
                lambda: fl.bias_gelu_dropout_bwd(h, b, dout, DROPOUT, seed),
                lambda: fl.bias_gelu_dropout_bwd_plain(h, b, dout, DROPOUT, seed),
                lambda: torch.ops.aten.gelu_backward(dout, u, approximate="tanh"),
                6 * nf + 4 * f, 40 * nf),
        }
        time_ln_fwd_shapes(flush, x, o, scale, bias, eps, seed)
        for name, (kernel, plain, library, nbytes, ops) in cases.items():
            ms = time_ms(kernel, flush)
            plain_ms = time_ms(plain, flush)
            lib_ms = time_ms(library, flush) if library else None
            b_ms, b_by = bound_ms(nbytes, ops, FP32_FLOPS_PER_S)
            lib_text = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
            print(f"{name} [{n}, {f if 'gelu' in name else c}]: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, library {lib_text}, bound {b_ms:.5f} ms ({b_by})",
                  flush=True)
            rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                              bound_by=b_by)
            if name in BWD_PASSES:
                passes = kernels_apart_ms(kernel, flush, BWD_PASSES[name])
                print(f"{name} [{n}, {f if 'gelu' in name else c}] passes apart (torch.profiler, "
                      f"mean of 20 launches on a flushed L2): "
                      + ", ".join(f"{k} {t:.4f} ms" for k, t in passes.items()), flush=True)
                rows[name]["passes_ms"] = passes
        time_k5_shapes(flush, rows, seed)
    for name, row in rows.items():
        row["max_abs_err"] = max_err[name]
    return rows


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``a`` and ``b`` hold the same bits (NaN included)."""
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return a.dtype == b.dtype and torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype]))


def check_ln_fwd_rows(x, o, scale, bias, eps) -> None:
    """K4's forward at rate 0 over x, o [4096, C]: the rows of an N = 1 and
    an N = 8 call bit-equal to the same rows of the N = 4096 call (its strips
    differ with N), with o and with o = None; and with o = None (serving's
    LayerNorm: no o read, no r written) y, mean and rstd bit-equal to the
    call with a zero o at [8, C] and [960, C]."""
    from gpt_2_distributed_torch.ops import fused_layer as fl

    def fwd(xs, os):
        return fl.ln_residual_dropout_fwd(xs, os, scale, bias, eps)

    invariant = True
    for branch in (o, None):
        full = fwd(x, branch)
        for i, j in ((0, 1), (5, 6), (4095, 4096), (0, 8), (4088, 4096)):
            part = fwd(x[i:j], None if branch is None else branch[i:j])
            invariant &= all(p is None and f is None or same_bits(p, f[i:j])
                             for p, f in zip(part, full))
    zero_branch = True
    for n in (8, 960):
        with_zeros = fwd(x[:n], torch.zeros_like(x[:n]))
        without = fwd(x[:n], None)
        zero_branch &= without[0] is None and all(
            same_bits(a, b) for a, b in zip(without[1:], with_zeros[1:]))
    print(f"ln_residual_dropout_fwd rate 0: rows of N = 1 and N = 8 bit-equal to "
          f"N = 4096: {invariant}; o = None bit-equal to a zero o at [8, {x.shape[1]}] "
          f"and [960, {x.shape[1]}]: {zero_branch}", flush=True)
    if not (invariant and zero_branch):
        fail("K4's forward rows depend on the call, or o = None differs from o = 0")


def signed_zero_case(n: int, c: int) -> dict:
    """Random bf16 inputs of K5 and K6 at [n, c] on the card with -0 planted
    in every third column: o, dr and dout -0 there; x -0 in even rows, +0
    in rows 1 mod 4, random else; h and b -0 where u = -0 (even rows).
    Also the bool masks ``planted`` and ``u_zero``."""
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(c)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(bf)

    x, o, dr, h, dout = (randn(n, c) for _ in range(5))
    b = randn(c)
    zero = torch.zeros((), dtype=bf, device="cuda")
    rows = torch.arange(n, device="cuda")[:, None]
    planted = (torch.arange(c, device="cuda") % 3 == 0)[None, :].expand(n, c)
    u_zero = planted & (rows % 2 == 0)
    o, dr, dout = (torch.where(planted, -zero, t) for t in (o, dr, dout))
    return dict(x=torch.where(u_zero, -zero, torch.where(planted & (rows % 4 == 1), zero, x)),
                o=o, dr=dr, h=torch.where(u_zero, -zero, h),
                b=torch.where(planted[0], -zero, b), dout=dout, planted=planted,
                u_zero=u_zero)


def signed_zeros_held() -> bool:
    """-0 planted at kept and dropped positions of dropout 0.1
    (``signed_zero_case``) at [256, 768] (16-byte rows) and [100, 100] (the
    element path): K5's forward with o = -0 and x = -0, +0 or random, its
    rescale at dr = -0, K6's forward at u = h + b = -0 and its backward at
    dout = -0 there. The outputs' bits against the plain versions' on the
    card: K5's everywhere (the same roundings of the same IEEE quotient),
    K6's where u = -0 (elsewhere its sigmoid-form GELU may differ from the
    plain tanh form within the element bound, which ``phase_fused``
    holds). Prints the count of differing bits of each; True where none
    differ."""
    from gpt_2_distributed_torch.ops import fused_layer as fl

    seed = FUSED_SEED
    ok = True
    for n, c in ((256, 768), (100, 100)):
        t = signed_zero_case(n, c)
        x, o, dr, h, b, dout, planted, u_zero = (
            t[k] for k in ("x", "o", "dr", "h", "b", "dout", "planted", "u_zero"))
        differ = {
            "residual_dropout_fwd": (fl.residual_dropout_fwd(x, o, DROPOUT, seed),
                                     fl.residual_dropout_plain(x, o, DROPOUT, seed), None),
            "dropout_scale": (fl.dropout_scale(dr, DROPOUT, seed),
                              fl.dropout_scale_plain(dr, DROPOUT, seed), None),
            "bias_gelu_dropout_fwd": (fl.bias_gelu_dropout_fwd(h, b, DROPOUT, seed),
                                      fl.bias_gelu_dropout_plain(h, b, DROPOUT, seed), u_zero),
            "bias_gelu_dropout_bwd": (fl.bias_gelu_dropout_bwd(h, b, dout, DROPOUT, seed)[0],
                                      fl.bias_gelu_dropout_bwd_plain(h, b, dout, DROPOUT,
                                                                     seed)[0], u_zero),
        }
        parts = []
        for name, (got, ref, where) in differ.items():
            bad = got.view(torch.int16) != ref.view(torch.int16)
            if where is not None:
                bad = bad & where
            ok &= not bad.any().item()
            parts.append(f"{name} {int(bad.sum())} of "
                         f"{got.numel() if where is None else int(where.sum())}")
        kept = {salt: fl.epilogue_dropout_mask(seed, salt, (n, c), DROPOUT, "cuda")
                for salt in (fl.SALT_RESID, fl.SALT_GELU)}
        print(f"signed zeros at [{n}, {c}], dropout {DROPOUT}: -0 planted at "
              f"{int((planted & kept[fl.SALT_RESID]).sum())} kept and "
              f"{int((planted & ~kept[fl.SALT_RESID]).sum())} dropped positions (K5), u = "
              f"dout = -0 at {int((u_zero & kept[fl.SALT_GELU]).sum())} kept and "
              f"{int((u_zero & ~kept[fl.SALT_GELU]).sum())} dropped (K6); bits differing "
              f"from the plain version: " + ", ".join(parts), flush=True)
    return ok


def time_k5_shapes(flush, rows: dict, seed: int) -> None:
    """K5's forward and rescale at dropout 0.1 at [1000, 1600] (the 1.5B
    width, ragged rows) beside their [4096, 768] times in ``rows``, each
    with its bound."""
    from gpt_2_distributed_torch.ops import fused_layer as fl

    gen = torch.Generator(device="cuda").manual_seed(1600)
    x, o, dr = (torch.randn(1000, 1600, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(3))
    cases = (("residual_dropout_fwd", lambda: fl.residual_dropout_fwd(x, o, DROPOUT, seed), 6),
             ("dropout_scale", lambda: fl.dropout_scale(dr, DROPOUT, seed), 4))
    print("K5, dropout 0.1: " + "; ".join(
        f"{name} [4096, 768] {rows[name]['ms']:.4f} ms (bound {rows[name]['bound_ms']:.5f}), "
        f"[1000, 1600] {time_ms(fn, flush):.4f} ms (bound "
        f"{bound_ms(per * x.numel(), 0.0)[0]:.5f})" for name, fn, per in cases), flush=True)


def time_ln_fwd_shapes(flush, x, o, scale, bias, eps, seed) -> None:
    """K4's forward at the shapes beside the kernels line's: [4096, C] at
    rate 0 with o and with o = None, serving's [8, C] and [960, C] with o =
    None, and the 1.5B width [1000, 1600] at dropout 0.1."""
    from gpt_2_distributed_torch.ops import fused_layer as fl

    gen = torch.Generator(device="cuda").manual_seed(16)
    x16, o16 = (torch.randn(1000, 1600, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
    s16 = 1 + 0.1 * torch.randn(1600, generator=gen, device="cuda")
    b16 = 0.1 * torch.randn(1600, generator=gen, device="cuda")
    cases = (("[4096, 768] rate 0", lambda: fl.ln_residual_dropout_fwd(x, o, scale, bias, eps)),
             ("[4096, 768] o = None", lambda: fl.ln_residual_dropout_fwd(x, None, scale, bias,
                                                                        eps)),
             ("[960, 768] o = None", lambda: fl.ln_residual_dropout_fwd(x[:960], None, scale,
                                                                       bias, eps)),
             ("[8, 768] o = None", lambda: fl.ln_residual_dropout_fwd(x[:8], None, scale,
                                                                     bias, eps)),
             ("[1000, 1600] dropout 0.1", lambda: fl.ln_residual_dropout_fwd(
                 x16, o16, s16, b16, eps, DROPOUT, seed)))
    print("ln_residual_dropout_fwd: " + ", ".join(
        f"{label} {time_ms(fn, flush):.4f} ms" for label, fn in cases), flush=True)


def every_finite_bf16(rows: int = 64, width: int = 1024) -> torch.Tensor:
    """The 65,280 finite bf16 values in ascending bit order, zeros after
    them, as a bf16 ``[rows, width]`` tensor on the card filled column by
    column: each column holds neighbouring values, so the columns where
    gelu' is not finite are apart from the others."""
    u = torch.arange(2 ** 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    u = u[torch.isfinite(u.float())]
    out = torch.zeros(rows * width, dtype=torch.bfloat16)
    out[:u.numel()] = u
    return out.view(width, rows).t().contiguous().cuda()


def phase_gelu_every_bf16() -> None:
    """K6 forward and backward on h holding every finite bf16 value, b = 0
    and dout = 1 (so dh is gelu'(u), rescaled), at dropout 0 and 0.1: each
    against its plain version in fp32 within the element bound wherever the
    plain value is finite in bf16 (gelu' is 0 x inf for |u| >~ 5e19 in both
    forms; g / kp overflows bf16 above ~3.06e38), and the kernel's value
    non-finite, the same NaN or inf, everywhere else; db against the plain
    column sums where those are finite, within the column-sum bound plus
    the element bound's absolute part once a row: the tanh form rounds
    gelu' to exactly 0 for u below ~-9 where the sigmoid form keeps its
    tiny value, so a column of such u sums to 0 in one and not the other.
    Prints how many outputs differ in bits from the plain (tanh) form
    rounded to bf16."""
    from gpt_2_distributed_torch.ops import fused_layer as fl

    h = every_finite_bf16()
    b = torch.zeros(h.shape[1], dtype=torch.bfloat16, device="cuda")
    dout = torch.ones_like(h)

    def held_finite(what, got, ref, terms=None, floor=0.0):
        ref16 = ref.to(torch.bfloat16).float()
        fin = torch.isfinite(ref16)
        g = got.float()
        same_rest = all(torch.equal(k(g[~fin]), k(ref16[~fin]))
                        for k in (torch.isnan, torch.isposinf, torch.isneginf))
        if terms is None:
            err, ratio = held(got[fin], ref[fin])
        else:
            err, ratio = held_colsum(got[fin], ref[fin], terms[fin], floor)
        differ = int((g[fin] != ref16[fin]).sum())
        print(f"{what}: max|d - plain| {err:.3e}, max err/tol {ratio:.3f} over {int(fin.sum())} "
              f"finite values, {differ} differ in bits from the tanh form; the "
              f"{int((~fin).sum())} others non-finite alike: {same_rest}", flush=True)
        if not (ratio <= 1.0 and same_rest):
            fail(f"{what} disagrees with its plain version")

    for rate in (0.0, DROPOUT):
        label = f"every finite bf16 u, dropout {rate}"
        out = fl.bias_gelu_dropout_fwd(h, b, rate, FUSED_SEED)
        held_finite(f"bias_gelu_dropout_fwd {label}", out,
                    fl.bias_gelu_dropout_plain(h.float(), b.float(), rate, FUSED_SEED,
                                               dtype=torch.bfloat16))
        dh, db = fl.bias_gelu_dropout_bwd(h, b, dout, rate, FUSED_SEED)
        dh_p, db_p = fl.bias_gelu_dropout_bwd_plain(h.float(), b.float(), dout.float(), rate,
                                                    FUSED_SEED, dtype=torch.bfloat16)
        held_finite(f"bias_gelu_dropout_bwd dh {label}", dh, dh_p)
        held_finite(f"bias_gelu_dropout_bwd db {label}", db, db_p, dh_p.abs().sum(0),
                    h.shape[0] * O_ABS_TOL)


MM_SEED = 0x5EED7777
# The K7 legs (name, kind, N, K, M, salt): 124M at batch 4 x 1024 (timed),
# then the 1.5B widths at a ragged row count.
MM_LEGS = (
    ("qkv", "bias", 4096, 768, 2304, 0),
    ("attn proj", "resid", 4096, 768, 768, 5),
    ("fc", "gelu", 4096, 768, 3072, 4),
    ("mlp proj", "resid", 4096, 3072, 768, 6),
    ("1.5B fc", "gelu", 1000, 1600, 6400, 4),
    ("1.5B mlp proj", "resid", 1000, 6400, 1600, 6),
)
# K7 is held against its plain version run on fp32 copies of the same bf16
# values, with the kernel's inner roundings (du rounded to bf16 before the
# products; the inference epilogue's product rounded before its bias). Both
# sides sum the same K exact products in fp32 in other orders, each within
# K 2^-24 sum|t| of the exact sum, so for depths up to 8192 the sums differ
# by at most MM_SUM_TOL sum|t|; the kernel then rounds its output once
# (O_REL_TOL) and the epilogue carries the sum's error on (the GELU's slope
# stays below 1.13 and dropout divides by 0.9: EPI_GAIN). Element by
# element: |y - ref| <= O_REL_TOL |ref| + O_ABS_TOL + MM_SUM_TOL EPI_GAIN
# sum|t|. The inference epilogue rounds the product before adding the bias:
# where the two sums straddle a rounding boundary that rounding moves by
# one ulp, 2 O_REL_TOL of the product.
MM_SUM_TOL = 2.0 ** -10
EPI_GAIN = 1.25


def held_mm(got: torch.Tensor, ref: torch.Tensor, terms: torch.Tensor,
            extra: torch.Tensor | float = 0.0) -> tuple[float, float]:
    """Max |got - ref| of a product and the largest ratio of an element's
    error to its tolerance, ``terms`` being its sum of |t| (times the
    epilogue's gain)."""
    rel = O_REL_TOL if got.dtype == torch.bfloat16 else 0.0
    err = (got.float() - ref).abs()
    tol = rel * ref.abs() + O_ABS_TOL + MM_SUM_TOL * terms + extra
    return err.max().item(), (err / tol).max().item()


MM_WRAPPERS = (
    # (wrapper name in ops/fused_matmul.py, the TPU function it replaces)
    ("mm_bias_fwd", "gpt_2_distributed_tpu/ops/fused_matmul.py:154"),
    ("mm_gelu_fwd", "gpt_2_distributed_tpu/ops/fused_matmul.py:164"),
    ("mm_resid_fwd", "gpt_2_distributed_tpu/ops/fused_matmul.py:180"),
    ("mm_dgrad", "gpt_2_distributed_tpu/ops/fused_matmul.py:210"),
    ("mm_dgrad_gelu", "gpt_2_distributed_tpu/ops/fused_matmul.py:231"),
    ("mm_wgrad", "gpt_2_distributed_tpu/ops/fused_matmul.py:288"),
    ("mm_wgrad_gelu", "gpt_2_distributed_tpu/ops/fused_matmul.py:293"),
    # The backward's du, formed once a leg here; _dgrad_tile inside the
    # dgrad and wgrad pallas_calls there.
    ("mm_du", "gpt_2_distributed_tpu/ops/fused_matmul.py:201"),
)
# The inference epilogues of K7's forward kernel (serving's unfused
# products and the tied head): the forward of _mm_bias_fwd_kernel with
# other roundings, where the JAX package leaves the products to XLA.
MM_SERVE_WRAPPERS = (
    ("linear", "gpt_2_distributed_tpu/ops/fused_matmul.py:154"),
    ("head_logits", "gpt_2_distributed_tpu/ops/fused_matmul.py:154"),
)


def phase_matmul(flush) -> dict[str, dict]:
    """K7's forward (bias, gelu, resid), dgrad and wgrad kernels against
    their plain versions at MM_LEGS, dropout 0 and 0.1, element by element;
    every kernel launched twice and bit-identical; planted faults (seed + 1,
    and one 64-deep stage of the contraction zeroed); the inference epilogues
    (linear, head) likewise and bit-equal for a row alone, in a batch of 8
    and inside 960 rows; times at the 124M legs beside the plain version and
    ``torch.addmm``/``torch.matmul`` on the same product (the yardstick; the
    port never calls it). Returns each wrapper's row of the kernels line."""
    from gpt_2_distributed_torch.ops import fused_matmul as fm

    bf = torch.bfloat16
    max_err: dict[str, float] = {}
    rows: dict[str, dict] = {}
    # The leg whose times go into a wrapper's row of the kernels line.
    row_leg = {"mm_bias_fwd": "qkv", "mm_gelu_fwd": "fc", "mm_resid_fwd": "mlp proj",
               "mm_dgrad": "mlp proj", "mm_dgrad_gelu": "fc", "mm_wgrad": "mlp proj",
               "mm_wgrad_gelu": "fc", "mm_du": "fc"}

    def hold(name, label, checks, same):
        err = max(c[0] for c in checks)
        ratio = max(c[1] for c in checks)
        max_err[name] = max(max_err.get(name, 0.0), err)
        print(f"{name} {label}: max|d - plain| {err:.3e}, max err/tol {ratio:.3f}, "
              f"two launches bit-identical: {same}", flush=True)
        if not (ratio <= 1.0 and same):
            fail(f"{name} disagrees with its plain version or with itself ({label})")

    def planted(name, what, checks):
        ratio = max(c[1] for c in checks)
        print(f"{name} planted fault ({what}): max err/tol {ratio:.1f}", flush=True)
        if ratio <= 1.0:
            fail(f"the {name} check lets a planted fault through ({what})")

    def timed(name, leg, kernel, plain, library, nbytes, flops, peak=BF16_FLOPS_PER_S,
              extra=None):
        ms = time_ms(kernel, flush)
        plain_ms = time_ms(plain, flush)
        lib_ms = None if library is None else time_ms(library, flush)
        b_ms, b_by = bound_ms(nbytes, flops, peak)
        lib_text = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        speed = f"; {flops / ms / 1e9:.1f} TFLOP/s" if peak == BF16_FLOPS_PER_S else ""
        print(f"{name} {leg}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch "
              f"{lib_text}, bound {b_ms:.5f} ms ({b_by}){speed}", flush=True)
        if row_leg.get(name) == leg:
            rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                              bound_by=b_by, **(extra or {}))
        return ms

    for leg, kind, n, k, m, salt in MM_LEGS:
        gen = torch.Generator(device="cuda").manual_seed(n + k + m)

        def randn(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(bf)

        x, w, b = randn(n, k), randn(k, m, scale=k ** -0.5), randn(m, scale=0.1)
        r, g = randn(n, m), randn(n, m)
        xf, wf, bfl, rf, gf = (t.float() for t in (x, w, b, r, g))
        terms_fwd = xf.abs() @ wf.abs() + bfl.abs()
        # Planted faults: one 64-deep stage of each product's contraction
        # zeroed.
        x_bad = x.clone()
        x_bad[:, 64:128] = 0
        g_bad = g.clone()
        g_bad[:, 64:128] = 0
        xr_bad = x.clone()
        xr_bad[64:128] = 0
        fwd_name = f"mm_{kind}_fwd"
        gelu = kind == "gelu"
        u = None
        for rate in ((0.0,) if kind == "bias" else (0.0, DROPOUT)):
            label = f"{leg} [{n}, {k}] -> {m} dropout {rate}"
            seed = MM_SEED
            gain = EPI_GAIN / (1.0 - rate)
            if kind == "bias":
                def fwd(x_, seed_=seed):
                    return fm.mm_bias_fwd(x_, w, b), None
                ref = (fm.matmul_fwd_plain("bias", xf, wf, bfl), None)
            elif gelu:
                def fwd(x_, seed_=seed, rate_=rate):
                    return fm.mm_gelu_fwd(x_, w, b, rate_, seed_, salt)
                ref = fm.matmul_fwd_plain("gelu", xf, wf, bfl, None, rate, seed, salt)
            else:
                def fwd(x_, seed_=seed, rate_=rate):
                    return fm.mm_resid_fwd(x_, w, b, r, rate_, seed_, salt), None
                ref = (fm.matmul_fwd_plain("resid", xf, wf, bfl, rf, rate, seed, salt), None)
            (y, u), (y2, u2) = fwd(x), fwd(x)
            torch.cuda.synchronize()
            checks = [held_mm(y, ref[0], gain * terms_fwd)]
            same = torch.equal(y, y2)
            if gelu:
                checks.append(held_mm(u, ref[1], terms_fwd))
                same = same and torch.equal(u, u2)
            hold(fwd_name, label, checks, same)
            planted(fwd_name, "one K stage zeroed", [held_mm(fwd(x_bad)[0], ref[0],
                                                            gain * terms_fwd)])
            if rate > 0.0:
                planted(fwd_name, "seed + 1", [held_mm(fwd(x, seed + 1)[0], ref[0],
                                                       gain * terms_fwd)])

            # dgrad and wgrad, on the forward's bf16 u where the leg has one.
            uf = u.float() if gelu else None
            dsalt, bwd_rate = salt, (0.0 if kind == "bias" else rate)
            du = fm.du_plain(gf, uf, bwd_rate, seed, dsalt, bf)
            dg_name, wg_name = ("mm_dgrad_gelu", "mm_wgrad_gelu") if gelu else (
                "mm_dgrad", "mm_wgrad")
            dgrad_k, wgrad_k = getattr(fm, dg_name), getattr(fm, wg_name)
            uu = u if gelu else None

            # The leg as the autograd backward runs it: the du pass once,
            # then each product on that du.
            def dgrad(g_, seed_=seed):
                return dgrad_k(fm.mm_du(g_, uu, bwd_rate, seed_, dsalt)[0], w)

            def wgrad(x_, seed_=seed):
                du_, db_ = fm.mm_du(g, uu, bwd_rate, seed_, dsalt)
                return wgrad_k(x_, du_), db_

            # The du pass: equal to du_plain, within one bf16 ulp (2^-7
            # |du|) with the GELU, where the card's tanhf and torch's tanh
            # may differ in the last fp32 bit across a rounding boundary;
            # db as a column sum.
            def held_du(got):
                err = (got.float() - du).abs()
                tol = 2.0 ** -7 * du.abs() if gelu else torch.zeros_like(du)
                ratio = (err / tol).nan_to_num(0.0, float("inf"))
                return err.max().item(), ratio.max().item(), int((err > 0).sum())

            (du_k, db_k), (du_k2, db_k2) = (fm.mm_du(g, uu, bwd_rate, seed, dsalt)
                                            for _ in range(2))
            torch.cuda.synchronize()
            du_err, du_ratio, du_off = held_du(du_k)
            print(f"mm_du {label}: {du_off} of {du.numel()} elements off (one ulp allowed "
                  f"only with the GELU)", flush=True)
            hold("mm_du", label, [(du_err, du_ratio), held_mm(db_k, du.sum(0), du.abs().sum(0))],
                 torch.equal(du_k, du_k2) and torch.equal(db_k, db_k2))
            if bwd_rate > 0.0:
                bad_err, bad_ratio, bad_off = held_du(fm.mm_du(g, uu, bwd_rate, seed + 1,
                                                               dsalt)[0])
                print(f"mm_du planted fault (seed + 1): {bad_off} of {du.numel()} elements "
                      f"off", flush=True)
                planted("mm_du", "seed + 1", [(bad_err, bad_ratio)])

            dx, dx2 = dgrad(g), dgrad(g)
            dx_ref = fm.matmul_dgrad_plain(gf, wf, uf, bwd_rate, seed, dsalt, bf)
            terms_dx = du.abs() @ wf.abs().t()
            hold(dg_name, label, [held_mm(dx, dx_ref, terms_dx)], torch.equal(dx, dx2))
            planted(dg_name, "one contraction tile of dy zeroed",
                    [held_mm(dgrad(g_bad), dx_ref, terms_dx)])
            (dw, db), (dw2, db2) = wgrad(x), wgrad(x)
            dw_ref, db_ref = fm.matmul_wgrad_plain(xf, gf, uf, bwd_rate, seed, dsalt, bf)
            terms_dw = xf.abs().t() @ du.abs()
            hold(wg_name, label, [held_mm(dw, dw_ref, terms_dw),
                                  held_mm(db, db_ref, du.abs().sum(0))],
                 torch.equal(dw, dw2) and torch.equal(db, db2))
            planted(wg_name, "one tile of the summed rows zeroed",
                    [held_mm(wgrad(xr_bad)[0], dw_ref, terms_dw)])
            if bwd_rate > 0.0:
                planted(dg_name, "seed + 1", [held_mm(dgrad(g, seed + 1), dx_ref, terms_dx)])
                planted(wg_name, "seed + 1",
                        [held_mm(wgrad(x, seed + 1)[0], dw_ref, terms_dw)])
        if n != 4096:
            continue

        # Times at the 124M leg, dropout 0.1 (the bias leg at 0). Bytes:
        # each operand read once, each output written once.
        rate = 0.0 if kind == "bias" else DROPOUT
        seed = MM_SEED
        out = 2 * n * m * (2 if kind != "bias" else 1)   # gelu writes u, resid reads r
        flops = 2 * n * k * m
        if kind == "bias":
            kernel = lambda: fm.mm_bias_fwd(x, w, b)
        elif gelu:
            kernel = lambda: fm.mm_gelu_fwd(x, w, b, rate, seed, salt)
        else:
            kernel = lambda: fm.mm_resid_fwd(x, w, b, r, rate, seed, salt)
        timed(fwd_name, leg, kernel,
              lambda: fm.matmul_fwd_plain(kind, x, w, b, r, rate, seed, salt),
              lambda: torch.addmm(b, x, w), 2 * (n * k + k * m + m) + out, flops)
        # The backward of the leg: the du pass alone (bytes: g, u where the
        # leg has one, du unless it is g; ~30 fp32 and uint32 operations an
        # element for the hash, the division and gelu'), then each TPU
        # kernel's function, du pass and product together, its plain version
        # dgrad/wgrad with du inside, its bound over g (and u), the weight or
        # x and the output, and the product alone on the pass's du as
        # product_ms.
        uu = u if gelu else None
        u_bytes = 2 * n * m if gelu else 0
        dgrad_k, wgrad_k = getattr(fm, dg_name), getattr(fm, wg_name)
        du_k, _ = fm.mm_du(g, uu, rate, seed, salt)
        writes = gelu or rate > 0.0
        du_ms = timed("mm_du", leg, lambda: fm.mm_du(g, uu, rate, seed, salt),
                      lambda: fm.du_plain(g, uu, rate, seed, salt), None,
                      2 * n * m * (1 + gelu + writes) + 4 * m, 30 * n * m, FP32_FLOPS_PER_S)
        dp_ms = time_ms(lambda: dgrad_k(du_k, w), flush)
        wp_ms = time_ms(lambda: wgrad_k(x, du_k), flush)
        d_ms = timed(dg_name, leg, lambda: dgrad_k(fm.mm_du(g, uu, rate, seed, salt)[0], w),
                     lambda: fm.matmul_dgrad_plain(g, w, uu, rate, seed, salt),
                     lambda: torch.matmul(g, w.t()), 2 * (n * m + k * m + n * k) + u_bytes,
                     flops, extra={"product_ms": dp_ms})
        w_ms = timed(wg_name, leg, lambda: wgrad_k(x, fm.mm_du(g, uu, rate, seed, salt)[0]),
                     lambda: fm.matmul_wgrad_plain(x, g, uu, rate, seed, salt),
                     lambda: torch.matmul(x.t(), g),
                     2 * (n * k + n * m + k * m) + 4 * m + u_bytes, flops,
                     extra={"product_ms": wp_ms})
        print(f"K7 backward {leg}: du pass {du_ms:.4f} ms; dgrad product alone {dp_ms:.4f}, "
              f"with its du pass {d_ms:.4f} ms; wgrad product alone {wp_ms:.4f}, with its du "
              f"pass {w_ms:.4f} ms; the leg (one du pass, two products) "
              f"{du_ms + dp_ms + wp_ms:.4f} ms", flush=True)

    # The inference epilogues at the serving shapes: a decode step's fc
    # product [8, 768] -> 3072 and its head [8, 768] -> 50257, held to their
    # plain versions, and a row's bits alone, in a batch of 8 and inside 960
    # rows (where it sits at another place in its tile).
    gen = torch.Generator(device="cuda").manual_seed(9)
    c, f, v = 768, 3072, 50257
    h = torch.randn(960, c, generator=gen, device="cuda").to(bf)
    w = (torch.randn(c, f, generator=gen, device="cuda") * c ** -0.5).to(bf)
    b = (torch.randn(f, generator=gen, device="cuda") * 0.1).to(bf)
    wte = (torch.randn(v, c, generator=gen, device="cuda") * 0.02).to(bf)
    for name, fn, ref_fn, terms_fn in (
            ("linear", lambda t: fm.linear(t, w, b),
             lambda t: fm.linear_plain(t.float(), w.float(), b.float(), bf),
             lambda t: t.float().abs() @ w.float().abs()),
            ("head_logits", lambda t: fm.head_logits(t, wte),
             lambda t: fm.head_plain(t, wte),
             lambda t: t.float().abs() @ wte.float().abs().t())):
        for rows_n in (8, 960):
            got, again = fn(h[:rows_n]), fn(h[:rows_n])
            ref = ref_fn(h[:rows_n])
            extra = 0.0
            if name == "linear":   # the product rounded before its bias
                extra = 2 * O_REL_TOL * (h[:rows_n].float() @ w.float()).abs()
            torch.cuda.synchronize()
            hold(name, f"[{rows_n}, {c}] -> {got.shape[1]}",
                 [held_mm(got, ref, terms_fn(h[:rows_n]), extra)], torch.equal(got, again))
        full = fn(h)
        invariant = torch.equal(fn(h[:8]), full[:8]) and all(
            torch.equal(fn(h[i:i + 1])[0], full[i]) for i in (0, 5, 130, 959))
        print(f"{name}: rows 0, 5, 130, 959 alone, in a batch of 8 and inside 960 rows "
              f"bit-equal: {invariant}", flush=True)
        if not invariant:
            fail(f"{name}: a row's result depends on the rows beside it")
        x8 = h[:8]
        if name == "linear":
            kernel, plain = (lambda: fm.linear(x8, w, b),
                             lambda: fm.linear_plain(x8, w, b))
            library, n_out = (lambda: torch.addmm(b, x8, w)), f
            nbytes = 2 * (8 * c + c * f + f + 8 * f)
        else:
            kernel, plain = (lambda: fm.head_logits(x8, wte),
                             lambda: fm.head_plain(x8, wte))
            library, n_out = (lambda: torch.matmul(x8, wte.t())), v
            nbytes = 2 * (8 * c + v * c) + 4 * 8 * v
        ms = time_ms(kernel, flush)
        plain_ms = time_ms(plain, flush)
        lib_ms = time_ms(library, flush)
        b_ms, b_by = bound_ms(nbytes, 2 * 8 * c * n_out)
        print(f"{name} [8, {c}] -> {n_out}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})", flush=True)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                          bound_by=b_by)
    for name, row in rows.items():
        row["max_abs_err"] = max_err[name]
    return rows


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


PAGED_CASES = (("mixed", [0, 1, 17, 1024, 300, 555, 64, 999]), ("full", [1024] * 8))


def check_paged(name: str, args) -> float:
    """K3 on one case against its plain version in fp32, idle rows exact
    zeros, two launches bit-identical, and each sequence's bits alone (B =
    1, with the batch's table width and with its table cut to its own
    blocks) equal to its bits in the batch; planted faults (a table entry
    swapped inside a split, and at a split's first block) rejected. Returns
    max |o - plain|."""
    from gpt_2_distributed_torch.ops.paged_attention import (
        paged_attention_kernel,
        paged_attention_plain,
        split_blocks,
    )

    q, kp, vp, table, lens = args
    lengths = lens.tolist()
    bs = kp.shape[2]
    o = paged_attention_kernel(*args)
    again = paged_attention_kernel(*args)
    torch.cuda.synchronize()
    o_ref = paged_attention_plain(q.float(), kp.float(), vp.float(), table, lens)
    err, ratio = held(o, o_ref)
    idle = [i for i, ln in enumerate(lengths) if ln == 0]
    zeros_ok = all(torch.equal(o[i], torch.zeros_like(o[i])) for i in idle)
    same = torch.equal(o, again)
    alone = all(
        torch.equal(paged_attention_kernel(q[i:i + 1], kp, vp, t, lens[i:i + 1])[0], o[i])
        for i, ln in enumerate(lengths)
        for t in (table[i:i + 1], table[i:i + 1, :max(1, -(-ln // bs))].contiguous()))
    print(f"K3 {name} lengths {lengths}: max|o - plain| {err:.3e}, max "
          f"err/tol {ratio:.3f}, idle rows exact zeros: {zeros_ok}, two launches "
          f"bit-identical: {same}, each sequence alone (B = 1) bit-equal to the "
          f"batch: {alone}", flush=True)
    if not (ratio <= 1.0 and zeros_ok and same and alone):
        fail(f"K3 disagrees with its plain version or itself ({name} lengths)")
    if name == "full":
        # Planted faults: sequence 0's sixth block, then the first block of
        # its second split, swapped for sequence 1's. The check must reject
        # both.
        for label, j in (("inside a split", 5), ("at a split's first block",
                                                  split_blocks(bs))):
            bad = table.clone()
            bad[0, j] = table[1, j]
            _, ratio_bad = held(paged_attention_kernel(q, kp, vp, bad, lens), o_ref)
            print(f"K3 planted fault (one table entry swapped {label}): max err/tol "
                  f"{ratio_bad:.1f}", flush=True)
            if ratio_bad <= 1.0:
                fail(f"the K3 check lets a planted fault {label} through")
    return err


def phase_paged(flush) -> dict:
    from gpt_2_distributed_torch.ops.paged_attention import (
        paged_attention_kernel,
        paged_attention_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    max_err = 0.0
    row = None
    for name, lengths in PAGED_CASES:
        args = paged_case(lengths, gen)
        max_err = max(max_err, check_paged(name, args))
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


def profile_window(label: str, fn, host_ops: int = 0) -> None:
    """Wall time, summed device time and top kernels of ``fn``'s window
    (and its top ``host_ops`` operators by host self time)."""
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
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:16]:
        print(f"  {e.self_device_time_total / 1e3 / n:9.4f} ms/step  "
              f"{e.count / n:6.1f}/step  {e.key[:90]}", flush=True)
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:host_ops]
    for e in ops:
        print(f"  host {e.self_cpu_time_total / 1e3 / n:9.4f} ms/step  "
              f"{e.count / n:7.1f}/step  {e.key[:80]}", flush=True)


def print_first_difference(label: str, w: dict, config, p: list[int], got: list[int],
                           want: list[int]) -> None:
    """A stream that differs from generate_cached(batch=1)'s: its first
    differing step, the two tokens' logits there and the top-two gap, from
    a batch-1 prefill of the common prefix."""
    from gpt_2_distributed_torch.models import decode, gpt2

    t = next(j for j, (a, c) in enumerate(zip(got, want)) if a != c)
    with torch.no_grad():
        hid, _ = decode.prefill(w, config, torch.tensor([p + want[:t]], device="cuda"),
                                len(p) + t)
        logits = gpt2.logits_fp32(w, hid[:, -1])[0]
    top = logits.topk(2).values
    print(f"{label} (prompt {len(p)}): first differing step {t}: engine token {got[t]} "
          f"(logit {logits[got[t]].item():.6f}), generate_cached token {want[t]} (logit "
          f"{logits[want[t]].item():.6f}), top-two gap {(top[0] - top[1]).item():.3e}",
          flush=True)


SERVING_LENGTHS = (1, 17, 100, 208, 400, 512, 777, 960)


def phase_serving(profile_steps: bool) -> dict[str, int]:
    """Serves the 8 requests greedily and sampled; returns the launches of
    the serving path's kernels by wrapper name."""
    from gpt_2_distributed_torch.config import MODEL_PRESETS, ServeConfig
    from gpt_2_distributed_torch.models import decode, gpt2
    from gpt_2_distributed_torch.ops import fused_matmul as fm
    from gpt_2_distributed_torch.ops.flash_attention import flash_attention_fwd
    from gpt_2_distributed_torch.ops.fused_layer import ln_residual_dropout_fwd
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

    prompts = [torch.randint(0, config.vocab_size, (p,), generator=rng).tolist()
               for p in SERVING_LENGTHS]

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

    wrappers = {"flash_attention_fwd": flash_attention_fwd,
                "paged_attention_kernel": paged_attention_kernel,
                "linear": fm.linear, "head_logits": fm.head_logits,
                "ln_residual_dropout_fwd": ln_residual_dropout_fwd}
    for wrapper in wrappers.values():
        wrapper.launches = 0
    greedy, pf_g, st_g = run(eng, "greedy", 64, 0)
    sampled, pf_s, st_s = run(eng_s, "sampled (temperature 1.0)", 16, 50)
    got = {name: wrapper.launches for name, wrapper in wrappers.items()}
    prefills, steps = pf_g + pf_s, st_g + st_s
    print(f"serving: launches {got} over {prefills} prefills and {steps} decode steps",
          flush=True)
    # Per prefill and per decode step: K1 (prefill) or K3 (decode) once a
    # layer; the qkv, out-projection, fc and proj products a layer and the
    # head once through K7's forward; two LayerNorms a layer and the final
    # one through K4.
    n_layer = config.n_layer
    want = {"flash_attention_fwd": n_layer * prefills, "paged_attention_kernel": n_layer * steps,
            "linear": 4 * n_layer * (prefills + steps), "head_logits": prefills + steps,
            "ln_residual_dropout_fwd": (2 * n_layer + 1) * (prefills + steps)}
    if not (prefills and steps and got == want):
        fail(f"serving launch counts {got} != {want}")
    del eng_s

    # The engine's exactness oracle, on the card: every stream equals
    # generate_cached(batch=1)'s, greedy and sampled. A stream that differs
    # is localised: its first differing step, and the two tokens' logits
    # and the top-two gap of a batch-1 prefill of the common prefix.
    def oracle(p, new, seed, temperature):
        return decode.generate_cached(params, config, [p], seed=seed, max_new_tokens=new,
                                      temperature=temperature,
                                      block_size=serve.block_size)[0, len(p):].tolist()

    differ = 0
    for label, handles, new, seed0, temperature in (("greedy", greedy, 64, 0, 0.0),
                                                    ("sampled", sampled, 16, 50, 1.0)):
        same = 0
        for i, (h, p) in enumerate(zip(handles, prompts)):
            want_ids = oracle(p, new, seed0 + i, temperature)
            if want_ids == h.generated:
                same += 1
                continue
            print_first_difference(f"serving {label} request {h.id}", eng.w, config, p,
                                   h.generated, want_ids)
        print(f"serving: {same} of {len(handles)} {label} engine streams equal "
              f"generate_cached(batch=1)'s", flush=True)
        differ += len(handles) - same
    if differ:
        fail(f"{differ} engine streams differ from generate_cached(batch=1)'s")

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
    return got


# Speculative serving: the serve CLI's 345M target with a 124M draft, K
# draft tokens a round, phase_serving's prompts; greedy then sampled.
SPEC_K = 4
SPEC_NEW = (64, 16)
SPEC_SLICE = 12   # layers of the 345M target that make the self-sliced draft


def spec_launches(n_layer: int, d_layer: int, k: int, prefills: int, rounds: int,
                  catchups: int) -> dict[str, int]:
    """The launches a speculative engine's stats imply: a target
    whole-prompt prefill is one K1 launch a layer; a round is K+1 draft
    decode steps and one verify, each one K3 launch a layer of its model;
    a catch-up one K1 offset launch a draft layer. Each of these forwards
    runs 4 products a layer and the head through K7's forward and 2
    LayerNorms a layer and the final one through K4."""
    target = prefills + rounds             # target forwards
    draft = (k + 1) * rounds + catchups    # draft forwards
    return {"flash_attention_fwd": n_layer * prefills,
            "flash_attention_fwd_offset": d_layer * catchups,
            "paged_attention_kernel": n_layer * rounds + d_layer * (k + 1) * rounds,
            "linear": 4 * n_layer * target + 4 * d_layer * draft,
            "head_logits": target + draft,
            "ln_residual_dropout_fwd": (2 * n_layer + 1) * target + (2 * d_layer + 1) * draft}


def phase_spec_serving(card: str) -> dict[str, int]:
    """Speculative decoding at full width: (a) the serve CLI in this
    process, ``--model 345M --init_random --draft_preset 124M --spec_k 4``,
    greedy, 64 new tokens for phase_serving's 8 prompts (the 960-token one
    ends at position 1024, so its last round straddles the context end);
    (b) the same requests through an engine whose draft is the target's
    first 12 of 24 layers with its embeddings and final LayerNorm, which
    must accept; both against the 345M ``generate_cached(batch=1)``, their
    launches against those the stats imply; then the kernel path against
    the plain path at these shapes: a 345M prefill, a draft catch-up and a
    verify window. (c) A sampled run (temperature
    1.0, 16 tokens) twice with the same seeds. (d) The acceptance rate,
    draft and verify ms a round and tok/s beside the plain 345M engine's on
    the same requests, warm, one pass of each engine in turn. Returns the
    launches of (a) and (b) by wrapper name."""
    import contextlib
    import io
    import tempfile

    from gpt_2_distributed_torch.config import MODEL_PRESETS, ServeConfig
    from gpt_2_distributed_torch.models import decode, gpt2
    from gpt_2_distributed_torch.ops import fused_matmul as fm
    from gpt_2_distributed_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_attention_fwd_offset,
    )
    from gpt_2_distributed_torch.ops.fused_layer import ln_residual_dropout_fwd
    from gpt_2_distributed_torch.ops.paged_attention import paged_attention_kernel
    from gpt_2_distributed_torch.serving import engine as engine_mod
    from gpt_2_distributed_torch.serving import serve
    from gpt_2_distributed_torch.serving.engine import chunk_prefill

    t_phase = time.monotonic()
    config = MODEL_PRESETS["345M"]
    rng = torch.Generator().manual_seed(7)
    prompts = [torch.randint(0, config.vocab_size, (p,), generator=rng).tolist()
               for p in SERVING_LENGTHS]
    wrappers = {"flash_attention_fwd": flash_attention_fwd,
                "flash_attention_fwd_offset": flash_attention_fwd_offset,
                "paged_attention_kernel": paged_attention_kernel,
                "linear": fm.linear, "head_logits": fm.head_logits,
                "ln_residual_dropout_fwd": ln_residual_dropout_fwd}
    total: collections.Counter = collections.Counter()

    # (a) the CLI; the engine it builds is caught for its stats.
    made = []

    class Caught(engine_mod.ServingEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    tmp = tempfile.mkdtemp(prefix="spec_smoke_")
    reqs = os.path.join(tmp, "reqs.jsonl")
    with open(reqs, "w", encoding="utf-8") as f:
        for i, p in enumerate(prompts):
            f.write(json.dumps({"prompt_ids": p, "new": SPEC_NEW[0], "seed": i}) + "\n")
    out, err = io.StringIO(), io.StringIO()
    real = engine_mod.ServingEngine
    engine_mod.ServingEngine = Caught
    try:
        for w in wrappers.values():
            w.launches = 0
        t0 = time.monotonic()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            serve.main(["--model", "345M", "--init_random", "--draft_preset", "124M",
                        "--spec_k", str(SPEC_K), "--temperature", "0", "--requests", reqs])
        cli_s = time.monotonic() - t0
        got = {name: w.launches for name, w in wrappers.items()}
    finally:
        engine_mod.ServingEngine = real
        os.remove(reqs)
        os.rmdir(tmp)
    eng = made[0]
    records = [json.loads(line) for line in out.getvalue().splitlines()]
    st = eng.stats
    want = spec_launches(config.n_layer, eng.draft_config.n_layer, SPEC_K, st["prefills"],
                         st["decode_steps"], st["spec_catchups"])
    print(f"spec serving (a): serve CLI --model 345M --init_random --draft_preset 124M "
          f"--spec_k {SPEC_K} in {cli_s:.1f} s with set-up, {len(records)} requests x "
          f"{SPEC_NEW[0]} greedy tokens, {st['decode_steps']} rounds, {st['spec_catchups']} "
          f"catch-ups, {st['spec_accepted_tokens']} of {st['spec_draft_tokens']} draft tokens "
          f"accepted; launches {got}", flush=True)
    if got != want:
        fail(f"spec serving (a) launches {got} != {want}")
    total.update(got)

    # The 345M oracle, from the engine's own compute weights.
    w = eng.w
    oracle = {}

    def reference(i, p, new, temperature=0.0):
        if (i, new, temperature) not in oracle:
            oracle[i, new, temperature] = decode.generate_cached(
                w, config, [p], seed=i, max_new_tokens=new, temperature=temperature,
                block_size=eng.serve.block_size)[0, len(p):].tolist()
        return oracle[i, new, temperature]

    def held(label, streams, e):
        same = 0
        for i, (got_ids, p) in enumerate(zip(streams, prompts)):
            want_ids = reference(i, p, SPEC_NEW[0])
            if got_ids == want_ids:
                same += 1
                continue
            print_first_difference(f"spec serving {label} request {i}", e.w, config, p,
                                   got_ids, want_ids)
        print(f"spec serving {label}: {same} of {len(prompts)} greedy streams equal the 345M "
              f"generate_cached(batch=1)'s", flush=True)
        if same != len(prompts):
            fail(f"spec serving {label}: {len(prompts) - same} streams differ")

    if [r["finish_reason"] for r in records] != ["length"] * len(prompts):
        fail(f"spec serving (a): finish reasons {[r['finish_reason'] for r in records]}")
    held("(a)", [r["generated"] for r in records], eng)

    # (b) the self-sliced draft: the target's first layers, its embeddings
    # and final LayerNorm.
    draft_config = config.replace(n_layer=SPEC_SLICE)
    sliced = real(w, config, eng.serve, temperature=0.0,
                  draft_params=dict(w, blocks=w["blocks"][:SPEC_SLICE]),
                  draft_config=draft_config)
    plain = real(w, config, ServeConfig(**{f: getattr(eng.serve, f) for f in (
        "max_batch", "block_size", "num_blocks")}), temperature=0.0)
    for e in (sliced, plain):
        e.submit([1, 2, 3], 2)
        e.run_until_idle()
    before = dict(sliced.stats)
    for wr in wrappers.values():
        wr.launches = 0
    hs = [sliced.submit(p, SPEC_NEW[0], seed=i) for i, p in enumerate(prompts)]
    sliced.run_until_idle()
    got = {name: wr.launches for name, wr in wrappers.items()}
    d = {k: sliced.stats[k] - before[k] for k in sliced.stats}
    want = spec_launches(config.n_layer, SPEC_SLICE, SPEC_K, d["prefills"], d["decode_steps"],
                         d["spec_catchups"])
    print(f"spec serving (b): draft = the 345M's first {SPEC_SLICE} layers, {d['decode_steps']} "
          f"rounds, {d['spec_accepted_tokens']} of {d['spec_draft_tokens']} draft tokens "
          f"accepted; launches {got}", flush=True)
    if got != want:
        fail(f"spec serving (b) launches {got} != {want}")
    total.update(got)
    held("(b)", [h.generated for h in hs], sliced)
    if d["spec_accepted_tokens"] < 1:
        fail("spec serving (b): the self-sliced draft accepted no token")

    # Kernel path against plain path at this phase's own shapes (H 16,
    # C 1024), outside the counted runs: the 960-token prompt's 345M
    # prefill (K1); then, with 8 requests admitted into the sliced engine
    # and one round run, every row's draft catch-up from position 0 over
    # cloned draft pools (K1's offset form) and one verify window of
    # 8 x (K+1) flattened rows over the target pools (K3).
    with torch.no_grad():
        pt = torch.tensor([prompts[-1]], device=sliced.device)
        hid = {impl: decode.prefill(w, config, pt, pt.shape[1], impl)[0][:, -1]
               for impl in ("kernel", "plain")}
        logits = {"prefill": {impl: gpt2.logits_fp32(w, h) for impl, h in hid.items()}}
        for i, p in enumerate(prompts):
            sliced.submit(p, 8, seed=100 + i)
        sliced.step()
        act = np.flatnonzero(sliced.active)
        clen = sliced.pos[act]
        bs = sliced._draft_serve.block_size
        chunk = np.zeros((len(act), -(-int(clen.max()) // bs) * bs), np.int64)
        for j, slot in enumerate(act):
            req = sliced._slots[slot]
            chunk[j, :clen[j]] = (req.prompt + req.generated)[:clen[j]]
        logits["catch-up"] = {impl: chunk_prefill(
            sliced.draft_w, sliced.draft_config, sliced.dk_pool.clone(), sliced.dv_pool.clone(),
            sliced.draft_table[act], chunk, np.zeros_like(clen), clen, impl)
            for impl in ("kernel", "plain")}
        drafts = torch.randint(0, config.vocab_size, (len(act), SPEC_K), generator=rng)
        vtoks = np.concatenate([sliced.tokens[act, None], drafts.numpy()], axis=1)
        logits["verify"] = {impl: sliced._verify_logits(act, vtoks, impl)
                            for impl in ("kernel", "plain")}
    sliced.run_until_idle()
    errs = {name: (o["kernel"] - o["plain"]).abs().max().item() for name, o in logits.items()}
    finite = all(bool(torch.isfinite(o["kernel"]).all()) for o in logits.values())
    print(f"spec serving: kernel vs plain fp32 logits at H {config.n_head}, C {config.n_embd}: "
          f"prefill (K1, T {pt.shape[1]}) max|diff| {errs['prefill']:.3e}, draft catch-up "
          f"(K1 offset, {len(act)} rows to {int(clen.max())}) {errs['catch-up']:.3e}, verify window "
          f"(K3, {vtoks.size} rows) {errs['verify']:.3e} (tol {LOGITS_TOL}, logits std "
          f"{logits['verify']['plain'].std().item():.3f}), finite {finite}", flush=True)
    if not (finite and max(errs.values()) <= LOGITS_TOL):
        fail("spec serving: kernel path logits disagree with the plain path")

    # (c) sampled, twice with the same seeds.
    eng.temperature = 1.0
    runs = []
    for _ in range(2):
        hs = [eng.submit(p, SPEC_NEW[1], seed=50 + i) for i, p in enumerate(prompts)]
        eng.run_until_idle()
        runs.append([h.generated for h in hs])
    eng.temperature = 0.0
    ok = all(len(t) == SPEC_NEW[1] and all(0 <= x < config.vocab_size for x in t)
             for t in runs[0])
    print(f"spec serving (c): sampled at temperature 1.0, {len(prompts)} x {SPEC_NEW[1]} "
          f"tokens: lengths and vocab {ok}, two runs with the same seeds equal "
          f"{runs[0] == runs[1]}", flush=True)
    if not (ok and runs[0] == runs[1]):
        fail("spec serving (c): sampled streams malformed or not deterministic")

    # (d) warm timings, one pass of each engine in turn, greedy (one pass
    # keeps the phase within a minute).
    toks = len(prompts) * SPEC_NEW[0]
    base = None
    engines = {"plain": plain, "spec 124M draft": eng, f"spec {SPEC_SLICE}-layer slice": sliced}
    for name, e in engines.items():
        b = dict(e.stats)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        hs = [e.submit(p, SPEC_NEW[0], seed=i) for i, p in enumerate(prompts)]
        e.run_until_idle()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        if [h.generated for h in hs] != [reference(i, p, SPEC_NEW[0])
                                          for i, p in enumerate(prompts)]:
            fail(f"spec serving (d): {name} streams differ from generate_cached's")
        r = {k: e.stats[k] - b[k] for k in e.stats}
        base = base or toks / wall
        line = (f"spec serving (d) [{card}]: {name}: {toks} tokens in {wall:.3f} s "
                f"({toks / wall:.1f} tok/s, {toks / wall / base:.3f}x plain), "
                f"{r['decode_steps']} steps at {r['decode_ms'] / r['decode_steps']:.3f} ms")
        if r["spec_draft_tokens"]:
            line += (f"; acceptance {r['spec_accepted_tokens'] / r['spec_draft_tokens']:.3f}, "
                     f"{(toks - len(prompts)) * SPEC_K / r['spec_draft_tokens']:.3f} tokens a "
                     f"row a round, draft {r['draft_ms'] / r['decode_steps']:.3f} ms + verify "
                     f"{r['verify_ms'] / r['decode_steps']:.3f} ms a round")
        print(line, flush=True)
    del eng, sliced, plain, made
    torch.cuda.empty_cache()
    print(f"spec serving phase: {time.monotonic() - t_phase:.1f} s", flush=True)
    return dict(total)


# K1's query-offset form: (start, chunk) cases at H 12, D 64 over S = 1024
# keys, the engine's chunk widths; the timed ones are the PERF.md rows.
OFFSET_S = 1024
OFFSET_CASES = tuple((s, c) for s in (0, 16, 512, 944) for c in (16, 256))
OFFSET_TIMED = ((512, 256), (944, 16))
# The prefix-serving workload: a 512-token prefix served first, then 8
# requests of it plus suffixes (0: a block-aligned full hit, copied on
# write).
PREFIX_LEN = 512
PREFIX_SUFFIXES = (0, 1, 17, 100, 208, 300, 400, 448)
PREFIX_NEW = (32, 16)    # greedy, sampled (temperature 1.0)
PREFIX_REPS = 5          # timed runs an engine, in turns


def offset_case(start: int, c: int, gen, batch: int = 1):
    """q [B, 12, c, 64] rows at ``start`` of a whole prompt, k and v [B, 12,
    S, 64] with random keys and values past the chunk (stale pool data the
    mask must keep out), the whole prompt's q, k and v, and start [B]."""
    h, d, s = 12, 64, OFFSET_S
    full = [torch.randn(batch, h, max(s, start + c), d, generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(3)]
    q = full[0][:, :, start:start + c]
    stale = [x[:, :, :s].clone() for x in full[1:]]
    for x in stale:
        x[:, :, start + c:] = torch.randn(x[:, :, start + c:].shape, generator=gen,
                                          device="cuda", dtype=torch.bfloat16)
    st = torch.full((batch,), start, dtype=torch.int32, device="cuda")
    return q, stale[0], stale[1], st, full


def offset_bound(start: int, c: int) -> tuple[float, str, float]:
    """The offset form's bound at H 12, D 64 over S keys: q, o and lse once,
    the keys and values up to the chunk's last position once; the two
    causal products over the positions each row attends."""
    h, d, s = 12, 64, OFFSET_S
    keys = min(s, start + c)
    attended = sum(min(p, s - 1) + 1 for p in range(start, start + c))
    nbytes = 2 * c * h * d * 2 + 2 * keys * h * d * 2 + c * h * 4
    flops = 4 * h * d * attended
    return (*bound_ms(nbytes, flops), flops)


def phase_offset(flush) -> dict:
    """K1's query-offset form against its plain version, bit-equal to the
    whole-prompt form's rows, relaunched bit-identical, a planted fault;
    timed at OFFSET_TIMED beside its plain version and SDPA with the
    boolean offset mask."""
    from gpt_2_distributed_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_attention_fwd_offset,
        flash_attention_offset_plain,
        flash_offset_error_terms,
    )

    gen = torch.Generator(device="cuda").manual_seed(9)
    max_err, worst = 0.0, 0.0
    for start, c in OFFSET_CASES:
        q, k, v, st, full = offset_case(start, c, gen)
        o, lse = flash_attention_fwd_offset(q, k, v, st)
        again = flash_attention_fwd_offset(q, k, v, st)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash_attention_offset_plain(q.float(), k.float(), v.float(), st)
        (terms,) = flash_offset_error_terms(q, k, v, st)
        err_o, ratio = held_flash(o, o_ref, terms)
        err_lse = (lse - lse_ref).abs().max().item()
        # The whole-prompt form over the same prompt: rows start .. start + c
        # (those inside it) must be the offset form's bit for bit.
        t = min(start + c, OFFSET_S)
        o_w, lse_w = flash_attention_fwd(*(x[:, :, :t] for x in full))
        rows = t - start
        bits = (torch.equal(o[:, :, :rows], o_w[:, :, start:t])
                and torch.equal(lse[:, :, :rows], lse_w[:, :, start:t]))
        same = torch.equal(again[0], o) and torch.equal(again[1], lse)
        print(f"K1 offset start {start} chunk {c} (S {OFFSET_S}): max|o - plain| "
              f"{err_o:.3e}, max err/tol {ratio:.3f}, max|lse - plain| {err_lse:.3e}; "
              f"rows bit-equal to K1's whole-prompt rows: {bits}; two launches "
              f"bit-identical: {same}", flush=True)
        if not (ratio <= 1.0 and err_lse <= LSE_TOL and bits and same):
            fail(f"K1's offset form disagrees at start {start}, chunk {c}")
        max_err, worst = max(max_err, err_o), max(worst, ratio)
    # One launch over rows of four starts, each row's bits its own launch's.
    q, k, v, _, _ = offset_case(0, 256, gen, batch=4)
    st = torch.tensor([0, 16, 512, 944], dtype=torch.int32, device="cuda")
    o, lse = flash_attention_fwd_offset(q, k, v, st)
    alone = [flash_attention_fwd_offset(q[i:i + 1], k[i:i + 1], v[i:i + 1], st[i:i + 1])
             for i in range(4)]
    batched = all(torch.equal(o[i:i + 1], a[0]) and torch.equal(lse[i:i + 1], a[1])
                  for i, a in enumerate(alone))
    # Planted fault: the starts one block late.
    o_ref, _ = flash_attention_offset_plain(q.float(), k.float(), v.float(), st)
    (terms,) = flash_offset_error_terms(q, k, v, st)
    _, ratio_bad = held_flash(flash_attention_fwd_offset(q, k, v, st + 16)[0], o_ref, terms)
    print(f"K1 offset: four starts in one launch bit-equal to each alone: {batched}; "
          f"planted fault (start + 16): max err/tol {ratio_bad:.1f}", flush=True)
    if not batched or ratio_bad <= 1.0:
        fail("K1's offset form depends on its batch, or its check lets a fault through")

    row = None
    for start, c in OFFSET_TIMED:
        q, k, v, st, _ = offset_case(start, c, gen)
        ms = time_ms(lambda: flash_attention_fwd_offset(q, k, v, st), flush)
        plain_ms = time_ms(lambda: flash_attention_offset_plain(q, k, v, st), flush)
        qpos = start + torch.arange(c, device="cuda")[:, None]
        mask = torch.arange(OFFSET_S, device="cuda") <= qpos
        lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), flush)
        b_ms, b_by, flops = offset_bound(start, c)
        print(f"K1 offset start {start} chunk {c}: kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, sdpa (bool mask) "
              f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})", flush=True)
        if row is None:   # chunk 256 at start 512 goes into the line
            row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                       bound_by=b_by, max_abs_err=max_err)
    return row


def phase_prefix_serving(profile_steps: bool) -> dict[str, int]:
    """The prefix cache and chunked, batched prefill at 124M: engines A
    (prefix cache, whole-prompt mode), B (prefix cache, chunks of 256, 4
    a dispatch) and OFF (no cache, whole-prompt) serve the 512-token prefix
    and then its 8 sharers, greedily and sampled; C (chunks of 256, no
    cache) serves phase_serving's 8 prompts. Every stream must equal
    generate_cached(batch=1)'s; returns the launches of the main path's
    kernels, held against counts derived from the engines' stats. With
    ``profile_steps``, a profiler window over one of C's steps that
    carries a 256-token chunk of a 960-token prompt."""
    from gpt_2_distributed_torch.config import MODEL_PRESETS, ServeConfig
    from gpt_2_distributed_torch.models import decode, gpt2
    from gpt_2_distributed_torch.ops import fused_matmul as fm
    from gpt_2_distributed_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_attention_fwd_offset,
    )
    from gpt_2_distributed_torch.ops.fused_layer import ln_residual_dropout_fwd
    from gpt_2_distributed_torch.ops.paged_attention import paged_attention_kernel
    from gpt_2_distributed_torch.serving import ServingEngine
    from gpt_2_distributed_torch.serving.engine import chunk_prefill

    config = MODEL_PRESETS["124M"]
    base = dict(max_batch=8, block_size=16, num_blocks=513)
    settings = {"A": dict(prefix_cache=True), "OFF": {},
                "B": dict(prefix_cache=True, prefill_chunk=256, prefill_batch=4),
                "C": dict(prefill_chunk=256)}
    t0 = time.monotonic()
    params = gpt2.init_params(config, seed=0)
    engines = {(name, temp): ServingEngine(params, config, ServeConfig(**base, **kw),
                                           temperature=temp)
               for name, kw in settings.items() for temp in (0.0, 1.0)}
    rng = torch.Generator().manual_seed(11)
    prefix = torch.randint(0, config.vocab_size, (PREFIX_LEN,), generator=rng).tolist()
    sharers = [prefix + torch.randint(0, config.vocab_size, (s,), generator=rng).tolist()
               for s in PREFIX_SUFFIXES]
    rng7 = torch.Generator().manual_seed(7)   # phase_serving's prompts
    mixed = [torch.randint(0, config.vocab_size, (p,), generator=rng7).tolist()
             for p in (1, 17, 100, 208, 400, 512, 777, 960)]
    warm = torch.randint(0, config.vocab_size, (40,), generator=rng).tolist()
    for eng in engines.values():   # allocator, handles, both prefill paths
        for _ in range(2):
            eng.submit(warm, 2)
            eng.run_until_idle()
        eng.clear_prefix_cache()
    print(f"prefix serving: 124M, 8 engines (A, B, C, OFF greedy and sampled), set-up "
          f"{time.monotonic() - t0:.1f} s", flush=True)

    wrappers = {"flash_attention_fwd_offset": flash_attention_fwd_offset,
                "flash_attention_fwd": flash_attention_fwd,
                "paged_attention_kernel": paged_attention_kernel,
                "linear": fm.linear, "head_logits": fm.head_logits,
                "ln_residual_dropout_fwd": ln_residual_dropout_fwd}
    before = {key: dict(eng.stats) for key, eng in engines.items()}
    for wrapper in wrappers.values():
        wrapper.launches = 0
    runs = {}   # (engine, temperature) -> [(prompt, seed, handle)]
    ttft = {}
    for (name, temp), eng in engines.items():
        new = PREFIX_NEW[temp > 0]
        seed0 = 300 if temp > 0 else 0
        if name == "C":
            prompts, first = mixed, []
        else:
            h0 = eng.submit(prefix, new, seed=seed0)
            eng.run_until_idle()
            prompts, first = sharers, [(prefix, seed0, h0)]
        hs = [eng.submit(p, new, seed=seed0 + 1 + i) for i, p in enumerate(prompts)]
        eng.run_until_idle()
        torch.cuda.synchronize()
        runs[name, temp] = first + [(p, seed0 + 1 + i, h) for i, (p, h) in
                                    enumerate(zip(prompts, hs))]
        ttft[name, temp] = sum((h.first_token_time - h.submit_time) * 1e3
                               for h in hs) / len(hs)
        for _, _, h in runs[name, temp]:
            if h.finish_reason != "length" or len(h.generated) != new:
                fail(f"prefix serving {name}: request {h.id} finished "
                     f"{h.finish_reason!r} with {len(h.generated)} tokens")
    got = {name: w.launches for name, w in wrappers.items()}

    # The launches the stats imply: a whole prefill is one K1 launch a
    # layer, a chunk dispatch one offset launch a layer, a decode step one
    # K3 launch a layer; each of them 4 products a layer and the head
    # through K7 and 2 LayerNorms a layer and the final one through K4.
    n_layer = config.n_layer
    whole = dispatches = steps = 0
    for key, eng in engines.items():
        d = {k: eng.stats[k] - before[key][k] for k in eng.stats}
        w = (sum(h.prefix_cached_tokens == 0 for _, _, h in runs[key])
             if eng.serve.prefill_chunk == 0 else 0)
        whole += w
        dispatches += d["prefill_dispatches"] - w
        steps += d["decode_steps"]
        if eng.serve.prefix_cache:
            if d["prefix_hit_tokens"] < 7 * PREFIX_LEN + PREFIX_LEN - 1 or d["cow_copies"] < 1:
                fail(f"prefix serving {key[0]}: {d['prefix_hit_tokens']} prefix-hit tokens, "
                     f"{d['cow_copies']} copies on write")
        print(f"prefix serving {key[0]} temperature {key[1]}: mean TTFT "
              f"{ttft[key]:.2f} ms, {d['decode_steps']} decode steps at "
              f"{d['decode_ms'] / max(d['decode_steps'], 1):.3f} ms/step, "
              f"prefix_hit_tokens {d['prefix_hit_tokens']}, cow_copies {d['cow_copies']}, "
              f"prefill_dispatches {d['prefill_dispatches']}, prefill_batched "
              f"{d['prefill_batched']}, prefill_ms {d['prefill_ms']:.1f}", flush=True)
    want = {"flash_attention_fwd_offset": n_layer * dispatches,
            "flash_attention_fwd": n_layer * whole,
            "paged_attention_kernel": n_layer * steps,
            "linear": 4 * n_layer * (whole + dispatches + steps),
            "head_logits": whole + dispatches + steps,
            "ln_residual_dropout_fwd": (2 * n_layer + 1) * (whole + dispatches + steps)}
    print(f"prefix serving: launches {got} over {whole} whole prefills, {dispatches} "
          f"chunk dispatches and {steps} decode steps", flush=True)
    if not (dispatches and whole and got == want):
        fail(f"prefix serving launch counts {got} != {want}")

    # Every stream against generate_cached(batch=1), localised where it
    # differs (phase_serving's printout).
    oracle = {}
    differ = 0
    for (name, temp), entries in runs.items():
        new = PREFIX_NEW[temp > 0]
        same = 0
        for p, seed, h in entries:
            key = (tuple(p), new, seed, temp)
            if key not in oracle:
                oracle[key] = decode.generate_cached(
                    params, config, [p], seed=seed, max_new_tokens=new, temperature=temp,
                    block_size=base["block_size"])[0, len(p):].tolist()
            want_ids = oracle[key]
            if want_ids == h.generated:
                same += 1
                continue
            print_first_difference(
                f"prefix serving {name} temperature {temp} request {h.id} "
                f"({h.prefix_cached_tokens} cached)", engines[name, temp].w, config, p,
                h.generated, want_ids)
        print(f"prefix serving {name} temperature {temp}: {same} of {len(entries)} streams "
              f"equal generate_cached(batch=1)'s", flush=True)
        differ += len(entries) - same
    if differ:
        fail(f"{differ} prefix-serving streams differ from generate_cached(batch=1)'s")

    # One chunk dispatch on A's pools (cloned): 100 tokens past the cached
    # prefix, through the kernel and the plain attention; the kernel's
    # logits must also be the whole-prompt prefill's bit for bit.
    eng = engines["A", 0.0]
    p = sharers[3]                          # the prefix + 100 tokens
    bs = base["block_size"]
    cached = eng.prefix_cache.lookup(p)[:PREFIX_LEN // bs]
    own = eng.allocator.alloc(-(-len(p) // bs) - len(cached))
    bt = np.zeros((1, eng._m), np.int32)
    bt[0, :len(cached) + len(own)] = cached + own
    chunk = np.zeros((1, 256), np.int64)
    chunk[0, :len(p) - PREFIX_LEN] = p[PREFIX_LEN:]
    start, clen = np.array([PREFIX_LEN]), np.array([len(p) - PREFIX_LEN])
    logits = {impl: chunk_prefill(eng.w, config, eng.k_pool.clone(), eng.v_pool.clone(),
                                  bt, chunk, start, clen, impl)[0]
              for impl in ("kernel", "plain")}
    eng.allocator.release(own)
    with torch.no_grad():
        hid, _ = decode.prefill(eng.w, config, torch.tensor([p], device="cuda"), len(p))
        whole_logits = gpt2.logits_fp32(eng.w, hid[:, -1])[0]
    err = (logits["kernel"] - logits["plain"]).abs().max().item()
    bits = torch.equal(logits["kernel"], whole_logits)
    finite = bool(torch.isfinite(logits["kernel"]).all())
    print(f"prefix serving: one chunk dispatch (100 tokens at 512): kernel vs plain fp32 "
          f"logits max|diff| {err:.3e} (tol {LOGITS_TOL}), finite {finite}; kernel logits "
          f"bit-equal to the whole-prompt prefill's: {bits}", flush=True)
    if not (finite and err <= LOGITS_TOL and bits):
        fail("the chunk path's logits disagree with the plain path or the whole prompt")

    # Host time moves one engine's reading by more than the effects, so
    # the timed workloads run PREFIX_REPS times, the engines in turns
    # (the order reversed each time), and their medians and ranges are
    # printed. Shared-prefix TTFT, greedy: the cache emptied first, so each
    # run is the counted run's workload, whose streams it must repeat.
    def spread(xs):
        xs = sorted(xs)
        return f"median {xs[len(xs) // 2]:.2f} ms (range {xs[0]:.2f}-{xs[-1]:.2f})"

    order = ["OFF", "A", "B"]
    reads = {name: [] for name in order}
    for r in range(PREFIX_REPS):
        for name in order[::1 - 2 * (r % 2)]:
            eng = engines[name, 0.0]
            eng.clear_prefix_cache()
            first = eng.submit(prefix, PREFIX_NEW[0], seed=0)
            eng.run_until_idle()
            hs = [eng.submit(p, PREFIX_NEW[0], seed=1 + i) for i, p in enumerate(sharers)]
            eng.run_until_idle()
            if [h.generated for h in [first] + hs] != [h.generated for _, _, h in
                                                         runs[name, 0.0]]:
                fail(f"prefix serving {name}: a repeated run's streams differ")
            reads[name].append(sum((h.first_token_time - h.submit_time) * 1e3
                                   for h in hs) / len(hs))
    print(f"prefix serving: mean TTFT of the 8 shared-prefix requests, greedy, "
          f"{PREFIX_REPS} runs an engine in turns: cache off {spread(reads['OFF'])}; cache on "
          f"(A) {spread(reads['A'])}; cache on with chunks of 256, 4 a dispatch (B) "
          f"{spread(reads['B'])}", flush=True)

    # Engine steps while a 960-token prompt comes in: 7 streams decoding,
    # then the prompt admitted whole (OFF) or in chunks of 256 (C); the wall
    # time of each step until its first token, beside 4 steady steps.
    walls = {name: [] for name in ("OFF", "C")}
    for r in range(PREFIX_REPS):
        for name in ("OFF", "C")[::1 - 2 * (r % 2)]:
            eng = engines[name, 0.0]
            streams = [eng.submit(mixed[i % 4], 24, seed=i) for i in range(7)]
            while not all(h.generated for h in streams):   # every stream decoding
                eng.step()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            for _ in range(4):
                eng.step()
            steady = (time.monotonic() - t0) / 4 * 1e3
            big = eng.submit(mixed[-1], 4)
            steps = []
            while not big.generated:
                t0 = time.monotonic()
                eng.step()
                steps.append((time.monotonic() - t0) * 1e3)
            eng.run_until_idle()
            walls[name].append((max(steps), sum(steps) / len(steps), steady, len(steps)))
    for name, how in (("OFF", "whole"), ("C", "in chunks of 256")):
        w = walls[name]
        print(f"prefix serving {name}: a 960-token prompt admitted {how} among 7 decoding "
              f"streams, {PREFIX_REPS} runs: {w[0][3]} step(s) to its first token; longest "
              f"step {spread([x[0] for x in w])}, mean step {spread([x[1] for x in w])}, "
              f"steady decode step {spread([x[2] for x in w])}", flush=True)
    if profile_steps:
        eng = engines["C", 0.0]
        streams = [eng.submit(mixed[i % 4], 16, seed=i) for i in range(7)]
        while not all(h.generated for h in streams):
            eng.step()
        eng.submit(mixed[-1], 4)
        profile_window("chunked admission (a 256-token chunk of a 960-token prompt + 1 "
                       "decode at batch 7)", lambda: (eng.step(), 1)[1])
        eng.run_until_idle()
    return got


# Watermark admission with preemption: 8 prompts of 95-431 tokens, the
# longest first, so the newest admissions (the preemption victims) are the
# short ones; a length one short of a block multiple makes every request
# grow a block at its first decode step. The pool of 54 blocks makes both
# engines preempt 5 times over a greedy and a sampled run (the schedule
# depends on the lengths alone: a run on the CPU at a tiny width counts the
# same preemptions).
PREEMPT_LENGTHS = (431, 383, 335, 287, 239, 191, 143, 95)
PREEMPT_NEW = (96, 32)   # greedy, then sampled at temperature 1.0
PREEMPT_BLOCKS = 54
PREEMPT_BITS_STEPS = 40  # decode steps before the pool-bits preemption


def resumed_pool_bits(eng, prompt: list[int], ref: list[int]) -> None:
    """One greedy request on an idle engine, uninterrupted for
    PREEMPT_BITS_STEPS decode steps, then preempted and resumed: the K and V its resume writes
    at the decode-written positions against the decode step's, bit for
    bit, layer by layer; then the same resume with K1's offset form alone
    (every row through the chunk attention). Fails if the engine's resume
    changes a bit; its stream must still equal ``ref``."""
    from gpt_2_distributed_torch.serving.engine import chunk_prefill

    bs, n, p = eng.serve.block_size, PREEMPT_BITS_STEPS, len(prompt)
    pos = torch.arange(p, p + n, device="cuda")

    def rows(table_row):   # [2, n, L, H, D]: K and V at the n positions
        blk = torch.as_tensor(table_row, dtype=torch.long, device="cuda")[pos // bs]
        return torch.stack([pool.permute(1, 3, 0, 2, 4)[blk, pos % bs]
                            for pool in (eng.k_pool, eng.v_pool)])

    def differing(a, b):   # per layer, (K, V) elements that differ
        return [tuple(int((a[kv, :, layer] != b[kv, :, layer]).sum()) for kv in (0, 1))
                for layer in range(a.shape[2])]

    eng.temperature = 0.0
    h = eng.submit(prompt, len(ref))
    while len(h.generated) < n + 1:
        eng.step()
    slot = eng._slots.index(h)
    decoded = rows(eng.block_table[slot]).clone()
    work = prompt + h.generated[:n]
    eng._preempt(slot)
    t0 = time.monotonic()
    eng._try_admit()            # whole-prompt mode: the resume completes inline
    torch.cuda.synchronize()
    resume_ms = (time.monotonic() - t0) * 1e3
    slot = eng._slots.index(h)
    routed = differing(rows(eng.block_table[slot]), decoded)
    # K1's offset form alone over the same work prompt, into blocks of its own.
    own = eng.allocator.alloc(-(-len(work) // bs))
    bt = np.zeros((1, eng._m), np.int32)
    bt[0, :len(own)] = own
    chunk_prefill(eng.w, eng.config, eng.k_pool, eng.v_pool, bt, np.array([work]),
                  np.array([0]), np.array([len(work)]), eng.serve.attn_impl)
    alone = differing(rows(bt[0]), decoded)
    eng.allocator.release(own)
    eng.run_until_idle()
    total = decoded[0, :, 0].numel()
    print(f"preempt serving: pool bits at the {n} decode-written positions of a "
          f"{p}-token prompt, resumed (one resume dispatch, {resume_ms:.3f} ms wall): elements "
          f"differing from the decode step's, (K, V) per layer of {total}: decode rows through "
          f"K3 (the engine) {routed}; K1's offset form alone {alone}", flush=True)
    enough = all(k == v == 0 for k, v in alone)
    print(f"preempt serving: K1's offset form alone gives the decode step's bits: {enough}",
          flush=True)
    if any(k or v for k, v in routed) or h.generated != ref:
        fail("a resume changed the pool bits the decode step wrote, or its stream")


def phase_preempt_serving() -> dict[str, int]:
    """Watermark admission with preemption and a recompute resume at 124M:
    engines W (whole-prompt mode, no cache) and C (chunks of 256, 4 a
    dispatch, prefix cache), ServeConfig(max_batch=8, block_size=16,
    num_blocks=54, admission="watermark", watermark_blocks=1), each serving
    the 8 prompts greedily (96 new tokens) and then sampled at temperature
    1.0 (32). Every stream must equal generate_cached(batch=1)'s, each
    on_token be called once a token, every preemption of a request that had
    sampled be resumed, the allocator come back, each engine preempt 4
    times or more, and the launches equal those the stats imply; then the
    pool bits of one resume (``resumed_pool_bits``) and a migration: C's
    configuration stopped with requests decoding, prefilling and queued,
    ``extract_inflight`` through the wire form and JSON into a second
    engine. Returns the counted runs' launches by wrapper name."""
    from gpt_2_distributed_torch.config import MODEL_PRESETS, ServeConfig
    from gpt_2_distributed_torch.models import decode, gpt2
    from gpt_2_distributed_torch.ops import fused_matmul as fm
    from gpt_2_distributed_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_attention_fwd_offset,
    )
    from gpt_2_distributed_torch.ops.fused_layer import ln_residual_dropout_fwd
    from gpt_2_distributed_torch.ops.paged_attention import paged_attention_kernel
    from gpt_2_distributed_torch.serving import RequestHandle, ServingEngine

    config = MODEL_PRESETS["124M"]
    base = dict(max_batch=8, block_size=16, num_blocks=PREEMPT_BLOCKS, admission="watermark",
                watermark_blocks=1)
    settings = {"W": {}, "C": dict(prefill_chunk=256, prefill_batch=4, prefix_cache=True)}
    t0 = time.monotonic()
    params = gpt2.init_params(config, seed=0)
    engines = {name: ServingEngine(params, config, ServeConfig(**base, **kw))
               for name, kw in settings.items()}
    rng = torch.Generator().manual_seed(15)
    prompts = [torch.randint(0, config.vocab_size, (n,), generator=rng).tolist()
               for n in PREEMPT_LENGTHS]
    warm = torch.randint(0, config.vocab_size, (40,), generator=rng).tolist()
    for eng in engines.values():
        for _ in range(2):
            eng.submit(warm, 2)
            eng.run_until_idle()
        eng.clear_prefix_cache()
    refs = {}   # (prompt index, temperature) -> stream, shared by every engine
    for i, p in enumerate(prompts):
        for temp, new in zip((0.0, 1.0), PREEMPT_NEW):
            refs[i, temp] = decode.generate_cached(
                params, config, [p], seed=500 + i, max_new_tokens=new, temperature=temp,
                block_size=base["block_size"])[0, len(p):].tolist()
    print(f"preempt serving: 124M, engines W and C, {PREEMPT_BLOCKS} blocks of 16 (the "
          f"8 requests' worst case: "
          f"{sum(-(-(n + PREEMPT_NEW[0] - 1) // 16) for n in PREEMPT_LENGTHS)}), set-up and "
          f"references {time.monotonic() - t0:.1f} s", flush=True)

    wrappers = {"flash_attention_fwd_offset": flash_attention_fwd_offset,
                "flash_attention_fwd": flash_attention_fwd,
                "paged_attention_kernel": paged_attention_kernel,
                "linear": fm.linear, "head_logits": fm.head_logits,
                "ln_residual_dropout_fwd": ln_residual_dropout_fwd}
    before = {name: dict(eng.stats) for name, eng in engines.items()}
    for wrapper in wrappers.values():
        wrapper.launches = 0
    differ = 0
    for name, eng in engines.items():
        early = collections.Counter()   # preemptions before a request's first token
        preempt = eng._preempt

        def counted(slot, eng=eng, preempt=preempt, early=early):
            early[eng._slots[slot].id] += not eng._slots[slot].generated
            preempt(slot)

        eng._preempt = counted
        for temp, new in zip((0.0, 1.0), PREEMPT_NEW):
            eng.temperature = temp
            start = dict(eng.stats)
            emitted = collections.Counter()
            hs = [eng.submit(p, new, seed=500 + i,
                             on_token=lambda r, t, emitted=emitted: emitted.update([r.id]))
                  for i, p in enumerate(prompts)]
            walls, resume_ms = [], []
            while eng.has_work():
                rd = eng.stats["resume_dispatches"]
                torch.cuda.synchronize()
                t1 = time.monotonic()
                eng.step()
                torch.cuda.synchronize()
                walls.append((time.monotonic() - t1) * 1e3)
                if eng.stats["resume_dispatches"] > rd:
                    resume_ms.append(walls[-1])
            d = {k: eng.stats[k] - start[k] for k in eng.stats}
            same = sum(h.generated == refs[i, temp] for i, h in enumerate(hs))
            for i, h in enumerate(hs):
                if h.generated != refs[i, temp]:
                    print_first_difference(
                        f"preempt serving {name} temperature {temp} request {h.id}", eng.w,
                        config, prompts[i], h.generated, refs[i, temp])
            differ += len(hs) - same
            cached = len(eng.prefix_cache) if eng.prefix_cache is not None else 0
            print(f"preempt serving {name} temperature {temp}: {same} of {len(hs)} streams "
                  f"equal generate_cached(batch=1)'s; {d['preemptions']} preemptions, "
                  f"{d['resumes']} resumes, {d['resume_dispatches']} resume dispatches, "
                  f"{d['prefix_hit_tokens']} prefix-hit tokens; {d['decode_steps']} decode "
                  f"steps at {d['decode_ms'] / d['decode_steps']:.3f} ms/step; engine steps "
                  f"with a resume dispatch "
                  + (f"{np.mean(resume_ms):.3f} ms mean wall" if resume_ms else "none")
                  + f", the "
                  f"longest step {max(walls):.3f} ms, the median "
                  f"{sorted(walls)[len(walls) // 2]:.3f} ms", flush=True)
            if any(h.resumes != h.preemptions - early[h.id] for h in hs) \
                    or d["resumes"] != sum(h.resumes for h in hs) \
                    or d["preemptions"] != sum(h.preemptions for h in hs):
                fail(f"preempt serving {name}: resumes {[h.resumes for h in hs]} against "
                     f"preemptions {[h.preemptions for h in hs]} (before a first token: "
                     f"{dict(early)})")
            if emitted != {h.id: len(h.generated) for h in hs} \
                    or any(h.finish_reason != "length" for h in hs):
                fail(f"preempt serving {name}: tokens emitted {dict(emitted)} for streams of "
                     f"{[len(h.generated) for h in hs]}")
            if eng.allocator.available != PREEMPT_BLOCKS - 1 - cached:
                fail(f"preempt serving {name}: {eng.allocator.available} blocks free, "
                     f"{cached} cached, of {PREEMPT_BLOCKS - 1}")
        eng._preempt = preempt
    got = {name: w.launches for name, w in wrappers.items()}
    if differ:
        fail(f"{differ} preempt-serving streams differ from generate_cached(batch=1)'s")

    # The launches the stats imply: as in phase_prefix_serving, and K3 once
    # a layer more for each chunk dispatch that carries decode-written rows
    # of a resume. W prefills every fresh admission whole, every resume in
    # chunks; C everything in chunks.
    n_layer = config.n_layer
    whole = dispatches = steps = resumed = 0
    for name, eng in engines.items():
        d = {k: eng.stats[k] - before[name][k] for k in eng.stats}
        if d["preemptions"] < 4:
            fail(f"preempt serving {name}: {d['preemptions']} preemptions, fewer than 4")
        w = d["admitted"] - d["resumes"] if eng.serve.prefill_chunk == 0 else 0
        whole += w
        dispatches += d["prefill_dispatches"] - w
        steps += d["decode_steps"]
        resumed += d["resume_dispatches"]
    want = {"flash_attention_fwd_offset": n_layer * dispatches,
            "flash_attention_fwd": n_layer * whole,
            "paged_attention_kernel": n_layer * (steps + resumed),
            "linear": 4 * n_layer * (whole + dispatches + steps),
            "head_logits": whole + dispatches + steps,
            "ln_residual_dropout_fwd": (2 * n_layer + 1) * (whole + dispatches + steps)}
    print(f"preempt serving: launches {got} over {whole} whole prefills, {dispatches} chunk "
          f"dispatches ({resumed} with decode-written rows) and {steps} decode steps",
          flush=True)
    if not (whole and resumed and got == want):
        fail(f"preempt serving launch counts {got} != {want}")

    resumed_pool_bits(engines["W"], prompts[5], refs[5, 0.0])

    # Migration: C's configuration, the prompts in another order so that
    # after one step a request decodes, one prefills and the rest wait;
    # every request through the wire form and JSON into a second engine.
    order = [7, 0, 6, 5, 4, 3, 2, 1]
    src, dst = (ServingEngine(params, config, ServeConfig(**base, **settings["C"]),
                              temperature=1.0) for _ in range(2))
    emitted = collections.Counter()

    def on_token(r, t):
        emitted.update([r.id])

    for i in order:
        src.submit(prompts[i], PREEMPT_NEW[1], seed=500 + i, rid=i, on_token=on_token)
    src.step()
    slotted = [h._prefill_pos is None for h in src._slots if h is not None]
    kinds = (sum(slotted), len(slotted) - sum(slotted), len(src._queue))
    keys = src.decode_keys()
    wires = [json.loads(json.dumps(h.to_wire())) for h in src.extract_inflight()]
    adopted = [RequestHandle.from_wire(wire, on_token) for wire in wires]
    for h in adopted:
        dst.adopt(h)
    dst.run_until_idle()
    same = sum(h.generated == refs[h.id, 1.0] for h in adopted)
    print(f"preempt serving: migration after 1 step ({kinds[0]} decoding, {kinds[1]} "
          f"prefilling, {kinds[2]} queued) through to_wire, JSON and from_wire: {same} of "
          f"{len(adopted)} sampled streams equal generate_cached(batch=1)'s; tokens emitted "
          f"{sum(emitted.values())} for {sum(len(h.generated) for h in adopted)} generated; "
          f"{dst.stats['preemptions']} preemptions after it", flush=True)
    if min(kinds) < 1 or same != len(adopted) \
            or emitted != {h.id: len(h.generated) for h in adopted} \
            or any(keys[w["rid"]] != w["generator"] for w in wires if w["rid"] in keys):
        fail("a migrated stream differs, re-emitted a token, or lost its generator state")
    return got


def phase_model_paths() -> None:
    """One 124M training micro-batch [4, 1024] twice, with the same params,
    batch and seeds: at dropout 0.1 through the kernel path (K1/K2) and the
    plain path (dense attention), then at dropout 0 with
    ``fused_layers="all"`` (K4-K6) and with ``fused_matmul="all"`` over it
    (K7), each against "off"; the loss and every grad."""
    from gpt_2_distributed_torch.config import MODEL_PRESETS
    from gpt_2_distributed_torch.models import gpt2
    from gpt_2_distributed_torch.parallel.train_step import param_list, trainable_params

    config = MODEL_PRESETS["124M"]
    params = trainable_params(gpt2.init_params(config, seed=0), torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randint(0, config.vocab_size, (4, 1024), generator=gen, device="cuda")
    y = torch.randint(0, config.vocab_size, (4, 1024), generator=gen, device="cuda")

    def loss_and_grads(cfg):
        _, loss = gpt2.forward(params, cfg, x, y, rng=(42, 0, 0), deterministic=False)
        return loss.item(), torch.autograd.grad(loss, param_list(params))

    no_dropout = config.replace(embd_dropout=0.0, attn_dropout=0.0, resid_dropout=0.0)
    for what, (label_a, cfg_a), (label_b, cfg_b) in (
            (f"dropout {DROPOUT}", ("kernel path", config.replace(attention_impl="flash")),
             ("plain path", config.replace(attention_impl="dense"))),
            ("dropout 0", ("fused_layers all", no_dropout.replace(fused_layers="all")),
             ("fused_layers off", no_dropout)),
            ("dropout 0", ("fused_matmul all + fused_layers all",
                           no_dropout.replace(fused_matmul="all", fused_layers="all")),
             ("fused off", no_dropout))):
        (loss_a, g_a), (loss_b, g_b) = loss_and_grads(cfg_a), loss_and_grads(cfg_b)
        rel = [((p - q).norm() / q.norm()).item() for p, q in zip(g_a, g_b)]
        finite = math.isfinite(loss_a) and all(torch.isfinite(g).all() for g in g_a)
        print(f"model 124M, one micro-batch [4, 1024], {what}: loss {label_a} "
              f"{loss_a:.5f}, {label_b} {loss_b:.5f} (|diff| {abs(loss_a - loss_b):.2e}, "
              f"tol {MODEL_LOSS_TOL}); grads: max relative L2 difference {max(rel):.3e} "
              f"over {len(rel)} tensors (tol {MODEL_GRAD_TOL}), median "
              f"{sorted(rel)[len(rel) // 2]:.3e}", flush=True)
        if not (finite and abs(loss_a - loss_b) <= MODEL_LOSS_TOL
                and max(rel) <= MODEL_GRAD_TOL):
            fail(f"the {label_a}'s loss or grads disagree with the {label_b}'s")


TRAIN_RUNS = (
    # (label, --fused_layers, --fused_matmul)
    ("off", "off", "off"),
    ("fused_layers all", "all", "off"),
    ("fused_matmul all", "all", "all"),
)
TRAIN_STEPS, TRAIN_ACCUM, TRAIN_EVAL_BATCHES = 16, 4, 4


def train_argv(data_dir: str, fused_layers: str = "off", fused_matmul: str = "off") -> list[str]:
    """The training runs' flags: 124M, seq 1024, batch 4, TRAIN_ACCUM
    micro-batches, dropout 0.1, TRAIN_STEPS steps, one eval at the end."""
    return ["--data_dir", data_dir, "--model", "124M", "--seq_len", "1024",
            "--batch", "4", "--grad_accum_steps", str(TRAIN_ACCUM), "--dropout",
            str(DROPOUT), "--lr", "6e-4", "--max_steps", str(TRAIN_STEPS), "--eval_every",
            str(TRAIN_STEPS), "--eval_batches", str(TRAIN_EVAL_BATCHES), "--cli_every", "1",
            "--fused_layers", fused_layers, "--fused_matmul", fused_matmul]


def training_wrappers() -> dict:
    """The launch-counted wrappers of the training runs, by name: K1, K2,
    K4-K6 and K7 (with its inference epilogues, which training must not
    launch)."""
    from gpt_2_distributed_torch.ops import flash_attention as fa
    from gpt_2_distributed_torch.ops import fused_layer as fl
    from gpt_2_distributed_torch.ops import fused_matmul as fm

    wrappers = {"flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_bwd": fa.flash_attention_bwd}
    wrappers.update((name, getattr(fl, name)) for name, _ in FUSED_WRAPPERS)
    wrappers.update((name, getattr(fm, name)) for name, _ in MM_WRAPPERS + MM_SERVE_WRAPPERS)
    return wrappers


def training_launches(fused_layers: str, fused_matmul: str, steps: int = TRAIN_STEPS,
                      eval_batches: int = TRAIN_EVAL_BATCHES,
                      accum: int = TRAIN_ACCUM) -> dict[str, int]:
    """The launches per process of one training run of ``train_argv``:
    ``steps`` x ``accum`` micro-batches and ``eval_batches`` eval
    batches through 12 layers. K1 runs in training and eval, K2 in
    training. The forward kernels of the fused legs run in both (at rate 0
    in eval), K5 (rate > 0 only) and every backward in training. With the
    fused matmuls K7 takes every leg K4-K6 would: its bias leg (qkv) and
    gelu leg (fc) once a layer, its resid legs (the two out-projections)
    twice, and one dgrad and one wgrad a leg."""
    from gpt_2_distributed_torch.config import MODEL_PRESETS

    n_layer, micro = MODEL_PRESETS["124M"].n_layer, steps * accum
    fwd, bwd = n_layer * (micro + eval_batches), n_layer * micro
    want = {name: 0 for name in training_wrappers()}
    want.update(flash_attention_fwd=fwd, flash_attention_bwd=bwd)
    if fused_matmul == "all":
        want.update(mm_bias_fwd=fwd, mm_gelu_fwd=fwd, mm_resid_fwd=2 * fwd,
                    mm_dgrad=3 * bwd, mm_dgrad_gelu=bwd, mm_wgrad=3 * bwd,
                    mm_wgrad_gelu=bwd, mm_du=4 * bwd)
    elif fused_layers == "all":
        for name, _ in FUSED_WRAPPERS:
            want[name] = fwd if name in ("ln_residual_dropout_fwd",
                                         "bias_gelu_dropout_fwd") else bwd
    return want


def phase_training(profile: bool) -> tuple[dict[str, dict[str, int]], dict[str, float],
                                           dict[str, list[float]]]:
    """``train.main()`` at 124M on synthetic shards, once for each of
    TRAIN_RUNS; returns each run's launches by wrapper name, its median
    ms/step and its losses."""
    import tempfile

    from gpt_2_distributed_torch import train
    from gpt_2_distributed_torch.config import MODEL_PRESETS
    from gpt_2_distributed_torch.data.synthetic import write_synthetic_shards
    from gpt_2_distributed_torch.utils import flops

    wrappers = training_wrappers()
    steps = TRAIN_STEPS
    counts, ms_steps, run_losses = {}, {}, {}
    with tempfile.TemporaryDirectory() as data_dir:
        write_synthetic_shards(data_dir, num_shards=4, tokens_per_shard=131072, seed=0)
        for label, fused_layers, fused_matmul in TRAIN_RUNS:
            for w in wrappers.values():
                w.launches = 0
            t0 = time.monotonic()
            tracker = train.main(train_argv(data_dir, fused_layers, fused_matmul))
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            got = counts[label] = {name: w.launches for name, w in wrappers.items()}
            losses = run_losses[label] = list(tracker.buffers["loss"])
            tok_s = sorted(tracker.buffers["tokens_per_second"])
            tok_s = tok_s[len(tok_s) // 2]    # median step; the first carries warm-up
            ms_step = ms_steps[label] = tracker.tokens_per_step / tok_s * 1e3
            mfu = flops.mfu(tok_s, MODEL_PRESETS["124M"], 1024, BF16_FLOPS_PER_S)
            eval_loss = tracker.buffers["eval_loss"][-1]
            skipped = tracker.buffers.get("skipped_steps", [0])[-1]
            print(f"training 124M, {label}: {steps} steps of "
                  f"{tracker.tokens_per_step} tokens in {wall:.1f} s (set-up included); "
                  f"median {ms_step:.1f} ms/step, {tok_s:,.0f} tok/s, MFU {100 * mfu:.2f}% "
                  f"of {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s; first loss {losses[0]:.4f}, "
                  f"last 5 mean {sum(losses[-5:]) / 5:.4f}, eval loss {eval_loss:.4f}, "
                  f"skipped {skipped:.0f}; launches {got}", flush=True)
            if not (len(losses) == steps and all(math.isfinite(v) for v in losses)
                    and math.isfinite(eval_loss)):
                fail(f"training ({label}) produced a missing or non-finite loss")
            if abs(losses[0] - math.log(50257)) > 0.3:
                fail(f"first loss {losses[0]:.4f} is not near ln(50257) = 10.82")
            if not sum(losses[-5:]) / 5 < losses[0]:
                fail(f"the training loss ({label}) did not fall")
            if skipped:
                fail(f"{skipped} steps were skipped by the guard")
            want = training_launches(fused_layers, fused_matmul)
            if got != want:
                fail(f"launch counts ({label}) {got} != {want}")
    print(f"training 124M in this call: fused_matmul all {ms_steps['fused_matmul all']:.1f} "
          f"ms/step against fused_layers all {ms_steps['fused_layers all']:.1f} ms/step "
          f"({ms_steps['fused_matmul all'] / ms_steps['fused_layers all']:.3f}x) and off "
          f"{ms_steps['off']:.1f} ms/step", flush=True)
    if profile:
        for _, fused_layers, fused_matmul in TRAIN_RUNS:
            profile_train_step(fused_layers, fused_matmul)
    return counts, ms_steps, run_losses


RESUME_PROMPTS = (1, 17, 100, 208)   # phase_serving's first 4 prompt lengths
RESUME_NEW = 16


class CheckpointProbe:
    """Records, while active, what the checkpoint plane did inside
    ``train.main()``: every ``StatsTracker`` made (a run that exits 143
    returns none), each save's step-loop stall (``save`` async or sync,
    ``ensure_committed_sync`` when it saved), each commit's write + commit
    time and each resume's restore time."""

    def __init__(self):
        from gpt_2_distributed_torch import checkpoint as ck
        from gpt_2_distributed_torch.metrics import tracker

        self.ck, self.tracker = ck, tracker
        self.trackers, self.stalls, self.commits, self.restores = [], [], [], []

    def __enter__(self):
        ck, probe = self.ck, self
        saver = ck.CheckpointSaver
        self.saved = (self.tracker.StatsTracker.__init__, saver.save,
                      saver.ensure_committed_sync, saver._write_and_commit,
                      ck.restore_latest_verified)
        init, save, ensure, commit, restore = self.saved

        def tracker_init(tr, *a, **kw):
            init(tr, *a, **kw)
            probe.trackers.append(tr)

        def saver_save(sv, step, *a, **kw):
            out = save(sv, step, *a, **kw)
            probe.stalls.append(("async" if sv.policy.async_save else "sync", step,
                                 sv.save_block_ms))
            return out

        def saver_ensure(sv, step, *a, **kw):
            n = sv._seq
            out = ensure(sv, step, *a, **kw)
            if sv._seq > n:    # it saved (rather than found the step committed)
                probe.stalls.append(("sync", step, sv.save_block_ms))
            return out

        def saver_commit(sv, path, step, *a, **kw):
            ok = commit(sv, path, step, *a, **kw)
            if ok:
                probe.commits.append((step, sv.commit_ms))
            return ok

        def timed_restore(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = restore(*a, **kw)
            torch.cuda.synchronize()
            probe.restores.append((time.perf_counter() - t0) * 1e3)
            return out

        self.tracker.StatsTracker.__init__ = tracker_init
        saver.save, saver.ensure_committed_sync = saver_save, saver_ensure
        saver._write_and_commit = saver_commit
        ck.restore_latest_verified = timed_restore
        return self

    def __exit__(self, *exc):
        init, save, ensure, commit, restore = self.saved
        self.tracker.StatsTracker.__init__ = init
        saver = self.ck.CheckpointSaver
        saver.save, saver.ensure_committed_sync, saver._write_and_commit = save, ensure, commit
        self.ck.restore_latest_verified = restore


def first_difference(a: list[float], b: list[float]) -> str:
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return f"step {i + 1}: {x!r} against {y!r}"
    return f"lengths {len(a)} against {len(b)}"


def phase_resume(fused_losses: list[float]) -> tuple[dict[str, int], dict[str, str]]:
    """Checkpoints and exact resume at 124M (step 13 of the module
    docstring); returns the launches of the runs and of the served
    checkpoint by wrapper name, and the sha256 of run A's final params,
    AdamW moments and step count."""
    import contextlib
    import hashlib
    import io
    import re
    import shutil
    import tempfile

    from gpt_2_distributed_torch import checkpoint as ck
    from gpt_2_distributed_torch import train
    from gpt_2_distributed_torch.config import MODEL_PRESETS
    from gpt_2_distributed_torch.data.synthetic import write_synthetic_shards
    from gpt_2_distributed_torch.models import decode
    from gpt_2_distributed_torch.ops import fused_matmul as fm
    from gpt_2_distributed_torch.ops.paged_attention import paged_attention_kernel
    from gpt_2_distributed_torch.resilience import PREEMPTED_EXIT_CODE, verify_checkpoint
    from gpt_2_distributed_torch.serving import serve

    wrappers = training_wrappers()
    wrappers["paged_attention_kernel"] = paged_attention_kernel
    half = TRAIN_STEPS // 2
    want_train = {**training_launches("all", "all"), "paged_attention_kernel": 0}
    t_phase = time.monotonic()
    total: dict[str, int] = collections.Counter()

    def counted(fn):
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        got = {name: w.launches for name, w in wrappers.items()}
        total.update(got)
        return out, got

    def digest(path: str) -> dict[str, str]:
        out = {}
        for rel in ("params/rank_00000.bin", "opt_state/rank_00000.bin",
                    "opt_state/state.json"):
            with open(os.path.join(path, rel), "rb") as f:
                out[rel] = hashlib.sha256(f.read()).hexdigest()
        return out

    def committed_and_verified(path: str) -> bool:
        return ck._dir_state(path) == "committed" and verify_checkpoint(path) == []

    with tempfile.TemporaryDirectory() as tmp, CheckpointProbe() as probe:
        data_dir = os.path.join(tmp, "data")
        write_synthetic_shards(data_dir, num_shards=4, tokens_per_shard=131072, seed=0)
        argv = train_argv(data_dir, "all", "all") + ["--save_every", str(half),
                                                     "--async_save", "on"]
        dir_a, dir_b = os.path.join(tmp, "a"), os.path.join(tmp, "b")

        # (a) the reference run
        t0 = time.monotonic()
        tracker_a, got_a = counted(lambda: train.main(argv + ["--save_dir", dir_a]))
        wall_a = time.monotonic() - t0
        losses_a = list(tracker_a.buffers["loss"])
        failures = tracker_a.buffers.get("save_failures", [0])[-1]
        ckpts_a = ck.list_checkpoints(dir_a)
        print(f"resume A: {TRAIN_STEPS} steps, async saves every {half}, in {wall_a:.1f} s; "
              f"losses bit-equal to phase 13's fused_matmul all run: "
              f"{losses_a == fused_losses}; save_failures {failures:.0f}; checkpoints "
              f"{[s for s, _ in ckpts_a]}, committed and verified: "
              f"{[committed_and_verified(p) for _, p in ckpts_a]}", flush=True)
        if losses_a != fused_losses:
            fail("run A's losses differ from phase 13's fused_matmul all run's at "
                 + first_difference(losses_a, fused_losses))
        if failures or [s for s, _ in ckpts_a] != [half, TRAIN_STEPS] or not all(
                committed_and_verified(p) for _, p in ckpts_a):
            fail("run A's checkpoints are not all committed and verified")
        if got_a != want_train:
            fail(f"run A's launches {got_a} != {want_train}")

        # (b) preempted after step half + 1
        t0 = time.monotonic()
        rc = None
        try:
            _, got_b = counted(lambda: train.main(argv + [
                "--save_dir", dir_b, "--inject_preempt_at", str(half + 1)]))
        except SystemExit as e:
            rc = e.code
            got_b = {name: w.launches for name, w in wrappers.items()}
            total.update(got_b)
        wall_b = time.monotonic() - t0
        losses_b = list(probe.trackers[-1].buffers["loss"])
        latest = ck.latest_checkpoint(dir_b)
        print(f"resume B: --inject_preempt_at {half + 1}: exit code {rc} in {wall_b:.1f} s; "
              f"newest checkpoint {os.path.basename(latest or 'none')}, committed and "
              f"verified: {latest is not None and committed_and_verified(latest)}; losses "
              f"bit-equal to A's first {half + 1}: {losses_b == losses_a[:half + 1]}",
              flush=True)
        if rc != PREEMPTED_EXIT_CODE:
            fail(f"run B exited {rc}, not {PREEMPTED_EXIT_CODE}")
        if latest is None or not latest.endswith(ck.step_dir_name(half + 1)) \
                or not committed_and_verified(latest):
            fail("run B left no committed emergency checkpoint of its last step")
        if losses_b != losses_a[:half + 1]:
            fail("run B's losses differ from A's at " + first_difference(losses_b, losses_a))

        # (c) resumed to TRAIN_STEPS
        t0 = time.monotonic()
        tracker_c, got_c = counted(lambda: train.main(argv + ["--save_dir", dir_b,
                                                              "--resume"]))
        wall_c = time.monotonic() - t0
        losses_c = list(tracker_c.buffers["loss"])
        end_a, end_c = (os.path.join(d, ck.step_dir_name(TRAIN_STEPS)) for d in (dir_a, dir_b))
        dig_a, dig_c = digest(end_a), digest(end_c)
        print(f"resume C: --resume from step {half + 1} to {TRAIN_STEPS} in {wall_c:.1f} s; "
              f"losses bit-equal to A's last {TRAIN_STEPS - half - 1}: "
              f"{losses_c == losses_a[half + 1:]}; final checkpoint's params, AdamW moments "
              f"and step count bit-equal to A's: {dig_a == dig_c} (sha256 "
              + ", ".join(f"{k} {v[:16]}" for k, v in dig_c.items()) + ")", flush=True)
        if losses_c != losses_a[half + 1:]:
            fail("run C's losses differ from A's at "
                 + first_difference(losses_c, losses_a[half + 1:]))
        if dig_a != dig_c:
            fail(f"run C's final state differs from A's: {dig_c} against {dig_a}")
        both = {name: got_b[name] + got_c[name] for name in want_train}
        if both != want_train:
            fail(f"runs B and C launched {both} together, not A's {want_train}")

        sizes = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(end_a)
                    for f in fs)
        stalls = {kind: [round(ms, 1) for k, _, ms in probe.stalls if k == kind]
                  for kind in ("async", "sync")}
        commits = [round(ms, 1) for _, ms in probe.commits]
        print(f"resume numbers: one 124M checkpoint {sizes:,} bytes (fp32 params and two "
              f"moments, meta, index, manifest); step-loop stall of an async save "
              f"{stalls['async']} ms, of a sync save {stalls['sync']} ms; write + commit "
              f"{commits} ms; restore on resume {[round(v, 1) for v in probe.restores]} ms",
              flush=True)
        shutil.rmtree(dir_a)

        # (d) the serve CLI on C's checkpoint
        config = MODEL_PRESETS["124M"]
        rng = torch.Generator().manual_seed(7)
        prompts = [torch.randint(0, config.vocab_size, (p,), generator=rng).tolist()
                   for p in RESUME_PROMPTS]
        reqs = os.path.join(tmp, "reqs.jsonl")
        with open(reqs, "w", encoding="utf-8") as f:
            for i, p in enumerate(prompts):
                f.write(json.dumps({"prompt_ids": p, "new": RESUME_NEW, "seed": i}) + "\n")
        out, err = io.StringIO(), io.StringIO()
        serve_wrappers = {"flash_attention_fwd": wrappers["flash_attention_fwd"],
                          "paged_attention_kernel": paged_attention_kernel,
                          "linear": fm.linear, "head_logits": fm.head_logits,
                          "ln_residual_dropout_fwd": wrappers["ln_residual_dropout_fwd"]}
        for w in serve_wrappers.values():
            w.launches = 0
        t0 = time.monotonic()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            serve.main(["--ckpt", dir_b, "--model", "124M", "--requests", reqs,
                        "--temperature", "0"])
        wall_s = time.monotonic() - t0
        got_s = {name: w.launches for name, w in serve_wrappers.items()}
        total.update(got_s)
        records = [json.loads(line) for line in out.getvalue().splitlines()]
        params, meta = ck.restore_params(end_c, "cuda", config)
        same = sum(r["generated"] == decode.generate_cached(
            params, config, [p], seed=i, max_new_tokens=RESUME_NEW, temperature=0.0,
            block_size=16)[0, len(p):].tolist() for i, (r, p) in enumerate(zip(records, prompts)))
        m = re.search(r"(\d+) decode steps", err.getvalue())
        steps = int(m.group(1)) if m else -1
        fwd = steps + len(prompts)
        want_s = {"flash_attention_fwd": 12 * len(prompts), "paged_attention_kernel": 12 * steps,
                  "linear": 48 * fwd, "head_logits": fwd, "ln_residual_dropout_fwd": 25 * fwd}
        print(f"resume serving: serve CLI --ckpt on C's dir (step {meta.step}) in "
              f"{wall_s:.1f} s, {len(records)} requests x {RESUME_NEW} greedy tokens, {steps} "
              f"decode steps; {same} of {len(prompts)} streams equal generate_cached(batch=1)'s "
              f"on restore_params' weights; launches {got_s}", flush=True)
        if "checkpoint: " not in err.getvalue() or meta.step != TRAIN_STEPS:
            fail(f"serve --ckpt did not load the step-{TRAIN_STEPS} checkpoint: "
                 f"{err.getvalue()[-1000:]}")
        if same != len(prompts) or any(len(r["generated"]) != RESUME_NEW for r in records):
            fail(f"serve --ckpt: {len(prompts) - same} streams differ from generate_cached's")
        if got_s != want_s:
            fail(f"serve --ckpt launches {got_s} != {want_s}")
    print(f"resume phase: {time.monotonic() - t_phase:.1f} s", flush=True)
    return dict(total), dig_a


# The fault detectors' phase: the hang is injected before step 9 of
# phase_resume's run A, so the watchdog's emergency checkpoint is step 8.
DETECT_HANG_AT = TRAIN_STEPS // 2 + 1
DETECT_HANG_TIMEOUT_S = 10
FINGERPRINT_CALLS = 20
FINGERPRINT_TOL = 2.0 ** -20   # of sum |p|: fp32 sums of 124M terms


def detector_worker(argv_json: str) -> None:
    """One process of ``phase_detectors``' and ``phase_elastic``'s CLI runs
    (``chip_smoke.py --detector_worker ARGV_JSON``): zeroes the training
    kernels' counts, runs ``train.main()`` on the argv and prints one
    ``detector_worker`` JSON line (its exit code, launches, the seconds
    from the hang watchdog's last arm to its exit, and the losses of a run
    that returned) when the run ends: from the
    watchdog's exit, which then ends the process with its code as before,
    or when ``train.main()`` returns or raises ``SystemExit``."""
    import functools

    from gpt_2_distributed_torch import coordination, train

    wrappers = training_wrappers()
    for w in wrappers.values():
        w.launches = 0
    last_arm = []

    def report(rc: int, losses: list[float] | None = None) -> None:
        print("detector_worker " + json.dumps({
            "rank": int(os.environ.get("RANK", "0")), "rc": rc,
            "launches": {name: w.launches for name, w in wrappers.items()},
            "beat_to_exit_s": time.monotonic() - last_arm[-1] if last_arm else None,
            "losses": losses,
        }), flush=True)

    def exit_after_report(code: int) -> None:
        report(code)
        os._exit(code)

    class Watchdog(coordination.HangWatchdog):
        def arm(self) -> None:
            last_arm.append(time.monotonic())
            super().arm()

    coordination.HangWatchdog = functools.partial(Watchdog, _exit=exit_after_report)
    try:
        tracker = train.main(json.loads(argv_json))
    except SystemExit as e:
        report(e.code if isinstance(e.code, int) else 1)
        raise
    report(0, list(tracker.buffers["loss"]))


def run_detector_workers(argv: list[str], world: int, log_dir: str) -> list[tuple[int, str, dict]]:
    """``world`` independent processes of ``detector_worker`` (ranks of
    one NCCL group over a local port when ``world`` > 1): each one's own
    exit code, output and report, in rank order."""
    import socket

    env = dict(os.environ)
    if world > 1:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env.update(WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    procs = []
    for r in range(world):
        log = os.path.join(log_dir, f"detector-rank{r}.log")
        with open(log, "w") as f:
            procs.append((subprocess.Popen(
                [sys.executable, __file__, "--detector_worker", json.dumps(argv)],
                env={**env, "RANK": str(r), "LOCAL_RANK": str(r)} if world > 1 else env,
                stdout=f, stderr=subprocess.STDOUT, text=True), log))
    out = []
    try:
        for p, log in procs:
            rc = p.wait(timeout=600)
            with open(log) as f:
                text = f.read()
            reports = [json.loads(line.split(" ", 1)[1]) for line in text.splitlines()
                       if line.startswith("detector_worker ")]
            out.append((rc, text, reports[-1] if reports else {}))
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def detector_mesh_runs(card: str) -> dict[str, int]:
    """``phase_detectors``' runs on two cards, where the machine has them:
    two ranks of ``detector_worker`` as independent processes over NCCL at
    data=2 with run A's flags, ``--shard_update off --desync_check_every 2
    --inject_desync_at 2 --max_rollbacks 0`` (rank 1 named, rc 1 on both)
    and ``--inject_worker_fail_at 2`` (rc 171 on both at the same step);
    each rank's launches those of its steps. Returns rank 0's launches."""
    import tempfile

    from gpt_2_distributed_torch.data.synthetic import write_synthetic_shards
    from gpt_2_distributed_torch.resilience import DATA_ABORT_EXIT_CODE, HANG_EXIT_CODE

    total: dict[str, int] = collections.Counter()
    if torch.cuda.device_count() < 2:
        print(f"detectors, data=2: the NCCL desync and data-worker runs need two GPUs and "
              f"this machine has {torch.cuda.device_count()}; "
              f"tests/test_torch_coordination.py holds them over gloo (desync names "
              f"rank 1, a worker failure ends both ranks with {DATA_ABORT_EXIT_CODE}, a "
              f"hang ends both with {HANG_EXIT_CODE})", flush=True)
        return {}
    with tempfile.TemporaryDirectory() as tmp:
        data2 = os.path.join(tmp, "data2")
        write_synthetic_shards(data2, num_shards=8, tokens_per_shard=262144, seed=0)
        base = train_argv(data2, "all", "all") + ["--mesh", "data=2"]
        runs = (
            ("desync", ["--shard_update", "off", "--desync_check_every", "2",
                        "--inject_desync_at", "2", "--max_rollbacks", "0"], 1),
            ("data worker", ["--inject_worker_fail_at", "2"], DATA_ABORT_EXIT_CODE),
        )
        for label, flags, want_rc in runs:
            t0 = time.monotonic()
            ranks = run_detector_workers(base + flags, 2, tmp)
            wall = time.monotonic() - t0
            rcs = [rc for rc, _, _ in ranks]
            out0, out1 = ranks[0][1], ranks[1][1]
            if label == "desync":
                ok = ("[coord] DESYNC at step 2: rank(s) [1]" in out0
                      and all("loss diverged" in o for o in (out0, out1)))
                steps = 2
            else:
                marks = [[line for line in o.splitlines()
                          if "pod-wide coordinated abort at step" in line] for o in (out0, out1)]
                at = [int(m[-1].split("at step ")[1].split(",")[0]) if m else -1
                      for m in marks]
                ok = at[0] == at[1] >= 1 and "[coord] local data worker failed" in out0
                steps = at[0]
            want = training_launches("all", "all", steps=steps, eval_batches=0)
            print(f"detectors, data=2 {label} over NCCL ({card}): exit codes {rcs} in "
                  f"{wall:.1f} s; " + ("rank 1 named, both stopped" if label == "desync"
                                       else f"both aborted at step {steps}")
                  + f": {ok}; launches per rank {[r.get('launches') for _, _, r in ranks]}",
                  flush=True)
            if rcs != [want_rc, want_rc] or not ok:
                fail(f"data=2 {label}: exit codes {rcs}, expected {want_rc} on both:\n"
                     f"{out0[-3000:]}\n{out1[-3000:]}")
            for _, _, r in ranks:
                if r.get("launches") != want:
                    fail(f"data=2 {label} rank {r.get('rank')} launches "
                         f"{r.get('launches')} != {want}")
            total.update(ranks[0][2]["launches"])
    return dict(total)


def phase_detectors(fused_losses: list[float], digest_a: dict[str, str],
                    card: str) -> dict[str, int]:
    """The fault detectors of a mesh run (step 14 of the module docstring):
    the parameter fingerprint at 124M on the card, the hang watchdog's
    exit and emergency checkpoint in phase_resume's run A with a hang
    injected, the resume from that checkpoint, and with two or more cards
    the desync and data-worker runs over NCCL; returns the launches of the
    runs on this card by wrapper name."""
    import hashlib
    import shutil
    import statistics
    import tempfile

    from gpt_2_distributed_torch import checkpoint as ck
    from gpt_2_distributed_torch import train
    from gpt_2_distributed_torch.config import MODEL_PRESETS
    from gpt_2_distributed_torch.coordination import fingerprint_params, perturb_params
    from gpt_2_distributed_torch.data.synthetic import write_synthetic_shards
    from gpt_2_distributed_torch.models import gpt2
    from gpt_2_distributed_torch.parallel import train_step as ts
    from gpt_2_distributed_torch.resilience import HANG_EXIT_CODE, verify_checkpoint

    t_phase = time.monotonic()
    total: dict[str, int] = collections.Counter()

    # (a) the fingerprint of 124M params on the card
    config = MODEL_PRESETS["124M"]
    params = ts.trainable_params(gpt2.init_params(config, seed=0), torch.device("cuda"))
    tensors = ts.param_list(params)
    fp = fingerprint_params(params)
    again = fingerprint_params(params)
    with torch.no_grad():
        ref = sum(float(t.double().sum()) for t in tensors)
        abs_sum = sum(float(t.double().abs().sum()) for t in tensors)
    times = []
    for _ in range(FINGERPRINT_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fingerprint_params(params)
        times.append((time.perf_counter() - t0) * 1e3)
    fp_ms = statistics.median(times)
    n_values = sum(t.numel() for t in tensors)
    perturb_params(tensors, 1.0)
    same = fingerprint_params(params)
    perturb_params(tensors, 1.001)
    moved = fingerprint_params(params)
    del params, tensors
    bound = FINGERPRINT_TOL * abs_sum
    print(f"fingerprint 124M on the card ({card}): {fp!r} ({n_values:,} fp32 values), twice "
          f"bit-identical: {fp == again}; after x1.0 bit-identical: {same == fp}; after "
          f"x1.001 {moved!r}, moved: {moved != fp}; against the fp64 sum {ref!r}: "
          f"|diff| {abs(fp - ref):.3g} <= 2^-20 sum|p| = {bound:.3g}: {abs(fp - ref) <= bound}; "
          f"median {fp_ms:.3f} ms of {FINGERPRINT_CALLS} calls (min {min(times):.3f}, max "
          f"{max(times):.3f}; one read of {4 * n_values / 1e6:.1f} MB at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s takes "
          f"{4 * n_values / HBM_BYTES_PER_S * 1e3:.3f} ms)", flush=True)
    if not (fp == again and same == fp and moved != fp and abs(fp - ref) <= bound):
        fail("the fingerprint is not reproducible, not moved by x1.001, moved by x1.0 or "
             "off its fp64 sum")

    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "data")
        write_synthetic_shards(data_dir, num_shards=4, tokens_per_shard=131072, seed=0)
        save_dir, trace_dir = os.path.join(tmp, "ckpt"), os.path.join(tmp, "trace")
        argv = train_argv(data_dir, "all", "all") + ["--save_dir", save_dir]
        half = DETECT_HANG_AT - 1

        # (b) a hang before step 9: rc 170 and the watchdog's checkpoint of step 8
        t0 = time.monotonic()
        [(rc, out, rep)] = run_detector_workers(
            argv + ["--hang_timeout_s", str(DETECT_HANG_TIMEOUT_S), "--inject_hang_at",
                    str(DETECT_HANG_AT), "--trace_dir", trace_dir], 1, tmp)
        wall_hang = time.monotonic() - t0
        lines = out.splitlines()
        spans = [lines[i + 1].strip() for i, line in enumerate(lines[:-1])
                 if line.startswith("[watchdog] open spans (innermost last):")]
        latest = ck.latest_checkpoint(save_dir)
        committed = (latest is not None and latest.endswith(ck.step_dir_name(half))
                     and ck._dir_state(latest) == "committed" and verify_checkpoint(latest) == [])
        want_hang = training_launches("all", "all", steps=half, eval_batches=0)
        print(f"detectors, hang: --hang_timeout_s {DETECT_HANG_TIMEOUT_S} --inject_hang_at "
              f"{DETECT_HANG_AT}: exit code {rc} in {wall_hang:.1f} s (start-up included); "
              f"{rep.get('beat_to_exit_s', float('nan')):.2f} s from the last beat to the "
              f"exit; open spans {spans}; newest checkpoint "
              f"{os.path.basename(latest or 'none')}, committed and verified: {committed}; "
              f"launches {rep.get('launches')}", flush=True)
        if rc != HANG_EXIT_CODE or rep.get("rc") != HANG_EXIT_CODE:
            fail(f"the hang run exited {rc}, not {HANG_EXIT_CODE}:\n{out[-4000:]}")
        if not spans or "step" not in spans[0]:
            fail(f"the watchdog's line names no open span:\n{out[-4000:]}")
        if not committed:
            fail(f"the watchdog left no committed, verified checkpoint of step {half}")
        if rep["launches"] != want_hang:
            fail(f"the hang run's launches {rep['launches']} != {want_hang}")
        total.update(rep["launches"])

        # ... and --resume from it to TRAIN_STEPS: run A's losses and final state
        wrappers = training_wrappers()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.monotonic()
        tracker = train.main(argv + ["--resume"])
        wall_resume = time.monotonic() - t0
        got = {name: w.launches for name, w in wrappers.items()}
        losses = list(tracker.buffers["loss"])
        end = os.path.join(save_dir, ck.step_dir_name(TRAIN_STEPS))
        dig = {}
        for rel in digest_a:
            with open(os.path.join(end, rel), "rb") as f:
                dig[rel] = hashlib.sha256(f.read()).hexdigest()
        want_resume = training_launches("all", "all", steps=TRAIN_STEPS - half)
        print(f"detectors, resume: --resume from the watchdog's step {half} to {TRAIN_STEPS} "
              f"in {wall_resume:.1f} s; losses bit-equal to run A's last {TRAIN_STEPS - half}: "
              f"{losses == fused_losses[half:]}; final params, AdamW moments and step count "
              f"bit-equal to A's (sha256): {dig == digest_a}; launches {got}", flush=True)
        if losses != fused_losses[half:]:
            fail("the resumed run's losses differ from A's at "
                 + first_difference(losses, fused_losses[half:]))
        if dig != digest_a:
            fail(f"the resumed run's final state differs from A's: {dig} against {digest_a}")
        if got != want_resume:
            fail(f"the resumed run's launches {got} != {want_resume}")
        total.update(got)
        shutil.rmtree(save_dir)

    # (c) the desync and data-worker runs on two cards
    total.update(detector_mesh_runs(card))
    print(f"detectors phase: {time.monotonic() - t_phase:.1f} s", flush=True)
    return dict(total)


# The elastic phase: every run at 124M with the fused paths, dropout 0 and
# one loader worker, so that each resized run reads E0's windows in E0's
# order; E0 saves at step 8. A resized run sums the same terms in another
# grouping (micro-batches of 2 or 8 rows in place of 4, the mesh's
# all-reduce), and AdamW's m / sqrt(v) turns that roundoff into lr-sized
# moves of the weights whose grads are near zero. On an H100 (lr 6e-4) E1
# drifted 2.86e-5 from E0 over its 8 steps, the grow 3.43e-5 and the
# shrink, whose first 8 steps ran at data=2 under the sharded update,
# 7.45e-4; a step read twice or skipped moves the loss by E0's
# step-to-step change (0.0026 to 0.061 there). The bound is the one the
# JAX package's elastic test holds the same comparison to.
ELASTIC_SAVE_AT = TRAIN_STEPS // 2
ELASTIC_LOSS_TOL = 2e-3


def elastic_argv(data_dir: str, save_dir: str, batch: int, accum: int,
                 *flags: str) -> list[str]:
    """``train_argv``'s fused run with dropout 0, one loader worker, no eval
    and checkpoints in ``save_dir``."""
    return train_argv(data_dir, "all", "all") + [
        "--dropout", "0", "--workers", "1", "--eval_every", "0", "--batch", str(batch),
        "--grad_accum_steps", str(accum), "--save_dir", save_dir, *flags]


def phase_elastic(card: str) -> dict[str, int]:
    """Elastic resume at 124M (step 15 of the module docstring); returns the
    launches of the runs on this card and of rank 0 of the two-card runs by
    wrapper name."""
    import contextlib
    import io
    import shutil
    import tempfile

    from gpt_2_distributed_torch import checkpoint as ck
    from gpt_2_distributed_torch import train
    from gpt_2_distributed_torch.data import dataloader as dl
    from gpt_2_distributed_torch.data.synthetic import write_synthetic_shards

    t_phase = time.monotonic()
    total: dict[str, int] = collections.Counter()
    wrappers = training_wrappers()
    half = ELASTIC_SAVE_AT

    def run_here(argv: list[str]) -> tuple[list[float], dict[str, int], str, float]:
        """``train.main(argv)`` in this process: its losses, launches,
        standard output and wall seconds."""
        for w in wrappers.values():
            w.launches = 0
        out = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(out):
            tracker = train.main(argv)
        torch.cuda.synchronize()
        got = {name: w.launches for name, w in wrappers.items()}
        total.update(got)
        return list(tracker.buffers["loss"]), got, out.getvalue(), time.monotonic() - t0

    def elastic_lines(out: str) -> list[str]:
        return [line for line in out.splitlines() if line.startswith("[elastic]")]

    def drift(label: str, losses: list[float], ref: list[float]) -> float:
        if len(losses) != len(ref) or not all(math.isfinite(v) for v in losses):
            fail(f"{label}: losses {losses} do not match the {len(ref)} steps of E0's")
        worst = max(abs(a - b) for a, b in zip(losses, ref))
        if worst > ELASTIC_LOSS_TOL:
            fail(f"{label}: losses {losses} drift {worst:.3g} from E0's {ref} (bound "
                 f"{ELASTIC_LOSS_TOL:g})")
        return worst

    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "data")
        write_synthetic_shards(data_dir, num_shards=4, tokens_per_shard=131072, seed=0)

        # (a) E0, then E1 on a copy of its step-8 checkpoint at another loader shape
        dir_e0 = os.path.join(tmp, "e0")
        losses_e0, got_e0, _, wall_e0 = run_here(elastic_argv(
            data_dir, dir_e0, 4, TRAIN_ACCUM, "--save_every", str(half)))
        want_e0 = training_launches("all", "all", eval_batches=0)
        steps = [abs(b - a) for a, b in zip(losses_e0[half - 1:], losses_e0[half:])]
        print(f"elastic E0: batch 4, accum {TRAIN_ACCUM}, {TRAIN_STEPS} steps in {wall_e0:.1f} "
              f"s, saved at step {half}; losses {[round(v, 4) for v in losses_e0]}; "
              f"step-to-step change after step {half}: {min(steps):.4f} to {max(steps):.4f}; "
              f"launches {got_e0}", flush=True)
        if len(losses_e0) != TRAIN_STEPS or not all(math.isfinite(v) for v in losses_e0):
            fail(f"E0 produced missing or non-finite losses: {losses_e0}")
        if got_e0 != want_e0:
            fail(f"E0's launches {got_e0} != {want_e0}")
        step_dir = os.path.join(dir_e0, ck.step_dir_name(half))

        def copy_of(name: str) -> str:
            d = os.path.join(tmp, name)
            os.makedirs(d)
            shutil.copytree(step_dir, os.path.join(d, os.path.basename(step_dir)))
            return d

        dir_e1 = copy_of("e1")
        losses_e1, got_e1, out_e1, wall_e1 = run_here(elastic_argv(
            data_dir, dir_e1, 2, 2 * TRAIN_ACCUM, "--resume"))
        lines = elastic_lines(out_e1)
        meta = ck.peek_latest_meta(dir_e1)
        t0 = time.perf_counter()
        plan = dl.replay_cursor_history(dl.get_shard_paths(data_dir, "train"), 1024,
                                        meta.epoch, meta.cursor_plan["resizes"])
        plan_ms = (time.perf_counter() - t0) * 1e3
        digest = dl.cursor_plan_digest(plan)
        worst_e1 = drift("E1", losses_e1, losses_e0[half:])
        want_e1 = training_launches("all", "all", steps=TRAIN_STEPS - half, eval_batches=0,
                                    accum=2 * TRAIN_ACCUM)
        print(f"elastic E1: --resume at batch 2, accum {2 * TRAIN_ACCUM} in {wall_e1:.1f} s; "
              f"{lines}; final step {meta.step}, cursor_plan digest "
              f"{meta.cursor_plan['digest'][:16]} equal to replay_cursor_history's here: "
              f"{meta.cursor_plan['digest'] == digest} ({meta.cursor_plan['windows']} windows, "
              f"plan rebuilt from file sizes in {plan_ms:.2f} ms); largest loss difference "
              f"to E0's last {TRAIN_STEPS - half}: {worst_e1:.3g} (bound "
              f"{ELASTIC_LOSS_TOL:g}); launches {got_e1}", flush=True)
        if not any("data cursor migrated" in line for line in lines) \
                or any("world resized" in line for line in lines):
            fail(f"E1 printed {lines}, not the cursor migration alone:\n{out_e1[-3000:]}")
        if meta.step != TRAIN_STEPS or meta.cursor_plan["digest"] != digest:
            fail(f"E1's final checkpoint (step {meta.step}) holds a cursor plan whose digest "
                 f"{meta.cursor_plan['digest']} != the recomputed {digest}")
        if got_e1 != want_e1:
            fail(f"E1's launches {got_e1} != {want_e1}")

        # (b) the shrink and the grow, on two cards
        if torch.cuda.device_count() < 2:
            print(f"elastic, two cards: the shrink (data=2 saved over NCCL, resumed on one "
                  f"card with --inject_world_size 1) and the grow (E0's step {half} resumed "
                  f"under --training_mode ddp) need two GPUs and this machine has "
                  f"{torch.cuda.device_count()}; tests/test_torch_elastic.py holds both over "
                  f"gloo", flush=True)
        else:
            want_rank = training_launches("all", "all", steps=half, eval_batches=0, accum=2)
            dir_s = os.path.join(tmp, "s")
            t0 = time.monotonic()
            ranks = run_detector_workers(elastic_argv(
                data_dir, dir_s, 4, 2, "--mesh", "data=2", "--max_steps", str(half),
                "--save_every", str(half)), 2, tmp)
            wall_s = time.monotonic() - t0
            if [rc for rc, _, _ in ranks] != [0, 0] or any(
                    r.get("launches") != want_rank for _, _, r in ranks):
                fail(f"run S at data=2: exit codes {[rc for rc, _, _ in ranks]}, launches "
                     f"{[r.get('launches') for _, _, r in ranks]} (want {want_rank}):\n"
                     + "\n".join(text[-3000:] for _, text, _ in ranks))
            total.update(ranks[0][2]["launches"])
            losses_sr, got_sr, out_sr, wall_sr = run_here(elastic_argv(
                data_dir, dir_s, 4, 2, "--mesh", "data=2", "--resume", "--inject_world_size",
                "1"))
            lines = elastic_lines(out_sr)
            worst_sr = drift("the shrink", losses_sr, losses_e0[half:])
            want_sr = training_launches("all", "all", steps=TRAIN_STEPS - half,
                                        eval_batches=0, accum=4)
            print(f"elastic shrink ({card}): run S, 2 ranks over NCCL at data=2, batch 4, "
                  f"accum 2, {half} steps in {wall_s:.1f} s; resumed on one card with "
                  f"--inject_world_size 1 in {wall_sr:.1f} s: {lines}; largest loss "
                  f"difference to E0's last {TRAIN_STEPS - half}: {worst_sr:.3g}; launches "
                  f"{got_sr}", flush=True)
            if not (any("world resized: 2 -> 1 device(s)" in line
                        and "--grad_accum_steps 2 -> 4" in line for line in lines)
                    and any("data cursor migrated" in line for line in lines)):
                fail(f"the shrink printed {lines}:\n{out_sr[-3000:]}")
            if got_sr != want_sr:
                fail(f"the shrink's launches {got_sr} != {want_sr}")

            dir_g = copy_of("g")
            t0 = time.monotonic()
            ranks = run_detector_workers(elastic_argv(
                data_dir, dir_g, 4, TRAIN_ACCUM, "--training_mode", "ddp", "--resume"), 2, tmp)
            wall_g = time.monotonic() - t0
            out0 = ranks[0][1]
            lines = elastic_lines(out0)
            losses_g = [r.get("losses") for _, _, r in ranks]
            if [rc for rc, _, _ in ranks] != [0, 0] or losses_g[0] != losses_g[1]:
                fail(f"the grow: exit codes {[rc for rc, _, _ in ranks]}, losses {losses_g}:\n"
                     + "\n".join(text[-3000:] for _, text, _ in ranks))
            worst_g = drift("the grow", losses_g[0], losses_e0[half:])
            print(f"elastic grow ({card}): E0's step {half} resumed under --training_mode ddp "
                  f"on 2 cards in {wall_g:.1f} s: {lines}; losses equal on both ranks: "
                  f"{losses_g[0] == losses_g[1]}; largest loss difference to E0's last "
                  f"{TRAIN_STEPS - half}: {worst_g:.3g}; launches per rank "
                  f"{[r.get('launches') for _, _, r in ranks]}", flush=True)
            if not (any("world resized: 1 -> 2 device(s)" in line
                        and f"--grad_accum_steps {TRAIN_ACCUM} -> 2" in line for line in lines)
                    and any("data cursor migrated" in line for line in lines)):
                fail(f"the grow printed {lines}:\n{out0[-3000:]}")
            for _, _, r in ranks:
                if r.get("launches") != want_rank:
                    fail(f"the grow's rank {r.get('rank')} launches {r.get('launches')} != "
                         f"{want_rank}")
            total.update(ranks[0][2]["launches"])
    print(f"elastic phase: {time.monotonic() - t_phase:.1f} s", flush=True)
    return dict(total)


# The front-end phase: phase_serving's prompt lengths, 64 new tokens, the
# shared-prefix fleet (8 sharers of a 512-token prefix and 4 strangers),
# and the profiler window of the traced CLI run.
FRONT_LENGTHS = (1, 17, 100, 208, 400, 512, 777, 960)
FRONT_NEW = 64
FRONT_STRANGERS = (33, 150, 600, 900)
FRONT_FLEET_NEW = (32, 16)   # greedy, sampled (temperature 1.0)
FRONT_PROFILE_AT = "3:2"
REPO_DIR = os.path.dirname(os.path.abspath(__file__))


def run_serve_cli(requests: str, flags: list[str], sigterm: bool = False) -> dict:
    """``gpt_2_distributed_torch.serving.serve`` on the 124M preset with
    random weights, greedy, streaming, in a subprocess; with ``sigterm``
    the process gets SIGTERM right after its first streamed token. Returns
    the streamed tokens by request id, the final records, the summary's
    numbers and stderr; fails unless it exits 0."""
    import re
    import tempfile

    cmd = [sys.executable, "-m", "gpt_2_distributed_torch.serving.serve", "--init_random",
           "--model", "124M", "--requests", requests, "--new", str(FRONT_NEW), "--stream",
           "--temperature", "0", *flags]
    with tempfile.TemporaryFile("w+") as errf:
        proc = subprocess.Popen(cmd, cwd=REPO_DIR, stdout=subprocess.PIPE, stderr=errf,
                                text=True)
        try:
            if sigterm:
                head = proc.stdout.readline()
                proc.send_signal(signal.SIGTERM)
            # One buffered stream throughout: the first line's read may
            # have buffered more.
            out = head + proc.stdout.read() if sigterm else proc.stdout.read()
            proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()
        errf.seek(0)
        err = errf.read()
    if proc.returncode != 0:
        fail(f"serve CLI {flags} exited {proc.returncode}: {err[-2000:]}")
    streams: dict[int, list[int]] = collections.defaultdict(list)
    finals = []
    for line in out.splitlines():
        rec = json.loads(line)
        if "token" in rec:
            streams[rec["id"]].append(rec["token"])
        else:
            finals.append(rec)
    m = re.search(r"(\d+) requests, (\d+) tokens, ([\d.]+)s \(\d+ tok/s\), (\d+) decode steps",
                  err)
    if m is None:
        fail(f"serve CLI {flags}: no summary line in {err[-2000:]}")
    toks, wall, steps = int(m.group(2)), float(m.group(3)), int(m.group(4))
    return {"streams": dict(streams), "finals": finals, "tok_s": toks / wall,
            "decode_steps": steps, "stderr": err}


def obs_report(trace_dir: str) -> dict:
    """``scripts/obs_report.py --json`` on a trace directory."""
    out = subprocess.run([sys.executable, "scripts/obs_report.py", "--json", trace_dir],
                         cwd=REPO_DIR, capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail(f"obs_report {trace_dir}: {out.stderr[-2000:]}")
    return json.loads(out.stdout)


def check_engine_trace(trace_dir: str, decode_steps: int) -> None:
    """Every engine_step span holds admit and prefill, and holds decode
    exactly when its step decoded (the next step's ``n`` is one more);
    the decode spans number the summary's decode steps."""
    with open(os.path.join(trace_dir, "trace-p0.jsonl"), encoding="utf-8") as f:
        spans = [r for r in map(json.loads, f) if r["ph"] == "span"]
    kids = collections.defaultdict(list)
    for r in spans:
        kids[r["parent"]].append(r["name"])
    steps = sorted((r for r in spans if r["name"] == "engine_step"), key=lambda r: r["ts"])
    n_decode = sum(r["name"] == "decode" for r in spans)
    if n_decode != decode_steps:
        fail(f"{n_decode} decode spans against {decode_steps} decode steps")
    for i, st in enumerate(steps):
        names = kids[st["sid"]]
        nxt = steps[i + 1]["attrs"]["n"] if i + 1 < len(steps) else decode_steps
        if not {"admit", "prefill"} <= set(names) or names.count("decode") != nxt - st["attrs"]["n"]:
            fail(f"engine_step {i} holds {names}; it decoded {nxt - st['attrs']['n']} times")


def check_profile_window(trace_dir: str) -> None:
    """The profiler window's Chrome trace holds the decode span's
    annotation and the K3 and K7 forward kernels."""
    import glob

    paths = glob.glob(os.path.join(trace_dir, "xla_profile", "*.json"))
    if len(paths) != 1:
        fail(f"profiler window: {paths}")
    with open(paths[0], encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    ann = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    have = {name: sum(name in k for k in kernels)
            for name in ("paged_split_kernel", "fwd_kernel", "flash_fwd_kernel")}
    print(f"front end: profiler window {FRONT_PROFILE_AT}: {len(kernels)} kernel launches, "
          f"annotations {sorted(ann)}, launches of K3 {have['paged_split_kernel']}, "
          f"K7 forward {have['fwd_kernel']}, K1 {have['flash_fwd_kernel']}", flush=True)
    if "decode" not in ann or not (have["paged_split_kernel"] and have["fwd_kernel"]):
        fail("the profiler window lacks the decode annotation or the K3/K7 kernels")


def http_get(port: int, path: str) -> tuple[int, dict]:
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    c.request("GET", path)
    r = c.getresponse()
    body = json.loads(r.read() or b"null")
    c.close()
    return r.status, body


def sse_stream(port: int, payload: dict, first, out: dict, key) -> None:
    """POST a streamed completion; ``out[key]`` = (status, tokens, saw
    [DONE]); ``first`` is set at the first data chunk."""
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    c.request("POST", "/v1/completions", json.dumps({**payload, "stream": True}),
              {"Content-Type": "application/json"})
    r = c.getresponse()
    toks, done = [], False
    for raw in r:
        line = raw.decode().rstrip("\r\n")
        if line == "data: [DONE]":
            done = True
        elif line.startswith("data: "):
            first.set()
            tok = json.loads(line[6:])["choices"][0]["token"]
            if tok is not None:
                toks.append(tok)
    c.close()
    out[key] = (r.status, toks, done)


def phase_frontend_http(prompts: list[list[int]], cli_streams: dict) -> None:
    """``gpt_2_distributed_torch.serving.frontend.server`` with 2 replicas
    at 124M on port 0: /healthz and /metrics, then 4 streamed completions
    at once, SIGTERM once each has its first token; the streams complete,
    equal the CLI's for the same seeds, and the process exits 0. The
    engines run on the server's driver thread."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "gpt_2_distributed_torch.serving.frontend.server",
         "--init_random", "--model", "124M", "--replicas", "2", "--port", "0",
         "--temperature", "0"],
        cwd=REPO_DIR, stderr=subprocess.PIPE, text=True)
    watchdog = threading.Timer(900, proc.kill)   # a hung server ends; the check then fails
    watchdog.start()
    try:
        port = None
        t0 = time.monotonic()
        for line in proc.stderr:
            if "frontend: http://" in line:
                port = int(line.rsplit(":", 1)[1].split()[0])
                break
        if port is None:
            fail(f"the front end never announced its port (rc {proc.poll()})")
        print(f"front end: HTTP server with 2 replicas up in {time.monotonic() - t0:.1f} s",
              flush=True)
        health, metrics = http_get(port, "/healthz"), http_get(port, "/metrics")
        if health != (200, {"status": "ok", "replicas": 2}) or metrics[0] != 200 \
                or not isinstance(metrics[1], dict) or metrics[1]["serve_replicas"] != 2.0:
            fail(f"/healthz {health}, /metrics {metrics[0]}")
        out, firsts, threads = {}, [], []
        for i in range(4):
            firsts.append(threading.Event())
            threads.append(threading.Thread(target=sse_stream, args=(
                port, {"prompt_ids": prompts[i], "max_tokens": FRONT_NEW, "seed": i},
                firsts[-1], out, i)))
            threads[-1].start()
        if not all(e.wait(300) for e in firsts):
            fail("a streamed completion never produced its first token")
        open_streams = 4 - len(out)
        proc.send_signal(signal.SIGTERM)
        for t in threads:
            t.join(600)
        rc = proc.wait(timeout=300)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
    same = sum(out.get(i, (0, None, False))[1] == cli_streams[i] for i in range(4))
    print(f"front end: HTTP: /healthz 200, /metrics JSON; 4 SSE streams, {open_streams} open at "
          f"SIGTERM, {same} of 4 equal to the CLI's; exit code {rc}", flush=True)
    if not (rc == 0 and same == 4 and open_streams > 0
            and all(out[i][0] == 200 and out[i][2] for i in range(4))):
        fail("the HTTP front end's streams or its SIGTERM drain failed")


def phase_frontend(train_losses_off: list[float]) -> dict[str, int]:
    """The serving CLI on the EngineDriver (plain, traced, traced with the
    prefix cache, chunks and a profiler window, and the SIGTERM drain),
    two replicas behind the ReplicaRouter in this process, the HTTP front
    end, and a traced training run; returns the launches of the
    in-process parts by wrapper name."""
    import tempfile

    from gpt_2_distributed_torch import train
    from gpt_2_distributed_torch.config import MODEL_PRESETS, ServeConfig
    from gpt_2_distributed_torch.data.synthetic import write_synthetic_shards
    from gpt_2_distributed_torch.models import decode, gpt2
    from gpt_2_distributed_torch.ops import flash_attention as fa
    from gpt_2_distributed_torch.ops import fused_matmul as fm
    from gpt_2_distributed_torch.ops.fused_layer import ln_residual_dropout_fwd
    from gpt_2_distributed_torch.ops.paged_attention import paged_attention_kernel
    from gpt_2_distributed_torch.serving import ServingEngine
    from gpt_2_distributed_torch.serving.frontend import EngineDriver, ReplicaRouter

    config = MODEL_PRESETS["124M"]
    params = gpt2.init_params(config)   # the CLIs' --init_random weights
    rng = torch.Generator().manual_seed(7)
    prompts = [torch.randint(0, config.vocab_size, (p,), generator=rng).tolist()
               for p in FRONT_LENGTHS]
    oracle = {}

    def reference(p, new, seed, temperature):
        key = (tuple(p), new, seed, temperature)
        if key not in oracle:
            oracle[key] = decode.generate_cached(
                params, config, [p], seed=seed, max_new_tokens=new, temperature=temperature,
                block_size=16)[0, len(p):].tolist()
        return oracle[key]

    with tempfile.TemporaryDirectory() as tmp:
        reqs = os.path.join(tmp, "reqs.jsonl")
        with open(reqs, "w", encoding="utf-8") as f:
            for i, p in enumerate(prompts):
                f.write(json.dumps({"prompt_ids": p, "new": FRONT_NEW, "seed": i}) + "\n")
        traced, chunked = os.path.join(tmp, "traced"), os.path.join(tmp, "chunked")
        runs = {
            "off (SIGTERM after the first token)": run_serve_cli(reqs, [], sigterm=True),
            "traced": run_serve_cli(reqs, ["--trace_dir", traced]),
            "traced, prefix cache, chunks of 256 x 4, profiler window": run_serve_cli(
                reqs, ["--trace_dir", chunked, "--xla_profile_at", FRONT_PROFILE_AT,
                       "--prefix_cache", "--prefill_chunk", "256", "--prefill_batch", "4"]),
        }
        off = runs["off (SIGTERM after the first token)"]
        if "[preempt] received signal 15" not in off["stderr"] or [
                (r["id"], r["finish_reason"], len(r["generated"])) for r in off["finals"]] \
                != [(i, "length", FRONT_NEW) for i in range(8)]:
            fail(f"the SIGTERM'd serve CLI did not print every final record: {off['finals']}")
        print("front end: serve CLI SIGTERM'd after its first token: 8 of 8 final records "
              "(finish_reason length, 64 tokens), exit code 0", flush=True)
        for label, run in runs.items():
            same = sum(run["streams"].get(i) == reference(p, FRONT_NEW, i, 0.0)
                       for i, p in enumerate(prompts))
            steps = run["decode_steps"]
            print(f"front end: serve CLI {label}: {run['tok_s']:.1f} tok/s (8 requests, "
                  f"{8 * FRONT_NEW} tokens, process set-up excluded), {steps} decode steps, "
                  f"{same} of 8 greedy streams equal generate_cached(batch=1)'s", flush=True)
            if same != 8:
                fail(f"serve CLI {label}: {8 - same} streams differ from generate_cached's")
        for label, d in (("traced", traced), ("chunked", chunked)):
            run = runs["traced"] if label == "traced" else runs[
                "traced, prefix cache, chunks of 256 x 4, profiler window"]
            check_engine_trace(d, run["decode_steps"])
            rep = obs_report(d)
            rows = {r["rid"]: r for r in rep["serving"]["requests"]}
            ttft_equal = sum(round(rows[r["id"]]["first_token_ms"], 2) == r["ttft_ms"]
                             for r in run["finals"])
            es = rep["engine_steps"]
            shares = ", ".join(f"{k} {v['share_pct']:.1f}%" for k, v in es["phases"].items())
            dec = es["phases"]["decode"]
            print(f"front end: {label} trace: {es['n_steps']} engine steps, mean "
                  f"{es['step']['mean_ms']:.3f} ms; decode span mean {dec['mean_ms']:.3f} ms "
                  f"(p50 {dec['p50_ms']:.3f}) over {dec['n']} steps; shares of engine_step "
                  f"wall: {shares}; attributed {es['attributed_pct']:.1f}%; trace TTFT equal "
                  f"to the record's ttft_ms for {ttft_equal} of 8", flush=True)
            if ttft_equal != 8:
                fail(f"{label}: the trace's TTFT differs from the records'")
        check_profile_window(chunked)
    phase_frontend_http(prompts, runs["traced"]["streams"])

    # Two replicas in this process behind the affinity router, prefix cache
    # on, whole-prompt mode: 8 sharers of a 512-token prefix among 4
    # strangers, greedy then sampled.
    wrappers = {"flash_attention_fwd_offset": fa.flash_attention_fwd_offset,
                "flash_attention_fwd": fa.flash_attention_fwd,
                "paged_attention_kernel": paged_attention_kernel,
                "linear": fm.linear, "head_logits": fm.head_logits,
                "ln_residual_dropout_fwd": ln_residual_dropout_fwd}
    serve = ServeConfig(max_batch=8, block_size=16, num_blocks=513, prefix_cache=True)
    router = ReplicaRouter(lambda: ServingEngine(params, config, serve, temperature=0.0),
                           replicas=2, policy="affinity")
    driver = EngineDriver(router)
    rng = torch.Generator().manual_seed(13)
    prefix = torch.randint(0, config.vocab_size, (PREFIX_LEN,), generator=rng).tolist()
    sharers = [prefix + torch.randint(0, config.vocab_size, (s,), generator=rng).tolist()
               for s in PREFIX_SUFFIXES]
    strangers = [torch.randint(0, config.vocab_size, (n,), generator=rng).tolist()
                 for n in FRONT_STRANGERS]
    order = [(p, True) for p in sharers[:2]] + [(strangers[0], False)] + [
        (p, True) for p in sharers[2:5]] + [(strangers[1], False), (strangers[2], False)] + [
        (p, True) for p in sharers[5:]] + [(strangers[3], False)]
    for e in router.engines:   # warm-up (allocator, both prefill paths), not counted
        for _ in range(2):
            e.submit(strangers[0][:40], 2)
            e.run_until_idle()
        e.clear_prefix_cache()
    before = [dict(e.stats) for e in router.engines]
    for w in wrappers.values():
        w.launches = 0
    fleet = []
    t0 = time.monotonic()
    for temperature, new, seed0 in ((0.0, FRONT_FLEET_NEW[0], 0), (1.0, FRONT_FLEET_NEW[1], 500)):
        for e in router.engines:
            e.temperature = temperature
        hs = [(p, shared, seed0 + i, driver.submit(p, new, seed=seed0 + i))
              for i, (p, shared) in enumerate(order)]
        driver.drain()
        fleet.append((temperature, new, hs))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    got = {name: w.launches for name, w in wrappers.items()}
    n_layer = config.n_layer
    whole = sum(h.prefix_cached_tokens == 0 for _, _, hs in fleet for *_, h in hs)
    d = {k: sum(e.stats[k] - b[k] for e, b in zip(router.engines, before))
         for k in ("prefill_dispatches", "decode_steps", "prefix_hit_tokens", "cow_copies")}
    dispatches, steps = d["prefill_dispatches"] - whole, d["decode_steps"]
    want = {"flash_attention_fwd_offset": n_layer * dispatches,
            "flash_attention_fwd": n_layer * whole,
            "paged_attention_kernel": n_layer * steps,
            "linear": 4 * n_layer * (whole + dispatches + steps),
            "head_logits": whole + dispatches + steps,
            "ln_residual_dropout_fwd": (2 * n_layer + 1) * (whole + dispatches + steps)}
    placed = {(temperature, shared): sorted({h.replica for _, s, _, h in hs if s == shared})
              for temperature, _, hs in fleet for shared in (True, False)}
    same = sum(h.generated == reference(p, new, seed, temperature)
               for temperature, new, hs in fleet for p, _, seed, h in hs)
    total = sum(len(hs) for _, _, hs in fleet)
    print(f"front end: 2 replicas in process (affinity, prefix cache): {total} requests in "
          f"{wall:.2f} s; sharers of the prefix on replicas {placed[0.0, True]} (greedy) and "
          f"{placed[1.0, True]} (sampled), strangers on {placed[0.0, False]} and "
          f"{placed[1.0, False]}; {router.affinity_hits} affinity routes, prefix_hit_tokens "
          f"{d['prefix_hit_tokens']}, cow_copies {d['cow_copies']}; {same} of {total} streams "
          f"equal generate_cached(batch=1)'s; launches {got} over {whole} whole prefills, "
          f"{dispatches} chunk dispatches and {steps} decode steps", flush=True)
    if not (len(placed[0.0, True]) == len(placed[1.0, True]) == 1 and same == total
            and whole and dispatches and got == want and d["cow_copies"]):
        fail(f"two-replica fleet: placement, streams or launches {got} != {want}")
    del router, driver

    # A traced training run of TRAIN_RUNS' "off" configuration.
    for w in (fa.flash_attention_fwd, fa.flash_attention_bwd):
        w.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        data_dir, trace_dir = os.path.join(tmp, "shards"), os.path.join(tmp, "trace")
        write_synthetic_shards(data_dir, num_shards=4, tokens_per_shard=131072, seed=0)
        tracker = train.main(train_argv(data_dir) + ["--trace_dir", trace_dir])
        torch.cuda.synchronize()
        rep = obs_report(trace_dir)["train_steps"]
    losses = list(tracker.buffers["loss"])
    tok_s = sorted(tracker.buffers["tokens_per_second"])
    ms_step = tracker.tokens_per_step / tok_s[len(tok_s) // 2] * 1e3
    shares = ", ".join(f"{k} {v['share_pct']:.1f}%" for k, v in rep["phases"].items())
    print(f"front end: traced training 124M (off): {rep['n_steps']} step spans, median "
          f"{ms_step:.1f} ms/step; shares of the step wall: {shares}; attributed "
          f"{rep['attributed_pct']:.1f}%; losses bit-equal to the untraced run's: "
          f"{losses == train_losses_off}", flush=True)
    micro = TRAIN_STEPS * TRAIN_ACCUM
    train_got = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches)
    train_want = (n_layer * (micro + TRAIN_EVAL_BATCHES), n_layer * micro)
    if not (rep["n_steps"] == TRAIN_STEPS and rep["attributed_pct"] >= 90.0
            and losses == train_losses_off and train_got == train_want):
        fail(f"the traced training run's steps, attribution, losses or launches {train_got} "
             f"!= {train_want} are off")
    got["flash_attention_fwd"] += train_got[0]
    got["flash_attention_bwd"] = train_got[1]
    return got


# Process isolation: worker processes under subprocess and remote placement,
# killed, stopped, hung and partitioned mid-decode.
WORKER_NEW = (64, 32)          # greedy, sampled
WORKER_SAMPLING = (0.9, 40)    # temperature, top-k of the sampled fleets
WORKER_SEED0 = 700
WORKER_KILL_STEP = 10          # fleet step of the SIGKILL, the SIGSTOP and the partition
WORKER_HANG_STEP = 5
WORKER_WATCHDOG_S = 3.0       # far above any step: the hang is the only trip
WORKER_HEARTBEAT = (0.05, 1.0)   # --worker_heartbeat_s, --worker_heartbeat_timeout_s
WORKER_WRAPPERS = ("flash_attention_fwd", "flash_attention_fwd_offset",
                   "paged_attention_kernel", "linear", "head_logits",
                   "ln_residual_dropout_fwd")


def serve_worker(argv: list[str]) -> None:
    """One serving worker of ``phase_workers`` (``chip_smoke.py
    --serve_worker [--cold_build DIR] WORKER_ARGS``): the worker CLI's
    ``main`` on WORKER_ARGS, with its kernels built into DIR (empty: a cold
    build) when given. When ``main`` returns (its frontend shut it down) or
    on SIGTERM (a TCP worker, which outlives its frontends), it prints one
    ``serve_worker`` JSON line: its pid, its engine's stats and the serving
    kernels' launches. A SIGKILLed worker prints none."""
    import pathlib

    if argv[:1] == ["--cold_build"]:
        from gpt_2_distributed_torch.kernels import build

        build.BUILD_DIR = pathlib.Path(argv[1])
        argv = argv[2:]
    from gpt_2_distributed_torch.serving import serve
    from gpt_2_distributed_torch.serving.frontend import worker

    engines = []
    make_factory = serve.engine_factory

    def engine_factory(p, args, device):
        make = make_factory(p, args, device)

        def make_and_keep():
            engines.append(make())
            return engines[-1]

        return make_and_keep

    serve.engine_factory = engine_factory

    def report() -> None:
        from gpt_2_distributed_torch.ops import flash_attention as fa
        from gpt_2_distributed_torch.ops import fused_layer, fused_matmul, paged_attention

        wrappers = {"flash_attention_fwd": fa.flash_attention_fwd,
                    "flash_attention_fwd_offset": fa.flash_attention_fwd_offset,
                    "paged_attention_kernel": paged_attention.paged_attention_kernel,
                    "linear": fused_matmul.linear, "head_logits": fused_matmul.head_logits,
                    "ln_residual_dropout_fwd": fused_layer.ln_residual_dropout_fwd}
        line = "serve_worker " + json.dumps({
            "pid": os.getpid(),
            "stats": engines[0].stats if engines else None,
            "launches": {name: w.launches for name, w in wrappers.items()},
        }) + "\n"
        # One write(2): the workers of a fleet share the frontend's log,
        # and a print's pieces could interleave with another process's.
        sys.stdout.flush()
        os.write(sys.stdout.fileno(), line.encode())

    def on_term(*_):
        report()
        os._exit(0)

    signal.signal(signal.SIGTERM, on_term)
    worker.main(argv)
    report()


def worker_launches_from_stats(stats: dict, n_layer: int) -> dict[str, int]:
    """The launches a whole-prompt engine's stats imply (as in
    ``phase_preempt_serving``): fresh admissions prefill whole through K1,
    resumes and adoptions through the chunk path (K1's offset form, and K3
    once a layer more for a dispatch with decode-written rows)."""
    whole = stats["admitted"] - stats["resumes"]
    dispatches = stats["prefill_dispatches"] - whole
    steps, resumed = stats["decode_steps"], stats["resume_dispatches"]
    return {"flash_attention_fwd": n_layer * whole,
            "flash_attention_fwd_offset": n_layer * dispatches,
            "paged_attention_kernel": n_layer * (steps + resumed),
            "linear": 4 * n_layer * (whole + dispatches + steps),
            "head_logits": whole + dispatches + steps,
            "ln_residual_dropout_fwd": (2 * n_layer + 1) * (whole + dispatches + steps)}


def workers_frontend(spec_path: str, out_path: str) -> None:
    """The frontend of ``phase_workers`` (``chip_smoke.py
    --workers_frontend SPEC OUT``), a process that never touches the card:
    fleets of ``--serve_worker`` processes at 124M on cuda, faults injected
    mid-decode, every fact the parent checks written to OUT as JSON."""
    import statistics

    from gpt_2_distributed_torch.obs.trace import configure_tracing
    from gpt_2_distributed_torch.resilience import FaultInjector, worker_env
    from gpt_2_distributed_torch.serving import serve
    from gpt_2_distributed_torch.serving.frontend import (
        Autoscaler,
        ChaosProxy,
        EngineDriver,
        RemoteSpawner,
        ReplicaRouter,
        read_worker_pool,
        worker,
    )
    from gpt_2_distributed_torch.serving.frontend.rpc import load_auth_token

    with open(spec_path) as f:
        spec = json.load(f)
    prompts, tmp = spec["prompts"], spec["tmp"]
    configure_tracing(os.path.join(tmp, "trace"))
    ready: list[list] = []      # [seconds from Popen to hello, cold]
    entry = [sys.executable, os.path.abspath(__file__), "--serve_worker"]

    class TimedSpawner(worker.WorkerSpawner):
        cold_dir = None

        def __call__(self):
            base, cold = self.argv, self.cold_dir is not None and self.spawns == 0
            if cold:
                self.argv = base[:3] + ["--cold_build", self.cold_dir] + base[3:]
            t0 = time.monotonic()
            try:
                return super().__call__()
            finally:
                self.argv = base
                ready.append([time.monotonic() - t0, cold])

    worker.WorkerSpawner = TimedSpawner
    hb, hb_timeout = WORKER_HEARTBEAT

    def args_for(temperature: float, top_k: int | None, placement: str):
        flags = ["--init_random", "--model", "124M", "--max_batch", "8", "--block_size", "16",
                 "--device", "cuda", "--requests", "-", "--placement", placement,
                 "--temperature", str(temperature), "--worker_respawn_backoff_s", "0",
                 "--worker_heartbeat_s", str(hb), "--worker_heartbeat_timeout_s", str(hb_timeout)]
        if top_k is not None:
            flags += ["--top_k", str(top_k)]
        if placement == "remote":
            flags += ["--worker_pool", os.path.join(tmp, "pool")]
        args = serve.build_argparser().parse_args(flags)
        return args, serve.build_serve_config(args, serve.model_config_from_args(args))

    def fleet(temperature: float, top_k: int | None, cold_dir: str | None = None):
        args, sc = args_for(temperature, top_k, "subprocess")
        sp = worker.spawner_from_args(args, sc, initial_replicas=2)
        sp.argv = entry + sp.argv[3:]
        sp.cold_dir = cold_dir
        router = ReplicaRouter(sp, replicas=2, max_replicas=3, policy="round_robin")
        sp.router = router
        return router, sp

    def run(driver, new: int, hook=None) -> dict:
        """The 8 prompts through ``driver``; ``hook(driver)`` before each step."""
        counts: dict[int, int] = {}
        stamps: dict[int, list[float]] = {}

        def on_token(h, _tok):
            counts[h.id] = counts.get(h.id, 0) + 1
            stamps.setdefault(h.id, []).append(time.monotonic())

        hs = [driver.submit(p, new, seed=WORKER_SEED0 + i, on_token=on_token)
              for i, p in enumerate(prompts)]
        placed = {h.id: h.replica for h in hs}
        while driver.has_work():
            if hook is not None:
                hook(driver)
            driver.step()
        return {"streams": [h.generated for h in hs],
                "reasons": [h.finish_reason for h in hs],
                "emitted_once": all(counts.get(h.id, 0) == len(h.generated) for h in hs),
                "placed": [placed[h.id] for h in hs], "replicas": [h.replica for h in hs],
                "stamps": [stamps.get(h.id, []) for h in hs]}

    def next_token_ms(res: dict, t_fault: float, victim: int) -> float:
        """The longest wait of a stream that was on ``victim`` for its first
        token after ``t_fault``."""
        waits = [min(t for t in s if t > t_fault) - t_fault
                 for s, r in zip(res["stamps"], res["placed"]) if r == victim
                 and any(t > t_fault for t in s)]
        return max(waits) * 1e3

    def kill_run(router, new: int) -> dict:
        fault = {}

        def kill(r):
            fault["t"] = time.monotonic()
            router.engines[r].kill(signal.SIGKILL)

        inj = FaultInjector(kill_at=(WORKER_KILL_STEP, 0), kill_fn=kill)
        driver = EngineDriver(router, injector=inj, autoscale_every=8,
                              autoscaler=Autoscaler(router, min_replicas=2, max_replicas=3))
        res = run(driver, new)
        res.update(kill_fired=inj.kill_fired, kill_rc=router.engines[0].proc.returncode,
                   kill_to_next_token_ms=next_token_ms(res, fault["t"], 0),
                   failed=router.failed_indices(), migrated=router.migrated,
                   worker_restarts=router.metrics_snapshot()["worker_restarts"])
        return res

    out: dict = {}
    greedy_new, sampled_new = WORKER_NEW
    temperature, top_k = WORKER_SAMPLING

    # Fleet G, greedy: its first worker builds the kernels into an empty
    # directory (the cold spawn). G1 a SIGKILL, G2 a hang under the
    # watchdog, G3 the RPC's cost a step on the one worker left.
    router, _ = fleet(0.0, None, cold_dir=os.path.join(tmp, "cold_build"))
    out["G1"] = kill_run(router, greedy_new)
    inj = FaultInjector(hang_at=(WORKER_HANG_STEP, 1))
    driver = EngineDriver(router, watchdog_timeout_s=WORKER_WATCHDOG_S, injector=inj)
    out["G2"] = run(driver, greedy_new)
    out["G2"].update(hang_fired=inj.hang_fired, watchdog_trips=driver.watchdog_trips,
                     failed=router.failed_indices())
    h = router.engines[2]
    hs = [h.submit(p, greedy_new, seed=i) for i, p in enumerate(prompts)]
    walls, spans = [], []
    while h.has_work():
        decoding = all(r.generated for r in hs)    # 8 rows decode, none prefills
        before = h.stats["decode_ms"]
        t0 = time.monotonic()
        h.step()
        if decoding and h.occupancy == len(prompts):
            walls.append(time.monotonic() - t0)
            spans.append(h.stats["decode_ms"] - before)
    beats = []
    for _ in range(50):
        t0 = time.monotonic()
        h._rpc({"op": "heartbeat"})
        beats.append(time.monotonic() - t0)
    out["G3"] = {"streams": [r.generated for r in hs], "step_walls": walls,
                 "median_step_ms": statistics.median(walls) * 1e3,
                 "median_decode_ms": statistics.median(spans),
                 "median_heartbeat_ms": statistics.median(beats) * 1e3}
    driver.close()

    # Fleet S, sampled: S1 a SIGKILL, S2 a SIGSTOP between two steps.
    router, _ = fleet(temperature, top_k)
    out["S1"] = kill_run(router, sampled_new)

    class StopProbe(EngineDriver):
        t_stop = t_detect = None

        def _check_worker_health(self):
            failed = super()._check_worker_health()
            if failed and self.t_stop is not None and self.t_detect is None:
                self.t_detect = time.monotonic()
            return failed

    def stop(driver):
        if driver.steps == WORKER_KILL_STEP and driver.t_stop is None:
            router.engines[1].kill(signal.SIGSTOP)
            driver.t_stop = time.monotonic()
            time.sleep(2 * hb)      # past --worker_heartbeat_s: the sweep probes

    driver = StopProbe(router)
    out["S2"] = run(driver, sampled_new, stop)
    victim = router.engines[1]
    out["S2"].update(detect_s=driver.t_detect - driver.t_stop, dead=victim._dead,
                     victim_rc=victim.proc.returncode, failed=router.failed_indices(),
                     stop_to_next_token_ms=next_token_ms(out["S2"], driver.t_stop, 1))
    driver.close()

    # Remote placement: TCP workers on hosts A and B behind chaos proxies;
    # host A partitioned mid-decode, healed after.
    args, sc = args_for(temperature, top_k, "remote")
    ledger, token = os.path.join(tmp, "ledger"), os.path.join(tmp, "token")
    with open(token, "w") as f:
        f.write("phase-workers-secret\n")
    flags = worker.worker_argv(args, sc)[3:] + ["--socket", "tcp://127.0.0.1:0",
                                                "--advertise", ledger,
                                                "--auth_token_file", token]
    t0 = time.monotonic()
    tcp = [subprocess.Popen(entry + flags + ["--host_id", host], env=worker_env("cuda"))
           for host in ("A", "B")]
    proxies = []
    try:
        while True:
            try:
                if len(read_worker_pool(ledger)) == 2:
                    break
            except (OSError, ValueError):
                pass    # not written yet
            if any(p.poll() is not None for p in tcp) or time.monotonic() - t0 > 300:
                raise RuntimeError("the TCP workers did not advertise")
            time.sleep(0.1)
        pool = []
        for e in sorted(read_worker_pool(ledger), key=lambda e: e["host_id"]):
            proxies.append(ChaosProxy(e["addr"]))
            pool.append({"host_id": e["host_id"], "addr": proxies[-1].addr, "handle": None})
        with open(args.worker_pool, "w") as f:
            f.writelines(f"{e['host_id']} {e['addr']}\n" for e in pool)
        sp = RemoteSpawner(read_worker_pool(args.worker_pool), sc, initial_replicas=1,
                           respawn_backoff_s=0.0, heartbeat_s=hb, heartbeat_timeout_s=hb_timeout,
                           connect_timeout_s=300.0, auth_token=load_auth_token(token))
        router = ReplicaRouter(sp, replicas=1, max_replicas=2, policy="round_robin")
        sp.router = router
        out["remote_ready_s"] = time.monotonic() - t0
        partition = {}

        def cut(driver):
            if driver.steps == WORKER_KILL_STEP and not partition:
                proxies[0].partition()
                partition["t"] = time.monotonic()
                time.sleep(2 * hb)

        driver = EngineDriver(router)
        out["R"] = run(driver, sampled_new, cut)
        out["R"].update(host_failures=router.host_failures, failed=router.failed_indices(),
                        hosts=[e.host_id for e in router.engines], respawns=sp.respawns,
                        dead_hosts=sorted(sp.dead_hosts),
                        cut_to_next_token_ms=next_token_ms(out["R"], partition["t"], 0))
        proxies[0].heal()
        t_heal = time.monotonic()
        while sp.dead_hosts and time.monotonic() - t_heal < 30:
            router.poll_hosts()
            time.sleep(0.1)
        out["R"]["readmitted_s"] = (time.monotonic() - t_heal) if not sp.dead_hosts else None
        driver.close()
    finally:
        for px in proxies:
            px.close()
        for p in tcp:
            p.terminate()       # the worker's SIGTERM report, then exit
        for p in tcp:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
    configure_tracing(None)
    trace = os.path.join(tmp, "trace")
    report = subprocess.run([sys.executable, "scripts/obs_report.py", "--json", trace],
                            cwd=REPO_DIR, capture_output=True, text=True, timeout=300)
    out["lifecycle"] = json.loads(report.stdout)["workers"] if report.returncode == 0 else None
    events = collections.Counter()
    for name in os.listdir(trace):
        with open(os.path.join(trace, name)) as f:
            events.update(json.loads(line).get("name") for line in f if line.strip())
    out["watchdog_fired_events"] = events["watchdog_fired"]
    out["spawn_ready_s"] = ready
    out["cuda_initialized"] = torch.cuda.is_initialized()
    with open(out_path, "w") as f:
        json.dump(out, f)


def phase_workers(card: str) -> dict[str, int]:
    """Process isolation on the card: ``workers_frontend`` in a child
    process (which must end with no CUDA context) drives fleets of worker
    processes at 124M; every stream equal to ``generate_cached(batch=1)``'s
    computed here, the faults contained, and the workers' own launch counts
    those their stats imply. Returns the launches the workers reported."""
    import statistics
    import tempfile

    from gpt_2_distributed_torch.config import MODEL_PRESETS, ServeConfig
    from gpt_2_distributed_torch.models import decode, gpt2
    from gpt_2_distributed_torch.serving import ServingEngine

    config = MODEL_PRESETS["124M"]
    params = gpt2.init_params(config)   # the workers' --init_random weights
    rng = torch.Generator().manual_seed(7)
    prompts = [torch.randint(0, config.vocab_size, (p,), generator=rng).tolist()
               for p in SERVING_LENGTHS]
    greedy_new, sampled_new = WORKER_NEW
    temperature, top_k = WORKER_SAMPLING
    t0 = time.monotonic()
    refs = {"greedy": [], "sampled": []}
    for i, p in enumerate(prompts):
        for label, new, temp, k in (("greedy", greedy_new, 0.0, None),
                                    ("sampled", sampled_new, temperature, top_k)):
            refs[label].append(decode.generate_cached(
                params, config, [p], seed=WORKER_SEED0 + i, max_new_tokens=new,
                temperature=temp, top_k=k, block_size=16)[0, len(p):].tolist())
    # The in-process step wall at batch 8, the counterpart of G3's.
    eng = ServingEngine(params, config, ServeConfig(max_batch=8, block_size=16, num_blocks=513),
                        temperature=0.0)
    eng.submit(prompts[0], 2)
    eng.run_until_idle()
    hs = [eng.submit(p, greedy_new, seed=i) for i, p in enumerate(prompts)]
    walls, spans = [], []
    while eng.has_work():
        decoding = all(h.generated for h in hs)
        before = eng.stats["decode_ms"]
        t1 = time.monotonic()
        eng.step()
        if decoding and eng.occupancy == len(prompts):
            walls.append(time.monotonic() - t1)
            spans.append(eng.stats["decode_ms"] - before)
    inproc_ms, inproc_decode_ms = statistics.median(walls) * 1e3, statistics.median(spans)
    if [h.generated for h in hs] != refs["greedy"]:
        fail("workers: the in-process engine's greedy streams differ from generate_cached's")
    del eng
    torch.cuda.empty_cache()
    print(f"workers: references and the in-process step walls in "
          f"{time.monotonic() - t0:.1f} s", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip-workers-") as tmp:
        spec, out_path = os.path.join(tmp, "spec.json"), os.path.join(tmp, "out.json")
        with open(spec, "w") as f:
            json.dump({"prompts": prompts, "tmp": tmp}, f)
        log = os.path.join(tmp, "frontend.log")
        t0 = time.monotonic()
        # A session of its own: on a timeout the frontend and every worker
        # it started (they stay in its process group) are killed together.
        with open(log, "w") as f:
            child = subprocess.Popen([sys.executable, __file__, "--workers_frontend", spec,
                                      out_path], stdout=f, stderr=subprocess.STDOUT,
                                     start_new_session=True)
            try:
                rc = child.wait(timeout=900)
            except subprocess.TimeoutExpired:
                rc = None
            try:
                os.killpg(child.pid, signal.SIGKILL)   # stragglers, if any
            except ProcessLookupError:
                pass
            if rc is None:
                rc = child.wait()
        wall = time.monotonic() - t0
        with open(log) as f:
            text = f.read()
        if rc != 0 or not os.path.exists(out_path):
            print(text[-8000:], flush=True)
            fail(f"workers: the frontend process exited {rc}")
        with open(out_path) as f:
            out = json.load(f)
    decoder = json.JSONDecoder()
    reports = [decoder.raw_decode(line, line.index("serve_worker {") + 13)[0]
               for line in text.splitlines() if "serve_worker {" in line]

    def streams_equal(res: dict, label: str) -> int:
        return sum(a == b for a, b in zip(res["streams"], refs[label]))

    problems = []
    for name, label, new in (("G1", "greedy", greedy_new), ("G2", "greedy", greedy_new),
                             ("S1", "sampled", sampled_new), ("S2", "sampled", sampled_new),
                             ("R", "sampled", sampled_new)):
        res = out[name]
        same = streams_equal(res, label)
        print(f"workers {name} ({label}): {same} of {len(prompts)} streams equal "
              f"generate_cached(batch=1)'s; each token emitted once: {res['emitted_once']}; "
              f"finish reasons {sorted(set(res['reasons']))}", flush=True)
        if same != len(prompts) or not res["emitted_once"] or set(res["reasons"]) != {"length"}:
            problems.append(f"{name}: {same} streams equal, emitted once {res['emitted_once']}")
    g1, g2, s1, s2, r = (out[k] for k in ("G1", "G2", "S1", "S2", "R"))
    for name, res in (("G1", g1), ("S1", s1)):
        print(f"workers {name}: SIGKILL of worker 0 at fleet step {WORKER_KILL_STEP} (rc "
              f"{res['kill_rc']}): failed {res['failed']}, {res['migrated']} requests migrated, "
              f"worker_restarts {res['worker_restarts']:g}; kill to the migrated streams' next "
              f"token {res['kill_to_next_token_ms']:.1f} ms", flush=True)
        if not (res["kill_fired"] and res["kill_rc"] == -signal.SIGKILL and res["failed"] == [0]
                and res["migrated"] >= 1 and res["worker_restarts"] == 1):
            problems.append(f"{name}: the SIGKILL was not contained as one replica failure")
    print(f"workers G2: a hang at fleet step {WORKER_HANG_STEP} on replica 1 under a "
          f"{WORKER_WATCHDOG_S:g} s watchdog: {g2['watchdog_trips']} trip, failed {g2['failed']}, "
          f"watchdog_fired events {out['watchdog_fired_events']}", flush=True)
    if not (g2["hang_fired"] and g2["watchdog_trips"] == 1 and g2["failed"] == [0, 1]
            and out["watchdog_fired_events"] == 1):
        problems.append("G2: the watchdog did not trip once and fail replica 1")
    print(f"workers S2: SIGSTOP of worker 1 found {s2['detect_s']:.2f} s later ({s2['dead']!r}; "
          f"--worker_heartbeat_s {WORKER_HEARTBEAT[0]:g}, two attempts of "
          f"--worker_heartbeat_timeout_s {WORKER_HEARTBEAT[1]:g}), the frozen process reaped "
          f"(rc {s2['victim_rc']}); stop to the migrated streams' next token "
          f"{s2['stop_to_next_token_ms']:.1f} ms", flush=True)
    if not (s2["dead"] == "heartbeat loss" and s2["victim_rc"] == -signal.SIGKILL
            and s2["detect_s"] <= 2 * WORKER_HEARTBEAT[0] + 2 * WORKER_HEARTBEAT[1] + 1.0
            and s2["failed"] == [0, 1]):
        problems.append("S2: the SIGSTOP was not found as heartbeat loss in time")
    print(f"workers R: two TCP workers ready in {out['remote_ready_s']:.1f} s; host A "
          f"partitioned at fleet step {WORKER_KILL_STEP}: host_failures {r['host_failures']}, "
          f"failed {r['failed']}, hosts {r['hosts']}, partition to the migrated streams' next "
          f"token {r['cut_to_next_token_ms']:.1f} ms; after heal() host A re-admitted in "
          f"{r['readmitted_s'] if r['readmitted_s'] is None else round(r['readmitted_s'], 2)} s",
          flush=True)
    if not (r["host_failures"] == 1 and r["failed"] == [0] and r["hosts"] == ["A", "B"]
            and r["respawns"] == 1 and r["readmitted_s"] is not None):
        problems.append("R: the partition was not one host death, or host A never rejoined")
    life = out["lifecycle"] or {}
    want_life = {"n_spawns": 8, "n_respawns": 3, "n_hosts_lost": 1, "n_hosts_joined": 1}
    got_life = {k: life.get(k) for k in want_life}
    print(f"workers: obs_report lifecycle rows {got_life}, heartbeat losses "
          f"{life.get('n_heartbeat_losses')}", flush=True)
    if got_life != want_life or (life.get("n_heartbeat_losses") or 0) < 2:
        problems.append(f"lifecycle rows {got_life} != {want_life}")
    g3 = out["G3"]
    if [list(s) for s in g3["streams"]] != refs["greedy"]:
        problems.append("G3: the single worker's greedy streams differ")
    cold = [s for s, c in out["spawn_ready_s"] if c]
    warm = sorted(s for s, c in out["spawn_ready_s"] if not c)
    print(f"workers: median step wall at batch 8 (greedy, 124M): {g3['median_step_ms']:.3f} ms "
          f"through a worker (the step RPC, {len(g3['step_walls'])} steps; the worker's decode "
          f"span {g3['median_decode_ms']:.3f} ms) against {inproc_ms:.3f} ms in process (its "
          f"decode span {inproc_decode_ms:.3f} ms): the RPC costs "
          f"{g3['median_step_ms'] - inproc_ms:.3f} ms a step; a heartbeat round trip "
          f"{g3['median_heartbeat_ms']:.3f} ms; spawn to ready {cold[0] if cold else float('nan'):.1f} s cold (nvcc of "
          f"the serving kernels into an empty build dir), warm median "
          f"{statistics.median(warm):.1f} s (min {warm[0]:.1f}, max {warm[-1]:.1f}, "
          f"{len(warm)} spawns); the frontend process {wall:.1f} s; {card}", flush=True)
    if out["cuda_initialized"]:
        problems.append("the frontend process opened a CUDA context")
    print(f"workers: torch.cuda.is_initialized() in the frontend process at its end: "
          f"{out['cuda_initialized']}", flush=True)

    got = {name: 0 for name in WORKER_WRAPPERS}
    for rep in reports:
        want = worker_launches_from_stats(rep["stats"], config.n_layer)
        if rep["launches"] != want:
            problems.append(f"worker pid {rep['pid']}: launches {rep['launches']} != {want}")
        for name in WORKER_WRAPPERS:
            got[name] += rep["launches"][name]
    print(f"workers: launches {got}, reported by {len(reports)} of the 8 workers at their "
          f"exit (the SIGKILLed, SIGSTOPped and watchdog-failed workers are killed and report "
          f"none), each equal to what its stats imply", flush=True)
    if not all(got.values()):
        problems.append(f"a serving kernel was never launched in the workers: {got}")
    if problems:
        fail("workers: " + "; ".join(problems))
    return got


SP_ARGS = ("--model", "124M", "--seq_len", "1024", "--batch", "4", "--grad_accum_steps", "4",
           "--dropout", str(DROPOUT), "--lr", "6e-4", "--max_steps", "16", "--eval_every", "16",
           "--eval_batches", "4", "--cli_every", "1", "--mesh", "sp=2")


def sp_worker(data_dir: str, profile: bool) -> None:
    """One rank of the sp=2 training run (``chip_smoke.py --sp_worker DIR``
    under ``torch.distributed.run``): zeroes the attention kernels' counts,
    runs ``train.main()`` with ``--mesh sp=2`` and prints one ``sp_worker``
    JSON line with its launches, losses and step times. With ``profile``
    rank 0 runs under a ``torch.profiler`` window (whole run, set-up and
    eval included) and prints its breakdown."""
    import os

    from gpt_2_distributed_torch import train
    from gpt_2_distributed_torch.ops import flash_attention as fa
    from gpt_2_distributed_torch.ops import flash_block as fb

    wrappers = {"flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_bwd": fa.flash_attention_bwd,
                "flash_block_fwd": fb.flash_block_fwd, "flash_block_bwd": fb.flash_block_bwd}
    for w in wrappers.values():
        w.launches = 0
    rank = int(os.environ["RANK"])
    run = {}

    def train_run() -> int:
        run["tracker"] = train.main(["--data_dir", data_dir, *SP_ARGS])
        return 16

    if profile and rank == 0:
        profile_window("training 124M --mesh sp=2, rank 0, the whole run", train_run)
    else:
        train_run()
    tracker = run["tracker"]
    torch.cuda.synchronize()
    print("sp_worker " + json.dumps({
        "rank": rank,
        "launches": {name: w.launches for name, w in wrappers.items()},
        "losses": list(tracker.buffers["loss"]),
        "eval_loss": tracker.buffers["eval_loss"][-1],
        "tokens_per_second": list(tracker.buffers["tokens_per_second"]),
        "tokens_per_step": tracker.tokens_per_step,
    }), flush=True)


def phase_sp_training(local_ms_step: float, profile: bool) -> dict[str, int] | None:
    """``--mesh sp=2`` training at 124M on two cards (NCCL), when the
    machine has them: ``torch.distributed.run`` starts two ranks of this
    script in ``--sp_worker`` mode; checks finite, falling losses that agree
    across ranks, a first loss near ln 50257, and per rank K8's exact
    launches (12 layers x sp blocks x micro-batches (+ eval batches)) with
    K1 = K2 = 0; prints ms/step and tok/s beside the local step of
    ``phase_training``. Returns rank 0's launches, or None on one card."""
    import tempfile

    from gpt_2_distributed_torch.data.synthetic import write_synthetic_shards

    if torch.cuda.device_count() < 2:
        print("training --mesh sp=2: the NCCL ring needs two GPUs and this machine has "
              f"{torch.cuda.device_count()}; the sp=2 training path is held on the CPU over "
              "gloo by tests/test_torch_ring_train.py, and K8 on this card by the one-card "
              "ring above", flush=True)
        return None
    sp, steps, accum, eval_batches, n_layer = 2, 16, 4, 4, 12
    with tempfile.TemporaryDirectory() as data_dir:
        write_synthetic_shards(data_dir, num_shards=4, tokens_per_shard=131072, seed=0)
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
             str(sp), __file__, "--sp_worker", data_dir] + (["--profile"] if profile else []),
            capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        fail(f"sp=2 training exited with {proc.returncode}:\n{proc.stdout[-4000:]}"
             f"\n{proc.stderr[-4000:]}")
    for line in proc.stdout.splitlines():
        if line.startswith(("profile ", "  ")):
            print(line, flush=True)
    ranks = sorted((json.loads(line.split(" ", 1)[1]) for line in proc.stdout.splitlines()
                    if line.startswith("sp_worker ")), key=lambda r: r["rank"])
    if len(ranks) != sp:
        fail(f"sp=2 training reported {len(ranks)} ranks:\n{proc.stdout[-4000:]}")
    micro = steps * accum
    want = {"flash_attention_fwd": 0, "flash_attention_bwd": 0,
            "flash_block_fwd": n_layer * sp * (micro + eval_batches),
            "flash_block_bwd": n_layer * sp * micro}
    losses = ranks[0]["losses"]
    tok_s = sorted(ranks[0]["tokens_per_second"])[steps // 2]
    ms_step = ranks[0]["tokens_per_step"] / tok_s * 1e3
    print(f"training 124M --mesh sp=2 on {sp} cards: median {ms_step:.1f} ms/step "
          f"({tok_s:,.0f} tok/s over both cards) against the local step's {local_ms_step:.1f} "
          f"ms/step in this call; first loss {losses[0]:.4f}, last 5 mean "
          f"{sum(losses[-5:]) / 5:.4f}, eval loss {ranks[0]['eval_loss']:.4f}; launches per "
          f"rank {[r['launches'] for r in ranks]}", flush=True)
    if not (len(losses) == steps and all(math.isfinite(v) for v in losses)
            and all(r["losses"] == losses for r in ranks)):
        fail("sp=2 training produced missing, non-finite or rank-dependent losses")
    if abs(losses[0] - math.log(50257)) > 0.3 or not sum(losses[-5:]) / 5 < losses[0]:
        fail("sp=2 training: the first loss is not near ln(50257) or the loss did not fall")
    for r in ranks:
        if r["launches"] != want:
            fail(f"sp=2 training rank {r['rank']} launches {r['launches']} != {want}")
    return ranks[0]["launches"]


# The data-parallel and fully-sharded training runs on two cards: (label,
# mesh flags, --fused_layers, --fused_matmul, the share of the replicated
# layout's bytes that each rank holds after a step of the AdamW moments
# and of the fp32 params with their grads). --shard_update holds the whole
# params and, beside them, its master shards and their grads: all told
# the replicated bytes.
DDP_RUNS = (
    ("--training_mode ddp (data=2, shard_update auto), fused all",
     ["--training_mode", "ddp"], "all", "all", 0.5, 1.0),
    ("--training_mode fsdp (fsdp=2)", ["--training_mode", "fsdp"], "off", "off", 0.5, 0.5),
    ("--mesh data=2 --shard_update off", ["--mesh", "data=2", "--shard_update", "off"],
     "off", "off", 1.0, 1.0),
)


def ddp_worker(data_dir: str, index: int, profile: bool) -> None:
    """One rank of a DDP_RUNS run (``chip_smoke.py --ddp_worker DIR I``
    under ``torch.distributed.run``): zeroes the training kernels' counts
    and the card's peak-memory mark, runs ``train.main()`` with the run's
    flags and prints one ``ddp_worker`` JSON line with its launches,
    losses, step times, a digest of its whole params after the run, the
    bytes it holds of the training state (``train_step.state_bytes``) and
    its peak allocated bytes. The optimizer and the sharded state are read
    through a wrapper of ``make_optimizer``, which the CLI calls. With
    ``profile`` rank 0 profiles its middle optimizer step (through a
    wrapper of ``make_train_step``) and prints its device and host
    breakdown."""
    import hashlib
    import os

    from gpt_2_distributed_torch import train
    from gpt_2_distributed_torch.parallel import train_step as ts

    label, flags, fused_layers, fused_matmul, _, _ = DDP_RUNS[index]
    wrappers = training_wrappers()
    for w in wrappers.values():
        w.launches = 0
    made = {}
    make_optimizer = ts.make_optimizer

    def capture(params, *args, **kwargs):
        made["params"], made["sharded"] = params, kwargs.get("sharded")
        made["optimizer"] = make_optimizer(params, *args, **kwargs)
        return made["optimizer"]

    def gather_then_destroy(*args, **kwargs):
        # train.main() ends the process group on its way out: gather the
        # whole params (fsdp holds only shards) while it still runs.
        params, sharded = made["params"], made["sharded"]
        made["whole"] = [p.detach().cpu() for p in ts.param_list(
            params if sharded is None else sharded.full_params(params))]
        destroy(*args, **kwargs)

    def profiled(*args, **kwargs):
        step, calls = make_train_step(*args, **kwargs), [0]

        def one(*a):
            calls[0] += 1
            if calls[0] != TRAIN_STEPS // 2:
                return step(*a)
            out = []
            profile_window(f"training 124M {label}, rank 0, step {calls[0]}",
                           lambda: (out.append(step(*a)), 1)[1], host_ops=12)
            return out[0]
        return one

    ts.make_optimizer = capture
    make_train_step = ts.make_train_step
    rank = int(os.environ["RANK"])
    if profile and rank == 0:
        ts.make_train_step = profiled
    destroy = torch.distributed.destroy_process_group
    torch.distributed.destroy_process_group = gather_then_destroy
    torch.cuda.reset_peak_memory_stats()
    made["tracker"] = train.main(train_argv(data_dir, fused_layers, fused_matmul) + flags)
    torch.cuda.synchronize()
    tracker, whole = made["tracker"], made["whole"]
    digest = hashlib.sha256()
    for p in whole:
        digest.update(p.numpy().tobytes())
    print("ddp_worker " + json.dumps({
        "rank": rank,
        "launches": {name: w.launches for name, w in wrappers.items()},
        "losses": list(tracker.buffers["loss"]),
        "eval_loss": tracker.buffers["eval_loss"][-1],
        "skipped": tracker.buffers.get("skipped_steps", [0])[-1],
        "tokens_per_second": list(tracker.buffers["tokens_per_second"]),
        "tokens_per_step": tracker.tokens_per_step,
        "params_sha256": digest.hexdigest(),
        "held": ts.state_bytes(made["params"], made["optimizer"], made["sharded"]),
        "param_bytes": sum(p.nbytes for p in whole),
        "peak_bytes": torch.cuda.max_memory_allocated(),
    }), flush=True)


def phase_ddp_training(local_ms_steps: dict[str, float], card: str, profile: bool) -> None:
    """DDP_RUNS at 124M on two cards (NCCL), when the machine has them:
    ``torch.distributed.run`` starts two ranks of this script in
    ``--ddp_worker`` mode per run; checks finite, falling losses equal on
    both ranks with the first near ln 50257, no skipped step, the final
    params bit-identical across ranks (a digest per rank), each rank's
    launches of K1, K2, K4-K7 equal to those its micro-batches imply
    (``training_launches``), each rank's AdamW moments and its fp32 params
    with their grads the run's shares of the replicated layout's, and the
    fsdp run's peak allocation below the replicated run's by at least half
    of the state bytes fsdp sheds; prints ms/step and tok/s beside the
    local step's of ``phase_training`` in this call."""
    import tempfile

    from gpt_2_distributed_torch.data.synthetic import write_synthetic_shards

    if torch.cuda.device_count() < 2:
        print("training --training_mode ddp / fsdp: the NCCL runs need two GPUs and this "
              f"machine has {torch.cuda.device_count()}; the data=2, fsdp=2, data=2 x fsdp=2 "
              "and data=2 x sp=2 steps are held on the CPU over gloo by "
              "tests/test_torch_ddp.py (against the local step and the JAX package's "
              "mesh steps), and the kernels' per-shard seeds on this card by the "
              "per-rank check above", flush=True)
        return
    with tempfile.TemporaryDirectory() as data_dir:
        # Two ranks read a global batch of 8 rows: twice the local runs' data.
        write_synthetic_shards(data_dir, num_shards=8, tokens_per_shard=262144, seed=0)
        peaks, held = {}, {}
        for index, (label, _, fused_layers, fused_matmul, share, held_share) in enumerate(
                DDP_RUNS):
            proc = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node", "2", __file__, "--ddp_worker", data_dir, str(index)]
                + (["--profile"] if profile else []),
                capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                fail(f"{label} exited with {proc.returncode}:\n{proc.stdout[-4000:]}"
                     f"\n{proc.stderr[-4000:]}")
            for line in proc.stdout.splitlines():
                if line.startswith(("profile ", "  ")):
                    print(line, flush=True)
            ranks = sorted((json.loads(line.split(" ", 1)[1])
                            for line in proc.stdout.splitlines()
                            if line.startswith("ddp_worker ")), key=lambda r: r["rank"])
            if len(ranks) != 2:
                fail(f"{label} reported {len(ranks)} ranks:\n{proc.stdout[-4000:]}")
            losses = ranks[0]["losses"]
            tok_s = sorted(ranks[0]["tokens_per_second"])[TRAIN_STEPS // 2]
            ms_step = ranks[0]["tokens_per_step"] / tok_s * 1e3
            local_label = "fused_matmul all" if fused_matmul == "all" else "off"
            replicated = {"moments": 2 * ranks[0]["param_bytes"],
                          "params": 2 * ranks[0]["param_bytes"]}
            moments = [r["held"]["moments"] / replicated["moments"] for r in ranks]
            pg = [(r["held"]["params"] + r["held"]["grads"]) / replicated["params"] for r in ranks]
            peaks[index] = max(r["peak_bytes"] for r in ranks)
            held[index] = max(sum(r["held"].values()) for r in ranks)
            print(f"training 124M {label} on 2 cards ({card}): median {ms_step:.1f} ms/step "
                  f"({tok_s:,.0f} tok/s over both cards, {ranks[0]['tokens_per_step']} tokens "
                  f"a step) against the local {local_label} step's "
                  f"{local_ms_steps[local_label]:.1f} ms/step in this call; first loss "
                  f"{losses[0]:.4f}, last 5 mean {sum(losses[-5:]) / 5:.4f}, eval loss "
                  f"{ranks[0]['eval_loss']:.4f}; AdamW moments per rank "
                  f"{[r['held']['moments'] for r in ranks]} bytes ({moments[0]:.4f} of the "
                  f"replicated layout's {replicated['moments']}); fp32 params + grads per "
                  f"rank {[r['held']['params'] + r['held']['grads'] for r in ranks]} bytes "
                  f"({pg[0]:.4f} of {replicated['params']}); peak allocated per rank "
                  f"{[r['peak_bytes'] for r in ranks]} bytes; params "
                  f"sha256 per rank {[r['params_sha256'][:16] for r in ranks]}; launches "
                  f"per rank {[r['launches'] for r in ranks]}", flush=True)
            if not (len(losses) == TRAIN_STEPS and all(math.isfinite(v) for v in losses)
                    and all(r["losses"] == losses for r in ranks)
                    and math.isfinite(ranks[0]["eval_loss"])):
                fail(f"{label}: missing, non-finite or rank-dependent losses")
            if abs(losses[0] - math.log(50257)) > 0.3 or not sum(losses[-5:]) / 5 < losses[0]:
                fail(f"{label}: the first loss is not near ln(50257) or the loss did not fall")
            if any(r["skipped"] for r in ranks):
                fail(f"{label}: the guard skipped a step")
            if len({r["params_sha256"] for r in ranks}) != 1:
                fail(f"{label}: the ranks end with different params")
            want = training_launches(fused_layers, fused_matmul)
            for r in ranks:
                if r["launches"] != want:
                    fail(f"{label} rank {r['rank']} launches {r['launches']} != {want}")
            if not all(abs(m - share) < 0.01 for m in moments):
                fail(f"{label}: AdamW moments per rank are {moments} of the replicated "
                     f"layout's, not {share}")
            if not all(abs(m - held_share) < 0.01 for m in pg):
                fail(f"{label}: fp32 params and grads per rank are {pg} of the replicated "
                     f"layout's, not {held_share}")
    # fsdp (run 1) sheds half the replicated state (run 2): its peak must
    # fall by at least half of that (the rest may go to whole tensors in
    # flight and to the allocator's rounding).
    shed = held[2] - held[1]
    print(f"training 124M on 2 cards ({card}): fsdp=2 peak {peaks[1]} bytes against "
          f"data=2 off's {peaks[2]}: {peaks[2] - peaks[1]} bytes lower; held state "
          f"{held[1]} against {held[2]} bytes", flush=True)
    if not peaks[2] - peaks[1] >= shed / 2:
        fail(f"fsdp=2 peak {peaks[1]} bytes is not {shed / 2:.0f} bytes below the replicated "
             f"run's {peaks[2]}")


def phase_ddp_ranks() -> None:
    """Every rank of a data=2 x fsdp=2 mesh in this process, one after the
    other (``activate_mesh(Mesh(spec, r))``, no process group): on that
    rank's 4 rows of a global batch of 16 at 124M shapes, dropout 0.1, the
    kernels the mesh runs with the per-shard seed of ``models/gpt2.py::
    _site_seed`` (K1, K2, K4 and K6 forward and backward, K5 and its
    rescale, K7's gelu and resid forward and the gelu leg's du, dgrad and
    wgrad) against their plain versions under the same seed, to the
    per-element bounds above; the ranks' masks (K5 on x = 0, o = 1) all
    differ; the unfused dropout's rank blocks equal the global draw's rows
    bit for bit."""
    from gpt_2_distributed_torch.models import gpt2
    from gpt_2_distributed_torch.ops import flash_attention as fa
    from gpt_2_distributed_torch.ops import fused_layer as fl
    from gpt_2_distributed_torch.ops import fused_matmul as fm
    from gpt_2_distributed_torch.ops.layers import dropout, site_key
    from gpt_2_distributed_torch.ops.spmd import batch_axes, shard_offset
    from gpt_2_distributed_torch.parallel.mesh import Mesh, MeshSpec, activate_mesh

    bf, eps = torch.bfloat16, 1e-5
    spec, rows = MeshSpec(data=2, fsdp=2), 4
    b, h, t, d = TRAIN_SHAPE
    c, f = h * d, 4 * h * d
    gen = torch.Generator(device="cuda").manual_seed(18)

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    n_global = spec.n_devices * rows
    q, k, v, do = (randn(n_global, h, t, d) for _ in range(4))
    x, o, dr, dy = (randn(n_global * t, c) for _ in range(4))
    hh, dout = randn(n_global * t, f), randn(n_global * t, f)
    scale, bias = 1 + randn(c, scale=0.1, dtype=torch.float32), randn(c, scale=0.1,
                                                                     dtype=torch.float32)
    bb = randn(f, scale=0.1)
    w_fc, w_pr = randn(c, f, scale=c ** -0.5), randn(f, c, scale=f ** -0.5)
    g = randn(n_global * t, f)
    site = site_key(42, 3, 1, 5, 2)
    masks, worst = [], {}

    def hold(name, rank, checks):
        ratio = max(q_ for _, q_ in checks)
        worst[name] = max(worst.get(name, 0.0), ratio)
        if ratio > 1.0:
            fail(f"{name} on rank {rank} of {spec.to_str()} disagrees with its plain "
                 f"version under the per-shard seed (max err/tol {ratio:.3f})")

    for r in range(spec.n_devices):
        mesh = Mesh(spec, r)
        with activate_mesh(mesh):
            b0 = shard_offset(mesh, batch_axes(mesh, rows), rows)
            seed = gpt2._site_seed(site, DROPOUT, rows)
        bl, tl = slice(b0, b0 + rows), slice(b0 * t, (b0 + rows) * t)
        qr, kr, vr, dor = (a[bl] for a in (q, k, v, do))
        o1, lse = fa.flash_attention_fwd(qr, kr, vr, DROPOUT, seed)
        o_ref, _ = fa.flash_attention_plain(qr.float(), kr.float(), vr.float(), DROPOUT, seed)
        (terms,) = fa.flash_error_terms(qr, kr, vr, DROPOUT, seed)
        hold("flash_attention_fwd", r, [held_flash(o1, o_ref, terms)])
        delta = (dor.float() * o1.float()).sum(-1)
        grads = fa.flash_attention_bwd(qr, kr, vr, dor, lse, delta, DROPOUT, seed)
        refs = fa.flash_attention_bwd_plain(qr.float(), kr.float(), vr.float(), dor.float(),
                                            lse, delta, DROPOUT, seed)
        terms = fa.flash_error_terms(qr, kr, vr, DROPOUT, seed, do=dor, delta=delta)[1:]
        hold("flash_attention_bwd", r, [held_flash(gr, rf, w)
                                        for gr, rf, w in zip(grads, refs, terms)])
        xr, or_, drr, dyr, hr, doutr, gr_ = (a[tl] for a in (x, o, dr, dy, hh, dout, g))
        rr, y, mean, rstd = fl.ln_residual_dropout_fwd(xr, or_, scale, bias, eps, DROPOUT, seed)
        ref = fl.ln_residual_dropout_plain(xr.float(), or_.float(), scale, bias, eps, DROPOUT,
                                           seed, dtype=bf)
        hold("ln_residual_dropout_fwd", r, [held(rr, ref[0]), held(y, ref[1])])
        lg = fl.ln_residual_dropout_bwd(rr, mean, rstd, scale, drr, dyr, DROPOUT, seed)
        lref = fl.ln_residual_dropout_bwd_plain(rr.float(), mean, rstd, scale, drr.float(),
                                                dyr.float(), DROPOUT, seed)
        rhat = (rr.float() - mean[:, None]) * rstd[:, None]
        hold("ln_residual_dropout_bwd", r, [
            held(lg[0], lref[0]), held(lg[1], lref[1]),
            held_colsum(lg[2], lref[2], (dyr.float() * rhat).abs().sum(0)),
            held_colsum(lg[3], lref[3], dyr.float().abs().sum(0))])
        hold("residual_dropout_fwd", r, [held(
            fl.residual_dropout_fwd(xr, or_, DROPOUT, seed),
            fl.residual_dropout_plain(xr.float(), or_.float(), DROPOUT, seed, dtype=bf))])
        hold("dropout_scale", r, [held(fl.dropout_scale(drr, DROPOUT, seed),
                                       fl.dropout_scale_plain(drr.float(), DROPOUT, seed,
                                                              dtype=bf))])
        hold("bias_gelu_dropout_fwd", r, [held(
            fl.bias_gelu_dropout_fwd(hr, bb, DROPOUT, seed),
            fl.bias_gelu_dropout_plain(hr.float(), bb.float(), DROPOUT, seed, dtype=bf))])
        dh, db = fl.bias_gelu_dropout_bwd(hr, bb, doutr, DROPOUT, seed)
        dh_p, db_p = fl.bias_gelu_dropout_bwd_plain(hr.float(), bb.float(), doutr.float(),
                                                    DROPOUT, seed, dtype=bf)
        hold("bias_gelu_dropout_bwd", r, [held(dh, dh_p),
                                          held_colsum(db, db_p, dh_p.abs().sum(0))])
        # K7: the fc leg (gelu) and the MLP out-projection (resid).
        xf, wf, bfl = xr.float(), w_fc.float(), bb.float()
        gain = EPI_GAIN / (1.0 - DROPOUT)
        y7, u7 = fm.mm_gelu_fwd(xr, w_fc, bb, DROPOUT, seed, fm.SALT_MM_GELU)
        y_ref, u_ref = fm.matmul_fwd_plain("gelu", xf, wf, bfl, None, DROPOUT, seed,
                                           fm.SALT_MM_GELU)
        terms_fwd = xf.abs() @ wf.abs() + bfl.abs()
        hold("mm_gelu_fwd", r, [held_mm(y7, y_ref, gain * terms_fwd),
                                held_mm(u7, u_ref, terms_fwd)])
        yr = fm.mm_resid_fwd(hr, w_pr, bias.to(bf), xr, DROPOUT, seed, fm.SALT_MM_MLP_PROJ)
        yr_ref = fm.matmul_fwd_plain("resid", hr.float(), w_pr.float(), bias.to(bf).float(),
                                     xr.float(), DROPOUT, seed, fm.SALT_MM_MLP_PROJ)
        hold("mm_resid_fwd", r, [held_mm(yr, yr_ref, gain * (
            hr.float().abs() @ w_pr.float().abs() + bias.abs()))])
        gf, uf = gr_.float(), u7.float()
        du = fm.du_plain(gf, uf, DROPOUT, seed, fm.SALT_MM_GELU, bf)
        du_k, db_k = fm.mm_du(gr_, u7, DROPOUT, seed, fm.SALT_MM_GELU)
        err = (du_k.float() - du).abs()
        hold("mm_du", r, [(err.max().item(), (err / (2.0 ** -7 * du.abs())).nan_to_num(
            0.0, float("inf")).max().item()), held_mm(db_k, du.sum(0), du.abs().sum(0))])
        dx = fm.mm_dgrad_gelu(du_k, w_fc)
        dx_ref = fm.matmul_dgrad_plain(gf, wf, uf, DROPOUT, seed, fm.SALT_MM_GELU, bf)
        hold("mm_dgrad_gelu", r, [held_mm(dx, dx_ref, du.abs() @ wf.abs().t())])
        dw = fm.mm_wgrad_gelu(xr, du_k)
        dw_ref, _ = fm.matmul_wgrad_plain(xf, gf, uf, DROPOUT, seed, fm.SALT_MM_GELU, bf)
        hold("mm_wgrad_gelu", r, [held_mm(dw, dw_ref, xf.abs().t() @ du.abs())])
        masks.append(fl.residual_dropout_fwd(torch.zeros_like(xr[:1024]),
                                             torch.ones_like(xr[:1024]), DROPOUT, seed) == 0)
    differ = all(not torch.equal(masks[i], masks[j])
                 for i in range(len(masks)) for j in range(i))
    # The unfused dropout (plain torch) hashes global coordinates: each
    # rank's block of the draw equals the global draw's rows.
    xg = x.view(n_global, t, c)
    whole = dropout(xg, DROPOUT, site, False)
    blocks_equal = True
    for r in range(spec.n_devices):
        mesh = Mesh(spec, r)
        b0 = shard_offset(mesh, batch_axes(mesh, rows), rows)
        blk = dropout(xg[b0:b0 + rows], DROPOUT, site, False, origin=(b0, 0, 0))
        blocks_equal = blocks_equal and torch.equal(blk, whole[b0:b0 + rows])
    print(f"per-rank kernels on {spec.to_str()} in one process ({rows} rows of {n_global} "
          f"each, [{rows}, {h}, {t}, {d}] attention, [{rows * t}, {c} / {f}] epilogues and "
          f"legs, dropout {DROPOUT}, the per-shard seed): max err/tol over the ranks "
          + ", ".join(f"{name} {q_:.3f}" for name, q_ in worst.items())
          + f"; the ranks' K5 masks all differ: {differ}; the unfused dropout's rank blocks "
          f"bit-equal to the global draw's rows: {blocks_equal}", flush=True)
    if not (differ and blocks_equal):
        fail("a rank's dropout stream is not its own, or the unfused dropout's rank blocks "
             "differ from the global draw")


def profile_train_step(fused_layers: str, fused_matmul: str) -> None:
    """A torch.profiler window over one optimizer step (4 micro-batches of
    [4, 1024]) of the 124M train step, after one warm-up step."""
    from gpt_2_distributed_torch.config import MODEL_PRESETS
    from gpt_2_distributed_torch.models import gpt2
    from gpt_2_distributed_torch.parallel import train_step as ts
    from gpt_2_distributed_torch.resilience import init_guard_state

    config = MODEL_PRESETS["124M"].replace(fused_layers=fused_layers,
                                           fused_matmul=fused_matmul)
    params = ts.trainable_params(gpt2.init_params(config, seed=0), torch.device("cuda"))
    step = ts.make_train_step(config, ts.make_optimizer(params, 1e-4), guard=True)
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randint(0, config.vocab_size, (4, 4, 1024), generator=gen, device="cuda")
    y = torch.randint(0, config.vocab_size, (4, 4, 1024), generator=gen, device="cuda")
    ones = torch.ones(4, device="cuda")
    guard = step(params, init_guard_state(), x, y, 42, 0, ones)[0]
    profile_window(f"training step 124M (4 x [4, 1024]), fused_layers {fused_layers}, "
                   f"fused_matmul {fused_matmul}",
                   lambda: (step(params, guard, x, y, 42, 1, ones), 1)[1])


def main() -> None:
    if sys.argv[1:2] == ["--serve_worker"]:
        serve_worker(sys.argv[2:])
        return
    if sys.argv[1:2] == ["--workers_frontend"]:
        workers_frontend(sys.argv[2], sys.argv[3])
        return
    if "--sp_worker" in sys.argv[1:]:
        sp_worker(sys.argv[sys.argv.index("--sp_worker") + 1], "--profile" in sys.argv)
        return
    if "--ddp_worker" in sys.argv[1:]:
        i = sys.argv.index("--ddp_worker")
        ddp_worker(sys.argv[i + 1], int(sys.argv[i + 2]), "--profile" in sys.argv)
        return
    if "--detector_worker" in sys.argv[1:]:
        detector_worker(sys.argv[sys.argv.index("--detector_worker") + 1])
        return
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
    reports = build.build(["flash_fwd", "flash_bwd", "paged_decode", "fused_layer",
                           "fused_matmul", "flash_block"])
    print(f"kernels built in {time.monotonic() - t0:.1f} s", flush=True)
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    profile = "--profile" in sys.argv[1:]
    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32, device="cuda")
    phase_flash(flush)
    k1_row, k2_row = phase_flash_train(flush, profile)
    k8_rows = phase_flash_block(flush)
    k8_ring = phase_ring()
    k3_row = phase_paged(flush)
    fused_rows = phase_fused(flush)
    phase_gelu_every_bf16()
    mm_rows = phase_matmul(flush)
    offset_row = phase_offset(flush)
    del flush
    prefix = phase_prefix_serving(profile)
    preempt = phase_preempt_serving()
    serving = phase_serving(profile)
    spec = phase_spec_serving(card)
    phase_model_paths()
    counts, ms_steps, train_losses = phase_training(profile)
    resume, digest_a = phase_resume(train_losses["fused_matmul all"])
    detectors = phase_detectors(train_losses["fused_matmul all"], digest_a, card)
    elastic = phase_elastic(card)
    front = phase_frontend(train_losses["off"])
    workers = phase_workers(card)
    k8_train = phase_sp_training(ms_steps["off"], profile)
    phase_ddp_ranks()
    phase_ddp_training(ms_steps, card, profile)
    k8 = k8_ring if k8_train is None else k8_train
    k1_serve, k3 = serving["flash_attention_fwd"], serving["paged_attention_kernel"]
    k1_train = sum(c["flash_attention_fwd"] for c in counts.values())
    k2 = sum(c["flash_attention_bwd"] for c in counts.values())
    print(f"launches on the main paths: K1 {k1_serve} serving + {k1_train} "
          f"training, K2 {k2} training, K3 {k3} serving; fused_layers all: "
          + ", ".join(f"{name} {counts['fused_layers all'][name]}"
                      for name, _ in FUSED_WRAPPERS)
          + "; fused_matmul all: "
          + ", ".join(f"{name} {counts['fused_matmul all'][name]}" for name, _ in MM_WRAPPERS)
          + "; serving: " + ", ".join(f"{name} {serving[name]}"
                                      for name, _ in MM_SERVE_WRAPPERS)
          + f"; K8 {k8['flash_block_fwd']} forward, {k8['flash_block_bwd']} backward "
          + ("(the one-card ring)" if k8_train is None else "(sp=2 training, rank 0)")
          + "; spec serving: " + ", ".join(f"{name} {n}" for name, n in spec.items())
          + "; prefix serving: " + ", ".join(f"{name} {n}" for name, n in prefix.items())
          + "; preempt serving: " + ", ".join(f"{name} {n}" for name, n in preempt.items())
          + "; front end: " + ", ".join(f"{name} {n}" for name, n in front.items())
          + "; resume (runs A, B, C and serve --ckpt): "
          + ", ".join(f"{name} {n}" for name, n in resume.items() if n)
          + "; detectors (the hang run, its resume, rank 0 of the data=2 runs): "
          + ", ".join(f"{name} {n}" for name, n in detectors.items() if n)
          + "; elastic (E0, E1 and, on two cards, the shrink's resume and rank 0 of S and "
          "the grow): " + ", ".join(f"{name} {n}" for name, n in elastic.items() if n)
          + "; worker processes (those that reported at their exit; a killed worker reports "
          "none): " + ", ".join(f"{name} {n}" for name, n in workers.items()),
          flush=True)

    kernels = [
        dict(name="flash_attention_fwd", route="cuda",
             source="gpt_2_distributed_torch/csrc/flash_fwd.cu",
             replaces="gpt_2_distributed_tpu/ops/flash_attention.py:175",
             launches=k1_serve + k1_train + front["flash_attention_fwd"]
             + resume["flash_attention_fwd"] + detectors["flash_attention_fwd"]
             + elastic["flash_attention_fwd"] + spec["flash_attention_fwd"]
             + workers["flash_attention_fwd"], **k1_row),
        dict(name="flash_attention_fwd_offset", route="cuda",
             source="gpt_2_distributed_torch/csrc/flash_fwd.cu",
             replaces="gpt_2_distributed_tpu/ops/flash_attention.py:175",
             launches=prefix["flash_attention_fwd_offset"]
             + preempt["flash_attention_fwd_offset"]
             + front["flash_attention_fwd_offset"] + spec["flash_attention_fwd_offset"]
             + workers["flash_attention_fwd_offset"], **offset_row),
        dict(name="flash_attention_bwd", route="cuda",
             source="gpt_2_distributed_torch/csrc/flash_bwd.cu",
             replaces="gpt_2_distributed_tpu/ops/flash_attention.py:254",
             launches=k2 + front["flash_attention_bwd"] + resume["flash_attention_bwd"]
             + detectors["flash_attention_bwd"] + elastic["flash_attention_bwd"], **k2_row),
        dict(name="paged_attention_kernel", route="cuda",
             source="gpt_2_distributed_torch/csrc/paged_decode.cu",
             replaces="gpt_2_distributed_tpu/ops/paged_attention.py:177",
             launches=k3 + preempt["paged_attention_kernel"] + front["paged_attention_kernel"]
             + resume["paged_attention_kernel"] + spec["paged_attention_kernel"]
             + workers["paged_attention_kernel"], **k3_row),
    ] + [
        dict(name=name, route="cuda", source="gpt_2_distributed_torch/csrc/fused_layer.cu",
             replaces=replaces, launches=counts["fused_layers all"][name] + front.get(name, 0)
             + resume.get(name, 0) + spec.get(name, 0) + detectors[name] + elastic[name]
             + workers.get(name, 0), **fused_rows[name])
        for name, replaces in FUSED_WRAPPERS
    ] + [
        dict(name=name, route="cuda", source="gpt_2_distributed_torch/csrc/fused_matmul.cu",
             replaces=replaces, launches=counts["fused_matmul all"][name] + resume[name]
             + detectors[name] + elastic[name], **mm_rows[name])
        for name, replaces in MM_WRAPPERS
    ] + [
        dict(name=name, route="cuda", source="gpt_2_distributed_torch/csrc/fused_matmul.cu",
             replaces=replaces, launches=serving[name] + front[name] + resume[name]
             + spec[name] + detectors[name] + elastic[name] + workers[name], **mm_rows[name])
        for name, replaces in MM_SERVE_WRAPPERS
    ] + [
        dict(name=name, route="cuda", source="gpt_2_distributed_torch/csrc/flash_block.cu",
             replaces=f"gpt_2_distributed_tpu/ops/flash_block.py:{line}",
             launches=k8[name], **row)
        for name, line, row in (("flash_block_fwd", 68, k8_rows[0]),
                                ("flash_block_bwd", 156, k8_rows[1]))
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
