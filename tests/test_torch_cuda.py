"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU (the kernels have no CPU build): it is
marked ``cuda`` and skips without one. The file imports neither JAX nor the
JAX package, so it also runs where JAX is absent; on a GPU machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.)
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gpt_2_distributed_torch.config import GPT2Config, ServeConfig
from gpt_2_distributed_torch.models import gpt2
from gpt_2_distributed_torch.models.decode import generate_cached
from gpt_2_distributed_torch.ops import flash_attention as flash
from gpt_2_distributed_torch.ops import paged_attention as paged
from gpt_2_distributed_torch.serving import ServingEngine

pytestmark = pytest.mark.cuda

# Each kernel is held against its plain version run on the same values in
# fp32, which keeps scores, probabilities and o in fp32. The kernel differs
# from that by its one rounding of o to bf16 (<= 2^-8 |o|) plus fp32
# summation-order noise, so element by element:
#   |o - ref| <= 2^-8 |ref| + 2^-16.


def _close(o: torch.Tensor, ref: torch.Tensor) -> bool:
    return bool(((o.float() - ref).abs() <= 2.0 ** -8 * ref.abs() + 2.0 ** -16).all())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    return torch.device("cuda")


def _bf16(rng, *shape, device):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device, torch.bfloat16)


@pytest.mark.parametrize("t", [16, 208, 1024])
def test_flash_kernel_matches_plain(cuda, t):
    rng = np.random.default_rng(t)
    q, k, v = (_bf16(rng, 1, 12, t, 64, device=cuda) for _ in range(3))
    before = flash.flash_attention_fwd.launches
    o, lse = flash.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert flash.flash_attention_fwd.launches == before + 1
    o_ref, lse_ref = flash.flash_attention_plain(q.float(), k.float(), v.float())
    assert _close(o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    # The [B, T, H, D] entry point reads and writes through strides.
    o_bthd = flash.flash_attention_bthd(q.transpose(1, 2), k.transpose(1, 2),
                                        v.transpose(1, 2))
    assert torch.equal(o_bthd.transpose(1, 2), o)


def _paged_case(rng, device, lengths=(0, 1, 17, 100, 64, 33), h=12, d=64,
                bs=16, m=8, n=64):
    b = len(lengths)
    q = _bf16(rng, b, h, d, device=device)
    kp, vp = _bf16(rng, n, h, bs, d, device=device), _bf16(rng, n, h, bs, d, device=device)
    table = np.zeros((b, m), np.int32)
    perm = rng.permutation(np.arange(1, n))
    used = 0
    for i, ln in enumerate(lengths):
        nb = -(-ln // bs)
        table[i, :nb] = perm[used:used + nb]
        used += nb
    return (q, kp, vp, torch.from_numpy(table).to(device),
            torch.tensor(lengths, dtype=torch.int32, device=device))


def test_paged_kernel_matches_plain_and_never_reads_past_lengths(cuda):
    rng = np.random.default_rng(0)
    q, kp, vp, table, lengths = _paged_case(rng, cuda)
    o = paged.paged_attention_kernel(q, kp, vp, table, lengths)
    torch.cuda.synchronize()
    o_ref = paged.paged_attention_plain(q.float(), kp.float(), vp.float(),
                                        table, lengths)
    assert torch.equal(o[0], torch.zeros_like(o[0]))      # idle slot
    assert _close(o, o_ref)
    # One table entry swapped (sequence 3's second block for sequence 5's
    # first): the check must reject it.
    bad = table.clone()
    bad[3, 1] = table[5, 0]
    assert not _close(paged.paged_attention_kernel(q, kp, vp, bad, lengths), o_ref)
    # NaN in every position past a sequence's length, null block included:
    # the kernel never reads it.
    kn, vn = kp.clone(), vp.clone()
    bs = kp.shape[2]
    for i, ln in enumerate(lengths.tolist()):
        for j, blk in enumerate(table[i].tolist()):
            lo = max(0, ln - j * bs)
            if lo < bs:
                kn[blk, :, lo:] = float("nan")
                vn[blk, :, lo:] = float("nan")
    assert torch.equal(paged.paged_attention_kernel(q, kn, vn, table, lengths), o)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    rng = np.random.default_rng(1)
    q, kp, vp, table, lengths = _paged_case(rng, cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        paged.paged_attention_kernel(q.float(), kp, vp, table, lengths)
    with pytest.raises(ValueError, match="contiguous"):
        paged.paged_attention_kernel(
            q, kp.transpose(0, 1).contiguous().transpose(0, 1), vp, table, lengths)
    with pytest.raises(TypeError, match="int32"):
        paged.paged_attention_kernel(q, kp, vp, table.long(), lengths)
    x = _bf16(rng, 1, 2, 32, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash.flash_attention_fwd(x, x, x)


def test_engine_runs_its_main_path_through_both_kernels(cuda):
    cfg = GPT2Config(vocab_size=257, n_positions=128, n_embd=128, n_layer=2,
                     n_head=2)
    params = gpt2.init_params(cfg, seed=0)
    eng = ServingEngine(params, cfg, ServeConfig(max_batch=4, block_size=16,
                                                 num_blocks=64),
                        temperature=0.0)
    k1, k3 = flash.flash_attention_fwd.launches, paged.paged_attention_kernel.launches
    prompts = [[1, 2, 3], list(range(5, 45)), [42], list(range(100, 117))]
    handles = [eng.submit(p, 9, seed=i) for i, p in enumerate(prompts)]
    eng.run_until_idle(max_steps=100)
    assert all(len(h.generated) == 9 for h in handles)
    assert flash.flash_attention_fwd.launches - k1 == cfg.n_layer * eng.stats["prefills"]
    assert (paged.paged_attention_kernel.launches - k3
            == cfg.n_layer * eng.stats["decode_steps"])
    # The one-shot sampler defaults to the card and prefills through K1.
    k1 = flash.flash_attention_fwd.launches
    ids = generate_cached(params, cfg, [prompts[1]], max_new_tokens=4)
    assert ids.shape == (1, len(prompts[1]) + 4)
    assert flash.flash_attention_fwd.launches - k1 == cfg.n_layer
