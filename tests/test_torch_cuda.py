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
from gpt_2_distributed_torch.ops import fused_layer as fl
from gpt_2_distributed_torch.ops import fused_matmul as fm
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


# K1 and K2 round the left operand of some products to bf16, as the TPU
# kernels do (the dropped probabilities before P v, ds and pd before their
# products), where the plain versions keep fp32. One bf16 rounding moves a
# product term by at most 2^-8 of itself, so each element may also move by
# 2^-8 times the sum of its product's absolute terms
# (``flash_error_terms``; the bound is ``flash_tolerance``):
#   |x - ref| <= 2^-8 |ref| + 2^-16 + 2^-8 terms.


def _flash_close(x: torch.Tensor, ref: torch.Tensor, terms: torch.Tensor) -> bool:
    return bool(((x.float() - ref).abs() <= flash.flash_tolerance(ref, terms)).all())


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
    assert _flash_close(o, o_ref, flash.flash_error_terms(q, k, v)[0])
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    # The [B, T, H, D] entry point reads and writes through strides.
    o_bthd = flash.flash_attention_bthd(q.transpose(1, 2), k.transpose(1, 2),
                                        v.transpose(1, 2))
    assert torch.equal(o_bthd.transpose(1, 2), o)


@pytest.mark.parametrize("t", [208, 1024])
def test_flash_kernel_dropout_matches_plain(cuda, t):
    rng = np.random.default_rng(t + 1)
    q, k, v = (_bf16(rng, 2, 12, t, 64, device=cuda) for _ in range(3))
    seed = 0x7EADBEEF
    o, lse = flash.flash_attention_fwd(q, k, v, 0.1, seed)
    torch.cuda.synchronize()
    o_ref, lse_ref = flash.flash_attention_plain(q.float(), k.float(), v.float(), 0.1, seed)
    (terms,) = flash.flash_error_terms(q, k, v, 0.1, seed)
    assert _flash_close(o, o_ref, terms)
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    # Another seed draws another mask: the check must see it.
    assert not _flash_close(flash.flash_attention_fwd(q, k, v, 0.1, seed + 1)[0], o_ref, terms)


def test_flash_kernel_dropout_relaunch_is_bit_identical(cuda):
    rng = np.random.default_rng(9)
    q, k, v = (_bf16(rng, 2, 12, 333, 64, device=cuda) for _ in range(3))
    o, lse = flash.flash_attention_fwd(q, k, v, 0.1, 0x7EADBEEF)
    o2, lse2 = flash.flash_attention_fwd(q, k, v, 0.1, 0x7EADBEEF)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("t", [1, 17, 100, 208, 777])
def test_flash_kernel_rows_do_not_depend_on_t(cuda, t):
    # The serving engine prefills a prompt padded to its block bucket: a
    # row's output and lse must be the same bits at T = t and at T = t
    # rounded up to 16 and to 64, given the same leading rows.
    rng = np.random.default_rng(t)
    width = -(-t // 64) * 64 + 64
    q, k, v = (_bf16(rng, 1, 12, width, 64, device=cuda) for _ in range(3))
    o, lse = flash.flash_attention_fwd(q[:, :, :t], k[:, :, :t], v[:, :, :t])
    for padded in (-(-t // 16) * 16, -(-t // 64) * 64, width):
        o_p, lse_p = flash.flash_attention_fwd(q[:, :, :padded], k[:, :, :padded],
                                               v[:, :, :padded])
        torch.cuda.synchronize()
        assert torch.equal(o_p[:, :, :t], o) and torch.equal(lse_p[:, :, :t], lse), padded


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_bwd_kernel_matches_plain_and_is_deterministic(cuda, rate):
    rng = np.random.default_rng(5)
    q, k, v, do = (_bf16(rng, 2, 12, 333, 64, device=cuda) for _ in range(4))
    seed = 123457
    o, lse = flash.flash_attention_fwd(q, k, v, rate, seed)
    delta = (do.float() * o.float()).sum(-1)
    before = flash.flash_attention_bwd.launches
    grads = flash.flash_attention_bwd(q, k, v, do, lse, delta, rate, seed)
    again = flash.flash_attention_bwd(q, k, v, do, lse, delta, rate, seed)
    torch.cuda.synchronize()
    assert flash.flash_attention_bwd.launches == before + 2
    assert all(torch.equal(g, a) for g, a in zip(grads, again))   # no atomics
    refs = flash.flash_attention_bwd_plain(q.float(), k.float(), v.float(), do.float(),
                                           lse, delta, rate, seed)
    terms = flash.flash_error_terms(q, k, v, rate, seed, do=do, delta=delta)[1:]
    for g, r, w in zip(grads, refs, terms):
        assert _flash_close(g, r, w)


def test_flash_kernels_take_rows_off_16_byte_boundaries(cuda):
    # Views one element into a wider buffer: no row starts on a 16-byte
    # boundary, so the wrappers hand K1 and K2 aligned copies; an o whose
    # rows are off those boundaries is refused.
    rng = np.random.default_rng(6)
    wide = [_bf16(rng, 2, 12, 100, 72, device=cuda) for _ in range(4)]
    q, k, v, do = (x[..., 1:65] for x in wide)
    with pytest.raises(ValueError, match="16-byte"):
        flash.flash_attention_fwd(q, k, v, o=torch.empty_like(wide[0])[..., 1:65])
    o, lse = flash.flash_attention_fwd(q, k, v, 0.1, 77)
    o_ref, lse_ref = flash.flash_attention_plain(q.float(), k.float(), v.float(), 0.1, 77)
    assert _flash_close(o, o_ref, flash.flash_error_terms(q, k, v, 0.1, 77)[0])
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    delta = (do.float() * o.float()).sum(-1)
    grads = flash.flash_attention_bwd(q, k, v, do, lse, delta, 0.1, 77)
    torch.cuda.synchronize()
    refs = flash.flash_attention_bwd_plain(q.float(), k.float(), v.float(), do.float(),
                                           lse, delta, 0.1, 77)
    terms = flash.flash_error_terms(q, k, v, 0.1, 77, do=do, delta=delta)[1:]
    for g, r, w in zip(grads, refs, terms):
        assert _flash_close(g, r, w)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d", [32, 128])
def test_flash_kernels_at_the_other_head_dims(cuda, d, rate):
    # Every preset has D = 64; K1 and K2 also take D = 32 and 128, each its
    # own instance of the kernels (other fragment counts and shared sizes).
    rng = np.random.default_rng(d)
    q, k, v, do = (_bf16(rng, 2, 4, 208, d, device=cuda) for _ in range(4))
    seed = 0x7EADBEEF
    o, lse = flash.flash_attention_fwd(q, k, v, rate, seed)
    o2, lse2 = flash.flash_attention_fwd(q, k, v, rate, seed)
    delta = (do.float() * o.float()).sum(-1)
    grads = flash.flash_attention_bwd(q, k, v, do, lse, delta, rate, seed)
    again = flash.flash_attention_bwd(q, k, v, do, lse, delta, rate, seed)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert all(torch.equal(g, a) for g, a in zip(grads, again))
    o_ref, lse_ref = flash.flash_attention_plain(q.float(), k.float(), v.float(), rate, seed)
    terms = flash.flash_error_terms(q, k, v, rate, seed, do=do, delta=delta)
    assert _flash_close(o, o_ref, terms[0])
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    refs = flash.flash_attention_bwd_plain(q.float(), k.float(), v.float(), do.float(),
                                           lse, delta, rate, seed)
    for g, r, w in zip(grads, refs, terms[1:]):
        assert _flash_close(g, r, w)


def test_model_trains_through_k1_and_k2(cuda):
    from gpt_2_distributed_torch.parallel import train_step as ts
    from gpt_2_distributed_torch.resilience import init_guard_state

    cfg = GPT2Config(vocab_size=257, n_positions=128, n_embd=128, n_layer=2, n_head=2)
    params = ts.trainable_params(gpt2.init_params(cfg, seed=0), cuda)
    step = ts.make_train_step(cfg, ts.make_optimizer(params, 1e-3), guard=True)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 257, (2, 2, 100))).to(cuda)
    y = torch.from_numpy(rng.integers(0, 257, (2, 2, 100))).to(cuda)
    k1, k2 = flash.flash_attention_fwd.launches, flash.flash_attention_bwd.launches
    guard, m = step(params, init_guard_state(), x, y, 0, 0, torch.ones(2, device=cuda))
    assert m.skip_reason == 0 and np.isfinite(m.loss.item())
    # Two layers, two micro-batches: K1 and K2 once per layer and micro-batch.
    assert flash.flash_attention_fwd.launches - k1 == 4
    assert flash.flash_attention_bwd.launches - k2 == 4


# The fused epilogues (K4-K6) against their plain versions run in fp32 on
# the same bf16 values with the kernels' inner bf16 roundings
# (``dtype=torch.bfloat16``): every element output is held as above. The
# column sums (dscale, dbias, db) add the same fp32 terms in other orders:
# each side is within N 2^-24 sum|t| of the exact sum (the recursive-
# summation bound), so |d - ref| <= rel |ref| + 2^-11 sum|t| for N <= 4096,
# rel being db's bf16 rounding (2^-8) and 0 for the fp32 dscale and dbias.
# The LayerNorm statistics are fp32 on both sides: 1e-4.


def _colsum_close(d, ref, terms) -> bool:
    rel = 2.0 ** -8 if d.dtype == torch.bfloat16 else 0.0
    return bool(((d.float() - ref).abs() <= rel * ref.abs() + 2.0 ** -11 * terms).all())


@pytest.mark.parametrize("n, c", [(333, 200), (77, 100)])   # 16-byte rows; element loads
def test_fused_layer_kernels_match_plain(cuda, n, c):
    rng = np.random.default_rng(n)
    f = 4 * c
    x, o, dr, dy = (_bf16(rng, n, c, device=cuda) for _ in range(4))
    scale = torch.from_numpy(1 + 0.1 * rng.normal(size=c).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(0.1 * rng.normal(size=c).astype(np.float32)).to(cuda)
    h, dout = _bf16(rng, n, f, device=cuda), _bf16(rng, n, f, device=cuda)
    b = _bf16(rng, f, device=cuda) * 0.1
    seed, bf = 0x9E3779B9, torch.bfloat16
    for rate in (0.0, 0.1):
        r, y, mean, rstd = fl.ln_residual_dropout_fwd(x, o, scale, bias, 1e-5, rate, seed)
        r_p, y_p, mean_p, rstd_p = fl.ln_residual_dropout_plain(
            x.float(), o.float(), scale, bias, 1e-5, rate, seed, dtype=bf)
        assert torch.equal(r.float(), r_p) and _close(y, y_p)
        assert max((mean - mean_p).abs().max().item(), (rstd - rstd_p).abs().max().item()) <= 1e-4
        grads = fl.ln_residual_dropout_bwd(r, mean, rstd, scale, dr, dy, rate, seed)
        again = fl.ln_residual_dropout_bwd(r, mean, rstd, scale, dr, dy, rate, seed)
        refs = fl.ln_residual_dropout_bwd_plain(r.float(), mean, rstd, scale, dr.float(),
                                                dy.float(), rate, seed)
        rhat = (r.float() - mean[:, None]) * rstd[:, None]
        assert all(torch.equal(g, a) for g, a in zip(grads, again))   # no atomics
        assert _close(grads[0], refs[0]) and _close(grads[1], refs[1])
        assert _colsum_close(grads[2], refs[2], (dy.float() * rhat).abs().sum(0))
        assert _colsum_close(grads[3], refs[3], dy.float().abs().sum(0))

        out = fl.bias_gelu_dropout_fwd(h, b, rate, seed)
        assert _close(out, fl.bias_gelu_dropout_plain(h.float(), b.float(), rate, seed, dtype=bf))
        dh, db = fl.bias_gelu_dropout_bwd(h, b, dout, rate, seed)
        dh2, db2 = fl.bias_gelu_dropout_bwd(h, b, dout, rate, seed)
        dh_p, db_p = fl.bias_gelu_dropout_bwd_plain(h.float(), b.float(), dout.float(), rate,
                                                    seed, dtype=bf)
        assert torch.equal(dh, dh2) and torch.equal(db, db2)
        assert _close(dh, dh_p) and _colsum_close(db, db_p, dh_p.abs().sum(0))
    # K5 (built for rate > 0 only, as in the JAX package).
    r = fl.residual_dropout_fwd(x, o, 0.1, seed)
    assert _close(r, fl.residual_dropout_plain(x.float(), o.float(), 0.1, seed, dtype=bf))
    do = fl.dropout_scale(dr, 0.1, seed)
    assert _close(do, fl.dropout_scale_plain(dr.float(), 0.1, seed, dtype=bf))
    # Another seed draws another mask: each check must see it.
    assert not torch.equal(fl.ln_residual_dropout_fwd(x, o, scale, bias, 1e-5, 0.1, seed + 1)[0]
                           .float(), r_p)
    assert not _close(fl.residual_dropout_fwd(x, o, 0.1, seed + 1),
                      fl.residual_dropout_plain(x.float(), o.float(), 0.1, seed, dtype=bf))
    assert not _close(fl.dropout_scale(dr, 0.1, seed + 1),
                      fl.dropout_scale_plain(dr.float(), 0.1, seed, dtype=bf))
    assert not _close(fl.bias_gelu_dropout_fwd(h, b, 0.1, seed + 1),
                      fl.bias_gelu_dropout_plain(h.float(), b.float(), 0.1, seed, dtype=bf))


def test_model_trains_through_the_fused_kernels(cuda):
    from gpt_2_distributed_torch.parallel import train_step as ts
    from gpt_2_distributed_torch.resilience import init_guard_state

    cfg = GPT2Config(vocab_size=257, n_positions=128, n_embd=128, n_layer=2, n_head=2,
                     fused_layers="all")
    params = ts.trainable_params(gpt2.init_params(cfg, seed=0), cuda)
    step = ts.make_train_step(cfg, ts.make_optimizer(params, 1e-3), guard=True)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 257, (2, 2, 100))).to(cuda)
    y = torch.from_numpy(rng.integers(0, 257, (2, 2, 100))).to(cuda)
    wrappers = (fl.ln_residual_dropout_fwd, fl.ln_residual_dropout_bwd, fl.residual_dropout_fwd,
                fl.dropout_scale, fl.bias_gelu_dropout_fwd, fl.bias_gelu_dropout_bwd)
    before = [w.launches for w in wrappers]
    guard, m = step(params, init_guard_state(), x, y, 0, 0, torch.ones(2, device=cuda))
    assert m.skip_reason == 0 and np.isfinite(m.loss.item())
    # Two layers, two micro-batches: each kernel once per layer and micro-batch.
    assert [w.launches - n for w, n in zip(wrappers, before)] == [4] * 6


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


def _mm_close(got, ref, terms, extra=0.0):
    """K7 against its plain version in fp32: one rounding of the output
    (2^-8) plus the two fp32 sums' orders (2^-10 of the sum of |terms| for
    depths up to 8192, times 1.25 / 0.9 for the GELU's slope and the
    dropout scale)."""
    rel = 2.0 ** -8 if got.dtype == torch.bfloat16 else 0.0
    tol = rel * ref.abs() + 2.0 ** -16 + 2.0 ** -10 * 1.4 * terms + extra
    return bool(((got.float() - ref).abs() <= tol).all())


def _du_close(du, ref, gelu):
    """The du pass against ``du_plain`` (both rounded to bf16): equal, and
    with the GELU within one bf16 ulp (<= 2^-7 |ref|), where the card's
    tanhf and torch's tanh differ in the last fp32 bit across a rounding
    boundary."""
    if not gelu:
        return torch.equal(du.float(), ref)
    return bool(((du.float() - ref).abs() <= 2.0 ** -7 * ref.abs()).all())


# 16-byte rows, rows padded for TMA (77, 100, 90), the 124M legs (fc, MLP
# proj, qkv, attention proj) and the ragged 1.5B legs; one row in
# test_training_epilogues_are_row_invariant.
@pytest.mark.parametrize("n, k, m", [(333, 200, 264), (77, 100, 90), (4096, 768, 3072),
                                     (4096, 3072, 768), (4096, 768, 2304), (4096, 768, 768),
                                     (1000, 1600, 6400), (1000, 6400, 1600)])
def test_fused_matmul_kernels_match_plain(cuda, n, k, m):
    rng = np.random.default_rng(n)
    x, r, g = _bf16(rng, n, k, device=cuda), _bf16(rng, n, m, device=cuda), _bf16(
        rng, n, m, device=cuda)
    w = _bf16(rng, k, m, device=cuda) * k ** -0.5
    b = _bf16(rng, m, device=cuda) * 0.1
    seed, bf = 0x9E3779B9, torch.bfloat16
    xf, wf, bfl, rf, gf = (t.float() for t in (x, w, b, r, g))
    terms = xf.abs() @ wf.abs() + bfl.abs()
    y, y2 = fm.mm_bias_fwd(x, w, b), fm.mm_bias_fwd(x, w, b)
    assert torch.equal(y, y2)
    assert _mm_close(y, fm.matmul_fwd_plain("bias", xf, wf, bfl), terms)
    for rate in (0.0, 0.1):
        (y, u), (y2, u2) = (fm.mm_gelu_fwd(x, w, b, rate, seed) for _ in range(2))
        assert torch.equal(y, y2) and torch.equal(u, u2)
        y_p, u_p = fm.matmul_fwd_plain("gelu", xf, wf, bfl, None, rate, seed, fm.SALT_MM_GELU)
        assert _mm_close(y, y_p, terms) and _mm_close(u, u_p, terms)
        y, y2 = (fm.mm_resid_fwd(x, w, b, r, rate, seed) for _ in range(2))
        assert torch.equal(y, y2)
        assert _mm_close(y, fm.matmul_fwd_plain("resid", xf, wf, bfl, rf, rate, seed,
                                                fm.SALT_MM_ATTN_PROJ), terms)
        for uu in (None, u):
            du = fm.du_plain(gf, None if uu is None else uu.float(), rate, seed, 4, bf)
            (du_k, db_k), (du_k2, db_k2) = (fm.mm_du(g, uu, rate, seed, 4) for _ in range(2))
            assert _du_close(du_k, du, uu is not None)
            assert torch.equal(du_k, du_k2) and torch.equal(db_k, db_k2)
            assert _mm_close(db_k, du.sum(0), du.abs().sum(0))
            if rate > 0.0:
                assert not _du_close(fm.mm_du(g, uu, rate, seed + 1, 4)[0], du, uu is not None)
            dgrad, wgrad = ((fm.mm_dgrad, fm.mm_wgrad) if uu is None else
                            (fm.mm_dgrad_gelu, fm.mm_wgrad_gelu))
            dx, dx2 = dgrad(du_k, w), dgrad(du_k, w)
            dw, dw2 = wgrad(x, du_k), wgrad(x, du_k)
            assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
            # The products on the du pass's du, and the leg against du_plain.
            duk = du_k.float()
            assert _mm_close(dx, duk @ wf.t(), duk.abs() @ wf.abs().t())
            assert _mm_close(dw, xf.t() @ duk, xf.abs().t() @ duk.abs())
            assert _mm_close(dx, du @ wf.t(), du.abs() @ wf.abs().t())
            assert _mm_close(dw, xf.t() @ du, xf.abs().t() @ du.abs())
    # Another seed draws another mask; a zeroed contraction tile is seen.
    assert not _mm_close(fm.mm_resid_fwd(x, w, b, r, 0.1, seed + 1),
                         fm.matmul_fwd_plain("resid", xf, wf, bfl, rf, 0.1, seed,
                                             fm.SALT_MM_ATTN_PROJ), terms)
    x_bad = x.clone()
    x_bad[:, 64:128] = 0
    assert not _mm_close(fm.mm_bias_fwd(x_bad, w, b), fm.matmul_fwd_plain("bias", xf, wf, bfl),
                         terms)
    du = fm.du_plain(gf, None, 0.1, seed, 4, bf)
    g_bad, xr_bad = g.clone(), x.clone()
    g_bad[:, 64:128] = 0
    xr_bad[64:128] = 0
    du_bad = fm.mm_du(g_bad, None, 0.1, seed, 4)[0]
    assert not _mm_close(fm.mm_dgrad(du_bad, w), du @ wf.t(), du.abs() @ wf.abs().t())
    du_k = fm.mm_du(g, None, 0.1, seed, 4)[0]
    assert not _mm_close(fm.mm_wgrad(xr_bad, du_k), xf.t() @ du, xf.abs().t() @ du.abs())


def test_training_epilogues_are_row_invariant(cuda):
    """A row of the training forward (bias, gelu with u, resid) computed
    alone (N = 1, held to its plain version) equals that row inside 4096
    rows (no dropout: the mask hashes the row's index in the launch), and
    the first 8 rows with dropout 0.1 equal the same rows inside 4096."""
    rng = np.random.default_rng(4)
    x, r = _bf16(rng, 4096, 768, device=cuda), _bf16(rng, 4096, 3072, device=cuda)
    w = _bf16(rng, 768, 3072, device=cuda) * 768 ** -0.5
    b = _bf16(rng, 3072, device=cuda) * 0.1
    wf, bfl = w.float(), b.float()
    salts = {"gelu": fm.SALT_MM_GELU, "resid": fm.SALT_MM_ATTN_PROJ}
    for rate, rows in ((0.0, [(i, i + 1) for i in (0, 5, 130, 4095)]), (0.1, [(0, 8)])):
        for kind, fn in (("bias", lambda t, rt: (fm.mm_bias_fwd(t, w, b),)),
                         ("gelu", lambda t, rt: fm.mm_gelu_fwd(t, w, b, rate, 11)),
                         ("resid", lambda t, rt: (fm.mm_resid_fwd(t, w, b, rt, rate, 11),))):
            full = fn(x, r)
            for i, j in rows:
                part = fn(x[i:j], r[i:j])
                assert all(torch.equal(p, f[i:j]) for p, f in zip(part, full)), (kind, i, rate)
                xf = x[i:j].float()
                ref = fm.matmul_fwd_plain(kind, xf, wf, bfl, r[i:j].float(), rate, 11,
                                          salts.get(kind, 0))
                ref = ref if isinstance(ref, tuple) else (ref,)
                terms = xf.abs() @ wf.abs() + bfl.abs()
                assert all(_mm_close(p, q, terms) for p, q in zip(part, ref)), (kind, i, rate)


def test_inference_products_are_row_invariant(cuda):
    """A row's bits from the inference products (unfused linear, bias
    forward, tied head) and K4's LayerNorm alone, in a batch of 8 and
    inside 960 rows, where it sits at another place of its tile."""
    rng = np.random.default_rng(3)
    h = _bf16(rng, 960, 256, device=cuda)
    w = _bf16(rng, 256, 640, device=cuda) * 0.0625
    b = _bf16(rng, 640, device=cuda) * 0.1
    wte = _bf16(rng, 1001, 256, device=cuda) * 0.02
    scale = torch.ones(256, device=cuda)
    for fn in (lambda t: fm.linear(t, w, b), lambda t: fm.mm_bias_fwd(t, w, b),
               lambda t: fm.head_logits(t, wte),
               lambda t: gpt2.norm(t, scale, scale - 1, 1e-5, True)):
        full = fn(h)
        assert torch.equal(fn(h[:8]), full[:8])
        for i in (0, 5, 130, 959):
            assert torch.equal(fn(h[i:i + 1])[0], full[i])


def test_model_trains_through_k7(cuda):
    from gpt_2_distributed_torch.parallel import train_step as ts
    from gpt_2_distributed_torch.resilience import init_guard_state

    cfg = GPT2Config(vocab_size=257, n_positions=128, n_embd=128, n_layer=2, n_head=2,
                     fused_matmul="all", fused_layers="all")
    params = ts.trainable_params(gpt2.init_params(cfg, seed=0), cuda)
    step = ts.make_train_step(cfg, ts.make_optimizer(params, 1e-3), guard=True)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 257, (2, 2, 100))).to(cuda)
    y = torch.from_numpy(rng.integers(0, 257, (2, 2, 100))).to(cuda)
    k7 = (fm.mm_bias_fwd, fm.mm_gelu_fwd, fm.mm_resid_fwd, fm.mm_dgrad, fm.mm_dgrad_gelu,
          fm.mm_wgrad, fm.mm_wgrad_gelu, fm.mm_du)
    k4_k6 = (fl.ln_residual_dropout_fwd, fl.residual_dropout_fwd, fl.bias_gelu_dropout_fwd)
    before = [w.launches for w in k7 + k4_k6]
    guard, m = step(params, init_guard_state(), x, y, 0, 0, torch.ones(2, device=cuda))
    assert m.skip_reason == 0 and np.isfinite(m.loss.item())
    # Two layers, two micro-batches: K7 takes every leg (one du pass a leg
    # backward), K4-K6 none.
    assert [w.launches - n for w, n in zip(k7 + k4_k6, before)] == [4, 4, 8, 12, 4, 12, 4, 16,
                                                                      0, 0, 0]


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_engine_streams_equal_generate_cached_on_the_card(cuda, temperature):
    cfg = GPT2Config(vocab_size=1000, n_positions=256, n_embd=128, n_layer=2, n_head=2)
    params = gpt2.init_params(cfg, seed=0)
    serve = ServeConfig(max_batch=4, block_size=16, num_blocks=64)
    eng = ServingEngine(params, cfg, serve, temperature=temperature)
    prompts = [[1, 2, 3], list(range(5, 45)), [42], list(range(100, 217))]
    handles = [eng.submit(p, 20, seed=7 + i) for i, p in enumerate(prompts)]
    eng.run_until_idle(max_steps=200)
    for i, (h, p) in enumerate(zip(handles, prompts)):
        ids = generate_cached(params, cfg, [p], seed=7 + i, max_new_tokens=20,
                              temperature=temperature, block_size=serve.block_size)
        assert ids[0, len(p):].tolist() == h.generated, i


@pytest.mark.parametrize("tq, tc, row_off, col_off", [
    (128, 128, 128, 0), (128, 128, 128, 128), (128, 128, 0, 128), (208, 160, 0, 48)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
# D = 64 (every preset), the other head dims the kernels take (each its own
# instance: other fragment counts and shared sizes), and rows off 16-byte
# boundaries (views one element into wider buffers, which the wrapper
# copies for the backward).
@pytest.mark.parametrize("d, offset_rows", [(64, False), (32, False), (128, False), (64, True)])
def test_flash_block_kernel_matches_plain(cuda, tq, tc, row_off, col_off, rate, d, offset_rows):
    """K8 forward and backward (nonzero do and dlse) against their plain
    versions in fp32 on the same bf16 values, both within the term-scaled
    bound; a fully masked row exactly o = 0 and lse = NEG_INF; two backward
    launches bit-identical."""
    from gpt_2_distributed_torch.ops import flash_block as fb

    rng = np.random.default_rng(tq + tc + row_off + col_off + d)

    def operand(t):
        if offset_rows:
            return _bf16(rng, 2, 4, t, d + 8, device=cuda)[..., 1:d + 1]
        return _bf16(rng, 2, 4, t, d, device=cuda)

    q, do = operand(tq), operand(tq)
    k, v = operand(tc), operand(tc)
    dlse = _bf16(rng, 2, 4, tq, device=cuda).float()
    kw = dict(seed=1234, b_off=1, h_off=2, dropout_rate=rate)
    before = (fb.flash_block_fwd.launches, fb.flash_block_bwd.launches)
    o, lse = fb.flash_block_fwd(q, k, v, row_off, col_off, **kw)
    delta = ((do.float() * o.float()).sum(-1) - dlse * 1.4426950408889634).contiguous()
    grads = fb.flash_block_bwd(q, k, v, do, lse, delta, row_off, col_off, **kw)
    again = fb.flash_block_bwd(q, k, v, do, lse, delta, row_off, col_off, **kw)
    torch.cuda.synchronize()
    assert (fb.flash_block_fwd.launches, fb.flash_block_bwd.launches) == (before[0] + 1,
                                                                          before[1] + 2)
    o_ref, lse_ref = fb.flash_block_plain(q, k, v, row_off, col_off, **kw)
    o_terms, *terms = fb.flash_block_error_terms(q, k, v, row_off, col_off, do=do, lse=lse,
                                                 delta=delta, **kw)
    assert _flash_close(o, o_ref, o_terms)
    dead = lse_ref == fb.NEG_INF
    assert torch.equal(lse == fb.NEG_INF, dead)
    assert torch.count_nonzero(o[dead]) == 0
    assert torch.allclose(lse[~dead], lse_ref[~dead], atol=1e-4, rtol=0)
    refs = fb.flash_block_bwd_plain(q, k, v, do, lse, delta, row_off, col_off, **kw)
    assert all(_flash_close(g, r, w) for g, r, w in zip(grads, refs, terms))
    assert all(torch.equal(g, a) for g, a in zip(grads, again))
    if row_off < col_off and tq == tc:
        assert dead.all() and all(torch.count_nonzero(g) == 0 for g in grads)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_block_fwd_relaunches_bit_identical_on_the_ring_views(cuda, rate, monkeypatch):
    """K8's forward on the views the ring hands it (``transpose(1, 2)`` of
    a [B, T/sp, H, D] block, rows on 128-byte boundaries): no copy is made,
    and two launches give the same bits."""
    from gpt_2_distributed_torch.ops import flash_block as fb

    rng = np.random.default_rng(9)
    q, k, v = (_bf16(rng, 2, 1024, 12, 64, device=cuda)[:, 512:].transpose(1, 2)
               for _ in range(3))
    copies = []

    def aligned(x):
        y = flash._aligned_input(x)
        copies.append(y is not x)
        return y

    monkeypatch.setattr(fb, "_aligned_input", aligned)
    kw = dict(seed=77, b_off=0, h_off=0, dropout_rate=rate)
    first = fb.flash_block_fwd(q, k, v, 512, 0, **kw)
    second = fb.flash_block_fwd(q, k, v, 512, 0, **kw)
    torch.cuda.synchronize()
    assert copies == [False] * 6
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("n, c", [(4096, 768), (1000, 1600)])   # 124M at 4 x 1024; 1.5B
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ln_residual_dropout_bwd_at_the_main_shapes(cuda, n, c, rate):
    """K4's backward at the training path's shape and the ragged 1.5B
    width: dx and do element by element, dscale and dbias within the
    column-sum bound, two launches bit-identical, and the next seed's mask
    rejected."""
    rng = np.random.default_rng(n + c)
    x, o, dr, dy = (_bf16(rng, n, c, device=cuda) for _ in range(4))
    scale = torch.from_numpy(1 + 0.1 * rng.normal(size=c).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(0.1 * rng.normal(size=c).astype(np.float32)).to(cuda)
    seed = 0x5EED4321
    r, _, mean, rstd = fl.ln_residual_dropout_fwd(x, o, scale, bias, 1e-5, rate, seed)
    grads = fl.ln_residual_dropout_bwd(r, mean, rstd, scale, dr, dy, rate, seed)
    again = fl.ln_residual_dropout_bwd(r, mean, rstd, scale, dr, dy, rate, seed)
    refs = fl.ln_residual_dropout_bwd_plain(r.float(), mean, rstd, scale, dr.float(),
                                            dy.float(), rate, seed)
    rhat = (r.float() - mean[:, None]) * rstd[:, None]
    assert all(torch.equal(g, a) for g, a in zip(grads, again))   # no atomics
    assert _close(grads[0], refs[0]) and _close(grads[1], refs[1])
    assert _colsum_close(grads[2], refs[2], (dy.float() * rhat).abs().sum(0))
    assert _colsum_close(grads[3], refs[3], dy.float().abs().sum(0))
    if rate:
        bad = fl.ln_residual_dropout_bwd(r, mean, rstd, scale, dr, dy, rate, seed + 1)
        assert not _close(bad[1], refs[1])


@pytest.mark.parametrize("n, f", [(4096, 3072), (1000, 6400)])   # 124M at 4 x 1024; 1.5B
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bias_gelu_dropout_at_the_main_shapes(cuda, n, f, rate):
    """K6 at the training path's shape and the ragged 1.5B width: the
    forward and dh element by element, db within the column-sum bound, two
    backward launches bit-identical, and the next seed's mask rejected."""
    rng = np.random.default_rng(n + f)
    h, dout = _bf16(rng, n, f, device=cuda), _bf16(rng, n, f, device=cuda)
    b = _bf16(rng, f, device=cuda) * 0.1
    seed, bf = 0x5EED4321, torch.bfloat16
    out = fl.bias_gelu_dropout_fwd(h, b, rate, seed)
    out_p = fl.bias_gelu_dropout_plain(h.float(), b.float(), rate, seed, dtype=bf)
    dh, db = fl.bias_gelu_dropout_bwd(h, b, dout, rate, seed)
    dh2, db2 = fl.bias_gelu_dropout_bwd(h, b, dout, rate, seed)
    dh_p, db_p = fl.bias_gelu_dropout_bwd_plain(h.float(), b.float(), dout.float(), rate, seed,
                                                dtype=bf)
    assert torch.equal(dh, dh2) and torch.equal(db, db2)   # no atomics
    assert _close(out, out_p) and _close(dh, dh_p)
    assert _colsum_close(db, db_p, dh_p.abs().sum(0))
    if rate:
        assert not _close(fl.bias_gelu_dropout_fwd(h, b, rate, seed + 1), out_p)
        assert not _close(fl.bias_gelu_dropout_bwd(h, b, dout, rate, seed + 1)[0], dh_p)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bias_gelu_kernels_over_every_finite_bf16(cuda, rate):
    """K6 on h holding every finite bf16 value (b = 0, dout = 1), against
    the plain versions wherever their values are finite in bf16, and the
    same NaN or inf elsewhere (gelu' is 0 x inf for |u| >~ 5e19)."""
    u = torch.arange(2 ** 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    u = u[torch.isfinite(u.float())]
    h = torch.zeros(64 * 1024, dtype=torch.bfloat16)
    h[:u.numel()] = u
    h = h.view(1024, 64).t().contiguous().to(cuda)
    b = torch.zeros(1024, dtype=torch.bfloat16, device=cuda)
    seed, bf = 0x5EED4321, torch.bfloat16
    out = fl.bias_gelu_dropout_fwd(h, b, rate, seed)
    dh, db = fl.bias_gelu_dropout_bwd(h, b, torch.ones_like(h), rate, seed)
    out_p = fl.bias_gelu_dropout_plain(h.float(), b.float(), rate, seed, dtype=bf)
    dh_p, db_p = fl.bias_gelu_dropout_bwd_plain(h.float(), b.float(), torch.ones_like(h).float(),
                                                rate, seed, dtype=bf)
    for got, ref in ((out, out_p), (dh, dh_p)):
        fin = torch.isfinite(ref.to(bf))
        assert _close(got[fin], ref[fin])
        assert torch.equal(got[~fin].float().nan_to_num(), ref.to(bf)[~fin].float().nan_to_num())
    # db: the column-sum bound plus the element bound's absolute part once
    # a row, as the tanh form rounds gelu' to 0 below u ~ -9 where the
    # sigmoid form keeps its tiny value.
    fin = torch.isfinite(db_p.to(bf))
    err = (db[fin].float() - db_p[fin]).abs()
    tol = 2.0 ** -8 * db_p[fin].abs() + 2.0 ** -11 * dh_p.abs().sum(0)[fin] + 64 * 2.0 ** -16
    assert bool((err <= tol).all())


@pytest.mark.parametrize("sp", [2, 4])
def test_one_card_ring_matches_k1_k2(cuda, sp):
    """The ring schedule of all sp ranks in one process against K1/K2 over
    the whole sequence with the same seed: the ring rounds each step's o to
    bf16 and combines in fp32, K8 rounds q * scale to bf16, and dk/dv sum sp
    bf16 partials, so they differ by a few bf16 roundings (relative L2
    2^-7 on o, 2^-6 on the grads); K8 launches sp^2 each way."""
    from gpt_2_distributed_torch.ops import flash_block as fb
    from gpt_2_distributed_torch.ops.ring_attention import ring_attention_all_ranks

    rng = np.random.default_rng(sp)
    q, k, v, do = (_bf16(rng, 2, 512, 12, 64, device=cuda) for _ in range(4))

    def run(attn):
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        o = attn(qg, kg, vg)
        return (o, *torch.autograd.grad(o, (qg, kg, vg), do))

    ref = run(lambda a, b, c: flash.flash_attention_bthd(a, b, c, 0.1, 77))
    before = (fb.flash_block_fwd.launches, fb.flash_block_bwd.launches)
    got = run(lambda a, b, c: ring_attention_all_ranks(a, b, c, sp=sp, dropout_rate=0.1,
                                                       seed=77))
    torch.cuda.synchronize()
    assert (fb.flash_block_fwd.launches - before[0],
            fb.flash_block_bwd.launches - before[1]) == (sp * sp, sp * sp)
    for i, (g, r) in enumerate(zip(got, ref)):
        rel = ((g.float() - r.float()).norm() / r.float().norm()).item()
        assert rel <= (2.0 ** -7 if i == 0 else 2.0 ** -6), (i, rel)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_offset_form_rows_are_the_whole_prompt_rows(cuda, d):
    """K1's query-offset form: rows at starts 0, 37 and 128 of three
    prompts in one launch, keys past each chunk holding random data, equal
    bit for bit to the whole-prompt form's rows at the same positions, and
    held to the offset plain version within K1's term-scaled bound."""
    rng = np.random.default_rng(d)
    t, c = 200, 48
    q, k, v = (_bf16(rng, 3, 2, t, d, device=cuda) for _ in range(3))
    starts = [0, 37, 128]
    qc = torch.stack([q[i, :, s:s + c] for i, s in enumerate(starts)])
    kc, vc = k.clone(), v.clone()
    for i, s in enumerate(starts):
        kc[i, :, s + c:] = _bf16(rng, 2, t - s - c, d, device=cuda)
        vc[i, :, s + c:] = _bf16(rng, 2, t - s - c, d, device=cuda)
    st = torch.tensor(starts, dtype=torch.int32, device=cuda)
    o, lse = flash.flash_attention_fwd_offset(qc, kc, vc, st)
    o_w, lse_w = flash.flash_attention_fwd(q, k, v)
    for i, s in enumerate(starts):
        assert torch.equal(o[i], o_w[i, :, s:s + c]) and torch.equal(lse[i], lse_w[i, :, s:s + c])
    o_ref, lse_ref = flash.flash_attention_offset_plain(qc.float(), kc.float(), vc.float(), st)
    (terms,) = flash.flash_offset_error_terms(qc, kc, vc, st)
    assert _flash_close(o, o_ref, terms)
    assert (lse - lse_ref).abs().max().item() <= 1e-4


def test_engine_prefix_cache_and_chunks_equal_generate_cached_on_the_card(cuda):
    """Every stream of engines with the prefix cache, chunks and batched
    prefill equals generate_cached(batch=1)'s, sampled, and each chunk
    dispatch launches the offset form once a layer."""
    cfg = GPT2Config(vocab_size=1000, n_positions=256, n_embd=128, n_layer=2, n_head=2)
    params = gpt2.init_params(cfg, seed=0)
    prefix = list(range(300, 364))
    prompts = [prefix, prefix + [1, 2, 3], prefix, prefix[:32], prefix + list(range(9, 90))]
    refs = [generate_cached(params, cfg, [p], seed=7 + i, max_new_tokens=12, temperature=1.0,
                            block_size=16)[0, len(p):].tolist() for i, p in enumerate(prompts)]
    for chunk, batch in ((0, 1), (16, 2), (64, 4)):
        serve = ServeConfig(max_batch=4, block_size=16, num_blocks=64, prefix_cache=True,
                            prefill_chunk=chunk, prefill_batch=batch)
        eng = ServingEngine(params, cfg, serve, temperature=1.0)
        n0 = flash.flash_attention_fwd_offset.launches
        first = eng.submit(prompts[0], 12, seed=7)
        eng.run_until_idle(max_steps=200)
        rest = [eng.submit(p, 12, seed=8 + i) for i, p in enumerate(prompts[1:])]
        eng.run_until_idle(max_steps=200)
        assert [h.generated for h in [first] + rest] == refs, (chunk, batch)
        assert eng.stats["cow_copies"] >= 1 and eng.stats["prefix_hit_tokens"] > 0
        # Whole-prompt mode prefills a request with no hit whole (K1).
        whole = sum(h.prefix_cached_tokens == 0 for h in [first] + rest) if chunk == 0 else 0
        assert (flash.flash_attention_fwd_offset.launches - n0
                == cfg.n_layer * (eng.stats["prefill_dispatches"] - whole))
