"""The element bound that holds the flash kernels K1 and K2, and the ring's
block kernel K8, against their plain versions, checked on the CPU.

The kernels multiply on the tensor cores, so they round the dropped
probabilities (K1, K8's forward), ds and pd (K2, K8's backward) to bf16
before their products, where the JAX kernels round them; the plain
versions keep them in fp32. The card
checks (``chip_smoke.py``, ``tests/test_torch_cuda.py``) hold each output
element to ``flash_tolerance``,

    |x - ref| <= 2^-8 |ref| + 2^-16 + 2^-8 terms

with ``terms`` from ``flash_error_terms``: one bf16 rounding moves a product
term by at most 2^-8 of itself. Here a torch emulation of the kernels'
roundings (P rounded key tile by key tile in the online-softmax order of
the 64-key tiles of K1 and K8's forward, ds and pd rounded in K2 and in
K8's backward) must lie within that bound against the fp32 plain versions,
and a planted fault must not. K8's terms (``flash_block_error_terms``)
follow its scaled q and its mask at global offsets.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import pytest
import torch

from gpt_2_distributed_torch.ops import flash_attention as flash
from gpt_2_distributed_torch.ops import flash_block as fb
from gpt_2_distributed_torch.ops.spmd import block_dropout_keep, causal_dropout_keep

BK = 64   # K1's keys per tile
LSE_TOL = 1e-4
SEED = 0x5EED1234


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _inputs(b, h, t, d, n, seed):
    """n bf16-valued fp32 tensors [b, h, t, d] from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [_bf16(torch.from_numpy(rng.normal(size=(b, h, t, d)).astype(np.float32)))
            for _ in range(n)]


def _ratio(got: torch.Tensor, ref: torch.Tensor, terms: torch.Tensor) -> float:
    """Largest ratio of an element's error to its bound (<= 1 holds)."""
    return ((got - ref).abs() / flash.flash_tolerance(ref, terms)).max().item()


def _keep(rate, b, h, t):
    return causal_dropout_keep(SEED, rate, b, h, t, torch.device("cpu")) if rate else None


def emulate_k1(q, k, v, rate):
    """K1's arithmetic in torch: raw scores, the scale in the exponent, the
    online softmax over 64-key tiles in order, each tile's dropped
    probabilities rounded to bf16 before the product with V; o rounded to
    bf16 once. Returns (o, base-2 lse)."""
    b, h, t, d = q.shape
    scale = flash.LOG2E / math.sqrt(d)
    keep = _keep(rate, b, h, t)
    rows = torch.arange(t)[:, None]
    m = torch.full((b, h, t), -math.inf)
    l = torch.zeros(b, h, t)
    acc = torch.zeros(b, h, t, d)
    for k0 in range(0, t, BK):
        k1 = min(k0 + BK, t)
        s = q @ k[:, :, k0:k1].transpose(-1, -2)
        s = s.masked_fill(torch.arange(k0, k1)[None, :] > rows, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - m_new) * scale)
        p = torch.exp2(s * scale - (m_new * scale)[..., None])
        l = l * alpha + p.sum(-1)
        if rate:
            p = torch.where(keep[..., k0:k1], p / (1.0 - rate), 0.0)
        acc = acc * alpha[..., None] + _bf16(p) @ v[:, :, k0:k1]
        m = m_new
    return _bf16(acc / l[..., None]), m * scale + torch.log2(l)


def emulate_k2(q, k, v, do, lse, delta, rate):
    """K2's arithmetic in torch: p from the base-2 lse, ds and pd rounded to
    bf16 before their products, each grad rounded to bf16 once."""
    b, h, t, d = q.shape
    scale = flash.LOG2E / math.sqrt(d)
    causal = torch.ones(t, t, dtype=torch.bool).tril()
    p = torch.where(causal, torch.exp2((q @ k.transpose(-1, -2)) * scale - lse[..., None]), 0.0)
    dpd = do @ v.transpose(-1, -2)
    if rate:
        keep = _keep(rate, b, h, t)
        pd = torch.where(keep, p / (1.0 - rate), 0.0)
        dp = torch.where(keep, dpd / (1.0 - rate), 0.0)
    else:
        pd, dp = p, dpd
    ds = _bf16(p * (dp - delta[..., None]))
    c = 1.0 / math.sqrt(d)
    return (_bf16(ds @ k * c), _bf16(ds.transpose(-1, -2) @ q * c),
            _bf16(_bf16(pd).transpose(-1, -2) @ do))


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_error_terms_equal_a_brute_force_loop(rate):
    b, h, t, d = 1, 2, 6, 3
    q, k, v, do = _inputs(b, h, t, d, 4, seed=11)
    delta = torch.from_numpy(np.random.default_rng(12).normal(size=(b, h, t))
                             .astype(np.float32))
    got = flash.flash_error_terms(q, k, v, rate, SEED, do=do, delta=delta)
    keep = _keep(rate, b, h, t)
    kp = 1.0 - rate
    want = [np.zeros((b, h, t, d)) for _ in range(4)]
    for bi in range(b):
        for hi in range(h):
            for r in range(t):
                s = [float(q[bi, hi, r] @ k[bi, hi, j]) / math.sqrt(d) for j in range(r + 1)]
                z = sum(math.exp(x - max(s)) for x in s)
                for j in range(r + 1):
                    p = math.exp(s[j] - max(s)) / z
                    mul = 1.0 if keep is None else float(keep[bi, hi, r, j]) / kp
                    pd = p * mul
                    dp = float(do[bi, hi, r] @ v[bi, hi, j]) * mul
                    ds = abs(p * (dp - float(delta[bi, hi, r])))
                    for c in range(d):
                        want[0][bi, hi, r, c] += pd * abs(float(v[bi, hi, j, c]))
                        want[1][bi, hi, r, c] += ds * abs(float(k[bi, hi, j, c])) / math.sqrt(d)
                        want[2][bi, hi, j, c] += ds * abs(float(q[bi, hi, r, c])) / math.sqrt(d)
                        want[3][bi, hi, j, c] += pd * abs(float(do[bi, hi, r, c]))
    assert len(got) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6)
    (o_only,) = flash.flash_error_terms(q, k, v, rate, SEED)
    assert torch.equal(o_only, got[0])


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("t", [16, 208, 1024])
def test_kernel_roundings_lie_within_the_bound(t, rate):
    b = 1 if t == 1024 else 2
    q, k, v, do = _inputs(b, 2, t, 64, 4, seed=t)
    o, lse = emulate_k1(q, k, v, rate)
    o_ref, lse_ref = flash.flash_attention_plain(q, k, v, rate, SEED)
    (o_terms,) = flash.flash_error_terms(q, k, v, rate, SEED)
    assert _ratio(o, o_ref, o_terms) <= 1.0
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL
    # The backward on the emulated forward's lse and delta, both sides.
    delta = (do * o).sum(-1)
    grads = emulate_k2(q, k, v, do, lse, delta, rate)
    refs = flash.flash_attention_bwd_plain(q, k, v, do, lse, delta, rate, SEED)
    terms = flash.flash_error_terms(q, k, v, rate, SEED, do=do, delta=delta)[1:]
    for g, r, w in zip(grads, refs, terms):
        assert _ratio(g, r, w) <= 1.0


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_swapped_key_tile_lies_outside_the_bound(rate):
    t = 208
    q, k, v, do = _inputs(2, 2, t, 64, 4, seed=3)
    o_ref, lse_ref = flash.flash_attention_plain(q, k, v, rate, SEED)
    (o_terms,) = flash.flash_error_terms(q, k, v, rate, SEED)
    # Key tile 1 replaced by tile 2, as a kernel that loaded the wrong tile
    # would see it.
    k_bad = k.clone()
    k_bad[:, :, 64:128] = k[:, :, 128:192]
    assert _ratio(emulate_k1(q, k_bad, v, rate)[0], o_ref, o_terms) > 1.0
    # The same fault in v reaches the backward through do . v^T.
    delta = (do * o_ref).sum(-1)
    refs = flash.flash_attention_bwd_plain(q, k, v, do, lse_ref, delta, rate, SEED)
    terms = flash.flash_error_terms(q, k, v, rate, SEED, do=do, delta=delta)[1:]
    v_bad = v.clone()
    v_bad[:, :, 64:128] = v[:, :, 128:192]
    bad = emulate_k2(q, k, v_bad, do, lse_ref, delta, rate)
    assert max(_ratio(g, r, w) for g, r, w in zip(bad, refs, terms)) > 1.0


# K8's backward: blocks a ring rank meets (below the diagonal, on it) and a
# ragged block whose first rows attend nothing, at small size.
K8_CASES = [  # (b, tq, tc, row_off, col_off)
    (2, 128, 128, 128, 0),
    (2, 128, 128, 128, 128),
    (1, 208, 160, 0, 48),
]
K8_OFFS = dict(b_off=1, h_off=2)


def _k8_case(b, tq, tc, row_off, col_off, rate, seed, h=2, forward=None):
    """bf16 inputs of one K8 block (the plain versions round the scaled q
    to q's dtype, as the kernels do), its forward's lse (rounded o) and the
    effective delta under a nonzero dlse; the forward is the plain version
    unless ``forward`` (``emulate_k8_fwd``) is given."""
    q, do = (x.bfloat16() for x in _inputs(b, h, tq, 64, 2, seed=seed))
    k, v = (x.bfloat16() for x in _inputs(b, h, tc, 64, 2, seed=seed + 1))
    dlse = torch.from_numpy(np.random.default_rng(seed + 2).normal(size=(b, h, tq))
                            .astype(np.float32))
    kw = dict(seed=SEED, dropout_rate=rate, **K8_OFFS)
    o, lse = (forward or fb.flash_block_plain)(q, k, v, row_off, col_off, **kw)
    delta = (do.float() * _bf16(o)).sum(-1) - dlse * flash.LOG2E
    return (q, k, v, do, lse, delta), kw


def _k8_terms(q, k, v, do, lse, delta, row_off, col_off, **kw):
    """K8's backward terms (dq, dk, dv) on the given lse and delta."""
    return fb.flash_block_error_terms(q, k, v, row_off, col_off, do=do, lse=lse, delta=delta,
                                      **kw)[1:]


def emulate_k8_fwd(q, k, v, row_off, col_off, *, seed, b_off, h_off, dropout_rate):
    """K8's forward arithmetic in torch: q scaled and rounded to bf16, the
    online softmax over 64-key tiles in order at global offsets (a row with
    no attended key so far keeps m = -inf, l = 0), the kept p times
    fp32(1 / (1 - rate)) and rounded to bf16 tile by tile before P v; o
    rounded to bf16 once. Returns (o, base-2 lse), NEG_INF and o = 0 on a
    row that attends nothing."""
    b, h, tq, d = q.shape
    tc = k.shape[2]
    q, k, v = (x.float() for x in (q, k, v))
    qs = _bf16(q * (flash.LOG2E / math.sqrt(d)))
    rows = row_off + torch.arange(tq)[:, None]
    keep = (block_dropout_keep(seed, dropout_rate, (b, h, tq, tc),
                               (b_off, h_off, row_off, col_off), torch.device("cpu"))
            if dropout_rate else None)
    inv_keep = 1.0 / torch.tensor(1.0 - dropout_rate, dtype=torch.float32)
    m = torch.full((b, h, tq), -math.inf)
    l = torch.zeros(b, h, tq)
    acc = torch.zeros(b, h, tq, d)
    for k0 in range(0, tc, BK):
        k1 = min(k0 + BK, tc)
        attend = col_off + torch.arange(k0, k1)[None, :] <= rows
        s = (qs @ k[:, :, k0:k1].transpose(-1, -2)).masked_fill(~attend, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.where(m_new == -math.inf, 1.0, torch.exp2(m - m_new))
        p = torch.where(attend, torch.exp2(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        if dropout_rate:
            p = torch.where(keep[..., k0:k1], p * inv_keep, 0.0)
        acc = acc * alpha[..., None] + _bf16(p) @ v[:, :, k0:k1]
        m = m_new
    has = l > 0.0
    inv = torch.where(has, 1.0 / l.clamp(min=1e-37), 0.0)
    lse = torch.where(has, m + torch.log2(l.clamp(min=1e-37)), fb.NEG_INF)
    return _bf16(acc * inv[..., None]), lse


def emulate_k8_bwd(q, k, v, do, lse, delta, row_off, col_off, *, seed, b_off, h_off,
                   dropout_rate):
    """K8's backward arithmetic in torch: q scaled and rounded to bf16, p
    from the base-2 lse where (r, c) attends and 0 elsewhere, the kept
    values times fp32(1 / (1 - rate)), ds and pd rounded to bf16 before
    their products, each grad rounded to bf16 once."""
    b, h, tq, d = q.shape
    tc = k.shape[2]
    q, k, v, do = (x.float() for x in (q, k, v, do))
    qs = _bf16(q * (flash.LOG2E / math.sqrt(d)))
    rows = row_off + torch.arange(tq)[:, None]
    cols = col_off + torch.arange(tc)[None, :]
    p = torch.where(cols <= rows, torch.exp2(qs @ k.transpose(-1, -2) - lse[..., None]), 0.0)
    dpd = do @ v.transpose(-1, -2)
    if dropout_rate:
        keep = block_dropout_keep(seed, dropout_rate, (b, h, tq, tc),
                                  (b_off, h_off, row_off, col_off), torch.device("cpu"))
        inv_keep = 1.0 / torch.tensor(1.0 - dropout_rate, dtype=torch.float32)
        pd = torch.where(keep, p * inv_keep, 0.0)
        dp = torch.where(keep, dpd * inv_keep, 0.0)
    else:
        pd, dp = p, dpd
    ds = _bf16(p * (dp - delta[..., None]))
    return (_bf16(ds @ k / math.sqrt(d)), _bf16(ds.transpose(-1, -2) @ qs / flash.LOG2E),
            _bf16(_bf16(pd).transpose(-1, -2) @ do))


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_k8_error_terms_equal_a_brute_force_loop(rate):
    # Rows 0 and 1 attend nothing in this block (col_off 2 > row_off + r).
    b, h, tq, tc, d, row_off, col_off = 1, 2, 6, 5, 3, 0, 2
    q, do = (x.bfloat16() for x in _inputs(b, h, tq, d, 2, seed=21))
    k, v = (x.bfloat16() for x in _inputs(b, h, tc, d, 2, seed=22))
    kw = dict(seed=SEED, dropout_rate=rate, **K8_OFFS)
    _, lse = fb.flash_block_plain(q, k, v, row_off, col_off, **kw)
    delta = torch.from_numpy(np.random.default_rng(23).normal(size=(b, h, tq))
                             .astype(np.float32))
    got = fb.flash_block_error_terms(q, k, v, row_off, col_off, do=do, lse=lse, delta=delta,
                                     **kw)
    keep = (block_dropout_keep(SEED, rate, (b, h, tq, tc), (1, 2, row_off, col_off),
                               torch.device("cpu")) if rate else None)
    assert (lse[..., :2] == fb.NEG_INF).all()
    q, k, v, do = (x.float() for x in (q, k, v, do))
    scale = flash.LOG2E / math.sqrt(d)
    want = [np.zeros((b, h, tq, d)), np.zeros((b, h, tq, d)), np.zeros((b, h, tc, d)),
            np.zeros((b, h, tc, d))]
    for bi in range(b):
        for hi in range(h):
            qs = _bf16(q[bi, hi] * scale)
            for r in range(tq):
                for c in range(tc):
                    if col_off + c > row_off + r:
                        continue
                    p = 2.0 ** (float(qs[r] @ k[bi, hi, c]) - float(lse[bi, hi, r]))
                    mul = 1.0 if keep is None else float(keep[bi, hi, r, c]) / (1.0 - rate)
                    dp = float(do[bi, hi, r] @ v[bi, hi, c]) * mul
                    ds = abs(p * (dp - float(delta[bi, hi, r])))
                    for e in range(d):
                        want[0][bi, hi, r, e] += p * mul * abs(float(v[bi, hi, c, e]))
                        want[1][bi, hi, r, e] += ds * abs(float(k[bi, hi, c, e])) / math.sqrt(d)
                        want[2][bi, hi, c, e] += ds * abs(float(qs[r, e])) / flash.LOG2E
                        want[3][bi, hi, c, e] += p * mul * abs(float(do[bi, hi, r, e]))
    assert len(got) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6)
    (o_only,) = fb.flash_block_error_terms(q.bfloat16(), k.bfloat16(), v.bfloat16(), row_off,
                                           col_off, **kw)
    assert torch.equal(o_only, got[0])


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("case", K8_CASES, ids=["below", "diagonal", "ragged"])
def test_k8_bwd_roundings_lie_within_the_bound(case, rate):
    b, tq, tc, row_off, col_off = case
    args, kw = _k8_case(b, tq, tc, row_off, col_off, rate, seed=tq + col_off)
    grads = emulate_k8_bwd(*args, row_off, col_off, **kw)
    refs = fb.flash_block_bwd_plain(*args, row_off, col_off, **kw)
    terms = _k8_terms(*args, row_off, col_off, **kw)
    for g, r, w in zip(grads, refs, terms):
        assert _ratio(g, r, w) <= 1.0
    # The roundings are seen: the old bound without terms does not hold.
    assert max(((g - r).abs() / (2.0 ** -8 * r.abs() + 2.0 ** -16)).max().item()
               for g, r in zip(grads, refs)) > 1.0


@pytest.mark.parametrize("tl", [256, 512], ids=["sp=4", "sp=2"])
def test_k8_bwd_roundings_at_the_card_shape(tl):
    # The diagonal blocks chip_smoke.py checks on the card, [4, 12, tl, 64]
    # at dropout 0.1. The largest ratios sit on the elements with few
    # terms (dq's first query rows, dk's and dv's last keys), where the
    # rounding of ds or pd and the output's own rounding can each come
    # near 2^-8 of the value: the bound's worst case, which it holds. One
    # of the two roundings alone reaches at most half the bound on a
    # one-term element; over 48 heads both together come well past that,
    # toward the 0.85-0.96 the card reads.
    args, kw = _k8_case(4, tl, tl, tl, tl, 0.1, seed=tl, h=12)
    grads = emulate_k8_bwd(*args, tl, tl, **kw)
    refs = fb.flash_block_bwd_plain(*args, tl, tl, **kw)
    terms = _k8_terms(*args, tl, tl, **kw)
    ratios = [_ratio(g, r, w) for g, r, w in zip(grads, refs, terms)]
    assert max(ratios) <= 1.0
    assert max(ratios) > 0.75


@pytest.mark.parametrize("fault", ["col_off + 64", "seed + 1"])
def test_k8_planted_faults_lie_outside_the_bound(fault):
    row_off = col_off = 128
    args, kw = _k8_case(2, 128, 128, row_off, col_off, 0.1, seed=7)
    refs = fb.flash_block_bwd_plain(*args, row_off, col_off, **kw)
    terms = _k8_terms(*args, row_off, col_off, **kw)
    if fault == "seed + 1":
        bad = emulate_k8_bwd(*args, row_off, col_off, **{**kw, "seed": SEED + 1})
    else:
        bad = emulate_k8_bwd(*args, row_off, col_off + 64, **kw)
    assert max(_ratio(g, r, w) for g, r, w in zip(bad, refs, terms)) > 1.0


def _k8_fwd_ratio(o, q, k, v, row_off, col_off, o_ref, kw):
    (terms,) = fb.flash_block_error_terms(q, k, v, row_off, col_off, **kw)
    return _ratio(o, o_ref, terms)


def _k8_fwd_holds(q, k, v, row_off, col_off, kw, o, lse):
    """The emulated forward (o, lse) against the plain version: o within the
    term-scaled bound, lse within LSE_TOL, a row that attends nothing
    exactly o = 0 and lse = NEG_INF. Returns o's ratio."""
    o_ref, lse_ref = fb.flash_block_plain(q, k, v, row_off, col_off, **kw)
    dead = lse_ref == fb.NEG_INF
    assert torch.equal(lse == fb.NEG_INF, dead)
    assert torch.count_nonzero(o[dead]) == 0
    if (~dead).any():
        assert (lse - lse_ref)[~dead].abs().max().item() <= LSE_TOL
    ratio = _k8_fwd_ratio(o, q, k, v, row_off, col_off, o_ref, kw)
    assert ratio <= 1.0
    return ratio


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("case", K8_CASES, ids=["below", "diagonal", "ragged"])
def test_k8_fwd_roundings_lie_within_the_bound(case, rate):
    b, tq, tc, row_off, col_off = case
    (q, k, v, *_), kw = _k8_case(b, tq, tc, row_off, col_off, rate, seed=tq + col_off)
    o, lse = emulate_k8_fwd(q, k, v, row_off, col_off, **kw)
    _k8_fwd_holds(q, k, v, row_off, col_off, kw, o, lse)
    # The rounding of P is seen: the old bound without terms does not hold.
    o_ref, _ = fb.flash_block_plain(q, k, v, row_off, col_off, **kw)
    assert ((o - o_ref).abs() / (2.0 ** -8 * o_ref.abs() + 2.0 ** -16)).max().item() > 1.0


# The blocks chip_smoke.py checks on the card: [4, 12, tl, 64] below the
# diagonal (full) and on it, at dropout 0.1. Built once for the module.
CARD_BLOCKS = [(tl, where) for tl in (256, 512) for where in ("below", "diagonal")]


@functools.lru_cache(maxsize=None)
def _card_block(tl, where):
    """(args, kw, emulated (o, lse)) of one card block; args carry the
    emulated forward's lse and the delta from its rounded o."""
    row_off, col_off = tl, (0 if where == "below" else tl)
    fwd = []
    args, kw = _k8_case(4, tl, tl, row_off, col_off, 0.1, seed=tl, h=12,
                        forward=lambda *a, **k: fwd.append(emulate_k8_fwd(*a, **k)) or fwd[0])
    return args, kw, fwd[0]


@pytest.mark.parametrize("tl, where", CARD_BLOCKS,
                         ids=[f"sp={1024 // tl} {w}" for tl, w in CARD_BLOCKS])
def test_k8_fwd_roundings_at_the_card_shape(tl, where):
    args, kw, (o, lse) = _card_block(tl, where)
    ratio = _k8_fwd_holds(*args[:3], tl, 0 if where == "below" else tl, kw, o, lse)
    print(f"K8 forward emulation [4, 12, {tl}, 64] {where}: o err/tol {ratio:.3f}")


@pytest.mark.parametrize("tl", [256, 512], ids=["sp=4", "sp=2"])
def test_k8_bwd_on_the_emulated_forward_at_the_card_shape(tl):
    # What the card runs since K8's forward rounds P: both the backward
    # kernel and its plain version take the forward kernel's lse, and delta
    # from its rounded o. The roundings of the forward move lse and delta
    # for both sides alike, so the bound must hold as on the plain forward.
    args, kw, _ = _card_block(tl, "diagonal")
    grads = emulate_k8_bwd(*args, tl, tl, **kw)
    refs = fb.flash_block_bwd_plain(*args, tl, tl, **kw)
    ratios = [_ratio(g, r, w) for g, r, w in zip(grads, refs, _k8_terms(*args, tl, tl, **kw))]
    print(f"K8 backward emulation on the emulated forward [4, 12, {tl}, 64] diagonal: "
          f"err/tol dq {ratios[0]:.3f} dk {ratios[1]:.3f} dv {ratios[2]:.3f}")
    assert max(ratios) <= 1.0


@pytest.mark.parametrize("fault", ["col_off + 64", "seed + 1"])
def test_k8_fwd_planted_faults_lie_outside_the_bound(fault):
    row_off = col_off = 128
    (q, k, v, *_), kw = _k8_case(2, 128, 128, row_off, col_off, 0.1, seed=7)
    o_ref, _ = fb.flash_block_plain(q, k, v, row_off, col_off, **kw)
    if fault == "seed + 1":
        bad, _ = emulate_k8_fwd(q, k, v, row_off, col_off, **{**kw, "seed": SEED + 1})
    else:
        bad, _ = emulate_k8_fwd(q, k, v, row_off, col_off + 64, **kw)
    assert _k8_fwd_ratio(bad, q, k, v, row_off, col_off, o_ref, kw) > 1.0
