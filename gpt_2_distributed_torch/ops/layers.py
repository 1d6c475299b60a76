"""Small shared layers: layer norm (fp32 internals) and inverted dropout
(``gpt_2_distributed_tpu/ops/layers.py``), plus the port's stateless
derivation of each dropout site's key.

Dropout keys. The JAX package derives each site's key with
``jax.random.split``/``fold_in`` (threefry) and then draws the mask from
:func:`hash_random_bits` over the key's words (and, for attention, from an
int32 seed drawn from the key). The port does not re-implement threefry:
:func:`site_key` derives a site's two key words from (run seed, optimizer
step, micro-batch, layer, site) through a murmur3-style uint32 hash, and
:func:`attention_seed` turns a site's words into the flash kernels' int32
seed. Both are pure functions of their arguments, so a resumed run at step
N redraws step N's masks. Given the same key words (or seed), the masks are
the JAX package's bit for bit.
"""

from __future__ import annotations

import torch

from gpt_2_distributed_torch.ops.spmd import M32, fmix32, mul32

_MIX_PRIMES = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1)

# Dropout sites of one layer (the embedding is site 0 of layer 0).
SITE_EMBD, SITE_ATTN, SITE_ATTN_RESID, SITE_MLP_ACT, SITE_MLP_RESID = range(5)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the last axis, computed in fp32 whatever the compute
    dtype; returns x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def site_key(seed: int, step: int, micro: int, layer: int,
             site: int) -> tuple[int, int]:
    """The two uint32 key words of one dropout site.

    A murmur3-style combine: ``h`` starts from the low seed word; each of
    (high seed word, step, micro, layer, site) is scrambled by
    ``fmix32(v * 0xCC9E2D51)`` and folded in as ``h = (rotl(h ^ v, 13) * 5
    + 0xE6546B64)``; the words are ``fmix32(h ^ 0x1B873593)`` and
    ``fmix32(h ^ 0x6A09E667)``. Python ints throughout."""
    h = fmix32((seed & M32) ^ 0x9E3779B9)
    for v in ((seed >> 32) & M32, step, micro, layer, site):
        h ^= fmix32(mul32(v & M32, 0xCC9E2D51))
        h = ((h << 13) | (h >> 19)) & M32
        h = (h * 5 + 0xE6546B64) & M32
    return fmix32(h ^ 0x1B873593), fmix32(h ^ 0x6A09E667)


def attention_seed(key: tuple[int, int]) -> int:
    """The flash kernels' int32 seed of a site, in [0, 2^31) like the JAX
    package's ``jax.random.randint(key, (1,), 0, int32 max)``."""
    return key[0] & 0x7FFFFFFF


def hash_random_bits(key: tuple[int, ...], shape, device=None,
                     origin: tuple[int, ...] | None = None) -> torch.Tensor:
    """Counter-based uint32 bits (in int64) over per-dim iotas mixed with
    the key words: ``key[0] ^ key[-1] * 0x9E3779B9``, XOR each dim's iota
    times its prime, then the murmur3 finalizer — the JAX function bit for
    bit for the same words. The per-dim products are formed on broadcast
    vectors; only the finalizer runs at full width.

    ``origin`` (default all 0) starts each dim's iota at that coordinate:
    a process holding the slice ``[o_0:o_0 + n_0, ...]`` of a global
    tensor draws the bits the JAX package draws for that slice of its
    global view (a sequence-parallel rank's ``[B, T/sp, C]`` block)."""
    origin = origin or (0,) * len(shape)
    x = int(key[0]) ^ mul32(int(key[-1]) & M32, 0x9E3779B9)
    x = torch.full((1,) * len(shape), x, dtype=torch.int64, device=device)
    for dim, (n, o) in enumerate(zip(shape, origin)):
        view = [1] * len(shape)
        view[dim] = n
        iota = (o + torch.arange(n, dtype=torch.int64, device=device)).view(view)
        x = x ^ mul32(iota & M32, _MIX_PRIMES[dim % len(_MIX_PRIMES)])
    return fmix32(x.expand(tuple(shape)))


def dropout(
    x: torch.Tensor,
    rate: float,
    key: tuple[int, int] | None,
    deterministic: bool,
    origin: tuple[int, ...] | None = None,
) -> torch.Tensor:
    """Inverted dropout. No-op when deterministic or rate == 0.

    Keeps ``hash_random_bits(key, x.shape, origin=origin) >= uint32(int(
    rate * 2^32))`` and divides the kept values by the keep probability
    cast to x's dtype, as JAX divides by a weakly-typed Python float.
    ``origin`` places ``x`` in the global tensor it is a slice of."""
    if deterministic or rate == 0.0:
        return x
    if key is None:
        raise ValueError("dropout requires an rng key when not deterministic")
    keep = hash_random_bits(key, x.shape, x.device, origin) >= int(rate * (2 ** 32))
    keep_prob = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
