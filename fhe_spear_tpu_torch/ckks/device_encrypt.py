"""The client's symmetric encryption on the device, with randomness from
an explicit `torch.Generator` (the reference's threefry draw in
distribution, not in bits), beside `CkksContext.encrypt`'s host draw.
Every device-resident client (the fused transport of
`models/client_aided.py`, `models/device_crypto.py`, the block pipeline)
encrypts through it.  Its core, the RNS expansion of int32 coefficient
encodings into NTT/Montgomery residues (`rns_expand`, and `rns_expand_wide`
for two-plane words), also expands the BSGS engine's staged diagonals
(`ops/bsgs.expand_groups`)."""

from __future__ import annotations

import torch

from ..core.modops import add_mod, barrett_reduce, mont_mul, neg_mod
from .context import CkksContext

__all__ = ["encrypt_on_device", "rns_expand", "rns_expand_wide"]


def rns_expand(ctx: CkksContext, coeffs: torch.Tensor, level: int
               ) -> torch.Tensor:
    """Signed int32 coefficient encodings [..., N] -> NTT/Mont residues
    [..., l, N] (device-side RNS expansion; also the fused-encrypt core)."""
    rows = tuple(range(level))
    p, _ = ctx._p(level)
    r = coeffs.to(torch.int64)[..., None, :] % p      # canonical in [0, p)
    return ctx.ntt.ntt_to_mont(r, rows)


def rns_expand_wide(ctx: CkksContext, planes: torch.Tensor, level: int
                    ) -> torch.Tensor:
    """Two-plane int64-split coefficient encodings [..., 2, N] (value =
    hi*2^31 + lo, |value| < 2^62) -> NTT/Mont residues [..., l, N]: the
    wide staging word of composite-scale (width-2) diagonals.  The value is
    formed exactly in int64 and reduced once, which gives the reference's
    canonical words."""
    rows = tuple(range(level))
    p, _ = ctx._p(level)
    v = (planes[..., 1, :].to(torch.int64) * (1 << 31)
         + planes[..., 0, :].to(torch.int64))
    return ctx.ntt.ntt_to_mont(v[..., None, :] % p, rows)


def _generator(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _uniform_mod(ctx: CkksContext, gen: torch.Generator, shape: tuple,
                l: int) -> torch.Tensor:
    """Uniform residues [*shape, l, N] mod q from 64 random bits each:
    (hi * 2^32 + lo) mod q = hi * (2^32 mod q) + lo  (mod q)."""
    p, pinv = ctx._p(l)
    mu = ctx.mu[:l]
    t32r = ctx.t32_mont[:l]
    draw = lambda: torch.randint(0, 1 << 32, shape + (l, ctx.n),
                                 generator=gen, dtype=torch.int64,
                                 device=ctx.device)
    hi, lo = draw(), draw()
    return add_mod(mont_mul(barrett_reduce(hi, p, mu), t32r, p, pinv),
                   barrett_reduce(lo, p, mu), p)


def encrypt_on_device(ctx: CkksContext, m: torch.Tensor,
                      gen: torch.Generator, l: int) -> torch.Tensor:
    """Symmetric encryption of int32 coefficient encodings m [..., N] at
    level l with device randomness from `gen` (the reference's threefry
    draw in distribution, not in bits) -> ciphertexts [..., 2, l, N]."""
    p, pinv = ctx._p(l)
    shape = tuple(m.shape[:-1])
    m_eval = rns_expand(ctx, m, l)                         # [..., l, N]
    a = _uniform_mod(ctx, gen, shape, l)
    e = torch.round(torch.randn(shape + (ctx.n,), generator=gen,
                                dtype=torch.float64, device=ctx.device)
                    * ctx.params.noise_sigma).to(torch.int32)
    e_eval = rns_expand(ctx, e, l)
    c0 = add_mod(add_mod(neg_mod(mont_mul(a, ctx.s_eval[:l], p, pinv), p),
                         m_eval, p), e_eval, p)
    return torch.stack([c0, a], dim=-3)
