"""Exact modular arithmetic over RNS residues held as torch int64.

Counterpart of `fhe_spear_tpu/core/modops.py`.  The reference keeps every
residue in a uint32 and assembles 32x32->64 products from 16-bit pieces,
because the TPU has no 64-bit multiplier.  Torch has no uint32 `+`, `>=`
or `>>` on the CPU, so the port keeps canonical residues as int64 in
[0, p) with p < 2^31; the CUDA kernels see 32-bit words internally.

Every function returns the canonical representative, so its words equal
the reference's word for word (any exact reduction gives the same word).
Residues stay in the Montgomery domain (R = 2^32) throughout, as in the
reference.

Overflow bounds (int64 holds values below 2^63):
  * a*b for a, b < p < 2^31 is below 2^62;
  * REDC's m = (lo * pinv) mod 2^32 is formed from the 16-bit halves of
    pinv, so no partial product reaches 2^49;
  * m*p < 2^32 * 2^31 = 2^63, and the result is assembled as
    hi + floor(m*p / 2^32) + (lo != 0) exactly as the reference does,
    so the wide sum t + m*p (up to 2^63 + 2^62) is never formed.
"""

from __future__ import annotations

import torch

__all__ = [
    "MASK32",
    "mul_lo_u32",
    "mul_hi_u32",
    "mont_mul",
    "mont_reduce_wide",
    "add_mod",
    "sub_mod",
    "neg_mod",
    "cond_sub",
    "barrett_reduce",
]

MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF


def mul_lo_u32(a, b):
    """(a * b) mod 2^32 for a, b in [0, 2^32) (the reference's wrapping
    uint32 multiply), without forming the 64-bit product."""
    lo = a * (b & _MASK16)                         # < 2^48
    hi = ((a * (b >> 16)) & _MASK16) << 16         # < 2^32
    return (lo + hi) & MASK32


def mul_hi_u32(a, b):
    """High 32 bits of the 64-bit product a*b for a, b in [0, 2^32)."""
    a0, a1 = a & _MASK16, a >> 16
    b0, b1 = b & _MASK16, b >> 16
    t = a1 * b0 + ((a0 * b0) >> 16)
    w1 = (t & _MASK16) + a0 * b1
    return a1 * b1 + (t >> 16) + (w1 >> 16)


def cond_sub(x, p):
    """x - p if x >= p else x (lazy-reduction fixup)."""
    return torch.where(x >= p, x - p, x)


def add_mod(a, b, p):
    """(a + b) mod p for a, b in [0, p)."""
    return cond_sub(a + b, p)


def sub_mod(a, b, p):
    """(a - b) mod p for a, b in [0, p)."""
    d = a - b
    return torch.where(d < 0, d + p, d)


def neg_mod(a, p):
    """(-a) mod p for a in [0, p)."""
    return torch.where(a == 0, a, p - a)


def mont_reduce_wide(hi, lo, p, pinv):
    """Montgomery REDC of hi*2^32 + lo (hi*2^32 + lo < p*2^32, lo < 2^32):
    returns (hi*2^32 + lo) * 2^-32 mod p in [0, p)."""
    m = mul_lo_u32(lo, pinv)
    # lo + (m*p mod 2^32) == 0 mod 2^32 by construction of pinv; the carry
    # out of that addition is exactly (lo != 0)
    t = hi + ((m * p) >> 32) + (lo != 0).to(hi.dtype)
    return cond_sub(t, p)


def mont_mul(a, b, p, pinv):
    """Montgomery product a*b*2^-32 mod p for a, b in [0, p), p < 2^31."""
    t = a * b
    return mont_reduce_wide(t >> 32, t & MASK32, p, pinv)


def barrett_reduce(x, p, mu):
    """x mod p for x in [0, 2^32), p < 2^31, mu = floor(2^32 / p).

    x*mu < 2^32 * 2^31 fits in int64 for every p >= 3."""
    q = (x * mu) >> 32
    return cond_sub(x - q * p, p)
