"""Host-side number theory: NTT-friendly prime generation and root finding.

The port's own copy of `fhe_spear_tpu/core/primes.py` (pure Python, copied
whole so that both packages pick the same primes).  All math here runs once
at context-construction time with exact Python integers; the results are
baked into the per-limb tables of `core/ntt.NttContext`.

The device word is 32 bits (the CUDA kernels work on uint32 residues; the
torch glue carries them as int64), so the RNS limb primes are chosen just
below 2^31.  Depth budgets are expressed in *limbs* rather than bits, and
the default scale is ~2^28.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

__all__ = [
    "is_prime",
    "find_ntt_primes",
    "primitive_root_of_unity",
    "Prime",
]


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (covers all 64-bit n)."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


@dataclass(frozen=True)
class Prime:
    """A single NTT-friendly RNS prime with its precomputed constants.

    Attributes:
      p: the prime, p ≡ 1 (mod 2N), p < 2^31.
      root: a primitive 2N-th root of unity mod p (ψ, negacyclic root).
      mont_r: R mod p where R = 2^32 (Montgomery radix).
      mont_r2: R^2 mod p (for converting into the Montgomery domain).
      mont_pinv: -p^{-1} mod 2^32 (Montgomery REDC constant).
    """

    p: int
    root: int
    mont_r: int
    mont_r2: int
    mont_pinv: int

    @property
    def bits(self) -> int:
        return self.p.bit_length()


def _make_prime(p: int, two_n: int) -> Prime:
    root = primitive_root_of_unity(p, two_n)
    r = (1 << 32) % p
    r2 = r * r % p
    pinv = (-pow(p, -1, 1 << 32)) % (1 << 32)
    return Prime(p=p, root=root, mont_r=r, mont_r2=r2, mont_pinv=pinv)


@functools.lru_cache(maxsize=None)
def find_ntt_primes(
    n: int,
    count: int,
    target_bits: int = 28,
    first_bits: int = 31,
    reserve_special: int = 0,
) -> tuple[Prime, ...]:
    """Find `count + reserve_special` distinct primes ≡ 1 (mod 2n), < 2^31.

    Layout (the CKKS modulus-chain convention):
      - prime[0]: ~`first_bits` bits (the "q0" headroom prime).
      - primes[1..count-1]: as close as possible to 2^target_bits
        alternating above/below so that repeated rescales keep the scale
        drift near 1 (SEAL-style scale tracking handles the residual).
      - the last `reserve_special` primes: ~31 bits (keyswitch specials,
        must dominate every q_i).
    """
    two_n = 2 * n
    out: list[Prime] = []
    used: set[int] = set()

    def grab_near(center: int, direction: int) -> int:
        """Largest/smallest prime ≡ 1 mod 2n at or beyond `center`."""
        cand = center - (center - 1) % two_n  # ≡ 1 mod 2n, ≤ center
        if direction > 0 and cand < center:
            cand += two_n
        while True:
            if 2 < cand < (1 << 31) and cand not in used and is_prime(cand):
                return cand
            cand += direction * two_n

    # q0: just below 2^first_bits
    p0 = grab_near((1 << first_bits) - 1, -1)
    used.add(p0)
    out.append(_make_prime(p0, two_n))

    # scale primes, alternating around 2^target_bits
    lo_cursor = (1 << target_bits) - 1
    hi_cursor = (1 << target_bits) + 1
    for i in range(count - 1):
        if i % 2 == 0:
            p = grab_near(hi_cursor, +1)
            hi_cursor = p + two_n
        else:
            p = grab_near(lo_cursor, -1)
            lo_cursor = p - two_n
        used.add(p)
        out.append(_make_prime(p, two_n))

    # special primes, just below 2^31 (skipping over p0)
    cursor = (1 << 31) - 1
    for _ in range(reserve_special):
        p = grab_near(cursor, -1)
        used.add(p)
        cursor = p - two_n
        out.append(_make_prime(p, two_n))

    return tuple(out)


def primitive_root_of_unity(p: int, order: int) -> int:
    """A primitive `order`-th root of unity mod p (order | p-1, order a power of 2)."""
    assert (p - 1) % order == 0, f"{order} does not divide {p}-1"
    cof = (p - 1) // order
    g = 2
    while True:
        cand = pow(g, cof, p)
        if pow(cand, order // 2, p) != 1 and pow(cand, order, p) == 1:
            return cand
        g += 1
        if g > 10_000:
            raise RuntimeError(f"no primitive root found for p={p}")
