"""CKKS canonical-embedding encoder/decoder (host side, numpy, FFT-based).

The port's own copy of `fhe_spear_tpu/ckks/encoding.py`, so both packages
encode a vector to the same integer coefficients.

Slot convention: slot j (j = 0..N/2-1) holds the evaluation of the message
polynomial at zeta^(5^j mod 2N), where zeta = exp(i*pi/N) is the primitive
complex 2N-th root of unity.  Conjugate evaluations at zeta^(-5^j) carry
conj(slot j), making the coefficient vector real.  Under this ordering the
Galois automorphism X -> X^(5^r) maps slot j -> slot j+r (a cyclic left
rotation by r), and X -> X^(2N-1) conjugates every slot.

Encode/decode are O(N log N) via a single length-N complex FFT with a
zeta^k pre/post twist:

    m(zeta^(2t+1)) = sum_k (a_k * zeta^k) * omega^(t*k),  omega = zeta^2,

so the values of m at ALL odd powers of zeta are N * ifft(a * zeta^k).
Encoding happens at the client and at diagonal pre-encoding time, never
inside the device hot loop.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SlotEncoder"]


class SlotEncoder:
    """FFT encoder for ring dimension n (n a power of two, n/2 slots)."""

    def __init__(self, n: int):
        self.n = n
        self.slots = n // 2
        two_n = 2 * n
        # slot j sits at odd exponent 5^j; its conjugate at 2N - 5^j
        e = np.ones(self.slots, dtype=np.int64)
        for j in range(1, self.slots):
            e[j] = e[j - 1] * 5 % two_n
        self._t_slot = (e - 1) // 2                 # vals index of slot j
        self._t_conj = (two_n - e - 1) // 2         # vals index of conj(slot j)
        k = np.arange(n)
        self._zeta_pow = np.exp(1j * np.pi * k / n)         # zeta^k
        self._zeta_pow_inv = np.exp(-1j * np.pi * k / n)    # zeta^-k

    def embed(self, z: np.ndarray) -> np.ndarray:
        """Slots (complex [..., slots]) -> real coefficient vector [..., n].

        Unscaled inverse canonical embedding; caller multiplies by the CKKS
        scale and rounds.
        """
        z = np.asarray(z, dtype=np.complex128)
        assert z.shape[-1] == self.slots, (z.shape, self.slots)
        vals = np.zeros(z.shape[:-1] + (self.n,), dtype=np.complex128)
        vals[..., self._t_slot] = z
        vals[..., self._t_conj] = np.conj(z)
        b = np.fft.fft(vals, axis=-1) / self.n
        return (b * self._zeta_pow_inv).real

    def project(self, a: np.ndarray) -> np.ndarray:
        """Real coefficients [..., n] -> slots (complex [..., slots])."""
        a = np.asarray(a, dtype=np.float64)
        vals = np.fft.ifft(a * self._zeta_pow, axis=-1) * self.n
        return vals[..., self._t_slot]

    def encode(self, z: np.ndarray, scale: float,
               wide: bool = False) -> np.ndarray:
        """Slots -> integer coefficient vector (int64, centered).

        Pads z with zeros up to the slot count.  Raises if the scaled
        coefficients overflow the 2^31 word (q0 headroom violated).
        wide=True raises the bound to 2^62 instead.
        """
        z = np.asarray(z)
        if z.shape[-1] < self.slots:
            pad = [(0, 0)] * (z.ndim - 1) + [(0, self.slots - z.shape[-1])]
            z = np.pad(z, pad)
        coeffs = np.round(self.embed(z) * scale).astype(np.int64)
        limit = np.abs(coeffs).max(initial=0)
        bound = (1 << 62) if wide else (1 << 31)
        if limit >= bound:
            raise OverflowError(
                f"encoded coefficient magnitude {limit} >= 2^{62 if wide else 31}; "
                f"reduce message magnitude or scale ({scale})"
            )
        return coeffs

    def decode(self, coeffs: np.ndarray, scale: float) -> np.ndarray:
        """Centered integer coefficients -> complex slots."""
        return self.project(np.asarray(coeffs, dtype=np.float64)) / scale
