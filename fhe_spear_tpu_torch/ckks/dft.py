"""Factorized (level-collapsed FFT) linear stages for CKKS bootstrapping.

The port's own copy of `fhe_spear_tpu/ckks/dft.py` (numpy only), so that
both packages build the same stage tables.  CoeffToSlot/SlotToCoeff are
evaluated as log2(S)/k collapsed FFT stages of at most 2^(k+1)-1
rotation-diagonals each (the Cheon-Han-Kim decomposition), derived
numerically from the slot encoder's root ordering:

  * With slot j at root zeta^(5^j mod 2N) (ckks/encoding.py), the decode
    map restricted to slots is z = E w, where E[j,k] = zeta^(k * 5^j) and
    w = a[:S] + i a[S:] packs the real coefficient vector a.  The map is
    purely C-linear (no conjugate term: zeta^(S*5^j) = i exactly).
  * E = C_m ... C_1 P_bitrev, where stage C_s is a radix-2 butterfly of
    span h = 2^(s-1) acting on bit-reversed data: 3 rotation-diagonals at
    offsets {0, +h, -h} with twiddles t_{h,q} = exp(i*pi*(5^q mod 8h)/(4h))
    independent of the block index.
  * CoeffToSlot = P^-1 C_1^-1 ... C_m^-1 with the P^-1 DROPPED: EvalMod is
    slot-pointwise, so the bit-reversal cancels against SlotToCoeff's
    leading P (likewise dropped).
  * Level collapse: consecutive stages compose into one linear map whose
    diagonal support is the sumset of the factors' supports --
    {j*h : |j| < 2^k} after k radix-2 stages with smallest span h.

Each collapsed group is evaluated by one generalized-BSGS matvec
(ops/bsgs.DiagonalMatvec), costing one ciphertext level.
"""

from __future__ import annotations

import numpy as np

__all__ = ["special_fft_stages", "inverse_stages", "collapse_stages",
           "apply_stages_host", "bitrev"]


def bitrev(m: int) -> np.ndarray:
    """Bit-reversal permutation on 2^m indices."""
    s = 1 << m
    br = np.zeros(s, dtype=np.int64)
    for i in range(s):
        x, r = i, 0
        for _ in range(m):
            r = (r << 1) | (x & 1)
            x >>= 1
        br[i] = r
    return br


def _twiddles(h: int) -> np.ndarray:
    """t_{h,q} = exp(i*pi*(5^q mod 8h)/(4h)) for q = 0..h-1."""
    e = np.ones(h, dtype=np.int64)
    for q in range(1, h):
        e[q] = e[q - 1] * 5 % (8 * h)
    return np.exp(1j * np.pi * e / (4 * h))


def special_fft_stages(slots: int) -> list[dict[int, np.ndarray]]:
    """Forward stages [C_1, ..., C_m] (finest span first) such that
    C_m(...C_1(w[bitrev])) = E w.  Each stage is {offset: diagonal[S]}
    with out = sum_d diag_d * rot_d(in), rot_d(x)_p = x_{(p+d) mod S}."""
    s = slots
    m = s.bit_length() - 1
    assert (1 << m) == s, s
    stages = []
    for st in range(m):
        h = 1 << st
        t = _twiddles(h)
        q = np.arange(s) % (2 * h)
        lo = q < h                      # first half of each butterfly block
        tq = np.where(lo, t[np.minimum(q, h - 1)], t[np.maximum(q - h, 0)])
        d0 = np.where(lo, 1.0 + 0j, -tq)
        dp = np.where(lo, tq, 0j)       # offset +h
        dm = np.where(lo, 0j, 1.0 + 0j)  # offset -h
        stage = {0: d0, h: dp}
        if (-h) % s != h:
            stage[(-h) % s] = dm
        else:                           # h == S/2: +h and -h coincide
            stage[h] = dp + dm
        stages.append(stage)
    return stages


def inverse_stages(slots: int) -> list[dict[int, np.ndarray]]:
    """Inverse stages [C_m^-1, ..., C_1^-1] (coarsest span first) such that
    C_1^-1(...C_m^-1(z)) = (E^-1 z)[bitrev] — the CoeffToSlot factors."""
    s = slots
    out = []
    for st, _fwd in reversed(list(enumerate(special_fft_stages(slots)))):
        h = 1 << st
        t = _twiddles(h)
        q = np.arange(s) % (2 * h)
        lo = q < h
        tq = np.where(lo, t[np.minimum(q, h - 1)], t[np.maximum(q - h, 0)])
        # u = (y_lo + y_hi)/2 ; v = (y_lo - y_hi)/(2 t)
        d0 = np.where(lo, 0.5 + 0j, -0.5 / tq)
        dp = np.where(lo, 0.5 + 0j, 0j)      # offset +h (only in lo rows)
        dm = np.where(lo, 0j, 0.5 / tq)      # offset -h (only in hi rows)
        stage = {0: d0, h: dp}
        if (-h) % s != h:
            stage[(-h) % s] = dm
        else:
            stage[h] = dp + dm
        out.append(stage)
    return out


def _compose(o2: dict[int, np.ndarray], o1: dict[int, np.ndarray], s: int
             ) -> dict[int, np.ndarray]:
    """Composition o2 after o1 in rotation-diagonal form:
    (o2 o1)_d = sum_{d1+d2=d} o2_{d2} * rot_{d2}(o1_{d1})."""
    out: dict[int, np.ndarray] = {}
    for d2, b in o2.items():
        for d1, a in o1.items():
            d = (d1 + d2) % s
            v = b * np.roll(a, -d2)
            if d in out:
                out[d] = out[d] + v
            else:
                out[d] = v
    return out


def collapse_stages(stages: list[dict[int, np.ndarray]], radix: int,
                    slots: int) -> list[dict[int, np.ndarray]]:
    """Collapse consecutive stages in groups of `radix` (application order
    preserved: result[0] applied first).  Drops numerically-zero diagonals."""
    out = []
    for i in range(0, len(stages), radix):
        grp = stages[i]
        for st in stages[i + 1: i + radix]:
            grp = _compose(st, grp, slots)
        grp = {d: v for d, v in grp.items() if np.abs(v).max() > 1e-14}
        out.append(grp)
    return out


def apply_stages_host(stages: list[dict[int, np.ndarray]], x: np.ndarray
                      ) -> np.ndarray:
    """Reference host evaluation of a stage list on a slot vector."""
    for st in stages:
        acc = np.zeros_like(x, dtype=np.complex128)
        for d, diag in st.items():
            acc = acc + diag * np.roll(x, -d)
        x = acc
    return x
