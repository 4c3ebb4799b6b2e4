"""Embedding geometry + complex SIMD packing.

The port's own copy of `fhe_spear_tpu/ops/packing.py` (pure numpy, host
side): these transforms happen before encryption and after decryption,
on the client side of the crypto boundary.

CKKS slots are complex, so a real d-vector packs into d/2 slots by pairing
adjacent coordinates into real/imag parts.  For a dot product under a
CT-CT multiply the query is packed conjugated:
    Re((a + ib) * (c - id)) = a*c + b*d
which makes the real part of the slot-wise product the per-pair dot
product; summing real parts over a doc's slot block gives <q, d>.

The Lorentz (hyperboloid) lift prepends x0 = sqrt(1 + ||v||^2); the Lorentz
inner product -q0*d0 + <qs, ds> is turned into a plain dot product by
sign-flipping the query's time component before packing.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "euclidean_to_lorentz",
    "lorentz_inner",
    "pack_complex",
    "pack_complex_conjugate",
    "unpack_complex",
]


def euclidean_to_lorentz(v: np.ndarray) -> np.ndarray:
    """[..., d] -> [..., d+1] hyperboloid lift: x0 = sqrt(1 + ||v||^2)."""
    v = np.asarray(v, dtype=np.float64)
    x0 = np.sqrt(1.0 + np.sum(v * v, axis=-1, keepdims=True))
    return np.concatenate([x0, v], axis=-1)


def lorentz_inner(q: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Lorentz inner product -q0*d0 + <qs, ds> (batched over leading dims)."""
    q, d = np.asarray(q), np.asarray(d)
    return -q[..., 0] * d[..., 0] + np.sum(q[..., 1:] * d[..., 1:], axis=-1)


def _pad_even(x: np.ndarray) -> np.ndarray:
    if x.shape[-1] % 2:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, 1)]
        x = np.pad(x, pad)
    return x


def pack_complex(x: np.ndarray) -> np.ndarray:
    """Real [..., d] -> complex [..., ceil(d/2)]: x[2j] + i*x[2j+1]."""
    x = _pad_even(np.asarray(x, dtype=np.float64))
    return x[..., 0::2] + 1j * x[..., 1::2]


def pack_complex_conjugate(x: np.ndarray) -> np.ndarray:
    """Real [..., d] -> complex [..., ceil(d/2)]: x[2j] - i*x[2j+1]
    (query-side packing so products' real parts are pairwise dots)."""
    x = _pad_even(np.asarray(x, dtype=np.float64))
    return x[..., 0::2] - 1j * x[..., 1::2]


def unpack_complex(z: np.ndarray, d: int | None = None) -> np.ndarray:
    """Inverse of pack_complex: complex [..., m] -> real [..., 2m] (or [..., d])."""
    z = np.asarray(z)
    out = np.empty(z.shape[:-1] + (2 * z.shape[-1],), dtype=np.float64)
    out[..., 0::2] = z.real
    out[..., 1::2] = z.imag
    return out if d is None else out[..., :d]
