"""Negacyclic NTT/iNTT over RNS limbs.

Counterpart of `fhe_spear_tpu/core/ntt.py`, with the same tables, the same
bit-reversed evaluation order and the same `automorphism_perm`, so its
outputs equal the reference's word for word.

  forward:  twist x_j *= psi^j, then cyclic DIF stages.
            Output bin b holds m(psi^(2*bitrev(b)+1)).
  inverse:  reversed stages, then untwist by psi^(-j) * N^(-1).

`NttContext.ntt`/`intt` take [..., R, N] int64 residues (Montgomery form,
canonical in [0, p)).  On a CUDA tensor they launch the hand-written
kernels of `core/ntt_cuda.py` (csrc/ntt.cu); on a CPU tensor they run the
plain torch version (`ntt_plain`/`intt_plain`), the reference's Stockham
loop written in torch, which the kernels are held against.
`ntt_to_mont`/`intt_from_mont` are `to_mont(ntt(x))`/`from_mont(intt(y))`:
the same kernels with the conversion folded into the twist tables (the
transforms are linear over Z_p), and the composed plain calls on the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .modops import add_mod, mont_mul, mont_reduce_wide, sub_mod
from .primes import Prime

__all__ = ["NttContext", "bitrev_indices", "automorphism_perm",
           "coeff_automorphism_np", "require_device"]


def require_device(device) -> torch.device:
    """The torch device an entry point runs on.  A CUDA device without a
    card raises: no path falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain torch path")
    return device


def _pow_table(base: int, count: int, p: int) -> np.ndarray:
    """[base^0, base^1, ..., base^(count-1)] mod p as uint64 (vectorized)."""
    j = np.arange(count, dtype=np.uint64)
    out = np.ones(count, dtype=np.uint64)
    sq = base % p
    bit = 0
    while (1 << bit) < count:
        mask = (j >> np.uint64(bit)) & np.uint64(1)
        out = np.where(mask == 1, out * sq % p, out)
        sq = sq * sq % p
        bit += 1
    return out


def bitrev_indices(n: int) -> np.ndarray:
    """Bit-reversal permutation of range(n)."""
    logn = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


@functools.lru_cache(maxsize=None)
def _eval_exponents(n: int) -> np.ndarray:
    """e(b): output bin b holds the evaluation of m at psi^e(b), e odd mod 2n."""
    return (2 * bitrev_indices(n) + 1) % (2 * n)


def automorphism_perm(n: int, g: int) -> np.ndarray:
    """Permutation perm s.t. NTT(m(X^g))[b] = NTT(m)[perm[b]].

    m(X^g) evaluated at psi^e equals m evaluated at psi^(e*g), so bin b of
    the transformed poly fetches the bin whose exponent is e(b)*g mod 2n.
    """
    e = _eval_exponents(n)
    target = (e * g) % (2 * n)
    # bin with exponent t sits at position bitrev((t-1)/2)
    rev = bitrev_indices(n)
    return rev[(target - 1) // 2]


def coeff_automorphism_np(a: np.ndarray, g: int) -> np.ndarray:
    """m(X) -> m(X^g) in coefficient form (host side).

    X^(j*g) = (-1)^(floor(j*g/n)) * X^(j*g mod n) in the negacyclic ring.
    `a` has shape [..., n] of int64/uint64 residues mod p (caller reduces).
    """
    n = a.shape[-1]
    j = np.arange(n, dtype=np.int64)
    jg = j * g
    dest = jg % n
    sign = 1 - 2 * ((jg // n) % 2)  # +1 or -1
    out = np.zeros_like(a)
    out[..., dest] = a[..., j] * sign
    return out


class NttContext:
    """Per-limb tables for a fixed (N, primes) pair on one device.

    Residue tensors have shape [..., L, N] (limb axis second-to-last),
    int64, Montgomery domain.  `rows` arguments select which prime domains
    the limb axis lives in (a tuple of limb ids; default all primes in
    order) — keyswitch base extension transforms one source polynomial
    into many limb domains.
    """

    def __init__(self, n: int, primes: tuple[Prime, ...], device,
                 tables: dict):
        self.n = n
        self.logn = n.bit_length() - 1
        self.primes = primes
        self.device = torch.device(device)
        self.p = tables["p"]                # [L, 1]
        self.pinv = tables["pinv"]          # [L, 1]
        self.r2 = tables["r2"]              # [L, 1]
        self.psi = tables["psi"]            # [L, N] twist psi^j (Mont)
        self.psi_inv_n = tables["psi_inv_n"]  # [L, N] psi^-j * n^-1 (Mont)
        self.fwd_tw = tables["fwd_tw"]      # stage s: [L, 1, n >> (s+1)]
        self.inv_tw = tables["inv_tw"]
        self._sel_cache: dict = {}
        self._folded = None
        self.kernel_tables = None           # device tables of core/ntt_cuda

    @classmethod
    def build(cls, n: int, primes: tuple[Prime, ...], device="cuda"
              ) -> "NttContext":
        device = require_device(device)
        logn = n.bit_length() - 1
        assert 1 << logn == n
        psi_rows, psiinv_rows = [], []
        fwd_stage_rows = [[] for _ in range(logn)]
        inv_stage_rows = [[] for _ in range(logn)]
        for q in primes:
            psi = q.root
            omega = psi * psi % q.p
            psi_t = _pow_table(psi, n, q.p)
            psi_rows.append(psi_t * q.mont_r % q.p)
            ninv = pow(n, -1, q.p)
            psi_inv_t = _pow_table(pow(psi, -1, q.p), n, q.p)
            psiinv_rows.append(psi_inv_t * ninv % q.p * q.mont_r % q.p)
            w_t = _pow_table(omega, n // 2, q.p) * q.mont_r % q.p
            winv_t = (_pow_table(pow(omega, -1, q.p), n // 2, q.p)
                      * q.mont_r % q.p)
            for s in range(logn):
                half = n >> (s + 1)
                fwd_stage_rows[s].append(w_t[:: 1 << s][:half])
                inv_stage_rows[s].append(winv_t[:: 1 << s][:half])

        def i64(x):
            return torch.as_tensor(np.asarray(x, dtype=np.int64),
                                   device=device)

        col = lambda vals: i64(np.array(vals, dtype=np.int64)[:, None])
        tables = {
            "p": col([q.p for q in primes]),
            "pinv": col([q.mont_pinv for q in primes]),
            "r2": col([q.mont_r2 for q in primes]),
            "psi": i64(np.stack(psi_rows)),
            "psi_inv_n": i64(np.stack(psiinv_rows)),
            "fwd_tw": tuple(i64(np.stack(r)[:, None, :])
                            for r in fwd_stage_rows),
            "inv_tw": tuple(i64(np.stack(r)[:, None, :])
                            for r in inv_stage_rows),
        }
        return cls(n, primes, device, tables)

    def autoperm(self, g: int) -> np.ndarray:
        """Eval-domain automorphism permutation in this bin order."""
        return automorphism_perm(self.n, g)

    def _sel(self, name: str, rows):
        """Row-subset selection of a table (cached per rows tuple)."""
        if rows is None:
            return getattr(self, name)
        key = (name, tuple(rows))
        if key not in self._sel_cache:
            idx = torch.as_tensor(list(rows), dtype=torch.long,
                                  device=self.device)
            t = getattr(self, name)
            self._sel_cache[key] = (tuple(x[idx] for x in t)
                                    if isinstance(t, tuple) else t[idx])
        return self._sel_cache[key]

    # -- transforms --------------------------------------------------------

    def ntt(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        """Forward negacyclic NTT.  x: [..., R, N] Mont -> [..., R, N] Mont.
        CUDA tensors run kernel K1; CPU tensors run the plain version."""
        if x.is_cuda:
            from .ntt_cuda import ntt_fwd

            return ntt_fwd(self, x.contiguous(), rows)
        return self.ntt_plain(x, rows)

    def intt(self, y: torch.Tensor, rows=None) -> torch.Tensor:
        """Inverse negacyclic NTT.  y: [..., R, N] Mont -> [..., R, N] Mont.
        CUDA tensors run kernel K2; CPU tensors run the plain version."""
        if y.is_cuda:
            from .ntt_cuda import ntt_inv

            return ntt_inv(self, y.contiguous(), rows)
        return self.intt_plain(y, rows)

    def ntt_to_mont(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        """to_mont(ntt(x, rows), rows).  CUDA tensors run kernel K1 with the
        twist table psi^j * R^2; CPU tensors compose the plain calls."""
        if x.is_cuda:
            from .ntt_cuda import ntt_fwd

            return ntt_fwd(self, x.contiguous(), rows, to_mont=True)
        return self.to_mont(self.ntt_plain(x, rows), rows)

    def intt_from_mont(self, y: torch.Tensor, rows=None) -> torch.Tensor:
        """from_mont(intt(y, rows), rows).  CUDA tensors run kernel K2 with
        the untwist table psi^-j * N^-1; CPU tensors compose the plain
        calls."""
        if y.is_cuda:
            from .ntt_cuda import ntt_inv

            return ntt_inv(self, y.contiguous(), rows, from_mont=True)
        return self.from_mont(self.intt_plain(y, rows), rows)

    def folded_tables(self) -> dict:
        """Montgomery-form twist tables [L, N] with the conversion folded in
        (built once): psi_to_mont = psi^j * R^2, so that mont_mul(x, it) =
        to_mont(mont_mul(x, psi)); psi_inv_n_from_mont = psi^-j * N^-1, so
        that mont_mul(x, it) = from_mont(mont_mul(x, psi_inv_n))."""
        if self._folded is None:
            self._folded = {
                "psi_to_mont": self.to_mont(self.psi),
                "psi_inv_n_from_mont": self.from_mont(self.psi_inv_n)}
        return self._folded

    def ntt_plain(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        """Plain torch forward transform (the Stockham loop of the
        reference, `fhe_spear_tpu/core/ntt.py:295-312`)."""
        lead = x.shape[:-2]
        R, n = x.shape[-2:]
        p, pinv = self._sel("p", rows), self._sel("pinv", rows)
        p3, pinv3 = p[:, :, None], pinv[:, :, None]
        fwd_tw = self._sel("fwd_tw", rows)
        x = mont_mul(x, self._sel("psi", rows), p, pinv)
        x = x.reshape(lead + (R, 1, n))
        for s in range(self.logn):
            half = n >> (s + 1)
            lo, hi = x[..., :half], x[..., half:]
            u = add_mod(lo, hi, p3)
            v = mont_mul(sub_mod(lo, hi, p3), fwd_tw[s], p3, pinv3)
            x = torch.stack([u, v], dim=-2).reshape(lead + (R, 2 << s, half))
        return x.reshape(lead + (R, n))

    def intt_plain(self, y: torch.Tensor, rows=None) -> torch.Tensor:
        """Plain torch inverse transform (`fhe_spear_tpu/core/ntt.py:314-330`)."""
        lead = y.shape[:-2]
        R, n = y.shape[-2:]
        p, pinv = self._sel("p", rows), self._sel("pinv", rows)
        p3, pinv3 = p[:, :, None], pinv[:, :, None]
        inv_tw = self._sel("inv_tw", rows)
        x = y.reshape(lead + (R, n, 1))
        for s in range(self.logn - 1, -1, -1):
            half = n >> (s + 1)
            x = x.reshape(lead + (R, 1 << s, 2, half))
            u, v = x[..., 0, :], x[..., 1, :]
            t = mont_mul(v, inv_tw[s], p3, pinv3)
            x = torch.cat([add_mod(u, t, p3), sub_mod(u, t, p3)], dim=-1)
        x = x.reshape(lead + (R, n))
        return mont_mul(x, self._sel("psi_inv_n", rows), p, pinv)

    def to_mont(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        return mont_mul(x, self._sel("r2", rows), self._sel("p", rows),
                        self._sel("pinv", rows))

    def from_mont(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        return mont_reduce_wide(torch.zeros_like(x), x, self._sel("p", rows),
                                self._sel("pinv", rows))
