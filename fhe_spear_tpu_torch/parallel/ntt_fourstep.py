"""Four-step NTT: the matmul formulation of the negacyclic transform.

Counterpart of `fhe_spear_tpu/parallel/ntt_fourstep.py` (single-device
part), with the same tables, the same Montgomery domain and the same
natural four-step bin order, so its outputs equal the reference's word for
word.  With N = N1 x N2:

    view coefficients as X[j1, j2] (j = j1*N2 + j2, twist by psi^j first)
    1. column DFTs   A[k1, j2] = sum_j1 W1[k1, j1] * X[j1, j2]
    2. twiddle       A *= w^(k1*j2)
    3. row DFTs      B[k2, k1] = sum_j2 A[k1, j2] * W2[k2, j2]
    4. bin k = k2*N1 + k1 holds m(psi^(2k+1))

Every product is Montgomery: a contraction returns (sum_k W*X) * R^-1 mod
p, canonical in [0, p).  Output-order contract (checked bitwise in
tests/test_torch_fourstep.py):
    stockham_ntt(x)[b] == fourstep_ntt(x)[bitrev(b)].

Plain versions.  `ntt_mxu_b` / `intt_mxu_b` are the plain torch versions of
the CUDA kernels `fourstep_fwd` / `fourstep_inv` (`core/fourstep_cuda.py`)
and repeat their arithmetic: 4 unsigned 8-bit limbs a residue, the 16
limb-pair products summed into 7 shift groups T_s (s = a + b; every
partial sum below 4 * 128 * 255^2 < 2^25 at K = 128, so the float64 matmul
that forms them is exact on the CPU and on the card, where cuBLAS has no
int64 matmul), then the kernel's epilogue: fold the groups into S =
sum_s T_s * (2^(8s) mod p) < 2^32 p and reduce it with one Montgomery
REDC.  The result is the unique canonical value congruent to (sum W*X) *
R^-1, so it equals the reference's 7-bit limbs and 9 mont_mul
recombination word for word.  `FourStepBackend.ntt` / `intt` launch the kernels for a CUDA tensor
and run the plain versions for a CPU tensor.

Sharded (`FourStepNtt.ntt_sharded`, the reference's `_sharded_fn`): the
input is sharded on j2 over a rank group, each rank runs its column DFTs
and twiddle, one `all_to_all` flips the shard axis, and each rank runs its
row DFTs; the output is sharded on k1.  The reference computes it in XLA,
outside any Pallas kernel, so the port runs the exact torch contraction
`_matmul_mod` (elementwise Montgomery products and an int64 sum: there is
no int64 `torch.matmul` on CUDA).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.modops import MASK32, mont_mul, mont_reduce_wide
from ..core.ntt import NttContext, bitrev_indices

__all__ = ["FourStepNtt", "FourStepBackend"]


def _pow_mod(base: int, e: np.ndarray, p: int) -> np.ndarray:
    out = np.ones_like(e, dtype=object)
    b = base % p
    bit = 0
    while (1 << bit) <= int(e.max(initial=0)):
        mask = (e >> bit) & 1
        out = np.where(mask == 1, out * b % p, out)
        b = b * b % p
        bit += 1
    return out.astype(np.uint64)


LIMBS = 4                       # unsigned 8-bit limbs of a 32-bit word
GROUPS = 2 * LIMBS - 1          # shift groups 2^(8s), s = 0..6


def _limbs8(w: np.ndarray) -> np.ndarray:
    """uint32 [L, M, K] -> 8-bit limbs [L, 4, M, K] uint8, limb a holding
    bits 8a..8a+7."""
    out = np.stack([(w >> np.uint32(8 * a)) & np.uint32(0xFF)
                    for a in range(LIMBS)], axis=1)
    return out.astype(np.uint8)


def shift_groups(a8: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """a8: [R, 4, M, K] 8-bit limbs, x: [R, K, J] words < 2^32 -> the shift
    groups T [R, 7, M, J] int64, T_s = sum_{a+b=s} sum_k a8[a] * limb_b(x),
    so that sum_k A[m, k] * x[k, j] = sum_s T_s 2^(8s).  One [R, 4M, K] x
    [R, K, 4J] float64 matmul; every entry is below 4 * K * 255^2 < 2^25
    for K <= 128 (exact in float64, and in the kernel's int32)."""
    r, _, m, k = a8.shape
    j = x.shape[-1]
    xb = torch.stack([(x >> (8 * b)) & 0xFF for b in range(LIMBS)],
                     dim=1)                              # [R, 4, K, J]
    A = a8.reshape(r, LIMBS * m, k).to(torch.float64)
    X = xb.transpose(1, 2).reshape(r, k, LIMBS * j).to(torch.float64)
    S = torch.bmm(A, X).to(torch.int64).reshape(r, LIMBS, m, LIMBS, j)
    groups = []
    for s in range(GROUPS):
        lo_a = max(0, s - LIMBS + 1)
        T = S[:, lo_a, :, s - lo_a, :]
        for a in range(lo_a + 1, min(s, LIMBS - 1) + 1):
            T = T + S[:, a, :, s - a, :]
        groups.append(T)
    return torch.stack(groups, dim=1)


def fold_reduce(T: torch.Tensor, p, pinv, dsh) -> torch.Tensor:
    """The kernel's epilogue: (sum_s T_s 2^(8s)) * 2^-32 mod p, canonical.
    T: [R, 7, M, J] (T_s < 2^25); p, pinv: [R, 1, 1]; dsh: [R, 7, 1, 1],
    2^(8s) mod p.  S = sum_s T_s * dsh_s is below 7 * 2^25 * p < 2^32 p, so
    one REDC of S makes it canonical."""
    S = (T * dsh).sum(dim=1)
    return mont_reduce_wide(S >> 32, S & MASK32, p, pinv)


class FourStepNtt:
    """Matmul-form negacyclic NTT for a fixed (NttContext, N1, N2).

    ntt(x, rows):      [..., R, N] Mont -> [..., R, N] Mont, four-step
                       natural order (use bitrev to match core/ntt.py).
    ntt_mxu_b / intt_mxu_b: [R, B, N] limb-contraction forms, the plain
                       versions of the CUDA kernels.
    """

    def __init__(self, ntt: NttContext, n1: int, n2: int):
        assert n1 * n2 == ntt.n, (n1, n2, ntt.n)
        self.base = ntt
        self.n1, self.n2 = n1, n2
        self.device = ntt.device
        n = ntt.n
        L = len(ntt.primes)
        w1 = np.zeros((L, n1, n1), dtype=np.uint32)
        w2 = np.zeros((L, n2, n2), dtype=np.uint32)
        tw = np.zeros((L, n1, n2), dtype=np.uint32)
        w1i = np.zeros((L, n1, n1), dtype=np.uint32)
        w2i = np.zeros((L, n2, n2), dtype=np.uint32)
        twi = np.zeros((L, n2, n1), dtype=np.uint32)
        k1j1 = np.outer(np.arange(n1), np.arange(n1)) * n2 % n
        k2j2 = np.outer(np.arange(n2), np.arange(n2)) * n1 % n
        k1j2 = np.outer(np.arange(n1), np.arange(n2)) % n
        for li, pr in enumerate(ntt.primes):
            p = pr.p
            mont = lambda t: (t * pr.mont_r % p).astype(np.uint32)
            omega = pr.root * pr.root % p          # psi^2, order n
            w1[li] = mont(_pow_mod(omega, k1j1, p))
            w2[li] = mont(_pow_mod(omega, k2j2, p))
            tw[li] = mont(_pow_mod(omega, k1j2, p))
            # inverse direction: x[j1,j2] = psi^-j/n * sum_{k1,k2}
            #   X[k2,k1] w^-(j2 k2 N1) w^-(j2 k1) w^-(j1 k1 N2)
            oinv = pow(omega, -1, p)
            w1i[li] = mont(_pow_mod(oinv, k1j1, p))
            w2i[li] = mont(_pow_mod(oinv, k2j2, p))
            twi[li] = mont(_pow_mod(oinv, k1j2.T, p))

        dev = self.device
        i64 = lambda a: torch.as_tensor(a.astype(np.int64), device=dev)
        u8 = lambda a: torch.as_tensor(a, device=dev)
        self.w1, self.w2, self.tw = i64(w1), i64(w2), i64(tw)   # Mont
        self.w1i, self.w2i, self.twi = i64(w1i), i64(w2i), i64(twi)
        # DFT matrices as 8-bit limbs: [L, 4, M, K] uint8
        self.w1_8, self.w2_8 = u8(_limbs8(w1)), u8(_limbs8(w2))
        self.w1i_8, self.w2i_8 = u8(_limbs8(w1i)), u8(_limbs8(w2i))
        # the epilogue's shift constants 2^(8s) mod p: [L, 7]
        self.dsh = i64(np.array([[(1 << (8 * s)) % pr.p
                                  for s in range(GROUPS)]
                                 for pr in ntt.primes]))
        # bin b of the Stockham output = four-step bin bitrev(b)
        self.to_stockham = torch.as_tensor(bitrev_indices(n), device=dev)
        self._sel_cache: dict = {}
        self.kernel_tables = None        # device tables of core/fourstep_cuda

    # -- row selection -----------------------------------------------------

    def _sel(self, t: torch.Tensor, rows) -> torch.Tensor:
        """Rows `rows` of a per-limb table (the whole table for None)."""
        if rows is None:
            return t
        key = tuple(int(r) for r in rows)
        idx = self._sel_cache.get(key)
        if idx is None:
            idx = torch.as_tensor(key, dtype=torch.long, device=self.device)
            self._sel_cache[key] = idx
        return t.index_select(0, idx)

    def _sel_np(self, rows, which):
        """p ("p") or mont_pinv ("pinv") of the selected limbs, [R, 1]: the
        reference builds them from numpy, the port takes the wrapped
        context's cached device tables."""
        return self.base._sel(which, rows)

    # -- modular matmul: sum_k A[i,k] * X[..., k, j] -----------------------

    @staticmethod
    def _matmul_mod(a, x, p, pinv):
        """a: [R, M, K] Mont, x: [..., R, K, J] Mont -> [..., R, M, J].

        Every partial product is a Montgomery product (the reference's
        mont_mul tree); the K canonical terms (< 2^31 each) are summed
        exactly in int64 and reduced once, which gives the tree's words."""
        prod = mont_mul(a[..., None], x[..., None, :, :], p[..., None],
                        pinv[..., None])           # [..., R, M, K, J]
        return prod.sum(dim=-2) % p

    # -- limb contraction: the kernels' arithmetic, exact -----------------

    def _matmul_mod_mxu(self, a8, x, p, pinv, dsh):
        """a8: [R, 4, M, K] uint8, x: [R, K, J] int64 -> [R, M, J] int64,
        (sum_k A[m, k] * x[k, j]) * R^-1 mod p (see shift_groups and
        fold_reduce)."""
        return fold_reduce(shift_groups(a8, x), p[..., None],
                           pinv[..., None], dsh[..., None, None])

    # -- batched variants: [R, B, N] with the batch riding the J axis ------

    def ntt_mxu_b(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        """[R, B, N] Mont coefficients -> [R, B, N] four-step bins (the
        plain version of kernel `fourstep_fwd`)."""
        n1, n2 = self.n1, self.n2
        r, bsz, n = x.shape
        p, pinv = self._sel_np(rows, "p"), self._sel_np(rows, "pinv")
        dsh = self._sel(self.dsh, rows)
        p2, pinv2 = p[..., None], pinv[..., None]               # [R, 1, 1]
        x = mont_mul(x, self.base._sel("psi", rows)[:, None], p2, pinv2)
        xt = x.reshape(r, bsz, n1, n2).transpose(1, 2).reshape(
            r, n1, bsz * n2)
        a = self._matmul_mod_mxu(self._sel(self.w1_8, rows), xt, p, pinv,
                                 dsh)                           # [R, k1, B*j2]
        a = mont_mul(a.reshape(r, n1, bsz, n2),
                     self._sel(self.tw, rows)[:, :, None, :],
                     p2[..., None], pinv2[..., None])
        at = a.permute(0, 3, 2, 1).reshape(r, n2, bsz * n1)    # [R, j2, B*k1]
        b = self._matmul_mod_mxu(self._sel(self.w2_8, rows), at, p, pinv,
                                 dsh)                           # [R, k2, B*k1]
        return b.reshape(r, n2, bsz, n1).transpose(1, 2).reshape(
            r, bsz, n)                                          # k = k2*N1+k1

    def intt_mxu_b(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        """[R, B, N] four-step bins -> [R, B, N] Mont coefficients (the
        plain version of kernel `fourstep_inv`)."""
        n1, n2 = self.n1, self.n2
        r, bsz, n = x.shape
        p, pinv = self._sel_np(rows, "p"), self._sel_np(rows, "pinv")
        dsh = self._sel(self.dsh, rows)
        p2, pinv2 = p[..., None], pinv[..., None]
        xt = x.reshape(r, bsz, n2, n1).transpose(1, 2).reshape(
            r, n2, bsz * n1)                                    # [R, k2, B*k1]
        a = self._matmul_mod_mxu(self._sel(self.w2i_8, rows), xt, p, pinv,
                                 dsh)                           # [R, j2, B*k1]
        a = mont_mul(a.reshape(r, n2, bsz, n1),
                     self._sel(self.twi, rows)[:, :, None, :],
                     p2[..., None], pinv2[..., None])
        at = a.permute(0, 3, 2, 1).reshape(r, n1, bsz * n2)    # [R, k1, B*j2]
        b = self._matmul_mod_mxu(self._sel(self.w1i_8, rows), at, p, pinv,
                                 dsh)                           # [R, j1, B*j2]
        b = b.reshape(r, n1, bsz, n2).transpose(1, 2).reshape(r, bsz, n)
        return mont_mul(b, self.base._sel("psi_inv_n", rows)[:, None], p2,
                        pinv2)

    # -- the mont_mul-tree form ---------------------------------------------

    def ntt(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        """[..., R, N] Mont -> [..., R, N] Mont, four-step order."""
        n1, n2 = self.n1, self.n2
        p, pinv = self._sel_np(rows, "p"), self._sel_np(rows, "pinv")
        x = mont_mul(x, self.base._sel("psi", rows), p, pinv)   # twist
        lead = x.shape[:-1]
        x = x.reshape(lead + (n1, n2))
        p2, pinv2 = p[..., None], pinv[..., None]
        a = self._matmul_mod(self._sel(self.w1, rows), x, p2, pinv2)
        a = mont_mul(a, self._sel(self.tw, rows), p2, pinv2)
        # row DFT: contract over j2, so j2 goes to the K slot
        b = self._matmul_mod(self._sel(self.w2, rows), a.transpose(-1, -2),
                             p2, pinv2)
        return b.reshape(lead + (self.base.n,))                 # k2*N1 + k1

    def ntt_stockham_order(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        """Four-step NTT permuted to match core/ntt.py bitwise."""
        return self.ntt(x, rows).index_select(-1, self.to_stockham)

    # -- sharded: j2-sharded input, ONE all-to-all, k1-sharded output ------

    def shard_j2(self, x: torch.Tensor, group) -> torch.Tensor:
        """This rank's j2 columns [R, N1, N2/size] of coefficients [R, N]."""
        m = self.n2 // group.size
        x = x.reshape(x.shape[:-1] + (self.n1, self.n2))
        return x[..., group.rank * m:(group.rank + 1) * m]

    def gather_k1(self, b: torch.Tensor, group) -> torch.Tensor:
        """Every rank's k1 columns [R, N2, N1/size] -> bins [R, N] (bin
        k = k2*N1 + k1)."""
        from .collectives import all_gather

        g = all_gather(b, group)                       # [size, R, N2, n1loc]
        g = g.permute(1, 2, 0, 3)                      # [R, N2, size, n1loc]
        return g.reshape(b.shape[0], self.base.n)

    def ntt_sharded(self, x: torch.Tensor, group, rows=None) -> torch.Tensor:
        """x [R, N1, N2/size] Mont, this rank's j2 columns -> [R, N2,
        N1/size] Mont, its k1 columns of the four-step bins: local column
        DFTs and twiddle, one all_to_all, local row DFTs."""
        from .collectives import all_to_all

        n1, n2, size = self.n1, self.n2, group.size
        assert n1 % size == 0 and n2 % size == 0, (n1, n2, size)
        j2 = slice(group.rank * (n2 // size), (group.rank + 1) * (n2 // size))
        p, pinv = self._sel_np(rows, "p"), self._sel_np(rows, "pinv")
        p2, pinv2 = p[..., None], pinv[..., None]
        psi = self.base._sel("psi", rows).reshape(-1, n1, n2)[..., j2]
        x = mont_mul(x, psi, p2, pinv2)
        a = self._matmul_mod(self._sel(self.w1, rows), x, p2, pinv2)
        a = mont_mul(a, self._sel(self.tw, rows)[..., j2], p2, pinv2)
        # [R, k1, j2loc] -> [dest, R, j2loc, k1loc]: k1 block d to rank d
        r = a.shape[0]
        a = a.transpose(-1, -2).reshape(r, n2 // size, size, n1 // size)
        a = all_to_all(a.permute(2, 0, 1, 3).contiguous(), group)
        # [src, R, j2loc, k1loc] -> [R, j2 (src-major = global), k1loc]
        a = a.permute(1, 0, 2, 3).reshape(r, n2, n1 // size)
        return self._matmul_mod(self._sel(self.w2, rows), a, p2, pinv2)


class FourStepBackend:
    """NttContext-compatible transform backend in NATURAL bin order.

    Drop-in for CkksContext (params.ntt_backend="mxu"): ntt/intt (and
    ntt_to_mont/intt_from_mont) run the four-step transform (kernels
    `fourstep_fwd` / `fourstep_inv` for a CUDA tensor, the plain limb
    contraction for a CPU tensor); every other
    attribute (p, pinv, r2, to_mont, from_mont, tables, ...) delegates to
    the wrapped Stockham NttContext.  Bin b holds m(psi^(2b+1)), so
    automorphism permutations come from autoperm() below, and a context on
    this backend is self-consistent but not binary-compatible with a
    Stockham context (coefficient-domain data is shared).
    """

    order = "natural"

    def __init__(self, base: NttContext, n1: int | None = None):
        n = base.n
        if n1 is None:
            n1 = 128 if n >= 16384 else max(16, min(64, n // 64))
        self.base = base
        self.fs = FourStepNtt(base, n1, n // n1)

    def __getattr__(self, name):
        if name in ("base", "fs"):            # not set yet (copy/unpickle)
            raise AttributeError(name)
        return getattr(self.base, name)

    def _flat(self, fn, x, rows):
        lead = x.shape[:-2]
        r, n = x.shape[-2:]
        x2 = x.reshape((-1, r, n)) if lead else x[None]
        y = fn(x2.transpose(0, 1), rows).transpose(0, 1)        # [B, R, N]
        return y.reshape(lead + (r, n)) if lead else y[0]

    def ntt(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        """[..., R, N] Mont coefficients -> natural-order bins.  CUDA
        tensors run kernel fourstep_fwd; CPU tensors the plain version."""
        if x.is_cuda:
            from ..core.fourstep_cuda import fourstep_fwd

            return fourstep_fwd(self.fs, x.contiguous(), rows)
        return self.ntt_plain(x, rows)

    def intt(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        """Inverse of ntt.  CUDA tensors run kernel fourstep_inv; CPU
        tensors the plain version."""
        if x.is_cuda:
            from ..core.fourstep_cuda import fourstep_inv

            return fourstep_inv(self.fs, x.contiguous(), rows)
        return self.intt_plain(x, rows)

    def ntt_to_mont(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        """to_mont(ntt(x, rows), rows).  CUDA tensors run kernel
        fourstep_fwd with the twist table psi^j * R^2; CPU tensors compose
        the plain calls."""
        if x.is_cuda:
            from ..core.fourstep_cuda import fourstep_fwd

            return fourstep_fwd(self.fs, x.contiguous(), rows, to_mont=True)
        return self.base.to_mont(self.ntt_plain(x, rows), rows)

    def intt_from_mont(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        """from_mont(intt(x, rows), rows).  CUDA tensors run kernel
        fourstep_inv with the untwist table psi^-j * N^-1; CPU tensors
        compose the plain calls."""
        if x.is_cuda:
            from ..core.fourstep_cuda import fourstep_inv

            return fourstep_inv(self.fs, x.contiguous(), rows, from_mont=True)
        return self.base.from_mont(self.intt_plain(x, rows), rows)

    def ntt_plain(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        rows = tuple(rows) if rows is not None else None
        return self._flat(self.fs.ntt_mxu_b, x, rows)

    def intt_plain(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        rows = tuple(rows) if rows is not None else None
        return self._flat(self.fs.intt_mxu_b, x, rows)

    def autoperm(self, g: int) -> np.ndarray:
        """NTT(m(X^g))[b] = NTT(m)[perm[b]] in natural bin order:
        exponent of bin b is 2b+1; source bin = ((2b+1)g mod 2n - 1)/2."""
        n = self.base.n
        t = (2 * np.arange(n, dtype=np.int64) + 1) * g % (2 * n)
        return ((t - 1) // 2).astype(np.int64)
