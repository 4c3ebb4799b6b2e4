"""CKKS context: parameters, keys, and the homomorphic operations of the
client-aided path.

Counterpart of `fhe_spear_tpu/ckks/context.py` (main-path subset).  Every
residue tensor is [..., limb, N] int64 in NTT domain + Montgomery form,
canonical in [0, p); operations are plain torch functions on those
tensors, and every transform goes through `NttContext.ntt`/`intt` (the
CUDA kernels on the card, the plain torch loop on the CPU).

  * Keyswitching is GHS/hybrid with K special primes: the same key tensor
    works at every level and the digit * key contraction is one
    multiply-accumulate over the digit axis.  Digits are single limbs
    (decomposition is a centered re-reduction) or, with `dnum`, groups of
    `gsize` limbs (decomposition is a fast base conversion with a 32-bit
    fixed-point centring, `_fbc_digits`).
  * Decryption never needs multiprecision CRT: the message magnitude is
    kept below q0/2, so the first one or two limbs of c0 + c1*s determine
    the value exactly.

Key identities (decrypt = c0 + c1*s):
  symmetric encrypt:  c1 = a (uniform),  c0 = -a*s + m + e
  keyswitch digit j:  ksk_j = (-a_j*s + e_j + P*g_j*s', a_j) over Q*P,
      where g_j is (P mod q_i) on the limbs i of digit j, 0 elsewhere.
  switched ct adds (sum_j D_j * ksk_j) / P  with D_j the centered
      re-reduction of the source polynomial's limb j (single-limb digits)
      or the fast base conversion of its limb group j.

Montgomery bookkeeping: ciphertexts/plaintexts are Mont-form (x*R).
Keyswitch keys are stored in R^2 form so that mont_mul(plain_digit, key)
lands back in Mont form; scalar constants that multiply Mont values
(P^-1, q_l^-1) are stored in Mont form (c*R).

All key and noise randomness is drawn on the host from
`np.random.RandomState(seed)` in the reference's draw order -- secret key,
relin key (uniform, then gauss), then Galois keys in sorted order in
chunks of 16 -- so a seeded context holds the reference's keys bit for
bit.  Sums of canonical residues are taken exactly in int64 and reduced
once (`% p`), which gives the same canonical word as the reference's
chains of modular adds.

`shard_eval_keys(group)` partitions the evaluation keys on their limb-row
axis over a rank group (`parallel.limb_sharded.KeyShard`): every keyswitch
then extends its digits to this rank's key rows only, contracts them with
those rows, gathers the special rows for the mod-down and all-gathers the
output limb rows (`_keyswitch`), so that the result is the replicated
ciphertext of the unsharded context, word for word.  The reference's
`NamedSharding` argument becomes a `parallel.collectives.RankGroup`.

`key_epoch` counts replacements of the key material (`set_secret_key`,
`utils.serialization.load_eval_keys`); `ops.bsgs.BsgsMatvec` compares it
with the epoch of its key stacks and rebuilds them when they are older.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..core.modops import (
    MASK32, add_mod, barrett_reduce, cond_sub, mont_mul, mul_hi_u32,
    mul_lo_u32, neg_mod, sub_mod,
)
from ..core.ntt import NttContext, require_device
from ..core.primes import Prime, find_ntt_primes
from ..parallel.ntt_fourstep import FourStepBackend
from ..utils.profiling import span
from .ciphertext import Ciphertext, Plaintext
from .encoding import SlotEncoder

__all__ = ["CkksParams", "CkksContext", "KeySwitchKey"]


@dataclass(frozen=True)
class CkksParams:
    """CKKS parameter preset.

    n:            ring dimension (power of two; n/2 complex slots).
    num_limbs:    total scale limbs L (q0 plus L-1 rescale primes);
                  fresh ciphertexts start at level L.
    num_special:  K special (keyswitch) primes.
    scale_bits:   log2 of the default scale (rescale primes sit near it).
    secret_hamming_weight: sparse ternary secret weight; None = dense.
    dnum:         hybrid-keyswitch digit count: groups of ceil(L/dnum) limbs
                  (needs P = prod(special primes) >= every group product);
                  None = one digit per limb.
    ntt_backend:  "stockham" or "pallas" -- in the port both name the same
                  bit-reversed transform, run by kernels K1/K2 on the card;
                  "mxu": the four-step transform in natural bin order
                  (`parallel/ntt_fourstep.FourStepBackend`), run by kernels
                  fourstep_fwd/fourstep_inv on the card.
    """

    n: int
    num_limbs: int
    num_special: int = 1
    scale_bits: int = 28
    first_bits: int = 31
    noise_sigma: float = 3.2
    secret_hamming_weight: int | None = None
    dnum: int | None = None
    ntt_backend: str = "stockham"

    @property
    def scale(self) -> float:
        return float(2.0 ** self.scale_bits)

    # Max log2(Q*P) for 128-bit classical security with a ternary secret,
    # per the homomorphicencryption.org standard tables.
    _LOGQP_128BIT = {1024: 27, 2048: 54, 4096: 109, 8192: 218,
                     16384: 438, 32768: 881}

    @property
    def log_qp(self) -> int:
        """Approximate total modulus bits log2(Q*P): q0 (~first_bits) +
        (L-1) scale primes (~scale_bits) + K special primes (~31 bits)."""
        return (self.first_bits + (self.num_limbs - 1) * self.scale_bits
                + 31 * self.num_special)

    def security_statement(self) -> str:
        """Security classification of this parameter set: "standard-128"
        when log2(QP) is within the 128-bit ceiling for this N with a
        dense ternary secret, "research-grade" otherwise."""
        ceiling = self._LOGQP_128BIT.get(self.n)
        lqp = self.log_qp
        if ceiling is not None and lqp <= ceiling \
                and self.secret_hamming_weight is None:
            return (f"standard-128: log2(QP)~{lqp} <= {ceiling} "
                    f"(128-bit ceiling at N={self.n}, dense ternary secret)")
        reasons = []
        if ceiling is None or lqp > ceiling:
            reasons.append(f"log2(QP)~{lqp} > {ceiling} "
                           f"(128-bit ceiling at N={self.n})")
        if self.secret_hamming_weight is not None:
            reasons.append(f"sparse secret h={self.secret_hamming_weight} "
                           "(below dense-ternary table assumptions)")
        return "research-grade: " + "; ".join(reasons)

    @classmethod
    def retrieval(cls, n: int = 8192) -> "CkksParams":
        """CT-PT/CT-CT retrieval: one multiply + rescale (standard-128 at
        N=8192)."""
        return cls(n=n, num_limbs=3, num_special=1)

    @classmethod
    def client_aided(cls, n: int = 8192) -> "CkksParams":
        """1-level BSGS round trips, N=8192, L=3, K=1 (standard-128)."""
        return cls(n=n, num_limbs=3, num_special=1)

    @classmethod
    def deep(cls, n: int, depth: int, num_special: int = 1) -> "CkksParams":
        """Fully-encrypted chains: depth limbs + q0 (research-grade at
        production depths)."""
        return cls(n=n, num_limbs=depth + 1, num_special=num_special)

    @classmethod
    def bootstrap(cls, n: int, num_limbs: int = 22, num_special: int = 2,
                  hamming: int = 64, dnum: int | None = None) -> "CkksParams":
        """Bootstrappable: sparse secret + deep chain (research-grade)."""
        return cls(n=n, num_limbs=num_limbs, num_special=num_special,
                   secret_hamming_weight=hamming, dnum=dnum)


class KeySwitchKey:
    """b, a: [dnum, L+K, N] int64, NTT domain, R^2 form (digit, limb,
    coeff); dnum = L when digits are single limbs."""

    def __init__(self, b: torch.Tensor, a: torch.Tensor):
        self.b = b
        self.a = a


class CkksContext:
    """Keys + tables + homomorphic ops for one parameter set on one device.

    The API mirrors the reference's: encrypt / encrypt_replicated[_complex]
    / decrypt_vec[_complex] / add / sub / negate / add_plain / mul_plain /
    mul_scalar / multiply (+ relin) / rescale / mod_drop / rotate /
    conjugate / hoisted_rotations.
    """

    def __init__(self, params: CkksParams, seed: int | None = None,
                 sk_coeff: np.ndarray | None = None, device="cuda"):
        """seed=None (the default) draws all key/noise randomness from OS
        entropy; pass an explicit integer seed ONLY for reproducible tests
        and benchmarks -- a seeded context is deterministic and therefore
        NOT confidential.  sk_coeff restores a saved secret key; the
        relinearization key is regenerated from it.  device: "cuda" (the
        default) or "cpu"; "cuda" without a card raises."""
        if params.ntt_backend not in ("stockham", "pallas", "mxu"):
            raise ValueError(f"unknown ntt_backend {params.ntt_backend!r}")
        self.device = require_device(device)
        self.params = params
        self.n = params.n
        self.slots = params.n // 2
        self.L = params.num_limbs
        self.K = params.num_special
        self.scale = params.scale
        self.primes: tuple[Prime, ...] = find_ntt_primes(
            params.n, params.num_limbs, params.scale_bits, params.first_bits,
            params.num_special,
        )
        self.ntt = NttContext.build(params.n, self.primes, self.device)
        if params.ntt_backend == "mxu":
            self.ntt = FourStepBackend(self.ntt)
        self.encoder = SlotEncoder(params.n)
        if seed is None:
            ss = np.random.SeedSequence(
                int.from_bytes(os.urandom(16), "little"))
            self.rng = np.random.RandomState(np.random.MT19937(ss))
        else:
            self.rng = np.random.RandomState(seed)
        self.seeded = seed is not None

        LK = self.L + self.K
        q = np.array([pr.p for pr in self.primes], dtype=np.uint64)
        self.q_np = q
        P = 1
        for pr in self.primes[self.L:]:
            P *= pr.p
        self.P_int = P

        # hybrid-keyswitch digit grouping: gsize limbs per digit
        self.dnum = params.dnum if params.dnum else self.L
        assert 1 <= self.dnum <= self.L, (self.dnum, self.L)
        self.gsize = -(-self.L // self.dnum)
        self.digit_of_limb = np.arange(self.L) // self.gsize
        self.dnum = int(self.digit_of_limb[-1]) + 1  # actual digit count
        if self.gsize > 1:
            # keyswitch noise ~ sigma*sqrt(dnum*N)*Q_j/P: require P >= Q_j
            for j in range(self.dnum):
                qj = 1
                for i in range(j * self.gsize,
                               min((j + 1) * self.gsize, self.L)):
                    qj *= int(q[i])
                assert P >= qj, (
                    f"digit group {j} product ({qj.bit_length()} bits) "
                    f"exceeds P ({P.bit_length()} bits): raise num_special "
                    f"or dnum")

        dev = self.device
        i64 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.int64),
                                        device=dev)
        r_of = lambda i: self.primes[i].mont_r

        # Barrett magic per prime: floor(2^32 / p)
        self.mu = i64(((1 << 32) // q)[:, None].astype(np.int64))
        # 2^32 mod p, Montgomery form: the high word of a 64-bit random
        # draw (`models.client_aided._uniform_mod`), uploaded once
        self.t32_mont = i64([(1 << 32) % int(q[i]) * r_of(i) % int(q[i])
                             for i in range(len(q))])[:, None]
        # centered-extension tables: q_s mod q_t and (q_s+1)//2
        qmod = np.zeros((LK, LK), dtype=np.uint64)
        for s in range(LK):
            qmod[s] = q[s] % q
        self.q_mod = i64(qmod[:, :, None].astype(np.int64))    # [S, T, 1]
        self.q_half = i64(((q + 1) // 2)[:, None, None].astype(np.int64))

        # keyswitch mod-down constants
        self.Pinv_mont = i64(
            [pow(P % int(q[i]), -1, int(q[i])) * r_of(i) % int(q[i])
             for i in range(self.L)])[:, None]
        self.Pmod_mont = i64(
            [P % int(q[j]) * r_of(j) % int(q[j]) for j in range(self.L)]
        )[:, None]
        if self.K > 1:
            phat = [P // int(q[self.L + k]) for k in range(self.K)]
            self.phat_inv_mont = i64(
                [pow(phat[k] % int(q[self.L + k]), -1, int(q[self.L + k]))
                 * r_of(self.L + k) % int(q[self.L + k])
                 for k in range(self.K)])[:, None]
            self.phat_mod_mont = i64(
                [[phat[k] % int(q[i]) * r_of(i) % int(q[i])
                  for i in range(self.L)] for k in range(self.K)])[:, :, None]
            # centered-CRT fixed-point constants: v = round(sum_k y_k / p_k)
            self._sp_muA = i64([(1 << 32) // int(q[self.L + k])
                                for k in range(self.K)])[:, None]
            self._sp_B64 = i64([((1 << 64) // int(q[self.L + k])) & MASK32
                                for k in range(self.K)])[:, None]

        # rescale constants: (q_l^-1 mod q_i) * R, lower-triangular [L, L]
        qlinv = np.zeros((self.L, self.L), dtype=np.int64)
        for l in range(1, self.L):
            for i in range(l):
                qlinv[l, i] = (pow(int(q[l]), -1, int(q[i])) * r_of(i)
                               % int(q[i]))
        self._qlinv = i64(qlinv)
        self._idx_cache: dict = {}
        self._perm_cache: dict = {}
        self._digit_cache: dict = {}
        # limb-row layout of the eval keys once shard_eval_keys ran
        self._key_shard = None

        # --- keys (host draw order of the reference) ---
        h = params.secret_hamming_weight
        if sk_coeff is not None:
            self._sk_coeff = np.asarray(sk_coeff, dtype=np.int64)
            assert self._sk_coeff.shape == (self.n,)
        elif h is None:
            self._sk_coeff = self.rng.randint(-1, 2, size=self.n
                                              ).astype(np.int64)
        else:
            self._sk_coeff = np.zeros(self.n, dtype=np.int64)
            pos = self.rng.choice(self.n, size=h, replace=False)
            self._sk_coeff[pos] = self.rng.choice([-1, 1], size=h)
        self.s_eval = self._to_eval_mont(self._sk_coeff, tuple(range(LK)))
        self.relin_key: KeySwitchKey = self._make_ksk(
            mont_mul(self.s_eval, self.s_eval, self.ntt.p, self.ntt.pinv))
        self.galois_keys: dict[int, KeySwitchKey] = {}
        # bumped whenever the key material is replaced (set_secret_key,
        # utils.serialization.load_eval_keys): an engine holding stacked
        # copies of the keys rebuilds them when its epoch is older
        self.key_epoch = 0

    def set_secret_key(self, sk_coeff: np.ndarray) -> None:
        """Install a restored secret key on a (possibly warm) context: the
        relinearization key is regenerated from it (uniform, then gauss,
        from the context's generator, as the reference draws), the Galois
        keys and the identity key are cleared (callers re-run
        ensure_galois), and the key epoch is bumped so that engines
        rebuild their key stacks.  Prefer a fresh
        CkksContext(params, sk_coeff=...) where possible."""
        sk = np.asarray(sk_coeff, dtype=np.int64)
        if sk.shape != (self.n,):
            raise ValueError(f"secret key of shape {sk.shape}, expected "
                             f"({self.n},)")
        self._sk_coeff = sk
        self.s_eval = self._to_eval_mont(sk, tuple(range(self.L + self.K)))
        self.galois_keys.clear()
        self.__dict__.pop("_identity_ksk", None)
        self.relin_key = self._make_ksk(
            mont_mul(self.s_eval, self.s_eval, self.ntt.p, self.ntt.pinv))
        self.key_epoch += 1

    # ------------------------------------------------------------------
    # small host/device helpers
    # ------------------------------------------------------------------

    def _idx(self, rows) -> torch.Tensor:
        """Cached device index tensor of a row tuple."""
        key = tuple(int(r) for r in rows)
        t = self._idx_cache.get(key)
        if t is None:
            t = torch.tensor(key, dtype=torch.long, device=self.device)
            self._idx_cache[key] = t
        return t

    def _sel(self, table: torch.Tensor, rows) -> torch.Tensor:
        return table.index_select(0, self._idx(rows))

    def perm(self, g: int) -> torch.Tensor:
        """Cached device automorphism permutation for Galois element g."""
        t = self._perm_cache.get(g)
        if t is None:
            t = torch.as_tensor(self.ntt.autoperm(g), dtype=torch.long,
                                device=self.device)
            self._perm_cache[g] = t
        return t

    def _p(self, l):
        """(p, pinv) of the first l limbs, [l, 1] device tensors."""
        return self.ntt.p[:l], self.ntt.pinv[:l]

    def _rows(self, table: torch.Tensor, rows, dim: int = 0) -> torch.Tensor:
        """Rows `rows` of a per-limb table along `dim`: a slice where they
        are contiguous (every unsharded call), a gather otherwise."""
        r0 = rows[0] if rows else 0
        if tuple(rows) == tuple(range(r0, r0 + len(rows))):
            return table.narrow(dim, r0, len(rows))
        return table.index_select(dim, self._idx(rows))

    def _reduce_rows(self, coeffs: np.ndarray, rows) -> np.ndarray:
        """Centered int64 coefficients [..., N] -> residues [..., R, N]."""
        q = self.q_np[list(rows)].astype(np.int64)
        return coeffs[..., None, :] % q[:, None]

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, dtype=np.int64),
                               device=self.device)

    def _to_eval_mont(self, coeffs: np.ndarray, rows: tuple) -> torch.Tensor:
        """Centered integer coefficients -> device eval/Mont tensor [R, N]."""
        res = self._tensor(self._reduce_rows(coeffs, rows))
        return self.ntt.ntt_to_mont(res, rows)

    def _uniform(self, shape_rows, rows) -> np.ndarray:
        """Uniform residues mod q_rows, shape [..., R, N] (R = len(rows))."""
        q = self.q_np[list(rows)]
        return self.rng.randint(
            0, q[:, None], size=shape_rows + (len(rows), self.n)
        ).astype(np.int64)

    def _gauss(self, shape=()) -> np.ndarray:
        return np.round(
            self.rng.normal(0.0, self.params.noise_sigma, shape + (self.n,))
        ).astype(np.int64)

    def targets(self, l: int) -> tuple:
        """Active limb rows during keyswitch at level l: scale limbs + specials."""
        return tuple(range(l)) + tuple(range(self.L, self.L + self.K))

    def _ks_targets(self, l: int) -> tuple:
        """The target rows this process extends digits to at level l: all of
        `targets(l)`, or this rank's share once the keys are sharded."""
        if self._key_shard is None:
            return self.targets(l)
        return self._key_shard.targets(l)

    def _key_rows(self, l: int) -> tuple:
        """Indices of `_ks_targets(l)` into the row axis of the stored keys."""
        if self._key_shard is None:
            return self.targets(l)
        return self._key_shard.key_rows(l)

    def shard_eval_keys(self, group) -> None:
        """Partition every evaluation key (relin, Galois, identity, and the
        ones made later) on its limb-row axis over the rank group `group`:
        the [dnum, L+K, N] keys are zero-padded to a multiple of the group
        size (pad rows are never targets) and each rank keeps its
        contiguous block of rows, so that key memory divides by the size.
        Keyswitches then run the explicit limb-sharded path (`_keyswitch`),
        whose replicated results equal the unsharded context's word for
        word.  The key epoch is bumped, so that engines rebuild their key
        stacks from the rank's rows."""
        from ..parallel.limb_sharded import KeyShard

        if self._key_shard is not None:
            raise ValueError("the evaluation keys are already sharded")
        self._key_shard = KeyShard(self, group)
        self.relin_key = self._key_shard.place(self.relin_key)
        for g, k in list(self.galois_keys.items()):
            self.galois_keys[g] = self._key_shard.place(k)
        if "_identity_ksk" in self.__dict__:
            self._identity_ksk = self._key_shard.place(self._identity_ksk)
        self._digit_cache.clear()
        self.key_epoch += 1

    def _place_key(self, k: KeySwitchKey) -> KeySwitchKey:
        """A freshly made key as this context stores it: this rank's rows
        once the keys are sharded, unchanged otherwise."""
        return k if self._key_shard is None else self._key_shard.place(k)

    # ------------------------------------------------------------------
    # key generation
    # ------------------------------------------------------------------

    def num_digits(self, l: int) -> int:
        """Active keyswitch digits at level l (= l for single-limb digits)."""
        return -(-l // self.gsize)

    def drop_galois_keys(self, drop=None, keep=()) -> int:
        """Free raw per-element Galois keys once every engine has built its
        stacked copies (`BsgsMatvec.warm_stacks`): kernels evaluate from
        the stacks only.  The conjugation key (element 2n-1) is always
        kept, plus anything in `keep`.  drop=None drops everything else;
        otherwise only the given elements.  A later ensure_galois for a
        dropped element regenerates it (fresh randomness).  Returns the
        number of keys dropped."""
        always_keep = set(keep) | {2 * self.n - 1}
        elts = list(self.galois_keys) if drop is None else list(drop)
        n_drop = 0
        for g in elts:
            if g in always_keep or g not in self.galois_keys:
                continue
            del self.galois_keys[g]
            n_drop += 1
        return n_drop

    def identity_ksk(self) -> KeySwitchKey:
        """Keyswitch key for s -> s (the identity rotation), made once, when
        a stacked-rotation kernel first meets a step whose Galois element is
        1 (rotation = 0 mod slots), so that every lane of the stack runs the
        same keyswitch.  Its draws come from the context's generator at that
        moment, as the reference's do."""
        if not hasattr(self, "_identity_ksk"):
            self._identity_ksk = self._make_ksk(self.s_eval)
        return self._identity_ksk

    def _build_ksk(self, a: torch.Tensor, e: torch.Tensor,
                   sprime_eval: torch.Tensor) -> KeySwitchKey:
        """Key for s' -> s from uniform a and noise e [..., dnum, L+K, N]
        (a is Mont by fiat; e plain coefficients)."""
        ntt = self.ntt
        all_rows = tuple(range(self.L + self.K))
        e_ev = ntt.ntt_to_mont(e, all_rows)
        b = add_mod(neg_mod(mont_mul(a, self.s_eval, ntt.p, ntt.pinv), ntt.p),
                    e_ev, ntt.p)
        # digit j carries (P mod q_i) * s' on every limb i of group j (zero
        # on other limbs and on the specials, since P | P*g_j there)
        msg = mont_mul(sprime_eval[..., : self.L, :], self.Pmod_mont,
                       ntt.p[: self.L], ntt.pinv[: self.L])   # [..., L, N]
        dof = torch.as_tensor(self.digit_of_limb, dtype=torch.long,
                              device=self.device)
        limb = torch.arange(self.L, device=self.device)
        b[..., dof, limb, :] = add_mod(b[..., dof, limb, :], msg,
                                       ntt.p[: self.L])
        # a key made after shard_eval_keys (ensure_galois, the identity
        # key, set_secret_key's relin key) gets the same rows and padding
        return self._place_key(KeySwitchKey(ntt.to_mont(b, all_rows),
                                            ntt.to_mont(a, all_rows)))

    def _make_ksk(self, sprime_eval: torch.Tensor) -> KeySwitchKey:
        """Keyswitch key for s' -> s.  sprime_eval: [L+K, N] eval/Mont."""
        all_rows = tuple(range(self.L + self.K))
        a = self._tensor(self._uniform((self.dnum,), all_rows))
        e = self._tensor(self._reduce_rows(self._gauss((self.dnum,)),
                                           all_rows))
        return self._build_ksk(a, e, sprime_eval)

    def galois_element(self, steps: int) -> int:
        """Galois element for a cyclic slot rotation by `steps` (left):
        5^steps mod 2N; the conjugation element is 2N-1."""
        return pow(5, steps % (self.n // 2), 2 * self.n)

    def ensure_galois(self, steps_list, conj: bool = False) -> None:
        """Generate (once) the rotation keys for the given step set, in
        sorted Galois-element order and chunks of 16 keys (the reference's
        draw order: uniform, then gauss, per chunk)."""
        gs = [self.galois_element(s) for s in steps_list]
        if conj:
            gs.append(2 * self.n - 1)
        gs = sorted({g for g in gs if g not in self.galois_keys and g != 1})
        all_rows = tuple(range(self.L + self.K))
        ch = 16
        for c0 in range(0, len(gs), ch):
            sub = gs[c0: c0 + ch]
            a = self._tensor(self._uniform((len(sub), self.dnum), all_rows))
            e = self._tensor(self._reduce_rows(
                self._gauss((len(sub), self.dnum)), all_rows))
            sprime = torch.stack([self.s_eval.index_select(-1, self.perm(g))
                                  for g in sub])
            k = self._build_ksk(a, e, sprime)
            for i, g in enumerate(sub):
                self.galois_keys[g] = KeySwitchKey(k.b[i], k.a[i])

    # ------------------------------------------------------------------
    # encode / encrypt / decrypt
    # ------------------------------------------------------------------

    def encode(self, vec, level: int | None = None, scale: float | None = None
               ) -> Plaintext:
        """Encode complex/real slots into an NTT-domain plaintext."""
        level = self.L if level is None else level
        scale = self.scale if scale is None else scale
        coeffs = self.encoder.encode(np.asarray(vec), scale,
                                     wide=scale > 2.0 ** 31)
        return Plaintext(self._to_eval_mont(coeffs, tuple(range(level))),
                         scale)

    def encode_const(self, c: complex, level: int | None = None,
                     scale: float | None = None) -> Plaintext:
        """Exact constant plaintext at any scale: c occupies coefficient 0
        (Re) and coefficient N/2 (Im) only -- X^(N/2) evaluates to i in
        every slot -- and the residues are reduced with python ints, so
        wide scales (beyond the encoder's 2^31 word) stay exact."""
        level = self.L if level is None else level
        scale = self.scale if scale is None else scale
        c = complex(c)
        vre = int(round(c.real * scale))
        vim = int(round(c.imag * scale))
        res = np.zeros((level, self.n), dtype=np.int64)
        for i in range(level):
            q = int(self.q_np[i])
            res[i, 0] = vre % q
            res[i, self.n // 2] = vim % q
        return Plaintext(self.ntt.ntt_to_mont(self._tensor(res),
                                              tuple(range(level))), scale)

    def encrypt(self, vec, level: int | None = None, scale: float | None = None
                ) -> Ciphertext:
        """Symmetric encryption with host randomness."""
        level = self.L if level is None else level
        scale = self.scale if scale is None else scale
        coeffs = self.encoder.encode(np.asarray(vec), scale,
                                     wide=scale > 2.0 ** 31)
        rows = tuple(range(level))
        lead = coeffs.shape[:-1]
        m = self._tensor(self._reduce_rows(coeffs, rows))
        a = self._tensor(self._uniform(lead, rows))
        e = self._tensor(self._reduce_rows(self._gauss(lead), rows))
        ntt = self.ntt
        p, pinv = self._p(level)
        me = ntt.ntt_to_mont(m, rows)
        ee = ntt.ntt_to_mont(e, rows)
        c0 = add_mod(add_mod(neg_mod(mont_mul(a, self.s_eval[:level], p,
                                              pinv), p), me, p), ee, p)
        return Ciphertext(torch.stack([c0, a], dim=-3), scale)

    def encrypt_replicated(self, x, level=None, scale=None) -> Ciphertext:
        """Encrypt x tiled across all slots."""
        x = np.asarray(x)
        reps = self.slots // x.shape[-1]
        return self.encrypt(np.tile(x, reps), level, scale)

    def encrypt_replicated_complex(self, z, level=None, scale=None
                                   ) -> Ciphertext:
        z = np.asarray(z, dtype=np.complex128)
        reps = self.slots // z.shape[-1]
        return self.encrypt(np.tile(z, reps), level, scale)

    def decrypt_limbs(self, c: torch.Tensor, nl: int) -> torch.Tensor:
        """c [..., 2, l, N] -> plain coefficient residues [..., nl, N] of
        c0 + c1*s on the first nl limbs."""
        ntt = self.ntt
        rows = tuple(range(nl))
        p, pinv = self._p(nl)
        v = add_mod(c[..., 0, :nl, :],
                    mont_mul(c[..., 1, :nl, :], self.s_eval[:nl], p, pinv), p)
        return ntt.intt_from_mont(v, rows)

    def decrypt_to_coeffs(self, ct: Ciphertext) -> np.ndarray:
        """Decrypt to centered integer coefficients from the first
        min(2, level) limbs (3 at composite scales > 2^40), exact uint64
        CRT (see compose_coeffs)."""
        nl = min(3 if ct.scale > 2.0 ** 40 else 2, ct.level)
        return self.compose_coeffs(self.decrypt_limbs(ct.c, nl).cpu().numpy())

    def compose_coeffs(self, limbs: np.ndarray) -> np.ndarray:
        """Residue limbs [..., nl, N] (nl = 1, 2 or 3, coefficient domain,
        plain) -> centered float64 coefficients via exact uint64 CRT."""
        limbs = np.asarray(limbs).astype(np.uint64)
        q0 = int(self.q_np[0])
        if limbs.shape[-2] == 1:
            c = limbs[..., 0, :].astype(np.int64)
            c[c > q0 // 2] -= q0
            return c.astype(np.float64)
        q1 = int(self.q_np[1])
        t0, t1 = limbs[..., 0, :], limbs[..., 1, :]
        q0inv = np.uint64(pow(q0, -1, q1))
        d = (t1 + np.uint64(q1) - t0 % np.uint64(q1)) % np.uint64(q1)
        m1 = d * q0inv % np.uint64(q1)
        v = t0 + np.uint64(q0) * m1          # exact: < q0*q1 < 2^62
        big = q0 * q1
        if limbs.shape[-2] == 2:
            out = v.astype(np.float64)
            out[v > big // 2] -= float(big)
            return out
        q2 = int(self.q_np[2])
        t2 = limbs[..., 2, :]
        q01inv = np.uint64(pow(big % q2, -1, q2))
        d2 = (t2 + np.uint64(q2) - v % np.uint64(q2)) % np.uint64(q2)
        k = (d2 * q01inv % np.uint64(q2)).astype(np.int64)
        k[k > q2 // 2] -= q2
        vi = v.astype(np.int64) + np.int64(big) * k
        return vi.astype(np.float64)

    def decrypt_vec_complex(self, ct: Ciphertext, length: int | None = None
                            ) -> np.ndarray:
        z = self.encoder.decode(self.decrypt_to_coeffs(ct), ct.scale)
        return z if length is None else z[:length]

    def decrypt_vec(self, ct: Ciphertext, length: int | None = None
                    ) -> np.ndarray:
        return self.decrypt_vec_complex(ct, length).real

    def decrypt_slot0(self, ct: Ciphertext) -> float:
        return float(self.decrypt_vec_complex(ct, 1)[0].real)

    # ------------------------------------------------------------------
    # arithmetic
    # ------------------------------------------------------------------

    def add(self, x: Ciphertext, y: Ciphertext) -> Ciphertext:
        assert x.level == y.level and _close(x.scale, y.scale), (x.scale,
                                                                  y.scale)
        return Ciphertext(add_mod(x.c, y.c, self._p(x.level)[0]), x.scale)

    def sub(self, x: Ciphertext, y: Ciphertext) -> Ciphertext:
        assert x.level == y.level and _close(x.scale, y.scale)
        return Ciphertext(sub_mod(x.c, y.c, self._p(x.level)[0]), x.scale)

    def negate(self, x: Ciphertext) -> Ciphertext:
        return Ciphertext(neg_mod(x.c, self._p(x.level)[0]), x.scale)

    def add_plain(self, x: Ciphertext, pt: Plaintext) -> Ciphertext:
        assert _close(x.scale, pt.scale) and x.level == pt.level
        c0 = add_mod(x.c[..., 0, :, :], pt.p, self._p(x.level)[0])
        return Ciphertext(torch.stack([c0, x.c[..., 1, :, :]], dim=-3),
                          x.scale)

    def mul_plain(self, x: Ciphertext, pt: Plaintext) -> Ciphertext:
        assert x.level == pt.level, (x.level, pt.level)
        p, pinv = self._p(x.level)
        return Ciphertext(mont_mul(x.c, pt.p.unsqueeze(-3), p, pinv),
                          x.scale * pt.scale)

    def mul_scalar(self, x: Ciphertext, value: float,
                   scale: float | None = None) -> Ciphertext:
        """Multiply by a plaintext scalar: one Montgomery multiply by a
        per-limb residue (a constant is constant across the evaluation
        domain).  Consumes scale like mul_plain."""
        scale = self.scale if scale is None else scale
        v = int(round(value * scale))
        l = x.level
        const = self._tensor([v % int(self.q_np[i]) * self.primes[i].mont_r
                              % int(self.q_np[i]) for i in range(l)])[:, None]
        p, pinv = self._p(l)
        return Ciphertext(mont_mul(x.c, const, p, pinv), x.scale * scale)

    def scale_to(self, x: Ciphertext, target: float | None = None,
                 exact: bool = False) -> Ciphertext:
        """Normalize x to scale exactly `target` (default ctx.scale) by one
        adjusting scalar multiply + as many rescales as needed.  exact=True
        narrows the retag shortcut from 1e-4 to float-ulp (a chain of CT-CT
        squares doubles a retag's deviation per block)."""
        target = self.scale if target is None else target
        tol = 1e-12 if exact else 1e-4
        if abs(x.scale - target) <= tol * target:
            return Ciphertext(x.c, target)
        # k rescales so the adjusting factor is >= 2^20 (scalar rounding
        # error then <= 2^-21)
        prod, k = 1.0, 0
        while target * prod / x.scale < (1 << 20) and k < x.level - 1:
            k += 1
            prod *= float(self.q_np[x.level - k])
        adj = target * prod / x.scale
        assert adj >= 1.0, (x.scale, target, "scale gap too large to bridge")
        # split into factors < 2^31 (several scalar mults, no extra level)
        while adj > float(1 << 30):
            x = self.mul_scalar(x, 1.0, scale=float(1 << 24))
            adj /= float(1 << 24)
        x = self.mul_scalar(x, 1.0, scale=adj)
        for _ in range(k):
            x = self.rescale(x)
        return Ciphertext(x.c, target)

    def multiply(self, x: Ciphertext, y: Ciphertext, relin: bool = True
                 ) -> Ciphertext:
        """CT x CT multiply (+ relinearize)."""
        assert x.level == y.level
        l = x.level
        p, pinv = self._p(l)
        x0, x1 = x.c[..., 0, :, :], x.c[..., 1, :, :]
        y0, y1 = y.c[..., 0, :, :], y.c[..., 1, :, :]
        d0 = mont_mul(x0, y0, p, pinv)
        d1 = add_mod(mont_mul(x0, y1, p, pinv), mont_mul(x1, y0, p, pinv), p)
        d2 = mont_mul(x1, y1, p, pinv)
        if not relin:
            return Ciphertext(torch.stack([d0, d1, d2], dim=-3),
                              x.scale * y.scale)
        kb, ka = self.select_key(self.relin_key, l)
        ks = self._keyswitch(self._decompose(d2, l), kb, ka, l)
        c = torch.stack([add_mod(d0, ks[..., 0, :, :], p),
                         add_mod(d1, ks[..., 1, :, :], p)], dim=-3)
        return Ciphertext(c, x.scale * y.scale)

    def square(self, x: Ciphertext) -> Ciphertext:
        return self.multiply(x, x)

    def rescale(self, x: Ciphertext) -> Ciphertext:
        l = x.level
        assert l >= 2, "cannot rescale at level 1"
        return Ciphertext(self._rescale_core(x.c, l),
                          x.scale / float(self.q_np[l - 1]))

    def _rescale_core(self, c: torch.Tensor, l: int) -> torch.Tensor:
        """[..., l, N] Mont eval -> [..., l-1, N]: exact divide by q_{l-1}."""
        ntt = self.ntt
        rows = tuple(range(l - 1))
        qlinv = self._qlinv[l - 1, : l - 1, None]
        p, pinv = self._p(l - 1)
        last = ntt.intt_from_mont(c[..., l - 1:, :], (l - 1,))
        u = self._extend_centered(last, (l - 1,), rows)[..., 0, :, :]
        u = ntt.ntt_to_mont(u, rows)
        return mont_mul(sub_mod(c[..., : l - 1, :], u, p), qlinv, p, pinv)

    def mod_drop(self, x: Ciphertext, levels: int = 1) -> Ciphertext:
        """Drop trailing limb rows (exact mod switch)."""
        assert x.level - levels >= 1
        return Ciphertext(x.c[..., : x.level - levels, :], x.scale)

    def mod_switch_to(self, x: Ciphertext, level: int) -> Ciphertext:
        assert level <= x.level
        return self.mod_drop(x, x.level - level) if level < x.level else x

    def set_scale(self, x: Ciphertext, scale: float) -> Ciphertext:
        return Ciphertext(x.c, float(scale))

    # ------------------------------------------------------------------
    # keyswitch internals
    # ------------------------------------------------------------------

    def _extend_centered(self, coeffs: torch.Tensor, src_rows: tuple,
                         tgt_rows: tuple) -> torch.Tensor:
        """Plain coefficients [..., S, N] (row s mod q_src[s]) ->
        [..., S, T, N]: centered lift re-reduced modulo each target prime."""
        c = coeffs[..., :, None, :]
        p_t = self._sel(self.ntt.p, tgt_rows)[None]          # [1, T, 1]
        mu_t = self._sel(self.mu, tgt_rows)[None]
        r = barrett_reduce(c, p_t, mu_t)
        qm = self.q_mod.index_select(0, self._idx(src_rows)).index_select(
            1, self._idx(tgt_rows))                           # [S, T, 1]
        r_neg = cond_sub(r + (p_t - qm), p_t)
        return torch.where(c >= self._sel(self.q_half, src_rows), r_neg, r)

    def _digit_tables(self, l: int, tgt: tuple | None = None) -> dict:
        """Constants of the grouped fast base conversion at level l onto the
        target rows tgt (default `targets(l)`; built once per pair).  Group
        j's active members are limbs [j*g, min((j+1)*g, l)); ragged groups
        are zero-padded to g (their hatinv/muA/B64/qhat are 0, and limb_idx
        clips to l-1)."""
        tgt = self.targets(l) if tgt is None else tgt
        tb = self._digit_cache.get((l, tgt))
        if tb is not None:
            return tb
        g, d_l = self.gsize, self.num_digits(l)
        T = len(tgt)
        q = self.q_np
        r_of = lambda i: self.primes[i].mont_r

        limb_idx = np.zeros((d_l, g), dtype=np.int64)
        hatinv_r = np.zeros((d_l, g, 1), dtype=np.int64)
        muA = np.zeros((d_l, g, 1), dtype=np.int64)
        B64 = np.zeros((d_l, g, 1), dtype=np.int64)
        qhat_r = np.zeros((d_l, g, T, 1), dtype=np.int64)
        qj_r = np.zeros((d_l, T, 1), dtype=np.int64)
        for j in range(d_l):
            mem = list(range(j * g, min((j + 1) * g, l)))
            qj = 1
            for i in mem:
                qj *= int(q[i])
            for t_i, t in enumerate(tgt):
                qj_r[j, t_i, 0] = qj % int(q[t]) * r_of(t) % int(q[t])
            for m_i, i in enumerate(mem):
                limb_idx[j, m_i] = i
                qhat = qj // int(q[i])
                hatinv_r[j, m_i, 0] = (pow(qhat % int(q[i]), -1, int(q[i]))
                                       * r_of(i) % int(q[i]))
                muA[j, m_i, 0] = (1 << 32) // int(q[i])
                B64[j, m_i, 0] = ((1 << 64) // int(q[i])) & MASK32
                for t_i, t in enumerate(tgt):
                    qhat_r[j, m_i, t_i, 0] = (qhat % int(q[t]) * r_of(t)
                                              % int(q[t]))
        li = np.clip(limb_idx, 0, l - 1)
        p_np = self.q_np.astype(np.int64)
        pinv_np = np.array([pr.mont_pinv for pr in self.primes],
                           dtype=np.int64)
        tb = {"limb_idx": li, "hatinv_r": hatinv_r,
              "p_mem": p_np[li][..., None], "pinv_mem": pinv_np[li][..., None],
              "muA": muA, "B64": B64, "qhat_r": qhat_r, "qj_r": qj_r}
        tb = {k: self._tensor(v) for k, v in tb.items()}
        self._digit_cache[(l, tgt)] = tb
        return tb

    def _fbc_digits(self, coeffs: torch.Tensor, l: int,
                    tgt: tuple | None = None) -> torch.Tensor:
        """Grouped digits via approximate-centered fast base conversion.

        coeffs: [..., l, N] plain coefficient-domain residues.  Returns
        [..., d_l, T, N]: for each group j an integer representative of
        c mod Q_j extended to the target rows tgt (default `targets(l)`).
        The centring correction v = round(sum_i y_i / q_i) is the
        reference's 32-bit fixed point:
        u_i = (y_i*muA + mulhi(y_i, B64)) mod 2^32, and v = hi + (lo >> 31)
        of the wrapping (hi, lo) sum, which the exact int64 sum of the u_i
        holds bit for bit.  An off-by-one v changes the representative by
        Q_j (a rare, bounded noise increment since P >= Q_j)."""
        tgt = self.targets(l) if tgt is None else tgt
        tb = self._digit_tables(l, tgt)
        p_t, pinv_t = self._sel(self.ntt.p, tgt), self._sel(self.ntt.pinv, tgt)
        # y_i = [c * Qhat_i^-1]_{q_i}, zero on padded members
        y = coeffs.index_select(-2, tb["limb_idx"].reshape(-1))
        y = y.reshape(coeffs.shape[:-2] + tuple(tb["limb_idx"].shape)
                      + (self.n,))                          # [..., d_l, g, N]
        y = mont_mul(y, tb["hatinv_r"], tb["p_mem"], tb["pinv_mem"])
        u = (mul_lo_u32(y, tb["muA"]) + mul_hi_u32(y, tb["B64"])) & MASK32
        tot = u.sum(dim=-2)
        v = (tot >> 32) + ((tot & MASK32) >> 31)               # [..., d_l, N]
        # D_j[t] = sum_i y_i * Qhat_i - v * Q_j  (mod q_t); one member at a
        # time bounds the transient to one [..., d_l, T, N] product
        acc = None
        for i in range(self.gsize):
            prod = mont_mul(y[..., i, None, :], tb["qhat_r"][:, i], p_t,
                            pinv_t)
            acc = prod if acc is None else acc + prod
        acc = acc % p_t
        vq = mont_mul(v[..., None, :], tb["qj_r"], p_t, pinv_t)
        return sub_mod(acc, vq, p_t)

    def _decompose(self, c1: torch.Tensor, l: int) -> torch.Tensor:
        """[..., l, N] Mont eval -> extended digits [..., d_l, T, N], plain,
        eval (d_l = l for single-limb digits, ceil(l/gsize) when dnum is
        set), on the target rows `_ks_targets(l)`."""
        with span("ckks.decompose"):
            coeffs = self.ntt.intt_from_mont(c1, tuple(range(l)))
            return self._extend_digits(coeffs, l, self._ks_targets(l))

    def _extend_digits(self, coeffs: torch.Tensor, l: int, tgt: tuple
                       ) -> torch.Tensor:
        """Plain digit coefficients [..., l, N] -> extended digits
        [..., d_l, len(tgt), N] in the eval domain of the rows tgt."""
        if not tgt:
            return coeffs.new_zeros(coeffs.shape[:-2]
                                    + (self.num_digits(l), 0, self.n))
        if self.gsize == 1:
            D = self._extend_centered(coeffs, tuple(range(l)), tgt)
        else:
            D = self._fbc_digits(coeffs, l, tgt)
        return self.ntt.ntt(D, tgt)

    def select_key(self, ksk: KeySwitchKey, l: int):
        """Slice a keyswitch key down to the digits/rows active at level l
        (this rank's rows of them once the keys are sharded)."""
        idx = self._idx(self._key_rows(l))
        d_l = self.num_digits(l)
        return (ksk.b[..., :d_l, :, :].index_select(-2, idx),
                ksk.a[..., :d_l, :, :].index_select(-2, idx))

    def _apply_ksk(self, D: torch.Tensor, b: torch.Tensor, a: torch.Tensor,
                   l: int, tgt: tuple | None = None) -> torch.Tensor:
        """sum_j D_j * key_j over digits -> [..., 2, T, N] Mont eval on the
        target rows tgt (default `_ks_targets(l)`).  b, a: level-selected
        key tensors [(...,) d_l, T, N]."""
        tgt = self._ks_targets(l) if tgt is None else tgt
        p_t, pinv_t = self._sel(self.ntt.p, tgt), self._sel(self.ntt.pinv, tgt)
        ks0 = mont_mul(D, b, p_t, pinv_t).sum(dim=-3) % p_t
        ks1 = mont_mul(D, a, p_t, pinv_t).sum(dim=-3) % p_t
        return torch.stack([ks0, ks1], dim=-3)

    def _keyswitch(self, D: torch.Tensor, kb: torch.Tensor, ka: torch.Tensor,
                   l: int) -> torch.Tensor:
        """Extended digits D [..., d_l, T, N] against level-selected keys
        kb/ka -> the switched pair [..., 2, l, N] (contraction, then the
        mod-down).  With sharded keys every rank contracts its own rows and
        the result is gathered: the same words on every rank."""
        with span("ckks.keyswitch"):
            if self._key_shard is not None:
                return self._key_shard.switch(D, kb, ka, l)
            return self._mod_down(self._apply_ksk(D, kb, ka, l), l)

    def _mod_down(self, ks: torch.Tensor, l: int) -> torch.Tensor:
        """[..., 2, l+K, N] Mont eval over Q_l*P -> [..., 2, l, N] Mont eval
        over Q_l (divide by P, CENTERED fast base conversion: the
        representative error stays <= 1 unit)."""
        return self._mod_down_rows(ks[..., :l, :], ks[..., l:, :],
                                   tuple(range(l)))

    def _mod_down_rows(self, ks_q: torch.Tensor, ks_sp: torch.Tensor,
                       rows: tuple) -> torch.Tensor:
        """The mod-down of the limb rows `rows` alone: ks_q [..., 2, R, N]
        on those rows, ks_sp [..., 2, K, N] on the special rows -> [..., 2,
        R, N].  Each row's words depend only on that row and the specials,
        so a limb-sharded caller gets the unsharded words for its rows."""
        if not rows:
            return ks_q
        ntt = self.ntt
        sp_rows = tuple(range(self.L, self.L + self.K))
        p, pinv = self._rows(ntt.p, rows), self._rows(ntt.pinv, rows)
        t = ntt.intt_from_mont(ks_sp, sp_rows)
        if self.K > 1:
            p_sp = self._sel(ntt.p, sp_rows)
            y = mont_mul(t, self.phat_inv_mont, p_sp,
                         self._sel(ntt.pinv, sp_rows))
            # v = round(sum_k y_k / p_k) in 32-bit fixed point: u_k is the
            # wrapping low word y*muA + mulhi(y, B64); the int64 sum holds
            # the reference's (hi, lo) carry pair exactly
            u32f = (mul_lo_u32(y, self._sp_muA)
                    + mul_hi_u32(y, self._sp_B64)) & MASK32
            tot = u32f.sum(dim=-2)
            v = (tot >> 32) + ((tot & MASK32) >> 31)            # [.., N]
            r = barrett_reduce(y[..., :, None, :], p[None],
                               self._rows(self.mu, rows)[None])
            r = mont_mul(r, self._rows(self.phat_mod_mont, rows, dim=1), p,
                         pinv)
            u = r.sum(dim=-3) % p
            vq = mont_mul(v[..., None, :], self._rows(self.Pmod_mont, rows),
                          p, pinv)
            u = sub_mod(u, vq, p)
        else:
            u = self._extend_centered(t, sp_rows, rows)[..., 0, :, :]
        u = ntt.ntt_to_mont(u, rows)
        return mont_mul(sub_mod(ks_q, u, p), self._rows(self.Pinv_mont, rows),
                        p, pinv)

    def keyswitch_rotated(self, c: torch.Tensor, D: torch.Tensor,
                          perm: torch.Tensor, kb: torch.Tensor,
                          ka: torch.Tensor, l: int) -> torch.Tensor:
        """Rotate ct c [2, l, N] whose c1 digits D [d_l, T, N] are hoisted,
        by the automorphism `perm` [..., N] with level-selected keys
        kb/ka [..., d_l, T, N] -> [..., 2, l, N] (a leading batch of
        rotations when perm and keys carry one)."""
        p, _ = self._p(l)
        Dg = _take_last(D, perm)
        ks = self._keyswitch(Dg, kb, ka, l)
        c0 = add_mod(_take_last(c[0], perm), ks[..., 0, :, :], p)
        return torch.stack([c0, ks[..., 1, :, :]], dim=-3)

    # ------------------------------------------------------------------
    # rotations
    # ------------------------------------------------------------------

    def rotate(self, x: Ciphertext, steps: int) -> Ciphertext:
        """Cyclic slot rotation by `steps` (slot j <- slot j+steps)."""
        if steps % self.slots == 0:
            return x
        g = self.galois_element(steps)
        assert g in self.galois_keys, f"missing galois key for step {steps}"
        return Ciphertext(self._rotate_g(x.c, x.level, g), x.scale)

    def conjugate(self, x: Ciphertext) -> Ciphertext:
        g = 2 * self.n - 1
        assert g in self.galois_keys, "missing conjugation key"
        return Ciphertext(self._rotate_g(x.c, x.level, g), x.scale)

    def _rotate_g(self, c: torch.Tensor, l: int, g: int) -> torch.Tensor:
        p, _ = self._p(l)
        cp = c.index_select(-1, self.perm(g))
        kb, ka = self.select_key(self.galois_keys[g], l)
        ks = self._keyswitch(self._decompose(cp[..., 1, :, :], l), kb, ka, l)
        return torch.stack([add_mod(cp[..., 0, :, :], ks[..., 0, :, :], p),
                            ks[..., 1, :, :]], dim=-3)

    def hoisted_rotations(self, x: Ciphertext, steps: tuple
                          ) -> list[Ciphertext]:
        """Rotate one ciphertext [2, l, N] by many steps, sharing the digit
        decomposition.  Step 0 passes through."""
        l = x.level
        D = self._decompose(x.c[1], l)
        outs = []
        for s in steps:
            if s % self.slots == 0:
                outs.append(x)
                continue
            g = self.galois_element(s)
            kb, ka = self.select_key(self.galois_keys[g], l)
            outs.append(Ciphertext(
                self.keyswitch_rotated(x.c, D, self.perm(g), kb, ka, l),
                x.scale))
        return outs


def _take_last(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """x[..., perm] along the last axis; a perm with leading dims [S, N]
    gives a leading batch [S, *x.shape]."""
    if perm.dim() == 1:
        return x.index_select(-1, perm)
    S = perm.shape[0]
    idx = perm.view((S,) + (1,) * (x.dim() - 1) + (x.shape[-1],))
    return torch.gather(x.unsqueeze(0).expand((S,) + x.shape), -1,
                        idx.expand((S,) + x.shape))


def _close(a: float, b: float, rtol: float = 1e-6) -> bool:
    return abs(a - b) <= rtol * max(abs(a), abs(b))
