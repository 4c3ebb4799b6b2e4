"""Encrypted similarity retrieval over CKKS -- SIMD-batched scoring.

Counterpart of `fhe_spear_tpu/ops/retrieval.py`.  Both engines use
Lorentz-lifted, complex-packed embeddings (`ops/packing`):

Row packing: each document occupies a contiguous block of ceil(d/2)
slots; floor(slots / spd) docs per ciphertext (124 docs per ct at
N=8192/64d).  The query is tiled across doc blocks; one CT-PT or CT-CT
multiply scores a whole batch; per-doc slot sums happen client-side after
decryption.

Column packing: one ciphertext per *coordinate pair* across all docs --
slot j of ciphertext c holds doc_j[2c] + i*doc_j[2c+1]; `slots` docs per
chunk.  Scoring a chunk = sum_c ct_c * query_c: the raw 3-component
products of all C coordinate pairs are summed (one batched product over
C, summed exactly in int64 and reduced once: C canonical residues stay far
below 2^63), then each chunk is relinearized and rescaled ONCE.  The
reference's `lax.scan` over C computes the same canonical words.

Every transform of the path (encryption, the relinearization's digit
extension and mod-down, the rescale, decryption) runs kernels K1/K2 on
the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ckks.ciphertext import Ciphertext, Plaintext
from ..ckks.context import CkksContext
from ..core.modops import add_mod, mont_mul
from .packing import euclidean_to_lorentz, pack_complex, pack_complex_conjugate

__all__ = ["RowPackedRetrieval", "ColumnPackedRetrieval"]


def _lift(docs: np.ndarray, lorentz: bool) -> np.ndarray:
    docs = np.asarray(docs, dtype=np.float64)
    return euclidean_to_lorentz(docs) if lorentz else docs


def _query_lift(q: np.ndarray, lorentz: bool) -> np.ndarray:
    q = _lift(q, lorentz)
    if lorentz:
        q = q.copy()
        q[..., 0] = -q[..., 0]  # sign-flip q0: Lorentz IP becomes a plain dot
    return q


class RowPackedRetrieval:
    """Docs along slot blocks; one multiply scores a whole doc batch."""

    def __init__(self, ctx: CkksContext, dim: int, lorentz: bool = True):
        self.ctx = ctx
        self.lorentz = lorentz
        self.dim = dim
        d_packed = dim + (1 if lorentz else 0)
        self.spd = (d_packed + 1) // 2          # slots per doc
        self.docs_per_ct = ctx.slots // self.spd

    def _pack_docs(self, docs: np.ndarray) -> tuple[np.ndarray, int]:
        """[n, dim] -> packed slot matrix [n_batches, slots] complex."""
        z = pack_complex(_lift(docs, self.lorentz))           # [n, spd]
        n = z.shape[0]
        nb = -(-n // self.docs_per_ct)
        full = np.zeros((nb * self.docs_per_ct, self.spd), dtype=np.complex128)
        full[:n] = z
        full = full.reshape(nb, self.docs_per_ct * self.spd)
        out = np.zeros((nb, self.ctx.slots), dtype=np.complex128)
        out[:, : full.shape[1]] = full
        return out, n

    def encode_docs(self, docs: np.ndarray, level: int | None = None
                    ) -> Plaintext:
        """Server-side plaintext corpus for CT-PT mode: [nb, l, N] (the
        reference keeps a broadcast axis, [nb, 1, l, N]; the port's
        mul_plain inserts it)."""
        slots_mat, _ = self._pack_docs(docs)
        return self.ctx.encode(slots_mat, level)

    def encrypt_docs(self, docs: np.ndarray, level: int | None = None
                     ) -> Ciphertext:
        """Encrypted corpus for CT-CT mode: [nb, 2, l, N]."""
        slots_mat, _ = self._pack_docs(docs)
        return self.ctx.encrypt(slots_mat, level)

    def encrypt_query(self, q: np.ndarray, level: int | None = None
                      ) -> Ciphertext:
        zq = pack_complex_conjugate(_query_lift(q, self.lorentz))
        tiled = np.zeros(self.ctx.slots, dtype=np.complex128)
        block = np.tile(zq, self.docs_per_ct)
        tiled[: block.shape[0]] = block
        return self.ctx.encrypt(tiled, level)

    def scores_ctpt(self, query_ct: Ciphertext, docs_pt: Plaintext
                    ) -> Ciphertext:
        """[server] one batched CT-PT multiply + rescale."""
        return self.ctx.rescale(self.ctx.mul_plain(query_ct, docs_pt))

    def scores_ctct(self, query_ct: Ciphertext, docs_ct: Ciphertext
                    ) -> Ciphertext:
        """[server] one batched CT-CT multiply + relin + rescale."""
        return self.ctx.rescale(self.ctx.multiply(query_ct, docs_ct))

    def decode_scores(self, ct_scores: Ciphertext, n_docs: int) -> np.ndarray:
        """[client] decrypt + per-doc slot sums of real parts."""
        z = self.ctx.decrypt_vec_complex(ct_scores)         # [nb, slots]
        z = np.atleast_2d(z)[:, : self.docs_per_ct * self.spd]
        per_doc = z.real.reshape(-1, self.spd).sum(axis=-1)
        return per_doc[:n_docs]


class ColumnPackedRetrieval:
    """Coordinate pairs along ciphertexts, docs along slots."""

    def __init__(self, ctx: CkksContext, dim: int, lorentz: bool = True):
        self.ctx = ctx
        self.lorentz = lorentz
        self.dim = dim
        d_packed = dim + (1 if lorentz else 0)
        self.n_coord = (d_packed + 1) // 2      # ciphertexts per chunk
        self.docs_per_chunk = ctx.slots

    def encrypt_corpus(self, docs: np.ndarray) -> Ciphertext:
        """[n, dim] -> Ciphertext batched [n_chunks, C, 2, l, N]."""
        z = pack_complex(_lift(docs, self.lorentz))            # [n, C]
        n = z.shape[0]
        nc = -(-n // self.ctx.slots)
        full = np.zeros((nc * self.ctx.slots, self.n_coord),
                        dtype=np.complex128)
        full[:n] = z
        cols = full.reshape(nc, self.ctx.slots, self.n_coord
                            ).transpose(0, 2, 1)
        return self.ctx.encrypt(cols)                          # [nc, C, 2, l, N]

    def encrypt_query(self, q: np.ndarray) -> Ciphertext:
        zq = pack_complex_conjugate(_query_lift(q, self.lorentz))  # [C]
        rep = np.repeat(zq[:, None], self.ctx.slots, axis=1)       # [C, slots]
        return self.ctx.encrypt(rep)                               # [C, 2, l, N]

    def scores(self, corpus_ct: Ciphertext, query_ct: Ciphertext
               ) -> Ciphertext:
        """[server] per chunk: sum_c ct_c * q_c with ONE relin + rescale.

        Returns score ciphertexts [n_chunks, 2, l-1, N]; slot j of chunk k
        holds the score of doc k*slots + j (in its real part).
        """
        ctx, l = self.ctx, corpus_ct.level
        p, pinv = ctx._p(l)
        dc, qc = corpus_ct.c, query_ct.c          # [nc, C, 2, l, N], [C, 2, l, N]
        d0, d1 = dc[:, :, 0], dc[:, :, 1]
        q0, q1 = qc[:, 0], qc[:, 1]
        t0 = mont_mul(d0, q0, p, pinv).sum(dim=1) % p
        t1 = (mont_mul(d0, q1, p, pinv) + mont_mul(d1, q0, p, pinv)
              ).sum(dim=1) % p
        t2 = mont_mul(d1, q1, p, pinv).sum(dim=1) % p
        # one relinearization of the accumulated c2 term per chunk
        kb, ka = ctx.select_key(ctx.relin_key, l)
        ks = ctx._keyswitch(ctx._decompose(t2, l), kb, ka, l)
        c = torch.stack([add_mod(t0, ks[:, 0], p), add_mod(t1, ks[:, 1], p)],
                        dim=1)
        scale = corpus_ct.scale * query_ct.scale / float(ctx.q_np[l - 1])
        return Ciphertext(ctx._rescale_core(c, l), scale)

    def decode_scores(self, ct_scores: Ciphertext, n_docs: int) -> np.ndarray:
        z = self.ctx.decrypt_vec_complex(ct_scores)     # [nc, slots]
        return np.atleast_2d(z).real.reshape(-1)[:n_docs]
