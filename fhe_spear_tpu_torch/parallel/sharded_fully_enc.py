"""Fully-encrypted FFN blocks with every chunk projection giant-sharded
over a rank group.

Counterpart of `fhe_spear_tpu/parallel/sharded_fully_enc.py`: the key
(D->F) and value (F->D) chunk projections run the giant-sharded kernel
(`sharded_bsgs.ShardedBsgsMatvec`), so the giant key stacks and the staged
diagonals divide over the ranks; the CT-CT square and the residual add run
replicated.  Scale management is exact (`FullyEncryptedFfn.diag_scales`):
each block's output scale equals its input scale.

The reference borrows `diag_scales`, which reads `self.width`, and sets no
`width`, so its chain raises; this class is width 1 and says so.
"""

from __future__ import annotations

import time

import numpy as np

from ..ckks.ciphertext import Ciphertext
from ..models.fully_encrypted import (FullyEncryptedFfn, _sync,
                                      plaintext_ffn_block)
from ..ops.bsgs import _load_coeffs
from .collectives import RankGroup
from .sharded_bsgs import ShardedBsgsMatvec

__all__ = ["ShardedFullyEncryptedFfn"]


class ShardedFullyEncryptedFfn:
    """One fully-encrypted block (x + (x @ W_key)^2 @ W_val, 3 levels)
    with its chunk matvecs giant-sharded over `group`."""

    width = 1
    # exact-scale bookkeeping and the host pre-encode (chunk stacks
    # [k, B, G, N] at the scales of the consume level) are the
    # single-device engine's
    diag_scales = FullyEncryptedFfn.diag_scales
    encode_block = FullyEncryptedFfn.encode_block

    def __init__(self, ctx, d: int, f: int, group: RankGroup):
        self.ctx = ctx
        self.d, self.f = d, f
        self.group = group
        self.eng = ShardedBsgsMatvec(ctx, d, group)
        self.n_chunks = -(-f // d)

    def load_block(self, host: dict, level: int) -> dict:
        """Stage this rank's giant groups of the diagonals at the levels
        they are consumed: key at `level`, val at `level - 2`."""
        assert host["level"] == level, (host["level"], level)
        lo, hi = self.eng.lo, self.eng.hi
        load = lambda coeffs, lv: _load_coeffs(self.ctx, coeffs[lo:hi], lv)
        return {"key": [load(c, level) for c in host["key"]],
                "val": [load(c, level - 2) for c in host["val"]],
                "level": level}

    def __call__(self, ct_x: Ciphertext, staged: dict) -> Ciphertext:
        ctx, l = self.ctx, ct_x.level
        assert l >= 4, f"need >= 4 limbs, have {l} (bootstrap first)"
        assert staged["level"] == l, (staged["level"], l)
        s_key, s_val = self.diag_scales(l)
        # 1. key projection: per-chunk sharded matvecs  [1 level]
        fks = [self.eng(ct_x, pt, pt_scale=s_key) for pt in staged["key"]]
        # 2. square per chunk  [1 level]
        sqs = [ctx.rescale(ctx.multiply(c, c)) for c in fks]
        # 3. value projection + chunk sum  [1 level]
        fvs = [self.eng(sq, pt, pt_scale=s_val)
               for sq, pt in zip(sqs, staged["val"])]
        v = fvs[0]
        for c in fvs[1:]:
            v = ctx.add(v, c)
        # 4. residual at equal true scales; set_scale unifies the float tags
        x_al = ctx.mod_drop(ct_x, 3)
        return ctx.add(ctx.set_scale(x_al, v.scale), v)

    def run_chain(self, w_keys, w_vals, x0, verbose: bool = False):
        """Chain blocks with per-block plaintext verification; returns
        (stats, ct).  Each stat: block, corr, max_err, level, encode_s (the
        host pre-encode) and sec (staging and evaluation)."""
        ctx = self.ctx
        x_ref = np.asarray(x0, dtype=np.float64).copy()
        ct = ctx.encrypt_replicated(x0)
        stats = []
        for b, (wk, wv) in enumerate(zip(w_keys, w_vals)):
            if ct.level - 1 < 4:
                break
            t0 = time.perf_counter()
            host = self.encode_block(np.asarray(wk), np.asarray(wv),
                                     level=ct.level)
            t1 = time.perf_counter()
            ct = self(ct, self.load_block(host, ct.level))
            _sync(ct.c)
            sec = time.perf_counter() - t1
            x_ref = plaintext_ffn_block(x_ref, np.asarray(wk),
                                        np.asarray(wv))
            dec = ctx.decrypt_vec(ct, self.d)
            corr = float(np.corrcoef(dec, x_ref)[0, 1])
            err = float(np.max(np.abs(dec - x_ref)))
            stats.append({"block": b, "corr": corr, "max_err": err,
                          "level": ct.level, "encode_s": t1 - t0,
                          "sec": sec})
            if verbose:
                print(f"  sharded block {b}: corr={corr:.10f} "
                      f"max_err={err:.2e} level={ct.level}")
        return stats, ct
