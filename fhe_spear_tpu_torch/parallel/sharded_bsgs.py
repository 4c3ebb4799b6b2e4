"""BSGS matvec with its giant-step groups sharded over a rank group.

Counterpart of `fhe_spear_tpu/parallel/sharded_bsgs.py`.  The evaluation
y = sum_g rot_{gG}( sum_b diag'_{gG+b} * rot_b(x) ) is data-parallel over
giant groups g: each rank holds the diagonals and the giant rotation keys
of its B/size contiguous groups, every rank computes the G hoisted baby
rotations (replicated), contracts and giant-rotates its own groups, sums
them, and the partial sums are reduced with the exact modular all-reduce
(`collectives.psum_mod`) before the one rescale.

Group g = 0 needs no rotation; as in the reference it goes through the
identity keyswitch (s -> s), so every group runs the same code.  The words
are therefore the reference's *sharded* kernel's, not the single-device
`BsgsMatvec`'s (they differ by one keyswitch of noise in group 0).  The
draw order is the reference's: `BsgsMatvec(ctx, d)` first (the rotation
keys), then `ctx.identity_ksk()`.

Memory divides by the group size for both sharded operands: a rank stacks
the giant keys of its own groups only, and `load` stages its slice of the
[B, G, l, N] diagonals.
"""

from __future__ import annotations

import torch

from ..ckks.ciphertext import Ciphertext
from ..core.modops import add_mod
from ..ops.bsgs import (GIANT_CHUNK, BsgsMatvec, EncodedDiagonals,
                        _load_coeffs, bsgs_dims, expand_groups, level_keys,
                        rotate_sum, stack_keys)
from .collectives import RankGroup, psum_mod

__all__ = ["ShardedBsgsMatvec"]


class ShardedBsgsMatvec:
    """BSGS matvec with giant groups sharded over `group` (B % size == 0);
    rank r holds groups [r*B/size, (r+1)*B/size)."""

    def __init__(self, ctx, d: int, group: RankGroup):
        self.ctx = ctx
        self.d = d
        self.group = group
        self.G, self.B = bsgs_dims(d)
        if self.B % group.size:
            raise ValueError(f"{self.B} giant groups do not divide over "
                             f"{group.size} ranks")
        self.eng = BsgsMatvec(ctx, d)          # host encode + Galois keys
        ctx.identity_ksk()                     # the s -> s key of group 0
        per = self.B // group.size
        self.lo, self.hi = group.rank * per, (group.rank + 1) * per
        self._full = None

    def encode(self, w, scale=None) -> EncodedDiagonals:
        return self.eng.encode(w, scale)

    def load(self, enc: EncodedDiagonals, level: int) -> torch.Tensor:
        """This rank's groups of the diagonals -> [B/size, G, l, N]."""
        return _load_coeffs(self.ctx, enc.coeffs[self.lo:self.hi], level)

    def _stacks(self):
        """Baby keys (all G-1) and the giant keys of this rank's groups
        (group 0 with the identity key), rebuilt after the context's keys
        were replaced (`key_epoch`)."""
        ctx = self.ctx
        if self._full is not None and self._full_epoch != ctx.key_epoch:
            self._full = None
            ctx.ensure_galois(self.eng.baby_steps + self.eng.giant_steps)
        if self._full is None:
            giants = tuple(g * self.G for g in range(self.lo, self.hi))
            self._full = (stack_keys(ctx, self.eng.baby_steps)
                          + stack_keys(ctx, giants))
            self._full_epoch = ctx.key_epoch
        return self._full

    def kernel(self, l: int):
        """kern(c [2, l, N], pt) -> [2, l-1, N] for this rank's groups pt
        [B/size, G, ...] of one matrix, in any format of
        `ops.bsgs.expand_groups`: the same words on every rank."""
        ctx, eng = self.ctx, self.eng
        p, _ = ctx._p(l)
        bp, bkb, bka, gp, gkb, gka = level_keys(ctx, self._stacks(), l)

        def kern(c, pt):
            babies = eng.babies(c, l, bp, bkb, bka)
            y = None
            for c0 in range(0, pt.shape[0], GIANT_CHUNK):
                c1 = min(pt.shape[0], c0 + GIANT_CHUNK)
                accs = eng.contract(
                    babies, expand_groups(ctx, pt, l, slice(c0, c1)), l)
                part = rotate_sum(ctx, accs, gp[c0:c1], gkb[c0:c1],
                                  gka[c0:c1], l)
                y = part if y is None else add_mod(y, part, p)
            return ctx._rescale_core(psum_mod(y, p, self.group), l)
        return kern

    def __call__(self, ct: Ciphertext, pt: torch.Tensor,
                 pt_scale: float | None = None) -> Ciphertext:
        l = ct.level
        assert pt.shape[0] == self.hi - self.lo, (pt.shape, self.lo, self.hi)
        scale = self.ctx.scale if pt_scale is None else pt_scale
        out = self.kernel(l)(ct.c, pt)
        return Ciphertext(out, ct.scale * scale / float(self.ctx.q_np[l - 1]))
