"""RNS-limb-sharded keyswitching: rotations with the ciphertext's limb rows
partitioned over a rank group (`LimbShardedRotator`), and evaluation keys
partitioned on their limb-row axis (`KeyShard`, the layout behind
`CkksContext.shard_eval_keys`).

Counterpart of `fhe_spear_tpu/parallel/limb_sharded.py` and of the
reference's `shard_eval_keys` / `key_sharding`.  The only cross-limb step
of a keyswitch is the digit broadcast: every target row needs the
coefficients of every digit.  After it, each row's words depend on that
row alone, except for the mod-down, which reads the K special rows.  So:

  * `LimbShardedRotator` (ciphertext rows sharded, l/size rows a rank):
    each rank iNTTs its own rows, the coefficient-domain digit rows [l, N]
    are all-gathered, every rank extends them to its rows and, redundantly,
    to the K special rows, contracts with its key rows, and divides by P
    on its rows.  The output stays limb-sharded.
  * `KeyShard` (ciphertexts replicated, key rows sharded): each rank
    extends the digits to its own key rows only and contracts them, the
    special rows are gathered from the ranks that hold them, each rank
    divides by P on its limb rows, and the output limb rows are
    all-gathered: a replicated ciphertext.

Both run `switch_rows`, and every transform is the context's
`ntt.ntt`/`intt` on the rank's rows (kernels K1/K2 on the card).  Each
rank's words are the unsharded keyswitch's words on its rows, so the
results equal `CkksContext.rotate` and the unsharded chain word for word.

Left out: the reference's table-passing `NttContext.tables`/`ntt_t`/
`intt_t`, which exist only because a `shard_map` body cannot index by
device; a rank here selects its rows with `rows=`.
"""

from __future__ import annotations

import torch

from ..ckks.ciphertext import Ciphertext
from ..core.modops import add_mod
from .collectives import RankGroup, all_gather_rows

__all__ = ["KeyShard", "LimbShardedRotator", "switch_rows"]


def switch_rows(ctx, D: torch.Tensor, kb: torch.Tensor, ka: torch.Tensor,
                l: int, tgt: tuple, group: RankGroup | None = None,
                sp_counts=None) -> torch.Tensor:
    """The keyswitch of the target rows tgt (limb rows below l first, then
    the special rows this rank holds): digits D [..., d_l, T, N] and key
    rows kb/ka [..., d_l, T, N] -> the switched limb rows [..., 2, R, N].
    With sp_counts (each rank's count of special rows), the special rows
    are all-gathered over `group`; without, tgt holds all K of them."""
    ks = ctx._apply_ksk(D, kb, ka, l, tgt)
    nq = sum(1 for t in tgt if t < l)
    ks_sp = ks[..., nq:, :]
    if sp_counts is not None:
        ks_sp = all_gather_rows(ks_sp, group, sp_counts)
    return ctx._mod_down_rows(ks[..., :nq, :], ks_sp, tgt[:nq])


class KeyShard:
    """Limb-row layout of a context's evaluation keys over a rank group:
    the [dnum, L+K, N] keys are zero-padded to L+K+pad rows (pad =
    (-(L+K)) mod size; pad rows are never targets) and rank r holds the
    contiguous block [r*m, (r+1)*m), m = (L+K+pad)/size."""

    def __init__(self, ctx, group: RankGroup):
        self.ctx = ctx
        self.group = group
        LK = ctx.L + ctx.K
        self.pad = (-LK) % group.size
        self.m = (LK + self.pad) // group.size
        self.lo = group.rank * self.m
        self._cache: dict = {}

    def place(self, k):
        """This rank's rows of a key [..., dnum, L+K, N] (a copy, so that
        the full key can be freed)."""
        from ..ckks.context import KeySwitchKey

        def rows(x):
            keep = min(self.m, max(0, x.shape[-2] - self.lo))
            out = x.new_zeros(x.shape[:-2] + (self.m, x.shape[-1]))
            out[..., :keep, :] = x[..., self.lo:self.lo + keep, :]
            return out

        return KeySwitchKey(rows(k.b), rows(k.a))

    def _owned(self, r: int, l: int):
        """(limb rows, special rows) of targets(l) in rank r's block."""
        ctx = self.ctx
        lo, hi = r * self.m, (r + 1) * self.m
        limbs = tuple(range(lo, min(hi, l)))
        sps = tuple(range(max(lo, ctx.L), min(hi, ctx.L + ctx.K)))
        return limbs, sps

    def _layout(self, l: int):
        if l not in self._cache:
            own = [self._owned(r, l) for r in range(self.group.size)]
            limbs, sps = own[self.group.rank]
            self._cache[l] = {
                "targets": limbs + sps,
                "key_rows": tuple(t - self.lo for t in limbs + sps),
                "limb_counts": [len(o[0]) for o in own],
                "sp_counts": [len(o[1]) for o in own]}
        return self._cache[l]

    def targets(self, l: int) -> tuple:
        """The target rows of level l this rank holds keys for."""
        return self._layout(l)["targets"]

    def key_rows(self, l: int) -> tuple:
        """targets(l) as indices into this rank's stored key rows."""
        return self._layout(l)["key_rows"]

    def switch(self, D, kb, ka, l: int) -> torch.Tensor:
        """Digits D [..., d_l, T_rank, N] on this rank's targets and its
        key rows -> the replicated switched pair [..., 2, l, N]."""
        lay = self._layout(l)
        out = switch_rows(self.ctx, D, kb, ka, l, lay["targets"], self.group,
                          lay["sp_counts"])
        return all_gather_rows(out, self.group, lay["limb_counts"])


class LimbShardedRotator:
    """Slot rotations of level-l ciphertexts whose limb rows are sharded
    over `group`: rank r holds rows [r*l/size, (r+1)*l/size)."""

    def __init__(self, ctx, group: RankGroup, level: int):
        assert ctx.gsize == 1, \
            "limb-sharded keyswitch assumes single-limb digits (dnum unset)"
        assert getattr(ctx.ntt, "order", "stockham") == "stockham", \
            "limb-sharded keyswitch runs on the Stockham transform"
        assert level % group.size == 0, (level, group.size)
        assert ctx._key_shard is None, "rotator needs unsharded keys"
        self.ctx = ctx
        self.group = group
        self.l = level
        m = level // group.size
        self.rows = tuple(range(group.rank * m, (group.rank + 1) * m))
        self.tgt = self.rows + tuple(range(ctx.L, ctx.L + ctx.K))
        self._keys: dict = {}

    def _key(self, g: int):
        """This rank's rows (its limbs and every special) of the level-l
        digits of Galois key g."""
        if g not in self._keys:
            k = self.ctx.galois_keys[g]
            idx = self.ctx._idx(self.tgt)
            self._keys[g] = tuple(x[:self.l].index_select(-2, idx)
                                  for x in (k.b, k.a))
        return self._keys[g]

    def shard(self, c: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a replicated ciphertext [..., 2, l, N]."""
        return c[..., self.rows[0]:self.rows[-1] + 1, :]

    def gather(self, c_loc: torch.Tensor) -> torch.Tensor:
        """Every rank's rows [..., 2, l/size, N] -> [..., 2, l, N]."""
        return all_gather_rows(c_loc, self.group)

    def rotate_local(self, c_loc: torch.Tensor, steps: int) -> torch.Tensor:
        """Rotate the ciphertext whose rows [2, l/size, N] this rank holds
        by `steps` -> this rank's rows of the result."""
        ctx, l = self.ctx, self.l
        ctx.ensure_galois([steps])
        g = ctx.galois_element(steps)
        kb, ka = self._key(g)
        cp = c_loc.index_select(-1, ctx.perm(g))
        co = ctx.ntt.intt_from_mont(cp[1], self.rows)
        co_all = all_gather_rows(co, self.group)         # [l, N] digits
        D = ctx._extend_digits(co_all, l, self.tgt)
        out = switch_rows(ctx, D, kb, ka, l, self.tgt)
        c0 = add_mod(cp[0], out[0], ctx._rows(ctx.ntt.p, self.rows))
        return torch.stack([c0, out[1]])

    def rotate(self, ct: Ciphertext, steps: int) -> Ciphertext:
        """Rotate a replicated level-l ciphertext through the limb-sharded
        keyswitch; the result is gathered (replicated)."""
        assert ct.level == self.l, (ct.level, self.l)
        c_loc = self.rotate_local(self.shard(ct.c), steps)
        return Ciphertext(self.gather(c_loc), ct.scale)
