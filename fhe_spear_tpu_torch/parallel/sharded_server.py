"""Client-aided RWKV server with every projection giant-sharded over a
rank group.

Counterpart of `fhe_spear_tpu/parallel/sharded_server.py`: a drop-in for
`models.client_aided.FheRwkvServer` on the explicit (Ciphertext)
transport.  The four protocol projections -- r/k/v, W_o, the FFN key and
value chunk pairs -- run the giant-sharded kernel
(`sharded_bsgs.ShardedBsgsMatvec`) one matrix at a time, and each rank
stages only its giant groups of every block's diagonals.  Every rank runs
the same client (`FheRwkvClient(..., fused=False)`) from the same seeds, so
ciphertexts in and out are replicated.

The fused transport (`fused_project`) is not sharded: it raises.
"""

from __future__ import annotations

import torch

from ..ckks.ciphertext import Ciphertext
from ..models.client_aided import FheRwkvServer
from .collectives import RankGroup
from .sharded_bsgs import ShardedBsgsMatvec

__all__ = ["ShardedFheRwkvServer"]


class ShardedFheRwkvServer(FheRwkvServer):
    def __init__(self, ctx, model, group: RankGroup, level: int = 3, **kw):
        super().__init__(ctx, model, level=level, **kw)
        self.group = group
        self.sharded = ShardedBsgsMatvec(ctx, self.d, group)
        lo, hi = self.sharded.lo, self.sharded.hi
        # every host stack is [..., B, G, N]: keep this rank's groups, so
        # that load_block stages them alone
        self.blocks_host = [{k: v[..., lo:hi, :, :] for k, v in h.items()}
                            for h in self.blocks_host]

    def _sharded_one(self, c: torch.Tensor, pt: torch.Tensor) -> torch.Tensor:
        return self.sharded.kernel(c.shape[-2])(c, pt)

    def project_rkv(self, i: int, ct3: Ciphertext) -> Ciphertext:
        pt = self.load_block(i)["rkv"]                # [3, B/size, G, N]
        outs = [self._sharded_one(ct3.c[k], pt[k]) for k in range(3)]
        return Ciphertext(torch.stack(outs), self._out_scale(ct3))

    def project_o(self, i: int, ct: Ciphertext) -> Ciphertext:
        pt = self.load_block(i)["o"]
        return Ciphertext(self._sharded_one(ct.c, pt), self._out_scale(ct))

    def project_ffn_key(self, i: int, ct: Ciphertext) -> Ciphertext:
        pt = self.load_block(i)["ffn_key"]            # [P, B/size, G, N]
        outs = [self._sharded_one(ct.c, pt[k]) for k in range(pt.shape[0])]
        return Ciphertext(torch.stack(outs), self._out_scale(ct))

    def project_ffn_val(self, i: int, ct_pairs: Ciphertext) -> Ciphertext:
        pt = self.load_block(i)["ffn_val"]
        outs = [self._sharded_one(ct_pairs.c[k], pt[k])
                for k in range(pt.shape[0])]
        return Ciphertext(torch.stack(outs), self._out_scale(ct_pairs))

    def fused_project(self, *args, **kw):
        raise NotImplementedError("the sharded server runs the explicit "
                                  "transport (FheRwkvClient(fused=False))")
