"""BSGS diagonal-method matvec under CKKS -- the hot kernel of the
client-aided path.

Counterpart of `fhe_spear_tpu/ops/bsgs.py` (square-matrix engine,
"fused" contraction layout).

  * Baby rotations are hoisted (one digit decomposition) and evaluated as
    ONE batched keyswitch over a stacked [G-1, ...] tensor of rotation keys
    and automorphism permutations.
  * Giant groups run in chunks of FHE_GIANT_CHUNK (default 8): each chunk
    batches its diagonal expansion, its contraction against the G baby
    rotations, and its giant-rotation keyswitch.
  * Diagonals are pre-encoded on the host to coefficient-domain int32 and
    either expanded to NTT/Montgomery residues at block-load time
    ("expanded") or inside the kernel, one chunk of giant groups at a time
    (i32 staging: a bounded transient regardless of B or l).
  * Exactly one rescale at the end: 1 level per call.

Sums of canonical residues are exact in int64 and reduced once (`% p`),
which gives the words of the reference's modular tree reductions.  The
reference's "lead" contraction layout is a TPU padding workaround and is
not carried over.

Complex packing comes for free: a complex weight matrix W1 + i*W2 encodes
into complex diagonals and one call evaluates both matrices.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..ckks.ciphertext import Ciphertext
from ..ckks.context import CkksContext
from ..core.modops import add_mod, mont_mul
from ..native import encode_i32

__all__ = ["bsgs_dims", "BsgsMatvec", "EncodedDiagonals", "extract_diagonals",
           "rns_expand"]


def bsgs_dims(d: int) -> tuple[int, int]:
    """(G, B): G = ceil(sqrt(D)) baby steps, B = ceil(D/G) giant groups."""
    g = math.isqrt(d)
    if g * g < d:
        g += 1
    return g, (d + g - 1) // g


def extract_diagonals(w: np.ndarray, d: int | None = None) -> np.ndarray:
    """delta_k[j] = W[j, (j+k) % D] for k = 0..G*B-1 (zero-padded past D),
    pre-rotated left by -(g*G) within each giant group: [B, G, D]."""
    w = np.asarray(w)
    d = w.shape[0] if d is None else d
    assert w.shape == (d, d), w.shape
    G, B = bsgs_dims(d)
    j = np.arange(d)
    k = np.arange(G * B)
    diags = np.where((k < d)[:, None],
                     w[j[None, :], (j[None, :] + k[:, None]) % d],
                     0.0 if not np.iscomplexobj(w) else 0.0 + 0.0j)
    diags = diags.reshape(B, G, d)
    # pre-rotate group g by +g*G (so the giant rotation can happen after the
    # baby-step accumulation): rot_{-gG}(delta) = np.roll(delta, +gG)
    for g in range(1, B):
        diags[g] = np.roll(diags[g], g * G, axis=-1)
    return diags


@dataclass
class EncodedDiagonals:
    """Host-staged pre-encoded diagonal plaintexts for one BSGS matrix.

    coeffs: int32 [B, G, N] coefficient-domain encodings (signed, centered).
    Stays in host RAM until `BsgsMatvec.load` stages it to the device.
    """

    coeffs: np.ndarray
    scale: float
    d: int


class BsgsMatvec:
    """BSGS matvec engine for a fixed (context, D) configuration.

    Usage:
        eng = BsgsMatvec(ctx, d=1024)
        enc = eng.encode(W)              # host: [B, G, N] int32
        pt  = eng.load(enc, level)       # device: [B, G, l, N] NTT/Mont
        y   = eng(ct_x, pt)              # level l -> l-1, slots = W @ x
    """

    def __init__(self, ctx: CkksContext, d: int):
        assert ctx.slots % d == 0, (d, ctx.slots)
        self.ctx = ctx
        self.d = d
        self.G, self.B = bsgs_dims(d)
        self.baby_steps = tuple(range(1, self.G))
        self.giant_steps = tuple(g * self.G for g in range(1, self.B))
        self.giant_chunk = max(1, int(os.environ.get("FHE_GIANT_CHUNK", "8")))
        ctx.ensure_galois(self.baby_steps + self.giant_steps)
        self._xs_cache: dict = {}

    # -- host-side diagonal pre-encoding -----------------------------------

    def encode(self, w: np.ndarray, scale: float | None = None
               ) -> EncodedDiagonals:
        ctx = self.ctx
        scale = ctx.scale if scale is None else scale
        diags = extract_diagonals(w, self.d)                    # [B, G, D]
        tiled = np.tile(diags, (1, 1, ctx.slots // self.d))     # [B, G, slots]
        return EncodedDiagonals(encode_i32(ctx.encoder, tiled, scale), scale,
                                self.d)

    # -- device staging ----------------------------------------------------

    def load(self, enc: EncodedDiagonals, level: int) -> torch.Tensor:
        """Stage host int32 coefficients -> device NTT/Mont residues
        [B, G, l, N]."""
        return _load_coeffs(self.ctx, enc.coeffs, level)

    # -- the matvec kernel -------------------------------------------------

    def __call__(self, ct: Ciphertext, pt: torch.Tensor,
                 pt_scale: float | None = None) -> Ciphertext:
        l = ct.level
        assert pt.shape[-2] == l, (pt.shape, l)
        scale = self.ctx.scale if pt_scale is None else pt_scale
        out = self._kernel_raw(l)(ct.c, pt, *self._xs(l))
        return Ciphertext(out, ct.scale * scale / float(self.ctx.q_np[l - 1]))

    def _xs(self, l: int):
        """Stacked level-l rotation keys: (baby_perms [G-1, N], baby_kb,
        baby_ka [G-1, d_l, T, N], giant_perms, giant_kb, giant_ka).
        The cache holds at most 2 levels: each is a full copy of every
        rotation key."""
        if l not in self._xs_cache:
            ctx = self.ctx
            while len(self._xs_cache) >= 2:
                self._xs_cache.pop(next(iter(self._xs_cache)))

            def stack_keys(steps):
                gs = [ctx.galois_element(s) for s in steps]
                if not gs:
                    empty = torch.empty((0,), dtype=torch.long,
                                        device=ctx.device)
                    return (empty, empty, empty)
                perms = torch.stack([ctx.perm(g) for g in gs])
                kb, ka = zip(*(ctx.select_key(ctx.galois_keys[g], l)
                               for g in gs))
                return (perms, torch.stack(kb), torch.stack(ka))

            self._xs_cache[l] = (stack_keys(self.baby_steps)
                                 + stack_keys(self.giant_steps))
        return self._xs_cache[l]

    def babies(self, c: torch.Tensor, l: int, bp, bkb, bka) -> torch.Tensor:
        """The G hoisted baby rotations of c [2, l, N] -> [G, 2, l, N]
        (rotation 0 first), one batched keyswitch."""
        if not self.baby_steps:
            return c[None]
        D1 = self.ctx._decompose(c[1], l)
        rots = self.ctx.keyswitch_rotated(c, D1, bp, bkb, bka, l)
        return torch.cat([c[None], rots])

    def giants(self, babies: torch.Tensor, pt: torch.Tensor, l: int,
               gp, gkb, gka, i32: bool = False) -> torch.Tensor:
        """sum_g rot_{gG}(sum_b babies[b] * pt[g, b]) for the giant groups of
        pt ([B, G, l, N] residues, or [B, G, N] int32 coefficients when
        i32), then the rescale -> [2, l-1, N]."""
        ctx = self.ctx
        p, pinv = ctx._p(l)
        expand = ((lambda ptg: rns_expand(ctx, ptg, l)) if i32
                  else (lambda ptg: ptg))

        def contract(ptg):
            """sum_b babies[b] * ptg[..., b]: [G, 2, l, N] x [..., G, l, N]
            -> [..., 2, l, N]."""
            prod = mont_mul(babies, ptg[..., :, None, :, :], p, pinv)
            return prod.sum(dim=-4) % p

        y = contract(expand(pt[0]))
        ng = len(self.giant_steps)
        for c0 in range(0, ng, self.giant_chunk):
            c1 = min(ng, c0 + self.giant_chunk)
            accs = contract(expand(pt[1 + c0: 1 + c1]))     # [c, 2, l, N]
            perms = gp[c0:c1]
            D2 = ctx._decompose(accs[:, 1], l)              # [c, d_l, T, N]
            Dg = torch.gather(D2, -1, perms[:, None, None, :].expand_as(D2))
            ks = ctx._mod_down(ctx._apply_ksk(Dg, gkb[c0:c1], gka[c0:c1], l),
                               l)
            a0 = torch.gather(accs[:, 0], -1,
                              perms[:, None, :].expand_as(accs[:, 0]))
            rot0 = add_mod(a0, ks[:, 0], p)
            part = torch.stack([rot0.sum(dim=0), ks[:, 1].sum(dim=0)]) % p
            y = add_mod(y, part, p)
        return ctx._rescale_core(y, l)

    def _kernel_raw(self, l: int, i32: bool = False):
        """kernel(c, pt, bp, bkb, bka, gp, gkb, gka) -> [2, l-1, N]: one
        ciphertext c [2, l, N] against one matrix pt.  i32=True: pt holds
        int32 coefficient encodings [B, G, N], RNS-expanded in chunks
        inside the kernel."""

        def kernel(c, pt, bp, bkb, bka, gp, gkb, gka):
            return self.giants(self.babies(c, l, bp, bkb, bka), pt, l,
                               gp, gkb, gka, i32=i32)
        return kernel


def rns_expand(ctx: CkksContext, coeffs: torch.Tensor, level: int
               ) -> torch.Tensor:
    """Signed int32 coefficient encodings [..., N] -> NTT/Mont residues
    [..., l, N] (device-side RNS expansion; also the fused-encrypt core)."""
    rows = tuple(range(level))
    p, _ = ctx._p(level)
    r = coeffs.to(torch.int64)[..., None, :] % p      # canonical in [0, p)
    return ctx.ntt.ntt_to_mont(r, rows)


def _load_coeffs(ctx: CkksContext, coeffs: np.ndarray, level: int
                 ) -> torch.Tensor:
    """Host int32 [rows, ..., N] -> device residues [rows, ..., l, N],
    expanded one leading row at a time to bound the transient."""
    x = torch.as_tensor(np.asarray(coeffs), device=ctx.device)
    out = torch.empty(x.shape[:-1] + (level, ctx.n), dtype=torch.int64,
                      device=ctx.device)
    for i in range(x.shape[0]):
        out[i] = rns_expand(ctx, x[i], level)
    return out
