"""BSGS diagonal-method matvec under CKKS -- the hot kernel of the
client-aided path.

Counterpart of `fhe_spear_tpu/ops/bsgs.py` (square-matrix engine,
"fused" contraction layout, full key stacks, wide staging).

  * Baby rotations are hoisted (one digit decomposition) and evaluated as
    ONE batched keyswitch over a stacked [G-1, ...] tensor of rotation keys
    and automorphism permutations -- in pieces where the rotated digits of
    all G-1 would pass `BABY_DIGIT_BYTES` (deep chains).
  * Giant groups run in chunks of FHE_GIANT_CHUNK (default 8): each chunk
    batches its diagonal expansion, its contraction against the G baby
    rotations, and its giant-rotation keyswitch.
  * Diagonals are pre-encoded on the host to coefficient-domain int32 and
    either expanded to NTT/Montgomery residues at block-load time
    ("expanded") or inside the kernel, one chunk of giant groups at a time
    (i32 staging: a bounded transient regardless of B or l).  Composite
    (width-2, ~2^56) scales stage two int32 planes per coefficient
    (`encode_wide`, expanded in the kernel by `rns_expand_wide`).
  * ONE level-independent stack of the full rotation keys; each call
    selects its level's digits and target rows from it (a deep chain
    walks ~20 levels).
  * Exactly one rescale at the end: 1 level per call.

Sums of canonical residues are exact in int64 and reduced once (`% p`),
which gives the words of the reference's modular tree reductions.  The
reference's "lead" contraction layout is a TPU padding workaround and is
not carried over.

Complex packing comes for free: a complex weight matrix W1 + i*W2 encodes
into complex diagonals and one call evaluates both matrices.

`DiagonalMatvec` runs the same kernel over a sparse offset set (the
collapsed-FFT stages of bootstrapping).  Where one of its steps is a
multiple of the slot count (Galois element 1: the last SlotToCoeff group
at N=16384 with radix 4), the stack holds the identity permutation and
`ctx.identity_ksk()`, so every lane runs the same keyswitch.
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

__all__ = ["bsgs_dims", "bsgs_kernel", "BsgsMatvec", "DiagonalMatvec",
           "EncodedDiagonals", "extract_diagonals", "rns_expand",
           "rns_expand_wide"]

# rotated baby digits [S, d_l, T, N] int64 per batched keyswitch: the
# keyswitch's transients are a few times this (1 GiB: one batch for every
# L=3 path; pieces of ~15 of the 45 rotations at N=16384, l=57, 8 digits)
BABY_DIGIT_BYTES = 1 << 30


def _split_i64(coeffs: np.ndarray) -> np.ndarray:
    """int64 [..., N] -> int32 planes [..., 2, N] with value =
    hi*2^31 + lo, lo in [0, 2^31) (two's-complement exact for negatives)."""
    lo = (coeffs & np.int64(0x7FFFFFFF)).astype(np.int32)
    hi = (coeffs >> np.int64(31)).astype(np.int32)
    return np.stack([lo, hi], axis=-2)


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
        self._full = None

    def galois_elements(self) -> set:
        """Galois elements of this engine's rotation steps (for
        CkksContext.drop_galois_keys after warm_stacks)."""
        return {self.ctx.galois_element(s)
                for s in self.baby_steps + self.giant_steps}

    def warm_stacks(self) -> set:
        """Build the key stack now, so that the raw per-element keys can be
        dropped (drop_galois_keys) before the memory peak of a deep run.
        Returns galois_elements()."""
        self._stacks()
        return self.galois_elements()

    # -- host-side diagonal pre-encoding -----------------------------------

    def encode(self, w: np.ndarray, scale: float | None = None
               ) -> EncodedDiagonals:
        ctx = self.ctx
        scale = ctx.scale if scale is None else scale
        diags = extract_diagonals(w, self.d)                    # [B, G, D]
        tiled = np.tile(diags, (1, 1, ctx.slots // self.d))     # [B, G, slots]
        return EncodedDiagonals(encode_i32(ctx.encoder, tiled, scale), scale,
                                self.d)

    def encode_wide(self, w: np.ndarray, scale: float) -> EncodedDiagonals:
        """Composite-scale (width-2, ~2^56) diagonal pre-encode: int64
        coefficients split into two int32 planes [B, G, 2, N] (value =
        hi*2^31 + lo; see rns_expand_wide)."""
        ctx = self.ctx
        diags = extract_diagonals(w, self.d)
        tiled = np.tile(diags, (1, 1, ctx.slots // self.d))
        coeffs = np.round(ctx.encoder.embed(tiled) * scale).astype(np.int64)
        limit = np.abs(coeffs).max(initial=0)
        assert limit < (1 << 62), (
            f"wide-encoded coefficient magnitude {limit} >= 2^62 "
            f"(scale {scale:g})")
        return EncodedDiagonals(_split_i64(coeffs), scale, self.d)

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
        """Level-l rotation keys: (baby_perms [G-1, N], baby_kb, baby_ka
        [G-1, d_l, T, N], giant_perms, giant_kb, giant_ka).  The level's
        digits and target rows are selected from the one full stack on each
        call (the caller holds the copy only while it runs; at the top level
        the stack itself is returned)."""
        ctx = self.ctx
        d_l, tgt = ctx.num_digits(l), ctx.targets(l)
        if d_l == ctx.dnum and len(tgt) == ctx.L + ctx.K:
            return self._stacks()
        idx = ctx._idx(tgt)
        bp, bkb, bka, gp, gkb, gka = self._stacks()
        sel = lambda k: k[:, :d_l].index_select(2, idx) if k.numel() else k
        return bp, sel(bkb), sel(bka), gp, sel(gkb), sel(gka)

    def _stacks(self):
        """The automorphism permutations [S, N] and the full rotation keys
        [S, dnum, L+K, N] of the baby and of the giant steps, stacked once:
        a deep chain walks ~20 levels on one copy of the keys."""
        if self._full is None:
            ctx = self.ctx

            def stack_keys(steps):
                gs = [ctx.galois_element(s) for s in steps]
                if not gs:
                    empty = torch.empty((0,), dtype=torch.long,
                                        device=ctx.device)
                    return (empty, empty, empty)
                # a step = 0 mod slots (Galois element 1) has no rotation
                # key: its lane switches with the identity key
                keys = [ctx.identity_ksk() if g == 1 else ctx.galois_keys[g]
                        for g in gs]
                return (torch.stack([ctx.perm(g) for g in gs]),
                        torch.stack([k.b for k in keys]),
                        torch.stack([k.a for k in keys]))

            self._full = (stack_keys(self.baby_steps)
                          + stack_keys(self.giant_steps))
        return self._full

    def babies(self, c: torch.Tensor, l: int, bp, bkb, bka) -> torch.Tensor:
        """The G hoisted baby rotations of c [2, l, N] -> [G, 2, l, N]
        (rotation 0 first): batched keyswitches of as many rotations as
        BABY_DIGIT_BYTES of rotated digits allow."""
        if not self.baby_steps:
            return c[None]
        D1 = self.ctx._decompose(c[1], l)
        bc = max(1, BABY_DIGIT_BYTES // (D1.numel() * D1.element_size()))
        rots = [self.ctx.keyswitch_rotated(c, D1, bp[i:i + bc],
                                           bkb[i:i + bc], bka[i:i + bc], l)
                for i in range(0, len(self.baby_steps), bc)]
        return torch.cat([c[None]] + rots)

    def giants(self, babies: torch.Tensor, pt: torch.Tensor, l: int,
               gp, gkb, gka, i32: bool = False, wide: bool = False
               ) -> torch.Tensor:
        """sum_g rot_{gG}(sum_b babies[b] * pt[g, b]) for the giant groups of
        pt ([B, G, l, N] residues; [B, G, N] int32 coefficients when i32;
        [B, G, 2, N] int32 planes when wide), then the rescale ->
        [2, l-1, N]."""
        ctx = self.ctx
        p, pinv = ctx._p(l)
        if wide:
            expand = lambda ptg: rns_expand_wide(ctx, ptg, l)
        elif i32:
            expand = lambda ptg: rns_expand(ctx, ptg, l)
        else:
            expand = lambda ptg: ptg

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

    def _kernel_raw(self, l: int, i32: bool = False, wide: bool = False):
        """kernel(c, pt, bp, bkb, bka, gp, gkb, gka) -> [2, l-1, N]: one
        ciphertext c [2, l, N] against one matrix pt.  i32=True: pt holds
        int32 coefficient encodings [B, G, N], RNS-expanded in chunks
        inside the kernel; wide=True: the two-plane format of
        `encode_wide`."""

        def kernel(c, pt, bp, bkb, bka, gp, gkb, gka):
            return self.giants(self.babies(c, l, bp, bkb, bka), pt, l,
                               gp, gkb, gka, i32=i32, wide=wide)
        return kernel


class DiagonalMatvec(BsgsMatvec):
    """Generalized BSGS over an arbitrary rotation-diagonal support.

    Evaluates y = sum_{o in offsets} diag_o * rot_o(x) for a sparse offset
    set (the collapsed-FFT bootstrap stages of ckks/dft.py, whose offsets
    are the lattice {j*h : |j| < 2^radix}).  Offsets are factored as
    o = (g*G + b) * u on the lattice of their gcd u; baby rotations are
    u*[1..G), giant rotations g*G*u (g may be negative; group row 0 is
    g = 0).  Same kernel, host staging and 1-level cost as the
    square-matrix engine.
    """

    def __init__(self, ctx: CkksContext, offsets):
        self.ctx = ctx
        s = ctx.slots
        signed = sorted({((o % s) + s // 2) % s - s // 2 for o in offsets})
        self.d = s
        u = 0
        for o in signed:
            u = math.gcd(u, abs(o))
        self.unit = u = max(u, 1)
        js = [o // u for o in signed]
        self.G = max(1, math.isqrt(len(js)))
        if self.G * self.G < len(js):
            self.G += 1
        gset = {j // self.G for j in js} | {0}
        self._g_list = [0] + sorted(g for g in gset if g != 0)
        self._g_row = {g: i for i, g in enumerate(self._g_list)}
        self.B = len(self._g_list)
        self.baby_steps = tuple(u * b for b in range(1, self.G))
        self.giant_steps = tuple(g * self.G * u for g in self._g_list[1:])
        self.giant_chunk = max(1, int(os.environ.get("FHE_GIANT_CHUNK", "8")))
        ctx.ensure_galois(self.baby_steps + self.giant_steps)
        self._full = None

    def slot_table(self, diags: dict) -> np.ndarray:
        """{offset: diagonal[slots]} -> the [B, G, slots] complex layout
        (group g's diagonals pre-rotated by +g*G*u for post-rotation)."""
        s = self.ctx.slots
        tbl = np.zeros((self.B, self.G, s), dtype=np.complex128)
        for o, v in diags.items():
            o_s = ((o % s) + s // 2) % s - s // 2
            j = o_s // self.unit
            assert j * self.unit == o_s, (o, self.unit)
            b = j % self.G
            g = (j - b) // self.G
            tbl[self._g_row[g], b] = np.roll(v, g * self.G * self.unit)
        return tbl

    def encode_table(self, diags: dict, scale: float | None = None
                     ) -> EncodedDiagonals:
        """int32 coefficients [B, G, N] of the slot table (the native batch
        encoder where it builds, the numpy encoder otherwise)."""
        ctx = self.ctx
        scale = ctx.scale if scale is None else scale
        return EncodedDiagonals(encode_i32(ctx.encoder, self.slot_table(diags),
                                           scale), scale, ctx.slots)


def bsgs_kernel(eng: BsgsMatvec, l: int, mode: str, i32: bool = False,
                wide: bool = False):
    """kern(c, pt) for one transport shape:
      "single":  c [2, l, N] against one matrix;
      "shared":  one c against stacked matrices pt [P, ...] (the baby
                 rotations are computed once and shared);
      "batched": c [P, 2, l, N] against matching matrices pt [P, ...].
    Matrices run one after another, so only one matrix's expanded residues
    are live at a time in i32 and wide staging (int32 coefficients)."""
    bp, bkb, bka, gp, gkb, gka = eng._xs(l)

    def one(babies, pt):
        return eng.giants(babies, pt, l, gp, gkb, gka, i32=i32, wide=wide)

    def kern(c, pt):
        if mode == "single":
            return one(eng.babies(c, l, bp, bkb, bka), pt)
        if mode == "shared":
            babies = eng.babies(c, l, bp, bkb, bka)
            return torch.stack([one(babies, q) for q in pt])
        return torch.stack([one(eng.babies(cq, l, bp, bkb, bka), q)
                            for cq, q in zip(c, pt)])
    return kern


def rns_expand(ctx: CkksContext, coeffs: torch.Tensor, level: int
               ) -> torch.Tensor:
    """Signed int32 coefficient encodings [..., N] -> NTT/Mont residues
    [..., l, N] (device-side RNS expansion; also the fused-encrypt core)."""
    rows = tuple(range(level))
    p, _ = ctx._p(level)
    r = coeffs.to(torch.int64)[..., None, :] % p      # canonical in [0, p)
    return ctx.ntt.ntt_to_mont(r, rows)


def rns_expand_wide(ctx: CkksContext, planes: torch.Tensor, level: int
                    ) -> torch.Tensor:
    """Two-plane int64-split coefficient encodings [..., 2, N] (value =
    hi*2^31 + lo, |value| < 2^62) -> NTT/Mont residues [..., l, N]: the
    wide staging word of composite-scale (width-2) diagonals.  The value is
    formed exactly in int64 and reduced once, which gives the reference's
    canonical words."""
    rows = tuple(range(level))
    p, _ = ctx._p(level)
    v = (planes[..., 1, :].to(torch.int64) * (1 << 31)
         + planes[..., 0, :].to(torch.int64))
    return ctx.ntt.ntt_to_mont(v[..., None, :] % p, rows)


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
