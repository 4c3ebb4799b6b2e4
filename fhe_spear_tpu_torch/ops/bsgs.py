"""BSGS diagonal-method matvec under CKKS -- the hot kernel of the
client-aided path.

Counterpart of `fhe_spear_tpu/ops/bsgs.py` (square-matrix engine,
"fused" contraction layout, full key stacks, wide staging).

  * Baby rotations are hoisted (one digit decomposition) and evaluated as
    ONE batched keyswitch over a stacked [G-1, ...] tensor of rotation keys
    and automorphism permutations -- in pieces where the rotated digits of
    all G-1 would pass `BABY_DIGIT_BYTES` (deep chains).
  * Giant groups run in chunks of GIANT_CHUNK (the contraction kernel's
    MAX_C, 8): each chunk batches its diagonal expansion, its contraction
    against the G baby rotations, and its giant-rotation keyswitch.
  * A staged matrix holds its diagonals in one of three formats, fixed
    when it is staged and read from the tensor by `expand_groups` alone:
    NTT/Mont residues [B, G, l, N] int64 (`load`), int32 coefficients
    [B, G, N] (`encode`, expanded inside the kernel one chunk of giant
    groups at a time: a bounded transient regardless of B or l), or, for
    composite (width-2, ~2^56) scales, two int32 planes [B, G, 2, N] a
    coefficient (`encode_wide`, expanded by `rns_expand_wide`).
  * ONE level-independent stack of the full rotation keys; each call
    selects its level's digits and target rows from it (a deep chain
    walks ~20 levels).
  * Exactly one rescale at the end: 1 level per call.
  * With `key_sharding` (a rank group whose context ran
    `CkksContext.shard_eval_keys`), the stacks hold this rank's key rows
    only, and every keyswitch runs the context's limb-sharded path: the
    words are the unsharded engine's.

Sums of canonical residues are exact in int64 and reduced once (`% p`),
which gives the words of the reference's modular tree reductions.  On
the card the baby-step contraction is one hand-written kernel a giant
chunk (`ops/bsgs_cuda.bsgs_contract`), which sums the same way.  The
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
from dataclasses import dataclass

import numpy as np
import torch

from ..ckks.ciphertext import Ciphertext
from ..ckks.context import CkksContext
from ..ckks.device_encrypt import rns_expand, rns_expand_wide
from ..core.modops import add_mod, mont_mul
from ..native import encode_i32
from .bsgs_cuda import MAX_C, bsgs_contract

__all__ = ["bsgs_dims", "bsgs_kernel", "BsgsMatvec", "DiagonalMatvec",
           "EncodedDiagonals", "GIANT_CHUNK", "contract_plain",
           "expand_groups", "extract_diagonals", "level_keys", "rns_expand",
           "rns_expand_wide", "rotate_sum", "stack_keys"]

# giant groups a chunk: one launch of the contraction kernel
GIANT_CHUNK = MAX_C

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
                                         # (or enc.coeffs as they are)
        y   = eng(ct_x, pt)              # level l -> l-1, slots = W @ x
    """

    def __init__(self, ctx: CkksContext, d: int, key_sharding=None):
        """key_sharding: the rank group over which the context's evaluation
        keys are (or will be, before the first call) limb-sharded by
        `CkksContext.shard_eval_keys`; the stacks then hold this rank's key
        rows, so their memory divides by the group size."""
        assert ctx.slots % d == 0, (d, ctx.slots)
        self.G, self.B = bsgs_dims(d)
        self._setup(ctx, d, tuple(range(1, self.G)),
                    tuple(g * self.G for g in range(1, self.B)),
                    key_sharding)

    def _setup(self, ctx: CkksContext, d: int, baby_steps: tuple,
               giant_steps: tuple, key_sharding) -> None:
        """The state every engine shares: its rotation steps, their keys
        generated now (the reference's draw order), no key stack yet."""
        self.ctx = ctx
        self.d = d
        self.baby_steps = baby_steps
        self.giant_steps = giant_steps
        self.key_sharding = key_sharding
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
        """W x for one ciphertext and one staged matrix pt, in any format
        of `expand_groups` (which holds residues to the level)."""
        l = ct.level
        scale = self.ctx.scale if pt_scale is None else pt_scale
        out = bsgs_kernel(self, l, "single")(ct.c, pt)
        return Ciphertext(out, ct.scale * scale / float(self.ctx.q_np[l - 1]))

    def _xs(self, l: int):
        """Level-l rotation keys: (baby_perms [G-1, N], baby_kb, baby_ka
        [G-1, d_l, T, N], giant_perms, giant_kb, giant_ka).  The level's
        digits and target rows are selected from the one full stack on each
        call (the caller holds the copy only while it runs; at the top level
        the stack itself is returned)."""
        return level_keys(self.ctx, self._stacks(), l)

    def _stacks(self):
        """The automorphism permutations [S, N] and the full rotation keys
        [S, dnum, L+K, N] of the baby and of the giant steps, stacked once:
        a deep chain walks ~20 levels on one copy of the keys.  Stacks built
        before the context's keys were replaced (an older `key_epoch`) are
        rebuilt from the current keys, generating any that are missing."""
        ctx = self.ctx
        if self._full is not None and self._full_epoch != ctx.key_epoch:
            self._full = None                   # free the stale stacks first
            ctx.ensure_galois(self.baby_steps + self.giant_steps)
        if self._full is None:
            if self.key_sharding is not None and (
                    ctx._key_shard is None
                    or ctx._key_shard.group is not self.key_sharding):
                raise ValueError("key_sharding is set but the context's keys "
                                 "are not sharded over that group "
                                 "(CkksContext.shard_eval_keys)")
            self._full = (stack_keys(ctx, self.baby_steps)
                          + stack_keys(ctx, self.giant_steps))
            self._full_epoch = ctx.key_epoch
        return self._full

    def babies(self, c: torch.Tensor, l: int, bp, bkb, bka) -> torch.Tensor:
        """The G hoisted baby rotations of c [2, l, N] -> [G, 2, l, N]
        (rotation 0 first): batched keyswitches of as many rotations as
        BABY_DIGIT_BYTES of rotated digits allow."""
        if not self.baby_steps:
            return c[None]
        D1 = self.ctx._decompose(c[1], l)
        # a rank of a key-sharded context may hold no target row at level l
        bc = max(1, BABY_DIGIT_BYTES
                 // max(1, D1.numel() * D1.element_size()))
        rots = [self.ctx.keyswitch_rotated(c, D1, bp[i:i + bc],
                                           bkb[i:i + bc], bka[i:i + bc], l)
                for i in range(0, len(self.baby_steps), bc)]
        return torch.cat([c[None]] + rots)

    def contract(self, babies: torch.Tensor, ptg: torch.Tensor, l: int
                 ) -> torch.Tensor:
        """sum_b babies[b] * ptg[..., b]: [G, 2, l, N] x [..., G, l, N]
        -> [..., 2, l, N].  CUDA tensors launch the kernel `bsgs_contract`
        (csrc/bsgs.cu); CPU tensors run its plain version, the torch tree
        `contract_plain`, whose words the kernel's equal."""
        p, pinv = self.ctx._p(l)
        if babies.is_cuda:
            return bsgs_contract(babies.contiguous(), ptg.contiguous(), p,
                                 pinv)
        return contract_plain(babies, ptg, p, pinv)

    def giants(self, babies: torch.Tensor, pt: torch.Tensor, l: int,
               gp, gkb, gka) -> torch.Tensor:
        """sum_g rot_{gG}(sum_b babies[b] * pt[g, b]) for the giant groups of
        one staged matrix pt (any format of `expand_groups`), then the
        rescale -> [2, l-1, N]."""
        ctx = self.ctx
        p, _ = ctx._p(l)
        contract = lambda groups: self.contract(
            babies, expand_groups(ctx, pt, l, groups), l)
        y = contract(0)
        ng = len(self.giant_steps)
        for c0 in range(0, ng, GIANT_CHUNK):
            c1 = min(ng, c0 + GIANT_CHUNK)
            accs = contract(slice(1 + c0, 1 + c1))          # [c, 2, l, N]
            part = rotate_sum(ctx, accs, gp[c0:c1], gkb[c0:c1], gka[c0:c1], l)
            y = add_mod(y, part, p)
        return ctx._rescale_core(y, l)


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
        s = ctx.slots
        signed = sorted({((o % s) + s // 2) % s - s // 2 for o in offsets})
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
        self._setup(ctx, s, tuple(u * b for b in range(1, self.G)),
                    tuple(g * self.G * u for g in self._g_list[1:]), None)

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


def contract_plain(babies: torch.Tensor, ptg: torch.Tensor, p: torch.Tensor,
                   pinv: torch.Tensor) -> torch.Tensor:
    """The plain version of the kernel `bsgs_contract`: sum_b
    mont(babies[b] * ptg[..., b]) mod p, [G, 2, l, N] x [..., G, l, N] ->
    [..., 2, l, N], as a torch tree (an int64 mont_mul of the whole
    product, a sum over b, one `% p`)."""
    prod = mont_mul(babies, ptg[..., :, None, :, :], p, pinv)
    return prod.sum(dim=-4) % p


def stack_keys(ctx: CkksContext, steps):
    """(perms [S, N], kb, ka [S, dnum, rows, N]) of the rotation steps, in
    order, from the context's stored keys.  A step = 0 mod slots (Galois
    element 1) has no rotation key: its lane switches with the identity
    key."""
    gs = [ctx.galois_element(s) for s in steps]
    if not gs:
        empty = torch.empty((0,), dtype=torch.long, device=ctx.device)
        return (empty, empty, empty)
    keys = [ctx.identity_ksk() if g == 1 else ctx.galois_keys[g] for g in gs]
    return (torch.stack([ctx.perm(g) for g in gs]),
            torch.stack([k.b for k in keys]),
            torch.stack([k.a for k in keys]))


def level_keys(ctx: CkksContext, stacks, l: int):
    """The level-l digits and key rows of stacks (perms, kb, ka, ...) (the
    stacks themselves where the level takes every digit and row)."""
    d_l, rows = ctx.num_digits(l), ctx._key_rows(l)
    if d_l == ctx.dnum and rows == tuple(range(ctx.relin_key.b.shape[-2])):
        return stacks
    idx = ctx._idx(rows)
    sel = lambda k: k[:, :d_l].index_select(2, idx) if k.numel() else k
    return tuple(k if i % 3 == 0 else sel(k) for i, k in enumerate(stacks))


def rotate_sum(ctx: CkksContext, accs: torch.Tensor, perms: torch.Tensor,
               kb: torch.Tensor, ka: torch.Tensor, l: int) -> torch.Tensor:
    """sum_i rot_i(accs[i]) for ciphertexts accs [c, 2, l, N], each by its
    own automorphism perms[i] with level-selected keys kb/ka [c, d_l, T,
    N] -> [2, l, N]."""
    p, _ = ctx._p(l)
    D2 = ctx._decompose(accs[:, 1], l)              # [c, d_l, T, N]
    Dg = torch.gather(D2, -1, perms[:, None, None, :].expand_as(D2))
    ks = ctx._keyswitch(Dg, kb, ka, l)
    a0 = torch.gather(accs[:, 0], -1, perms[:, None, :].expand_as(accs[:, 0]))
    rot0 = add_mod(a0, ks[:, 0], p)
    return torch.stack([rot0.sum(dim=0), ks[:, 1].sum(dim=0)]) % p


def bsgs_kernel(eng: BsgsMatvec, l: int, mode: str):
    """kern(c, pt) for one transport shape:
      "single":  c [2, l, N] against one matrix;
      "shared":  one c against stacked matrices pt [P, ...] (the baby
                 rotations are computed once and shared);
      "batched": c [P, 2, l, N] against matching matrices pt [P, ...].
    Each matrix is in any format of `expand_groups`.  Matrices run one
    after another, so only one chunk's expanded residues are live at a
    time.  The level's keys are selected once, and again after the
    context's keys were replaced (`key_epoch`)."""
    sel = [None, None]                      # [epoch, level-l keys]

    def keys():
        if sel[0] != eng.ctx.key_epoch:
            sel[1] = eng._xs(l)
            sel[0] = eng.ctx.key_epoch
        return sel[1]

    def kern(c, pt):
        bp, bkb, bka, *giant = keys()
        if mode == "single":
            return eng.giants(eng.babies(c, l, bp, bkb, bka), pt, l, *giant)
        if mode == "shared":
            babies = eng.babies(c, l, bp, bkb, bka)
            return torch.stack([eng.giants(babies, q, l, *giant) for q in pt])
        return torch.stack([eng.giants(eng.babies(cq, l, bp, bkb, bka), q, l,
                                       *giant)
                            for cq, q in zip(c, pt)])
    keys()
    return kern


def expand_groups(ctx: CkksContext, pt: torch.Tensor, l: int, groups
                  ) -> torch.Tensor:
    """The giant groups `groups` (an index or a slice of axis 0) of one
    staged matrix pt as NTT/Mont residues at level l.  The one place that
    reads a staged matrix's format, from its dtype and rank:
      int64 [B, G, l, N]  residues (`BsgsMatvec.load`): passed through;
      int32 [B, G, N]     coefficients (`encode`): `rns_expand`;
      int32 [B, G, 2, N]  planes (`encode_wide`): `rns_expand_wide`."""
    if pt.dtype == torch.int64 and pt.dim() == 4:
        assert pt.shape[-2] == l, (tuple(pt.shape), l)
        return pt[groups]
    if pt.dtype == torch.int32 and pt.dim() == 3:
        return rns_expand(ctx, pt[groups], l)
    if pt.dtype == torch.int32 and pt.dim() == 4 and pt.shape[-2] == 2:
        return rns_expand_wide(ctx, pt[groups], l)
    raise ValueError(f"not a staged matrix: {pt.dtype} {tuple(pt.shape)}")


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
