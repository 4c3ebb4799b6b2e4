"""CKKS bootstrapping: ModRaise -> CoeffToSlot -> EvalMod -> SlotToCoeff.

Counterpart of `fhe_spear_tpu/ckks/bootstrap.py`:

  * ModRaise is the centered base extension: one iNTT of limb 0 (K2 with
    the Montgomery conversion folded in), a Barrett re-reduction to all L
    rows, one NTT of every row (K1, conversion folded in).  The level-1
    residue re-expressed mod the full Q decrypts to v = Delta*m + q0*I with
    |I| <~ O(sqrt(h)) for a sparse ternary secret of Hamming weight h.
  * CoeffToSlot / SlotToCoeff are either dense S x S BSGS matvecs
    (`radix=None`, small rings) or collapsed FFT stage groups
    (`ckks/dft.py`) evaluated by `ops/bsgs.DiagonalMatvec` -- the only
    feasible mode at production rings.  Conjugation supplies the z-bar
    terms.
  * EvalMod approximates t -> e^(2*pi*i*t/(q0*2^r)) by a Chebyshev series
    (`ops/polyeval`) and squares r times, on the real and imaginary
    coefficient streams separately; the final Im(.) extraction constants
    fold q0/(2*pi*Delta_d) so slots come out in original units.
  * The message is re-scaled to Delta_d = scale/2^margin_bits before
    ModRaise: margin trades sine linearization error against noise
    amplification by gamma = q0/(2*pi*Delta_d).

The reference's `vmap` over the pair {ct, conj(ct)} of the dense maps is
one "batched" call of `bsgs_kernel`.  Every transform of the refresh
(ModRaise, every stage keyswitch's digit extensions and mod-downs, the
rescales, the staged diagonals' expansion) runs kernels K1/K2 on the card.

Level cost ~ 15-17 limbs at width 1 (~34-37 at width 2); construct the
context with a sparse secret (secret_hamming_weight ~ 64).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.bsgs import BsgsMatvec, DiagonalMatvec, _load_coeffs, bsgs_kernel
from ..ops.polyeval import _mul_scalar_c, chebyshev_fit, eval_chebyshev
from .ciphertext import Ciphertext
from .context import CkksContext
from .dft import collapse_stages, inverse_stages, special_fft_stages

__all__ = ["Bootstrapper"]


class _FactorGroup:
    """One collapsed-FFT stage group, evaluated as a generalized-BSGS
    diagonal matvec.  The plaintext scale is prime-matched per level so
    the ciphertext scale is exactly preserved -- or, when `target_scale`
    is set (the last group of a direction), exactly retargeted.

    width=2 encodes the stage diagonals at the two-prime product scale
    (~2^56) and rescales twice per stage: the plaintext-encode rounding
    error drops from 2^-28 to ~2^-53 relative.  Costs one extra level per
    stage; used for CoeffToSlot (large slots), not SlotToCoeff."""

    def __init__(self, ctx: CkksContext, diags: dict,
                 target_scale: float | None = None, width: int = 1):
        self.ctx = ctx
        self.diags = diags
        self.target = target_scale
        self.w = width
        self.eng = DiagonalMatvec(ctx, list(diags.keys()))
        self._cache: dict = {}

    def _stage_wide(self, l: int, sp: float) -> torch.Tensor:
        """Host-encode the group's diagonal table at wide scale sp (int64
        coefficients, beyond the int32 staging word) and expand to device
        residues [B, G, l, N]."""
        ctx = self.ctx
        tbl = self.eng.slot_table(self.diags)            # [B, G, slots]
        coeffs = np.round(ctx.encoder.embed(tbl) * sp).astype(np.int64)
        return ctx._to_eval_mont(coeffs, tuple(range(l)))

    def __call__(self, ct: Ciphertext) -> Ciphertext:
        ctx = self.ctx
        l = ct.level
        key = (l, ct.scale) if self.target else l
        if key not in self._cache:
            sp = float(ctx.q_np[l - 1])
            if self.w > 1:
                for j in range(2, self.w + 1):
                    sp *= float(ctx.q_np[l - j])
            if self.target:
                sp *= self.target / ct.scale
            if self.w > 1:
                pt = self._stage_wide(l, sp)
            else:
                pt = self.eng.load(self.eng.encode_table(self.diags,
                                                         scale=sp), l)
            self._cache[key] = (pt, sp)
        pt, sp = self._cache[key]
        out = self.eng(ct, pt, pt_scale=sp)
        for _ in range(self.w - 1):
            out = ctx.rescale(out)
        if self.target:
            out = Ciphertext(out.c, self.target)  # exact by sp construction
        return out


class Bootstrapper:
    def __init__(self, ctx: CkksContext, exp_degree: int = 31,
                 range_k: int | None = None, margin_bits: int = 3,
                 radix: int | None = 4, double_angles: int | None = None,
                 evalmod_width: int = 1):
        """radix=None: dense S x S CoeffToSlot/SlotToCoeff (1 level each,
        small rings).  radix=k: factorized level-collapsed FFT stages of
        <= 2^(k+1)-1 diagonals each.

        double_angles: number of squarings r after the Chebyshev exp
        (default ceil(log2(K+1)), just enough to cover the ModRaise
        integer range).

        evalmod_width: scale width w of the EvalMod segment (w=2 evaluates
        the Chebyshev chain at Delta^2 ~ 2^56, two rescales per multiply:
        the width that reaches reference-grade refresh error at production
        rings; costs ~(5 + r) extra limbs)."""
        assert ctx.params.secret_hamming_weight is not None, \
            "bootstrap needs a sparse secret (secret_hamming_weight)"
        self.ctx = ctx
        h = ctx.params.secret_hamming_weight
        # |I| <= K w.h.p.: I coeffs ~ Gaussian, std ~ sqrt(h/12)
        self.K = range_k if range_k is not None else max(
            8, int(math.ceil(5.0 * math.sqrt(h / 12.0))))
        self.r = (double_angles if double_angles is not None
                  else max(1, math.ceil(math.log2(self.K + 1))))
        self.width = evalmod_width
        self.margin_bits = margin_bits
        self.delta_d = ctx.scale / float(1 << margin_bits)
        self.q0 = float(ctx.q_np[0])

        s = ctx.slots
        ctx.ensure_galois([], conj=True)
        m = s.bit_length() - 1
        self.radix = min(radix, m) if radix else None

        if self.radix:
            # the last group of each direction retargets the ciphertext
            # scale to exactly ctx.scale; C2S stages take the wide scale
            # (their inputs carry the large raised-coefficient slots), S2C
            # inputs are unit-magnitude and stay single-prime
            c2s_g = collapse_stages(inverse_stages(s), self.radix, s)
            s2c_g = collapse_stages(special_fft_stages(s), self.radix, s)
            self._c2s_f = [
                _FactorGroup(ctx, g,
                             ctx.scale if i == len(c2s_g) - 1 else None,
                             width=self.width)
                for i, g in enumerate(c2s_g)]
            self._s2c_f = [
                _FactorGroup(ctx, g,
                             ctx.scale if i == len(s2c_g) - 1 else None)
                for i, g in enumerate(s2c_g)]
            self.linear_levels = self.width * len(c2s_g) + len(s2c_g)
        else:
            self.eng = BsgsMatvec(ctx, s)
            self.linear_levels = 2

            # --- CoeffToSlot matrices: w = A z + B conj(z) ---------------
            enc = ctx.encoder
            eye = np.eye(s)
            e1 = enc.embed(eye)                   # [j, N]: coeffs of e_j
            e2 = enc.embed(1j * eye)
            ap = (e1 - 1j * e2) / 2               # A'[n, j] = ap[j, n]
            bp = (e1 + 1j * e2) / 2
            A = (ap[:, :s] + 1j * ap[:, s:]).T    # [S, S]
            B = (bp[:, :s] + 1j * bp[:, s:]).T

            # --- SlotToCoeff matrices: z = C w + D conj(w) ---------------
            n = ctx.n
            ej = (2 * enc._t_slot + 1).astype(np.float64)  # slot exponents
            U = np.exp(1j * np.pi * np.outer(ej, np.arange(n)) / n)  # [S, N]
            ul, ur = U[:, :s], U[:, s:]
            C = ul / 2 - 1j * ur / 2
            Dm = ul / 2 + 1j * ur / 2

            self._c2s = self._encode_pair(A, B)
            self._s2c = self._encode_pair(C, Dm)

        # --- EvalMod Chebyshev series ------------------------------------
        # C2S output slots are (integer coefficients)/Delta_d, so the exp
        # argument carries a Delta_d factor
        lim = (self.K + 1) * self.q0 / self.delta_d
        dd = self.delta_d
        self.exp_coeffs = chebyshev_fit(
            lambda t: np.exp(2j * np.pi * t * dd / (self.q0 * (1 << self.r))),
            -lim, lim, exp_degree)
        self.exp_range = (-lim, lim)

    # -- helpers -----------------------------------------------------------

    def galois_elements(self) -> set:
        """Union of every stage engine's rotation-key elements (the
        conjugation key is not included: ctx.conjugate reads it raw).
        Used with a warm-up refresh + CkksContext.drop_galois_keys."""
        es = set()
        engines = ([g.eng for g in self._c2s_f + self._s2c_f] if self.radix
                   else [self.eng])
        for e in engines:
            es |= e.galois_elements()
        return es

    def _encode_pair(self, m1, m2):
        """Encode two matrices at a shared power-of-two scale chosen so the
        largest diagonal coefficient sits near 2^28 (int32-representable)."""
        ctx = self.ctx
        mx = max(np.abs(m1).max(), np.abs(m2).max())
        k = max(0, int(math.ceil(-math.log2(mx)))) if mx < 1 else 0
        sp = ctx.scale * float(1 << k)
        enc1 = self.eng.encode(m1, scale=sp)
        enc2 = self.eng.encode(m2, scale=sp)
        return {"coeffs": np.stack([enc1.coeffs, enc2.coeffs]), "scale": sp,
                "staged": {}}

    def _pair_matvec(self, pair, ct: Ciphertext) -> Ciphertext:
        """M1 @ ct + M2 @ conj(ct): one batched BSGS call, normalized
        scale."""
        ctx = self.ctx
        l = ct.level
        if l not in pair["staged"]:
            pair["staged"][l] = _load_coeffs(ctx, pair["coeffs"], l)
        ct_conj = ctx.conjugate(ct)
        both = torch.stack([ct.c, ct_conj.c])
        out = bsgs_kernel(self.eng, l, "batched")(both, pair["staged"][l])
        scale = ct.scale * pair["scale"] / float(ctx.q_np[l - 1])
        summed = ctx.add(Ciphertext(out[0], scale), Ciphertext(out[1], scale))
        return ctx.scale_to(summed, ctx.scale)

    def _coeff_to_slot(self, ct: Ciphertext) -> Ciphertext:
        """slots <- coefficient pairs w_k = (v_k + i v_{k+S}) / delta_d
        (bit-reverse slot-ordered in factorized mode: EvalMod is pointwise
        and SlotToCoeff reverses it, so the order cancels)."""
        if self.radix:
            for g in self._c2s_f:
                ct = g(ct)
            return ct
        return self._pair_matvec(self._c2s, ct)

    def _slot_to_coeff(self, ct: Ciphertext) -> Ciphertext:
        if self.radix:
            for g in self._s2c_f:
                ct = g(ct)
            return self.ctx.scale_to(ct, self.ctx.scale)
        return self._pair_matvec(self._s2c, ct)

    def mod_raise(self, ct: Ciphertext) -> Ciphertext:
        """Level-1 ciphertext -> full-level ciphertext decrypting to
        v + q0*I (centered base extension of both components)."""
        ctx = self.ctx
        assert ct.level == 1
        ntt = ctx.ntt
        rows = tuple(range(ctx.L))
        coeffs = ntt.intt_from_mont(ct.c, (0,))              # [.., 2, 1, N]
        ext = ctx._extend_centered(coeffs, (0,), rows)[..., 0, :, :]
        return Ciphertext(ntt.ntt_to_mont(ext, rows), ct.scale)

    def _eval_exp(self, ct: Ciphertext) -> Ciphertext:
        """e^(2*pi*i*t/q0) on a real-slot ciphertext t (|t|<=(K+1)q0)."""
        ctx = self.ctx
        e = eval_chebyshev(ctx, ct, self.exp_coeffs, *self.exp_range,
                           width=self.width)
        for _ in range(self.r):
            e = ctx.multiply(e, e)
            for _ in range(self.width):
                e = ctx.rescale(e)
        return e

    # -- the full pipeline -------------------------------------------------

    def bootstrap(self, ct: Ciphertext) -> Ciphertext:
        """Refresh a (level <= 2, |slot| <= 1) ciphertext to high level."""
        ctx = self.ctx
        # 0. normalize to Delta_d and drop to one limb
        if ct.level == 1:
            assert abs(ct.scale - self.delta_d) < 1e-3 * self.delta_d, \
                "level-1 bootstrap input must already sit at delta_d"
        else:
            ct = ctx.scale_to(ct, self.delta_d)
            ct = ctx.mod_switch_to(ct, 1)
        # 1. ModRaise: v + q0*I at full level
        raised = self.mod_raise(ct)
        # 2. CoeffToSlot: slots <- coefficient pairs w_k = v_k + i v_{k+S}
        w = self._coeff_to_slot(raised)
        # 3. split real/imag coefficient streams
        wc = ctx.conjugate(w)
        two_re = ctx.add(w, wc)                      # 2*Re(w)
        two_im_i = ctx.sub(w, wc)                    # 2i*Im(w)
        # the exp argument must be exact, so halve now via scalar mult
        half_re = ctx.rescale(ctx.mul_scalar(two_re, 0.5))
        half_im = _mul_scalar_c(ctx, two_im_i, -0.5j, ctx.scale)
        half_im = ctx.rescale(half_im)
        # 4. EvalMod both streams
        er = self._eval_exp(half_re)
        ei = self._eval_exp(half_im)
        # 5. recombine: w~ = gamma*(Im(er) + i*Im(ei)), gamma =
        #    q0/(2*pi*Delta_d), split into a unit complex rotation (-i,
        #    encoded) and a real scalar: w~ = 0.5*gamma * ((-i)*dr + di)
        gamma = self.q0 / (2 * np.pi * self.delta_d)
        lvl = min(er.level, ei.level)
        er = ctx.mod_switch_to(er, lvl)
        ei = ctx.mod_switch_to(ei, lvl)
        dr = ctx.sub(er, ctx.conjugate(er))          # 2i*Im(er)
        di = ctx.sub(ei, ctx.conjugate(ei))          # 2i*Im(ei)
        t1 = ctx.rescale(_mul_scalar_c(ctx, dr, -1.0j, ctx.scale))
        t2 = ctx.rescale(ctx.mul_scalar(di, 1.0))
        s = ctx.add(t1, Ciphertext(t2.c, t1.scale))
        wt = ctx.rescale(ctx.mul_scalar(s, 0.5 * gamma))
        if self.width > 1:
            # step back down from the wide EvalMod scale before the
            # single-prime-matched SlotToCoeff stages, exactly (a retag
            # would compound through every later CT-CT square)
            wt = ctx.scale_to(wt, ctx.scale, exact=True)
        # 6. SlotToCoeff
        return self._slot_to_coeff(wt)
