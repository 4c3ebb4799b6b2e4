"""Polynomial evaluation under CKKS: Paterson-Stockmeyer over the
Chebyshev basis.

Counterpart of `fhe_spear_tpu/ops/polyeval.py`: the deg-13 sigmoid and the
workhorse of the bootstrap's EvalMod stage (ckks/bootstrap.py).

Method: evaluate p(t) = sum_k c_k T_k(u), u = affine(t) in [-1, 1]:
  * the Chebyshev basis keeps every intermediate in [-1, 1];
  * baby steps T_1..T_{m-1} and giant steps T_m, T_2m, T_4m, ... via the
    double angle T_2k = 2 T_k^2 - 1 (the x2 is a ciphertext add);
  * recursion by Chebyshev long division: p = T_g * q + r with
    T_g T_j = (T_{g+j} + T_{|g-j|})/2, one ct-ct multiply per recursion
    level; total depth ~ ceil(log2 deg) + 1;
  * real coefficients multiply as RNS constants (ctx.mul_scalar), complex
    ones through one-constant plaintexts; every add happens at an exactly
    matched (level, scale).

The scale bookkeeping is float arithmetic in the reference's order (a
scale tag rounded differently becomes a different `mul_scalar` constant,
and the words then differ).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ckks.ciphertext import Ciphertext
from ..ckks.context import CkksContext

__all__ = ["chebyshev_fit", "cheb_divmod", "eval_chebyshev", "eval_sigmoid"]


def chebyshev_fit(fn, a: float, b: float, degree: int) -> np.ndarray:
    """Chebyshev interpolation coefficients of fn on [a, b] (complex ok)."""
    k = np.arange(degree + 1)
    nodes = np.cos(np.pi * (k + 0.5) / (degree + 1))
    vals = fn((nodes + 1) * (b - a) / 2 + a)
    Tkj = np.cos(np.outer(k, np.pi * (np.arange(degree + 1) + 0.5)
                          / (degree + 1)))
    c = 2.0 / (degree + 1) * (Tkj @ vals)
    c[0] /= 2
    return np.asarray(c, dtype=np.complex128)


def cheb_divmod(c: np.ndarray, g: int):
    """Divide sum c_k T_k by T_g: returns (q, r) Chebyshev coefficients
    with p = T_g * q + r, deg r < g.  Uses T_g T_j = (T_{g+j}+T_{|g-j|})/2."""
    c = np.array(c, dtype=np.complex128)
    n = len(c) - 1
    assert n >= g
    q = np.zeros(n - g + 1, dtype=np.complex128)
    for k in range(n, g, -1):
        q[k - g] = 2.0 * c[k]
        c[abs(k - 2 * g)] -= c[k]
        c[k] = 0.0
    q[0] = c[g]
    c[g] = 0.0
    return q, c[:g]


class _ChebEvaluator:
    """Holds baby/giant Chebyshev ciphertexts and runs the PS recursion.

    width w > 1 evaluates at a composite scale Delta_w ~ (2^28)^w: every
    multiply is followed by w rescales, so relative rounding noise per
    level is ~2^(-28w) instead of 2^-28 (what keeps the bootstrap's EvalMod
    noise below its gamma*sqrt(S) amplification at production rings)."""

    def __init__(self, ctx: CkksContext, u: Ciphertext, m: int, deg: int,
                 width: int = 1):
        self.ctx = ctx
        self.m = m
        self.w = width
        self.T = {1: u}
        for k in range(2, m):
            half, other = k // 2, k - k // 2
            if half == other:
                self.T[k] = self._double(self.T[half])
            else:
                self.T[k] = self._product(self.T[half], self.T[other],
                                          other - half)
        self.giants = {}
        g = m
        cur = self._double(self.T[m // 2]) if m > 1 else u
        self.giants[g] = cur
        # largest giant needed: smallest m*2^j >= (deg+1)/2 (see eval())
        while g < (deg + 1) / 2:
            g *= 2
            cur = self._double(cur)
            self.giants[g] = cur

    def top_level(self, coeffs: np.ndarray, off: int = 0) -> float:
        """Highest start level of `eval(coeffs, ...)` at which every
        `_linear` call finds each T_k it uses (nonzero coefficient) at or
        above its level + width."""
        deg = len(coeffs) - 1
        if deg < self.m:
            return min((self.T[k].level - off - self.w
                        for k in range(1, len(coeffs))
                        if abs(coeffs[k]) >= 1e-14), default=np.inf)
        g = self.m
        while g < (deg + 1) / 2:
            g *= 2
        q, r = cheb_divmod(coeffs, g)
        return min(self.top_level(q, off + self.w), self.top_level(r, off))

    def _rs(self, x):
        for _ in range(self.w):
            x = self.ctx.rescale(x)
        return x

    def _qprod(self, level):
        p = 1.0
        for j in range(level, level + self.w):
            p *= float(self.ctx.q_np[j])
        return p

    # T_2k = 2 T_k^2 - 1; the 2x is an add, so one level per doubling
    def _double(self, tk):
        ctx = self.ctx
        sq = self._rs(ctx.multiply(tk, tk))
        two = ctx.add(sq, sq)
        return _add_const(ctx, two, -1.0)

    # T_{a+b} = 2 T_a T_b - T_{|a-b|}
    def _product(self, ta, tb, d):
        ctx = self.ctx
        lvl = min(ta.level, tb.level)
        prod = self._rs(ctx.multiply(ctx.mod_switch_to(ta, lvl),
                                     ctx.mod_switch_to(tb, lvl)))
        prod = ctx.add(prod, prod)
        td = (_one_like(ctx, prod) if d == 0
              else _match(ctx, self.T[d], prod.level, prod.scale, self.w))
        return ctx.sub(prod, td)

    # -- recursion ----------------------------------------------------

    def eval(self, coeffs: np.ndarray, level: int, scale: float) -> Ciphertext:
        deg = len(coeffs) - 1
        if deg < self.m:
            return self._linear(coeffs, level, scale)
        g = self.m
        while g < (deg + 1) / 2:
            g *= 2
        q, r = cheb_divmod(coeffs, g)
        ctx = self.ctx
        gm = _match(ctx, self.giants[g], level + self.w, None, self.w)
        qq = self.eval(q, level + self.w,
                       scale * self._qprod(level) / gm.scale)
        prod = self._rs(ctx.multiply(qq, gm))
        rr = self.eval(r, level, prod.scale)
        return ctx.add(rr, prod)

    def _linear(self, cs, level, scale):
        """sum_k cs[k] T_k, k < m, delivered at (level, scale)."""
        ctx = self.ctx
        acc = None
        for k in range(1, len(cs)):
            if abs(cs[k]) < 1e-14:
                continue
            tk = _match(ctx, self.T[k], level + self.w, None, self.w)
            term = _mul_scalar_c(ctx, tk, cs[k],
                                 scale * self._qprod(level) / tk.scale)
            term = self._rs(term)
            acc = term if acc is None else ctx.add(acc, term)
        if acc is None:
            acc = Ciphertext(_zero_c(ctx, self.T[1], level), scale)
        else:
            acc = Ciphertext(acc.c, scale)  # kill float round-off drift
        if abs(cs[0]) > 1e-14:
            acc = _add_const(ctx, acc, cs[0])
        return acc


def _zero_c(ctx, like, level):
    return torch.zeros(like.c.shape[:-2] + (level, ctx.n), dtype=torch.int64,
                       device=ctx.device)


def _one_like(ctx, x):
    """Ciphertext-free representation of the constant 1 at x's (level,
    scale): an encoding added to a zero ciphertext."""
    z = Ciphertext(_zero_c(ctx, x, x.level), x.scale)
    return _add_const(ctx, z, 1.0)


def _match(ctx: CkksContext, x: Ciphertext, level: int,
           scale: float | None, width: int = 1) -> Ciphertext:
    """Bring x down to `level` (and, if given, exactly to `scale`)."""
    if x.level > level + width:
        x = ctx.mod_switch_to(x, level + width)
    if x.level == level + width:
        prod = 1.0
        for j in range(level, level + width):
            prod *= float(ctx.q_np[j])
        target = ((scale if scale is not None else ctx.scale ** width)
                  * prod / x.scale)
        x = ctx.mul_scalar(x, 1.0, scale=target)
        for _ in range(width):
            x = ctx.rescale(x)
        return x
    assert x.level == level, (x.level, level)
    if scale is not None and abs(x.scale - scale) > 1e-6 * scale:
        raise ValueError(f"scale mismatch: {x.scale} vs {scale}")
    return x


def _mul_scalar_c(ctx, x, c, scale):
    c = complex(c)
    if abs(c.imag) < 1e-14:
        return ctx.mul_scalar(x, c.real, scale=scale)
    pt = ctx.encode_const(c, level=x.level, scale=scale)
    return ctx.mul_plain(x, pt)


def _add_const(ctx, x, c):
    pt = ctx.encode_const(complex(c), level=x.level, scale=x.scale)
    return ctx.add_plain(x, pt)


def eval_chebyshev(ctx: CkksContext, ct: Ciphertext, coeffs: np.ndarray,
                   a: float, b: float, m: int | None = None,
                   width: int = 1) -> Ciphertext:
    """Evaluate a Chebyshev series on ct's slots (values in [a, b]).

    width > 1: evaluate at composite scale Delta^width (the affine step
    raises ct to the wide scale; see _ChebEvaluator)."""
    coeffs = np.asarray(coeffs, dtype=np.complex128)
    deg = len(coeffs) - 1
    if m is None:
        m = 1
        while m * m < deg + 1:
            m *= 2
    # affine to [-1,1], raising to the working scale Delta^width
    alpha, beta = 2.0 / (b - a), -(b + a) / (b - a)
    l = ct.level
    prod = 1.0
    for j in range(l - width, l):
        prod *= float(ctx.q_np[j])
    wide = ctx.scale ** width
    u = ctx.mul_scalar(ct, alpha, scale=wide * prod / ct.scale)
    for _ in range(width):
        u = ctx.rescale(u)
    u = Ciphertext(u.c, wide)  # exact by construction of the adjusting scale
    if abs(beta) > 1e-12:
        u = _add_const(ctx, u, beta)

    ev = _ChebEvaluator(ctx, u, m, deg, width)
    lvl = (min(c.level for c in ev.giants.values()) - width if ev.giants
           else u.level - width)
    # the reference starts at lvl alone; where the top giant is T_m itself
    # (m = 4, degree 4-7) its last baby T_{m-1} sits at the giant's level,
    # one level short of the quotient's `_linear` call, and the reference
    # fails an assertion.  Start low enough for every baby the series uses
    # (the same lvl wherever the reference runs).
    lvl = int(min(lvl, ev.top_level(coeffs)))
    return ev.eval(coeffs, lvl, wide)


def eval_sigmoid(ctx: CkksContext, ct: Ciphertext, a: float = -8.0,
                 b: float = 8.0, degree: int = 13) -> Ciphertext:
    """Degree-13 sigmoid under CKKS."""
    coeffs = chebyshev_fit(lambda t: 1.0 / (1.0 + np.exp(-t)), a, b, degree)
    return eval_chebyshev(ctx, ct, coeffs, a, b)
