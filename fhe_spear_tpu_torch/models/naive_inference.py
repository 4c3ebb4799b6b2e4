"""Naive (non-BSGS) fully-encrypted inference primitives: the per-column
ablation that motivates the BSGS engine (d_out * log2(d_in) rotations a
matvec against BSGS's ~2*sqrt(d): 22,528 against 89 at D=2048).

Counterpart of `fhe_spear_tpu/models/naive_inference.py`.  As there, the
per-column loop is batched: a batch of output columns' mul_plain runs as
one [cols, ...] tensor op, and the log2(d) rotate-and-sum tree rotates the
whole batch at each level.  Two bounds the reference does not have:

  * `naive_matvec` runs the columns in chunks of `col_chunk` (default: as
    many as `NAIVE_DIGIT_BYTES` of keyswitch digits allow), so that a
    [8192, 2, l, 16384] batch is never live at once; each column's words
    are those of the unchunked batch.
  * `_ws_batch` accumulates over the input axis in chunks of
    `WS_PRODUCT_BYTES` of products instead of materialising the full
    [dout, din, 2, l, N] product; modular addition is exact, so the words
    equal the reference's.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ckks.ciphertext import Ciphertext
from ..ckks.context import CkksContext
from ..core.modops import add_mod, mont_mul

__all__ = ["ct_pt_dot", "ct_pt_weighted_sum", "naive_matvec",
           "naive_ffn_block", "naive_ablation", "rotation_count_naive",
           "default_col_chunk", "naive_multilayer", "naive_autoregressive"]

# keyswitch digits [cols, d_l, T, N] int64 of one column batch's rotation
# (the rotation's transients are a few times this)
NAIVE_DIGIT_BYTES = 2 << 30
# [dout, din_chunk, 2, l, N] int64 products of one _ws_batch step
WS_PRODUCT_BYTES = 1 << 30


def rotation_count_naive(d_in: int, d_out: int) -> int:
    """Rotations for the naive path: d_out * log2(d_in) (ablation metric)."""
    return d_out * int(np.ceil(np.log2(d_in)))


def _tree_steps(d: int) -> list:
    return [1 << k for k in range(int(np.ceil(np.log2(d))))]


def ct_pt_dot(ctx: CkksContext, ct: Ciphertext, w: np.ndarray, d: int
              ) -> Ciphertext:
    """<ct, w> via mul_plain + ceil(log2 d) rotate-and-sum; the dot product
    lands in slot 0 (read with decrypt_slot0).  Consumes one level."""
    steps = _tree_steps(d)
    ctx.ensure_galois(steps)
    wv = np.zeros(ctx.slots)
    wv[:d] = w
    pt = ctx.encode(wv, level=ct.level)
    acc = ctx.mul_plain(ct, pt)
    for s in steps:
        acc = ctx.add(acc, ctx.rotate(acc, s))
    return ctx.rescale(acc)


def ct_pt_weighted_sum(ctx: CkksContext, cts: list[Ciphertext],
                       weights: np.ndarray, level: int | None = None
                       ) -> Ciphertext:
    """sum_j w_j * ct_j with explicit level alignment.  Scalar multiplies
    are direct RNS constants (ctx.mul_scalar) -- no encoding."""
    level = min(c.level for c in cts) if level is None else level
    acc = None
    for ct, w in zip(cts, weights):
        t = ctx.rescale(ctx.mul_scalar(ctx.mod_switch_to(ct, level), float(w)))
        acc = t if acc is None else ctx.add(acc, t)
    return acc


def default_col_chunk(ctx: CkksContext, level: int) -> int:
    """Columns per batch of `naive_matvec` at `level`: the largest power of
    two whose rotation digits fit NAIVE_DIGIT_BYTES (1024 at N=16384, l=3,
    K=1)."""
    per_col = ctx.num_digits(level) * len(ctx.targets(level)) * ctx.n * 8
    cols = max(1, NAIVE_DIGIT_BYTES // per_col)
    return 1 << (cols.bit_length() - 1)


def naive_matvec(ctx: CkksContext, ct: Ciphertext, w: np.ndarray,
                 d_in: int, d_out: int | None = None,
                 col_chunk: int | None = None) -> np.ndarray:
    """Per-column dots, decrypting slot 0 of each: w[:d_in, :d_out]^T x for
    a ciphertext ct holding x in slots [0, d_in).  Batched over columns
    (one [cols, ...] mul_plain + a shared rotation tree), `col_chunk`
    columns at a time (default `default_col_chunk`)."""
    d_out = w.shape[1] if d_out is None else d_out
    col_chunk = default_col_chunk(ctx, ct.level) if col_chunk is None \
        else col_chunk
    steps = _tree_steps(d_in)
    ctx.ensure_galois(steps)
    out = []
    for c0 in range(0, d_out, col_chunk):
        c1 = min(d_out, c0 + col_chunk)
        cols = np.zeros((c1 - c0, ctx.slots))
        cols[:, :d_in] = w[:d_in, c0:c1].T
        acc = ctx.mul_plain(ct, ctx.encode(cols, level=ct.level))
        for s in steps:                                  # [cols, 2, l, N]
            acc = ctx.add(acc, ctx.rotate(acc, s))
        out.append(ctx.decrypt_vec(ctx.rescale(acc))[..., 0])
        del acc
    return np.concatenate(out)


def naive_ffn_block(ctx: CkksContext, x: np.ndarray, w_key: np.ndarray,
                    w_val: np.ndarray, col_chunk: int | None = None,
                    phases=None) -> np.ndarray:
    """One naive fully-encrypted FFN block x + (x@Wk)^2 @ Wv with
    per-column dots and a client square in between.  Where F exceeds the
    slot count, the hidden vector is truncated to the slots, as the
    reference does.  `phases` (a `utils.profiling.Phases`) receives the
    spans "key projection" and "value projection" (each ends in a
    decryption, so its work is done when the span closes)."""
    span = phases.span if phases is not None \
        else (lambda name: contextlib.nullcontext())
    d, f = w_key.shape
    with span("key projection"):
        ct = ctx.encrypt_replicated(x)
        fk = naive_matvec(ctx, ct, w_key, d, f, col_chunk=col_chunk)
    fk2 = fk ** 2
    with span("value projection"):
        ct2 = ctx.encrypt_replicated(fk2 if f <= ctx.slots
                                     else fk2[: ctx.slots])
        fv = naive_matvec(ctx, ct2, w_val, f, d, col_chunk=col_chunk)
    return x + fv


def naive_ablation(d: int = 2048, f: int = 8192, n: int = 16384,
                   num_limbs: int = 3, num_special: int = 1, seed: int = 0,
                   col_chunk: int | None = None, device="cuda") -> dict:
    """The ablation's FFN block on `device`: seeded weights at
    bench_fully_enc's scale (W_key ~ N(0, 1/d), W_val ~ N(0, 1/f) from
    default_rng(42), x ~ U(-1, 1) from default_rng(4242)) through
    `naive_ffn_block` on CkksParams(n, num_limbs, num_special), held
    against the plaintext x + (x@Wk)^2 @ Wv.  Returns the seconds of each
    projection, its columns and rotations, and the error."""
    from ..ckks.context import CkksParams
    from ..utils.profiling import Phases

    if f > n // 2:
        raise ValueError(f"f={f} exceeds the {n // 2} slots of N={n}")
    rng = np.random.default_rng(42)
    w_key = rng.standard_normal((d, f)) / np.sqrt(d)
    w_val = rng.standard_normal((f, d)) / np.sqrt(f)
    x = np.random.default_rng(4242).uniform(-1, 1, d)
    ctx = CkksContext(CkksParams(n=n, num_limbs=num_limbs,
                                 num_special=num_special), seed=seed,
                      device=device)
    chunk = default_col_chunk(ctx, num_limbs) if col_chunk is None \
        else col_chunk
    phases = Phases()
    got = naive_ffn_block(ctx, x, w_key, w_val, col_chunk=chunk,
                          phases=phases)
    want = x + (x @ w_key) ** 2 @ w_val
    rep = phases.report()
    return {
        "d": d, "f": f, "n": n, "col_chunk": chunk, "out": got,
        "want": want, "corr": float(np.corrcoef(got, want)[0, 1]),
        "max_err": float(np.abs(got - want).max()),
        "key_s": rep["key projection"]["total_s"],
        "value_s": rep["value projection"]["total_s"],
        "key_rotations": rotation_count_naive(d, f),
        "value_rotations": rotation_count_naive(f, d)}


# ---------------------------------------------------------------------------
# ablation chains: multilayer, residual, autoregressive -- per-dimension
# scalar-ciphertext arithmetic, batched
# ---------------------------------------------------------------------------

def _scalar_consts(ctx, w: np.ndarray, level: int) -> torch.Tensor:
    """Direct-RNS constant residues for a weight matrix: [dout, din, l, 1]
    int64 Montgomery encodings of round(w * scale) (vectorized
    mul_scalar)."""
    v = np.round(np.asarray(w, dtype=np.float64).T * ctx.scale).astype(
        np.int64)                                   # [dout, din]
    q = ctx.q_np[:level].astype(np.int64)
    r = np.array([ctx.primes[i].mont_r for i in range(level)],
                 dtype=np.int64)
    res = (v[..., None] % q) * r % q                # [dout, din, l]
    return ctx._tensor(res[..., None])


def _ws_batch(ctx, cts: torch.Tensor, w: np.ndarray) -> torch.Tensor:
    """Batched weighted sums: cts [din, 2, l, N] -> [dout, 2, l-1, N],
    out_i = rescale(sum_j w[j, i] * ct_j).  One level.  The sum runs over
    chunks of the input axis (WS_PRODUCT_BYTES of products each): each
    chunk's canonical products are summed exactly in int64 and reduced
    once, and the chunks are added modulo p."""
    din, l = cts.shape[0], cts.shape[-2]
    consts = _scalar_consts(ctx, w, l)              # [dout, din, l, 1]
    p, pinv = ctx._p(l)
    per_j = consts.shape[0] * cts[0].numel() * 8
    chunk = max(1, min(din, WS_PRODUCT_BYTES // per_j))
    acc = None
    for j0 in range(0, din, chunk):
        j1 = min(din, j0 + chunk)
        prod = mont_mul(cts[None, j0:j1], consts[:, j0:j1, None], p, pinv)
        part = prod.sum(dim=1) % p                  # [dout, 2, l, N]
        acc = part if acc is None else add_mod(acc, part, p)
        del prod
    return ctx._rescale_core(acc, l)


def naive_multilayer(ctx: CkksContext, x: np.ndarray, blocks, w_head,
                     residual: bool = False):
    """Chained naive FFN inference, depth 3*len(blocks)+1, fully encrypted
    end to end.

    blocks: [(W_key [d, f], W_val [f, d]), ...].  Returns
    (token, logits, final_level).  The residual variant aligns x down
    with mod-switch + set_scale before each add."""
    h_ct = ctx.encrypt(np.tile(np.asarray(x)[:, None],
                               (1, ctx.slots)))        # [d, 2, L, N]
    h_scale = h_ct.scale
    for wk, wv in blocks:
        fk = _ws_batch(ctx, h_ct.c, wk)                # [f, 2, l-1, N]
        s1 = h_scale * ctx.scale / float(ctx.q_np[h_ct.level - 1])
        sq = ctx.multiply(Ciphertext(fk, s1), Ciphertext(fk, s1))
        sq = ctx.rescale(sq)                           # [f, 2, l-2, N]
        v = _ws_batch(ctx, sq.c, wv)                   # [d, 2, l-3, N]
        s2 = sq.scale * ctx.scale / float(ctx.q_np[sq.level - 1])
        out = Ciphertext(v, s2)
        if residual:
            x_al = ctx.mod_switch_to(h_ct, out.level)
            out = ctx.add(ctx.set_scale(out, x_al.scale), x_al)
        h_ct = out
        h_scale = h_ct.scale
    logits_ct = Ciphertext(_ws_batch(ctx, h_ct.c, np.asarray(w_head)),
                           h_scale)
    logits = ctx.decrypt_vec(logits_ct)[..., 0]        # slot 0 per row
    return int(np.argmax(logits)), logits, logits_ct.level


def naive_autoregressive(ctx: CkksContext, emb: np.ndarray, blocks, w_head,
                         start_token: int, num_tokens: int,
                         residual: bool = False):
    """Autoregressive naive generation: each step encrypts the current
    token's embedding, runs the encrypted chain + encrypted head, decrypts
    logits for argmax (client), feeds the next token back.  Returns
    (tokens_fhe, tokens_plain)."""
    tok_f = tok_p = start_token
    toks_f, toks_p = [tok_f], [tok_p]
    for _ in range(num_tokens):
        # plaintext twin
        h = emb[tok_p].copy()
        for wk, wv in blocks:
            pre = (h @ wk) ** 2 @ wv
            h = pre + h if residual else pre
        tok_p = int(np.argmax(h @ np.asarray(w_head)))
        toks_p.append(tok_p)
        tok_f, _, _ = naive_multilayer(ctx, emb[tok_f], blocks, w_head,
                                       residual=residual)
        toks_f.append(tok_f)
    return toks_f, toks_p
