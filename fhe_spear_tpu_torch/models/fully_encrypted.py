"""Fully-encrypted FFN inference: no intermediate decryption.

Counterpart of `fhe_spear_tpu/models/fully_encrypted.py`.  Per block
(plaintext oracle: x + (x @ W_key)^2 @ W_val, exactly 3 levels):
  1. key projection D->F: ceil(F/D) real BSGS chunk matvecs sharing one
     input, so the baby rotations are computed once           [1 level]
  2. CT-CT square of every chunk (one batched multiply + relin + rescale)
                                                               [1 level]
  3. value projection F->D: one BSGS matvec per chunk, partials summed
     level-aligned                                             [1 level]
  4. residual: mod-switch x down 3 limbs + set_scale + add     [0 levels]

The chunk axis (the reference's `vmap` / `lax.map`) runs one chunk at a
time in the port: the "shared" and "batched" forms of
`ops.bsgs.bsgs_kernel` hold one chunk's transient, which is what the
reference's `seq_chunks` buys.  The port accepts `seq_chunks` for
signature parity and ignores it.

Magnitude control: per-block constants folded into W_key and W_val from
one calibration input keep every intermediate near unit magnitude through
arbitrarily many blocks.  Exact scale management (`diag_scales`) encodes
each block's diagonals at the scales of the level it is consumed at, so a
block's output scale equals its input scale.

`run_fully_encrypted` refreshes the ciphertext through a caller-provided
`bootstrap_fn` when fewer than `min_levels`+1 limbs remain.  Unlike the
reference, its pre-encoded path runs when the levels match (the
reference's local `import os` shadows the module's), and a failed
prefetch is logged before the block is staged in the loop.

Every transform of the chain (digit extensions, mod-downs, rescales, the
in-kernel RNS expansion of the staged diagonals, decryption) runs kernels
K1/K2 on the card.
"""

from __future__ import annotations

import logging
import os
import threading
import time

import numpy as np
import torch

from ..ckks.ciphertext import Ciphertext
from ..ckks.context import CkksContext
from ..ops.bsgs import BsgsMatvec, _load_coeffs, bsgs_kernel

__all__ = ["FullyEncryptedFfn", "FullyEncryptedTimeMix", "calibrate_magnitude",
           "fe_level_schedule", "full_vocab_head",
           "generate_fully_encrypted_token", "plaintext_ffn_block",
           "pre_encode_blocks", "run_fully_encrypted"]

_log = logging.getLogger(__name__)


def plaintext_ffn_block(x, w_key, w_val):
    return x + (x @ w_key) ** 2 @ w_val


def calibrate_magnitude(w_keys, w_vals, x_cal, target_mag=1.0):
    """Two-stage magnitude control from one calibration pass: the key
    matrix is scaled by a = target/|fk|_inf and the value matrix by
    b = (target/|fv|_inf)/a^2, which computes the calibrated chain
    (a^2*b * fk^2 @ W_val) while keeping every encoded matrix -- and the
    squared intermediate -- near unit magnitude.  Returns
    (w_keys_scaled, w_vals_scaled)."""
    ks, vs = [], []
    x = np.asarray(x_cal, dtype=np.float64).copy()
    for wk, wv in zip(w_keys, w_vals):
        fk = x @ wk
        a = target_mag / (np.max(np.abs(fk)) + 1e-12)
        fv = fk ** 2 @ wv
        ms = target_mag / (np.max(np.abs(fv)) + 1e-12)
        b = ms / (a * a)
        ks.append(wk * a)
        vs.append(wv * b)
        x = x + fv * ms
    return ks, vs


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


class FullyEncryptedFfn:
    """Fully-encrypted FFN block evaluator for fixed (ctx, D, F)."""

    def __init__(self, ctx: CkksContext, d: int, f: int,
                 seq_chunks: bool = False, stage_mode: str = "i32",
                 key_sharding=None, width: int = 1):
        """seq_chunks: ignored (the reference's lax.map-over-chunks switch;
        the port always runs one chunk at a time, see the module
        docstring).

        stage_mode: "i32", the one staging: int32 coefficients [B, G, N]
        (width 2: planes [B, G, 2, N]), RNS-expanded one giant chunk at a
        time inside the kernel.  Any other value raises ValueError.

        key_sharding: the rank group over which the context's evaluation
        keys are limb-sharded (`CkksContext.shard_eval_keys`, before the
        first block): the key stacks then divide over the group, and the
        chain's words equal the unsharded chain's.

        width: working-scale width in limbs.  width=2 runs the chain at a
        composite scale Delta_2 ~ 2^56 (two rescales per stage, 6
        limbs/block): every absolute noise source drops by ~2^28 relative.
        Diagonals use the two-plane int64-split staging (encode_wide), the
        input is encrypted at ctx.scale**2, and decryption uses the
        3-limb CRT path.  Requires exact (level-scheduled) pre-encodes."""
        if width not in (1, 2):
            raise ValueError(f"width must be 1 or 2, got {width}")
        if stage_mode != "i32":
            raise ValueError(f"the diagonals stage as int32 coefficients "
                             f"(stage_mode 'i32'), not {stage_mode!r}")
        self.width = width
        self.ctx = ctx
        self.d, self.f = d, f
        self.eng = BsgsMatvec(ctx, d, key_sharding=key_sharding)
        self.n_chunks = -(-f // d)

    def diag_scales(self, level: int) -> tuple[float, float]:
        """Exact scale management: key diagonals at s_key = q[l-1], value
        diagonals at s_val = q[l-2]*q[l-3]/Delta make the block's output
        scale equal its input scale exactly (s_fk = s_x, s_sq =
        s_x^2/q[l-2], s_fv = s_x^2/Delta = s_x for s_x = Delta).

        width=2: the invariant is s_x = Delta_2 = ctx.scale^2; s_key =
        q[l-1]*q[l-2], s_val = q[l-3]*q[l-4]*q[l-5]*q[l-6]/Delta_2."""
        q = self.ctx.q_np
        if self.width == 2:
            assert level >= 7, f"width-2 consume level must be >= 7, got {level}"
            s_key = float(q[level - 1]) * float(q[level - 2])
            s_val = (float(q[level - 3]) * float(q[level - 4])
                     * float(q[level - 5]) * float(q[level - 6])
                     / self.ctx.scale ** 2)
            return s_key, s_val
        assert level >= 4, f"consume level must be >= 4, got {level}"
        s_key = float(q[level - 1])
        s_val = float(q[level - 2]) * float(q[level - 3]) / self.ctx.scale
        return s_key, s_val

    def encode_block(self, w_key: np.ndarray, w_val: np.ndarray,
                     level: int | None = None) -> dict:
        """Host pre-encode: chunked key/value diagonal stacks (int32).

        With `level` (the level this block will be CONSUMED at), diagonals
        are encoded at the exact-alignment scales of `diag_scales`;
        without, at Delta.  width=2 requires `level` and produces two-plane
        int64-split stacks [k, B, G, 2, N]."""
        d = self.d
        if self.width == 2:
            assert level is not None, "width-2 encodes require a level"
            enc = self.eng.encode_wide
        else:
            enc = self.eng.encode
        s_key = s_val = None
        if level is not None:
            s_key, s_val = self.diag_scales(level)
        key_mats, val_mats = [], []
        for c in range(self.n_chunks):
            mk = np.zeros((d, d))
            cols = w_key[:, c * d: (c + 1) * d].T
            mk[: cols.shape[0]] = cols
            key_mats.append(enc(mk, s_key).coeffs)
            mv = np.zeros((d, d))
            rows = w_val[c * d: (c + 1) * d, :].T
            mv[:, : rows.shape[1]] = rows
            val_mats.append(enc(mv, s_val).coeffs)
        out = {"key": np.stack(key_mats), "val": np.stack(val_mats)}
        if level is not None:
            out["level"] = level
        return out

    def load_block(self, host: dict, level: int) -> dict:
        """Stage one block's diagonals, consumed key at `level` and val at
        `level - 2`: the int32 coefficients are copied to the device
        unchanged; kernels expand them one giant chunk at a time."""
        out = {k: torch.as_tensor(np.asarray(host[k]), device=self.ctx.device)
               for k in ("key", "val")}
        if "level" in host:
            out["level"] = int(host["level"])
        return out

    def __call__(self, ct_x: Ciphertext, staged: dict) -> Ciphertext:
        """One fully-encrypted block; level l -> l-3 (width 2: l -> l-6)."""
        if self.width == 2:
            return self._call_wide(ct_x, staged)
        ctx, l = self.ctx, ct_x.level
        assert l >= 4, f"need >= 4 limbs, have {l} (bootstrap first)"
        q = ctx.q_np
        exact = "level" in staged
        if exact:
            assert staged["level"] == l, (
                f"block diagonals encoded for level {staged['level']} but "
                f"consumed at level {l} -- re-encode (exact scale management)")
            s_key, s_val = self.diag_scales(l)
        else:
            s_key = s_val = ctx.scale
        # 1. key projection (shared input, one chunk at a time)
        fk = self._kernel(l, "shared")(ct_x.c, staged["key"])  # [k, 2, l-1, N]
        s_fk = ct_x.scale * s_key / float(q[l - 1])
        # 2. square (batched multiply + relin + rescale)
        sq = Ciphertext(fk, s_fk)
        sq = ctx.rescale(ctx.multiply(sq, sq))               # [k, 2, l-2, N]
        # 3. value projection (one chunk at a time) + chunk sum
        fv = self._kernel(l - 2, "batched")(sq.c, staged["val"])  # [k, 2, l-3, N]
        s_fv = sq.scale * s_val / float(q[l - 3])
        v = self._sum_chunks(fv, l - 3)
        # 4. residual: align level + scale, add.  In exact mode the true
        # scales are equal by construction; set_scale unifies the float
        # bookkeeping.  Without levels it relabels a genuinely different
        # scale (~3e-2 signal-proportional error per block).
        x_al = ctx.mod_drop(ct_x, 3)
        tgt = s_fv if exact else x_al.scale
        v_ct = ctx.set_scale(Ciphertext(v, s_fv), tgt)
        x_sc = x_al if x_al.scale == tgt else ctx.set_scale(x_al, tgt)
        return ctx.add(x_sc, v_ct)

    def _call_wide(self, ct_x: Ciphertext, staged: dict) -> Ciphertext:
        """width-2 block at the composite scale Delta_2; level l -> l-6.
        Each stage rescales twice (once inside the matvec kernel, once
        after), so every absolute noise source is ~2^-56 relative."""
        ctx, l = self.ctx, ct_x.level
        assert l >= 7, f"width-2 needs >= 7 limbs, have {l} (bootstrap first)"
        q = ctx.q_np
        assert "level" in staged and staged["level"] == l, (
            f"width-2 diagonals encoded for level {staged.get('level')} "
            f"but consumed at level {l} -- re-encode")
        s_key, s_val = self.diag_scales(l)
        # 1. key projection + second rescale: l -> l-2, s_fk = s_x
        fk = self._kernel(l, "shared")(ct_x.c, staged["key"])  # [k, 2, l-1, N]
        fk_ct = ctx.rescale(
            Ciphertext(fk, ct_x.scale * s_key / float(q[l - 1])))
        # 2. square + two rescales: l-2 -> l-4
        sq = ctx.rescale(ctx.rescale(ctx.multiply(fk_ct, fk_ct)))
        # 3. value projection, chunk-sum at l-5, second rescale: -> l-6
        fv = self._kernel(l - 4, "batched")(sq.c, staged["val"])  # [k, 2, l-5, N]
        v = self._sum_chunks(fv, l - 5)
        v_ct = ctx.rescale(
            Ciphertext(v, sq.scale * s_val / float(q[l - 5])))
        # 4. residual: scales equal by construction; set_scale unifies the
        # float tags only
        x_al = ctx.mod_drop(ct_x, 6)
        x_sc = (x_al if x_al.scale == v_ct.scale
                else ctx.set_scale(x_al, v_ct.scale))
        return ctx.add(x_sc, v_ct)

    def _kernel(self, l: int, mode: str):
        """kern(c, pt [k, ...]) -> [k, 2, l-1, N], c [2, l, N] ("shared")
        or [k, 2, l, N] ("batched").  Built per call: the level's selected
        keys live only while the projection runs."""
        return bsgs_kernel(self.eng, l, mode)

    def _sum_chunks(self, x: torch.Tensor, l: int) -> torch.Tensor:
        """Sum over the chunk axis of [k, 2, l, N] residues, exact in int64
        and reduced once (the words of the reference's tree of add_mods)."""
        return x.sum(dim=0) % self.ctx._p(l)[0]


def fe_level_schedule(start_level: int, n_blocks: int,
                      min_levels: int | None = None,
                      boot_level: int | None = None,
                      width: int = 1) -> list[int | None]:
    """Per-block CONSUME levels for a chain starting at `start_level`
    (3*width limbs/block; refresh to `boot_level` when fewer than
    `min_levels`+1 remain).  Without boot_level, blocks past exhaustion
    get None (never reached).  min_levels defaults to 4 (width 1) / 8
    (width 2: the output level stays >= 3 for the 3-limb decrypt)."""
    if min_levels is None:
        min_levels = 4 if width == 1 else 8
    lv, out = start_level, []
    for _ in range(n_blocks):
        if lv - 1 < min_levels:
            if boot_level is None:
                out.append(None)
                continue
            lv = boot_level
        out.append(lv)
        lv -= 3 * width
    return out


def _block_dir(cache_dir: str, b: int, level) -> str:
    return os.path.join(cache_dir, f"block{b:03d}"
                        + (f"_l{level}" if level is not None else ""))


def _load_cached(bdir: str, level) -> dict | None:
    kf, vf = os.path.join(bdir, "key.npy"), os.path.join(bdir, "val.npy")
    if not (os.path.exists(kf) and os.path.exists(vf)):
        return None
    host = {"key": np.load(kf, mmap_mode="r"), "val": np.load(vf, mmap_mode="r")}
    if level is not None:
        host["level"] = level
    return host


def _save_cached(bdir: str, host: dict) -> None:
    os.makedirs(bdir, exist_ok=True)
    np.save(os.path.join(bdir, "key.npy"), host["key"])
    np.save(os.path.join(bdir, "val.npy"), host["val"])


def pre_encode_blocks(eng: FullyEncryptedFfn, w_keys, w_vals,
                      cache_dir: str | None = None, log_fn=None,
                      levels: list | None = None):
    """Host pre-encode of every block's diagonal plaintexts.  With
    cache_dir set, each block is persisted as raw mmap-able .npy files.

    levels: per-block consume levels (fe_level_schedule) -- encodes at the
    exact-alignment scales of FullyEncryptedFfn.diag_scales; entries of
    None fall back to level-agnostic Delta encodes."""
    hosts = []
    for b, (wk, wv) in enumerate(zip(w_keys, w_vals)):
        lv = levels[b] if levels is not None else None
        bdir = _block_dir(cache_dir, b, lv) if cache_dir else None
        host = _load_cached(bdir, lv) if bdir else None
        if host is None:
            t0 = time.perf_counter()
            host = eng.encode_block(np.asarray(wk), np.asarray(wv), level=lv)
            if bdir:
                _save_cached(bdir, host)
            if log_fn:
                log_fn(f"  pre-encode block {b}: "
                       f"{time.perf_counter() - t0:.1f}s")
        hosts.append(host)
    return hosts


def run_fully_encrypted(ctx: CkksContext, w_keys, w_vals, x0,
                        bootstrap_fn=None, min_levels: int | None = None,
                        verbose: bool = True, return_ct: bool = False,
                        seq_chunks: bool = False,
                        pre_encoded: list | None = None, eng=None,
                        log_fn=None, calibrated: bool = False,
                        cache_dir: str | None = None, width: int = 1):
    """Chain blocks with per-block plaintext verification.  Returns
    per-block stats; with return_ct=True returns (stats, final_ciphertext)
    so a client-side head can consume the encrypted result.

    seq_chunks: ignored (see FullyEncryptedFfn).

    pre_encoded: optional pre_encode_blocks output -- when given (with
    calibrated=True weights) encoding stays out of the per-block timing.
    A block pre-encoded for another level than the one it is consumed at
    is re-encoded (or read from `cache_dir`, where the re-encode is also
    persisted).  With FHE_PREFETCH (default 1) block b+1's int32 staging
    is copied to the device on a thread while block b computes."""
    d, f = np.asarray(w_keys[0]).shape
    if eng is None:
        eng = FullyEncryptedFfn(ctx, d, f, width=width)
    width = eng.width
    if min_levels is None:
        min_levels = 4 if width == 1 else 8
    if width == 2 and bootstrap_fn is not None:
        raise NotImplementedError(
            "width-2 chains refresh to ctx.scale, not Delta_2; bootstrap "
            "integration needs a post-refresh scale-raise (future work)")
    if not calibrated:
        w_keys, w_vals = calibrate_magnitude(w_keys, w_vals, x0)

    x_ref = np.asarray(x0, dtype=np.float64).copy()
    refs = [x_ref.copy()]
    for wk, wv in zip(w_keys, w_vals):
        x_ref = plaintext_ffn_block(x_ref, wk, wv)
        refs.append(x_ref.copy())

    ct = ctx.encrypt_replicated(
        x0, scale=ctx.scale ** 2 if width == 2 else None)
    stats = []
    n_boot = 0
    say = log_fn if log_fn else (print if verbose else None)
    prefetch = os.environ.get("FHE_PREFETCH", "1") == "1"
    pf: dict = {}                     # one-slot prefetcher: thread, key, staged
    for b, (wk, wv) in enumerate(zip(w_keys, w_vals)):
        if ct.level - 1 < min_levels:
            if bootstrap_fn is None:
                if say:
                    say(f"  out of levels at block {b} (level={ct.level})")
                break
            t0 = time.perf_counter()
            ct = bootstrap_fn(ct)
            # exact-mode blocks assume tag == true scale == ctx.scale; a
            # refresh landing off-scale is adjusted exactly
            if abs(ct.scale - ctx.scale) > 1e-9 * ctx.scale:
                ct = ctx.scale_to(ct, ctx.scale, exact=True)
            else:
                ct = ctx.set_scale(ct, ctx.scale)
            n_boot += 1
            if say:
                say(f"  bootstrap before block {b}: "
                    f"{time.perf_counter() - t0:.2f}s -> level {ct.level}")
        t0 = time.perf_counter()
        if pre_encoded is not None:
            host = pre_encoded[b]
            if host.get("level") != ct.level:
                # encoded for another (or no) consume level, e.g. after an
                # unplanned refresh level: load a persisted re-encode, else
                # re-encode at the exact scales; keep it in memory and on
                # disk so later passes hit steady state
                bdir = _block_dir(cache_dir, b, ct.level) if cache_dir else None
                host = _load_cached(bdir, ct.level) if bdir else None
                if host is None:
                    if say:
                        say(f"  block {b}: re-encode for level {ct.level} "
                            f"(pre-encoded for {pre_encoded[b].get('level')})")
                    host = eng.encode_block(np.asarray(w_keys[b]),
                                            np.asarray(w_vals[b]),
                                            level=ct.level)
                    if bdir:
                        _save_cached(bdir, host)
                pre_encoded[b] = host
        else:
            host = eng.encode_block(np.asarray(wk), np.asarray(wv),
                                    level=ct.level)

        # consume a prefetched staging if it matches this block and level
        staged = None
        if pf.get("thread") is not None:
            pf.pop("thread").join()
            if pf.get("key") == (b, ct.level):
                staged = pf.get("staged")
            pf.clear()
        if staged is None:
            staged = eng.load_block(host, ct.level)

        # prefetch block b+1's int32 staging (a host-to-device copy, no
        # kernel) on a thread while this block computes
        if prefetch and pre_encoded is not None and b + 1 < len(pre_encoded):
            nh = pre_encoded[b + 1]
            nl = nh.get("level")
            if nl is not None and nl == ct.level - 3 * width:
                def _pre(nh=nh, nl=nl, nb=b + 1):
                    try:
                        pf["staged"] = eng.load_block(nh, nl)
                        pf["key"] = (nb, nl)
                    except Exception:
                        _log.exception("prefetch of block %d failed; the "
                                       "loop stages it itself", nb)
                pf["thread"] = threading.Thread(target=_pre, daemon=True)
                pf["thread"].start()

        ct = eng(ct, staged)
        _sync(ct.c)
        del staged
        dt = time.perf_counter() - t0
        dec = ctx.decrypt_vec(ct, d)
        corr = float(np.corrcoef(dec, refs[b + 1])[0, 1])
        err = float(np.max(np.abs(dec - refs[b + 1])))
        stats.append({"block": b, "corr": corr, "max_err": err, "sec": dt,
                      "level": ct.level, "bootstraps": n_boot})
        if say:
            say(f"  block {b}: corr={corr:.10f} max_err={err:.2e} "
                f"level={ct.level} {dt:.2f}s")
    if pf.get("thread") is not None:
        pf["thread"].join()
    return (stats, ct) if return_ct else stats


def full_vocab_head(x: np.ndarray, w_head: np.ndarray,
                    ln_w=None, ln_b=None):
    """Client-side full-vocabulary head: LN(x) @ W_head -> logits, argmax.
    Only the D-dim hidden state crosses the wire, never vocab-sized data.
    Returns (token_id, logits)."""
    x = np.asarray(x, dtype=np.float64)
    h = (x - x.mean()) / np.sqrt(x.var() + 1e-5)
    if ln_w is not None:
        h = h * np.asarray(ln_w, dtype=np.float64)
    if ln_b is not None:
        h = h + np.asarray(ln_b, dtype=np.float64)
    logits = h @ np.asarray(w_head, dtype=np.float64)
    return int(np.argmax(logits)), logits


def generate_fully_encrypted_token(ctx: CkksContext, w_keys, w_vals,
                                   w_head, x0, bootstrap_fn=None,
                                   min_levels: int = 4,
                                   seq_chunks: bool = False,
                                   ln_w=None, ln_b=None):
    """Full-vocab generation step: fully-encrypted FFN trunk + client-side
    head over the whole vocabulary (seq_chunks: ignored, see
    FullyEncryptedFfn).  Returns (token_id, logits, stats)."""
    stats, ct = run_fully_encrypted(
        ctx, w_keys, w_vals, x0, bootstrap_fn=bootstrap_fn,
        min_levels=min_levels, verbose=False, return_ct=True)
    d = np.asarray(w_keys[0]).shape[0]
    dec = ctx.decrypt_vec(ct, d)
    token, logits = full_vocab_head(dec, w_head, ln_w, ln_b)
    return token, logits, stats


class FullyEncryptedTimeMix:
    """Fully-encrypted time-mix block: the sigmoid gate is the linear
    surrogate 0.25x + 0.5 with the 0.25 folded into W_r, then the
    (r * k) * v CT-CT chain with level-aligned accumulation and the W_o
    output projection + residual (4 levels a block).

    Oracle: x + W_o @ (((0.25*(W_r x)+0.5) * (W_k x)) * (W_v x)).
    """

    def __init__(self, ctx: CkksContext, d: int):
        self.ctx = ctx
        self.d = d
        self.eng = BsgsMatvec(ctx, d)

    @staticmethod
    def oracle(x, w_r, w_k, w_v, w_o):
        r = 0.25 * (x @ w_r) + 0.5
        return x + ((r * (x @ w_k)) * (x @ w_v)) @ w_o

    def diag_scales(self, level: int) -> tuple[float, float]:
        """Exact scale management: with s_rkv = q[l-1] and s_o =
        q[l-2]*q[l-3]*q[l-4]/Delta^2 the output scale equals the input
        scale exactly (at the chain invariant s_x = Delta)."""
        assert level >= 5, f"consume level must be >= 5, got {level}"
        q = self.ctx.q_np
        s_rkv = float(q[level - 1])
        s_o = (float(q[level - 2]) * float(q[level - 3]) *
               float(q[level - 4]) / (self.ctx.scale * self.ctx.scale))
        return s_rkv, s_o

    def encode_block(self, w_r, w_k, w_v, w_o, level: int | None = None):
        enc = self.eng.encode
        s_rkv, s_o = ((None, None) if level is None
                      else self.diag_scales(level))
        out = {"rkv": np.stack([enc(0.25 * w_r.T, s_rkv).coeffs,
                                enc(w_k.T, s_rkv).coeffs,
                                enc(w_v.T, s_rkv).coeffs]),
               "o": enc(w_o.T, s_o).coeffs}
        if level is not None:
            out["level"] = level
        return out

    def __call__(self, ct_x: Ciphertext, host: dict) -> Ciphertext:
        ctx, l = self.ctx, ct_x.level
        assert l >= 5, f"need >= 5 limbs, have {l}"
        q = ctx.q_np
        exact = "level" in host
        if exact:
            assert host["level"] == l, (host["level"], l)
            s_rkv, s_o = self.diag_scales(l)
        else:
            s_rkv = s_o = ctx.scale
        pt3 = _load_coeffs(ctx, host["rkv"], l)
        rkv = bsgs_kernel(self.eng, l, "shared")(ct_x.c, pt3)  # [3, 2, l-1, N]
        del pt3
        s1 = ct_x.scale * s_rkv / float(q[l - 1])
        r = Ciphertext(rkv[0], s1)
        k = Ciphertext(rkv[1], s1)
        v = Ciphertext(rkv[2], s1)
        # r~ = 0.25 Wr x + 0.5 (the 0.25 is already folded into the diags)
        half = ctx.encode(np.full(ctx.slots, 0.5), level=r.level,
                          scale=r.scale)
        r = ctx.add_plain(r, half)
        rk = ctx.rescale(ctx.multiply(r, k))            # l-2
        rkv_ct = ctx.rescale(ctx.multiply(rk, ctx.mod_switch_to(v, rk.level)))
        # W_o projection at l-3 -> l-4
        pto = _load_coeffs(ctx, host["o"], rkv_ct.level)
        out = self.eng(rkv_ct, pto, pt_scale=s_o)
        x_al = ctx.mod_switch_to(ct_x, out.level)
        tgt = out.scale if exact else x_al.scale
        return ctx.add(ctx.set_scale(x_al, tgt), ctx.set_scale(out, tgt))
