"""Client-aided RWKV-7 generation under CKKS.

Counterpart of `fhe_spear_tpu/models/client_aided.py`: one stream
(`FheRwkvClient`, `run_generation`); S streams through one call are
`models/device_client.DeviceTokenRunner.generate_tokens_streams`.
Protocol: per block, 4 crypto round trips --
  1. client sends Enc(xr), Enc(xk), Enc(xv); server returns Enc(W_r xr),
     Enc(W_k xk), Enc(W_v xv)
  2. client runs the WKV-7 recurrence + gates, sends Enc(gated);
     server returns Enc(W_o gated)
  3. client sends Enc(xk_ffn); server returns the F-dim FFN key projection
     (complex-packed output chunk pairs)
  4. client applies ReLU^2, sends complex-packed input chunk pairs;
     server returns the conjugate-trick value projection partials.

Diagonals for all blocks are pre-encoded on the host as int32 coefficient
tensors and staged to the device per block as they are; the kernel
expands them to residues one chunk of giant groups at a time.
Client inputs are sup-norm normalized before encryption and rescaled after
decryption (exact for a linear server).  Per projection: exactly 1 level.

Two transports:
  * fused=True: encrypt -> BSGS -> partial decrypt on the device per round
    trip; encryption randomness comes from an explicit `torch.Generator`
    on the device (the same distribution as the reference's threefry
    draw, not the same bits).
  * fused=False: explicit Ciphertext objects across the boundary, with
    host randomness (bitwise-faithful to the reference).
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np
import torch

from ..ckks.ciphertext import Ciphertext
from ..ckks.context import CkksContext
from ..ckks.device_encrypt import _generator, encrypt_on_device
from ..native import encode_i32
from ..ops.bsgs import BsgsMatvec, bsgs_kernel
from .rwkv7 import (
    RwkvModel, RwkvState, generate_token_plaintext, layer_norm, token_mix,
    wkv7_client,
)

__all__ = ["FheRwkvServer", "FheRwkvClient", "run_generation"]


def _chunk_pairs(n_chunks: int):
    """Chunk indices grouped in pairs (padded with None)."""
    pairs = []
    c = 0
    while c < n_chunks:
        pairs.append((c, c + 1 if c + 1 < n_chunks else None))
        c += 2
    return pairs


class FheRwkvServer:
    """Server side: holds pre-encoded diagonals, evaluates BSGS matvecs.

    The server never sees a secret key on the explicit transport; it
    receives and returns Ciphertexts.
    """

    def __init__(self, ctx: CkksContext, model: RwkvModel, level: int = 3,
                 max_cached_blocks: int | None = None,
                 cache_dir: str | None = None):
        self.ctx = ctx
        self.level = level
        d, f = model.d, model.blocks[0].f
        self.d, self.f = d, f
        self.eng = BsgsMatvec(ctx, d)
        self.n_chunks = -(-f // d)
        self.key_pairs = _chunk_pairs(self.n_chunks)
        self.blocks_host: list[dict] = []
        self.max_cached_blocks = (len(model.blocks) if max_cached_blocks is None
                                  else max_cached_blocks)
        self._device: dict[int, dict] = {}
        t0 = time.perf_counter()
        if cache_dir is not None:
            os.makedirs(cache_dir, exist_ok=True)
        keys = ("rkv", "o", "ffn_key", "ffn_val")
        for bi, blk in enumerate(model.blocks):
            bdir = (os.path.join(cache_dir, f"block{bi}_{d}_{f}_{level}")
                    if cache_dir else None)
            if bdir and all(os.path.exists(os.path.join(bdir, k + ".npy"))
                            for k in keys):
                self.blocks_host.append(
                    {k: np.load(os.path.join(bdir, k + ".npy"),
                                mmap_mode="r") for k in keys})
            else:
                enc = self._pre_encode_block(blk)
                if bdir:
                    os.makedirs(bdir, exist_ok=True)
                    for k, v in enc.items():
                        np.save(os.path.join(bdir, k + ".npy"), v)
                self.blocks_host.append(enc)
        self.preencode_time = time.perf_counter() - t0

    # -- host pre-encoding --------------------------------------------------

    def _pre_encode_block(self, blk) -> dict:
        enc = self.eng.encode
        out = {}
        # r, k, v stacked for the batched round-1 call; o separate
        out["rkv"] = np.stack([enc(blk.W_r.T).coeffs, enc(blk.W_k.T).coeffs,
                               enc(blk.W_v.T).coeffs])
        out["o"] = enc(blk.W_o.T).coeffs
        # FFN key D->F: output chunk pairs, complex-packed
        mats = []
        for c0, c1 in self.key_pairs:
            m0 = self._out_chunk(blk.W_key_ffn, c0)
            m1 = self._out_chunk(blk.W_key_ffn, c1) if c1 is not None else 0.0
            mats.append(enc(m0 + 1j * np.asarray(m1)).coeffs)
        out["ffn_key"] = np.stack(mats)
        # FFN val F->D: input chunk pairs, conjugate trick (M0 - i*M1)
        mats = []
        for c0, c1 in self.key_pairs:
            m0 = self._in_chunk(blk.W_val_ffn, c0)
            m1 = self._in_chunk(blk.W_val_ffn, c1) if c1 is not None else 0.0
            mats.append(enc(m0 - 1j * np.asarray(m1)).coeffs)
        out["ffn_val"] = np.stack(mats)
        return out

    def _out_chunk(self, w, c):
        """W[:, c*D:(c+1)*D].T zero-padded to [D, D] (output chunking)."""
        d = self.d
        m = np.zeros((d, d))
        cols = w[:, c * d: (c + 1) * d].T
        m[: cols.shape[0]] = cols
        return m

    def _in_chunk(self, w, c):
        """W[c*D:(c+1)*D, :].T zero-padded to [D, D] (input chunking)."""
        d = self.d
        m = np.zeros((d, d))
        rows = w[c * d: (c + 1) * d, :].T
        m[:, : rows.shape[1]] = rows
        return m

    # -- device staging -------------------------------------------------------

    def load_block(self, i: int) -> dict:
        if i in self._device:
            return self._device[i]
        if len(self._device) >= self.max_cached_blocks:
            # MRU eviction: block access is cyclic (0..B-1 repeating), so
            # evicting the most recently staged block pins a prefix of
            # max_cached_blocks-1 blocks that hit every cycle
            self._device.pop(next(reversed(self._device)))
        host = self.blocks_host[i]
        # int32 coefficients as encoded; the kernel expands them
        stage = lambda: {k: torch.as_tensor(np.asarray(v),
                                            device=self.ctx.device)
                         for k, v in host.items()}

        try:
            staged = stage()
        except torch.cuda.OutOfMemoryError:
            # device OOM backoff: drop the cache and retry once
            self._device.clear()
            gc.collect()
            torch.cuda.empty_cache()
            try:
                staged = stage()
            except torch.cuda.OutOfMemoryError as e2:
                raise RuntimeError(
                    "block staging does not fit in device memory even with "
                    "an empty cache -- lower FHE_MAX_CACHED_BLOCKS") from e2
        self._device[i] = staged
        return staged

    # -- projection services (explicit transport) ----------------------------

    def project_rkv(self, i: int, ct3: Ciphertext) -> Ciphertext:
        """Batched r/k/v: ct3 holds [3, 2, l, N]."""
        return self._batched_matvec(ct3, self.load_block(i)["rkv"])

    def project_o(self, i: int, ct: Ciphertext) -> Ciphertext:
        return self.eng(ct, self.load_block(i)["o"])

    def project_ffn_key(self, i: int, ct: Ciphertext) -> Ciphertext:
        """One input ct against every output chunk pair: [P, 2, l-1, N]."""
        pt = self.load_block(i)["ffn_key"]
        return Ciphertext(self._kernel(ct.level, "shared")(ct.c, pt),
                          self._out_scale(ct))

    def project_ffn_val(self, i: int, ct_pairs: Ciphertext) -> Ciphertext:
        """Input chunk-pair cts [P, 2, l, N] against matching diagonals."""
        return self._batched_matvec(ct_pairs, self.load_block(i)["ffn_val"])

    def _out_scale(self, ct):
        return ct.scale * self.ctx.scale / float(self.ctx.q_np[ct.level - 1])

    def _batched_matvec(self, ct: Ciphertext, pt: torch.Tensor) -> Ciphertext:
        return Ciphertext(self._kernel(ct.level, "batched")(ct.c, pt),
                          self._out_scale(ct))

    def _kernel(self, l: int, mode: str):
        """kern(c, pt) for one transport shape (see `bsgs_kernel`)."""
        return bsgs_kernel(self.eng, l, mode)

    # -- fused round trip -----------------------------------------------------
    # encrypt -> BSGS -> partial decrypt on the device in one call; the
    # client-side host-randomness path remains for strict parity.

    def fused_project(self, kind: str, i: int, m_coeffs: np.ndarray,
                      seed: int) -> np.ndarray:
        """m_coeffs: int32 [b, N] encoded inputs.  Returns decrypted
        limb pairs [b, 2, N] (host finishes with the uint64 CRT)."""
        ctx = self.ctx
        l = self.level
        pt = self.load_block(i)[kind]
        # per-kind transport shape: "o" is a single ct against a single
        # matrix; "ffn_key" shares one ct across stacked matrices;
        # rkv / ffn_val batch both
        mode = {"o": "single", "ffn_key": "shared"}.get(kind, "batched")
        m = torch.as_tensor(m_coeffs[0] if mode in ("single", "shared")
                            else m_coeffs, device=ctx.device)
        c = encrypt_on_device(ctx, m, _generator(ctx.device, seed), l)
        out = self._kernel(l, mode)(c, pt)                 # [b, 2, l-1, N]
        limbs = ctx.decrypt_limbs(out, min(2, l - 1)).cpu().numpy()
        return limbs[None] if mode == "single" else limbs


class FheRwkvClient:
    """Client side: all nonlinearities in plaintext, normalizes before
    encryption, drives the 4-round-trip protocol over the fused
    (default) or explicit transport."""

    def __init__(self, ctx: CkksContext, model: RwkvModel,
                 server: FheRwkvServer, fused: bool = True):
        self.ctx = ctx
        self.model = model
        self.server = server
        self.level = server.level
        self.d, self.f = server.d, server.f
        self.fused = fused
        # per-ciphertext device randomness is Generator(base + counter); the
        # base comes from the context RNG (OS-entropy-seeded unless the
        # context was explicitly seeded), so two clients never reuse (a, e)
        self._seed = int(ctx.rng.randint(0, 1 << 62, dtype=np.int64))

    # -- encode / transport helpers -------------------------------------------

    def _encode_i32(self, slots: np.ndarray) -> np.ndarray:
        return encode_i32(self.ctx.encoder, slots, self.ctx.scale)

    def _tile(self, xs: np.ndarray) -> np.ndarray:
        return np.tile(xs, (1, self.ctx.slots // xs.shape[-1]))

    def _project(self, kind: str, i: int, slots: np.ndarray) -> np.ndarray:
        """Send normalized slot rows through one server projection; returns
        decrypted complex slot rows [b, S]."""
        ctx = self.ctx
        out_scale = ctx.scale * ctx.scale / float(ctx.q_np[self.level - 1])
        if self.fused:
            self._seed += 1
            limbs = self.server.fused_project(
                kind, i, self._encode_i32(slots), self._seed)
            return ctx.encoder.decode(ctx.compose_coeffs(limbs), out_scale)
        ct = ctx.encrypt(slots if slots.shape[0] > 1 else slots[0],
                         level=self.level)
        if kind == "rkv":
            out = self.server.project_rkv(i, ct)
        elif kind == "o":
            out = self.server.project_o(i, ct)
        elif kind == "ffn_key":
            out = self.server.project_ffn_key(i, ct)
        else:
            out = self.server.project_ffn_val(i, ct)
        return np.atleast_2d(ctx.decrypt_vec_complex(out))

    # -- the protocol -----------------------------------------------------------

    def block(self, i: int, x, x_prev_att, x_prev_ffn, state, v_first):
        """One client-aided block; mirrors the plaintext oracle exactly."""
        blk = self.model.blocks[i]
        srv, d = self.server, self.d
        timings = {}

        t0 = time.perf_counter()
        x_ln = layer_norm(x, blk.ln1_w, blk.ln1_b)
        mixes = token_mix(blk, x_ln, x_prev_att)
        xs = np.stack([mixes["r"], mixes["k"], mixes["v"]])
        mag = np.maximum(np.abs(xs).max(axis=-1, keepdims=True), 1e-9)
        timings["client_mix"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        rkv = self._project("rkv", i, self._tile(xs / mag)).real[:, :d] * mag
        r, k, v = rkv[0], rkv[1], rkv[2]
        timings["server_rkv"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        gated, new_state, v, v_first = wkv7_client(blk, r, k, v, mixes, state,
                                                   v_first)
        mag_g = max(np.abs(gated).max(), 1e-9)
        timings["client_wkv_gate"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        att = self._project("o", i, self._tile(gated[None] / mag_g)
                            )[0].real[:d] * mag_g
        timings["server_wo"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        x = x + att
        x_ffn_ln = layer_norm(x, blk.ln2_w, blk.ln2_b)
        xk_ffn = x_ffn_ln + (x_prev_ffn - x_ffn_ln) * blk.x_k_ffn
        mag_fk = max(np.abs(xk_ffn).max(), 1e-9)
        timings["client_ffn_prep"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        z = self._project("ffn_key", i, self._tile(xk_ffn[None] / mag_fk)
                          ) * mag_fk
        fk = np.zeros(srv.n_chunks * d)
        for p, (c0, c1) in enumerate(srv.key_pairs):
            fk[c0 * d: (c0 + 1) * d] = z[p, :d].real
            if c1 is not None:
                fk[c1 * d: (c1 + 1) * d] = z[p, :d].imag
        fk = fk[: self.f]
        timings["server_ffn_key"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        fk = np.maximum(fk, 0.0) ** 2
        pads = []
        for c0, c1 in srv.key_pairs:
            x0 = np.pad(fk[c0 * d: (c0 + 1) * d],
                        (0, max(0, d - len(fk[c0 * d: (c0 + 1) * d]))))
            x1 = (np.pad(fk[c1 * d: (c1 + 1) * d],
                         (0, max(0, d - len(fk[c1 * d: (c1 + 1) * d]))))
                  if c1 is not None else np.zeros(d))
            pads.append(x0 + 1j * x1)
        zp = np.stack(pads)
        mag_v = max(np.abs(zp.real).max(initial=0),
                    np.abs(zp.imag).max(initial=0), 1e-9)
        timings["client_relu_sq"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        zv = self._project("ffn_val", i, self._tile(zp / mag_v)) * mag_v
        v_ffn = zv[:, :d].real.sum(axis=0)
        timings["server_ffn_val"] = time.perf_counter() - t0

        x = x + v_ffn
        return x, x_ln, x_ffn_ln, new_state, v_first, timings

    def generate_token(self, token_id: int, state: RwkvState):
        """One FHE token step."""
        m = self.model
        x = layer_norm(m.emb[token_id].copy(), m.ln0_w, m.ln0_b)
        new = state.copy()
        v_first = None
        all_timings = []
        for i in range(len(m.blocks)):
            x, xpa, xpf, s, v_first, t = self.block(
                i, x, state.x_prev_att[i], state.x_prev_ffn[i], state.wkv[i],
                v_first)
            new.x_prev_att[i], new.x_prev_ffn[i], new.wkv[i] = xpa, xpf, s
            all_timings.append(t)
        logits = layer_norm(x, m.ln_out_w, m.ln_out_b) @ m.head_w
        return logits, new, all_timings


def run_generation(ctx: CkksContext, model: RwkvModel, seed_tokens,
                   num_tokens: int, level: int = 3, verbose: bool = True,
                   fused: bool = True, log_fn=None):
    """Prefill in plaintext, then generate under FHE with a plaintext twin;
    reports per-token match + logit correlation."""
    t0 = time.perf_counter()
    mc = os.environ.get("FHE_MAX_CACHED_BLOCKS")
    server = FheRwkvServer(
        ctx, model, level=level,
        max_cached_blocks=int(mc) if mc else None,
        cache_dir=os.environ.get("FHE_PREENC_CACHE"))
    client = FheRwkvClient(ctx, model, server, fused=fused)
    if log_fn is not None:
        log_fn(f"server init {time.perf_counter() - t0:.1f}s "
               f"(pre-encode {server.preencode_time:.1f}s, fused={fused})")

    st_fhe, st_ref = model.zero_state(), model.zero_state()
    for tok in seed_tokens[:-1]:
        _, st_fhe = generate_token_plaintext(model, tok, st_fhe)
        _, st_ref = generate_token_plaintext(model, tok, st_ref)

    tok_fhe = tok_ref = seed_tokens[-1]
    results = []
    for step in range(num_tokens):
        logits_ref, st_ref = generate_token_plaintext(model, tok_ref, st_ref)
        t0 = time.perf_counter()
        logits_fhe, st_fhe, timings = client.generate_token(tok_fhe, st_fhe)
        dt = time.perf_counter() - t0
        tok_ref = int(np.argmax(logits_ref))
        tok_fhe = int(np.argmax(logits_fhe))
        corr = float(np.corrcoef(logits_fhe, logits_ref)[0, 1])
        results.append({"ref": tok_ref, "fhe": tok_fhe,
                        "match": tok_ref == tok_fhe, "corr": corr, "sec": dt})
        if log_fn is not None:
            log_fn(f"token {step}: ref={tok_ref} fhe={tok_fhe} "
                   f"match={tok_ref == tok_fhe} corr={corr:.6f} {dt:.2f}s")
            agg = {}
            for bt in timings:
                for k, v in bt.items():
                    agg[k] = agg.get(k, 0.0) + v
            log_fn("  phases: " + " ".join(
                f"{k}={v:.3f}s" for k, v in sorted(agg.items())))
        elif verbose:
            print(f"  token {step}: ref={tok_ref} fhe={tok_fhe} "
                  f"match={tok_ref == tok_fhe} corr={corr:.6f} {dt:.2f}s")
    return results
