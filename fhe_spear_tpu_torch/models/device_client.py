"""Client-aided token pipeline with the client role on the device.

Counterpart of `fhe_spear_tpu/models/device_client.py`.  The classic
transport (models/client_aided.py) runs the client role on the host: four
encode/encrypt -> server kernel -> decrypt/decode round trips per block,
with host FFT encodes and the WKV-7 recurrence in numpy between them.  This
module keeps the same protocol algebra -- every value that crosses the
client/server boundary is encrypted with fresh randomness, the server math
sees only ciphertexts and pre-encoded diagonals, and decryption uses the
secret key exactly where the protocol says the client would -- but runs
the client role on the device too, in float32, so a token never leaves the
device between its blocks.

  * The client's crypto and the server's projection path (device
    encode/decode, encrypt, single-limb decryption under PRESCALE, the
    BSGS kernels and their CUDA graphs) are `models/device_crypto.
    DeviceClient`'s, shared with the LFM2 runner (`models/lfm2.py`); an
    encoding may differ from the reference's XLA FFT by one unit in a
    coefficient.
  * The WKV-7 recurrence, gates, GroupNorm and ReLU^2 are torch float32
    forms of the numpy oracle (models/rwkv7.py).
  * Randomness comes from a `torch.Generator` on the device seeded from
    the runner's `_seed`: the reference's threefry draw in distribution,
    not in bits, so tokens and logit correlation are compared, not words.

What the reference needed and the port does not: the token is one jitted
`lax.scan` over blocks there and a Python loop over blocks here; `vmap`
over projections becomes `ops.bsgs.bsgs_kernel`'s "batched" and
"shared" modes, and `vmap` over streams a leading stream axis; the remote
TPU's workarounds (host-only complex tables, in-jit key derivation, numpy
arguments) have no counterpart.
"""

from __future__ import annotations

import hashlib
import math
import os
import time

import numpy as np
import torch

from ..ckks.context import CkksContext
from ..ckks.device_encrypt import _generator
from ..utils.profiling import span
from .client_aided import _chunk_pairs
from .device_crypto import PRESCALE, DeviceClient
from .rwkv7 import RwkvModel, RwkvState, generate_token_plaintext, layer_norm

__all__ = ["PRESCALE", "DeviceTokenRunner", "run_generation_device"]

_CLIENT_FIELDS = ["ln1_w", "ln1_b", "ln2_w", "ln2_b", "ln_x_w", "ln_x_b",
                  "x_r", "x_k", "x_v", "x_g", "x_w", "x_a", "x_k_ffn",
                  "w0", "w1", "w2", "a0", "a1", "a2", "v0", "v1", "v2",
                  "g1", "g2", "k_k", "k_a", "r_k"]


class DeviceTokenRunner(DeviceClient):
    """One FHE token (all blocks x 4 round trips, client math included) on
    the context's device; `generate_tokens_streams` advances S streams at
    once."""

    def __init__(self, ctx: CkksContext, model: RwkvModel, level: int = 3,
                 cache_dir: str | None = None, blocks: range | None = None):
        """blocks: the span of blocks whose diagonals and client weights
        this runner stages (default all; `parallel.block_pipeline` gives
        each rank its own span).  A token needs every block."""
        d, f = model.d, model.blocks[0].f
        super().__init__(ctx, d, level)
        self.model = model
        self.blocks = range(len(model.blocks)) if blocks is None else blocks
        self.f = f
        self.n_chunks = -(-f // d)
        self.key_pairs = _chunk_pairs(self.n_chunks)
        self._shared = {"fk"}             # one input against the pairs
        self._build_server_stacks(cache_dir)
        self._build_client_stacks()

    # -- server-side pre-encoding (diagonals / PRESCALE, int32) -------------

    def _build_server_stacks(self, cache_dir):
        enc = self.eng.encode
        d = self.d

        # the cached bytes are encodings of the weights: keyed by a hash of
        # every tensor encoded for the block, so a changed model never
        # reuses another model's diagonals (same names and hashes as the
        # reference, so the two packages share a cache)
        def block_hash(blk):
            h = hashlib.sha1()
            for w in (blk.W_r, blk.W_k, blk.W_v, blk.W_o,
                      blk.W_key_ffn, blk.W_val_ffn):
                h.update(np.ascontiguousarray(w).tobytes())
            return h.hexdigest()[:8]

        stacks = {"rkv": [], "o": [], "fk": [], "fv": []}
        names = list(stacks)
        for bi in self.blocks:
            blk = self.model.blocks[bi]
            bdir = (os.path.join(cache_dir, f"dc{bi}_{d}_{self.f}_"
                                 f"{self.ctx.n}_{block_hash(blk)}")
                    if cache_dir else None)
            if bdir and all(os.path.exists(os.path.join(bdir, k + ".npy"))
                            for k in names):
                for k in names:
                    stacks[k].append(np.load(os.path.join(bdir, k + ".npy"),
                                             mmap_mode="r"))
                continue
            one = {"rkv": np.stack([enc(blk.W_r.T / PRESCALE).coeffs,
                                    enc(blk.W_k.T / PRESCALE).coeffs,
                                    enc(blk.W_v.T / PRESCALE).coeffs]),
                   "o": enc(blk.W_o.T / PRESCALE).coeffs}
            fk_mats, fv_mats = [], []
            for c0, c1 in self.key_pairs:
                m0 = self._out_chunk(blk.W_key_ffn, c0)
                m1 = (self._out_chunk(blk.W_key_ffn, c1)
                      if c1 is not None else 0.0)
                fk_mats.append(enc((m0 + 1j * np.asarray(m1)) / PRESCALE
                                   ).coeffs)
                m0 = self._in_chunk(blk.W_val_ffn, c0)
                m1 = (self._in_chunk(blk.W_val_ffn, c1)
                      if c1 is not None else 0.0)
                fv_mats.append(enc((m0 - 1j * np.asarray(m1)) / PRESCALE
                                   ).coeffs)
            one["fk"] = np.stack(fk_mats)
            one["fv"] = np.stack(fv_mats)
            if bdir:
                os.makedirs(bdir, exist_ok=True)
                for k in names:
                    np.save(os.path.join(bdir, k + ".npy"), one[k])
            for k in names:
                stacks[k].append(one[k])
        # device-resident int32 stacks [nb, ...]
        self.pt = {k: torch.as_tensor(np.stack(v), device=self.device)
                   for k, v in stacks.items()}
        # W_o's row as a stack of one, like the other rows
        self.pt["o"] = self.pt["o"][:, None]

    def _out_chunk(self, w, c):
        d = self.d
        m = np.zeros((d, d))
        cols = w[:, c * d: (c + 1) * d].T
        m[: cols.shape[0]] = cols
        return m

    def _in_chunk(self, w, c):
        d = self.d
        m = np.zeros((d, d))
        rows = w[c * d: (c + 1) * d, :].T
        m[:, : rows.shape[1]] = rows
        return m

    # -- client weights stacked over blocks, float32 ------------------------

    def _build_client_stacks(self):
        self.cw = {
            name: torch.as_tensor(np.stack(
                [np.asarray(getattr(self.model.blocks[bi], name),
                            dtype=np.float32) for bi in self.blocks]),
                device=self.device)
            for name in _CLIENT_FIELDS}

    # -- the token step -------------------------------------------------------

    def _block_body(self, bi, x, v_first, xpa, xpf, state, gen):
        """One block of the protocol for S streams -- all 4 encrypted round
        trips plus the device-resident client math.  x, v_first, xpa, xpf:
        [S, d] float32; state [S, h, hs, hs].  Returns (x', v_first', x_ln,
        x_ffn_ln, new_state); the last three become the next token's
        per-block token-mix and WKV state."""
        d = self.d
        h, hs = self.model.n_head, self.model.head_size
        S = x.shape[0]
        j = bi - self.blocks.start                 # row of the staged span
        w = {k: t[j] for k, t in self.cw.items()}
        sig = torch.sigmoid

        def ln(v, wt, bb, eps=1e-5):
            mu = v.mean(-1, keepdim=True)
            var = v.var(-1, correction=0, keepdim=True)
            return (v - mu) / torch.sqrt(var + eps) * wt + bb

        def amax(v):                       # per-stream sup norm, [S, 1, ...]
            m = v.abs().reshape(S, -1).amax(-1)
            m = torch.clamp(m, min=1e-9)
            return m.reshape((S,) + (1,) * (v.dim() - 1))

        # client.math spans each stretch of client math between the round
        # trips, which open their own client.* and server.bsgs spans
        with span("client.math"):
            x_ln = ln(x, w["ln1_w"], w["ln1_b"])
            xx = xpa - x_ln
            mix = {nm: x_ln + xx * w["x_" + nm]
                   for nm in ("r", "k", "v", "g", "w", "a")}
            xs3 = torch.stack([mix["r"], mix["k"], mix["v"]], dim=1)
            mag = torch.clamp(xs3.abs().amax(-1, keepdim=True), min=1e-9)
            rows = self._tile((xs3 / mag).to(torch.complex64))   # [S, 3, .]

        # -- round trip 1: r, k, v projections ------------------------------
        rkv = self._project("rkv", j, rows, gen)

        # -- client: WKV-7 recurrence --------------------------------------
        with span("client.math"):
            rkv = rkv.real[..., :d] * mag
            r, k, v = rkv[:, 0], rkv[:, 1], rkv[:, 2]
            w_vec = sig(w["w0"] + torch.tanh(mix["w"] @ w["w1"]) @ w["w2"])
            decay = torch.exp(-math.exp(-0.5) * w_vec.reshape(S, h, hs))
            a_h = sig(w["a0"] + (mix["a"] @ w["a1"]) @ w["a2"]
                      ).reshape(S, h, hs)
            kk = (k * w["k_k"]).reshape(S, h, hs)
            kk = kk / (torch.linalg.norm(kk, dim=-1, keepdim=True) + 1e-12)
            k_h = k.reshape(S, h, hs) * (1.0 + (a_h - 1.0)
                                         * w["k_a"].reshape(h, hs))
            if bi == 0:
                v_first = v
            else:
                v_gate = sig(w["v0"] + (mix["v"] @ w["v1"]) @ w["v2"])
                v = v + (v_first - v) * v_gate
            v_h = v.reshape(S, h, hs)
            rh = r.reshape(S, h, hs)
            sa = torch.einsum("shij,shj->shi", state, -kk)
            new_state = (state * decay[..., None, :]
                         + sa[..., :, None] * (kk * a_h)[..., None, :]
                         + v_h[..., :, None] * k_h[..., None, :])
            g_ = torch.einsum("shij,shj->shi", new_state, rh)
            g_ = (g_ - g_.mean(-1, keepdim=True)) / torch.sqrt(
                g_.var(-1, correction=0, keepdim=True) + 64e-5)
            wkv = g_.reshape(S, h * hs) * w["ln_x_w"] + w["ln_x_b"]
            bonus = (rh * k_h * w["r_k"]).sum(-1, keepdim=True) * v_h
            wkv = wkv + bonus.reshape(S, h * hs)
            gated = wkv * (sig(mix["g"] @ w["g1"]) @ w["g2"])
            mag_g = amax(gated)                               # [S, 1]
            rows = self._tile((gated / mag_g).to(torch.complex64))[:, None]

        # -- round trip 2: W_o ---------------------------------------------
        att = self._project("o", j, rows, gen)

        with span("client.math"):
            x = x + att.real[:, 0, :d] * mag_g
            x_ffn_ln = ln(x, w["ln2_w"], w["ln2_b"])
            xk_ffn = x_ffn_ln + (xpf - x_ffn_ln) * w["x_k_ffn"]
            mag_fk = amax(xk_ffn)
            rows = self._tile((xk_ffn / mag_fk).to(torch.complex64))[:, None]

        # -- round trip 3: FFN key (complex chunk pairs) -------------------
        z = self._project("fk", j, rows, gen)              # [S, P, slots]

        # client: unpack pairs -> relu^2 -> repack complex pairs
        with span("client.math"):
            z = z[..., :d] * mag_fk[..., None]
            fk_re = torch.clamp(z.real, min=0.0) ** 2        # [S, P, d]
            fk_im = torch.clamp(z.imag, min=0.0) ** 2
            zp = torch.complex(fk_re, fk_im)
            mag_v = torch.maximum(amax(fk_re), amax(fk_im))  # [S, 1, 1]
            rows = self._tile((zp / mag_v).to(torch.complex64))

        # -- round trip 4: FFN value (conjugate trick) ---------------------
        zv = self._project("fv", j, rows, gen)
        with span("client.math"):
            x = x + zv.real[..., :d].sum(dim=1) * mag_v[:, 0]
        return x, v_first, x_ln, x_ffn_ln, new_state

    def _token(self, token_ids, xpa, xpf, states, seed):
        """All blocks of one token for S streams.  xpa, xpf: [S, nb, d];
        states [S, nb, h, hs, hs] (float32 device tensors)."""
        m = self.model
        assert len(self.blocks) == len(m.blocks), "a token needs every block"
        with span("token.embed"):
            x = torch.as_tensor(np.stack([
                layer_norm(np.asarray(m.emb[t], dtype=np.float64), m.ln0_w,
                           m.ln0_b) for t in token_ids]).astype(np.float32),
                device=self.device)
        gen = _generator(self.device, seed)
        v_first = None
        outs = []
        for bi in range(len(m.blocks)):
            x, v_first, x_ln, x_ffn_ln, st = self._block_body(
                bi, x, v_first, xpa[:, bi], xpf[:, bi], states[:, bi], gen)
            outs.append((x_ln, x_ffn_ln, st))
        with span("token.readback"):
            x_out = x.double().cpu().numpy()
            xpa_n, xpf_n, st_n = (torch.stack(t, dim=1).double().cpu()
                                  .numpy() for t in zip(*outs))
        with span("token.head"):
            logits = layer_norm(x_out, m.ln_out_w, m.ln_out_b) @ m.head_w
        with span("token.state_out"):
            news = [RwkvState(x_prev_att=list(xpa_n[s]),
                              x_prev_ffn=list(xpf_n[s]), wkv=list(st_n[s]))
                    for s in range(len(token_ids))]
        return logits, news

    def _state_tensors(self, states):
        f32 = lambda arrs: torch.as_tensor(
            np.stack([np.stack(a) for a in arrs]).astype(np.float32),
            device=self.device)
        with span("token.state_in"):
            return (f32([s.x_prev_att for s in states]),
                    f32([s.x_prev_ffn for s in states]),
                    f32([s.wkv for s in states]))

    # -- public API -----------------------------------------------------------

    def generate_token(self, token_id: int, state: RwkvState):
        """One FHE token step.  Returns (logits [vocab], new_state)."""
        self._seed += 1
        with span("token"):
            logits, news = self._token(
                [token_id], *self._state_tensors([state]), self._seed)
        return logits[0], news[0]

    def generate_tokens_streams(self, token_ids, states):
        """One token step for S independent streams at once (server
        plaintexts, client weights and rotation keys shared; each stream's
        ciphertexts are encrypted with their own randomness).  Returns
        (logits [S, vocab], new_states)."""
        self._seed += 1
        with span("token"):
            return self._token(list(token_ids), *self._state_tensors(states),
                               self._seed)


def run_generation_device(ctx, model, seed_tokens, num_tokens,
                          level: int = 3, cache_dir: str | None = None,
                          log_fn=None):
    """Device-client generation with the plaintext twin oracle (the same
    verification protocol as client_aided.run_generation)."""
    t0 = time.perf_counter()
    runner = DeviceTokenRunner(ctx, model, level=level, cache_dir=cache_dir)
    if log_fn:
        log_fn(f"device runner init {time.perf_counter() - t0:.1f}s")

    st_fhe, st_ref = model.zero_state(), model.zero_state()
    for tok in seed_tokens[:-1]:
        _, st_fhe = generate_token_plaintext(model, tok, st_fhe)
        _, st_ref = generate_token_plaintext(model, tok, st_ref)
    tok_fhe = tok_ref = seed_tokens[-1]
    results = []
    for step in range(num_tokens):
        logits_ref, st_ref = generate_token_plaintext(model, tok_ref, st_ref)
        t0 = time.perf_counter()
        logits_fhe, st_fhe = runner.generate_token(tok_fhe, st_fhe)
        dt = time.perf_counter() - t0
        tok_ref = int(np.argmax(logits_ref))
        tok_fhe = int(np.argmax(logits_fhe))
        corr = float(np.corrcoef(logits_fhe, logits_ref)[0, 1])
        results.append({"ref": tok_ref, "fhe": tok_fhe,
                        "match": tok_ref == tok_fhe, "corr": corr,
                        "sec": dt})
        if log_fn:
            log_fn(f"token {step}: ref={tok_ref} fhe={tok_fhe} "
                   f"match={tok_ref == tok_fhe} corr={corr:.6f} {dt:.2f}s")
    return results
