"""The client role's crypto and the server's projection path on the device,
shared by the device-resident token runners (`models/device_client.py`
for RWKV-7, `models/lfm2.py` for LFM2).

A runner is a `DeviceClient` over one `BsgsMatvec` engine of width D.  It
stages its D x D (complex) matrices as int32 diagonal encodings divided by
PRESCALE in `self.pt` (name -> [rows, ...] device stacks), names the ones
that one ciphertext runs against all at once in `self._shared`, and runs
each projection through `_project`: device encode -> encrypt -> the
server's BSGS kernel (one CUDA graph replay for all S streams where
`ops.graphed` engages) -> single-limb decrypt -> decode.

  * Encode/decode are the canonical-embedding FFTs on the device in
    complex64 (`torch.fft`).  Float32 encode rounding (~1e-6 relative) is
    extra benign encryption noise.
  * Single-limb decryption: server diagonals are pre-scaled by 1/PRESCALE
    so every projection output stays below q0 / (2 * out_scale); the
    client multiplies PRESCALE back after decoding, so decryption needs no
    multi-limb CRT.  With `track_headroom`, the largest decrypted
    coefficient over q0 / 2 is kept on the device (`headroom()`), read
    without a synchronise inside the step.
  * Randomness comes from a `torch.Generator` on the device seeded from
    the runner's `_seed`, drawn from the context's host generator right
    after the engine's rotation keys.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ckks.context import CkksContext
from ..ckks.device_encrypt import encrypt_on_device
from ..core.modops import add_mod, mont_mul
from ..ops.bsgs import BsgsMatvec, bsgs_dims, bsgs_kernel
from ..ops.graphed import ProjectionGraphs
from ..utils.profiling import span

__all__ = ["PRESCALE", "DeviceClient", "diagonal_slots"]

PRESCALE = 8.0  # folded out of the diagonals; bounds outputs for 1-limb dec


def diagonal_slots(w: torch.Tensor, slots: int) -> torch.Tensor:
    """The BSGS slot table of D x D matrices w [..., D, D] (complex):
    delta_k[j] = w[j, (j+k) % D] for k < G*B (zero past D), group g
    pre-rotated by +g*G, tiled to the slot count -> [..., B, G, slots]
    (`ops.bsgs.extract_diagonals` on the device, over a leading axis)."""
    d = w.shape[-1]
    G, B = bsgs_dims(d)
    j = torch.arange(d, device=w.device)
    k = torch.arange(G * B, device=w.device)
    cols = (j[None, :] + k[:, None]) % d                       # [G*B, D]
    rows = j[None, :].expand_as(cols)
    diags = w[..., rows, cols]                                 # [..., G*B, D]
    diags[..., d:, :] = 0
    diags = diags.reshape(w.shape[:-2] + (B, G, d))
    shift = (torch.arange(B, device=w.device) * G)[:, None, None]
    src = (j[None, None, :] - shift) % d                       # roll by +gG
    diags = torch.gather(diags, -1, src.expand(diags.shape).contiguous())
    return diags.repeat((1,) * (diags.dim() - 1) + (slots // d,))


class DeviceClient:
    """The client's device crypto and the server's projections over one
    BSGS engine of width d at `level`.  Subclasses fill `self.pt` (and
    `self._shared`) before the first projection."""

    def __init__(self, ctx: CkksContext, d: int, level: int = 3,
                 track_headroom: bool = False):
        self.ctx = ctx
        self.level = level
        self.device = ctx.device
        self.d = d
        # draws the rotation keys from ctx.rng first, then the runner's
        # seed below: the reference's order
        self.eng = BsgsMatvec(ctx, d)
        self._build_tables()
        # entropy-derived base seed (deterministic only for seeded contexts)
        self._seed = int(ctx.rng.randint(0, 1 << 62, dtype=np.int64))
        self._kern_b = bsgs_kernel(self.eng, level, "batched")
        self._kern_s = bsgs_kernel(self.eng, level, "shared")
        self._graphs = ProjectionGraphs(ctx)
        self.pt: dict = {}
        self._shared: set = set()
        self._peak = (torch.zeros((), dtype=torch.int64, device=self.device)
                      if track_headroom else None)

    # -- encoder tables (device FFT encode/decode) --------------------------

    def _build_tables(self):
        ctx = self.ctx
        enc = ctx.encoder
        dev = self.device
        self._t_slot = torch.as_tensor(enc._t_slot, device=dev)
        self._t_conj = torch.as_tensor(enc._t_conj, device=dev)
        self._zeta = torch.as_tensor(enc._zeta_pow.astype(np.complex64),
                                     device=dev)
        self._zeta_inv = torch.as_tensor(
            enc._zeta_pow_inv.astype(np.complex64), device=dev)
        self._q0 = int(ctx.q_np[0])
        self._out_scale = float(ctx.scale) * float(ctx.scale) / float(
            ctx.q_np[self.level - 1])

    # -- server-side staging --------------------------------------------------

    def encode_stack(self, mats) -> torch.Tensor:
        """D x D (complex) matrices, each the M of y = M x (numpy or torch,
        one at a time so only one float64 slot table is live) -> their
        diagonals / PRESCALE as device int32 coefficients [P, B, G, N]:
        the canonical embedding in float64 on the device (`torch.fft`), the
        host encoder's arithmetic; a coefficient within ~1e-9 of a half may
        round the other way."""
        ctx, n, dev = self.ctx, self.ctx.n, self.device
        zinv = torch.as_tensor(ctx.encoder._zeta_pow_inv, device=dev)
        out = []
        for m in mats:
            w = torch.as_tensor(m, device=dev).to(torch.complex128)
            z = diagonal_slots(w / PRESCALE, ctx.slots)        # [B, G, slots]
            vals = torch.zeros(z.shape[:-1] + (n,), dtype=torch.complex128,
                               device=dev)
            vals[..., self._t_slot] = z
            vals[..., self._t_conj] = torch.conj(z)
            del z
            b = torch.fft.fft(vals, dim=-1) / n
            del vals
            coeffs = torch.round((b * zinv).real * float(ctx.scale))
            out.append(coeffs.to(torch.int32))
        return torch.stack(out)

    # -- device-side crypto helpers -----------------------------------------

    def _encode_dev(self, z: torch.Tensor) -> torch.Tensor:
        """complex64 slot rows [..., slots] -> int32 coefficients [..., N]
        at ctx.scale (canonical embedding, device FFT)."""
        n = self.ctx.n
        with span("client.encode"):
            vals = torch.zeros(z.shape[:-1] + (n,), dtype=torch.complex64,
                               device=self.device)
            vals[..., self._t_slot] = z
            vals[..., self._t_conj] = torch.conj(z)
            b = torch.fft.fft(vals, dim=-1) / n
            coeffs = (b * self._zeta_inv).real * np.float32(self.ctx.scale)
            return torch.round(coeffs).to(torch.int32)

    def _decode_dev(self, coeffs_f32: torch.Tensor) -> torch.Tensor:
        """float32 coefficient rows [..., N] (already divided by the output
        scale) -> complex64 slots."""
        n = self.ctx.n
        vals = torch.fft.ifft(coeffs_f32.to(torch.complex64) * self._zeta,
                              dim=-1) * n
        return vals[..., self._t_slot]

    def _encrypt_dev(self, m_i32: torch.Tensor, gen: torch.Generator
                     ) -> torch.Tensor:
        """int32 coefficients [..., N] -> ciphertexts [..., 2, l, N]."""
        with span("client.encrypt"):
            return encrypt_on_device(self.ctx, m_i32, gen, self.level)

    def _decrypt_dev(self, out_ct: torch.Tensor) -> torch.Tensor:
        """[..., 2, l-1, N] -> complex64 message slot rows [..., slots]
        (single-limb decryption; |value| < q0 / (2 * out_scale) by
        PRESCALE)."""
        ctx = self.ctx
        ntt = ctx.ntt
        p1, pinv1 = ntt.p[:1], ntt.pinv[:1]
        with span("client.decrypt"):
            v = add_mod(out_ct[..., 0, :1, :],
                        mont_mul(out_ct[..., 1, :1, :], ctx.s_eval[:1], p1,
                                 pinv1), p1)
            t = ntt.intt_from_mont(v, (0,))[..., 0, :]
            centered = torch.where(t > self._q0 // 2, t - self._q0, t)
            if self._peak is not None:
                torch.maximum(self._peak, centered.abs().amax(),
                              out=self._peak)
            coeffs = centered.to(torch.float32) / np.float32(self._out_scale)
            return self._decode_dev(coeffs)

    def headroom(self) -> float | None:
        """The largest decrypted coefficient since construction over q0 / 2
        (single-limb decryption wraps at 1), or None without
        `track_headroom`.  Synchronises."""
        if self._peak is None:
            return None
        return float(self._peak) / (self._q0 // 2)

    # -- the projections ------------------------------------------------------

    def _tile(self, x: torch.Tensor) -> torch.Tensor:
        reps = self.ctx.slots // x.shape[-1]
        return x.repeat((1,) * (x.dim() - 1) + (reps,))

    def _server_kern(self, name, j):
        """kern(cs) of projection `name` at row j of its stack: the
        server's BSGS kernel on one stream's ciphertexts cs [b, 2, l, N]
        ("shared": one input against every matrix of the row; otherwise
        the row's matrices pair with the b inputs)."""
        pt = self.pt[name][j]
        if name in self._shared:          # one input against the stack
            return lambda cs: self._kern_s(cs[0], pt)
        return lambda cs: self._kern_b(cs, pt)

    def _project(self, name, j, slots_rows, gen):
        """Encrypt slot rows [S, b, slots] of S streams, run projection
        `name` of row j on every stream (one CUDA graph replay for all S
        where `ops.graphed` engages), decrypt -> [S, b', slots]."""
        c = self._encrypt_dev(self._encode_dev(slots_rows), gen)
        out = self._graphs(name, j, self._server_kern(name, j), c)
        return self._decrypt_dev(out) * np.float32(PRESCALE)
