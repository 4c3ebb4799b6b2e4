"""Plain RWKV-7 ("Goose") decoding forward in PyTorch: the yardstick the
benchmark holds the encrypted program's logits against.

A frozen copy of the layer equations of BlinkDL/RWKV-LM `RWKV-v7`, one
token at a time over S streams with the recurrent state carried between
steps.  Per block:

    x_ln = LN1(x);  mix_n = x_ln + (x_prev_att - x_ln) * x_n   (n = r k v g w a)
    r, k, v = mix_r W_r, mix_k W_k, mix_v W_v
    decay = exp(-e^-0.5 * sigmoid(w0 + tanh(mix_w w1) w2))
            (RWKV-v7's exp(-exp(-softplus(-z) - 0.5)), the same number)
    a = sigmoid(a0 + (mix_a a1) a2);  kk = normalize(k * k_k) per head
    k = k * (1 + (a - 1) * k_a)
    v = v_first (block 0 sets it) or v + (v_first - v) * sigmoid(v0 + (mix_v v1) v2)
    S = S diag(decay) + (S (-kk)) (kk a)^T + v k^T;  o = GroupNorm(S r)
    o = o + sum(r * k * r_k) v;  x = x + (o * (sigmoid(mix_g g1) g2)) W_o
    x_f = LN2(x);  x = x + relu((x_f + (x_prev_ffn - x_f) * x_k_ffn) W_key)^2 W_val
and the head is LN_out(x) @ head_w after LN0 on the embedding.

It imports torch and numpy only: nothing of the program or of any other
package of this repository.  Weights come in as the plain dict that
`benchmark/weights.py` makes (numpy float64, projections [in, out]).

`precision` selects the arithmetic:
  * "float64": the reference (TF32 is never used for float64).
  * "tf32": float32 elementwise, and every product's inputs rounded to
    TF32's 10-bit mantissa (round to nearest even) before a float32
    product with TF32 off: what a float32 program with TF32 turned on
    computes, on any device.
  * "bfloat16": every tensor and every operation in bfloat16.
The last two are the controls: the reference put in the program's place a
precision step below it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["PRECISIONS", "ReferenceModel", "reference_logits"]

PRECISIONS = ("float64", "tf32", "bfloat16")

_DTYPE = {"float64": torch.float64, "tf32": torch.float32,
          "bfloat16": torch.bfloat16}

_BLOCK_KEYS = ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "ln_x_w", "ln_x_b",
               "x_r", "x_k", "x_v", "x_g", "x_w", "x_a", "x_k_ffn",
               "w0", "w1", "w2", "a0", "a1", "a2", "v0", "v1", "v2",
               "g1", "g2", "k_k", "k_a", "r_k",
               "W_r", "W_k", "W_v", "W_o", "W_key_ffn", "W_val_ffn")


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest float32 with a 10-bit mantissa (ties to
    even), as the tensor cores read TF32 inputs."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


class ReferenceModel:
    """The weights on one device in one precision; `step` advances S
    streams by one token."""

    def __init__(self, weights: dict, device, precision: str = "float64"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.precision = precision
        self.dtype = _DTYPE[precision]
        self.device = torch.device(device)
        t = lambda a: torch.as_tensor(np.asarray(a), device=self.device
                                      ).to(self.dtype)
        self.emb = torch.as_tensor(np.asarray(weights["emb"]),
                                   device=self.device)     # rows cast on use
        self.head_w = t(weights["head_w"])
        self.ln_out = (t(weights["ln_out_w"]), t(weights["ln_out_b"]))
        self.ln0 = (t(weights["ln0_w"]), t(weights["ln0_b"]))
        self.blocks = [{k: t(b[k]) for k in _BLOCK_KEYS}
                       for b in weights["blocks"]]
        self.head_size = int(weights["head_size"])
        self.d = self.head_w.shape[0]
        self.n_head = self.d // self.head_size

    # -- arithmetic of the chosen precision ----------------------------------

    def _mm(self, a, b):
        if self.precision == "tf32":
            return _round_tf32(a) @ _round_tf32(b)
        return a @ b

    def _ein(self, eq, a, b):
        if self.precision == "tf32":
            a, b = _round_tf32(a), _round_tf32(b)
        return torch.einsum(eq, a, b)

    @staticmethod
    def _ln(x, w, b, eps=1e-5):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + eps) * w + b

    # -- the forward ----------------------------------------------------------

    def zero_state(self, streams: int):
        nb, h, hs, d = len(self.blocks), self.n_head, self.head_size, self.d
        z = lambda *s: torch.zeros(s, dtype=self.dtype, device=self.device)
        return {"x_att": [z(streams, d) for _ in range(nb)],
                "x_ffn": [z(streams, d) for _ in range(nb)],
                "wkv": [z(streams, h, hs, hs) for _ in range(nb)]}

    def _block(self, i, x, v_first, state):
        w = self.blocks[i]
        S, h, hs = x.shape[0], self.n_head, self.head_size
        sig = torch.sigmoid
        x_ln = self._ln(x, w["ln1_w"], w["ln1_b"])
        xx = state["x_att"][i] - x_ln
        mix = {n: x_ln + xx * w["x_" + n] for n in "rkvgwa"}
        r = self._mm(mix["r"], w["W_r"])
        k = self._mm(mix["k"], w["W_k"])
        v = self._mm(mix["v"], w["W_v"])

        w_vec = sig(w["w0"] + self._mm(torch.tanh(self._mm(mix["w"], w["w1"])),
                                       w["w2"]))
        decay = torch.exp(-math.exp(-0.5) * w_vec).reshape(S, h, hs)
        a_h = sig(w["a0"] + self._mm(self._mm(mix["a"], w["a1"]), w["a2"])
                  ).reshape(S, h, hs)
        kk = (k * w["k_k"]).reshape(S, h, hs)
        kk = kk / (torch.linalg.vector_norm(kk, dim=-1, keepdim=True) + 1e-12)
        k_h = k.reshape(S, h, hs) * (1.0 + (a_h - 1.0)
                                     * w["k_a"].reshape(h, hs))
        if i == 0:
            v_first = v
        else:
            v_gate = sig(w["v0"] + self._mm(self._mm(mix["v"], w["v1"]),
                                            w["v2"]))
            v = v + (v_first - v) * v_gate
        v_h = v.reshape(S, h, hs)
        r_h = r.reshape(S, h, hs)
        st = state["wkv"][i]
        sa = self._ein("shij,shj->shi", st, -kk)
        st = (st * decay[..., None, :]
              + sa[..., :, None] * (kk * a_h)[..., None, :]
              + v_h[..., :, None] * k_h[..., None, :])
        o = self._ein("shij,shj->shi", st, r_h)
        o = (o - o.mean(-1, keepdim=True)) / torch.sqrt(
            ((o - o.mean(-1, keepdim=True)) ** 2).mean(-1, keepdim=True)
            + 64e-5)
        o = o.reshape(S, h * hs) * w["ln_x_w"] + w["ln_x_b"]
        o = o + ((r_h * k_h * w["r_k"]).sum(-1, keepdim=True) * v_h
                 ).reshape(S, h * hs)
        g = self._mm(sig(self._mm(mix["g"], w["g1"])), w["g2"])
        x = x + self._mm(o * g, w["W_o"])

        x_f = self._ln(x, w["ln2_w"], w["ln2_b"])
        xk = x_f + (state["x_ffn"][i] - x_f) * w["x_k_ffn"]
        x = x + self._mm(torch.relu(self._mm(xk, w["W_key_ffn"])) ** 2,
                         w["W_val_ffn"])
        state["x_att"][i], state["x_ffn"][i], state["wkv"][i] = x_ln, x_f, st
        return x, v_first

    @torch.no_grad()
    def step(self, ids, state):
        """ids [S] -> logits [S, vocab] (this precision); state is updated
        in place."""
        idx = torch.as_tensor(np.asarray(ids), device=self.device)
        x = self._ln(self.emb[idx].to(self.dtype), *self.ln0)
        v_first = None
        for i in range(len(self.blocks)):
            x, v_first = self._block(i, x, v_first, state)
        return self._mm(self._ln(x, *self.ln_out), self.head_w)


def reference_logits(weights: dict, ids: np.ndarray, device,
                     precision: str = "float64", on_step=None):
    """Logits of every step of ids [T, S] from zero state, float64 numpy
    [T, S, vocab]; or, with on_step, on_step(t, logits) on each step's
    logits (a float64 device tensor [S, vocab]) and nothing kept."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = ReferenceModel(weights, device, precision)
        ids = np.asarray(ids)
        state = ref.zero_state(ids.shape[1])
        out = []
        for t in range(ids.shape[0]):
            lg = ref.step(ids[t], state).to(torch.float64)
            if on_step is not None:
                on_step(t, lg)
            else:
                out.append(lg.cpu().numpy())
        return None if on_step is not None else np.stack(out)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
