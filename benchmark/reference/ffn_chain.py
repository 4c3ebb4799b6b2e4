"""Plain fully-encrypted FFN chain in PyTorch: the yardstick the benchmark
holds the encrypted chain's outputs against.

The reference paper's fully-encrypted FFN block, one after another over
the configuration's blocks:

    x <- x + (x W_key)^2 W_val

on weights scaled by a magnitude calibration worked out from one
calibration input x_cal, block by block (a copy of the arithmetic, taken
anew from the raw weights):

    fk = x_cal W_key;  a = 1 / max|fk|;  fv = fk^2 W_val;  m = 1 / max|fv|
    W_key <- a W_key;  W_val <- (m / a^2) W_val;  x_cal <- x_cal + m fv

so that every intermediate stays near unit magnitude.  The calibration
always runs in float64; it is part of the model, like the weights.

It imports torch and numpy only: nothing of the program or of any other
package of this repository.  Weights come in as the plain dict that
`benchmark/ffn_weights.py` makes (numpy float64, W_key [D, F], W_val
[F, D]).

`precision` selects the arithmetic of the chain:
  * "float64": the reference (TF32 is never used for float64).
  * "float32", "float16", "bfloat16": the calibrated weights and the
    inputs rounded to that type, and every operation of the chain in it
    (matrix products as the device computes that type, TF32 off).
The lower ones are the controls: the reference put in the program's
place a precision step below it.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["PRECISIONS", "calibrate", "chain", "reference_outputs"]

PRECISIONS = ("float64", "float32", "float16", "bfloat16")

_DTYPE = {"float64": torch.float64, "float32": torch.float32,
          "float16": torch.float16, "bfloat16": torch.bfloat16}


def calibrate(w_keys, w_vals, x_cal, target: float = 1.0) -> tuple:
    """The calibrated weights (lists of float64 tensors on x_cal's
    device) from the raw ones."""
    x = x_cal.to(torch.float64).clone()
    ks, vs = [], []
    for wk, wv in zip(w_keys, w_vals):
        fk = x @ wk
        a = target / (fk.abs().max() + 1e-12)
        fv = fk ** 2 @ wv
        m = target / (fv.abs().max() + 1e-12)
        ks.append(wk * a)
        vs.append(wv * (m / (a * a)))
        x = x + fv * m
    return ks, vs


def chain(x, w_keys, w_vals):
    """The blocks on x [T, D] in x's type, on the weights as given."""
    for wk, wv in zip(w_keys, w_vals):
        x = x + (x @ wk) ** 2 @ wv
    return x


@torch.no_grad()
def reference_outputs(weights: dict, xs, device,
                      precision: str = "float64") -> torch.Tensor:
    """The chain's outputs for inputs xs [T, D] (numpy or tensor), as a
    float64 tensor [T, D] on device."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        dev = torch.device(device)
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                      device=dev)
        ks, vs = calibrate([t(w) for w in weights["w_key"]],
                           [t(w) for w in weights["w_val"]],
                           t(weights["x_cal"]))
        dt = _DTYPE[precision]
        y = chain(t(xs).to(dt), [k.to(dt) for k in ks],
                  [v.to(dt) for v in vs])
        return y.to(torch.float64)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
