"""Seeded random weights of a fully-encrypted FFN chain at a
configuration's widths, made on the device in one large draw and handed
to both sides as one plain dict.

Per block W_key [D, F] and W_val [F, D], normal at 1/sqrt(in) (the
chain's own benchmark draws them so), and one calibration input x_cal,
uniform on [-1, 1]^D, from which each side works out the blocks'
magnitude calibration.  Every array is float64, the type the program's
host encoder serves them in.
"""

from __future__ import annotations

import math

import torch

from .weights import derive_seed

__all__ = ["make_ffn_weights"]


def make_ffn_weights(cfg: dict, seed: int, device) -> dict:
    """{"w_key": [D x F per block], "w_val": [F x D per block], "x_cal":
    [D]}, numpy float64, from seed."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    blocks = cfg["num_hidden_layers"]
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, 4))
    z = torch.randn(blocks, 2, d * f, generator=gen, dtype=torch.float64,
                    device=device)
    z[:, 0].mul_(1.0 / math.sqrt(d))
    z[:, 1].mul_(1.0 / math.sqrt(f))
    x_cal = torch.rand(d, generator=gen, dtype=torch.float64,
                       device=device).mul_(2.0).sub_(1.0)
    flat = z.cpu().numpy()
    del z
    return {"w_key": [flat[b, 0].reshape(d, f) for b in range(blocks)],
            "w_val": [flat[b, 1].reshape(f, d) for b in range(blocks)],
            "x_cal": x_cal.cpu().numpy()}
