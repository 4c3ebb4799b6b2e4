"""The least time of one LFM2-MoE decode step, from the configuration's
shapes alone (the peaks are `benchmark/roofline.py`'s).

A step runs S streams through every layer; each of the layer's server
projections is a D x D (complex-packed) BSGS matvec at the
configuration's level (`lfm2_matrices`):
  * conv mixer: 2 in (B + iC, x) + 1 out; attention: 1 (q + i[k; v]) + 1
    out;
  * a SwiGLU of width F: ceil(F/D) up (W1 + iW3 a chunk) + ceil(that/2)
    down (conjugate pairs); an MoE layer runs one for every held expert,
    its chunks and pairs counted over all of them.
Bytes: every matrix's diagonal plaintexts read once as 32-bit
coefficients (D diagonals of N coefficients) and each distinct rotation
key read once as 32-bit words (2 polynomials x digits x (level + special)
rows x N, G - 1 + B - 1 keys); operations: the diagonal x ciphertext
modular multiply-adds, one 32-bit operation each (2 polynomials x level
limbs x N a diagonal a stream).  As `roofline.step_bound` counts them;
it depends on the shapes and S only, not on how the program runs.
"""

from __future__ import annotations

from .roofline import HBM_BYTES_PER_S, INT32_OPS_PER_S, bsgs_steps
from .weights_lfm2 import lfm2_dims

__all__ = ["lfm2_matrices", "lfm2_step_bound"]


def lfm2_matrices(cfg: dict) -> dict:
    """{"mixer", "ffn", "expert"}: the D x D matrices a token's step
    evaluates, by part (expert: the MoE layers' share of ffn)."""
    m = lfm2_dims(cfg)
    d = m["d"]

    def swiglu(width, times):
        up = times * -(-width // d)
        return up + -(-up // 2)

    mixer = sum(3 if k == "conv" else 2 for k in m["kinds"])
    n_moe = m["layers"] - m["dense"]
    expert = n_moe * swiglu(m["fe"], len(m["experts"]))
    dense = m["dense"] * swiglu(m["f"], 1)
    return {"mixer": mixer, "ffn": dense + expert, "expert": expert}


def lfm2_step_bound(cfg: dict, streams: int) -> dict:
    """Least seconds of one decode step: {"s", "by", "bytes", "ops",
    "matrices"}."""
    m = lfm2_dims(cfg)
    d, n = m["d"], cfg["ckks"]["n"]
    level = cfg["ckks"]["level"]
    special = cfg["ckks"]["num_special"]
    mats = lfm2_matrices(cfg)
    count = mats["mixer"] + mats["ffn"]
    diag_bytes = count * d * n * 4
    g, b = bsgs_steps(d)
    key_bytes = (g - 1 + b - 1) * 2 * level * (level + special) * n * 4
    ops = streams * count * d * 2 * level * n
    t_bytes = (diag_bytes + key_bytes) / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return {"s": max(t_bytes, t_ops),
            "by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": diag_bytes + key_bytes, "ops": ops, "matrices": count}
