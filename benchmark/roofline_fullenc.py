"""The least time of one step of a fully-encrypted FFN chain, from the
configuration's shapes alone (the peaks are `benchmark/roofline.py`'s).

A step runs S requests through every block; a block consumed at level l
(width w limbs a stage) runs:
  * the key projection D -> F: ceil(F/D) BSGS matvecs on one input at
    level l;
  * the ciphertext square, relinearised at level l - w;
  * the value projection F -> D: ceil(F/D) BSGS matvecs at level l - 2w.
Bytes: every block's staged diagonals read once as 32-bit coefficients
(D diagonals of N coefficients a D x D matrix, two planes at width 2),
and the key rows that each matvec and each relinearisation selects, read
once each: a key at level m holds 2 polynomials x ceil(m / gsize) digits
x (m + K) rows x N 32-bit words, a matvec needs G - 1 + B - 1 of them
(`roofline.bsgs_steps`), a relinearisation one.  Operations: the
diagonal x ciphertext modular multiply-adds, one 32-bit operation each (2
polynomials x m limbs x N a diagonal a request).  The bound depends on
the configuration's shapes and S only, not on how the program runs the
step.
"""

from __future__ import annotations

from .roofline import HBM_BYTES_PER_S, INT32_OPS_PER_S, bsgs_steps

__all__ = ["fullenc_step_bound"]


def fullenc_step_bound(cfg: dict, streams: int) -> dict:
    """Least seconds of one chain step: {"s", "by", "bytes", "ops"}."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    ck = cfg["ckks"]
    n, limbs, special = ck["n"], ck["num_limbs"], ck["num_special"]
    width = ck.get("width", 1)
    gsize = -(-limbs // ck["dnum"]) if ck.get("dnum") else 1
    chunks = -(-f // d)
    g, b = bsgs_steps(d)

    def key_bytes(m):
        return 2 * -(-m // gsize) * (m + special) * n * 4

    diag_bytes = key_total = ops = 0
    for lv in ck["levels"]:
        diag_bytes += 2 * chunks * d * n * 4 * width
        for m in (lv, lv - 2 * width):           # key, value projection
            key_total += (g - 1 + b - 1) * key_bytes(m)
            ops += streams * chunks * d * 2 * m * n
        key_total += key_bytes(lv - width)        # relinearisation
    t_bytes = (diag_bytes + key_total) / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return {"s": max(t_bytes, t_ops),
            "by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": diag_bytes + key_total, "ops": ops}
