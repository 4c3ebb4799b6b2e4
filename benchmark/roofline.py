"""The table of peaks and the least times that the roofline metrics divide
by, computed from shapes alone.

Peaks: one NVIDIA H100 SXM (data sheet, 700 W): 3.35 TB/s of HBM, 67 T
32-bit integer operations a second outside the tensor cores.

K1/K2 (the program's forward and inverse negacyclic NTT kernels) at a
launch of [B, R, N]: x read once and y written once at 8 bytes a word
(int64 residues), the per-limb twist and twiddle tables read once at 4
bytes a word, against (N/2) log2 N butterflies of 12 32-bit operations
(mont_mul 8, add_mod 2, sub_mod 2) plus N twist products of 8 per
polynomial; the larger of the two times.  At every shape of the decode
path the bytes bound it.

A decode step (S streams through every block, 4 encrypted round trips a
block, 8 plaintext-matrix x ciphertext products a block a stream at
F = 4D): bytes are each block's diagonal plaintexts read once as 32-bit
coefficients (D diagonals of N coefficients a D x D matrix) and each
distinct rotation key read once as 32-bit words (2 polynomials x digits x
(level + special) rows x N); operations are the diagonal x ciphertext
modular multiply-adds, one 32-bit operation each (2 polynomials x level
limbs x N a diagonal a stream).  It depends on the configuration's shapes
and S only, not on how the program runs the step.
"""

from __future__ import annotations

import math

from .weights import dims

__all__ = ["HBM_BYTES_PER_S", "INT32_OPS_PER_S", "ntt_bytes", "ntt_bound_s",
           "bsgs_steps", "step_bound"]

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12


def ntt_bytes(B: int, R: int, n: int) -> int:
    """Bytes one K1/K2 transform of [B, R, n] must move."""
    return 2 * 8 * B * R * n + 4 * R * (2 * n - 1 + 2)


def ntt_bound_s(B: int, R: int, n: int) -> tuple:
    """(least seconds, "bytes" or "operations") of one K1/K2 launch."""
    logn = n.bit_length() - 1
    ops = B * R * (12 * (n // 2) * logn + 8 * n)
    t_bytes = ntt_bytes(B, R, n) / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def bsgs_steps(d: int) -> tuple:
    """(G, B): G = ceil(sqrt(D)) baby steps, B = ceil(D / G) giant groups;
    a matvec needs G - 1 + B - 1 distinct rotation keys."""
    g = math.isqrt(d)
    if g * g < d:
        g += 1
    return g, -(-d // g)


def step_bound(cfg: dict, streams: int) -> dict:
    """Least seconds of one decode step: {"s", "by", "bytes", "ops"}."""
    m = dims(cfg)
    d, f, n = m["d"], m["f"], cfg["ckks"]["n"]
    level = cfg["ckks"]["level"]
    special = cfg["ckks"]["num_special"]
    digits = level          # one digit a limb (no dnum grouping)
    chunks = -(-f // d)              # F/D chunks of the FFN
    pairs = -(-chunks // 2)          # packed two to a complex matrix
    mats = 4 + 2 * pairs             # r k v o, then FFN key and value
    diag_bytes = m["blocks"] * mats * d * n * 4
    g, b = bsgs_steps(d)
    key_bytes = (g - 1 + b - 1) * 2 * digits * (level + special) * n * 4
    ops = streams * m["blocks"] * mats * d * 2 * level * n
    t_bytes = (diag_bytes + key_bytes) / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return {"s": max(t_bytes, t_ops),
            "by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": diag_bytes + key_bytes, "ops": ops}
