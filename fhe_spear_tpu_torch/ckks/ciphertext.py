"""Ciphertext / Plaintext containers.

Counterpart of `fhe_spear_tpu/ckks/ciphertext.py`.  A ciphertext is a pair
(c0, c1) of ring elements stored as one int64 tensor of shape [..., 2, l, N]:
evaluation (NTT) domain, Montgomery form, one row per active RNS limb,
canonical residues in [0, p).  `l` is the chain index: rescale and
mod-switch drop the trailing limb row.  The scale is tracked exactly as a
float64.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["Ciphertext", "Plaintext"]


@dataclass
class Ciphertext:
    c: torch.Tensor      # [..., 2, l, N] int64, NTT domain, Montgomery form
    scale: float

    @property
    def level(self) -> int:
        """Number of active RNS limbs (the chain index)."""
        return self.c.shape[-2]


@dataclass
class Plaintext:
    p: torch.Tensor      # [..., l, N] int64, NTT domain, Montgomery form
    scale: float

    @property
    def level(self) -> int:
        return self.p.shape[-2]
