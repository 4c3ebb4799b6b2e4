"""Carry weights and keys across from the JAX package.

`model_from_reference(model)` turns an `fhe_spear_tpu.models.rwkv7.RwkvModel`
(any object with the same numpy fields) into the port's model, and
`context_from_secret(params, sk_coeff, seed)` builds a port context on a
given secret key.  With these, both packages compute the same thing.  This
module reads the reference's objects by their fields only: it imports
nothing of the reference.
"""

from __future__ import annotations

import numpy as np

from .ckks.context import CkksContext, CkksParams
from .models.rwkv7 import _BLOCK_FIELDS, RwkvBlockWeights, RwkvModel

__all__ = ["model_from_reference", "context_from_secret"]

_MODEL_FIELDS = ("emb", "head_w", "ln_out_w", "ln_out_b", "ln0_w", "ln0_b")


def model_from_reference(model) -> RwkvModel:
    """A port RwkvModel holding copies of `model`'s float64 numpy fields."""
    arr = lambda x: np.array(x, dtype=np.float64)
    blocks = [RwkvBlockWeights(
        block_idx=int(b.block_idx), d=int(b.d), f=int(b.f),
        n_head=int(b.n_head), head_size=int(b.head_size),
        **{name: arr(getattr(b, name)) for name in _BLOCK_FIELDS})
        for b in model.blocks]
    return RwkvModel(blocks=blocks,
                     **{name: arr(getattr(model, name))
                        for name in _MODEL_FIELDS})


def context_from_secret(params: CkksParams, sk_coeff: np.ndarray,
                        seed: int | None, device="cuda") -> CkksContext:
    """A port context on secret key `sk_coeff` (centered ternary [n]);
    relin and Galois keys are drawn from `RandomState(seed)` exactly as
    the reference's `CkksContext(params, seed=seed, sk_coeff=sk_coeff)`
    draws them, so the two hold the same keys bit for bit."""
    return CkksContext(params, seed=seed,
                       sk_coeff=np.asarray(sk_coeff, dtype=np.int64),
                       device=device)
