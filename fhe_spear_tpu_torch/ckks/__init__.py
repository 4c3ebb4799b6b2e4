"""CKKS on torch tensors: contexts, ciphertext ops, rotations, keyswitching
(counterpart of `fhe_spear_tpu/ckks`)."""

from .ciphertext import Ciphertext, Plaintext
from .context import CkksContext, CkksParams, KeySwitchKey

__all__ = ["Ciphertext", "Plaintext", "CkksContext", "CkksParams", "KeySwitchKey"]
