"""Wrapper of the hand-written CUDA kernel of the BSGS baby-step
contraction (csrc/bsgs.cu).

`bsgs_contract` replaces no Pallas kernel: the JAX package's contraction
is XLA-fused jnp (`fhe_spear_tpu/ops/bsgs.py:339-360`).  Its plain version
is the torch tree of `BsgsMatvec.contract`, which takes a CPU tensor;
`contract` launches this kernel for a CUDA tensor.  The kernel is bound by
bytes and reads each diagonal word and each baby word once a launch
(csrc/bsgs.cu's top comment has the design).

The source is built and loaded like `core/ntt_cuda.py`'s (nvcc for sm_90a
into `build/`, keyed on a hash of the source, plain C interface through
ctypes), by the same helper.  Nothing is imported or built when this module
is imported.

I/O: babies [G, 2, l, N] and diagonals [..., G, l, N], int64 canonical
residues in the Montgomery domain on one CUDA device, contiguous and
16-byte aligned; p and pinv the [l, 1] (or [l]) int64 limb tables of
`CkksContext._p(l)`; N a power of two.  The output is a new int64 tensor
[..., 2, l, N].  There is no fallback: a tensor the kernel does not take
raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..core.ntt_cuda import CudaLibrary, KernelStats

__all__ = ["BSGS_CONTRACT", "bsgs_contract", "build", "reset_counts",
           "split", "SOURCE", "LIBRARY", "MAX_C"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "bsgs.cu"
MAX_C = 8                  # giant groups a launch (the kernel's template)
MAX_SPLIT = 8              # warps of a CTA that may split the b loop
WARPS_PER_SM = 16          # warps a launch should give each SM at least

# launches, by (C, l, N)
BSGS_CONTRACT = KernelStats("bsgs_contract")


def reset_counts() -> None:
    BSGS_CONTRACT.reset()


def _bind(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fhe_bsgs_contract.restype = ci
    lib.fhe_bsgs_contract.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci,
                                      ci, vp]


LIBRARY = CudaLibrary(SOURCE, "fhe_bsgs", _bind)


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the contraction library."""
    return LIBRARY.build()


def split(G: int, l: int, n: int, sms: int) -> int:
    """Warps S of a CTA that split the b loop of one launch: the least power
    of two (at most 8 and at most G) for which the launch's warps, one per
    32 position pairs times S, give each of the card's `sms` SMs
    WARPS_PER_SM warps.  l = 3, N = 8192 on 132 SMs: 384 warps, S = 8;
    l = 11: S = 2; l = 46, N = 16384: S = 1."""
    warps = -(-(l * n // 2) // 32)
    s = 1
    while 2 * s <= min(MAX_SPLIT, G) and warps * s < WARPS_PER_SM * sms:
        s *= 2
    return s


def _check(babies, pt, p, pinv):
    """(G, l, N, C) of a call, after checking dtype, shape, contiguity,
    alignment and device; raises on anything the kernel does not take."""
    name = BSGS_CONTRACT.name
    for arg, t in (("babies", babies), ("pt", pt), ("p", p),
                   ("pinv", pinv)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {arg} must be a tensor")
        if t.dtype != torch.int64:
            raise TypeError(f"{name}: {arg} must be int64, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if babies.dim() != 4 or babies.shape[1] != 2 or babies.shape[0] < 1:
        raise ValueError(f"{name}: babies must be [G, 2, l, N], got "
                         f"{tuple(babies.shape)}")
    G, _, l, n = babies.shape
    if pt.dim() < 3 or tuple(pt.shape[-3:]) != (G, l, n):
        raise ValueError(f"{name}: pt must be [..., {G}, {l}, {n}], got "
                         f"{tuple(pt.shape)}")
    if p.numel() != l or pinv.numel() != l:
        raise ValueError(f"{name}: p and pinv must hold {l} limbs")
    if n < 2 or n & (n - 1):
        raise ValueError(f"{name}: N={n} must be a power of two >= 2")
    dev = babies.device
    if not babies.is_cuda or any(t.device != dev for t in (pt, p, pinv)):
        raise ValueError(f"{name}: every tensor must lie on one CUDA device")
    if babies.data_ptr() % 16 or pt.data_ptr() % 16:
        raise ValueError(f"{name}: babies and pt must start on a 16-byte "
                         "boundary (the kernel moves 16-byte pairs)")
    return G, l, n, pt.numel() // (G * l * n)


def bsgs_contract(babies: torch.Tensor, pt: torch.Tensor, p: torch.Tensor,
                  pinv: torch.Tensor) -> torch.Tensor:
    """out[..., k, r, n] = (sum_b mont(babies[b, k, r, n] * pt[..., b, r,
    n])) mod p_r: [G, 2, l, N] x [..., G, l, N] -> [..., 2, l, N], bitwise
    equal to `BsgsMatvec.contract`'s torch tree.  One launch per MAX_C
    giant groups, on the current stream (so a CUDA graph captures it)."""
    G, l, n, C = _check(babies, pt, p, pinv)
    lead = tuple(pt.shape[:-3])
    out = torch.empty((C, 2, l, n), dtype=torch.int64, device=babies.device)
    if C:
        lib = build()
        sms = torch.cuda.get_device_properties(
            babies.device).multi_processor_count
        S = split(G, l, n, sms)
        ptc = pt.view(C, G, l, n)
        stream = torch.cuda.current_stream(babies.device).cuda_stream
        logn = n.bit_length() - 1
        for c0 in range(0, C, MAX_C):
            c = min(MAX_C, C - c0)
            rc = lib.fhe_bsgs_contract(
                babies.data_ptr(), ptc[c0].data_ptr(), p.data_ptr(),
                pinv.data_ptr(), out[c0].data_ptr(), c, G, l, logn, S,
                stream)
            if rc != 0:
                raise RuntimeError(f"{BSGS_CONTRACT.name}: kernel launch "
                                   f"failed, cudaGetLastError() = {rc}")
            BSGS_CONTRACT.count(c, l, n)
    return out.view(lead + (2, l, n))
