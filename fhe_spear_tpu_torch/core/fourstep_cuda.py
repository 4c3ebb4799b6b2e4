"""Wrappers of the hand-written CUDA four-step NTT kernels (csrc/fourstep.cu).

`fourstep_fwd` (K3) replaces `fhe_spear_tpu/core/fourstep_pallas.py`'s
three variants of one function: `ntt_fourstep_pallas` (K3a),
`_ntt_fourstep_pallas_2d` (K3b) and `_ntt_fourstep_pallas_2dio` (K3c).
`fourstep_inv` is the port's kernel for `FourStepNtt.intt_mxu_b`, which the
reference left to XLA.  Their plain versions are `FourStepNtt.ntt_mxu_b` /
`intt_mxu_b` (`parallel/ntt_fourstep.py`); `FourStepBackend.ntt` / `intt`
pick the kernel for a CUDA tensor and the plain version for a CPU tensor.

The kernels contract 8-bit limbs on the int8 tensor cores (`mma.sync`
u8 x u8 -> s32, 7 shift groups) with the DFT-matrix limb planes staged in
shared memory once per CTA; `csrc/fourstep.cu`'s top comment has the
design.  The limb planes are built here once per FourStepNtt, in the byte
layout the fragments load (`limb_image`).

The source is built and loaded like `core/ntt_cuda.py`'s (nvcc for sm_90a
into `build/`, keyed on a hash of the source, plain C interface through
ctypes), by the same helper.  Nothing is imported or built when this module
is imported.

I/O: x is an int64 tensor [..., R, N] on a CUDA device, contiguous, with
canonical residues in [0, p) (Montgomery form); limb r of the R axis lives
in prime domain rows[r].  The output is a new int64 tensor of the same
shape, in natural four-step bin order (k = k2*n1 + k1) for the forward
transform.  N = n1 * n2 with both powers of two, 8 <= n1, n2 <= 128 and
128 <= N <= 16384 (every split `FourStepBackend` picks).  There is no
fallback: a tensor the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .ntt_cuda import CudaLibrary, KernelStats, _rows

__all__ = ["FOURSTEP_FWD", "FOURSTEP_INV", "fourstep_fwd", "fourstep_inv",
           "build", "reset_counts", "plan", "limb_image", "SOURCE", "MIN_N",
           "MAX_N", "MIN_DIM", "MAX_DIM", "LIBRARY"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fourstep.cu"
MIN_N, MAX_N = 128, 16384
MIN_DIM, MAX_DIM = 8, 128          # n1 and n2

FOURSTEP_FWD = KernelStats("fourstep_fwd")
FOURSTEP_INV = KernelStats("fourstep_inv")


def reset_counts() -> None:
    FOURSTEP_FWD.reset()
    FOURSTEP_INV.reset()


def _bind(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.fhe_fourstep_fwd, lib.fhe_fourstep_inv):
        fn.restype = ci
        fn.argtypes = [vp, vp, vp, ci, ctypes.c_longlong, ci, ci,
                       vp, vp, vp, vp, vp, vp, vp, ci, vp]
    lib.fhe_fourstep_plan.restype = ci
    lib.fhe_fourstep_plan.argtypes = [ci, ci, ci, ci, ctypes.c_longlong, ci,
                                      ctypes.POINTER(ctypes.c_int)]


LIBRARY = CudaLibrary(SOURCE, "fhe_fourstep", _bind)


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the four-step library."""
    return LIBRARY.build()


def limb_image(w8: torch.Tensor) -> torch.Tensor:
    """8-bit limb planes [L, 4, M, K] -> the kernel's shared-memory image
    [L, 4, max(16, M), max(32, K) + 16] uint8: rows padded to one 16-row
    tile, K to one 32-byte k-step, plus 16 bytes a row so that the row
    stride is 16 times an odd number (no bank conflicts); padding is 0."""
    L, limbs, m, k = w8.shape
    out = torch.zeros((L, limbs, max(16, m), max(32, k) + 16),
                      dtype=torch.uint8, device=w8.device)
    out[:, :, :m, :k] = w8
    return out


def _share(fs) -> int:
    """1 when both DFT matrices of each direction are equal (n1 == n2), so
    the kernel keeps one copy of them in shared memory."""
    return int(fs.n1 == fs.n2 and torch.equal(fs.w1, fs.w2)
               and torch.equal(fs.w1i, fs.w2i))


def _tables(fs, device: torch.device) -> dict:
    """The kernels' tables of a FourStepNtt on the device (built once per
    FourStepNtt): uint32 words psi / psi_inv_n [L, N] and their folded
    forms psi_to_mont / psi_inv_n_from_mont (`NttContext.folded_tables`),
    tw [L, n1, n2], twi
    [L, n2, n1], p / pinv [L], d [L, 8] (2^(8s) mod p, s < 7); limb-plane
    images w1 / w2 / w1i / w2i
    (`limb_image`); share: the two DFT matrices are equal (n1 == n2)."""
    tb = fs.kernel_tables
    if tb is None or tb["device"] != device:
        def u32(t):
            return t.to(device=device, dtype=torch.int32).contiguous()

        def img(w8):
            return limb_image(w8.to(device)).contiguous()

        base = fs.base
        folded = base.folded_tables()
        # residues (< 2^31) keep their bits in int32; pinv may reach 2^32,
        # so it is stored as its two's-complement int32 word
        pinv = base.pinv[:, 0]
        tb = {"device": device,
              "psi": u32(base.psi), "psi_inv_n": u32(base.psi_inv_n),
              "psi_to_mont": u32(folded["psi_to_mont"]),
              "psi_inv_n_from_mont": u32(folded["psi_inv_n_from_mont"]),
              "w1": img(fs.w1_8), "w2": img(fs.w2_8), "tw": u32(fs.tw),
              "w1i": img(fs.w1i_8), "w2i": img(fs.w2i_8), "twi": u32(fs.twi),
              "p": u32(base.p[:, 0]), "pinv": u32(pinv - ((pinv >> 31) << 32)),
              "d": u32(torch.nn.functional.pad(fs.dsh, (0, 1))),
              "share": _share(fs),
              "rows": {}}
        fs.kernel_tables = tb
    return tb


def _check_split(name: str, fs) -> None:
    if not (MIN_DIM <= fs.n1 <= MAX_DIM and MIN_DIM <= fs.n2 <= MAX_DIM):
        raise ValueError(f"{name}: split n1={fs.n1}, n2={fs.n2} unsupported "
                         f"(kernel takes {MIN_DIM} <= n1, n2 <= {MAX_DIM})")


def plan(fs, shape, forward: bool = True) -> dict:
    """The launch plan of a transform of x [..., R, N] on the current card:
    shared memory per CTA (bytes), CTAs, polynomials per CTA (at most) and
    CTAs per SM.  Builds the library."""
    _check_split("plan", fs)
    R, n = shape[-2:]
    B = 1
    for d in shape[:-2]:
        B *= d
    out = (ctypes.c_int * 4)()
    rc = build().fhe_fourstep_plan(int(forward), fs.n1, fs.n2, R, B,
                                   _share(fs), out)
    if rc != 0:
        raise RuntimeError(f"fourstep plan failed: {rc}")
    return {"smem_bytes": out[0], "ctas": out[1], "polys_per_cta": out[2],
            "ctas_per_sm": out[3]}


def _launch(stats: KernelStats, fn_name: str, names: tuple, fs, x, rows):
    if not isinstance(x, torch.Tensor) or not x.is_cuda:
        raise ValueError(f"{stats.name}: x must be a CUDA tensor")
    if x.dtype != torch.int64:
        raise TypeError(f"{stats.name}: x must be int64, got {x.dtype}")
    if x.dim() < 2 or not x.is_contiguous():
        raise ValueError(f"{stats.name}: x must be a contiguous [..., R, N] "
                         "tensor")
    R, n = x.shape[-2:]
    if n != fs.base.n or not MIN_N <= n <= MAX_N:
        raise ValueError(f"{stats.name}: N={n} unsupported (transform N="
                         f"{fs.base.n}, kernel takes {MIN_N} <= N <= {MAX_N})")
    _check_split(stats.name, fs)
    lib = build()
    tb = _tables(fs, x.device)
    rows_t = _rows(tb, rows, R, len(fs.base.primes))
    B = x.numel() // (R * n)
    y = torch.empty_like(x)
    if B == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = getattr(lib, fn_name)(
        x.data_ptr(), y.data_ptr(), rows_t.data_ptr(), R, B, fs.n1, fs.n2,
        *(tb[k].data_ptr() for k in names), tb["p"].data_ptr(),
        tb["pinv"].data_ptr(), tb["d"].data_ptr(), tb["share"], stream)
    if rc != 0:
        raise RuntimeError(f"{stats.name}: kernel launch failed, "
                           f"cudaGetLastError() = {rc}")
    stats.count(B, R, n)
    return y


def fourstep_fwd(fs, x: torch.Tensor, rows=None, to_mont: bool = False
                 ) -> torch.Tensor:
    """Kernel K3: forward four-step NTT of x [..., R, N] in natural bin
    order, bitwise equal to fs.ntt_mxu_b (fs: a FourStepNtt); with to_mont
    (twist table psi^j * R^2), equal to its to_mont."""
    twist = "psi_to_mont" if to_mont else "psi"
    return _launch(FOURSTEP_FWD, "fhe_fourstep_fwd", (twist, "w1", "tw", "w2"),
                   fs, x, rows)


def fourstep_inv(fs, x: torch.Tensor, rows=None, from_mont: bool = False
                 ) -> torch.Tensor:
    """Inverse four-step NTT, bitwise equal to fs.intt_mxu_b; with
    from_mont (untwist table psi^-j * N^-1), equal to its from_mont."""
    untwist = "psi_inv_n_from_mont" if from_mont else "psi_inv_n"
    return _launch(FOURSTEP_INV, "fhe_fourstep_inv",
                   (untwist, "w2i", "twi", "w1i"), fs, x, rows)
