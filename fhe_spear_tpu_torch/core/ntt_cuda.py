"""Wrappers of the hand-written CUDA NTT kernels (csrc/ntt.cu).

K1 `ntt_fwd` replaces `fhe_spear_tpu/core/ntt_pallas.py::_fwd_call`, K2
`ntt_inv` replaces `_inv_call`.  Their plain versions are
`NttContext.ntt_plain` / `intt_plain`; `NttContext.ntt` / `intt` pick the
kernel for a CUDA tensor and the plain version for a CPU tensor.

The source is compiled with nvcc for sm_90a into a shared library with a
plain C interface at first use (into `build/` at the repository root,
keyed on a hash of the source) and loaded with ctypes.  Nothing is
imported or built when this module is imported.

I/O: x is an int64 tensor [..., R, N] on a CUDA device, contiguous, with
canonical residues in [0, p) (Montgomery form); the output is a new int64
tensor of the same shape.  N is a power of two, 2 <= N <= 8192.  There is
no fallback: a tensor the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

__all__ = ["NTT_FWD", "NTT_INV", "ntt_fwd", "ntt_inv", "build", "reset_counts",
           "SOURCE", "MAX_N", "CudaLibrary", "KernelStats", "LIBRARY"]

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "ntt.cu"
BUILD_DIR = _PKG.parent / "build"
MAX_N = 8192


class KernelStats:
    """Launch counter of one kernel: `launches` counts launches of the
    kernel itself, never runs of its plain version."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def reset(self) -> None:
        self.launches = 0


NTT_FWD = KernelStats("ntt_fwd")
NTT_INV = KernelStats("ntt_inv")


def reset_counts() -> None:
    NTT_FWD.reset()
    NTT_INV.reset()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


class CudaLibrary:
    """One `.cu` source with a plain C interface, compiled with nvcc for
    sm_90a into `build/lib<stem>-<source hash>.so` at first use and loaded
    with ctypes.  `bind(lib)` sets the argument types of its functions.
    `seconds` and `log` hold the build's time and nvcc's output."""

    def __init__(self, source: Path, stem: str, bind):
        self.source, self.stem, self.bind = source, stem, bind
        self.lib = None
        self.seconds = None
        self.log = ""
        self._lock = threading.Lock()

    def build(self) -> ctypes.CDLL:
        """Compile (once per source hash) and load the library."""
        with self._lock:
            if self.lib is not None:
                return self.lib
            t0 = time.perf_counter()
            tag = hashlib.sha256(self.source.read_bytes()).hexdigest()[:16]
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            so = BUILD_DIR / f"lib{self.stem}-{tag}.so"
            if not so.exists():
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                       "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                       "-Xptxas", "-v", "-o", tmp, str(self.source)]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                self.log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    os.unlink(tmp)
                    raise RuntimeError(f"nvcc failed on {self.source.name} "
                                       f"({proc.returncode}):\n{self.log}")
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            self.bind(lib)
            self.lib = lib
            self.seconds = time.perf_counter() - t0
            return lib


def _bind(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.fhe_ntt_fwd, lib.fhe_ntt_inv):
        fn.restype = ci
        fn.argtypes = [vp, vp, vp, ci, ctypes.c_longlong, ci,
                       vp, vp, vp, vp, vp]


LIBRARY = CudaLibrary(SOURCE, "fhe_ntt", _bind)


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the NTT kernel library."""
    return LIBRARY.build()


def _tables(ctx, device: torch.device) -> dict:
    """uint32 words of the context's tables on the device (built once per
    context): psi / psi_inv_n [L, N], fwd / inv twiddles concatenated over
    stages [L, N-1] (stage s at offset N - (N >> s)), p / pinv [L]."""
    tb = ctx.kernel_tables
    if tb is None or tb["device"] != device:
        def u32(t):
            return t.to(device=device, dtype=torch.int32).contiguous()

        cat = lambda stages: torch.cat([t[:, 0, :] for t in stages], dim=-1)
        # residues (< 2^31) keep their bits in int32; pinv may reach 2^32,
        # so it is stored as its two's-complement int32 word
        pinv = ctx.pinv[:, 0]
        tb = {"device": device,
              "psi": u32(ctx.psi), "psi_inv_n": u32(ctx.psi_inv_n),
              "fwd_tw": u32(cat(ctx.fwd_tw)), "inv_tw": u32(cat(ctx.inv_tw)),
              "p": u32(ctx.p[:, 0]), "pinv": u32(pinv - ((pinv >> 31) << 32)),
              "rows": {}}
        ctx.kernel_tables = tb
    return tb


def _rows(tb: dict, rows, R: int, L: int) -> torch.Tensor:
    key = tuple(range(R)) if rows is None else tuple(int(r) for r in rows)
    if len(key) != R or not all(0 <= r < L for r in key):
        raise ValueError(f"rows {rows} do not match R={R} limbs of {L}")
    if key not in tb["rows"]:
        tb["rows"][key] = torch.tensor(key, dtype=torch.int32,
                                       device=tb["device"])
    return tb["rows"][key]


def _launch(stats: KernelStats, fn_name: str, twist: str, twiddles: str,
            ctx, x, rows):
    if not isinstance(x, torch.Tensor) or not x.is_cuda:
        raise ValueError(f"{stats.name}: x must be a CUDA tensor")
    if x.dtype != torch.int64:
        raise TypeError(f"{stats.name}: x must be int64, got {x.dtype}")
    if x.dim() < 2 or not x.is_contiguous():
        raise ValueError(f"{stats.name}: x must be a contiguous [..., R, N] "
                         "tensor")
    R, n = x.shape[-2:]
    if n != ctx.n or n > MAX_N or n < 2:
        raise ValueError(f"{stats.name}: N={n} unsupported (context N="
                         f"{ctx.n}, kernel takes 2 <= N <= {MAX_N})")
    lib = build()
    tb = _tables(ctx, x.device)
    rows_t = _rows(tb, rows, R, len(ctx.primes))
    B = x.numel() // (R * n)
    y = torch.empty_like(x)
    if B == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = getattr(lib, fn_name)(
        x.data_ptr(), y.data_ptr(), rows_t.data_ptr(), R, B, ctx.logn,
        tb[twist].data_ptr(), tb[twiddles].data_ptr(),
        tb["p"].data_ptr(), tb["pinv"].data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{stats.name}: kernel launch failed, "
                           f"cudaGetLastError() = {rc}")
    stats.launches += 1
    return y


def ntt_fwd(ctx, x: torch.Tensor, rows=None) -> torch.Tensor:
    """Kernel K1: forward negacyclic NTT of x [..., R, N] (limb r of the
    R axis in prime domain rows[r]), bitwise equal to ctx.ntt_plain."""
    return _launch(NTT_FWD, "fhe_ntt_fwd", "psi", "fwd_tw", ctx, x, rows)


def ntt_inv(ctx, x: torch.Tensor, rows=None) -> torch.Tensor:
    """Kernel K2: inverse negacyclic NTT, bitwise equal to ctx.intt_plain."""
    return _launch(NTT_INV, "fhe_ntt_inv", "psi_inv_n", "inv_tw", ctx, x,
                   rows)
