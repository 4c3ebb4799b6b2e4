"""Wrappers of the hand-written CUDA NTT kernels (csrc/ntt.cu).

K1 `ntt_fwd` replaces `fhe_spear_tpu/core/ntt_pallas.py::_fwd_call`, K2
`ntt_inv` replaces `_inv_call`.  Their plain versions are
`NttContext.ntt_plain` / `intt_plain`; `NttContext.ntt` / `intt` pick the
kernel for a CUDA tensor and the plain version for a CPU tensor.  With
`to_mont=True` / `from_mont=True` the same kernels take twist tables with
the Montgomery conversion folded in (`NttContext.ntt_to_mont` /
`intt_from_mont`); such a launch counts as a K1 / K2 launch.

The kernels run register-resident radix passes (`schedule`, the host copy
of csrc/ntt.cu's `make_pass`) on a persistent, limb-grouped grid (`plan`),
and multiply by constants with Shoup products: every table is built here
once per context as (c, floor(c * 2^32 / p)) pairs (`shoup_pairs`).

The source is compiled with nvcc for sm_90a into a shared library with a
plain C interface at first use (into `build/` at the repository root,
keyed on a hash of the source and the flags) and loaded with ctypes: one
library per N (`library(logn)`, `-DFHE_NTT_LOGN`), so that a run compiles
only the sizes it transforms.  Nothing is imported or built when this
module is imported.

I/O: x is an int64 tensor [..., R, N] on a CUDA device, contiguous and
16-byte aligned, with canonical residues in [0, p) (Montgomery form); the
output is a new int64 tensor of the same shape.  N is a power of two,
2 <= N <= 16384.  There is no fallback: a tensor the kernel does not take
raises.
"""

from __future__ import annotations

import collections
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

__all__ = ["NTT_FWD", "NTT_INV", "ntt_fwd", "ntt_inv", "build", "library",
           "reset_counts", "SOURCE", "MAX_N", "CudaLibrary", "KernelStats",
           "schedule", "twiddle_index", "shoup_pairs", "plan",
           "cuda_schedule"]

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "ntt.cu"
BUILD_DIR = _PKG.parent / "build"
MAX_N = 16384
MAX_LOGN = 14
LOG_E = 5                      # a thread holds 2^5 words


class KernelStats:
    """Launch counter of one kernel: `launches` counts launches of the
    kernel itself, never runs of its plain version; `by_shape` counts them
    per (B, R, N)."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.by_shape = collections.Counter()

    def count(self, B: int, R: int, n: int) -> None:
        self.launches += 1
        self.by_shape[(B, R, n)] += 1

    def reset(self) -> None:
        self.launches = 0
        self.by_shape = collections.Counter()


NTT_FWD = KernelStats("ntt_fwd")
NTT_INV = KernelStats("ntt_inv")


def reset_counts() -> None:
    NTT_FWD.reset()
    NTT_INV.reset()


def schedule(logn: int) -> list:
    """The kernels' passes at N = 2^logn, in forward order (the inverse
    runs them backwards), as csrc/ntt.cu's `make_pass` builds them.  Pass j
    runs the stages of index bits lo..hi on a thread's registers; word r of
    thread u sits at index deposit(r, reg) | deposit(u, thr): `reg[k]` is
    the index bit of register bit k, `thr[k]` that of thread-id bit k.
    A: the top bits (4 from N = 1024) plus the lowest as spare register
    bits; B: bits 5..9 (stages 5..logn-5); C: bits 0..4."""
    e = min(LOG_E, logn)
    npass = 1 if logn <= LOG_E else (2 if logn < 2 * LOG_E else 3)
    passes = []
    for j in range(npass):
        if j == 0:
            k = logn if npass == 1 else (logn - LOG_E if npass == 2 else 4)
            lo, hi = logn - k, logn - 1
            mask = (((1 << k) - 1) << lo) | ((1 << (e - k)) - 1)
        elif j == npass - 1:
            lo, hi, mask = 0, LOG_E - 1, (1 << LOG_E) - 1
        else:
            lo, hi = LOG_E, logn - LOG_E
            mask = ((1 << LOG_E) - 1) << LOG_E
        passes.append({"lo": lo, "hi": hi,
                       "reg": [b for b in range(logn) if mask >> b & 1],
                       "thr": [b for b in range(logn) if not mask >> b & 1]})
    return passes


def twiddle_index(n: int, h: int, i0):
    """Index into a limb's concatenated twiddle table of the butterfly on
    index bit h whose lower word sits at i0: stage h's table starts at
    N - 2^(h+1) and is indexed by i0 mod 2^h."""
    return n - (2 << h) + (i0 & ((1 << h) - 1))


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
    sm_90a (plus `flags`) into `build/lib<stem>-<hash>.so` at first use and
    loaded with ctypes.  `bind(lib)` sets the argument types of its
    functions.  `seconds` and `log` hold the build's time and nvcc's
    output."""

    def __init__(self, source: Path, stem: str, bind, flags=()):
        self.source, self.stem, self.bind = source, stem, bind
        self.flags = tuple(flags)
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
            tag = hashlib.sha256(self.source.read_bytes() + " ".join(
                self.flags).encode()).hexdigest()[:16]
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            so = BUILD_DIR / f"lib{self.stem}-{tag}.so"
            if not so.exists():
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                       "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                       "-Xptxas", "-v", *self.flags, "-o", tmp,
                       str(self.source)]
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
        fn.argtypes = [vp, vp, vp, ci, ctypes.c_longlong, ci, vp, vp, vp, vp]
    lib.fhe_ntt_plan.restype = ci
    lib.fhe_ntt_plan.argtypes = [ci, ci, ci, ctypes.c_longlong,
                                 ctypes.POINTER(ctypes.c_int)]
    lib.fhe_ntt_schedule.restype = ci
    lib.fhe_ntt_schedule.argtypes = [ci, ci, ctypes.POINTER(ctypes.c_int)]


_LIBRARIES: dict = {}
_LIBRARIES_LOCK = threading.Lock()


def library(logn: int) -> CudaLibrary:
    """The K1/K2 library for N = 2^logn (csrc/ntt.cu built with
    -DFHE_NTT_LOGN=logn)."""
    if not 1 <= logn <= MAX_LOGN:
        raise ValueError(f"N=2^{logn} unsupported (kernel takes 2 <= N <= "
                         f"{MAX_N})")
    with _LIBRARIES_LOCK:
        if logn not in _LIBRARIES:
            _LIBRARIES[logn] = CudaLibrary(SOURCE, f"fhe_ntt{logn}", _bind,
                                           (f"-DFHE_NTT_LOGN={logn}",))
        return _LIBRARIES[logn]


def build(logn: int) -> ctypes.CDLL:
    """Compile (once per source hash) and load the library for N = 2^logn."""
    return library(logn).build()


def plan(shape, forward: bool = True) -> dict:
    """The launch plan of a transform of x [..., R, N] on the current card:
    threads and shared memory (bytes) per CTA, CTAs, polynomials per CTA
    (at most) and CTAs per SM.  Builds the library of that N."""
    R, n = shape[-2:]
    B = 1
    for d in shape[:-2]:
        B *= d
    logn = n.bit_length() - 1
    out = (ctypes.c_int * 5)()
    rc = build(logn).fhe_ntt_plan(int(forward), logn, R, B, out)
    if rc != 0:
        raise RuntimeError(f"ntt plan failed: {rc}")
    return {"threads": out[0], "smem_bytes": out[1], "ctas": out[2],
            "polys_per_cta": out[3], "ctas_per_sm": out[4]}


def cuda_schedule(logn: int) -> list:
    """The schedule at N = 2^logn as the compiled source holds it (to hold
    against `schedule`), read from the N = 8192 library: every build holds
    the whole schedule."""
    lib = build(13)
    passes, j, count = [], 0, 1
    while j < count:
        out = (ctypes.c_int * 64)()
        count = lib.fhe_ntt_schedule(logn, j, out)
        if count < 0:
            raise RuntimeError(f"ntt schedule failed at logn={logn}, j={j}")
        lo, hi, e, t = out[0], out[1], out[2], out[3]
        passes.append({"lo": lo, "hi": hi, "reg": list(out[4:4 + e]),
                       "thr": list(out[4 + e:4 + e + t])})
        j += 1
    return passes


def shoup_pairs(ctx, table: torch.Tensor) -> torch.Tensor:
    """Montgomery-form constants c*R mod p [L, X] (int64, all limbs) ->
    the kernels' Shoup pairs [L, X, 2] int64: (c, floor(c * 2^32 / p)).
    a*c - floor(a * c' / 2^32)*p lies in [0, 2p) for any a < 2^32, and one
    conditional subtraction makes it the canonical a*c mod p, the word
    mont_mul(a, c*R) gives."""
    c = ctx.from_mont(table)
    return torch.stack([c, (c << 32) // ctx.p], dim=-1)


def _tables(ctx, device: torch.device) -> dict:
    """The kernels' tables of a context on the device (built once per
    context), int32 words of (c, c') Shoup pairs: twist psi^j and twist_mont
    psi^j * R (to_mont folded in), untwist psi^-j N^-1 and untwist_plain
    psi^-j N^-1 R^-1 (from_mont folded in), each [L, N, 2]; the forward and
    inverse twiddles concatenated over stages, [L, N, 2] (stage on index
    bit h at N - 2^(h+1), the last pair unused); p [L]."""
    tb = ctx.kernel_tables
    if tb is None or tb["device"] != device:
        def u32(t):
            # residues (< 2^31) keep their bits; c' (< 2^32) is stored as
            # its two's-complement int32 word
            t = t - ((t >> 31) << 32)
            return t.to(device=device, dtype=torch.int32).contiguous()

        def twiddles(stages):
            cat = torch.cat([t[:, 0, :] for t in stages]
                            + [torch.zeros_like(ctx.p)], dim=-1)
            return u32(shoup_pairs(ctx, cat))

        folded = ctx.folded_tables()
        tb = {"device": device,
              "twist": u32(shoup_pairs(ctx, ctx.psi)),
              "twist_mont": u32(shoup_pairs(ctx, folded["psi_to_mont"])),
              "untwist": u32(shoup_pairs(ctx, ctx.psi_inv_n)),
              "untwist_plain": u32(shoup_pairs(
                  ctx, folded["psi_inv_n_from_mont"])),
              "fwd_tw": twiddles(ctx.fwd_tw), "inv_tw": twiddles(ctx.inv_tw),
              "p": u32(ctx.p[:, 0]), "rows": {}}
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
    if x.data_ptr() % 16:
        raise ValueError(f"{stats.name}: x must start on a 16-byte boundary "
                         "(the kernels move 16-byte pairs)")
    lib = build(ctx.logn)
    tb = _tables(ctx, x.device)
    rows_t = _rows(tb, rows, R, len(ctx.primes))
    B = x.numel() // (R * n)
    y = torch.empty_like(x)
    if B == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = getattr(lib, fn_name)(
        x.data_ptr(), y.data_ptr(), rows_t.data_ptr(), R, B, ctx.logn,
        tb[twist].data_ptr(), tb[twiddles].data_ptr(), tb["p"].data_ptr(),
        stream)
    if rc != 0:
        raise RuntimeError(f"{stats.name}: kernel launch failed, "
                           f"cudaGetLastError() = {rc}")
    stats.count(B, R, n)
    return y


def ntt_fwd(ctx, x: torch.Tensor, rows=None, to_mont: bool = False
            ) -> torch.Tensor:
    """Kernel K1: forward negacyclic NTT of x [..., R, N] (limb r of the
    R axis in prime domain rows[r]), bitwise equal to ctx.ntt_plain; with
    to_mont, equal to ctx.to_mont(ctx.ntt_plain(x))."""
    return _launch(NTT_FWD, "fhe_ntt_fwd", "twist_mont" if to_mont
                   else "twist", "fwd_tw", ctx, x, rows)


def ntt_inv(ctx, x: torch.Tensor, rows=None, from_mont: bool = False
            ) -> torch.Tensor:
    """Kernel K2: inverse negacyclic NTT, bitwise equal to ctx.intt_plain;
    with from_mont, equal to ctx.from_mont(ctx.intt_plain(x))."""
    return _launch(NTT_INV, "fhe_ntt_inv", "untwist_plain" if from_mont
                   else "untwist", "inv_tw", ctx, x, rows)
