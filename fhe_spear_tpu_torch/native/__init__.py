"""Native (C++/OpenMP) host batch encoder, with the numpy fallback.

The port's copy of `fhe_spear_tpu/native/`.  `batch_encode(slots, scale,
t_slot, t_conj, n)` is the batch CKKS encoder used for diagonal
pre-encoding and the client's fused-transport encodes (see
batch_encoder.cpp).  This is host code, not a device kernel.  The shared
library is built with g++ at first use into the `build/` directory at the
repository root, keyed on a hash of the source; if the toolchain is
unavailable, `batch_encode` returns None and the caller falls back to the
numpy encoder.  Which of the two ran is logged once.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["batch_encode", "available", "encode_i32"]

_SRC = Path(__file__).resolve().parent / "batch_encoder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_log = logging.getLogger(__name__)
_lib = None
_tried = False
_reported = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libbatchenc-{tag}.so"
    if not so.exists():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", "-O3", "-fopenmp", "-shared", "-fPIC",
                            "-o", str(tmp), str(_SRC)],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            _log.warning("native batch encoder not built (%s)", e)
            return None
        os.replace(tmp, so)
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        _log.warning("native batch encoder not loaded (%s)", e)
        return None
    lib.batch_encode.restype = ctypes.c_int
    lib.batch_encode.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_longlong, ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def batch_encode(slots: np.ndarray, scale: float, t_slot: np.ndarray,
                 t_conj: np.ndarray, n: int) -> np.ndarray | None:
    """Complex slots [rows, n/2] -> int32 coefficients [rows, n], or None
    if the native library is unavailable (caller falls back to numpy)."""
    lib = _load()
    if lib is None:
        return None
    slots = np.ascontiguousarray(slots, dtype=np.complex128)
    rows = int(np.prod(slots.shape[:-1], initial=1))
    re = np.ascontiguousarray(slots.real.reshape(rows, -1))
    im = np.ascontiguousarray(slots.imag.reshape(rows, -1))
    ts = np.ascontiguousarray(t_slot, dtype=np.int64)
    tc = np.ascontiguousarray(t_conj, dtype=np.int64)
    out = np.empty((rows, n), dtype=np.int32)
    rc = lib.batch_encode(
        re.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        im.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rows, n, float(scale),
        ts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        tc.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise OverflowError("native batch_encode: coefficient > int32")
    return out.reshape(slots.shape[:-1] + (n,))


def encode_i32(encoder, slots: np.ndarray, scale: float) -> np.ndarray:
    """Slots [..., n/2] -> int32 coefficients [..., n]: the native encoder
    where it builds, the numpy encoder otherwise (the reference's
    fallback, `fhe_spear_tpu/ops/bsgs.py:521-533`).  Logs once which."""
    global _reported
    out = batch_encode(np.asarray(slots, dtype=np.complex128), scale,
                       encoder._t_slot, encoder._t_conj, encoder.n)
    if not _reported:
        _reported = True
        _log.info("batch encoder: %s",
                  "native C++" if out is not None else "numpy fallback")
    if out is None:
        out = encoder.encode(slots, scale).astype(np.int32)
    return out
