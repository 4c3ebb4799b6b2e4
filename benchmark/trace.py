"""Reduction of a torch.profiler trace of a few steps to the numbers the
per-layer readers take: device busy time, kernel counts and device time
by class of kernel, the operations that took the most device time, and
the longest idle gaps named by what the host was doing meanwhile.

The event arithmetic is that of the program's own `profile_token`
(busy time is the union of the device intervals; a kernel's time is its
own interval), read from the profiler's raw events so that a trace of
tens of thousands of kernels reduces in seconds.
"""

from __future__ import annotations

import bisect
import re

__all__ = ["kernel_class", "summarize"]

_NTT = re.compile(r"\bntt_(fwd|inv)_kernel\b")
_FOURSTEP = re.compile(r"\bfourstep_(fwd|inv)_kernel\b")
_FFT = re.compile(r"fft|radix", re.IGNORECASE)
_COPY = re.compile(r"^\s*(memcpy|memset)", re.IGNORECASE)


def kernel_class(name: str) -> str:
    """"ntt" (K1/K2), "fourstep", "fft" (cuFFT), "copy" (memory copies
    and sets) or "glue" (every other kernel: the torch elementwise,
    reduction and indexing kernels of the modular arithmetic and of the
    client's float math)."""
    if _COPY.search(name):
        return "copy"
    if _NTT.search(name):
        return "ntt"
    if _FOURSTEP.search(name):
        return "fourstep"
    if _FFT.search(name):
        return "fft"
    return "glue"


def _merge(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(prof, top: int = 10) -> dict:
    """{"busy_s", "kernels", "device_s" by class, "device_ops" [[name, s]]
    (the top by device time), "idle_gaps" [[name, s]] (the longest gaps
    between device work, by the innermost host operation open at the
    gap's middle)}, or None when the trace holds no device event."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            dev.append((start, end, e.name()))
        elif e.device_type() == DeviceType.CPU:
            host.append((start, end, e.name()))
    if not dev:
        return None
    by_class: dict = {}
    by_name: dict = {}
    kernels = 0
    for s, e, name in dev:
        c = kernel_class(name)
        by_class[c] = by_class.get(c, 0) + (e - s)
        by_name[name] = by_name.get(name, 0) + (e - s)
        kernels += c != "copy"
    busy = _merge((s, e) for s, e, _ in dev)
    busy_ns = sum(e - s for s, e in busy)
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0])
                   for i in range(len(busy) - 1)), reverse=True)[:top]
    host.sort()
    starts = [s for s, _, _ in host]

    def doing(mid):
        """The shortest host event open at mid (the innermost)."""
        best = None
        i = bisect.bisect_right(starts, mid)
        for s, e, name in host[max(0, i - 4000):i]:
            if e >= mid and (best is None or e - s < best[0]):
                best = (e - s, name)
        return best[1] if best else "host, outside any profiled operation"

    return {
        "busy_s": busy_ns / 1e9,
        "kernels": kernels,
        "device_s": {c: t / 1e9 for c, t in by_class.items()},
        "device_ops": [[n[:200], t / 1e9] for n, t in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[doing((a + b) // 2)[:200], g / 1e9]
                      for g, a, b in gaps],
    }
