"""Tracing / profiling utilities: the program's spans (`span`), named
wall-clock totals (`Phases`) and a `torch.profiler` trace around a region
(`trace`).  Counterpart of `fhe_spear_tpu/utils/profiling.py`, whose trace
is a jax.profiler one.

A span is always in the code and records only while a torch profiler
runs: it is then a host operator (`cpu_op`) of the profiler's trace,
under its name, on the host clock of the trace's CUDA launches.  It is made
with `_RecordFunctionFast`, not `torch.profiler.record_function`: the
latter records a user annotation, which the profiler mirrors onto the
device's timeline as a device event, so a span would read as device work.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path

from torch._C._profiler import _RecordFunctionFast

__all__ = ["span", "Phases", "trace", "DEFAULT_TRACE_DIR"]

# inside the checkout's gitignored build directory
DEFAULT_TRACE_DIR = str(Path(__file__).resolve().parents[2] / "build"
                        / "fhe_spear_trace")


def span(name: str):
    """Context manager: the region as a host operator named `name` in a
    running torch profiler's trace; nothing (a few hundred ns) otherwise."""
    return _RecordFunctionFast(name)


class Phases:
    """Accumulates named wall-clock spans (per-block server/client timing).
    Host clock: on the card, end a span's work with a synchronise to count
    the device's share.  Each span is also a `span` of the same name."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> dict:
        return {k: {"total_s": round(v, 4), "count": self.counts[k],
                    "mean_s": round(v / self.counts[k], 4)}
                for k, v in sorted(self.totals.items())}

    def __str__(self):
        return json.dumps(self.report(), indent=2)


@contextlib.contextmanager
def trace(log_dir: str = DEFAULT_TRACE_DIR):
    """torch.profiler trace of a region: CPU activity, and CUDA activity
    (kernels under their names) where a card is present.  On exit the
    trace is written to `log_dir` as `<worker>.<ms>.pt.trace.json`
    (TensorBoard's profiler plugin and chrome://tracing read it).  Yields
    log_dir."""
    import torch
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir
