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

`GRAPHS` counts how the server's projections ran (`ops.graphed`): CUDA
graphs captured and replayed, and calls run eagerly.  `MOE` counts the
expert matvecs the server ran for an MoE layer (`models/lfm2.py`), and
of those, the ones whose expert the client had routed the token to;
`MOE_TIMER` holds the device time between the edges of the `moe.experts`
spans (`DeviceTimer`).
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path

from torch._C._profiler import _RecordFunctionFast

__all__ = ["span", "Phases", "trace", "GRAPHS", "MOE", "MOE_TIMER",
           "DeviceTimer", "DEFAULT_TRACE_DIR"]

# inside the checkout's gitignored build directory
DEFAULT_TRACE_DIR = str(Path(__file__).resolve().parents[2] / "build"
                        / "fhe_spear_trace")


# a projection's first call runs eagerly (and fills the caches a capture
# needs), its second is captured, every later one replays; calls that
# cannot be graphed (a CPU context, sharded keys) run eagerly each time;
# zero it with GRAPHS.update(dict.fromkeys(GRAPHS, 0))
GRAPHS = {"captures": 0, "replays": 0, "eager": 0}

# the server's expert matvecs (every held expert on every token, whatever
# the routing) and those whose expert the client routed to; client-side
# counts: the server is never told the routing
MOE = {"expert_matvecs": 0, "routed_matvecs": 0}


def span(name: str):
    """Context manager: the region as a host operator named `name` in a
    running torch profiler's trace; nothing (a few hundred ns) otherwise."""
    return _RecordFunctionFast(name)


class DeviceTimer:
    """Device time between the two edges of a region, from CUDA events
    recorded on the current stream at its edges: nothing waits inside
    the region or the step.  `read()` waits for the recorded events and
    returns the total in ms since construction; on the CPU it records
    nothing and reads 0."""

    def __init__(self):
        self._pending: list = []
        self._ms = 0.0

    @contextlib.contextmanager
    def region(self, device):
        import torch

        if torch.device(device).type != "cuda":
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self._pending.append((start, end))

    def read(self) -> float:
        for start, end in self._pending:
            end.synchronize()
            self._ms += start.elapsed_time(end)
        self._pending.clear()
        return self._ms


MOE_TIMER = DeviceTimer()


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
