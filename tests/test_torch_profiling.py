"""The port's `utils.profiling` on the CPU: the program's `span` (a host
operator of a running profiler's trace, never a user annotation, nothing
without a profiler), `Phases` spans and report, and a torch.profiler
`trace` that writes a trace file holding the region's operators."""

import glob
import json
import os
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fhe_spear_tpu.utils.profiling import Phases as RefPhases
from fhe_spear_tpu_torch.utils.profiling import Phases, span, trace


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small torch ops gain nothing from intra-op threads, and under a
    parallel test run the threads of several workers oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_phases_report():
    ph, ref = Phases(), RefPhases()
    for p in (ph, ref):
        for name in ("encrypt", "matvec", "matvec"):
            with p.span(name):
                time.sleep(0.002)
    rep = ph.report()
    assert list(rep) == ["encrypt", "matvec"] == list(ref.report())
    assert rep["matvec"]["count"] == 2 and rep["encrypt"]["count"] == 1
    assert set(rep["matvec"]) == {"total_s", "count", "mean_s"}
    assert rep["matvec"]["total_s"] >= 0.004
    assert json.loads(str(ph)) == rep


def test_trace_writes_a_trace(tmp_path):
    x = torch.arange(4096, dtype=torch.int64)
    with trace(str(tmp_path)) as log_dir:
        y = (x * 3 + 1) % 65537
    assert log_dir == str(tmp_path)
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::remainder" in names and "aten::mul" in names
    assert int(y[5]) == 16


def _named(prof, prefix="t."):
    """The trace's host events whose names start with prefix, in order."""
    return sorted((e for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(prefix)), key=lambda e: e.start_ns())


def test_span_is_a_host_operator():
    """A span is a `cpu_op` (not a user annotation, which the profiler
    would mirror onto the device's timeline), and spans nest."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("t.outer"):
            with span("t.inner"):
                x = torch.arange(64) * 3
            with span("t.inner"):
                x = x + 1
    ev = _named(prof)
    assert [e.name() for e in ev] == ["t.outer", "t.inner", "t.inner"]
    for e in ev:
        assert e.activity_type() == "cpu_op"
        assert not e.is_user_annotation()
    outer = ev[0]
    end = outer.start_ns() + outer.duration_ns()
    for e in ev[1:]:
        assert outer.start_ns() <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= end
    assert ev[1].start_ns() + ev[1].duration_ns() <= ev[2].start_ns()
    assert int(x[2]) == 7


def test_span_records_nothing_without_a_profiler():
    with span("t.before"):
        torch.arange(8).sum()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("t.during"):
            torch.arange(8).sum()
    with span("t.after"):
        torch.arange(8).sum()
    assert [e.name() for e in _named(prof)] == ["t.during"]


def test_phases_span_is_a_span():
    """Phases.span opens the span of its name; its report is as before."""
    ph = Phases()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ph.span("t.matvec"):
            time.sleep(0.002)
        with ph.span("t.matvec"):
            pass
    ev = _named(prof)
    assert [e.name() for e in ev] == ["t.matvec", "t.matvec"]
    assert all(e.activity_type() == "cpu_op" and not e.is_user_annotation()
               for e in ev)
    rep = ph.report()
    assert list(rep) == ["t.matvec"]
    assert set(rep["t.matvec"]) == {"total_s", "count", "mean_s"}
    assert rep["t.matvec"]["count"] == 2
    assert rep["t.matvec"]["total_s"] >= 0.002
    assert ev[0].duration_ns() / 1e9 <= rep["t.matvec"]["total_s"]
