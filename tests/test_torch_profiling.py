"""The port's `utils.profiling` on the CPU: `Phases` spans and report, and
a torch.profiler `trace` that writes a trace file holding the region's
operators."""

import glob
import json
import os
import time

import pytest
import torch

from fhe_spear_tpu.utils.profiling import Phases as RefPhases
from fhe_spear_tpu_torch.utils.profiling import Phases, trace


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
