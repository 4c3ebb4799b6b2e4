"""The benchmark's harness: finds a cell's parts by name, runs its set-up
and measured window, reads its metrics and decides `correct`.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own under `benchmark/`, found by the name that
`BENCHMARK.json` gives:
  configs/<config>.json     the configuration as it is run
  traffic/<traffic>.json    the traffic mix; its "kind" names the driver
  drivers/<kind>.py         the driver of that kind of traffic (`Driver`)
                            and the numbers its check returns (`NUMBERS`)
  metrics/<metric>.py       one reader a metric: read(rec) -> number or None
A cell, a traffic mix or a metric is added as new files and entries.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import statistics
import sys
import time
import traceback
from pathlib import Path

__all__ = ["HERE", "load_manifest", "resolve", "load_reader", "load_driver",
           "run_cell", "FORBIDDEN", "forbidden_modules"]

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fhe_spear_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is one of
    FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def load_manifest(root: Path = HERE.parent) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve(manifest: dict, workload: str) -> dict:
    """The cell named workload with its configuration, traffic and
    metrics: {"cell", "config", "traffic", "end_to_end", "per_layer"}."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    root = HERE.parent
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json"
                          ).read_text())

    def applies(m):
        return workload in m.get("workloads", [workload])
    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": [m for m in manifest["end_to_end"] if applies(m)],
            "per_layer": [m for m in manifest["per_layer"] if applies(m)]}


def load_reader(name: str):
    """The read(rec) function of benchmark/metrics/<name>.py."""
    return importlib.import_module(f"benchmark.metrics.{name}").read


def load_driver(kind: str):
    """The module benchmark/drivers/<kind>.py: its Driver and NUMBERS."""
    return importlib.import_module(f"benchmark.drivers.{kind}")


def _diff(after: dict, before: dict) -> dict:
    return {k: {s: n - before.get(k, {}).get(s, 0) for s, n in v.items()
                if n - before.get(k, {}).get(s, 0)}
            for k, v in after.items()}


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=None) -> dict:
    """One run of a cell: set-up, the window of `seconds`, the metrics and
    the comparison.  Returns {"correct", "attempted", "failed", "metrics",
    "memory_peak_bytes", "busy_s", "window_s", "breakdown", "checks",
    "numbers", "rec", "driver"}; the caller adds the device and prints."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    traffic, config = spec["traffic"], spec["config"]
    spans: dict = {}

    @contextlib.contextmanager
    def span(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
            spans[name] = time.perf_counter() - t0

    def profiler():
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        return profile(activities=acts)

    drv = load_driver(traffic["kind"]).Driver(config, traffic, seed, dev)
    if trace:
        with span("profiler_s"):          # the profiler's own first start
            with profiler():
                torch.ones(1, device=dev).add_(1)
    drv.setup(span)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in spans.items()))

    p0 = int(traffic.get("profile_after", 0))
    p1 = p0 + int(traffic.get("profile_steps", 0)) if trace else p0
    units = drv.streams
    lat, failed, prof = [], 0, None
    c_start = drv.counters()
    c_prof = [None, None]
    t_prof = [0.0, 0.0]
    t0 = time.perf_counter()
    t_end = t0
    t = 0
    while time.perf_counter() - t0 < seconds or t < p1:
        if trace and t == p0:
            c_prof[0] = drv.counters()
            prof = profiler()
            prof.start()
            t_prof[0] = time.perf_counter()
        ts = time.perf_counter()
        try:
            drv.step(t)
        except Exception:                     # the step failed: end here
            traceback.print_exc()
            failed += units
            break
        t_end = time.perf_counter()
        lat.append(t_end - ts)
        t += 1
        if trace and t == p1:
            if cuda:
                torch.cuda.synchronize()
            t_prof[1] = time.perf_counter()
            prof.stop()
            c_prof[1] = drv.counters()
            # the profiler's stop (seconds of event processing) is not the
            # program's time: the window resumes where the step ended
            t0 += time.perf_counter() - t_prof[1]
            t_end = time.perf_counter()
    if prof is not None and c_prof[1] is None:
        prof.stop()
    window_s = t_end - t0
    c_end = drv.counters()
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    log(f"window {window_s:.3f} s, {t} steps of {units} streams, "
        f"{failed} failed")

    summary = None
    if trace and c_prof[1] is not None:
        from .trace import summarize
        summary = summarize(prof)
    prof = None

    drv.release()
    numbers = drv.check(t)
    from .compare import verdict
    limits = config.get("limits", {})
    for k, v in numbers.items():
        if k not in limits:
            log(f"not compared: {k} {v!r}")
    ok, rows = verdict(numbers, limits)
    ok = ok and failed == 0 and t > 0

    profiled = set(range(p0, p1)) if trace else set()
    rest = [x for i, x in enumerate(lat) if i not in profiled]
    rec = {"spans": spans, "setup_s": setup_s, "streams": units,
           "steps": t, "window_s": window_s, "latencies": lat,
           "unprofiled_mean_s": statistics.fmean(rest) if rest else None,
           "profiled_steps": p1 - p0 if c_prof[1] is not None else 0,
           "profiled_wall_s": t_prof[1] - t_prof[0],
           "counters_window": _diff(c_end, c_start),
           "counters_profiled": (_diff(c_prof[1], c_prof[0])
                                 if c_prof[1] is not None else None),
           "trace": summary, "step_bound": drv.step_bound(),
           "config": config, "traffic": traffic}
    metrics = {}
    for m in spec["per_layer"] if trace else spec["end_to_end"]:
        value = load_reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": ok, "attempted": t * units + failed, "failed": failed,
           "metrics": metrics, "memory_peak_bytes": memory_peak,
           "checks": rows, "numbers": numbers, "rec": rec, "driver": drv}
    if summary is not None:
        out["busy_s"] = summary["busy_s"]
        out["window_s"] = rec["profiled_wall_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    return out
