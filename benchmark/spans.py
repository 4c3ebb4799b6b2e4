"""Reduction of the program's own spans in a torch.profiler trace: for each
span name, its count, host time (inclusive and self), the device time of
the kernels launched inside it and the device's idle time inside it.

The program opens its spans with `fhe_spear_tpu_torch.utils.profiling.span`
at its layer boundaries (`SPANS`); each is a host operator of the trace
under its name.  A device event's launch is the CUDA API call (`cuda*`
or `cu*`) with the same correlation id or, where none is recorded, the
host operator whose correlation id is the event's linked one (the first
to open under that id: the profiler's own events inside an operator
carry its id too); the spans open on the launching thread at the launch
each receive the event's duration, once per name.

Idle time is the gaps between the merged busy intervals, with the idle
before the first and after the last within the host events' extent, each
intersected with the spans' intervals.  A gap is laid on the host's clock
by the work that ends it: that work starts on an idle device as soon as
it is launched, so the gap ends at its launch and is as long as the
device clock says.  The device events' own timestamps drift from the
host's, either way, by up to 10 ms a second in traces taken on an H100
(two seconds in, kernels read as starting 10 ms before, or 20 ms after,
their launches), which would move each gap into the host work next to it.
A gap ended by work with no recorded launch keeps the device's
timestamps; the idle after the last work starts where that work's busy
interval, laid from its launch, ends.

`BENCHMARK.json` reads none of this: `trace.summarize` does not call it.
`python3 -m benchmark.spans --workload <cell> --seed <n> --seconds <s>`
makes one traced run of a cell, as `benchmark/run.py --trace 1` does, and
adds to its result line the summary ("spans") and, per profiled step, the
figures that each would be a per-layer metric ("figures": `FIGURES`).
"""

from __future__ import annotations

import bisect
import json
import os
import re
import sys
import time
from collections import defaultdict

from .trace import _merge

__all__ = ["SPANS", "FIGURES", "span_summary", "ms_per_step", "figures",
           "main"]

# the program's spans, from the token step down to the keyswitch
SPANS = ("token", "token.state_in", "token.embed", "client.math",
         "client.encode", "client.encrypt", "server.bsgs", "client.decrypt",
         "ckks.decompose", "ckks.keyswitch", "token.readback", "token.head",
         "token.state_out")
_API = re.compile(r"^cu(da)?[A-Z]")     # CUDA API calls: cuda*, cu*
_CLIENT = ("client.math", "client.encode", "client.encrypt", "client.decrypt")
# per profiled step, in ms: name -> (spans, the field of theirs summed)
FIGURES = {
    # the server's whole matvec, keyswitch included
    "server_ms_per_step": (("server.bsgs",), "device_s"),
    "keyswitch_ms_per_step": (("ckks.decompose", "ckks.keyswitch"),
                              "device_s"),
    "crypto_ms_per_step": (_CLIENT[1:], "device_s"),
    "client_math_ms_per_step": (_CLIENT[:1], "device_s"),
    # numpy work around the device step
    "host_ms_per_step": (("token.state_in", "token.embed", "token.head",
                          "token.state_out"), "self_s"),
    # the host was launching device work and the card ran dry
    "launch_idle_ms_per_step": (("server.bsgs",) + _CLIENT, "idle_s"),
}


def _covered(gaps, ivs) -> int:
    """Total length of the intervals `gaps` inside `ivs` (sorted,
    disjoint)."""
    starts = [a for a, _ in ivs]
    tot = 0
    for a, b in gaps:
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(ivs) and ivs[i][0] < b:
            tot += max(0, min(b, ivs[i][1]) - max(a, ivs[i][0]))
            i += 1
    return tot


def span_summary(events, busy) -> dict:
    """The program's spans in kineto events (`kineto_results.events()`),
    against the merged device intervals `busy` ([[start_ns, end_ns]]):

    {"spans": {name: {"count", "wall_s", "self_s", "device_s", "idle_s",
                      "parents": {parent name or "": count}}},
     "device_s", "attributed_device_s", "unattributed_device_s",
     "idle_s", "outside_idle_s", "user_annotations"}

    device_s is every device event's time but user annotations' (the
    profiler's mirrors of `record_function` regions, which the program's
    spans never are), counted in user_annotations."""
    from torch.autograd import DeviceType

    names = set(SPANS)
    spans = defaultdict(list)        # thread -> [(start, end, name)]
    launch, ops = {}, {}             # correlation id -> (thread, start)
    dev = []                         # (start, duration, corr, linked)
    window = [float("inf"), 0]       # the host events' extent
    user_annotations = 0
    for e in events:
        kind = e.device_type()
        if kind == DeviceType.CUDA:
            if e.is_user_annotation():
                user_annotations += 1
            else:
                dev.append((e.start_ns(), e.duration_ns(),
                            e.correlation_id(), e.linked_correlation_id()))
        elif kind == DeviceType.CPU:
            name, tid = e.name(), e.device_resource_id()
            start = e.start_ns()
            window[0] = min(window[0], start)
            window[1] = max(window[1], start + e.duration_ns())
            if name in names:
                spans[tid].append((start, start + e.duration_ns(), name))
            elif _API.match(name):
                launch[e.correlation_id()] = (tid, start)
            else:
                at = ops.get(e.correlation_id())
                if at is None or start < at[1]:
                    ops[e.correlation_id()] = (tid, start)

    # device time: each event at its launch, on the launching thread
    queries = defaultdict(list)      # thread -> [(launch time, duration)]
    launched = {}                    # device start -> its launch time
    unattributed = 0
    for start, dur, corr, linked in dev:
        at = launch.get(corr) or ops.get(linked)
        if at is None:
            unattributed += dur
        else:
            queries[at[0]].append((at[1], dur))
            launched.setdefault(start, at[1])
    by_open: dict = defaultdict(int)  # frozenset of open names -> ns
    stats = {n: {"count": 0, "wall": 0, "child": 0, "device": 0,
                 "parents": defaultdict(int)} for n in names}
    for tid in set(spans) | set(queries):
        # sweep: at one instant a span opens before a launch, and closes
        # after it
        ev = []
        for s, e, n in spans.get(tid, ()):
            ev.append((s, 0, n))
            ev.append((e, 2, n))
        for t, dur in queries.get(tid, ()):
            ev.append((t, 1, dur))
        ev.sort(key=lambda x: (x[0], x[1]))
        open_n: dict = defaultdict(int)
        for _, kind, v in ev:
            if kind == 0:
                open_n[v] += 1
            elif kind == 2:
                open_n[v] -= 1
                if not open_n[v]:
                    del open_n[v]
            else:
                by_open[frozenset(open_n)] += v
        # host time and parents: spans nest on a thread
        stack = []
        for s, e, n in sorted(spans.get(tid, ()),
                              key=lambda x: (x[0], -x[1])):
            while stack and stack[-1][1] <= s:
                stack.pop()
            st = stats[n]
            st["count"] += 1
            st["wall"] += e - s
            if stack:
                parent = stack[-1]
                stats[parent[2]]["child"] += min(e, parent[1]) - s
                st["parents"][parent[2]] += 1
            else:
                st["parents"][""] += 1
            stack.append((s, e, n))
    attributed = 0
    for open_set, ns in by_open.items():
        if open_set:
            attributed += ns
        else:
            unattributed += ns
        for n in open_set:
            stats[n]["device"] += ns

    # idle: the gaps between busy intervals on the host's clock, inside
    # each name's spans
    gaps = []
    for (_, a), (b, _) in zip(busy, busy[1:]):
        end = launched.get(b, b)
        gaps.append((end - (b - a), end))
    if busy:                         # before the first work, after the last
        first = launched.get(busy[0][0], busy[0][0])
        last = launched.get(busy[-1][0], busy[-1][0]) + busy[-1][1] - \
            busy[-1][0]
        gaps += [(window[0], first), (last, window[1])]
    elif window[1]:
        gaps.append(tuple(window))
    gaps = [(a, b) for a, b in gaps if b > a]
    every = [(s, e, n) for lst in spans.values() for s, e, n in lst]
    idle_total = sum(b - a for a, b in gaps)
    outside = idle_total - _covered(gaps, _merge((s, e)
                                                 for s, e, _ in every))
    out = {}
    for n in SPANS:
        st = stats[n]
        if not st["count"]:
            continue
        mine = _merge((s, e) for s, e, m in every if m == n)
        out[n] = {"count": st["count"], "wall_s": st["wall"] / 1e9,
                  "self_s": (st["wall"] - st["child"]) / 1e9,
                  "device_s": st["device"] / 1e9,
                  "idle_s": _covered(gaps, mine) / 1e9,
                  "parents": dict(st["parents"])}
    return {"spans": out,
            "device_s": (attributed + unattributed) / 1e9,
            "attributed_device_s": attributed / 1e9,
            "unattributed_device_s": unattributed / 1e9,
            "idle_s": idle_total / 1e9,
            "outside_idle_s": outside / 1e9,
            "user_annotations": user_annotations}


def ms_per_step(rec, names, field: str):
    """The sum over the spans `names` of `field` ("device_s", "self_s",
    "idle_s", ...) in ms per profiled step, or None where the run has no
    trace or its trace holds none of these spans."""
    tr = rec["trace"]
    spans = (tr or {}).get("spans")
    if not spans or not rec["profiled_steps"]:
        return None
    found = [spans["spans"][n][field] for n in names if n in spans["spans"]]
    return 1e3 * sum(found) / rec["profiled_steps"] if found else None


def figures(rec) -> dict:
    """`FIGURES` of a run's record ({name: ms a step or None})."""
    return {name: ms_per_step(rec, names, field)
            for name, (names, field) in FIGURES.items()}


def _with_spans(summarize):
    """`summarize`, its result also holding span_summary under "spans"."""
    def wrapped(prof, top: int = 10):
        from torch.autograd import DeviceType

        out = summarize(prof, top)
        if out is not None:
            events = prof.profiler.kineto_results.events()
            busy = _merge((e.start_ns(), e.start_ns() + e.duration_ns())
                          for e in events
                          if e.device_type() == DeviceType.CUDA)
            out["spans"] = span_summary(events, busy)
        return out
    return wrapped


def main(argv=None) -> int:
    """One traced run of a cell on the card, printed as the result line of
    `benchmark/run.py --trace 1` with "spans" and "figures" added."""
    from . import harness, run, trace

    t_start = time.perf_counter()
    os.environ["TORCH_EXTENSIONS_DIR"] = str(run.ROOT / "build" /
                                             "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(run.ROOT / "build" / "triton")
    args = run.parse(argv)
    args.trace = 1
    spec = harness.resolve(harness.load_manifest(run.ROOT), args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    recs = []
    run_cell = harness.run_cell

    def recorded(*a, **k):
        res = run_cell(*a, **k)
        recs.append(res["rec"])
        return res
    trace.summarize = _with_spans(trace.summarize)
    harness.run_cell = recorded
    line = run.execute(args, spec, "cuda", t_start)
    if line is None:
        return 3
    line["figures"] = figures(recs[0])
    line["spans"] = (recs[0]["trace"] or {}).get("spans")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
