"""`benchmark/spans.span_summary` and the six figures of the program's spans
on a synthetic trace: device time by launch (the runtime call's
correlation id, else the launching operator's), inclusive and self host
time, idle time inside the spans and outside them, unattributed device
time, user annotations; `trace.summarize`'s keys unchanged by the
program's span events, and by the spans' tool that adds "spans"."""

import pytest
import torch
from torch.autograd import DeviceType

from benchmark import trace
from benchmark.spans import (FIGURES, _with_spans, figures, main,
                             span_summary)
from benchmark.trace import summarize


class Ev:
    """A kineto event as torch 2.11 gives it (no activity type): name,
    device, [start, start + dur) in ns, correlation ids, thread, and
    whether it is a user annotation."""

    def __init__(self, name, kind, start, dur, corr=0, linked=0, tid=7,
                 ann=False):
        self._v = (name, kind, ann, start, dur, corr, linked, tid)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]

    def device_resource_id(self):
        return self._v[7]

    def is_user_annotation(self):
        return self._v[2]


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def span(name, a, b, tid=7):
    return Ev(name, CPU, a, b - a, tid=tid)


def kernel(a, b, corr, linked=0, name="k"):
    return Ev(name, CUDA, a, b - a, corr, linked)


SPANS = [span("token", 0, 1000), span("token.state_in", 10, 60),
         span("client.math", 100, 200), span("server.bsgs", 250, 700),
         span("ckks.decompose", 260, 360), span("ckks.keyswitch", 400, 600),
         span("token.head", 750, 900),
         span("client.encode", 405, 415, tid=9)]   # another thread

OTHER = [
    Ev("aten::copy_", CPU, 15, 10, corr=499),
    Ev("cudaMemcpyAsync", CPU, 20, 5, corr=1),
    Ev("aten::mul", CPU, 110, 40, corr=500),
    Ev("cudaLaunchKernel", CPU, 130, 5, corr=2),
    Ev("cudaLaunchKernel", CPU, 300, 5, corr=3),
    Ev("cudaLaunchKernel", CPU, 420, 5, corr=4),
    Ev("cuLaunchKernel", CPU, 500, 5, corr=5),
    Ev("aten::add", CPU, 620, 10, corr=501),
    Ev("Activity Buffer Request", CPU, 622, 5, corr=501, tid=0),
    Ev("cudaLaunchKernel", CPU, 1100, 5, corr=7),
    Ev("cudaDeviceSynchronize", CPU, 1300, 10, corr=9),  # the trace's end
    # device work: a copy, kernels launched by `cuda*`, by `cu*` calls,
    # by an operator with no runtime call recorded (linked id 501), one
    # outside every span, one with no launch; a user annotation's mirror.
    # Work launched onto an idle device starts at its launch.
    Ev("Memcpy HtoD", CUDA, 30, 10, 1, 499),
    kernel(130, 180, 2, 500, "vectorized_elementwise_kernel"),
    kernel(300, 400, 3, 0, "ntt_inv_kernel<13>"),
    kernel(420, 520, 4, 0, "elementwise_kernel"),
    kernel(520, 560, 5, 0, "regular_fft_radix"),
    kernel(620, 660, 6, 501, "elementwise_kernel"),
    kernel(1100, 1150, 7, 0, "reduce_kernel"),
    kernel(1200, 1210, 8, 999, "reduce_kernel"),
    Ev("ann", CUDA, 0, 50, ann=True),
]
BUSY = [[30, 40], [130, 180], [300, 400], [420, 560], [620, 660],
        [1100, 1150], [1200, 1210]]


def _summary():
    return span_summary(SPANS + OTHER, BUSY)


def test_device_time_by_launch():
    out = _summary()
    sp = out["spans"]
    dev = {n: round(v["device_s"] * 1e9) for n, v in sp.items()}
    # cuda* (corr 1-4), cu* (5) and linked-operator (501) launches;
    # each once per span name open at the launch on its thread
    assert dev == {"token": 340, "token.state_in": 10, "client.math": 50,
                   "server.bsgs": 280, "ckks.decompose": 100,
                   "ckks.keyswitch": 140, "token.head": 0,
                   "client.encode": 0}
    assert round(out["attributed_device_s"] * 1e9) == 340
    # launched outside every span (corr 7), and with no launch (corr 8)
    assert round(out["unattributed_device_s"] * 1e9) == 60
    assert round(out["device_s"] * 1e9) == 400
    assert out["user_annotations"] == 1


def test_host_time_inclusive_and_self():
    sp = _summary()["spans"]
    wall = {n: round(v["wall_s"] * 1e9) for n, v in sp.items()}
    own = {n: round(v["self_s"] * 1e9) for n, v in sp.items()}
    assert wall["token"] == 1000 and own["token"] == 1000 - 750
    assert wall["server.bsgs"] == 450 and own["server.bsgs"] == 150
    assert own["ckks.keyswitch"] == wall["ckks.keyswitch"] == 200
    assert own["token.head"] == 150
    assert {n: v["count"] for n, v in sp.items()} == dict.fromkeys(sp, 1)
    assert sp["ckks.decompose"]["parents"] == {"server.bsgs": 1}
    assert sp["server.bsgs"]["parents"] == {"token": 1}
    assert sp["token"]["parents"] == {"": 1}
    assert sp["client.encode"]["parents"] == {"": 1}


IDLE = {"token": 650, "token.state_in": 30, "client.math": 50,
        "server.bsgs": 170, "ckks.decompose": 40, "ckks.keyswitch": 60,
        "token.head": 150, "client.encode": 10}


def test_idle_inside_spans_and_outside():
    out = _summary()
    idle = {n: round(v["idle_s"] * 1e9) for n, v in out["spans"].items()}
    # gaps: [40,130] [180,300] [400,420] [560,620] [660,1100] [1150,1200];
    # before the first work, from the trace's start to its launch: [0,20];
    # after the last, to the trace's end: [1210,1310]
    assert idle == IDLE
    assert round(out["idle_s"] * 1e9) == 780 + 20 + 100
    assert round(out["outside_idle_s"] * 1e9) == 100 + 50 + 100


@pytest.mark.parametrize("drift", [-40, 25])
def test_idle_follows_the_launches_not_the_device_clock(drift):
    """Device timestamps shifted against the host's (a drifting device
    clock) move no idle time between spans: each gap ends at the launch
    of the work that ends it.  The gap ended by work with no launch
    (corr 8), and the idle after it, keep the device's timestamps,
    outside every span."""
    moved = [Ev(e.name(), CUDA, e.start_ns() + drift, e.duration_ns(),
                e.correlation_id(), e.linked_correlation_id(),
                ann=e.is_user_annotation())
             if e.device_type() == CUDA else e for e in OTHER]
    out = span_summary(SPANS + moved,
                       [[a + drift, b + drift] for a, b in BUSY])
    idle = {n: round(v["idle_s"] * 1e9) for n, v in out["spans"].items()}
    assert idle == IDLE
    assert round(out["outside_idle_s"] * 1e9) == 250 - drift
    assert round(out["attributed_device_s"] * 1e9) == 340


def test_no_spans():
    out = span_summary(OTHER, BUSY)
    assert out["spans"] == {}
    assert out["attributed_device_s"] == 0
    assert round(out["unattributed_device_s"] * 1e9) == 400
    assert round(out["outside_idle_s"] * 1e9) == (20 - 15) + 780 + 100
    idle = span_summary(SPANS, [])
    assert round(idle["idle_s"] * 1e9) == 1000
    assert round(idle["spans"]["token.head"]["idle_s"] * 1e9) == 150


def _rec(spans, steps=2):
    return {"trace": {"spans": {"spans": spans}} if spans is not None
            else None, "profiled_steps": steps}


def test_figures():
    def one(dev, own, idle):
        return {"count": 1, "wall_s": own, "self_s": own, "device_s": dev,
                "idle_s": idle, "parents": {}}
    spans = {
        "token": one(1.0, 0.01, 0.5),
        "server.bsgs": one(0.4, 0.02, 0.1),
        "ckks.decompose": one(0.05, 0.01, 0.0),
        "ckks.keyswitch": one(0.15, 0.01, 0.0),
        "client.math": one(0.01, 0.01, 0.04),
        "client.encode": one(0.002, 0.01, 0.01),
        "client.encrypt": one(0.003, 0.01, 0.02),
        "client.decrypt": one(0.004, 0.01, 0.03),
        "token.state_in": one(0.0, 0.006, 0.005),
        "token.embed": one(0.0, 0.001, 0.001),
        "token.head": one(0.0, 0.06, 0.06),
        "token.state_out": one(0.0, 0.003, 0.003),
        "token.readback": one(0.0, 0.03, 0.0),
    }
    want = {"server_ms_per_step": 200.0, "keyswitch_ms_per_step": 100.0,
            "crypto_ms_per_step": 4.5, "client_math_ms_per_step": 5.0,
            "host_ms_per_step": 35.0,
            "launch_idle_ms_per_step": (0.1 + 0.04 + 0.06) * 1e3 / 2}
    assert set(FIGURES) == set(want)
    assert figures(_rec(spans)) == pytest.approx(want)
    # no trace; a trace without the program's spans (a program that opens
    # none); spans, but none of these; no profiled step
    no_spans = {"trace": {"busy_s": 1.0}, "profiled_steps": 2}
    for empty in (_rec(None), no_spans, _rec({}),
                  _rec({"token": spans["token"]}), _rec(spans, steps=0)):
        assert figures(empty) == dict.fromkeys(FIGURES)


class _Prof:
    """What summarize reads of a torch.profiler.profile."""

    def __init__(self, events):
        class R:
            def events(self):
                return list(events)

        class P:
            kineto_results = R()
        self.profiler = P()


def test_summarize_keeps_its_keys():
    """The program's span events change none of summarize's keys where an
    operator is open at each gap's middle; where only a span is, the gap is
    named by the span (the innermost host event).  The spans' tool adds
    "spans" and changes no other key."""
    cover = [Ev("cudaStreamSynchronize", CPU, a, d) for a, d in
             ((85, 10), (235, 10), (407, 6), (585, 10), (875, 10),
              (1170, 10))]
    old = ("busy_s", "kernels", "device_s", "device_ops", "idle_gaps")
    with_spans = summarize(_Prof(SPANS + OTHER + cover))
    without = summarize(_Prof(OTHER + cover))
    assert with_spans == without
    assert set(with_spans) == set(old)
    tool = _with_spans(summarize)
    for events, count in ((SPANS + OTHER + cover, 1), (OTHER + cover, 0)):
        out = tool(_Prof(events))
        assert {k: out[k] for k in old} == without
        assert set(out) == set(old) | {"spans"}
        assert len(out["spans"]["spans"]) == 8 * count
    # over summarize's busy intervals, the annotation's mirror [0, 50] in
    assert tool(_Prof(SPANS + OTHER))["spans"] == span_summary(
        SPANS + OTHER, [[0, 50]] + BUSY[1:])
    assert tool(_Prof(SPANS)) is None
    assert with_spans["busy_s"] == pytest.approx(sum(
        b - a for a, b in BUSY) / 1e9 + 40e-9)     # the annotation's mirror

    named = summarize(_Prof(SPANS + OTHER))["idle_gaps"]
    bare = summarize(_Prof(OTHER))["idle_gaps"]
    assert named[0] == ["token.head", 440e-9]
    assert bare[0] == ["host, outside any profiled operation", 440e-9]


@pytest.mark.skipif(torch.cuda.is_available(), reason="runs a cell on a card")
def test_tool_refuses_without_a_card():
    """The spans' tool, like benchmark/run.py, runs on a CUDA card only;
    refusing, it leaves `trace.summarize` as it was."""
    plain = trace.summarize
    assert main(["--workload", "rwkv7-1.5b.s1", "--seed", "3",
                 "--seconds", "1"]) == 2
    assert trace.summarize is plain
