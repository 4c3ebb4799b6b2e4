"""The control: the plain reference put in the program's place one
precision step below it must come out not correct under each
configuration's limits.  On the CPU at the configuration's widths with a
short vocabulary and a few steps; on the card (`cuda`) at the cell's own
size through `benchmark/control.py`."""

import copy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark.compare import compare_logits, precision_switches, verdict
from benchmark.harness import load_manifest, resolve
from benchmark.reference.rwkv7 import reference_logits
from benchmark.weights import make_weights

ROOT = Path(__file__).resolve().parents[2]
CONTROL = {"rwkv7-1.5b.s1": "bfloat16", "rwkv7-0.4b.s1": "bfloat16",
           "rwkv7-1.5b.s4": "bfloat16"}


@pytest.mark.parametrize("workload", sorted(CONTROL))
def test_control_is_not_correct(workload):
    spec = copy.deepcopy(resolve(load_manifest(), workload))
    cfg = spec["config"]
    cfg["vocab_size"] = 2048
    streams = spec["traffic"]["streams"]
    w = make_weights(cfg, 2**31 + 1, "cpu")
    ids = np.random.default_rng(1).integers(0, 2048, (8, streams))
    low = reference_logits(w, ids, "cpu", CONTROL[workload])
    numbers = compare_logits(w, ids, low, "cpu")
    numbers["tf32_switches_on"] = float(len(precision_switches()))
    ok, rows = verdict(numbers, cfg["limits"])
    assert not ok, rows
    # the logits alone fail: the control is caught by a logit number
    assert not verdict(numbers, {k: v for k, v in cfg["limits"].items()
                                 if k != "tf32_switches_on"})[0]


def test_verdict_holds_every_limited_number():
    limits = {"a": 1.0, "b": 0.0}
    assert verdict({"a": 1.0, "b": 0.0, "c": 9.0}, limits)[0]
    assert not verdict({"a": 1.0}, limits)[0]                # b missing
    assert not verdict({"a": float("nan"), "b": 0.0}, limits)[0]
    assert not verdict({"a": 1.5, "b": 0.0}, limits)[0]
    assert not verdict({"a": 0.5}, {})[0]                    # no limit


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(CONTROL))
def test_control_on_card(workload, card):
    """Three seeds at the cell's own size: the program's numbers beside
    the control's (one process; ~4 minutes a cell)."""
    import json

    out = subprocess.run(
        [sys.executable, "benchmark/control.py", "--workload", workload,
         "--seconds", str(load_manifest()["run_seconds"]),
         "--seeds", "2147483749,2147483750,2147483751",
         "--controls", CONTROL[workload]],
        cwd=ROOT, capture_output=True, text=True, timeout=1800, check=True)
    cfg = resolve(load_manifest(), workload)["config"]
    for line in out.stdout.strip().splitlines():
        r = json.loads(line)
        assert r["correct"] is True
        assert not verdict(r[CONTROL[workload]], cfg["limits"])[0]
