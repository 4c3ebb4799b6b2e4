"""The comparison fails what it must.  A whole run of a cell (set-up,
window, comparison, result line) at tiny widths on the CPU, the harness's
look for a card skipped, with the timed path broken underneath: each
fault that a decode cell can have makes `correct` false under the cell's
own limits, and the sound run is correct.  (No cell spans chips, so no
exchange between chips can be left out.)  A run whose program turns on
TF32 for float32 products, below the precision that the configurations
state, is not correct either."""

import json
import time

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.harness import load_manifest

from .conftest import tiny_spec

CELLS = [w["name"] for w in load_manifest()["workloads"]]


def _line(workload, capsys, seconds=8.0):
    args = run.parse(["--workload", workload, "--seed", str(2**31 + 99),
                      "--seconds", str(seconds), "--trace", "0"])
    line = run.execute(args, tiny_spec(workload), "cpu", time.perf_counter())
    run.report(line)
    out, err = capsys.readouterr()
    printed = json.loads(out.strip().splitlines()[-1])
    assert list(printed)[-1] == "checks"
    last = err.strip().splitlines()[-len(printed["checks"]):]
    assert all(s.startswith("check ") and " limit " in s for s in last)
    return printed


def _patch(monkeypatch, fault):
    from fhe_spear_tpu_torch.models.device_client import DeviceTokenRunner

    sound = DeviceTokenRunner.generate_tokens_streams
    calls = {"n": 0}

    def broken(self, token_ids, states):
        calls["n"] += 1
        late = calls["n"] > 2                  # past the 2 warm-up steps
        if fault == "half_batch" and late and len(token_ids) > 1:
            h = len(token_ids) // 2
            logits, news = sound(self, token_ids[:h], states[:h])
            mean = np.mean(logits, axis=0, keepdims=True)
            return (np.concatenate([logits] + [mean] * (len(token_ids) - h)),
                    news + [news[0].copy() for _ in token_ids[h:]])
        if fault == "tf32_on" and late:
            monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                                True)
        logits, news = sound(self, token_ids, states)
        if fault == "state_unchanged":
            return logits, [s.copy() for s in states]
        if fault == "answer_altered" and late:
            logits = logits.copy()
            top = int(np.argmax(logits[0]))
            logits[0, top] -= 3.0 * np.std(logits[0])
        return logits, news
    monkeypatch.setattr(DeviceTokenRunner, "generate_tokens_streams", broken)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload, capsys):
    line = _line(workload, capsys)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered",
                                   "half_batch", "tf32_on"])
def test_fault_is_not_correct(fault, monkeypatch, capsys):
    workload = "rwkv7-1.5b.s4"
    _patch(monkeypatch, fault)
    line = _line(workload, capsys)
    assert line["correct"] is False, (fault, line["checks"])
    if fault == "tf32_on":
        assert line["checks"]["tf32_switches_on"]["value"] > 0
