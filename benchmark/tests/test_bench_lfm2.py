"""The LFM2-MoE cell on the CPU: a whole run (set-up, window, comparison,
result line) of `lfm2-8b-a1b.s1` at tiny widths (D=64, 4 heads of 16, 2
KV heads, SwiGLU 112, experts of 48, 4 held of 8, top 2, vocab 128,
N=256, 4 layers: conv + dense twice, attention + MoE, conv + MoE) reads
`correct` under the cell's limits; TF32 switched on, a skipped layer and
a wrong top k each read not correct, and so do bfloat16 logits (the
plain reference in bfloat16 in the program's place); the step's least
time counts the cell's 77 matrices; the two new readers read nothing
without a trace.  On the card (`cuda`), the controls at the cell's own
size through `benchmark/control_lfm2.py`."""

import copy
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.compare import verdict
from benchmark.control_lfm2 import control_numbers
from benchmark.drivers import decode_lfm2
from benchmark.harness import load_manifest, load_reader, resolve
from benchmark.roofline import HBM_BYTES_PER_S
from benchmark.roofline_lfm2 import lfm2_matrices, lfm2_step_bound
from benchmark.weights_lfm2 import make_weights

ROOT = Path(__file__).resolve().parents[2]
CELL = "lfm2-8b-a1b.s1"
TINY = {"hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 112,
        "moe_intermediate_size": 48, "num_router_experts": 8,
        "experts_held": [0, 1, 2, 3], "num_experts": 4,
        "num_experts_per_tok": 2, "vocab_size": 128, "num_hidden_layers": 4}


def _spec() -> dict:
    spec = copy.deepcopy(resolve(load_manifest(), CELL))
    spec["config"].update(TINY)
    spec["config"]["ckks"] = dict(spec["config"]["ckks"], n=256)
    return spec


def _line(capsys, seconds=4.0):
    args = run.parse(["--workload", CELL, "--seed", str(2**31 + 123),
                      "--seconds", str(seconds), "--trace", "0"])
    line = run.execute(args, _spec(), "cpu", time.perf_counter())
    run.report(line)
    out, _ = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1])


def test_sound_tiny_cell_is_correct(capsys):
    line = _line(capsys)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["checks"]) == {"logit_err_median", "logit_err_max",
                                   "route_margin_max", "tf32_switches_on"}
    assert set(line["metrics"]) == {"step_ms", "step_ms_p90", "setup_s"}


def _break_model(monkeypatch, fault):
    sound = decode_lfm2.program_model

    def broken(weights):
        model = sound(weights)
        if fault == "skipped_layer":
            del model.layers[1]            # the second conv + dense layer
        if fault == "wrong_top_k":
            model.top_k += 1
        return model
    monkeypatch.setattr(decode_lfm2, "program_model", broken)


@pytest.mark.parametrize("fault", ["tf32_on", "skipped_layer",
                                   "wrong_top_k"])
def test_fault_is_not_correct(fault, monkeypatch, capsys):
    from fhe_spear_tpu_torch.models.lfm2 import Lfm2TokenRunner

    if fault in ("skipped_layer", "wrong_top_k"):
        _break_model(monkeypatch, fault)
    sound = Lfm2TokenRunner.generate_tokens_streams

    def step(self, token_ids, states):
        if fault == "tf32_on":
            monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                                True)
        return sound(self, token_ids, states)
    monkeypatch.setattr(Lfm2TokenRunner, "generate_tokens_streams", step)
    line = _line(capsys)
    assert line["correct"] is False, (fault, line["checks"])
    checks = line["checks"]
    if fault == "tf32_on":
        assert checks["tf32_switches_on"]["value"] > 0
    if fault == "wrong_top_k":
        assert checks["route_margin_max"]["value"] == float("inf")


def test_bfloat16_control_is_not_correct():
    """The plain reference in bfloat16, routing by its own scores, in the
    program's place: its logits alone fail the cell's limits."""
    cfg = _spec()["config"]
    w = make_weights(cfg, 2**31 + 1, "cpu")
    ids = np.random.default_rng(1).integers(0, 128, (6, 1))
    drv = SimpleNamespace(weights=w,
                          ids=SimpleNamespace(window=lambda n: ids[:n]))
    limits = cfg["limits"]
    numbers = control_numbers(drv, len(ids), "bfloat16", "cpu",
                              limits["route_margin_max"])
    assert not verdict(numbers, {k: v for k, v in limits.items()
                                 if k.startswith(("logit", "top"))})[0]


def test_step_bound_counts_the_cells_matrices():
    """77 matrices a token at the cell's shapes (9 in each of the two
    conv + dense layers, 14 in the attention + MoE layer, 15 in each of
    the three conv + MoE ones), 48 of them expert matvecs; the bound is
    their diagonals' bytes plus the rotation keys' over the HBM rate."""
    cfg = resolve(load_manifest(), CELL)["config"]
    assert lfm2_matrices(cfg) == {"mixer": 17, "ffn": 60, "expert": 48}
    b = lfm2_step_bound(cfg, 1)
    assert b["matrices"] == 77 and b["by"] == "bytes"
    diag = 77 * 2048 * 8192 * 4
    keys = (45 + 44) * 2 * 3 * 4 * 8192 * 4
    assert b["bytes"] == diag + keys
    assert b["s"] == pytest.approx((diag + keys) / HBM_BYTES_PER_S)
    assert 1.5e-3 < b["s"] < 1.6e-3
    assert lfm2_step_bound(cfg, 4)["ops"] == 4 * b["ops"]


def test_new_readers_read_nothing_without_a_trace():
    rec = {"counters_window": {}, "counters_profiled": None, "steps": 5,
           "profiled_steps": 0}
    for name in ("expert_matvecs_per_step", "moe_ms_per_step"):
        assert load_reader(name)(rec) is None
    rec = {"counters_window": {"moe": {"expert_matvecs": 240}},
           "counters_profiled": {"moe": {"experts_ms": 300.0}},
           "steps": 5, "profiled_steps": 2}
    assert load_reader("expert_matvecs_per_step")(rec) == 48.0
    assert load_reader("moe_ms_per_step")(rec) == 150.0


def test_traced_cpu_run_reads_the_expert_counter():
    """A traced CPU run: the expert matvecs a step from the program's
    counter (4 up and 2 down in each of the 2 MoE layers), no device
    timer."""
    from benchmark.harness import run_cell

    spec = _spec()
    res = run_cell(spec, 2**31 + 5, 0.1, True, "cpu", time.perf_counter(),
                   log=lambda m: None)
    assert res["metrics"]["expert_matvecs_per_step"]["value"] == 12.0
    assert "moe_ms_per_step" not in res["metrics"]


@pytest.mark.cuda
def test_control_on_card(card):
    """Two seeds at the cell's own size: the program's numbers beside the
    controls' (one process)."""
    out = subprocess.run(
        [sys.executable, "benchmark/control_lfm2.py", "--workload", CELL,
         "--seconds", "8", "--seeds", "2147483901,2147483902"],
        cwd=ROOT, capture_output=True, text=True, timeout=1800, check=True)
    lines = [json.loads(s) for s in out.stdout.strip().splitlines()]
    assert len(lines) == 2
    for line in lines:
        assert line["correct"] is True, line["program"]
        assert line["bfloat16"]["correct"] is False
        assert np.isfinite(line["program"]["logit_err_median"])
