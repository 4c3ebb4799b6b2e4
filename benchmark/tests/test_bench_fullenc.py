"""The fully-encrypted chain cell on the CPU: a whole run (set-up, window,
comparison, result line) at a tiny configuration (D=16, F=64, N=256,
the cell's own L=11, K=8, dnum=8 and 3 blocks) reads `correct` under the
cell's limits; the plain chain equals the program's own plaintext chain;
each fault that the cell can have, planted in the timed path, and the
controls (the plain chain a precision step below the program's) read not
correct; the step's least time follows from the shapes alone.  On the
card (`cuda`), the controls at the cell's own size through
`benchmark/control_chain.py`."""

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.compare import verdict
from benchmark.drivers.fullenc import compare_outputs
from benchmark.ffn_weights import make_ffn_weights
from benchmark.harness import load_manifest, resolve
from benchmark.reference.ffn_chain import reference_outputs
from benchmark.roofline import HBM_BYTES_PER_S
from benchmark.roofline_fullenc import fullenc_step_bound
from benchmark.vectors import InputVectors

ROOT = Path(__file__).resolve().parents[2]
CELL = "rwkv7-1.5b-fullenc.chain3"


def _spec(d=16, f=64, n=256) -> dict:
    spec = copy.deepcopy(resolve(load_manifest(), CELL))
    spec["config"].update(hidden_size=d, intermediate_size=f)
    spec["config"]["ckks"] = dict(spec["config"]["ckks"], n=n)
    return spec


def _line(capsys, seconds=3.0):
    args = run.parse(["--workload", CELL, "--seed", str(2**31 + 77),
                      "--seconds", str(seconds), "--trace", "0"])
    line = run.execute(args, _spec(), "cpu", time.perf_counter())
    run.report(line)
    out, err = capsys.readouterr()
    printed = json.loads(out.strip().splitlines()[-1])
    assert list(printed)[-1] == "checks"
    last = err.strip().splitlines()[-len(printed["checks"]):]
    assert all(s.startswith("check ") and " limit " in s for s in last)
    return printed


def test_sound_tiny_cell_is_correct(capsys):
    line = _line(capsys)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["checks"]) == {"out_err_median", "out_abs_err_max",
                                   "tf32_switches_on"}
    assert set(line["metrics"]) == {"step_ms", "step_ms_p90", "setup_s"}


def test_reference_equals_program_plaintext_chain():
    """The plain chain, calibrating anew from the raw weights, against the
    program's calibrate_magnitude and plaintext_ffn_block on the same
    inputs."""
    from fhe_spear_tpu_torch.models.fully_encrypted import (
        calibrate_magnitude, plaintext_ffn_block)

    cfg = _spec(d=64, f=256)["config"]
    w = make_ffn_weights(cfg, 2**31 + 5, "cpu")
    ks, vs = calibrate_magnitude(w["w_key"], w["w_val"], w["x_cal"])
    xs = np.random.default_rng(2).uniform(-1, 1, (5, 64))
    want = xs.copy()
    for k, v in zip(ks, vs):
        want = plaintext_ffn_block(want, k, v)
    got = reference_outputs(w, xs, "cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert np.abs(want).max() > 0.5      # the blocks did change x


def _patch(monkeypatch, fault):
    from fhe_spear_tpu_torch.ckks.context import CkksContext
    from fhe_spear_tpu_torch.models.fully_encrypted import FullyEncryptedFfn

    blocks, warm = 3, 2                      # the cell's blocks, warm-up
    calls = {"block": 0, "decrypt": 0}
    sound_block = FullyEncryptedFfn.__call__
    sound_decrypt = CkksContext.decrypt_vec

    def block(self, ct_x, staged):
        calls["block"] += 1
        late = calls["block"] > warm * blocks
        if fault == "block_skipped" and late and calls["block"] % 3 == 2:
            return self.ctx.mod_drop(ct_x, 3)   # the input, levels aligned
        return sound_block(self, ct_x, staged)

    def decrypt(self, ct, length=None):
        calls["decrypt"] += 1
        y = sound_decrypt(self, ct, length)
        if calls["decrypt"] <= warm:
            return y
        if fault == "tf32_on":
            monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                                True)
        if fault == "bfloat16_output":
            y = torch.as_tensor(y).to(torch.bfloat16).double().numpy()
        if fault == "half_left_out":
            h = len(y) // 2
            y = np.concatenate([y[:h], np.full(len(y) - h, y[:h].mean())])
        if fault == "answer_altered":
            y = y.copy()
            y[0] += 1e-2
        return y
    monkeypatch.setattr(FullyEncryptedFfn, "__call__", block)
    monkeypatch.setattr(CkksContext, "decrypt_vec", decrypt)


@pytest.mark.parametrize("fault", ["block_skipped", "bfloat16_output",
                                   "half_left_out", "answer_altered",
                                   "tf32_on"])
def test_fault_is_not_correct(fault, monkeypatch, capsys):
    _patch(monkeypatch, fault)
    line = _line(capsys)
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["correct"] is False, (fault, line["checks"])
    if fault == "tf32_on":
        assert line["checks"]["tf32_switches_on"]["value"] > 0


@pytest.mark.parametrize("precision", ["float16", "bfloat16"])
def test_control_is_not_correct(precision):
    """The plain chain in the precision below the program's, in the
    program's place, at D=256, F=1024 (the cell's widths would not fit a
    test run's memory on the CPU)."""
    spec = _spec(d=256, f=1024)
    w = make_ffn_weights(spec["config"], 2**31 + 11, "cpu")
    xs = InputVectors(spec["traffic"], 256, 2**31 + 11).window(6)
    low = reference_outputs(w, xs.reshape(-1, 256), "cpu", precision)
    numbers = compare_outputs(w, xs, low, "cpu")
    numbers["tf32_switches_on"] = 0.0
    assert not verdict(numbers, spec["config"]["limits"])[0], numbers


def test_inputs_from_the_seed():
    traffic = resolve(load_manifest(), CELL)["traffic"]
    a, b = InputVectors(traffic, 8, 3), InputVectors(traffic, 8, 3)
    a.warmup(4)                      # warm-up draws its own stream
    np.testing.assert_array_equal(a.window(3), b.window(3))
    assert a.window(3).shape == (3, 1, 8)
    assert np.abs(a.window(3)).max() <= 1.0
    assert not np.array_equal(InputVectors(traffic, 8, 4).step(0),
                              b.step(0))


def test_step_bound_from_shapes():
    cfg = resolve(load_manifest(), CELL)["config"]
    b = fullenc_step_bound(cfg, 1)
    n, rot = 8192, 45 + 44                   # G=46, B=45 at D=2048

    def key(m):                               # gsize 2, K = 8
        return 2 * -(-m // 2) * (m + 8) * n * 4
    diag = 3 * 2 * 4 * 2048 * n * 4
    keys = sum(rot * (key(lv) + key(lv - 2)) + key(lv - 1)
               for lv in (11, 8, 5))
    assert b["bytes"] == diag + keys and b["by"] == "bytes"
    assert b["s"] == pytest.approx(b["bytes"] / HBM_BYTES_PER_S)
    assert 1e-3 < b["s"] < 2e-3
    assert b["ops"] == sum(4 * 2048 * 2 * m * n for m in (11, 9, 8, 6, 5, 3))
    b4 = fullenc_step_bound(cfg, 4)
    assert b4["bytes"] == b["bytes"] and b4["ops"] == 4 * b["ops"]


@pytest.mark.cuda
def test_control_on_card(card):
    """Three seeds at the cell's own size: the program correct, both
    controls not (one process; ~6 minutes)."""
    out = subprocess.run(
        [sys.executable, "benchmark/control_chain.py", "--workload", CELL,
         "--seconds", str(load_manifest()["run_seconds"]),
         "--seeds", "2147483761,2147483762,2147483763"],
        cwd=ROOT, capture_output=True, text=True, timeout=1800, check=True)
    for line in out.stdout.strip().splitlines():
        r = json.loads(line)
        assert r["correct"] is True
        assert r["float16"]["correct"] is False
        assert r["bfloat16"]["correct"] is False
