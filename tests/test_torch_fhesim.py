"""The port's fhesim against the JAX package's.

The simulator, `eval.split_eval` and the numpy paths are copies: for the
same seeds their results are equal, not close.  The calibration runs on
the port's CT-CT column engine; its words equal the reference's, so the
measured noise constant agrees to the float decode's last bits.  Also the
4-band `validate` at n=256 (bands 2 and 3), `benchmark_speed.run`'s
schema, and the `fhesim` subcommand on the CPU."""

import json

import numpy as np
import pytest
import torch

from fhe_spear_tpu.ckks import CkksContext as RefContext
from fhe_spear_tpu.ckks import CkksParams as RefParams
from fhe_spear_tpu.fhesim import FheAccuracySimulator as RefSim
from fhe_spear_tpu.fhesim.calibrate import \
    measure_noise_constant as ref_measure
from fhe_spear_tpu.fhesim.eval import split_eval as ref_split_eval
from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams
from fhe_spear_tpu_torch.fhesim import FheAccuracySimulator, calibrate
from fhe_spear_tpu_torch.fhesim.benchmark_speed import run as speed_run
from fhe_spear_tpu_torch.fhesim.eval import split_eval


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small-ring torch ops gain nothing from intra-op threads, and under a
    parallel test run the threads of several workers oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same_result(a, b):
    assert a.predicted_correlation == b.predicted_correlation
    assert a.optimal_dimension == b.optimal_dimension
    assert a.compatibility.value == b.compatibility.value
    assert a.uniformity == b.uniformity
    assert a.similarity_std == b.similarity_std
    assert a.recommendation == b.recommendation
    assert a.details == b.details


@pytest.mark.parametrize("n_ring,target", [(8192, 64), (16384, None),
                                           (3000, 16)])
def test_simulator_equal_to_reference(n_ring, target):
    x = np.random.default_rng(0).normal(0, 1, (120, 48))
    ours, ref = (cls(poly_modulus_degree=n_ring, seed=3)
                 for cls in (FheAccuracySimulator, RefSim))
    assert ours.c == ref.c
    assert_same_result(ours.predict(x, target_dim=target, n_samples=400),
                       ref.predict(x, target_dim=target, n_samples=400))
    q, docs = x[0], x[1:]
    np.testing.assert_array_equal(ours.simulate_scores(q, docs),
                                  ref.simulate_scores(q, docs))
    assert ours.simulate_dot_product(q, docs[0]) == \
        ref.simulate_dot_product(q, docs[0])
    assert ours.estimate_retrieval_accuracy(x, n_queries=6, k=4, n_runs=2) \
        == ref.estimate_retrieval_accuracy(x, n_queries=6, k=4, n_runs=2)
    meas = {8: 0.97, 16: 0.95, 32: 0.9}
    assert ours.calibrate(x, meas) == ref.calibrate(x, meas)


def test_simulated_bias_and_split_eval_equal_to_reference():
    ours = FheAccuracySimulator(seed=5, simulate_bias=True, bias_std=0.2)
    ref = RefSim(seed=5, simulate_bias=True, bias_std=0.2)
    assert ours.context_bias == ref.context_bias != 0.0
    assert ours.new_context() == ref.new_context()
    embs = np.random.default_rng(1).normal(0, 1, (150, 64))
    assert split_eval(embs, seed=2) == ref_split_eval(embs, seed=2)


@pytest.fixture(scope="module")
def small_ctx():
    return CkksContext(CkksParams(n=256, num_limbs=3, num_special=1),
                       seed=61, device="cpu")


def test_noise_constant_matches_reference(small_ctx):
    ref = RefContext(RefParams(n=256, num_limbs=3, num_special=1), seed=61)
    c_ref, per_ref = ref_measure(ref, dims=(16,), n_docs=32, seed=4)
    c, per = calibrate.measure_noise_constant(small_ctx, dims=(16,),
                                              n_docs=32, seed=4)
    assert 0 < c < 1e-3
    np.testing.assert_allclose(c, c_ref, rtol=1e-9)
    np.testing.assert_allclose(per[16], per_ref[16], rtol=1e-9)


def test_validate_bands_on_the_port(small_ctx):
    res = calibrate.validate(small_ctx, verbose=False)
    assert res["formula"]["pass"], res
    assert res["topk_overlap"]["pass"], res
    assert set(res) == {"noise_constant", "formula", "topk_overlap",
                        "context_bias", "summary"}


def test_benchmark_speed_schema():
    rows = speed_run(ns=(256,), n_docs=32, device="cpu", verbose=False)
    assert len(rows) == 1 and set(rows[0]) == {"n", "sim_s", "real_s",
                                               "speedup"}
    assert rows[0]["n"] == 256 and rows[0]["real_s"] > 0 \
        and rows[0]["speedup"] > 0


def test_fhesim_subcommand_cpu(tmp_path, monkeypatch, capsys):
    from fhe_spear_tpu_torch.__main__ import main

    out = tmp_path / "fhesim_calibration.json"
    monkeypatch.setattr(calibrate, "CALIBRATION_PATH", str(out))
    main(["fhesim", "--n", "256", "--device", "cpu"])
    rec = json.loads(out.read_text())
    assert rec["n"] == 256 and rec["device"] == "cpu"
    assert 0 < rec["noise_constant"] < 1e-3
    assert set(rec["validation"]) == {"noise_constant", "formula",
                                      "topk_overlap", "context_bias"}
    assert "wrote" in capsys.readouterr().out


def test_shipped_calibration_is_the_reference_file():
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    assert json.loads((root / "fhe_spear_tpu_torch/fhesim/"
                       "fhesim_calibration.json").read_text()) == \
        json.loads((root / "fhe_spear_tpu/fhesim/fhesim_calibration.json"
                    ).read_text())
