"""Train/test-split evaluation of the fhesim predictor: calibrate on one
split, predict on the other, versus circularly validating on the
calibration data.  The port's own copy of `fhe_spear_tpu/fhesim/eval.py`.

Pure numpy; the "measured" correlations can come either from the real
backend (fhesim/calibrate.py) or from a synthetic noise model with a known
constant (for fast self-tests).
"""

from __future__ import annotations

import numpy as np

from .simulator import FheAccuracySimulator, _normalize

__all__ = ["split_eval"]


def _measured_rho(embs, dims, c_true, rng):
    """Synthetic oracle: correlation of noisy vs clean similarities."""
    x = _normalize(embs)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    out = {}
    for d in dims:
        z = _normalize(x @ vt[:d].T)
        i = rng.integers(0, len(z), 2000)
        j = rng.integers(0, len(z), 2000)
        sims = np.einsum("ij,ij->i", z[i], z[j])
        noisy = sims + rng.normal(0, c_true * np.sqrt(d), len(sims))
        out[d] = float(np.corrcoef(sims, noisy)[0, 1])
    return out


def split_eval(embeddings, c_true=0.003, train_dims=(16, 32),
               test_dims=(8, 64, 96), seed=0):
    """Calibrate c on train_dims' measurements; report prediction error on
    held-out test_dims.  Returns {dim: {measured, predicted, error}} plus
    the fitted constant."""
    rng = np.random.default_rng(seed)
    embs = np.asarray(embeddings, dtype=np.float64)
    sim = FheAccuracySimulator(noise_constant=1.0, seed=seed)

    train = _measured_rho(embs, train_dims, c_true, rng)
    sim.calibrate(embs, train)

    test = _measured_rho(embs, test_dims, c_true, rng)
    x = _normalize(embs)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    report = {}
    for d, rho_meas in test.items():
        z = _normalize(x @ vt[:d].T)
        i = rng.integers(0, len(z), 1000)
        j = rng.integers(0, len(z), 1000)
        sigma_z = float(np.std(np.einsum("ij,ij->i", z[i], z[j])))
        rho_pred = sim.rho_noise(sigma_z, d)
        report[d] = {"measured": rho_meas, "predicted": rho_pred,
                     "error": abs(rho_meas - rho_pred)}
    report["fitted_c"] = sim.c
    report["true_c"] = c_true
    return report


if __name__ == "__main__":
    rng = np.random.default_rng(0)
    rep = split_eval(rng.normal(0, 1, (400, 128)))
    for k, v in rep.items():
        print(k, v)
