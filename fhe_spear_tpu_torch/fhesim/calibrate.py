"""Calibrate and validate fhesim against the port's own CKKS backend.

Counterpart of `fhe_spear_tpu/fhesim/calibrate.py`; the oracle is the
port's CT-CT column-packed engine (`ops.retrieval.ColumnPackedRetrieval`)
on a `CkksContext` on any device.

measure_noise_constant: encrypts random unit vectors, scores them CT-CT
through the column-packed engine, and fits sigma_eps = c * sqrt(d) across
dims.  validate() runs the 4 pass/fail bands:
  1. fitted c within [0.8, 1.2]x of the shipped constant;
  2. formula prediction error < 0.10 against measured correlations;
  3. simulated vs real top-k overlap >= 6/10;
  4. per-context bias std consistent with the shipped bias model
     (measured zero on this backend; see measure_context_bias).
main() writes fhesim_calibration.json next to this file (the port's
`fhesim/`, never the JAX package's).
"""

from __future__ import annotations

import json
import os

import numpy as np

from .simulator import FheAccuracySimulator, _normalize

__all__ = ["measure_noise_constant", "measure_context_bias", "validate",
           "main", "CALIBRATION_PATH"]

CALIBRATION_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "fhesim_calibration.json")


def _real_scores(ctx, query, docs):
    """Score docs against query under real CT-CT encryption (euclidean)."""
    from ..ops.retrieval import ColumnPackedRetrieval

    eng = ColumnPackedRetrieval(ctx, dim=docs.shape[-1], lorentz=False)
    ct = eng.scores(eng.encrypt_corpus(docs), eng.encrypt_query(query))
    return eng.decode_scores(ct, len(docs))


def measure_noise_constant(ctx, dims=(8, 16, 32, 64), n_docs=64, seed=0):
    """Fit c in sigma_eps = c*sqrt(d) from real encrypted dot products on
    ctx's device.  Returns (c, {dim: sigma})."""
    rng = np.random.default_rng(seed)
    cs = []
    per_dim = {}
    for d in dims:
        docs = _normalize(rng.normal(0, 1, (n_docs, d)))
        q = _normalize(rng.normal(0, 1, d))
        got = _real_scores(ctx, q, docs)
        err = got - docs @ q
        sigma = float(np.std(err))
        per_dim[d] = sigma
        cs.append(sigma / np.sqrt(d))
    return float(np.mean(cs)), per_dim


def measure_context_bias(params, n_contexts=6, n_trials=24, dim=32, seed=0,
                         device="cuda"):
    """Per-context systematic score bias: for each of n_contexts FRESH
    contexts (fresh secret key + noise) on `device`, average the CT-CT score
    error over n_trials random pairs; return (std of the per-context means,
    expected sampling std if the true bias is zero).  On this backend the
    measured std is consistent with zero -- encryption noise and rescale
    rounding are zero-mean and independent of the key -- which the shipped
    BIAS_STD=0 records."""
    from ..ckks import CkksContext

    rng = np.random.default_rng(seed)
    means = []
    sigma_one = None
    for ci in range(n_contexts):
        ctx = CkksContext(params, seed=1000 + ci, device=device)
        docs = _normalize(rng.normal(0, 1, (n_trials, dim)))
        q = _normalize(rng.normal(0, 1, dim))
        err = _real_scores(ctx, q, docs) - docs @ q
        means.append(float(np.mean(err)))
        sigma_one = float(np.std(err))
    bias_std = float(np.std(means))
    # sampling floor: even a zero-bias backend shows std(means) of about
    # sigma_eps/sqrt(n_trials)
    floor = (sigma_one or 0.0) / np.sqrt(n_trials)
    return bias_std, floor


def validate(ctx, seed=0, verbose=True):
    """The 4-band validation harness on ctx (band 4 builds its fresh
    contexts on ctx's device)."""
    rng = np.random.default_rng(seed)
    sim = FheAccuracySimulator(poly_modulus_degree=ctx.n, seed=seed)
    results = {}

    # 1. noise constant ratio
    c_meas, per_dim = measure_noise_constant(ctx, seed=seed)
    ratio = c_meas / sim.c
    results["noise_constant"] = {"measured": c_meas, "shipped": sim.c,
                                 "ratio": ratio,
                                 "pass": 0.8 <= ratio <= 1.2}

    # 2. formula error vs measured correlation
    d = 32
    docs = _normalize(rng.normal(0, 1, (96, d)))
    q_idx = 0
    got = _real_scores(ctx, docs[q_idx], docs)
    true = docs @ docs[q_idx]
    rho_real = float(np.corrcoef(got, true)[0, 1])
    rho_pred = sim.rho_noise(float(np.std(true)), d)
    results["formula"] = {"rho_real": rho_real, "rho_pred": rho_pred,
                          "pass": abs(rho_real - rho_pred) < 0.10}

    # 3. sim-vs-real top-k overlap
    k = 10
    sim.c = c_meas
    sim_scores = sim.simulate_scores(docs[q_idx], docs)
    top_real = set(np.argsort(got)[-k:].tolist())
    top_sim = set(np.argsort(sim_scores)[-k:].tolist())
    overlap = len(top_real & top_sim)
    results["topk_overlap"] = {"overlap": overlap, "k": k,
                               "pass": overlap >= 6}

    # 4. context-bias band.  A TenSEAL backend's band checks
    # sim_bias_std/real_bias_std in [0.7, 1.3]; this backend models bias as
    # exactly zero, so the band instead verifies the MEASURED per-context
    # bias is statistically indistinguishable from zero (within 3x the
    # n_trials sampling floor).
    bias_std, floor = measure_context_bias(ctx.params, seed=seed,
                                           device=ctx.device)
    results["context_bias"] = {
        "real_bias_std": bias_std, "sampling_floor": floor,
        "sim_bias_std": sim._bias_std,
        "pass": bias_std <= max(3.0 * floor, 1e-9)}

    n_tests = len(results)
    n_pass = sum(r["pass"] for r in results.values())
    results["summary"] = f"{n_pass}/{n_tests} tests passed"
    if verbose:
        for name, r in results.items():
            if isinstance(r, dict):
                print(f"  {name}: {'PASS' if r['pass'] else 'FAIL'} {r}")
    return results


def main(n=2048, device="cuda", seed=0):
    """Calibrate and validate at ring n on `device` and write the result
    to CALIBRATION_PATH."""
    from ..ckks import CkksContext, CkksParams

    ctx = CkksContext(CkksParams(n=n, num_limbs=3, num_special=1), seed=seed,
                      device=device)
    c, per_dim = measure_noise_constant(ctx, seed=seed)
    res = validate(ctx, seed=seed)
    out = {"noise_constant": c, "per_dim_sigma": per_dim, "n": ctx.n,
           "device": str(ctx.device),
           "validation": {k: v for k, v in res.items() if isinstance(v, dict)
                          and all(not isinstance(x, set) for x in v.values())}}
    with open(CALIBRATION_PATH, "w") as f:
        json.dump(out, f, indent=2, default=str)
    print(f"wrote {CALIBRATION_PATH}: c={c:.3e}")
    return out


if __name__ == "__main__":
    main()
