"""fhesim: analytical CKKS retrieval-accuracy predictor.

The port's own copy of `fhe_spear_tpu/fhesim/simulator.py`: numpy only,
and for the same seed its results are equal to the JAX package's.

Predicts the correlation between plaintext and under-encryption similarity
scores without running any encryption:

    rho_FHE = rho_compression(dim) * rho_noise(dim)
    rho_noise = sigma_z / sqrt(sigma_z^2 + c^2 * d)

where sigma_z is the std of pairwise similarities after SVD compression to
d dims and c is a backend noise constant (sigma_eps = c * sqrt(d)).  The
formula is backend-agnostic; the constants are not: the shipped constant
for N=2048 was measured against the uint32-RNS column engine (see
fhesim/calibrate.py; N=4096-16384 are scaled ~1/sqrt(N) from it, not
measured), ~3 orders of magnitude below TenSEAL's values (scale 2^28
keyswitch-free CT-PT noise vs TenSEAL's 2^20-scale contexts) -- encrypted
retrieval is effectively compression-limited on this backend.

Numpy only; no torch import (usable anywhere, much faster than running
encryption -- fhesim/benchmark_speed.py measures by how much).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

import numpy as np

__all__ = ["FheAccuracySimulator", "Compatibility", "SimulatorResult"]


class Compatibility(Enum):
    EXCELLENT = "excellent"
    GOOD = "good"
    MARGINAL = "marginal"
    POOR = "poor"
    INCOMPATIBLE = "incompatible"


@dataclass
class SimulatorResult:
    predicted_correlation: float
    optimal_dimension: int
    compatibility: Compatibility
    uniformity: float
    similarity_std: float
    recommendation: str
    details: dict

    def __repr__(self):
        return (f"fhesim: {self.predicted_correlation:.1%} correlation, "
                f"{self.optimal_dimension}d optimal, "
                f"{self.compatibility.value}")


def _normalize(x):
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-8)


def _pair_sims(x, n_samples, rng):
    n = len(x)
    i = rng.integers(0, n, n_samples)
    j = rng.integers(0, n, n_samples)
    keep = i != j
    return np.einsum("ij,ij->i", x[i[keep]], x[j[keep]]), (i[keep], j[keep])


class FheAccuracySimulator:
    """Gaussian stand-in for CKKS similarity scoring.

    Default constants measured against this framework's CT-CT column-packed
    retrieval at scale 2^28 (fhesim/calibrate.py writes updated values).
    """

    # sigma_eps = c * sqrt(d); N=2048 measured against this backend's
    # CT-CT column engine (fhesim_calibration.json: c = 7.5e-7), others
    # scaled ~1/sqrt(N)
    NOISE_CONSTANTS = {2048: 7.5e-7, 4096: 5.3e-7, 8192: 3.8e-7,
                       16384: 2.7e-7}

    # Per-context systematic score bias (a TenSEAL backend
    # shows BIAS_STD 0.09-0.36, fhesim/simulator.py:33).  Measured on this
    # uint32 backend the per-context mean error is statistically zero —
    # symmetric encryption noise and rescale rounding are zero-mean and
    # key-independent (fhesim/calibrate.py measure_context_bias;
    # fhesim_calibration.json records the measurement) — so the default
    # bias model is exactly 0; simulate_bias=True with an explicit
    # bias_std reproduces biased backends for comparison studies.
    BIAS_STD = {2048: 0.0, 4096: 0.0, 8192: 0.0, 16384: 0.0}

    def __init__(self, poly_modulus_degree: int = 8192,
                 noise_constant: float | None = None, seed: int = 0,
                 simulate_bias: bool = False,
                 bias_std: float | None = None):
        self.n = poly_modulus_degree
        if noise_constant is not None:
            self.c = noise_constant
        elif poly_modulus_degree in self.NOISE_CONSTANTS:
            self.c = self.NOISE_CONSTANTS[poly_modulus_degree]
        else:
            self.c = 1.5e-6 * (8192 / poly_modulus_degree) ** 0.5
        self.rng = np.random.default_rng(seed)
        self.simulate_bias = simulate_bias
        self._bias_std = (bias_std if bias_std is not None
                          else self.BIAS_STD.get(poly_modulus_degree, 0.0))
        self.context_bias = 0.0
        if simulate_bias:
            self.new_context()

    def new_context(self) -> float:
        """Draw a fresh per-context systematic bias (zero-std on this
        backend unless overridden)."""
        self.context_bias = (float(self.rng.normal(0, self._bias_std))
                             if self._bias_std > 0 else 0.0)
        return self.context_bias

    # -- prediction (no encryption) ------------------------------------

    def predict(self, embeddings: np.ndarray, target_dim: int | None = None,
                n_samples: int = 1000) -> SimulatorResult:
        x = _normalize(np.asarray(embeddings, dtype=np.float64))
        n, orig_dim = x.shape
        sims, _ = _pair_sims(x, n_samples, self.rng)
        uniformity = 1.0 - abs(float(np.mean(sims)))
        sim_std = float(np.std(sims))

        _, _, vt = np.linalg.svd(x, full_matrices=False)
        optimal = self._optimal_dim(x, vt, n_samples)
        dim = min(target_dim if target_dim is not None else optimal,
                  vt.shape[0])

        rho_c, rho_n = self._rho_at(x, vt, dim, n_samples)
        rho = float(np.clip(rho_c * rho_n, 0, 1))

        return SimulatorResult(
            predicted_correlation=rho,
            optimal_dimension=optimal,
            compatibility=self._assess(sim_std, rho),
            uniformity=uniformity,
            similarity_std=sim_std,
            recommendation=self._recommend(sim_std, rho, optimal, target_dim),
            details={"original_dim": orig_dim, "target_dim": dim,
                     "noise_constant": self.c, "rho_compression": rho_c,
                     "rho_noise": rho_n},
        )

    def _rho_at(self, x, vt, d, n_samples):
        z = _normalize(x @ vt[:d].T)
        orig, (i, j) = _pair_sims(x, n_samples, self.rng)
        comp = np.einsum("ij,ij->i", z[i], z[j])
        rho_c = float(np.corrcoef(orig, comp)[0, 1]) if len(orig) > 2 else 1.0
        rho_n = self.rho_noise(float(np.std(comp)), d)
        return rho_c, rho_n

    def rho_noise(self, sigma_z: float, d: int) -> float:
        se = self.c * np.sqrt(d)
        return float(sigma_z / np.sqrt(sigma_z ** 2 + se ** 2)) \
            if sigma_z > 1e-9 else 0.0

    def _optimal_dim(self, x, vt, n_samples):
        dims = [d for d in (8, 16, 32, 48, 64, 96, 128) if d < vt.shape[0]]
        if not dims:
            return min(64, vt.shape[0])
        best, best_rho = dims[0], -1.0
        for d in dims:
            rc, rn = self._rho_at(x, vt, d, min(n_samples, 300))
            if rc * rn > best_rho:
                best, best_rho = d, rc * rn
        return best

    # -- simulation (Gaussian CKKS stand-in) ---------------------------

    def simulate_dot_product(self, x, y):
        d = len(x)
        return float(np.dot(x, y) + self.rng.normal(0, self.c * np.sqrt(d))
                     + self.context_bias)

    def simulate_scores(self, query, docs):
        """Vectorized: plaintext scores + iid Gaussian CKKS noise (+ the
        per-context bias, zero on this backend)."""
        docs = np.atleast_2d(docs)
        d = docs.shape[-1]
        return (docs @ query + self.rng.normal(0, self.c * np.sqrt(d),
                                               len(docs))
                + self.context_bias)

    def simulate_retrieval(self, embeddings, query_idx, k=10):
        x = _normalize(np.asarray(embeddings, dtype=np.float64))
        sims = self.simulate_scores(x[query_idx], x)
        sims[query_idx] = -np.inf
        top = np.argsort(sims)[-k:][::-1]
        return top, sims[top]

    def estimate_retrieval_accuracy(self, embeddings, n_queries=100, k=10,
                                    n_runs=5):
        x = _normalize(np.asarray(embeddings, dtype=np.float64))
        n = len(x)
        true_sim = x @ x.T
        precisions = []
        for q in self.rng.choice(n, min(n_queries, n), replace=False):
            ts = true_sim[q].copy()
            ts[q] = -np.inf
            true_top = set(np.argsort(ts)[-k:].tolist())
            hits: dict[int, int] = {}
            for _ in range(n_runs):
                top, _ = self.simulate_retrieval(x, q, k)
                for idx in top:
                    hits[idx] = hits.get(idx, 0) + 1
            got = set(sorted(hits, key=lambda t: -hits[t])[:k])
            precisions.append(len(true_top & got) / k)
        return {"precision_at_k": float(np.mean(precisions)),
                "precision_std": float(np.std(precisions)), "k": k}

    # -- calibration (invert the formula from measured correlations) ---

    def calibrate(self, embeddings, actual_correlations: dict) -> float:
        """Fit c from measured (dim -> correlation) pairs
        (fhesim/calibrate.py measures them against the real backend)."""
        x = _normalize(np.asarray(embeddings, dtype=np.float64))
        _, _, vt = np.linalg.svd(x, full_matrices=False)
        ests = []
        for d, rho in actual_correlations.items():
            if not (0 < rho < 1):
                continue
            z = _normalize(x @ vt[:d].T)
            sims, _ = _pair_sims(z, 500, self.rng)
            s2 = float(np.var(sims))
            c2 = (s2 / rho ** 2 - s2) / d
            if c2 > 0:
                ests.append(np.sqrt(c2))
        if ests:
            self.c = float(np.mean(ests))
        return self.c

    # -- assessment ----------------------------------------------------

    @staticmethod
    def _assess(sim_std, rho):
        if sim_std < 0.01:
            return Compatibility.INCOMPATIBLE
        for thresh, level in ((0.95, Compatibility.EXCELLENT),
                              (0.85, Compatibility.GOOD),
                              (0.70, Compatibility.MARGINAL),
                              (0.50, Compatibility.POOR)):
            if rho >= thresh:
                return level
        return Compatibility.INCOMPATIBLE

    @staticmethod
    def _recommend(sim_std, rho, opt_dim, target):
        if sim_std < 0.01:
            return ("Similarity scores are nearly constant across this "
                    "corpus; encrypted retrieval cannot rank it.")
        dim = target or opt_dim
        if rho >= 0.90:
            return (f"SVD-compress to {dim} dims; predicted score "
                    f"correlation under encryption: {rho:.0%}.")
        if rho >= 0.70:
            return (f"Better at {opt_dim} dims (predicted {rho:.0%} "
                    f"score correlation).")
        if rho >= 0.50:
            return (f"Predicted correlation only {rho:.0%} — a larger "
                    f"ring (N) would lower the noise floor.")
        return (f"Predicted correlation {rho:.0%}; this configuration "
                f"needs different CKKS parameters or embeddings.")
