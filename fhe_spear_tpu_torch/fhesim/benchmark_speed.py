"""Simulator-vs-real-encryption speed benchmark: wall-clock for scoring a
corpus with the Gaussian simulator vs the port's real CT-CT column-packed
engine at several ring dimensions.  Counterpart of
`fhe_spear_tpu/fhesim/benchmark_speed.py`.

Both sides are timed on their second call (the JAX package's times the
simulator's first, which on a 50k-doc corpus measures numpy's first-use
cost more than the simulator).  The real side is timed from a
synchronised device to the decoded scores (scoring, then decryption and
decode on the host); on the card the clock starts after
`torch.cuda.synchronize()`, so no queued work of the set-up is counted,
and the decode's copy to the host waits for the scoring.
"""

from __future__ import annotations

import time

import numpy as np

from .simulator import FheAccuracySimulator, _normalize

__all__ = ["run"]


def _sync(ctx):
    if ctx.device.type == "cuda":
        import torch

        torch.cuda.synchronize(ctx.device)


def run(ns=(2048, 4096), n_docs=256, dim=32, seed=0, verbose=True,
        device="cuda"):
    """Rows {"n", "sim_s", "real_s", "speedup"} per ring n; the real side
    runs on `device` (each side: one warm-up call, then one timed call)."""
    from ..ckks import CkksContext, CkksParams
    from ..ops.retrieval import ColumnPackedRetrieval

    rng = np.random.default_rng(seed)
    docs = _normalize(rng.normal(0, 1, (n_docs, dim)))
    q = _normalize(rng.normal(0, 1, dim))
    rows = []
    for n in ns:
        sim = FheAccuracySimulator(poly_modulus_degree=n, seed=seed)
        sim.simulate_scores(q, docs)                        # warm-up
        t0 = time.perf_counter()
        sim.simulate_scores(q, docs)
        t_sim = time.perf_counter() - t0

        ctx = CkksContext(CkksParams(n=n, num_limbs=3, num_special=1),
                          seed=seed, device=device)
        eng = ColumnPackedRetrieval(ctx, dim=dim, lorentz=False)
        corpus = eng.encrypt_corpus(docs)
        qct = eng.encrypt_query(q)
        eng.decode_scores(eng.scores(corpus, qct), n_docs)  # warm-up
        _sync(ctx)
        t0 = time.perf_counter()
        eng.decode_scores(eng.scores(corpus, qct), n_docs)
        _sync(ctx)
        t_real = time.perf_counter() - t0
        rows.append({"n": n, "sim_s": t_sim, "real_s": t_real,
                     "speedup": t_real / max(t_sim, 1e-9)})
        if verbose:
            print(f"  N={n}: simulator {t_sim * 1e3:.2f} ms, "
                  f"real {t_real * 1e3:.1f} ms, "
                  f"{rows[-1]['speedup']:.0f}x faster")
        del corpus, qct, eng, ctx
    return rows


if __name__ == "__main__":
    run()
