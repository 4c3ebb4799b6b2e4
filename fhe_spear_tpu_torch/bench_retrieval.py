"""Encrypted-retrieval benchmark of the port: column-packed CT-CT scoring
time per document against corpus size, on one NVIDIA card.

    python -m fhe_spear_tpu_torch.bench_retrieval

The port's counterpart of the root `bench_retrieval.py`, with the same
environment knobs and the same one-line JSON schema on stdout (progress
on stderr), plus the card's name and the peak device memory in `detail`:

  BENCH_N       ring dimension (default 8192)
  BENCH_DIM     embedding dimension (default 64, Lorentz-lifted)
  BENCH_SIZES   comma-separated corpus sizes (default 1000,10000,50000)

Documents and queries are seeded random unit vectors (`RandomState(0)`),
the context `CkksParams.retrieval(n)` at seed 0.  `score_ms` is the
server-side scoring of one query against the whole corpus after one
warm-up call, host clock around work that ends in a device synchronize.
It runs on the card and raises without one; `main(device="cpu")` runs the
plain torch path (tests, tiny sizes).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from .bench_common import device_name, log

REF_US_PER_DOC = 630e3 / 50e3   # the reference paper's A100: 50k docs, 630 ms


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(device="cuda"):
    import torch

    from .core.ntt import require_device

    device = require_device(device)
    n = int(os.environ.get("BENCH_N", "8192"))
    dim = int(os.environ.get("BENCH_DIM", "64"))
    sizes = [int(s) for s in os.environ.get(
        "BENCH_SIZES", "1000,10000,50000").split(",")]
    log(f"device: {device_name(device)}")

    from .ckks import CkksContext, CkksParams
    from .ops.packing import euclidean_to_lorentz, lorentz_inner
    from .ops.retrieval import ColumnPackedRetrieval

    t0 = time.perf_counter()
    ctx = CkksContext(CkksParams.retrieval(n=n), seed=0, device=device)
    log(f"context ({time.perf_counter() - t0:.1f}s)")
    eng = ColumnPackedRetrieval(ctx, dim=dim, lorentz=True)

    rng = np.random.RandomState(0)
    rows = []
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for n_docs in sizes:
        docs = rng.rand(n_docs, dim) * 2 - 1
        docs /= np.linalg.norm(docs, axis=1, keepdims=True)
        q = rng.rand(dim) * 2 - 1
        q /= np.linalg.norm(q)
        t0 = time.perf_counter()
        corpus = eng.encrypt_corpus(docs)
        _sync(device)
        t_enc = time.perf_counter() - t0
        qct = eng.encrypt_query(q)
        # warm-up, then measure the server-side scoring alone
        ct = eng.scores(corpus, qct)
        _sync(device)
        t0 = time.perf_counter()
        ct = eng.scores(corpus, qct)
        _sync(device)
        t_score = time.perf_counter() - t0
        scores = eng.decode_scores(ct, n_docs)
        true = lorentz_inner(euclidean_to_lorentz(q),
                             euclidean_to_lorentz(docs))
        exact = int(np.argmax(scores) == np.argmax(true))
        corr = float(np.corrcoef(scores, true)[0, 1])
        rows.append({"docs": n_docs, "score_ms": t_score * 1e3,
                     "us_per_doc": t_score * 1e6 / n_docs,
                     "encrypt_s": t_enc, "top1_exact": exact, "corr": corr})
        log(f"{n_docs} docs: score {t_score * 1e3:.1f} ms "
            f"({t_score * 1e6 / n_docs:.2f} us/doc), corr {corr:.6f}")
        del corpus, ct

    last = rows[-1]
    line = {
        "metric": f"CT-CT retrieval us/doc at {last['docs']} docs "
                  f"({dim}d Lorentz, N={n})",
        "value": round(last["us_per_doc"], 3),
        "unit": "us/doc",
        "vs_baseline": round(REF_US_PER_DOC / last["us_per_doc"], 2),
        "detail": {
            "rows": rows,
            "device": device_name(device),
            "peak_device_memory_gib": (
                torch.cuda.max_memory_allocated(device) / 2 ** 30
                if device.type == "cuda" else None),
        },
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
