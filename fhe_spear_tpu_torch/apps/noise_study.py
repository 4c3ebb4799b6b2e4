"""Per-passage vs per-class noise leak study.

Counterpart of `fhe_spear_tpu/apps/noise_study.py`.  Quantifies WHY
access-control noise must be drawn per passage:

  * Per-class (shared n_c) noise cancels in within-class score
    DIFFERENCES: for passages i, j with the same class set,
    score(q, d_i + n) - score(q, d_j + n) = score(q, d_i) - score(q, d_j)
    exactly -- an unauthorized user recovers the within-class ranking
    (difference correlation 1.0).
  * Per-passage (independent n_i) noise adds an O(alpha * avg_norm)
    random term to every difference, destroying the ordering
    (correlation ~ 0, noise/signal ~ 1000x at alpha = 100).
  * Per-passage corrections Enc(-n_i) restore authorized retrieval
    exactly (R@1 preserved under real encryption).

run_leak_study() is pure numpy (the leak is a property of the noise
algebra, not of encryption); run_fhe_restore() checks the authorized
path end to end under real CKKS via AccessControlledCorpus.
"""

from __future__ import annotations

import numpy as np

from .access_control import AccessControlledCorpus

__all__ = ["run_leak_study", "run_fhe_restore"]


def _packed_docs(rng, n_docs, dim):
    z = rng.standard_normal((n_docs, dim)) + 1j * rng.standard_normal(
        (n_docs, dim))
    return z / np.linalg.norm(z, axis=-1, keepdims=True)


def run_leak_study(n_docs: int = 48, dim: int = 33, n_queries: int = 32,
                   alpha: float = 100.0, seed: int = 7) -> dict:
    """The two difference-correlation experiments.  Returns
    {class_diff_corr (~1.0), passage_diff_corr (~0), noise_to_signal}."""
    rng = np.random.default_rng(seed)
    docs = _packed_docs(rng, n_docs, dim)
    avg_norm = float(np.mean([np.linalg.norm(d) for d in docs]))

    # every doc in the SAME single class: the worst case for leakage
    def cplx(shape):
        z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return z / np.abs(z).mean() * alpha * avg_norm

    class_noise = cplx(dim)
    noised_class = docs + class_noise[None, :]

    passage_noise = cplx((n_docs, dim))
    noised_passage = docs + passage_noise

    queries = _packed_docs(rng, n_queries, dim)

    def diffs(noised):
        td, nd = [], []
        for q in queries:
            ts = np.real(docs @ q)
            ns = np.real(noised @ q)
            for a in range(n_docs):
                for b in range(a + 1, n_docs):
                    td.append(ts[a] - ts[b])
                    nd.append(ns[a] - ns[b])
        return np.asarray(td), np.asarray(nd)

    td_c, nd_c = diffs(noised_class)
    td_p, nd_p = diffs(noised_passage)

    return {
        "class_diff_corr": float(np.corrcoef(td_c, nd_c)[0, 1]),
        "class_max_abs_err": float(np.abs(td_c - nd_c).max()),
        "passage_diff_corr": float(np.corrcoef(td_p, nd_p)[0, 1]),
        "noise_to_signal": float(np.std(nd_p) / np.std(td_p)),
        "n_pairs": len(td_c),
    }


def run_fhe_restore(ctx, n_docs: int = 24, dim: int = 16, seed: int = 11
                    ) -> dict:
    """Authorized retrieval with per-passage corrections under REAL CKKS:
    R@1 must match plaintext exactly; the unauthorized view must not."""
    rng = np.random.default_rng(seed)
    docs = rng.standard_normal((n_docs, dim))
    docs /= np.linalg.norm(docs, axis=-1, keepdims=True)
    classes = [{"financial"} for _ in range(n_docs)]

    corpus = AccessControlledCorpus(ctx, dim=dim, per_passage=True,
                                    lorentz=False, seed=seed)
    corpus.build(docs, classes)

    q = docs[0] + 0.1 * rng.standard_normal(dim)
    q /= np.linalg.norm(q)
    true_scores = docs @ q
    want = int(np.argmax(true_scores))

    auth = corpus.retrieve(q, corpus.apply_corrections(
        corpus.corrections_for({"financial"})))
    unauth = corpus.retrieve(q, corpus.apply_corrections(
        corpus.corrections_for(set())))

    return {
        "true_top1": want,
        "auth_top1": int(np.argmax(auth)),
        "unauth_top1": int(np.argmax(unauth)),
        "auth_score_corr": float(np.corrcoef(auth, true_scores)[0, 1]),
        "unauth_score_corr": float(np.corrcoef(unauth, true_scores)[0, 1]),
    }


def main(device="cuda"):
    import json

    res = run_leak_study()
    print("leak study (plaintext algebra):")
    print(json.dumps(res, indent=2))

    from ..ckks import CkksContext, CkksParams

    ctx = CkksContext(CkksParams.retrieval(n=2048), seed=0, device=device)
    fhe = run_fhe_restore(ctx)
    print("FHE restore:")
    print(json.dumps(fhe, indent=2))


if __name__ == "__main__":
    main()
