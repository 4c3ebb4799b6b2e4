"""Self-contained encrypted-retrieval demo and dataset loader.

Counterpart of `fhe_spear_tpu/apps/demo.py`.  The default embedder is a
deterministic hashed bag-of-words projection (no network, no model
download); the retrieval pipeline -- SVD compression, Lorentz lift,
complex packing, CT-PT/CT-CT scoring on the card -- is the same for any
embedder passed as `embed_fn`.

Every entry point runs on the card (`device="cuda"`) unless the caller
passes `device="cpu"`.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from pathlib import Path

import numpy as np

from ..ckks import CkksContext, CkksParams
from ..ops.packing import euclidean_to_lorentz, lorentz_inner
from ..ops.retrieval import ColumnPackedRetrieval, RowPackedRetrieval

__all__ = ["hashed_embed", "svd_compress", "FheSpearRetriever",
           "load_msmarco_sft", "run_demo", "recall_benchmark"]

# the MS-MARCO SFT file at the reference dataset's own relative path,
# inside this checkout
MSMARCO_SFT = Path(__file__).resolve().parents[2] / "data" / "msmarco_sft.jsonl"


def hashed_embed(texts, dim: int = 256) -> np.ndarray:
    """Deterministic hashed bag-of-words embeddings (demo fallback)."""
    out = np.zeros((len(texts), dim))
    for i, t in enumerate(texts):
        for tok in re.findall(r"[a-z0-9]+", t.lower()):
            h = int.from_bytes(hashlib.blake2b(tok.encode(), digest_size=8)
                               .digest(), "little")
            out[i, h % dim] += 1.0 + (h >> 32) % 7 * 0.1
    return out / (np.linalg.norm(out, axis=1, keepdims=True) + 1e-9)


def svd_compress(embs: np.ndarray, dim: int):
    """SVD projection to `dim` (corpus-side compression).  Returns
    (compressed, projection)."""
    _, _, vt = np.linalg.svd(embs, full_matrices=False)
    proj = vt[:dim].T
    z = embs @ proj
    return z / (np.linalg.norm(z, axis=-1, keepdims=True) + 1e-9), proj


class FheSpearRetriever:
    """End-to-end encrypted retriever: embed -> compress -> Lorentz ->
    pack -> encrypted scores, in row- or column-packed mode."""

    def __init__(self, ctx: CkksContext | None = None, dim: int = 64,
                 mode: str = "row", lorentz: bool = True, embed_fn=None,
                 device="cuda"):
        """ctx None: `CkksParams(n=8192, num_limbs=3, num_special=1)` at
        seed 0 on `device`."""
        self.ctx = ctx or CkksContext(
            CkksParams(n=8192, num_limbs=3, num_special=1), seed=0,
            device=device)
        self.dim = dim
        self.embed_fn = embed_fn or hashed_embed
        cls = RowPackedRetrieval if mode == "row" else ColumnPackedRetrieval
        self.eng = cls(self.ctx, dim, lorentz=lorentz)
        self.mode = mode

    def index(self, passages: list[str], encrypted: bool = True):
        self.passages = passages
        embs = self.embed_fn(passages)
        self.z, self.proj = svd_compress(embs, self.dim)
        if self.z.shape[-1] < self.dim:     # rank-limited tiny corpora
            pad = self.dim - self.z.shape[-1]
            self.z = np.pad(self.z, [(0, 0), (0, pad)])
            self.proj = np.pad(self.proj, [(0, 0), (0, pad)])
        if self.mode == "row":
            self._corpus = (self.eng.encrypt_docs(self.z) if encrypted
                            else self.eng.encode_docs(self.z))
        else:
            self._corpus = self.eng.encrypt_corpus(self.z)
        self._encrypted = encrypted
        return self

    def _embed_query(self, text: str) -> np.ndarray:
        q = self.embed_fn([text])[0] @ self.proj
        return q / (np.linalg.norm(q) + 1e-9)

    def scores(self, text: str) -> np.ndarray:
        """Decrypted encrypted scores of every indexed passage."""
        q = self._embed_query(text)
        if self.mode == "row":
            qct = self.eng.encrypt_query(q)
            ct = (self.eng.scores_ctct(qct, self._corpus) if self._encrypted
                  else self.eng.scores_ctpt(qct, self._corpus))
        else:
            ct = self.eng.scores(self._corpus, self.eng.encrypt_query(q))
        return self.eng.decode_scores(ct, len(self.passages))

    def query(self, text: str, k: int = 3):
        scores = self.scores(text)
        top = np.argsort(scores)[::-1][:k]
        return [(int(i), float(scores[i]), self.passages[i]) for i in top]

    def plaintext_scores(self, text: str) -> np.ndarray:
        q = self._embed_query(text)
        return lorentz_inner(euclidean_to_lorentz(q),
                             euclidean_to_lorentz(self.z))


def load_msmarco_sft(path: str | os.PathLike | None = None, n: int = 100):
    """Parse the Context:/Question: SFT format of the MS-MARCO SFT file
    (one JSON record a line).  path None: `data/msmarco_sft.jsonl` in this
    checkout.  A missing file gives empty lists (callers fall back to
    synthetic passages)."""
    path = MSMARCO_SFT if path is None else Path(path)
    passages, questions = [], []
    if not os.path.exists(path):
        return passages, questions
    with open(path) as f:
        for line in f:
            if len(passages) >= n:
                break
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            text = rec.get("text", "")
            m = re.search(r"Context:\s*(.*?)\s*Question:\s*(.*?)\s*Answer:",
                          text, re.S)
            if m:
                passages.append(m.group(1).strip())
                questions.append(m.group(2).strip())
    return passages, questions


def run_demo(n_docs: int = 64, mode: str = "row", verbose: bool = True,
             device="cuda"):
    """Retrieval over the MS-MARCO SFT passages (or a synthetic corpus),
    encrypted vs plaintext ranking.  Returns (agreements, queries)."""
    passages, questions = load_msmarco_sft(n=n_docs)
    if not passages:
        passages = [f"synthetic passage number {i} about topic {i % 7}"
                    for i in range(n_docs)]
        questions = ["synthetic passage about topic 3"]
    r = FheSpearRetriever(mode=mode, device=device).index(passages[:n_docs])
    agree = 0
    n_q = min(10, len(questions))
    for qt in questions[:n_q]:
        enc_top = r.query(qt, k=1)[0][0]
        plain_top = int(np.argmax(r.plaintext_scores(qt)))
        agree += enc_top == plain_top
        if verbose:
            print(f"  q='{qt[:50]}...' enc_top={enc_top} plain_top={plain_top}")
    if verbose:
        print(f"  encrypted ranking agrees with plaintext: {agree}/{n_q}")
    return agree, n_q


def recall_benchmark(n_docs: int = 200, n_queries: int = 20, dim: int = 64,
                     mode: str = "column", n: int = 2048, seed: int = 0,
                     verbose: bool = True, device="cuda"):
    """Recall@k of encrypted vs plaintext retrieval over the MS-MARCO SFT
    passages (gold = each question's own context passage).  Without the
    file, synthetic passages whose gold is the passage itself.

    Reports R@1/5/10 for the encrypted engine and agreement with the
    plaintext ranking (which isolates FHE noise from embedding quality).
    """
    passages, questions = load_msmarco_sft(n=n_docs)
    if not passages:
        passages = [f"synthetic topic {i % 29} passage {i}"
                    for i in range(n_docs)]
        questions = [passages[i] for i in range(min(n_queries, n_docs))]
    ctx = CkksContext(CkksParams.retrieval(n=n), seed=seed, device=device)
    r = FheSpearRetriever(ctx, dim=dim, mode=mode).index(passages[:n_docs])

    ranks_enc, agree1 = [], 0
    n_q = min(n_queries, len(questions))
    for qi in range(n_q):
        q = questions[qi]
        order = np.argsort(r.scores(q))[::-1]
        ranks_enc.append(int(np.where(order == qi)[0][0]) + 1)
        agree1 += int(order[0] == int(np.argmax(r.plaintext_scores(q))))

    ranks = np.asarray(ranks_enc)
    out = {"recall@1": float((ranks <= 1).mean()),
           "recall@5": float((ranks <= 5).mean()),
           "recall@10": float((ranks <= 10).mean()),
           "plaintext_top1_agreement": agree1 / n_q,
           "n_docs": len(r.passages), "n_queries": n_q, "dim": dim}
    if verbose:
        print(f"  R@1={out['recall@1']:.2f} R@5={out['recall@5']:.2f} "
              f"R@10={out['recall@10']:.2f} (enc-vs-plain top1 agreement "
              f"{out['plaintext_top1_agreement']:.2f})")
    return out
