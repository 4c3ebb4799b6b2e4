"""End-to-end encrypted RAG: encrypted retrieval -> client-aided FHE
generation with plaintext prefill.

Counterpart of `fhe_spear_tpu/apps/rag.py`.  Pipeline:
  1. embed the corpus (pluggable embedder; hashed bag-of-words fallback),
     SVD-compress to 64d, Lorentz-lift, complex-pack, encrypt;
  2. encrypted retrieval of the top passage (CT-PT or CT-CT);
  3. prefill the RWKV-7 state on the retrieved context in plaintext
     (recurrent state, no FHE cost);
  4. generate answer tokens under FHE (`FheRwkvServer`/`FheRwkvClient`),
     each checked against the plaintext twin.

Without model weights the generation model is the seeded random RWKV-7
(FHE correctness is weight-independent); pass a checkpoint path to use a
real model.  Both contexts live on `device` (the card by default).
"""

from __future__ import annotations

import hashlib
import time

import numpy as np

from ..ckks import CkksContext, CkksParams
from ..models.client_aided import FheRwkvClient, FheRwkvServer
from ..models.rwkv7 import generate_token_plaintext, load_torch_model, \
    make_random_model
from .demo import FheSpearRetriever

__all__ = ["EncryptedRag"]


def _toy_tokenize(text: str, vocab: int) -> list[int]:
    """Deterministic stand-in tokenizer (hash words into the vocab)."""
    return [int.from_bytes(hashlib.blake2b(w.encode(), digest_size=4)
                           .digest(), "little") % vocab
            for w in text.split()][:64] or [0]


class EncryptedRag:
    def __init__(self, passages: list[str], dim: int = 64,
                 retrieval_mode: str = "row", d: int = 64, f: int = 256,
                 n_blocks: int = 2, gen_n: int = 2048,
                 weights: str | None = None, embed_fn=None, seed: int = 0,
                 device="cuda"):
        self.retriever = FheSpearRetriever(
            CkksContext(CkksParams.retrieval(n=2048), seed=seed,
                        device=device),
            dim=dim, mode=retrieval_mode, embed_fn=embed_fn)
        self.retriever.index(passages)
        if weights:
            self.model = load_torch_model(weights, d, f, n_blocks)
        else:
            self.model = make_random_model(d=d, f=f, n_blocks=n_blocks,
                                           head_size=min(16, d), seed=seed + 1)
        self.gen_ctx = CkksContext(CkksParams.client_aided(n=gen_n),
                                   seed=seed + 2, device=device)
        self.server = FheRwkvServer(self.gen_ctx, self.model, level=3)
        self.client = FheRwkvClient(self.gen_ctx, self.model, self.server)

    def answer(self, question: str, num_tokens: int = 3, verbose: bool = True
               ) -> dict:
        t0 = time.perf_counter()
        hits = self.retriever.query(question, k=1)
        t_ret = time.perf_counter() - t0
        idx, score, passage = hits[0]
        if verbose:
            print(f"  retrieved #{idx} (score {score:.4f}) in {t_ret:.2f}s")

        vocab = self.model.emb.shape[0]
        prompt = _toy_tokenize(passage + " " + question, vocab)
        state_fhe = self.model.zero_state()
        state_ref = self.model.zero_state()
        t0 = time.perf_counter()
        for tok in prompt[:-1]:
            _, state_fhe = generate_token_plaintext(self.model, tok, state_fhe)
            _, state_ref = generate_token_plaintext(self.model, tok, state_ref)
        t_prefill = time.perf_counter() - t0

        tok_f = tok_r = prompt[-1]
        out, ref, secs = [], [], []
        for _ in range(num_tokens):
            logits_r, state_ref = generate_token_plaintext(
                self.model, tok_r, state_ref)
            t0 = time.perf_counter()
            logits_f, state_fhe, _ = self.client.generate_token(
                tok_f, state_fhe)
            secs.append(time.perf_counter() - t0)
            tok_r = int(np.argmax(logits_r))
            tok_f = int(np.argmax(logits_f))
            out.append(tok_f)
            ref.append(tok_r)
        matches = sum(a == b for a, b in zip(out, ref))
        if verbose:
            print(f"  prefill {len(prompt) - 1} tok {t_prefill:.2f}s; "
                  f"generated {num_tokens} tok in {sum(secs):.2f}s "
                  f"({matches}/{num_tokens} match plaintext)")
        return {"passage_idx": idx, "tokens": out, "plaintext_tokens": ref,
                "token_matches": matches, "num_tokens": num_tokens,
                "retrieval_s": t_ret, "prefill_s": t_prefill,
                "generation_s": sum(secs), "token_s": secs}
