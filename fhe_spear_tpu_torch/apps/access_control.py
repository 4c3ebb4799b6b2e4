"""FHE-native per-user access control via additive noise cancellation.

Counterpart of `fhe_spear_tpu/apps/access_control.py`.  Pipeline:
classify passages into sensitivity classes (regex PII detection) -> add
per-class complex noise to the packed embeddings before encryption ->
store Enc(e_j + sum_c n_c).  A user authorized for class c receives
Enc(-n_c) corrections (else an indistinguishable random dummy), which the
server applies with plain homomorphic additions -- zero levels consumed,
ciphertext level unchanged -- before CT-CT retrieval.

Per-passage mode: class-shared noise leaks within-class score
*differences*; drawing independent noise per passage destroys the ordering
for unauthorized users while per-passage corrections restore it exactly.

Noise, corrections and scores are batched tensors; the noise and the
dummies come from `default_rng(seed)` in the reference's draw order, so a
seeded corpus holds the reference's score ciphertexts word for word.
Every transform of the path (encryption, the CT-CT relinearization and
rescale, decryption) runs kernels K1/K2 on the card; generation goes
through the client-aided client given to it.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from ..ckks.context import CkksContext
from ..ckks.ciphertext import Ciphertext
from ..ops.packing import euclidean_to_lorentz, pack_complex
from ..ops.retrieval import RowPackedRetrieval

__all__ = ["classify_passage", "detect_pii", "AccessControlledCorpus",
           "SENSITIVITY_CLASSES", "generate_on_retrieved",
           "generation_demo"]

PII_PATTERNS = {
    "SSN": re.compile(r"\b\d{3}-\d{2}-\d{4}\b"),
    "PHONE": re.compile(r"\b(?:\+1[-.]?)?\(?\d{3}\)?[-.\s]?\d{3}[-.\s]?\d{4}\b"),
    "EMAIL": re.compile(r"\b[A-Za-z0-9._%+-]+@[A-Za-z0-9.-]+\.[A-Za-z]{2,}\b"),
    "DATE": re.compile(r"\b(?:January|February|March|April|May|June|July|"
                       r"August|September|October|November|December)"
                       r"\s+\d{1,2},?\s+\d{4}\b"),
    "MONEY": re.compile(r"\$[\d,]+(?:\.\d{2})?(?:\s*(?:million|billion|trillion))?"),
    "PERCENT": re.compile(r"\b\d+(?:\.\d+)?%"),
    "YEAR_EVENT": re.compile(r"\b(?:in|since|from|until|after|before|during)\s+\d{4}\b"),
    "ORG_PAREN": re.compile(r"\b[A-Z][a-z]+(?:\s+[A-Z][a-z]+)*\s+\([A-Z]{2,}\)"),
    "MEDICAL_STAT": re.compile(r"\b\d+(?:\.\d+)?%\s*(?:to\s+\d+(?:\.\d+)?%\s*)?"
                               r"of\s+(?:men|women|patients|people|adults|children)",
                               re.I),
    "DOSAGE": re.compile(r"\b\d+(?:\.\d+)?\s*(?:mg|IU|mL|mcg|g/dL|mmHg)\b"),
}

CLASS_MAP = {
    "MONEY": "financial", "PERCENT": "financial",
    "SSN": "personal", "PHONE": "personal", "EMAIL": "personal",
    "DATE": "temporal", "YEAR_EVENT": "temporal",
    "ORG_PAREN": "organizational",
    "MEDICAL_STAT": "medical", "DOSAGE": "medical",
}

SENSITIVITY_CLASSES = sorted(set(CLASS_MAP.values()))


def detect_pii(text: str):
    """PII spans with overlapping matches merged (type names joined with
    '+', text extended): an overlapping span that extends the current one
    grows it; a fully-contained overlap is dropped."""
    spans = []
    for kind, pat in PII_PATTERNS.items():
        spans += [{"type": kind, "start": m.start(), "end": m.end(),
                   "text": m.group()} for m in pat.finditer(text)]
    spans.sort(key=lambda s: s["start"])
    merged: list[dict] = []
    for span in spans:
        if merged and span["start"] < merged[-1]["end"]:
            if span["end"] > merged[-1]["end"]:
                merged[-1]["end"] = span["end"]
                merged[-1]["text"] = text[merged[-1]["start"]: merged[-1]["end"]]
                merged[-1]["type"] += "+" + span["type"]
        else:
            merged.append(dict(span))
    return merged


def classify_passage(text: str) -> set:
    """Sensitivity classes present in `text`.

    Merged spans carry '+'-joined type names (detect_pii), so each span
    contributes the classes of ALL its constituent types -- e.g. a
    "30% of patients" span merged as PERCENT+MEDICAL_STAT yields both
    financial and medical."""
    classes = set()
    for span in detect_pii(text):
        for kind in span["type"].split("+"):
            if kind in CLASS_MAP:
                classes.add(CLASS_MAP[kind])
    return classes


@dataclass
class AccessControlledCorpus:
    """Encrypted corpus with per-class (or per-passage) additive noise.

    Built once by the data owner; serves any number of users, each with a
    correction set matching their authorization.
    """

    ctx: CkksContext
    dim: int
    noise_scale: float = 100.0
    per_passage: bool = False
    lorentz: bool = True
    seed: int = 0

    def __post_init__(self):
        self.eng = RowPackedRetrieval(self.ctx, self.dim, self.lorentz)
        self.rng = np.random.default_rng(self.seed)

    # -- owner side --------------------------------------------------------

    def build(self, docs: np.ndarray, passage_classes: list[set]):
        """Noise + encrypt the corpus; keeps noise secrets owner-side."""
        self.n_docs = len(docs)
        self.classes = sorted(set(c for cs in passage_classes for c in cs))
        self.passage_classes = passage_classes
        spd, dpc = self.eng.spd, self.eng.docs_per_ct
        packed, _ = self.eng._pack_docs(docs)          # [nb, slots]
        self.nb = packed.shape[0]

        def cplx_noise(shape):
            z = self.rng.standard_normal(shape) + 1j * self.rng.standard_normal(shape)
            return z / np.abs(z).mean() * self.noise_scale

        # noise layout matrix [nb, slots] per class (or per passage)
        self._noise = {}
        if self.per_passage:
            for i, cs in enumerate(passage_classes):
                if cs:
                    self._noise[i] = cplx_noise(spd)
        else:
            for c in self.classes:
                self._noise[c] = cplx_noise(spd)

        noised = packed.copy()
        for i, cs in enumerate(passage_classes):
            b, off = divmod(i, dpc)
            off *= spd
            if self.per_passage and cs:
                noised[b, off: off + spd] += self._noise[i]
            else:
                for c in cs:
                    noised[b, off: off + spd] += self._noise[c]
        # large noise magnitudes would overflow the 31-bit coefficient
        # bound at full scale; encode the corpus (and corrections, which
        # must share its scale for the homomorphic add) at a power-of-two
        # reduced scale.  Scale tracking keeps all downstream ops exact.
        mag = max(np.abs(noised.real).max(), np.abs(noised.imag).max(), 1.0)
        self._enc_scale = self.ctx.scale / 2.0 ** int(
            np.ceil(np.log2(max(mag / 2.0, 1.0))))
        self.encrypted = self.ctx.encrypt(noised, scale=self._enc_scale)
        return self.encrypted

    def corrections_for(self, authorized: set) -> Ciphertext:
        """Per-user correction ciphertexts [n_keys, nb, 2, l, N]: Enc(-n)
        where authorized, dummies elsewhere.

        Dummies are fresh samples from the SAME distribution as the noise
        itself (iid complex normal, mean-|.| normalized to noise_scale), so
        even the key-holding client cannot distinguish a decrypted dummy
        from a real correction by its per-slot statistics; before
        decryption, indistinguishability rests on ciphertext semantic
        security as usual."""
        spd, dpc = self.eng.spd, self.eng.docs_per_ct
        keys = (range(self.n_docs) if self.per_passage else self.classes)
        mats = []
        for key in keys:
            slots = np.zeros((self.nb, self.ctx.slots), dtype=np.complex128)
            for i, cs in enumerate(self.passage_classes):
                hit = (i == key and cs) if self.per_passage else (key in cs)
                if not hit:
                    continue
                b, off = divmod(i, dpc)
                off *= spd
                nv = self._noise[i if self.per_passage else key]
                ok = (cs <= authorized) if self.per_passage else (key in authorized)
                if ok:
                    slots[b, off: off + spd] = -nv
                else:
                    z = (self.rng.standard_normal(spd)
                         + 1j * self.rng.standard_normal(spd))
                    slots[b, off: off + spd] = (
                        z / np.abs(z).mean() * self.noise_scale)
            mats.append(slots)
        return self.ctx.encrypt(np.stack(mats), scale=self._enc_scale)

    # -- server side -------------------------------------------------------

    def apply_corrections(self, corrections: Ciphertext) -> Ciphertext:
        """Homomorphic adds; zero levels consumed, level unchanged."""
        ct = self.encrypted
        k = corrections.c.shape[0]
        out = ct
        for i in range(k):
            out = self.ctx.add(out, Ciphertext(corrections.c[i],
                                               corrections.scale))
        assert out.level == ct.level  # chain index unchanged
        return out

    def retrieve(self, query: np.ndarray, corrected: Ciphertext) -> np.ndarray:
        """CT-CT scores for one user's corrected corpus view."""
        qct = self.eng.encrypt_query(query)
        return self.eng.decode_scores(self.eng.scores_ctct(qct, corrected),
                                      self.n_docs)


def generate_on_retrieved(corpus: AccessControlledCorpus, passages: list,
                          query_vec: np.ndarray, question: str,
                          authorized: set, client, num_tokens: int = 3,
                          verbose: bool = False) -> dict:
    """One user's full pipeline tail: retrieve under the user's
    corrections, build a prompt from the retrieved passage's first
    sentence + the question, prefill the RWKV state in plaintext, then
    generate under FHE, verified token-exact vs the plaintext twin.

    `client` is a prepared models.client_aided.FheRwkvClient (share one
    across users -- the model/keys don't depend on the user)."""
    from ..models.rwkv7 import generate_token_plaintext
    from .rag import _toy_tokenize

    corrected = corpus.apply_corrections(corpus.corrections_for(authorized))
    scores = corpus.retrieve(query_vec, corrected)
    idx = int(np.argmax(scores))
    passage = passages[idx]
    first_sent = passage.split(".")[0] + "."
    prompt_text = f"{first_sent}\n{question}"

    model = client.model
    vocab = model.emb.shape[0]
    prompt = _toy_tokenize(prompt_text, vocab)
    state_fhe, state_ref = model.zero_state(), model.zero_state()
    for tok in prompt[:-1]:
        _, state_fhe = generate_token_plaintext(model, tok, state_fhe)
        _, state_ref = generate_token_plaintext(model, tok, state_ref)

    tok_f = tok_r = prompt[-1]
    out, matches = [], 0
    for _ in range(num_tokens):
        logits_r, state_ref = generate_token_plaintext(model, tok_r, state_ref)
        logits_f, state_fhe, _ = client.generate_token(tok_f, state_fhe)
        tok_r = int(np.argmax(logits_r))
        tok_f = int(np.argmax(logits_f))
        matches += tok_f == tok_r
        out.append(tok_f)
    if verbose:
        print(f"    retrieved #{idx}; tokens {out} "
              f"({matches}/{num_tokens} match plaintext)")
    return {"retrieved": idx, "tokens": out, "token_matches": matches,
            "num_tokens": num_tokens, "prompt": prompt_text}


def generation_demo(corpus: AccessControlledCorpus, passages: list,
                    query_vec: np.ndarray, question: str,
                    users: dict, client, num_tokens: int = 3,
                    verbose: bool = False) -> dict:
    """The Alice/Bob generation demo: each user retrieves under their own
    corrections and generates on THEIR retrieved passage; users with
    different authorization retrieve different passages and so generate
    different text.  Returns per-user results + outputs_differ."""
    results = {}
    for name, auth in users.items():
        if verbose:
            print(f"  {name} (authorized: {sorted(auth) or 'none'}):")
        results[name] = generate_on_retrieved(
            corpus, passages, query_vec, question, auth, client,
            num_tokens=num_tokens, verbose=verbose)
    toks = [r["tokens"] for r in results.values()]
    results["outputs_differ"] = any(t != toks[0] for t in toks[1:])
    return results


def security_sweep(corpus: AccessControlledCorpus, docs, passage_classes,
                   scales=(1, 10, 50, 100, 500), seed=123):
    """Authorized vs unauthorized score separation per noise scale --
    plaintext analysis, no encryption."""
    rng = np.random.default_rng(seed)
    eng = corpus.eng
    lifted = pack_complex(euclidean_to_lorentz(docs) if corpus.lorentz else docs)
    q = rng.standard_normal(lifted.shape[-1]) + 1j * rng.standard_normal(lifted.shape[-1])
    q /= np.linalg.norm(q)
    rows = []
    for scale in scales:
        auth, unauth = [], []
        for i, doc in enumerate(lifted):
            true = float(np.real(np.sum(q * doc)))
            auth.append(true)
            cs = passage_classes[i]
            if cs:
                key = i if corpus.per_passage else None
                nz = (corpus._noise[i] if corpus.per_passage
                      else sum(corpus._noise[c] for c in cs))
                nz = nz * (scale / corpus.noise_scale)
                unauth.append(float(np.real(np.sum(q * (doc + nz[:len(doc)])))))
        sep = (np.abs(unauth).mean() / (np.abs(auth).mean() + 1e-10)
               if unauth else 0.0)
        rows.append({"scale": scale, "separation": sep})
    return rows
