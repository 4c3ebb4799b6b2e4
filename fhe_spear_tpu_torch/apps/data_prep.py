"""Dataset preparation: SQuAD-format JSON to the SFT JSONL the retrieval
benchmarks read, and the gold + distractor corpus construction.  The
port's own copy of `fhe_spear_tpu/apps/data_prep.py` (json/numpy only).

These functions read local files only; nothing is downloaded:
  * squad_to_sft: convert a local SQuAD-format JSON into the
    Context:/Question:/Answer: SFT JSONL the retrieval benchmarks consume.
  * load_sft: parse SFT JSONL into (passages, questions, answers).
  * build_retrieval_corpus: (gold passage index, question) query pairs.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

__all__ = ["squad_to_sft", "load_sft", "build_retrieval_corpus"]


def squad_to_sft(squad_json: str, out_jsonl: str, max_samples: int = 5000
                 ) -> int:
    """SQuAD v1/v2 JSON -> SFT JSONL."""
    with open(squad_json) as f:
        data = json.load(f)
    n = 0
    with open(out_jsonl, "w") as out:
        for article in data.get("data", []):
            for para in article.get("paragraphs", []):
                ctx = para.get("context", "").strip()
                for qa in para.get("qas", []):
                    if qa.get("is_impossible"):
                        continue
                    answers = qa.get("answers") or []
                    if not answers:
                        continue
                    rec = {"text": f"Context: {ctx}\nQuestion: "
                                   f"{qa['question'].strip()}\nAnswer: "
                                   f"{answers[0]['text'].strip()}"}
                    out.write(json.dumps(rec) + "\n")
                    n += 1
                    if n >= max_samples:
                        return n
    return n


def load_sft(path: str, n: int = 100):
    """SFT JSONL -> (passages, questions, answers)."""
    passages, questions, answers = [], [], []
    if not os.path.exists(path):
        return passages, questions, answers
    with open(path) as f:
        for line in f:
            if len(passages) >= n:
                break
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            m = re.search(r"Context:\s*(.*?)\s*Question:\s*(.*?)\s*Answer:"
                          r"\s*(.*)", rec.get("text", ""), re.S)
            if m:
                passages.append(m.group(1).strip())
                questions.append(m.group(2).strip())
                answers.append(m.group(3).strip())
    return passages, questions, answers


def build_retrieval_corpus(passages, questions, n_queries=10, seed=0):
    """Gold + distractor corpus construction: every passage is a corpus
    doc; each query's gold index is its own passage."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(questions))[:n_queries]
    return [(int(i), questions[int(i)]) for i in idx]
