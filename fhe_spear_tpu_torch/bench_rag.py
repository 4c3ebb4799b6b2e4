"""End-to-end RAG benchmark of the port on one NVIDIA card: encrypted
retrieval, then device-client generation on the retrieved passage.

    python -m fhe_spear_tpu_torch.bench_rag

The port's counterpart of the root `bench_rag.py`, with the same
environment knobs and the same one-line JSON schema on stdout (progress
on stderr), plus the card's name and the peak device memory in `detail`:

  RAG_DOCS / RAG_QUERIES        corpus size / timed queries (2000 / 3)
  BENCH_D / BENCH_F / BENCH_N   generation widths (2048 / 8192 / 8192)
  BENCH_BLOCKS                  generation depth (24)
  BENCH_TOKENS                  steady tokens after one warm-up (3)
  FHE_PREENC_CACHE              pre-encoded diagonal cache directory

Passages come from the MS-MARCO SFT file when the checkout has one
(`apps.demo.load_msmarco_sft`); otherwise a synthetic corpus is made, as
the root entry does.  Retrieval is row-packed CT-CT at N=8192, dim 64;
its quality is anchored by the encrypted top-1 agreeing with the
plaintext top-1.  The generation model is `make_random_model(seed=42)`,
the context `CkksParams(n, 3, 1)` at seed 0; the prompt (the first
passage and question) is prefilled in plaintext.  Caches go under
`build/` of the checkout.  It runs on the card and raises without one;
`main(device="cpu")` runs the plain torch path (tests, tiny sizes).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from .bench_common import CACHE_ROOT, device_name, load_or_make_model, log

BASELINE_S = 429.0   # the reference paper's s/token of its RAG demo


def main(device="cuda"):
    import torch

    from .core.ntt import require_device

    device = require_device(device)
    n_docs = int(os.environ.get("RAG_DOCS", "2000"))
    n_queries = int(os.environ.get("RAG_QUERIES", "3"))
    d = int(os.environ.get("BENCH_D", "2048"))
    f = int(os.environ.get("BENCH_F", "8192"))
    n = int(os.environ.get("BENCH_N", "8192"))
    num_blocks = int(os.environ.get("BENCH_BLOCKS", "24"))
    num_tokens = int(os.environ.get("BENCH_TOKENS", "3"))
    log(f"device: {device_name(device)}")

    from .apps.demo import FheSpearRetriever, load_msmarco_sft
    from .apps.rag import _toy_tokenize
    from .ckks import CkksContext, CkksParams
    from .models.device_client import run_generation_device

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    # --- phase 1: encrypted retrieval -----------------------------------
    passages, questions = load_msmarco_sft(n=n_docs)
    if not passages:
        log("MS-MARCO data unavailable; synthesizing corpus")
        passages = [f"Document {i} text about topic {i % 97}."
                    for i in range(n_docs)]
        questions = [f"What is topic {i % 97}?" for i in range(n_docs)]
    log(f"corpus: {len(passages)} passages")

    t0 = time.perf_counter()
    ret_ctx = CkksContext(CkksParams.retrieval(n=8192), seed=0,
                          device=device)
    retr = FheSpearRetriever(ret_ctx, dim=64, mode="row")
    retr.index(passages)
    t_index = time.perf_counter() - t0
    log(f"index + encrypt corpus: {t_index:.1f}s")

    ret_times, rank_agree = [], 0
    for qi in range(n_queries):
        q = questions[qi]
        t0 = time.perf_counter()
        hits = retr.query(q, k=1)
        ret_times.append(time.perf_counter() - t0)
        top_plain = int(np.argmax(retr.plaintext_scores(q)))
        rank_agree += int(hits[0][0] == top_plain)
        log(f"query {qi}: retrieved #{hits[0][0]} "
            f"(plain {top_plain}) {ret_times[-1]:.3f}s")
    ret_s = float(np.median(ret_times))
    del retr, ret_ctx

    # --- phase 2: device-client generation on the retrieved passage,
    # the recurrent state prefilled in plaintext ------------------------
    model = load_or_make_model(d, f, num_blocks)
    t0 = time.perf_counter()
    gen_ctx = CkksContext(CkksParams(n=n, num_limbs=3, num_special=1),
                          seed=0, device=device)
    log(f"generation context ({time.perf_counter() - t0:.1f}s)")

    prompt = _toy_tokenize(passages[0] + " " + questions[0],
                           model.emb.shape[0])
    log(f"prompt: {len(prompt)} tokens (passage prefill, plaintext)")
    results = run_generation_device(
        gen_ctx, model, seed_tokens=prompt, num_tokens=num_tokens + 1,
        level=3, cache_dir=os.environ.get(
            "FHE_PREENC_CACHE", str(CACHE_ROOT / "fhe_preenc_cache")),
        log_fn=log)
    steady = [r["sec"] for r in results[1:]]
    s_token = float(np.median(steady))
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else None)

    line = {
        "metric": f"e2e RAG: encrypted retrieval ({len(passages)} docs) + "
                  f"{num_blocks}-block device-client generation "
                  f"D={d} F={f} N={n}",
        "value": round(s_token, 3),
        "unit": "s/token (+ retrieval)",
        "vs_baseline": round(BASELINE_S / s_token, 3),
        "detail": {
            "retrieval_s": round(ret_s, 4),
            "index_s": round(t_index, 1),
            "rank_agree": f"{rank_agree}/{n_queries}",
            "tokens_match_plaintext": all(r["match"] for r in results),
            "min_logit_corr": min(r["corr"] for r in results),
            "prompt_tokens_prefilled": len(prompt),
            "reference": "ret 1.0 s + 429 s/token at d=2048 (A100)",
            "device": device_name(device),
            "peak_device_memory_gib": peak,
        },
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
