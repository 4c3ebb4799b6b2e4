"""Benchmark of the port: client-aided RWKV-7 token generation under CKKS on
one NVIDIA card.

    python -m fhe_spear_tpu_torch.bench

The port's counterpart of the root `bench.py`, with the same environment
knobs and the same one-line JSON schema on stdout (progress on stderr),
plus the card's name in `detail.device`:

  BENCH_D / BENCH_F / BENCH_N   widths (default 2048 / 8192 / 8192)
  BENCH_BLOCKS                  depth (default 24; the result is scaled to
                                24 blocks when fewer run)
  BENCH_TOKENS                  steady tokens after one warm-up (default 3)
  BENCH_MODE                    device (default): the device-resident
                                client; classic: the per-round-trip
                                transport of `run_generation`
  BENCH_FUSED                   classic only: 0 = explicit ciphertexts
  BENCH_NTT_BACKEND             stockham (default), pallas or mxu
  FHE_PREENC_CACHE              pre-encoded diagonal cache directory
  FHE_STAGE_MODE                classic staging: i32 or expanded

The model is `make_random_model(seed=42)` at the chosen widths, the
context `CkksParams(n, num_limbs=3, num_special=1)` at seed 0.  Caches go
under `build/` of the checkout.  It runs on the card and raises without
one; `main(device="cpu")` runs the plain torch path (tests, tiny sizes).
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

CACHE_ROOT = Path(__file__).resolve().parents[1] / "build"
BASELINE_S = 79.0     # the reference paper's A100 seconds per token


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def device_name(device) -> str:
    import torch

    return (torch.cuda.get_device_name(0) if torch.device(device).type
            == "cuda" else "cpu")


def load_or_make_model(d, f, num_blocks):
    """make_random_model(seed=42) with head size 64 (d below 64: one
    head), cached as a model directory."""
    from .models.rwkv7 import load_model, make_random_model, save_model

    t0 = time.perf_counter()
    cache = CACHE_ROOT / f"bench_model_{d}_{f}_{num_blocks}.dir"
    if cache.exists():
        model = load_model(str(cache))
        log(f"model loaded from cache ({time.perf_counter() - t0:.1f}s)")
    else:
        model = make_random_model(d=d, f=f, n_blocks=num_blocks,
                                  head_size=min(64, d), vocab=1000, seed=42)
        save_model(str(cache), model)
        log(f"model built ({time.perf_counter() - t0:.1f}s)")
    return model


def main(device="cuda"):
    from .core.ntt import require_device

    device = require_device(device)
    d = int(os.environ.get("BENCH_D", "2048"))
    f = int(os.environ.get("BENCH_F", "8192"))
    n = int(os.environ.get("BENCH_N", "8192"))
    num_blocks = int(os.environ.get("BENCH_BLOCKS", "24"))
    num_tokens = int(os.environ.get("BENCH_TOKENS", "3"))

    os.environ.setdefault("FHE_PREENC_CACHE",
                          str(CACHE_ROOT / "fhe_preenc_cache"))
    # 24 resident blocks only fit as int32 coefficients (in-kernel RNS
    # expansion); smaller configs default to pre-expanded staging
    os.environ.setdefault("FHE_STAGE_MODE",
                          "i32" if num_blocks > 8 else "expanded")
    log(f"device: {device_name(device)}")

    from .ckks import CkksContext, CkksParams
    from .models.client_aided import run_generation

    model = load_or_make_model(d, f, num_blocks)
    t0 = time.perf_counter()
    backend = os.environ.get("BENCH_NTT_BACKEND", "stockham")
    ctx = CkksContext(CkksParams(n=n, num_limbs=3, num_special=1,
                                 ntt_backend=backend), seed=0, device=device)
    log(f"context + keys (ntt_backend={backend}, "
        f"{time.perf_counter() - t0:.1f}s)")

    mode = os.environ.get("BENCH_MODE", "device")
    if mode == "device" and "BENCH_FUSED" in os.environ:
        log("WARNING: BENCH_FUSED is ignored in device transport; set "
            "BENCH_MODE=classic for explicit-ciphertext wire accounting")
    if mode == "device":
        from .models.device_client import run_generation_device

        results = run_generation_device(
            ctx, model, seed_tokens=[5, 11, 2], num_tokens=num_tokens + 1,
            level=3, cache_dir=os.environ.get("FHE_PREENC_CACHE"),
            log_fn=log)
    else:
        results = run_generation(
            ctx, model, seed_tokens=[5, 11, 2],
            num_tokens=num_tokens + 1, level=3, verbose=False,
            fused=os.environ.get("BENCH_FUSED", "1") == "1",
            log_fn=log)
    for i, r in enumerate(results):
        log(f"token {i}: match={r['match']} corr={r['corr']:.6f} "
            f"{r['sec']:.2f}s")

    # median of the tokens after the warm-up one
    steady = [r["sec"] for r in results[1:]]
    per_block = float(np.median(steady)) / num_blocks
    sec_per_token = per_block * 24
    kind = ("24-block measured" if num_blocks == 24
            else f"{num_blocks}-block, x24/{num_blocks} extrapolated")
    if mode == "device":
        kind += ", device-client"
    fused = os.environ.get("BENCH_FUSED", "1") == "1" and mode != "device"
    # classic-transport wire volume: Ciphertext [2, l, N] of 32-bit words
    # per hop; per block the protocol moves 7 up + 8 down = 15 ciphertexts
    ct_bytes = 2 * 3 * n * 4
    wire = {"ciphertext_bytes": ct_bytes,
            "cts_per_block_up_down": [7, 8],
            "bytes_per_token_24_blocks": 15 * ct_bytes * 24}
    line = {
        "metric": f"sec/token client-aided RWKV-7 D={d} F={f} N={n} "
                  f"({kind})",
        "value": round(sec_per_token, 3),
        "unit": "s/token",
        "vs_baseline": round(BASELINE_S / sec_per_token, 3),
        "detail": {
            "per_block_s": round(per_block, 4),
            "blocks_measured": num_blocks,
            "tokens_match_plaintext": all(r["match"] for r in results),
            "min_logit_corr": round(min(r["corr"] for r in results), 6),
            "transport": ("device-client" if mode == "device"
                          else "fused" if fused else "explicit-ciphertext"),
            "wire": wire if not fused and mode != "device" else None,
            "device": device_name(device),
        },
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
