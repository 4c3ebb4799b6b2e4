"""What the port's bench entries (`bench_retrieval`, `bench_rag`,
`bench_bootstrap`, `bench_fully_enc`) share: the cache directory under
`build/` of the checkout, progress on stderr, the device's name and the
cached generation model."""

from __future__ import annotations

import sys
import time
from pathlib import Path

CACHE_ROOT = Path(__file__).resolve().parents[1] / "build"


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
