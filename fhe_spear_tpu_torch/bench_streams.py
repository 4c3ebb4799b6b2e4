"""Aggregate-throughput benchmark of the port: S independent generation
streams through one transport, on one NVIDIA card.

    python -m fhe_spear_tpu_torch.bench_streams

The port's counterpart of the root `bench_streams.py`: the same knobs
(BENCH_D / F / N, BENCH_BLOCKS default 4, BENCH_TOKENS default 2,
BENCH_STREAMS default 8, BENCH_MODE classic (default:
`run_generation_batched`) or device (`DeviceTokenRunner.
generate_tokens_streams`), FHE_PREENC_CACHE, FHE_STAGE_MODE) and the same
one-line JSON schema on stdout, plus the card's name in `detail.device`.
It runs on the card and raises without one; `main(device="cpu")` runs the
plain torch path.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from .bench import BASELINE_S, CACHE_ROOT, device_name, load_or_make_model, \
    log


def main(device="cuda"):
    from .core.ntt import require_device

    device = require_device(device)
    d = int(os.environ.get("BENCH_D", "2048"))
    f = int(os.environ.get("BENCH_F", "8192"))
    n = int(os.environ.get("BENCH_N", "8192"))
    num_blocks = int(os.environ.get("BENCH_BLOCKS", "4"))
    num_tokens = int(os.environ.get("BENCH_TOKENS", "2"))
    streams = int(os.environ.get("BENCH_STREAMS", "8"))
    os.environ.setdefault("FHE_PREENC_CACHE",
                          str(CACHE_ROOT / "fhe_preenc_cache"))
    log(f"device: {device_name(device)}")
    mode = os.environ.get("BENCH_MODE", "classic")

    from .ckks import CkksContext, CkksParams
    from .models.client_aided import run_generation_batched
    from .models.rwkv7 import generate_token_plaintext

    model = load_or_make_model(d, f, num_blocks)
    t0 = time.perf_counter()
    ctx = CkksContext(CkksParams(n=n, num_limbs=3, num_special=1), seed=0,
                      device=device)
    log(f"context + keys ({time.perf_counter() - t0:.1f}s)")

    if mode == "device":
        # device-client streams: one call advances all S sequences
        from .models.device_client import DeviceTokenRunner

        runner = DeviceTokenRunner(
            ctx, model, level=3,
            cache_dir=os.environ.get("FHE_PREENC_CACHE"))
        rng = np.random.default_rng(7)
        toks = [int(t) for t in rng.integers(0, model.emb.shape[0], streams)]
        ref_toks = list(toks)
        states = [model.zero_state() for _ in range(streams)]
        ref_states = [model.zero_state() for _ in range(streams)]
        results = []
        for step in range(num_tokens + 1):
            t0 = time.perf_counter()
            logits, states = runner.generate_tokens_streams(toks, states)
            dt = time.perf_counter() - t0
            match = 0
            for s in range(streams):
                lr, ref_states[s] = generate_token_plaintext(
                    model, ref_toks[s], ref_states[s])
                ref_toks[s] = int(np.argmax(lr))
                toks[s] = int(np.argmax(logits[s]))
                match += toks[s] == ref_toks[s]
            results.append({"sec": dt, "match": match})
            log(f"step {step}: {dt:.2f}s match {match}/{streams}")
    else:
        results = run_generation_batched(ctx, model, None,
                                         num_tokens=num_tokens + 1,
                                         streams=streams, level=3,
                                         verbose=False, log_fn=log)
    steady = results[1:]
    per_token = float(np.mean([r["sec"] for r in steady])) / num_blocks * 24
    agg = streams / per_token
    depth = ("24-block measured" if num_blocks == 24
             else "24-block extrapolated")
    line = {
        "metric": f"aggregate tokens/s, {streams} streams, client-aided "
                  f"RWKV-7 D={d} F={f} N={n} "
                  f"({'device-client, ' if mode == 'device' else ''}{depth})",
        "value": round(agg, 3),
        "unit": "tokens/s",
        "vs_baseline": round(agg / (1.0 / BASELINE_S), 1),
        "detail": {"per_token_s": round(per_token, 3), "streams": streams,
                   "all_streams_match_plaintext": all(
                       r["match"] == streams for r in results),
                   "device": device_name(device)},
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
