"""Fully-encrypted FFN benchmark of the port on one NVIDIA card.

    python -m fhe_spear_tpu_torch.bench_fully_enc

The port's counterpart of the root `bench_fully_enc.py`, with the same
environment knobs and the same one-line JSON schema on stdout (progress
on stderr), plus the card's name and the peak device memory in `detail`:

  BENCH_D / BENCH_F / BENCH_N   widths (default 2048 / 8192 / 16384)
  BENCH_BLOCKS                  depth (default 19)
  BENCH_LIMBS                   scale limbs (default 3*blocks + 2; width
                                2: 6*blocks + 3; bootstrap: 46)
  BENCH_SPECIAL / BENCH_DNUM    special primes / keyswitch digits (8 / 8;
                                bootstrap: 8 / ceil(L/K))
  BENCH_PASSES                  passes over the chain (default 2: the
                                first warms up, the rest are measured)
  BENCH_TARGET_MAG              calibration magnitude (default 1.0)
  BENCH_WIDTH_CHAIN             1, or 2 for the composite ~2^56 scale
  BENCH_BOOT_LEVEL              refresh level for the level schedule
  BENCH_PREP_ONLY=1             weights + host pre-encode only
  BENCH_BOOTSTRAP=1             refresh mid-chain: a sparse secret
                                (`CkksParams.bootstrap`, h=64) and a
                                `Bootstrapper` with BENCH_EXP_DEGREE (31),
                                BENCH_RADIX (4), BENCH_WIDTH (EvalMod
                                width, 2), BENCH_MARGIN_BITS (3); width-2
                                chains do not refresh
  FHE_WARM_FREE=1               build the key stacks, then drop the raw
                                rotation keys before the chain runs (with
                                BENCH_BOOTSTRAP: the chain's stack first,
                                then one warm-up refresh builds the stage
                                stacks, then the rest is dropped)
  PYTORCH_CUDA_ALLOC_CONF       default expandable_segments:True (an empty
                                value runs PyTorch's default allocator)

Random weights from `default_rng(42)` and x0 from `default_rng(4242)`,
the context at seed 0, one chunk at a time.  Weights and
pre-encoded diagonals are cached under `build/` of the checkout; the
pre-encode cache key carries a hash of the scale primes and of x0, as the
root entry's does.  It runs on the card and raises without one;
`main(device="cpu")` runs the plain torch path (tests, tiny sizes).
"""

from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np

from .bench_common import CACHE_ROOT, device_name, log

BASELINE_S = 70.0   # the reference paper's A100 s/block, 19 blocks, no refresh
BASELINE_BOOT_S = 40.0   # the same, 24 blocks with 4 refreshes


def main(device="cuda"):
    # the chain frees and allocates transients of many sizes: expandable
    # segments let freed space serve larger requests (the 19-block chain
    # once ran out of memory with 14 GiB reserved but unallocated); read
    # when the card's allocator starts, so before the first device call
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    from .core.ntt import require_device

    device = require_device(device)
    d = int(os.environ.get("BENCH_D", "2048"))
    f = int(os.environ.get("BENCH_F", "8192"))
    n = int(os.environ.get("BENCH_N", "16384"))
    blocks = int(os.environ.get("BENCH_BLOCKS", "19"))
    use_boot = os.environ.get("BENCH_BOOTSTRAP", "0") == "1"
    passes = int(os.environ.get("BENCH_PASSES", "2"))
    width = int(os.environ.get("BENCH_WIDTH_CHAIN", "1"))
    if use_boot and width == 2:
        raise ValueError("BENCH_BOOTSTRAP=1 with BENCH_WIDTH_CHAIN=2: "
                         "width-2 chains do not refresh")
    log(f"device: {device_name(device)}")

    from .ckks import CkksContext, CkksParams
    from .models.fully_encrypted import (
        FullyEncryptedFfn, _sync, calibrate_magnitude, fe_level_schedule,
        pre_encode_blocks, run_fully_encrypted)

    if use_boot:
        # the width-2 radix-4 refresh consumes ~37 limbs at N=16384, so
        # L=46 lands refreshes at level 9: 2 blocks a refresh (3 at N=8192)
        limbs = int(os.environ.get("BENCH_LIMBS", "46"))
        special = int(os.environ.get("BENCH_SPECIAL", "8"))
        dnum = int(os.environ.get("BENCH_DNUM", str(-(-limbs // special))))
        params = CkksParams.bootstrap(n=n, num_limbs=limbs,
                                      num_special=special, hamming=64,
                                      dnum=dnum)
    else:
        default_l = 6 * blocks + 3 if width == 2 else 3 * blocks + 2
        limbs = int(os.environ.get("BENCH_LIMBS", str(default_l)))
        special = int(os.environ.get("BENCH_SPECIAL", "8"))
        dnum = int(os.environ.get("BENCH_DNUM", "8"))
        params = CkksParams(n=n, num_limbs=limbs, num_special=special,
                            dnum=dnum)

    t0 = time.perf_counter()
    ctx = CkksContext(params, seed=0, device=device)
    log(f"context N={n} L={limbs} K={special} dnum={dnum} "
        f"({time.perf_counter() - t0:.1f}s)")

    # random weights (FHE correctness is weight-independent); x0 from its
    # own seeded stream, so that it does not depend on the weight cache
    rng = np.random.default_rng(42)
    x0 = np.random.default_rng(4242).uniform(-1, 1, d)
    wdir = CACHE_ROOT / f"fe_model_{d}_{f}_{blocks}"
    wdir.mkdir(parents=True, exist_ok=True)
    w_keys, w_vals = [], []
    t0 = time.perf_counter()
    for b in range(blocks):
        kf, vf = wdir / f"k{b:03d}.npy", wdir / f"v{b:03d}.npy"
        if not (kf.exists() and vf.exists()):
            np.save(kf, rng.standard_normal((d, f)) / np.sqrt(d))
            np.save(vf, rng.standard_normal((f, d)) / np.sqrt(f))
        w_keys.append(np.load(kf, mmap_mode="r"))
        w_vals.append(np.load(vf, mmap_mode="r"))
    log(f"weights ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    tmag = float(os.environ.get("BENCH_TARGET_MAG", "1.0"))
    w_keys, w_vals = calibrate_magnitude(w_keys, w_vals, x0, target_mag=tmag)
    log(f"magnitude calibration (target {tmag}, "
        f"{time.perf_counter() - t0:.1f}s)")

    eng = FullyEncryptedFfn(ctx, d, f, width=width)
    # exact-scale encodes depend on the scale primes and the calibrated
    # weights depend on x0: both are in the cache key
    qh = hashlib.sha1(np.asarray(ctx.q_np[:limbs], dtype=np.uint64)
                      .tobytes()).hexdigest()[:10]
    xh = hashlib.sha1(np.asarray(x0, dtype=np.float64).tobytes()
                      ).hexdigest()[:8]
    cache = str(CACHE_ROOT / (f"fe_preenc_{d}_{f}_{blocks}_{n}_q{qh}_x{xh}"
                              + (f"_m{tmag:g}" if tmag != 1.0 else "")
                              + (f"_w{width}" if width != 1 else "")))
    boot_lv = int(os.environ.get("BENCH_BOOT_LEVEL", "0")) or None
    levels = fe_level_schedule(limbs, blocks, boot_level=boot_lv, width=width)
    t0 = time.perf_counter()
    hosts = pre_encode_blocks(eng, w_keys, w_vals, cache_dir=cache,
                              log_fn=log, levels=levels)
    log(f"pre-encode ({time.perf_counter() - t0:.1f}s)")

    if os.environ.get("BENCH_PREP_ONLY") == "1":
        print(json.dumps({"metric": "prep-only", "value": 1, "unit": "",
                          "vs_baseline": None, "detail": {"cache": cache}}))
        return None

    bt, boot_fn, refresh_s = None, None, []
    if use_boot:
        from .ckks.bootstrap import Bootstrapper

        t0 = time.perf_counter()
        bt = Bootstrapper(
            ctx, exp_degree=int(os.environ.get("BENCH_EXP_DEGREE", "31")),
            radix=int(os.environ.get("BENCH_RADIX", "4")),
            evalmod_width=int(os.environ.get("BENCH_WIDTH", "2")),
            margin_bits=int(os.environ.get("BENCH_MARGIN_BITS", "3")))
        log(f"bootstrapper ({time.perf_counter() - t0:.1f}s, "
            f"{len(ctx.galois_keys)} Galois keys)")

        def boot_fn(ct):
            t0 = time.perf_counter()
            out = bt.bootstrap(ct)
            _sync(out.c)
            refresh_s.append(time.perf_counter() - t0)
            return out

    if os.environ.get("FHE_WARM_FREE") == "1":
        # the chain's stack first, drop its raw keys; then one warm-up
        # refresh builds the stage stacks (and the identity key where a
        # stage needs it), then drop the rest: the peak holds one copy
        t0 = time.perf_counter()
        fe_elts = eng.eng.warm_stacks()
        boot_elts = bt.galois_elements() if bt is not None else set()
        nd = ctx.drop_galois_keys(drop=fe_elts - boot_elts)
        log(f"warm/free: key stack built, {nd} raw rotation keys dropped "
            f"({time.perf_counter() - t0:.1f}s)")
        if bt is not None:
            t0 = time.perf_counter()
            ct_w = ctx.mod_switch_to(ctx.encrypt_replicated(np.zeros(d)), 2)
            _sync(bt.bootstrap(ct_w).c)
            nd = ctx.drop_galois_keys()
            log(f"warm/free: warm-up refresh done, {nd} raw keys dropped "
                f"({time.perf_counter() - t0:.1f}s)")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    all_stats, pass_refresh = [], []
    for ps in range(passes):
        t0 = time.perf_counter()
        refresh_s.clear()
        stats = run_fully_encrypted(
            ctx, w_keys, w_vals, x0, bootstrap_fn=boot_fn, pre_encoded=hosts,
            eng=eng, calibrated=True, verbose=False, log_fn=log,
            cache_dir=cache)
        log(f"pass {ps}: {time.perf_counter() - t0:.1f}s total, "
            f"{len(stats)} blocks, refreshes "
            + ", ".join(f"{x:.3f}s" for x in refresh_s))
        all_stats.append(stats)
        pass_refresh.append(list(refresh_s))
    if device.type == "cuda":
        log(f"peak device memory: "
            f"{torch.cuda.max_memory_allocated(device) / 2 ** 30:.2f} GiB "
            f"allocated, {torch.cuda.max_memory_reserved(device) / 2 ** 30:.2f}"
            f" GiB reserved (allocator: "
            f"{os.environ['PYTORCH_CUDA_ALLOC_CONF'] or 'default'})")

    final = all_stats[-1]
    # per-block minimum over the measured passes (all passes but the
    # first when there are several)
    measure = all_stats[1:] if len(all_stats) > 1 else all_stats
    per_block_min = [min(ps[i]["sec"] for ps in measure)
                     for i in range(len(final))]
    per_block = float(np.mean(per_block_min))
    n_boot = final[-1]["bootstraps"] if final else 0
    measured_refresh = [x for p in (pass_refresh[1:] if passes > 1
                                    else pass_refresh) for x in p]
    line = {
        "metric": f"fully-encrypted FFN s/block D={d} F={f} N={n} "
                  f"{len(final)} blocks"
                  + (f" ({n_boot} bootstraps)" if use_boot
                     else " (no bootstrap)")
                  + (" width-2" if width == 2 else ""),
        "value": round(per_block, 3),
        "unit": "s/block",
        "vs_baseline": round((BASELINE_BOOT_S if use_boot else BASELINE_S)
                             / per_block, 3),
        "detail": {
            "blocks": len(final),
            "min_corr": round(min(s["corr"] for s in final), 8),
            "max_err": max(s["max_err"] for s in final),
            "bootstraps": n_boot,
            "final_level": final[-1]["level"] if final else None,
            "per_block_min_s": [round(s, 4) for s in per_block_min],
            "per_pass_mean_s": [round(float(np.mean([s["sec"] for s in p])),
                                      4) for p in all_stats],
            "stat": "mean of per-block min across measurement passes",
            "per_block_corr": [s["corr"] for s in final],
            "per_block_max_err": [s["max_err"] for s in final],
            "refresh_s_steady": (float(np.median(measured_refresh))
                                 if measured_refresh else None),
            "device": device_name(device),
            "allocator": os.environ["PYTORCH_CUDA_ALLOC_CONF"] or "default",
            "peak_device_memory_gib": (
                torch.cuda.max_memory_allocated(device) / 2 ** 30
                if device.type == "cuda" else None),
        },
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
