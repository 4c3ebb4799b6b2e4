"""CKKS bootstrap benchmark of the port on one NVIDIA card.

    python -m fhe_spear_tpu_torch.bench_bootstrap

The port's counterpart of the root `bench_bootstrap.py`, with the same
environment knobs and the same one-line JSON schema on stdout (progress
on stderr): refreshes a seeded uniform(-0.8, 0.8) message at level 2 twice
(the first call includes the host encodes of the stage diagonals) and
reports the second call's seconds, the refresh error and correlation.

  BENCH_N / BENCH_LIMBS         ring and scale limbs (default 2048 / 22)
  BENCH_SPECIAL / BENCH_DNUM    special primes / keyswitch digits (2 / one
                                a limb)
  BENCH_RADIX                   collapsed-FFT radix (4; 0 = dense C2S/S2C)
  BENCH_EXP_DEGREE              EvalMod Chebyshev degree (31)
  BENCH_MARGIN_BITS             Delta_d = scale / 2^margin (3)
  BENCH_WIDTH                   EvalMod scale width (1)

The context is `CkksParams.bootstrap(h=64)` at seed 0.  `detail` adds the
card's name, the peak device memory, whether a key stack used the
identity key, and K1/K2 launches of the steady refresh by [B, R, N].  It
runs on the card and raises without one; `main(device="cpu")` runs the
plain torch path (tests, tiny sizes).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from .bench_common import device_name, log

BASELINE_S = 0.7   # the reference paper's A100 seconds a refresh, N=16384


def main(device="cuda"):
    import torch

    from .core import ntt_cuda
    from .core.ntt import require_device

    device = require_device(device)
    n = int(os.environ.get("BENCH_N", "2048"))
    limbs = int(os.environ.get("BENCH_LIMBS", "22"))
    special = int(os.environ.get("BENCH_SPECIAL", "2"))
    dnum = int(os.environ.get("BENCH_DNUM", "0")) or None
    radix = int(os.environ.get("BENCH_RADIX", "4")) or None
    log(f"device: {device_name(device)}")

    from .ckks import CkksContext, CkksParams
    from .ckks.bootstrap import Bootstrapper
    from .models.fully_encrypted import _sync

    t0 = time.perf_counter()
    ctx = CkksContext(CkksParams.bootstrap(n=n, num_limbs=limbs,
                                           num_special=special, hamming=64,
                                           dnum=dnum),
                      seed=0, device=device)
    log(f"context ({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    deg = int(os.environ.get("BENCH_EXP_DEGREE", "31"))
    margin = int(os.environ.get("BENCH_MARGIN_BITS", "3"))
    width = int(os.environ.get("BENCH_WIDTH", "1"))
    bt = Bootstrapper(ctx, exp_degree=deg, margin_bits=margin, radix=radix,
                      evalmod_width=width)
    log(f"bootstrapper setup ({time.perf_counter() - t0:.1f}s, "
        f"{len(ctx.galois_keys)} Galois keys)")

    rng = np.random.default_rng(1)
    m = rng.uniform(-0.8, 0.8, ctx.slots)
    ct = ctx.mod_switch_to(ctx.encrypt(m), 2)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = bt.bootstrap(ct)                  # includes the host encodes
    _sync(out.c)
    t_first = time.perf_counter() - t0
    ntt_cuda.reset_counts()
    t0 = time.perf_counter()
    out = bt.bootstrap(ct)
    _sync(out.c)
    t_steady = time.perf_counter() - t0
    launches = {k.name: {"x".join(map(str, s)): c
                         for s, c in sorted(k.by_shape.items())}
                for k in (ntt_cuda.NTT_FWD, ntt_cuda.NTT_INV)}
    got = ctx.decrypt_vec(out)
    err = float(np.abs(got - m).max())
    corr = float(np.corrcoef(got, m)[0, 1])
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else None)
    log(f"first {t_first:.2f}s steady {t_steady:.3f}s err {err:.2e} "
        f"corr {corr:.8f} out_level {out.level}"
        + (f" peak {peak:.2f} GiB" if peak is not None else ""))

    line = {
        "metric": f"CKKS bootstrap wall time, N={n}, L={limbs}, h=64"
                  + (f", dnum={dnum}" if dnum else "")
                  + (f", radix={radix}" if radix else " (dense C2S)"),
        "value": round(t_steady, 4),
        "unit": "s",
        "vs_baseline": round(BASELINE_S / t_steady, 3),
        "detail": {"refresh_max_err": err, "corr": corr,
                   "output_level": out.level,
                   "first_call_s": round(t_first, 2),
                   "device": device_name(device),
                   "peak_device_memory_gib": peak,
                   "identity_key": hasattr(ctx, "_identity_ksk"),
                   "launches_by_shape": launches},
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
