"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases (each failure raises, and the script exits non-zero):
  1. device: fail without CUDA; print the card's name and power limit;
  2. build: compile the CUDA kernels (nvcc, sm_90a) and the host batch
     encoder (g++) from the sources in this checkout, in parallel;
  3. kernels: hold NTT kernels K1/K2 against their plain torch versions,
     bitwise, at N=8192 and the batch shapes of the main path, check the
     round trip, and time kernel and plain version (CUDA events, median);
  4. main path: client-aided RWKV-7 generation through
     `run_generation` at D=2048, F=8192, N=8192, L=3, K=1, level 3 on the
     fused transport with i32 staging (depth cut to 2 blocks; 2 tokens,
     the first a warm-up), then one token of the explicit transport on
     1 block.  Every token must match its plaintext twin with logit
     correlation >= 0.9999, and the kernel launch counters must rise;
  5. print the kernels line, then the device line last.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# the card's memory rate and 32-bit integer rate (non-tensor), H100 SXM
# data sheet at 700 W: 3.35 TB/s, 67 T 32-bit ops/s
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
# ~10 ms at the H100's ~2 GHz clock: longer than the host takes to queue
# the 21 timed calls of a kernel
SPIN_CYCLES = 20_000_000

D, F, N, L, K, LEVEL = 2048, 8192, 8192, 3, 1, 3
BLOCKS = 2             # depth cut from the model's 24 to fit the time limit
SEED_TOKENS = [5, 11, 2]


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return card


def phase_build():
    from fhe_spear_tpu_torch import native
    from fhe_spear_tpu_torch.core import ntt_cuda

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        kern = pool.submit(ntt_cuda.build)
        enc = pool.submit(native.available)
        kern.result()
        have_native = enc.result()
    log(f"build: {time.perf_counter() - t0:.2f}s (nvcc {ntt_cuda.build_seconds:.2f}s"
        f"; host batch encoder: {'native' if have_native else 'numpy'})")
    for line in ntt_cuda.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def _time_ms(fn, runs=21):
    """Median device time of fn() over `runs` back-to-back calls after a
    warm-up, from CUDA events recorded between the calls.  A spin kernel
    holds the device while the host queues every call, so the host's
    launch overhead does not show up as device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(runs + 1)]
    torch.cuda._sleep(SPIN_CYCLES)
    ev[0].record()
    for i in range(runs):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    times = sorted(ev[i].elapsed_time(ev[i + 1]) for i in range(runs))
    return times[runs // 2]


def _bound(B: int, R: int, n: int):
    """Least time for one transform of [B, R, n] int64 residues: read x
    once, write y once (8 bytes a word), read the per-limb twist and
    twiddle tables once (4 bytes a word), against (n/2) log2 n butterflies
    (12 32-bit ops: mont_mul 8, add_mod 2, sub_mod 2) + n twist products
    (8 ops) per polynomial."""
    logn = n.bit_length() - 1
    nbytes = 2 * 8 * B * R * n + 4 * R * (2 * n - 1 + 2)
    ops = B * R * (12 * (n // 2) * logn + 8 * n)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def phase_kernels():
    import torch

    from fhe_spear_tpu_torch.core import ntt_cuda
    from fhe_spear_tpu_torch.core.ntt import NttContext
    from fhe_spear_tpu_torch.core.primes import find_ntt_primes

    ctx = NttContext.build(N, find_ntt_primes(N, L, reserve_special=K),
                           device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    p_all = ctx.p[:, 0]

    def residues(B, rows):
        idx = torch.tensor(rows, device="cuda")
        x = torch.randint(0, 1 << 31, (B, len(rows), N), generator=gen,
                          device="cuda", dtype=torch.int64)
        return x % p_all[idx][:, None]

    # (B, rows) as the main path gives them at level 3 with K=1:
    #   giant-chunk diagonal expansion [8, 46, 3, N]   -> (368, (0, 1, 2))
    #   digit extension to targets     [8, 3, 4, N]    -> (24, (0, 1, 2, 3))
    #   mod-down of the special limb   [45, 2, 1, N]   -> (90, (3,))
    #   plus a non-prefix subset                        -> (16, (0, 3))
    shapes = [(368, (0, 1, 2)), (24, (0, 1, 2, 3)), (90, (3,)), (16, (0, 3)),
              (8, (0, 1, 2))]
    err = {"ntt_fwd": 0, "ntt_inv": 0}
    for B, rows in shapes:
        x = residues(B, rows)
        y = ctx.ntt(x, rows)
        y_plain = ctx.ntt_plain(x, rows)
        back = ctx.intt(y, rows)
        back_plain = ctx.intt_plain(y, rows)
        torch.cuda.synchronize()
        e_f = int((y - y_plain).abs().max())
        e_i = int((back - back_plain).abs().max())
        rt = bool(torch.equal(back, x))
        log(f"  K1/K2 [B={B}, R={len(rows)}, N={N}] rows={rows}: "
            f"fwd max|err|={e_f} inv max|err|={e_i} round trip={rt}")
        if e_f or e_i or not rt:
            raise AssertionError(f"NTT kernel disagrees at B={B} rows={rows}")
        err["ntt_fwd"] = max(err["ntt_fwd"], e_f)
        err["ntt_inv"] = max(err["ntt_inv"], e_i)

    timed = {"ntt_fwd": (368, (0, 1, 2)), "ntt_inv": (90, (3,))}
    out = {}
    for name, (B, rows) in timed.items():
        x = residues(B, rows)
        kern = ctx.ntt if name == "ntt_fwd" else ctx.intt
        plain = ctx.ntt_plain if name == "ntt_fwd" else ctx.intt_plain
        ms = _time_ms(lambda: kern(x, rows))
        plain_ms = _time_ms(lambda: plain(x, rows))
        bound_ms, bound_by = _bound(B, len(rows), N)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "max_abs_err": err[name],
                     "shape": [B, len(rows), N]}
        log(f"  {name} [B={B}, R={len(rows)}, N={N}]: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    ntt_cuda.reset_counts()
    return out


def phase_main_path():
    import torch

    from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams
    from fhe_spear_tpu_torch.core import ntt_cuda
    from fhe_spear_tpu_torch.models.client_aided import run_generation
    from fhe_spear_tpu_torch.models.rwkv7 import RwkvModel, make_random_model
    from fhe_spear_tpu_torch.ops.bsgs import bsgs_dims

    log(f"main path: client-aided RWKV-7 D={D} F={F} N={N} L={L} K={K} "
        f"level {LEVEL}; depth cut to {BLOCKS} of the model's 24 blocks")
    t0 = time.perf_counter()
    model = make_random_model(d=D, f=F, n_blocks=BLOCKS, head_size=64,
                              vocab=1000, seed=42)
    log(f"  model: {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    ctx = CkksContext(CkksParams(n=N, num_limbs=L, num_special=K), seed=0,
                      device="cuda")
    G, B = bsgs_dims(D)
    ctx.ensure_galois(tuple(range(1, G)) + tuple(g * G for g in range(1, B)))
    torch.cuda.synchronize()
    log(f"  keygen: {time.perf_counter() - t0:.2f}s "
        f"({len(ctx.galois_keys)} Galois keys; "
        f"{ctx.params.security_statement()})")

    def run(tag, mdl, tokens, fused, stage_mode):
        per_token = []

        def on_log(msg):
            log(f"  [{tag}] {msg}")
            if msg.startswith("token "):
                per_token.append({"ntt_fwd": ntt_cuda.NTT_FWD.launches,
                                  "ntt_inv": ntt_cuda.NTT_INV.launches})

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ntt_cuda.reset_counts()
        t0 = time.perf_counter()
        results = run_generation(ctx, mdl, seed_tokens=SEED_TOKENS,
                                 num_tokens=tokens, level=LEVEL, fused=fused,
                                 log_fn=on_log, stage_mode=stage_mode)
        torch.cuda.synchronize()
        counts = {"ntt_fwd": ntt_cuda.NTT_FWD.launches,
                  "ntt_inv": ntt_cuda.NTT_INV.launches}
        prev = {"ntt_fwd": 0, "ntt_inv": 0}
        for i, c in enumerate(per_token):
            log(f"  [{tag}] launches token {i}: "
                + " ".join(f"{k}={c[k] - prev[k]}" for k in c))
            prev = c
        log(f"  [{tag}] total {time.perf_counter() - t0:.2f}s, peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"launches {counts}")
        for r in results:
            if not r["match"] or not r["corr"] >= 0.9999:
                raise AssertionError(f"{tag}: token off its plaintext twin: "
                                     f"{results}")
        for k, v in counts.items():
            if v == 0:
                raise AssertionError(f"{tag}: kernel {k} never launched")
        return counts, results

    counts, results = run("fused i32", model, 2, True, "i32")
    log(f"  fused: steady token {results[-1]['sec']:.3f}s, "
        f"min corr {min(r['corr'] for r in results):.6f}")
    one = RwkvModel(blocks=model.blocks[:1], emb=model.emb,
                    head_w=model.head_w, ln_out_w=model.ln_out_w,
                    ln_out_b=model.ln_out_b, ln0_w=model.ln0_w,
                    ln0_b=model.ln0_b)
    _, res_x = run("explicit expanded, 1 block", one, 1, False, "expanded")
    log(f"  explicit: token {res_x[0]['sec']:.3f}s corr "
        f"{res_x[0]['corr']:.6f}")
    return counts


def main():
    t_start = time.perf_counter()
    phase_device()
    import torch

    phase_build()
    log("kernels: K1/K2 against their plain torch versions")
    timing = phase_kernels()
    counts = phase_main_path()
    kernels = []
    for name, line in (("ntt_fwd", 144), ("ntt_inv", 199)):
        t = timing[name]
        kernels.append({
            "name": name, "status": "ported; bitwise equal to plain",
            "route": "cuda",
            "source": "fhe_spear_tpu_torch/csrc/ntt.cu",
            "replaces": f"fhe_spear_tpu/core/ntt_pallas.py:{line}",
            "launches": counts[name], "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "shape": t["shape"]})
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
