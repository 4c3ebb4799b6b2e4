"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --kernels-only  # build + kernel checks only

Phases (each failure raises, and the script exits non-zero):
  1. device: fail without CUDA; print the card's name and power limit;
  2. build: compile the CUDA kernels (one nvcc per library: csrc/ntt.cu
     once per N it checks, csrc/fourstep.cu) and the host batch encoder
     (g++) from the sources in this checkout, all started together;
  3. kernels: hold NTT kernels K1/K2 and the four-step kernels
     fourstep_fwd/fourstep_inv against their plain torch versions,
     bitwise, at N=8192 and the batch shapes of the main path, at B*R=1,
     odd batches ([7, 3], [133, 3]), N=2, 32, 64, 128, 256, 1024 (K1/K2;
     the four-step pair at 128 and 256) and N=16384, with
     each launch's plan (threads, shared memory, CTAs, polynomials per
     CTA); hold the compiled K1/K2 schedule against `ntt_cuda.schedule`;
     check the round trips, fourstep_fwd against K1 through bitrev, and
     the fused `ntt_to_mont` / `intt_from_mont` of both backends against
     the composed plain calls; time kernel and plain version (CUDA events,
     median);
  4. classic path: client-aided RWKV-7 generation through `run_generation`
     at D=2048, F=8192, N=8192, L=3, K=1, level 3 on the fused transport
     with i32 staging (depth cut to 2 blocks; 2 tokens, the first a
     warm-up), then one token of the explicit transport on 1 block;
  5. device client, stockham: `run_generation_device` at the same widths
     and depth (2 tokens); K1/K2 launches must rise;
  6. device client, mxu: the same run on a four-step ("mxu") context;
     fourstep_fwd/fourstep_inv launches must rise and K1/K2 stay at 0;
  7. streams: `generate_tokens_streams` with 4 streams on 1 block, and
     `run_generation_batched` with 2 streams on 1 block, 1 token.
  Every token must match its plaintext twin with logit correlation
  >= 0.999 (0.9999 on the classic path), every stream its own twin;
  8. retrieval: column-packed CT-CT scores of 50k seeded unit vectors (and
     1k, 10k; dim 64, Lorentz, N=8192), row-packed CT-PT and CT-CT at 1k;
     every mode's encrypted top-1 must equal the plaintext `lorentz_inner`
     top-1, with score correlation >= 0.9999;
  9. RAG: `EncryptedRag` over 64 synthetic passages, row mode, D=2048,
     F=8192, 1 block, generation N=8192, 2 tokens: the retrieved passage
     must be the plaintext top-1 and every token equal its twin;
 10. fully-encrypted FFN chain: D=2048, F=8192, N=8192, 3 blocks, L=11,
     K=8, dnum=8 (6 grouped keyswitch digits), i32 staging, pre-encoded
     at `fe_level_schedule(11, 3)`, two passes; every block needs corr >
     0.99999 and max_err < 1e-3 against the plaintext oracle; then one
     width-2 block at L=9 (corr > 0.9999999, max_err < 1e-6).  K1/K2
     launch counts must rise in each of phases 8-10;
 11. hold every kernel bitwise against its plain version (plain and fused
     entry points) at each shape the device-client paths launched it with
     in their last token, time it there (plain version at the two most
     frequent), and sum launches x (time - bound) over that shape mix;
     hold K1/K2 the same way at the largest shapes phases 8-10 launched,
     and time them there;
 12. print the kernels line, then the device line last.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# the card's memory rate, 32-bit integer rate (non-tensor) and int8
# tensor-core rate, H100 SXM data sheet at 700 W: 3.35 TB/s, 67 T 32-bit
# ops/s, 1,979 T int8 ops/s (dense)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
INT8_TC_OPS_PER_S = 1979e12
# ~10 ms at the H100's ~2 GHz clock: longer than the host takes to queue
# the 21 timed calls of a kernel
SPIN_CYCLES = 20_000_000

D, F, N, L, K, LEVEL = 2048, 8192, 8192, 3, 1, 3
HEAD_SIZE = 64
BLOCKS = 2             # depth cut from the model's 24 to fit the time limit
SEED_TOKENS = [5, 11, 2]
CORR_DEVICE = 0.999    # the bar of tests/test_device_client.py
CORR_CLASSIC = 0.9999  # the bar of tests/test_client_aided.py
PREENC_CACHE = Path(__file__).resolve().parent / "build" / "chip_smoke_preenc"
KERNELS = ("ntt_fwd", "ntt_inv", "fourstep_fwd", "fourstep_inv")
# the K1/K2 sizes the checks and paths run (N=2048: the RAG retriever)
NTT_LOGNS = (1, 5, 6, 7, 8, 10, 11, 13, 14)
DEVICE = "cuda"


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
        f"python {sys.version.split()[0]}; the host shows "
        f"{torch.cuda.device_count()} card(s), this run uses cuda:0")
    return card


def phase_build():
    from fhe_spear_tpu_torch import native
    from fhe_spear_tpu_torch.core import fourstep_cuda, ntt_cuda

    t0 = time.perf_counter()
    libs = tuple(ntt_cuda.library(logn) for logn in NTT_LOGNS) + (
        fourstep_cuda.LIBRARY,)
    with ThreadPoolExecutor(len(libs) + 1) as pool:
        jobs = [pool.submit(lib.build) for lib in libs]
        enc = pool.submit(native.available)
        for j in jobs:
            j.result()
        have_native = enc.result()
    log(f"build: {time.perf_counter() - t0:.2f}s ("
        + ", ".join(f"{lib.stem} {lib.seconds:.2f}s" for lib in libs)
        + f"; host batch encoder: {'native' if have_native else 'numpy'})")
    for lib in libs:
        for name, info in _ptxas(lib.log):
            log(f"  ptxas {lib.stem} {name}: {info}")


def _ptxas(text: str):
    """(kernel, 'registers, stack, spills') of each entry function in
    nvcc -Xptxas -v output (K1/K2 are templates on log2 N)."""
    import re

    out, name, frame = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(ntt_fwd_kernel|ntt_inv_kernel|fourstep_fwd_kernel"
                          r"|fourstep_inv_kernel)(?:ILi(\d+)E)?", m.group(1))
            name = (f"{k.group(1)}<{k.group(2)}>" if k and k.group(2) else
                    k.group(1) if k else m.group(1))
            frame = ""
        elif "stack frame" in line:
            frame = line.strip()
        elif "Used" in line and "registers" in line and name:
            used = line.split("Used", 1)[1].strip()
            out.append((name, f"{used}; {frame}"))
            name = None
    return out


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


def _bytes_ntt(B: int, R: int, n: int) -> int:
    """Bytes one transform of [B, R, n] int64 residues must move: read x
    once, write y once (8 bytes a word), read the per-limb twist and
    twiddle tables once (4 bytes a word: a kernel's own table layout, such
    as K1/K2's Shoup quotients, is not part of the function)."""
    return 2 * 8 * B * R * n + 4 * R * (2 * n - 1 + 2)


def _bound(B: int, R: int, n: int):
    """Least time for one K1/K2 transform of [B, R, n]: the bytes above,
    against (n/2) log2 n butterflies (12 32-bit ops: mont_mul 8, add_mod
    2, sub_mod 2) + n twist products (8 ops) per polynomial."""
    logn = n.bit_length() - 1
    ops = B * R * (12 * (n // 2) * logn + 8 * n)
    t_bytes = _bytes_ntt(B, R, n) / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _bound_fourstep(B: int, R: int, n: int, n1: int, n2: int):
    """Least time for one four-step transform of [B, R, n]: K1's bytes at
    the same shape, against n * (n1 + n2) modular multiply-adds per
    polynomial, each 16 8-bit limb products on the int8 tensor cores (the
    kernel's 4 x 4 limbs; a multiply-add counts as two operations)."""
    ops = B * R * n * (n1 + n2) * 16 * 2
    t_bytes = _bytes_ntt(B, R, n) / HBM_BYTES_PER_S
    t_ops = ops / INT8_TC_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _residues(ntt, B, rows, gen):
    import torch

    idx = torch.tensor(rows, device="cuda")
    x = torch.randint(0, 1 << 31, (B, len(rows), ntt.n), generator=gen,
                      device="cuda", dtype=torch.int64)
    return x % ntt.p[:, 0][idx][:, None]


# (B, rows) as the main path gives them at level 3 with K=1:
#   giant-chunk diagonal expansion [8, 46, 3, N]   -> (368, (0, 1, 2))
#   digit extension to targets     [8, 3, 4, N]    -> (24, (0, 1, 2, 3))
#   mod-down of the special limb   [45, 2, 1, N]   -> (90, (3,))
#   plus a non-prefix subset                        -> (16, (0, 3))
SHAPES = [(368, (0, 1, 2)), (24, (0, 1, 2, 3)), (90, (3,)), (16, (0, 3)),
          (8, (0, 1, 2))]
TIMED = {"ntt_fwd": (368, (0, 1, 2)), "ntt_inv": (90, (3,)),
         "fourstep_fwd": (368, (0, 1, 2)), "fourstep_inv": (90, (3,))}


def _log_plan(fs, B, rows, n):
    from fhe_spear_tpu_torch.core.fourstep_cuda import plan

    for fwd in (True, False):
        pl = plan(fs, (B, len(rows), n), forward=fwd)
        log(f"    plan {'fourstep_fwd' if fwd else 'fourstep_inv'} "
            f"[{B}, {len(rows)}, {n}]: {pl['smem_bytes']} B shared memory "
            f"per CTA, {pl['ctas']} CTAs, <= {pl['polys_per_cta']} "
            f"polynomials per CTA, {pl['ctas_per_sm']} CTA(s) per SM")


def _log_plan_ntt(B, rows, n):
    from fhe_spear_tpu_torch.core.ntt_cuda import plan

    for fwd in (True, False):
        pl = plan((B, len(rows), n), forward=fwd)
        log(f"    plan {'ntt_fwd' if fwd else 'ntt_inv'} [{B}, {len(rows)}, "
            f"{n}]: {pl['threads']} threads and {pl['smem_bytes']} B shared "
            f"memory per CTA, {pl['ctas']} CTAs, <= {pl['polys_per_cta']} "
            f"polynomials per CTA, {pl['ctas_per_sm']} CTA(s) per SM, no "
            "cluster")


def phase_kernels():
    import torch

    from fhe_spear_tpu_torch.core import fourstep_cuda, ntt_cuda
    from fhe_spear_tpu_torch.core.fourstep_cuda import fourstep_fwd, \
        fourstep_inv
    from fhe_spear_tpu_torch.core.ntt import NttContext
    from fhe_spear_tpu_torch.core.primes import find_ntt_primes
    from fhe_spear_tpu_torch.parallel.ntt_fourstep import FourStepBackend

    for logn in range(1, 15):
        if ntt_cuda.cuda_schedule(logn) != ntt_cuda.schedule(logn):
            raise AssertionError(f"K1/K2 schedule at logn={logn} differs "
                                 "from ntt_cuda.schedule")
    log("  K1/K2 schedule (passes of register-resident stages) equals "
        "ntt_cuda.schedule at N = 2 ... 16384: " + "; ".join(
            f"N={1 << logn}: " + " + ".join(
                str(ps["hi"] - ps["lo"] + 1) for ps in ntt_cuda.schedule(logn))
            for logn in (7, 10, 13, 14)))
    ctx = NttContext.build(N, find_ntt_primes(N, L, reserve_special=K),
                           device="cuda")
    fsb = FourStepBackend(ctx)
    fs = fsb.fs
    log(f"  four-step split at N={N}: n1={fs.n1}, n2={fs.n2}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    err = dict.fromkeys(KERNELS, 0)

    def check(name, got, want):
        e = int((got - want).abs().max())
        err[name] = max(err[name], e)
        return e

    def fused_ok(backend, x, y, want_f, want_i, rows):
        """ntt_to_mont / intt_from_mont against the composed plain calls
        (launches of the folded kernels, compared as K1/K2's are)."""
        f = torch.equal(backend.ntt_to_mont(x, rows),
                        ctx.to_mont(want_f, rows))
        i = torch.equal(backend.intt_from_mont(y, rows),
                        ctx.from_mont(want_i, rows))
        return f and i

    for B, rows in SHAPES:
        x = _residues(ctx, B, rows, gen)
        y = ctx.ntt(x, rows)
        back = ctx.intt(y, rows)
        want_f, want_i = ctx.ntt_plain(x, rows), ctx.intt_plain(y, rows)
        e_f = check("ntt_fwd", y, want_f)
        e_i = check("ntt_inv", back, want_i)
        rt = bool(torch.equal(back, x))
        fused = fused_ok(ctx, x, y, want_f, want_i, rows)
        z = fourstep_fwd(fs, x, rows)
        zb = fourstep_inv(fs, z, rows)
        want_3, want_3i = fsb.ntt_plain(x, rows), fsb.intt_plain(z, rows)
        e_3 = check("fourstep_fwd", z, want_3)
        e_3i = check("fourstep_inv", zb, want_3i)
        rt3 = bool(torch.equal(zb, x))
        fused3 = fused_ok(fsb, x, z, want_3, want_3i, rows)
        vs_k1 = bool(torch.equal(z.index_select(-1, fs.to_stockham), y))
        torch.cuda.synchronize()
        log(f"  [B={B}, R={len(rows)}, N={N}] rows={rows}: K1 max|err|={e_f} "
            f"K2 max|err|={e_i} round trip={rt} fused={fused}; fourstep_fwd "
            f"max|err|={e_3} fourstep_inv max|err|={e_3i} round trip={rt3} "
            f"fused={fused3} fwd[bitrev] == K1: {vs_k1}")
        if e_f or e_i or e_3 or e_3i or not (rt and rt3 and vs_k1 and fused
                                             and fused3):
            raise AssertionError(f"a kernel disagrees at B={B} rows={rows}")

    for B, rows in SHAPES:
        _log_plan_ntt(B, rows, N)
        _log_plan(fs, B, rows, N)

    def ntt_case(c, B, rows, why):
        n = c.n
        x = _residues(c, B, rows, gen)
        y = c.ntt(x, rows)
        back = c.intt(y, rows)
        want_f, want_i = c.ntt_plain(x, rows), c.intt_plain(y, rows)
        e_f = check("ntt_fwd", y, want_f)
        e_i = check("ntt_inv", back, want_i)
        rt = bool(torch.equal(back, x))
        fused = (torch.equal(c.ntt_to_mont(x, rows), c.to_mont(want_f, rows))
                 and torch.equal(c.intt_from_mont(y, rows),
                                 c.from_mont(want_i, rows)))
        torch.cuda.synchronize()
        log(f"  [B={B}, R={len(rows)}, N={n}] ({why}): K1 max|err|={e_f} "
            f"K2 max|err|={e_i} round trip={rt} fused={fused}")
        _log_plan_ntt(B, rows, n)
        if e_f or e_i or not (rt and fused):
            raise AssertionError(f"K1/K2 disagree at B={B} rows={rows} N={n}")

    def fourstep_case(backend, B, rows, why):
        n = backend.fs.base.n
        x = _residues(backend.fs.base, B, rows, gen)
        z = fourstep_fwd(backend.fs, x, rows)
        zb = fourstep_inv(backend.fs, z, rows)
        e_3 = check("fourstep_fwd", z, backend.ntt_plain(x, rows))
        e_3i = check("fourstep_inv", zb, backend.intt_plain(z, rows))
        rt3 = bool(torch.equal(zb, x))
        torch.cuda.synchronize()
        log(f"  [B={B}, R={len(rows)}, N={n}] n1={backend.fs.n1} "
            f"n2={backend.fs.n2} ({why}): fourstep_fwd max|err|={e_3} "
            f"fourstep_inv max|err|={e_3i} round trip={rt3}")
        _log_plan(backend.fs, B, rows, n)
        if e_3 or e_3i or not rt3:
            raise AssertionError(f"four-step kernels disagree at B={B} "
                                 f"rows={rows} N={n}")

    # shapes the tiling makes risky: one polynomial; a batch that is not a
    # multiple of the polynomials per CTA; small N (K1/K2: several
    # polynomials per CTA; four-step: K, M and N below one mma tile are
    # zero-padded); N=16384 (K1/K2: 512 threads, 67.5 KB of dynamic shared
    # memory; four-step: n1 = n2 = 128, one copy of the DFT matrix serves
    # both stages, 216 KB of shared memory)
    ntt_case(ctx, 1, (2,), "B*R = 1")
    ntt_case(ctx, 7, (0, 1, 2), "odd B*R")
    ntt_case(ctx, 133, (0, 1, 2), "uneven polynomials per CTA")
    fourstep_case(fsb, 1, (0, 1, 2), "one polynomial")
    fourstep_case(fsb, 7, (0, 1, 2), "odd B*R")
    fourstep_case(fsb, 133, (0, 1, 2), "uneven polynomials per CTA")
    # N = 64 is the smallest N of two passes, N = 32 and N = 2 run one; at
    # [17001, 4, 32] each CTA slot takes several polynomials in turn
    for n_small, B in ((1024, 6), (256, 8), (128, 5), (64, 9), (32, 17001),
                       (2, 301)):
        ctx_s = NttContext.build(n_small, find_ntt_primes(n_small, L,
                                 reserve_special=K), device="cuda")
        ntt_case(ctx_s, B, (0, 1, 2, 3), "several polynomials per CTA")
        if n_small in (128, 256):
            fourstep_case(FourStepBackend(ctx_s), B, (0, 1, 2, 3),
                          "zero-padded tiles")
    n16 = 16384
    ctx16 = NttContext.build(n16, find_ntt_primes(n16, L, reserve_special=K),
                             device="cuda")
    ntt_case(ctx16, 8, (0, 1, 2), "512 threads, dynamic shared memory")
    fourstep_case(FourStepBackend(ctx16), 8, (0, 1, 2), "shared W")
    del ctx16, ctx_s

    out = {}
    for name, (B, rows) in TIMED.items():
        out[name] = _time_kernel(name, ctx, fsb, B, rows, gen)
        out[name]["max_abs_err"] = err[name]
    ntt_cuda.reset_counts()
    fourstep_cuda.reset_counts()
    torch.cuda.empty_cache()
    return out, ctx, fsb


def _time_kernel(name, ctx, fsb, B, rows, gen, plain=True, plain_runs=21):
    """Kernel (and plain version) ms at [B, len(rows), ctx.n], with the
    bound, after holding the kernel's plain and fused (Montgomery
    conversion folded in) entry points bitwise against the plain version
    there."""
    import torch

    n = ctx.n

    # (entry point, plain version), (fused entry point, conversion)
    calls = {"ntt_fwd": lambda: ((ctx.ntt, ctx.ntt_plain),
                                 (ctx.ntt_to_mont, ctx.to_mont)),
             "ntt_inv": lambda: ((ctx.intt, ctx.intt_plain),
                                 (ctx.intt_from_mont, ctx.from_mont)),
             "fourstep_fwd": lambda: ((fsb.ntt, fsb.ntt_plain),
                                      (fsb.ntt_to_mont, ctx.to_mont)),
             "fourstep_inv": lambda: ((fsb.intt, fsb.intt_plain),
                                      (fsb.intt_from_mont, ctx.from_mont))}
    x = _residues(ctx, B, rows, gen)
    (kern, plain_fn), (kern_f, convert) = calls[name]()
    want = plain_fn(x, rows)
    if not (torch.equal(kern(x, rows), want) and torch.equal(
            kern_f(x, rows), convert(want, rows))):
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"[{B}, {len(rows)}, {n}]")
    ms = _time_ms(lambda: kern(x, rows))
    plain_ms = (_time_ms(lambda: plain_fn(x, rows), runs=plain_runs)
                if plain else None)
    if name.startswith("fourstep"):
        bound_ms, bound_by = _bound_fourstep(B, len(rows), n, fsb.fs.n1,
                                             fsb.fs.n2)
    else:
        bound_ms, bound_by = _bound(B, len(rows), n)
    log(f"  {name} [B={B}, R={len(rows)}, N={n}]: kernel {ms:.4f} ms, plain "
        + (f"{plain_ms:.4f} ms" if plain else "not timed")
        + f", bound {bound_ms:.4f} ms ({bound_by}), held bitwise (plain and "
        "fused entry points)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "shape": [B, len(rows), n]}


def _shape_counts():
    from fhe_spear_tpu_torch.core import fourstep_cuda, ntt_cuda

    stats = {"ntt_fwd": ntt_cuda.NTT_FWD, "ntt_inv": ntt_cuda.NTT_INV,
             "fourstep_fwd": fourstep_cuda.FOURSTEP_FWD,
             "fourstep_inv": fourstep_cuda.FOURSTEP_INV}
    return {k: dict(st.by_shape) for k, st in stats.items()}


def phase_shapes(ctx, fsb, hists, timing):
    """Hold each kernel bitwise against its plain version (plain and fused
    entry points) at every shape its device-client path launched it with in
    the path's last token, then time it there (the plain version at the
    two most frequent), and sum launches x (kernel - bound) over that mix."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)
    path = {"ntt_fwd": "device client stockham",
            "ntt_inv": "device client stockham",
            "fourstep_fwd": "device client mxu",
            "fourstep_inv": "device client mxu"}
    one = torch.zeros(1, device="cuda")
    log("shapes: each kernel at its device-client token's shape mix, held "
        "bitwise against its plain version first; a trivial torch kernel "
        f"(the method's per-launch floor) reads "
        f"{_time_ms(lambda: one.add_(1)):.4f} ms")
    for name in KERNELS:
        hist = hists[path[name]][name]
        rows_out, excess = [], 0.0
        for i, ((B, R, n), cnt) in enumerate(
                sorted(hist.items(), key=lambda kv: -kv[1])):
            if n != N or R > L + K:
                continue
            t = _time_kernel(name, ctx, fsb, B, tuple(range(R)), gen,
                             plain=i < 2)
            t["launches"] = cnt
            excess += cnt * (t["ms"] - t["bound_ms"])
            rows_out.append(t)
        timing[name]["by_shape"] = rows_out
        timing[name]["excess_ms_per_token"] = excess
        log(f"  {name}: launches x (kernel - bound) over the {path[name]} "
            f"token's mix = {excess:.3f} ms")
    torch.cuda.empty_cache()


def _counts():
    from fhe_spear_tpu_torch.core import fourstep_cuda, ntt_cuda

    return {"ntt_fwd": ntt_cuda.NTT_FWD.launches,
            "ntt_inv": ntt_cuda.NTT_INV.launches,
            "fourstep_fwd": fourstep_cuda.FOURSTEP_FWD.launches,
            "fourstep_inv": fourstep_cuda.FOURSTEP_INV.launches}


def _reset_counts():
    from fhe_spear_tpu_torch.core import fourstep_cuda, ntt_cuda

    ntt_cuda.reset_counts()
    fourstep_cuda.reset_counts()


def _drive(tag, fn, corr_bar, must_launch=(), must_not_launch=(),
           hists=None):
    """Run one generation path with the counts set to 0 just before it and
    read just after; check every token against its twin and the counts.
    Prints each token's launches by shape (most frequent first) and, with
    `hists`, keeps the last token's there."""
    import torch

    per_token, per_token_shapes = [], []

    def on_log(msg):
        log(f"  [{tag}] {msg}")
        if msg.startswith("token "):
            per_token.append(_counts())
            per_token_shapes.append(_shape_counts())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    results = fn(on_log)
    torch.cuda.synchronize()
    counts = _counts()
    prev = dict.fromkeys(KERNELS, 0)
    prev_shapes = {k: {} for k in KERNELS}
    token_hist = None
    for i, (c, sh) in enumerate(zip(per_token, per_token_shapes)):
        log(f"  [{tag}] launches token {i}: "
            + " ".join(f"{k}={c[k] - prev[k]}" for k in KERNELS))
        token_hist = {k: {s: n - prev_shapes[k].get(s, 0)
                          for s, n in sh[k].items()
                          if n - prev_shapes[k].get(s, 0)} for k in KERNELS}
        for k in KERNELS:
            if token_hist[k]:
                log(f"  [{tag}]   {k} by [B, R, N]: " + ", ".join(
                    f"{list(s)} x{n}" for s, n in sorted(
                        token_hist[k].items(), key=lambda kv: -kv[1])))
        prev, prev_shapes = c, sh
    if hists is not None:
        hists[tag] = token_hist
    log(f"  [{tag}] total {time.perf_counter() - t0:.2f}s, peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches {counts}")
    for r in results:
        if not r["match"] or not r["corr"] >= corr_bar:
            raise AssertionError(f"{tag}: token off its plaintext twin: "
                                 f"{results}")
    log(f"  [{tag}] tokens: " + ", ".join(f"{r['sec']:.3f}s" for r in results)
        + f"; min corr {min(r['corr'] for r in results):.6f}")
    for k in must_launch:
        if counts[k] == 0:
            raise AssertionError(f"{tag}: kernel {k} never launched")
    for k in must_not_launch:
        if counts[k] != 0:
            raise AssertionError(f"{tag}: kernel {k} launched {counts[k]} "
                                 "times on a path that must not run it")
    return counts


def _context(backend):
    import torch

    from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams
    from fhe_spear_tpu_torch.ops.bsgs import bsgs_dims

    t0 = time.perf_counter()
    ctx = CkksContext(CkksParams(n=N, num_limbs=L, num_special=K,
                                 ntt_backend=backend), seed=0, device=DEVICE)
    G, B = bsgs_dims(D)
    ctx.ensure_galois(tuple(range(1, G)) + tuple(g * G for g in range(1, B)))
    torch.cuda.synchronize()
    log(f"  keygen ({backend}): {time.perf_counter() - t0:.2f}s "
        f"({len(ctx.galois_keys)} Galois keys; "
        f"{ctx.params.security_statement()})")
    return ctx


def _one_block(model):
    from fhe_spear_tpu_torch.models.rwkv7 import RwkvModel

    return RwkvModel(blocks=model.blocks[:1], emb=model.emb,
                     head_w=model.head_w, ln_out_w=model.ln_out_w,
                     ln_out_b=model.ln_out_b, ln0_w=model.ln0_w,
                     ln0_b=model.ln0_b)


def phase_paths(hists):
    import numpy as np
    import torch

    from fhe_spear_tpu_torch.models.client_aided import run_generation, \
        run_generation_batched
    from fhe_spear_tpu_torch.models.device_client import DeviceTokenRunner, \
        run_generation_device
    from fhe_spear_tpu_torch.models.rwkv7 import generate_token_plaintext, \
        make_random_model

    log(f"paths: client-aided RWKV-7 D={D} F={F} N={N} L={L} K={K} "
        f"level {LEVEL}; depth cut to {BLOCKS} of the model's 24 blocks")
    t0 = time.perf_counter()
    model = make_random_model(d=D, f=F, n_blocks=BLOCKS, head_size=HEAD_SIZE,
                              vocab=1000, seed=42)
    one = _one_block(model)
    log(f"  model: {time.perf_counter() - t0:.2f}s")
    ctx = _context("stockham")
    counts = {}

    counts["classic"] = _drive(
        "classic fused i32", lambda lg: run_generation(
            ctx, model, seed_tokens=SEED_TOKENS, num_tokens=2, level=LEVEL,
            fused=True, log_fn=lg, stage_mode="i32"),
        CORR_CLASSIC, must_launch=("ntt_fwd", "ntt_inv"))
    _drive("classic explicit expanded, 1 block", lambda lg: run_generation(
        ctx, one, seed_tokens=SEED_TOKENS, num_tokens=1, level=LEVEL,
        fused=False, log_fn=lg, stage_mode="expanded"),
        CORR_CLASSIC, must_launch=("ntt_fwd", "ntt_inv"))
    torch.cuda.empty_cache()

    counts["device_stockham"] = _drive(
        "device client stockham", lambda lg: run_generation_device(
            ctx, model, seed_tokens=SEED_TOKENS, num_tokens=2, level=LEVEL,
            cache_dir=str(PREENC_CACHE), log_fn=lg),
        CORR_DEVICE, must_launch=("ntt_fwd", "ntt_inv"),
        must_not_launch=("fourstep_fwd", "fourstep_inv"), hists=hists)

    # streams on the stockham context, 1 block
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = DeviceTokenRunner(ctx, one, level=LEVEL,
                               cache_dir=str(PREENC_CACHE))
    log(f"  [device streams] runner init {time.perf_counter() - t0:.2f}s")
    _reset_counts()
    toks = [3, 17, 42, 99]
    t0 = time.perf_counter()
    logits, news = runner.generate_tokens_streams(
        toks, [one.zero_state() for _ in toks])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    corrs = []
    for s, t in enumerate(toks):
        lref, _ = generate_token_plaintext(one, t, one.zero_state())
        corrs.append(float(np.corrcoef(logits[s], lref)[0, 1]))
        if int(np.argmax(logits[s])) != int(np.argmax(lref)) \
                or not corrs[-1] >= CORR_DEVICE:
            raise AssertionError(f"device streams: stream {s} off its twin "
                                 f"(corr {corrs[-1]})")
    log(f"  [device streams, 4 on 1 block] step {dt:.3f}s, every stream "
        f"matches; min corr {min(corrs):.6f}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{_counts()}")
    del runner
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    res = run_generation_batched(ctx, one, None, num_tokens=1, streams=2,
                                 level=LEVEL, verbose=False,
                                 log_fn=lambda m: log(f"  [batched] {m}"),
                                 stage_mode="i32")
    if any(r["match"] != r["streams"] for r in res):
        raise AssertionError(f"batched: a stream is off its twin: {res}")
    log(f"  [batched, 2 streams on 1 block] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{_counts()}")
    del ctx
    torch.cuda.empty_cache()

    ctx_mxu = _context("mxu")
    counts["device_mxu"] = _drive(
        "device client mxu", lambda lg: run_generation_device(
            ctx_mxu, model, seed_tokens=SEED_TOKENS, num_tokens=2,
            level=LEVEL, cache_dir=str(PREENC_CACHE), log_fn=lg),
        CORR_DEVICE, must_launch=("fourstep_fwd", "fourstep_inv"),
        must_not_launch=("ntt_fwd", "ntt_inv"), hists=hists)
    return counts


RET_DIM = 64
RET_SIZES = (1000, 10000, 50000)   # column-packed corpus sizes
RET_ROW_DOCS = 1000                # row-packed corpus size
CORR_RETRIEVAL = 0.9999
RAG_DOCS, RAG_TOKENS = 64, 2
FE_BLOCKS, FE_L, FE_K, FE_DNUM = 3, 11, 8, 8   # bench_fully_enc's, depth cut
FE_W2_L = 9
FE_CORR, FE_ERR = 0.99999, 1e-3
FE_W2_CORR, FE_W2_ERR = 0.9999999, 1e-6
NTT_KERNELS = ("ntt_fwd", "ntt_inv")


def _hist_since(before):
    """K1/K2 launches by [B, R, N] since the `_shape_counts()` snapshot
    `before`."""
    after = _shape_counts()
    return {k: {s: c - before[k].get(s, 0) for s, c in after[k].items()
                if c - before[k].get(s, 0)} for k in NTT_KERNELS}


def _log_hist(tag, hist):
    for k in NTT_KERNELS:
        if hist[k]:
            log(f"  [{tag}]   {k} by [B, R, N]: " + ", ".join(
                f"{list(s)} x{c}" for s, c in sorted(
                    hist[k].items(), key=lambda kv: -kv[1])))


def _must_launch_ntt(tag, counts):
    for k in NTT_KERNELS:
        if counts[k] == 0:
            raise AssertionError(f"{tag}: kernel {k} never launched")


def _wall_ms(fn, runs=3):
    """Median host-clock ms of fn() ending in a device synchronize."""
    import torch

    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[runs // 2]


def phase_retrieval(new_hists):
    """Column-packed CT-CT at 1k/10k/50k docs, row-packed CT-PT and CT-CT
    at 1k, each held against the plaintext Lorentz scores."""
    import numpy as np
    import torch

    from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams
    from fhe_spear_tpu_torch.ops.packing import euclidean_to_lorentz, \
        lorentz_inner
    from fhe_spear_tpu_torch.ops.retrieval import ColumnPackedRetrieval, \
        RowPackedRetrieval

    log(f"retrieval: dim {RET_DIM} Lorentz, N={N}, L=3, K=1 "
        "(CkksParams.retrieval); seeded random unit vectors")
    ctx = CkksContext(CkksParams.retrieval(n=N), seed=0, device=DEVICE)
    rng = np.random.RandomState(0)

    def unit(*shape):
        v = rng.rand(*shape) * 2 - 1
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    def check(tag, scores, docs, q):
        true = lorentz_inner(euclidean_to_lorentz(q),
                             euclidean_to_lorentz(docs))
        corr = float(np.corrcoef(scores, true)[0, 1])
        top, want = int(np.argmax(scores)), int(np.argmax(true))
        if top != want or not corr >= CORR_RETRIEVAL:
            raise AssertionError(f"retrieval {tag}: encrypted top-1 {top} vs "
                                 f"plaintext {want}, corr {corr}")
        return corr

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    start = _shape_counts()
    out = {}
    col = ColumnPackedRetrieval(ctx, RET_DIM)
    for n_docs in RET_SIZES:
        docs, q = unit(n_docs, RET_DIM), unit(RET_DIM)
        t0 = time.perf_counter()
        corpus = col.encrypt_corpus(docs)
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        before = _shape_counts()
        t0 = time.perf_counter()
        ct = col.scores(corpus, col.encrypt_query(q))
        scores = col.decode_scores(ct, n_docs)
        t_query = time.perf_counter() - t0
        query_hist = _hist_since(before)
        qct = col.encrypt_query(q)
        ms = _wall_ms(lambda: col.scores(corpus, qct))
        corr = check(f"column {n_docs}", scores, docs, q)
        out[f"column_{n_docs}"] = {"score_ms": ms,
                                   "us_per_doc": ms * 1e3 / n_docs,
                                   "encrypt_s": t_enc, "query_s": t_query,
                                   "corr": corr,
                                   "chunks": int(corpus.c.shape[0])}
        log(f"  [column CT-CT, {n_docs} docs, {corpus.c.shape[0]} chunks x "
            f"{col.n_coord} ciphertexts] scores {ms:.2f} ms "
            f"({ms * 1e3 / n_docs:.3f} us/doc, median of 3), encrypt corpus "
            f"{t_enc:.2f}s, one query end to end {t_query:.3f}s, top-1 = "
            f"plaintext, corr {corr:.7f}")
        if n_docs == max(RET_SIZES):
            log(f"  [column CT-CT, {n_docs} docs] one query's launches:")
            _log_hist("retrieval query", query_hist)
        del corpus, ct, qct
    row = RowPackedRetrieval(ctx, RET_DIM)
    docs, q = unit(RET_ROW_DOCS, RET_DIM), unit(RET_DIM)
    qct = row.encrypt_query(q)
    for mode in ("ctpt", "ctct"):
        if mode == "ctpt":
            corpus = row.encode_docs(docs)
            fn = lambda: row.scores_ctpt(qct, corpus)
            nb = corpus.p.shape[0]
        else:
            corpus = row.encrypt_docs(docs)
            fn = lambda: row.scores_ctct(qct, corpus)
            nb = corpus.c.shape[0]
        scores = row.decode_scores(fn(), RET_ROW_DOCS)
        ms = _wall_ms(fn)
        corr = check(f"row {mode}", scores, docs, q)
        out[f"row_{mode}_{RET_ROW_DOCS}"] = {"score_ms": ms, "batches": nb,
                                             "ms_per_batch": ms / nb,
                                             "corr": corr}
        log(f"  [row {mode.upper()}, {RET_ROW_DOCS} docs, {nb} batches of "
            f"{row.docs_per_ct}] scores {ms:.2f} ms ({ms / nb:.3f} ms a "
            f"batch, median of 3), top-1 = plaintext, corr {corr:.7f}")
    torch.cuda.synchronize()
    counts = _counts()
    new_hists["retrieval"] = _hist_since(start)
    log(f"  [retrieval] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{counts}")
    _must_launch_ntt("retrieval", counts)
    del ctx, col, row, corpus, qct
    torch.cuda.empty_cache()
    return counts, out


def phase_rag(new_hists):
    """EncryptedRag end to end: retrieval on the card, plaintext prefill,
    client-aided FHE tokens held against their plaintext twins."""
    import numpy as np
    import torch

    from fhe_spear_tpu_torch.apps.rag import EncryptedRag

    log(f"rag: {RAG_DOCS} synthetic passages, row CT-CT retrieval (N=2048), "
        f"client-aided RWKV-7 D={D} F={F} N={N}, 1 block, {RAG_TOKENS} tokens")
    passages = [f"synthetic passage number {i} about topic {i % 7}"
                for i in range(RAG_DOCS)]
    question = "synthetic passage about topic 3"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    start = _shape_counts()
    t0 = time.perf_counter()
    rag = EncryptedRag(passages, retrieval_mode="row", d=D, f=F, n_blocks=1,
                       gen_n=N, device=DEVICE)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    res = rag.answer(question, num_tokens=RAG_TOKENS, verbose=False)
    torch.cuda.synchronize()
    counts = _counts()
    new_hists["rag"] = _hist_since(start)
    plain_top = int(np.argmax(rag.retriever.plaintext_scores(question)))
    log(f"  [rag] init {t_init:.2f}s (index + model + server pre-encode); "
        f"retrieved #{res['passage_idx']} (plaintext top-1 #{plain_top}) in "
        f"{res['retrieval_s']:.3f}s; prefill {res['prefill_s']:.2f}s; tokens "
        + ", ".join(f"{t:.3f}s" for t in res["token_s"])
        + f" fhe {res['tokens']} plaintext {res['plaintext_tokens']}; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches {counts}")
    if res["passage_idx"] != plain_top or \
            res["tokens"] != res["plaintext_tokens"]:
        raise AssertionError(f"rag: off its plaintext twin: {res}")
    _must_launch_ntt("rag", counts)
    del rag
    torch.cuda.empty_cache()
    return counts, {"retrieval_s": res["retrieval_s"],
                    "token_s": res["token_s"], "init_s": t_init}


def _fe_weights():
    """bench_fully_enc's weights (default_rng(42), key then value per
    block) and x0 (default_rng(4242)) for the first FE_BLOCKS blocks."""
    import numpy as np

    rng = np.random.default_rng(42)
    wk, wv = [], []
    for _ in range(FE_BLOCKS):
        wk.append(rng.standard_normal((D, F)) / np.sqrt(D))
        wv.append(rng.standard_normal((F, D)) / np.sqrt(F))
    return wk, wv, np.random.default_rng(4242).uniform(-1, 1, D)


def _fe_run(tag, ctx, eng, wk, wv, x0, hosts, corr_bar, err_bar):
    """One pass of run_fully_encrypted with the K1/K2 launches of each
    block by shape; every block held to the plaintext oracle."""
    import torch

    from fhe_spear_tpu_torch.models.fully_encrypted import \
        run_fully_encrypted

    snaps = []

    def on_log(msg):
        log(f"  [{tag}] {msg.strip()}")
        if msg.strip().startswith("block "):
            snaps.append(_shape_counts())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = _shape_counts()
    stats = run_fully_encrypted(ctx, wk, wv, x0, pre_encoded=hosts, eng=eng,
                                calibrated=True, verbose=False, log_fn=on_log)
    peak = torch.cuda.max_memory_allocated() / 2**30
    prev = start
    for i, snap in enumerate(snaps):
        hist = {k: {s: c - prev[k].get(s, 0) for s, c in snap[k].items()
                    if c - prev[k].get(s, 0)} for k in NTT_KERNELS}
        log(f"  [{tag}] block {i} launches: " + " ".join(
            f"{k}={sum(hist[k].values())}" for k in NTT_KERNELS))
        _log_hist(tag, hist)
        prev = snap
    if len(stats) != len(hosts):
        raise AssertionError(f"{tag}: {len(stats)} of {len(hosts)} blocks ran")
    for st in stats:
        if not (st["corr"] > corr_bar and st["max_err"] < err_bar):
            raise AssertionError(f"{tag}: block off the plaintext oracle "
                                 f"(corr > {corr_bar}, max_err < {err_bar}): "
                                 f"{stats}")
    log(f"  [{tag}] peak device memory {peak:.2f} GiB")
    return stats, peak


def phase_fullenc(new_hists):
    """The fully-encrypted FFN chain at full width (depth cut), then one
    width-2 block."""
    import numpy as np
    import torch

    from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams
    from fhe_spear_tpu_torch.models.fully_encrypted import (
        FullyEncryptedFfn, calibrate_magnitude, fe_level_schedule,
        pre_encode_blocks)

    t0 = time.perf_counter()
    wk, wv, x0 = _fe_weights()
    wk, wv = calibrate_magnitude(wk, wv, x0)
    log(f"fullenc: D={D} F={F} N={N}, {FE_BLOCKS} blocks, L={FE_L} K={FE_K} "
        f"dnum={FE_DNUM}, i32 staging ({time.perf_counter() - t0:.2f}s "
        "weights + calibration)")
    _reset_counts()
    start = _shape_counts()
    t0 = time.perf_counter()
    ctx = CkksContext(CkksParams(n=N, num_limbs=FE_L, num_special=FE_K,
                                 dnum=FE_DNUM), seed=0, device=DEVICE)
    eng = FullyEncryptedFfn(ctx, D, F, stage_mode="i32")
    torch.cuda.synchronize()
    log(f"  keygen: {time.perf_counter() - t0:.2f}s ({ctx.dnum} digits of "
        f"{ctx.gsize} limbs, {len(ctx.galois_keys)} Galois keys; "
        f"{ctx.params.security_statement()})")
    levels = fe_level_schedule(FE_L, FE_BLOCKS)
    if levels != [11, 8, 5]:
        raise AssertionError(f"fe_level_schedule: {levels}")
    t0 = time.perf_counter()
    hosts = pre_encode_blocks(eng, wk, wv, levels=levels)
    log(f"  pre-encode ({FE_BLOCKS} blocks at levels {levels}): "
        f"{time.perf_counter() - t0:.2f}s")
    passes = []
    for ps in range(2):
        t0 = time.perf_counter()
        stats, peak = _fe_run(f"fullenc pass {ps}", ctx, eng, wk, wv, x0,
                              hosts, FE_CORR, FE_ERR)
        passes.append({"stats": stats, "peak_gib": peak,
                       "total_s": time.perf_counter() - t0})
    sec = [s["sec"] for s in passes[-1]["stats"]]
    log(f"  [fullenc] s/block (pass 1): " + ", ".join(f"{x:.3f}" for x in sec)
        + f"; mean {float(np.mean(sec)):.3f}; corr "
        + ", ".join(f"{s['corr']:.9f}" for s in passes[-1]["stats"])
        + "; max_err " + ", ".join(f"{s['max_err']:.2e}"
                                   for s in passes[-1]["stats"]))
    del eng, hosts, ctx
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ctx2 = CkksContext(CkksParams(n=N, num_limbs=FE_W2_L, num_special=FE_K,
                                  dnum=FE_DNUM), seed=0, device=DEVICE)
    eng2 = FullyEncryptedFfn(ctx2, D, F, stage_mode="i32", width=2)
    lv2 = fe_level_schedule(FE_W2_L, 1, width=2)
    hosts2 = pre_encode_blocks(eng2, wk[:1], wv[:1], levels=lv2)
    log(f"  width 2: L={FE_W2_L}, keygen + wide pre-encode at levels {lv2}: "
        f"{time.perf_counter() - t0:.2f}s")
    stats2, peak2 = _fe_run("fullenc width 2", ctx2, eng2, wk[:1], wv[:1], x0,
                            hosts2, FE_W2_CORR, FE_W2_ERR)
    torch.cuda.synchronize()
    counts = _counts()
    new_hists["fullenc"] = _hist_since(start)
    log(f"  [fullenc] launches {counts}")
    _must_launch_ntt("fullenc", counts)
    del eng2, hosts2, ctx2
    torch.cuda.empty_cache()
    return counts, {"passes": passes, "width2": stats2, "width2_peak_gib":
                    peak2}


def phase_new_shapes(new_hists, timing):
    """Hold K1/K2 bitwise (plain and fused entry points) at the largest
    shape (most polynomials, then most launches) each new path launched,
    and time them there (plain version: median of 5)."""
    import torch

    from fhe_spear_tpu_torch.core.ntt import NttContext
    from fhe_spear_tpu_torch.core.primes import find_ntt_primes

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    picks = []
    for tag, hist in new_hists.items():
        for name in NTT_KERNELS:
            (B, R, n), cnt = max(hist[name].items(),
                                 key=lambda kv: (kv[0][0] * kv[0][1], kv[1]))
            picks.append((tag, name, B, R, n, cnt))
    rows_by_n = {}
    for _, _, _, R, n, _ in picks:
        rows_by_n[n] = max(rows_by_n.get(n, 0), R)
    ctxs = {n: NttContext.build(n, find_ntt_primes(n, R), device="cuda")
            for n, R in rows_by_n.items()}
    log("new shapes: K1/K2 at the largest shape each new path launched, "
        "held bitwise first")
    for tag, name, B, R, n, cnt in picks:
        t = _time_kernel(name, ctxs[n], None, B, tuple(range(R)), gen,
                         plain_runs=5)
        t["launches"], t["path"] = cnt, tag
        timing[name].setdefault("largest_by_path", []).append(t)
        log(f"    ({tag}: {cnt} launches at this shape)")
    torch.cuda.empty_cache()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    t_start = time.perf_counter()
    phase_device()
    import torch

    phase_build()
    log("kernels: K1/K2 and fourstep_fwd/fourstep_inv against their plain "
        "torch versions")
    timing, kctx, kfsb = phase_kernels()
    if "--kernels-only" in argv:
        log(json.dumps({"kernel_timing": timing}))
        return
    hists, new_hists, split = {}, {}, {}
    t0 = time.perf_counter()
    counts = phase_paths(hists)
    split["generation paths"] = time.perf_counter() - t0
    results = {}
    for tag, phase in (("retrieval", phase_retrieval), ("rag", phase_rag),
                       ("fullenc", phase_fullenc)):
        t0 = time.perf_counter()
        counts[tag], results[tag] = phase(new_hists)
        split[tag] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_shapes(kctx, kfsb, hists, timing)
    phase_new_shapes(new_hists, timing)
    split["shapes"] = time.perf_counter() - t0
    log("phase split: " + ", ".join(f"{k} {v:.1f}s" for k, v in split.items()))
    # launches: K1/K2 from the first slice's path (classic fused
    # transport), the four-step pair from this slice's (device client on
    # the mxu backend); every phase's counts are in launches_by_path
    main_path = {"ntt_fwd": "classic", "ntt_inv": "classic",
                 "fourstep_fwd": "device_mxu", "fourstep_inv": "device_mxu"}
    replaces = {
        "ntt_fwd": ("fhe_spear_tpu_torch/csrc/ntt.cu",
                    "fhe_spear_tpu/core/ntt_pallas.py:144"),
        "ntt_inv": ("fhe_spear_tpu_torch/csrc/ntt.cu",
                    "fhe_spear_tpu/core/ntt_pallas.py:199"),
        "fourstep_fwd": ("fhe_spear_tpu_torch/csrc/fourstep.cu",
                         "fhe_spear_tpu/core/fourstep_pallas.py:137"),
        "fourstep_inv": ("fhe_spear_tpu_torch/csrc/fourstep.cu",
                         "fhe_spear_tpu/parallel/ntt_fourstep.py:268"),
    }
    kernels = []
    for name in KERNELS:
        t = timing[name]
        src, rep = replaces[name]
        kernels.append({
            "name": name, "status": "ported; bitwise equal to plain",
            "route": "cuda", "source": src, "replaces": rep,
            "launches": counts[main_path[name]][name],
            "launches_by_path": {p: c[name] for p, c in counts.items()},
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "shape": t["shape"], "by_shape": t["by_shape"],
            "excess_ms_per_token": t["excess_ms_per_token"],
            "largest_by_path": t.get("largest_by_path", [])})
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)


if __name__ == "__main__":
    main()
