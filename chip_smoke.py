"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --kernels-only  # build + kernel checks only
    python3 chip_smoke.py --only=naive,checkpoints  # build, kernel checks,
        # the named phases (paths = 4-7) and phase 18; no device line
    python3 chip_smoke.py --only=parallel  # build, kernel checks, phase 17

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
     and depth (3 tokens: the server projections run eagerly, are
     captured as CUDA graphs, then replay; the replayed token must count
     the capturing token's launches by shape); K1/K2 launches must rise;
  6. device client, mxu: the same 3 tokens on a four-step ("mxu") context;
     fourstep_fwd/fourstep_inv launches must rise and K1/K2 stay at 0;
  7. streams: `generate_tokens_streams` with 4 streams on 1 block, 3
     steps (the third replays, as in 5), and `run_generation_batched`
     with 2 streams on 1 block, 1 token.
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
 11. bootstrap: one refresh at N=16384 (`CkksParams.bootstrap`, L=46, K=8,
     dnum=6, h=64; `Bootstrapper` width 2, radix 4, exp_degree 31, margin
     3) of a seeded uniform(-0.8, 0.8) message at level 2, twice (the
     first call encodes the stage diagonals): corr > 0.99999, max_err <
     1e-2, and a key stack must hold the identity key (the last
     SlotToCoeff group's giant step is 0 mod slots); then a 2-block chain
     through `run_fully_encrypted` at D=2048, F=8192 on the same context,
     `min_levels` set so that one refresh falls between the blocks: each
     block corr > 0.99999 and max_err < 1e-2 against the plaintext
     oracle, with exactly 1 bootstrap;
 12. access control: the `access-control` CLI's defaults (30 passages,
     dim 32, N=2048, noise scale 100, seed 0) through
     `AccessControlledCorpus`: the authorized top-1 is the plaintext
     top-1, the unauthorized one is not, and the separation grows with
     the noise scale; then `generation_demo` at D=2048, F=8192, 1 block,
     N=8192, 2 tokens: the authorized user's tokens equal the plaintext
     twin's, and the two users' outputs differ.  K1/K2 launch counts must
     rise in each of phases 8-12;
 13. fhesim: on `CkksParams.retrieval(8192)` seed 0, the noise constant
     over dims 8-64 and the 4-band `validate` through the port's CT-CT
     column engine (bands 2 and 3 must pass; band 1, against the shipped
     constant for N=8192, is printed and recorded), then
     `benchmark_speed.run` at N=8192 and 16384 over 50k seeded unit vectors
     at dim 64 (simulator ms, real ms synchronised, speed-up);
 14. naive ablation: `naive_ablation` (the FFN block x + (x@Wk)^2 @ Wv) at
     D=2048, F=8192 on CkksParams(16384, 3, 1) in column batches, each
     projection's seconds and rotations beside BSGS's, corr > 0.99999
     against the plaintext; then `naive_multilayer` (plain and residual)
     and `naive_autoregressive` (2 tokens) at d=64, f=256, vocab 64, 2
     blocks on CkksParams(8192, 8, 1), token-exact with logit corr > 0.999;
 15. checkpoints: an owner's `BsgsMatvec(owner, 2048)` keys saved and
     loaded by a server whose engine built its key stacks before the load;
     the server's matvec equals the owner's word for word (the key epoch
     rebuilt the stacks), the owner decrypts it to w @ x within 1e-3 and
     the server's own key does not; secret key, ciphertext and a 24-block
     D=2048 generation state survive round trips;
 16. profiling: `utils.profiling.trace` around one D=2048 matvec writes a
     torch.profiler trace holding K1 (`ntt_fwd_kernel`) events;
 17. parallel: the multi-device modules at full width, in three spawns of
     ranks on the card (`parallel.collectives.run_ranks`; gloo ranks all
     on cuda:0 with collectives staged through the host, so times are the
     cost of each rank, not scaling), launches counted inside the ranks
     and reported by rank 0, every replicated result equal on every rank:
     (a) 3 gloo ranks: the giant-sharded matvec (`ShardedBsgsMatvec`,
     D=2048, B=45 groups, 15 a rank) on CkksParams(8192, 3, 1) seed 0 at
     level 3, stockham (max_err < 2e-3 against W @ x; K1/K2 launch, the
     four-step pair does not) and mxu (< 5e-3; the four-step pair
     launches, K1/K2 do not); the sharded server's explicit-transport
     token (`ShardedFheRwkvServer`, the paths' model, 2 blocks, 2 tokens,
     each equal to its twin with corr >= 0.9999); the sharded
     fully-encrypted chain (`ShardedFullyEncryptedFfn`, phase 10's chain:
     every block corr > 0.99999, max_err < 1e-3);
     (b) 1 NCCL rank: the giant matvec again, and psum_mod /
     all_gather_rows / all_to_all of int64 on the device;
     (c) 2 gloo ranks: one limb-sharded rotation (`LimbShardedRotator`) at
     N=16384, L=46, K=8, one digit per limb, level 46 (words equal
     `ctx.rotate` on the same rank); phase 10's chain with its keys
     limb-sharded (`shard_eval_keys`; words equal the unsharded chain's);
     `FourStepNtt.ntt_sharded` at N=8192 on 3 rows (words equal
     `FourStepNtt.ntt`); the block pipeline (`BlockPipeline`, 2 blocks
     over 2 ranks, 2 streams, 2 tokens, each stream equal to its twin with
     corr >= 0.999);
 18. hold every kernel bitwise against its plain version (plain and fused
     entry points) at each shape the device-client paths launched it with
     in their last token, time it there (plain version at the two most
     frequent), and sum launches x (time - bound) over that shape mix;
     hold K1/K2 the same way at the largest shapes phases 8-12 and 14
     launched, at the shapes of one refresh that carry the most work (and
     ModRaise's), at the naive block's most frequent shape, and at the
     largest limb-row shapes of phase 17's limb rotation and key-sharded
     chain, and time them there;
 19. print the kernels line, then the device line last.
 K1/K2 launch counts must rise in each of phases 8-16.

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
# the device client's tokens: the first runs its projections eagerly, the
# second captures them as CUDA graphs, the third replays them
DEVICE_TOKENS = 3
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


def _graphs_since(before):
    from fhe_spear_tpu_torch.utils.profiling import GRAPHS

    return {k: n - before[k] for k, n in GRAPHS.items()}


def _check_replay(tag, hists, graphs):
    """The projections' CUDA graphs (`ops.graphed`): the last of the
    tokens `hists`/`graphs` (each token's launches by shape and GRAPHS
    deltas) replayed every projection the token before captured, ran
    none eagerly, and counts the launches the capturing token counted."""
    if len(graphs) < 3:
        raise AssertionError(f"{tag}: {len(graphs)} tokens, a replay "
                             "needs 3")
    cap, rep = graphs[-2], graphs[-1]
    if not (cap["captures"] > 0 and rep == {"captures": 0, "eager": 0,
                                            "replays": cap["captures"]}):
        raise AssertionError(f"{tag}: graphs by token {graphs}, the last "
                             "token must replay what the one before "
                             "captured")
    if hists[-1] != hists[-2]:
        raise AssertionError(f"{tag}: a replayed token's launches by shape "
                             f"{hists[-1]} differ from the capturing "
                             f"token's {hists[-2]}")
    log(f"  [{tag}] graphs by token: {graphs}; the replayed token's "
        "launches by shape equal the capturing token's")


def _drive(tag, fn, corr_bar, must_launch=(), must_not_launch=(),
           hists=None, graphed=False):
    """Run one generation path with the counts set to 0 just before it and
    read just after; check every token against its twin and the counts.
    Prints each token's launches by shape (most frequent first) and, with
    `hists`, keeps the last token's there.  `graphed`: the path's server
    projections are CUDA graphs, and its last token must replay them
    (`_check_replay`)."""
    import torch

    from fhe_spear_tpu_torch.utils.profiling import GRAPHS

    per_token, per_token_shapes, per_token_graphs = [], [], []
    graphs_before = dict(GRAPHS)

    def on_log(msg):
        nonlocal graphs_before
        log(f"  [{tag}] {msg}")
        if msg.startswith("token "):
            per_token.append(_counts())
            per_token_shapes.append(_shape_counts())
            per_token_graphs.append(_graphs_since(graphs_before))
            graphs_before = dict(GRAPHS)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    results = fn(on_log)
    torch.cuda.synchronize()
    counts = _counts()
    prev = dict.fromkeys(KERNELS, 0)
    prev_shapes = {k: {} for k in KERNELS}
    token_hist, token_hists = None, []
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
        token_hists.append(token_hist)
    if hists is not None:
        hists[tag] = token_hist
    if graphed:
        _check_replay(tag, token_hists, per_token_graphs)
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
    from fhe_spear_tpu_torch.utils.profiling import GRAPHS

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
            ctx, model, seed_tokens=SEED_TOKENS, num_tokens=DEVICE_TOKENS,
            level=LEVEL, cache_dir=str(PREENC_CACHE), log_fn=lg),
        CORR_DEVICE, must_launch=("ntt_fwd", "ntt_inv"),
        must_not_launch=("fourstep_fwd", "fourstep_inv"), hists=hists,
        graphed=True)

    # streams on the stockham context, 1 block
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = DeviceTokenRunner(ctx, one, level=LEVEL,
                               cache_dir=str(PREENC_CACHE))
    log(f"  [device streams] runner init {time.perf_counter() - t0:.2f}s")
    _reset_counts()
    toks = [3, 17, 42, 99]
    states = [one.zero_state() for _ in toks]
    refs = [one.zero_state() for _ in toks]
    step_hists, step_graphs, dts, corrs = [], [], [], []
    for step in range(DEVICE_TOKENS):     # eager, capture, replay
        shapes, graphs = _shape_counts(), dict(GRAPHS)
        t0 = time.perf_counter()
        logits, states = runner.generate_tokens_streams(toks, states)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
        step_graphs.append(_graphs_since(graphs))
        step_hists.append(_hist_since(shapes))
        for s, t in enumerate(toks):
            lref, refs[s] = generate_token_plaintext(one, t, refs[s])
            corrs.append(float(np.corrcoef(logits[s], lref)[0, 1]))
            if int(np.argmax(logits[s])) != int(np.argmax(lref)) \
                    or not corrs[-1] >= CORR_DEVICE:
                raise AssertionError(f"device streams: stream {s} off its "
                                     f"twin at step {step} (corr "
                                     f"{corrs[-1]})")
    _check_replay("device streams", step_hists, step_graphs)
    log(f"  [device streams, 4 on 1 block] steps "
        + ", ".join(f"{dt:.3f}s" for dt in dts) + ", every stream "
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
            ctx_mxu, model, seed_tokens=SEED_TOKENS, num_tokens=DEVICE_TOKENS,
            level=LEVEL, cache_dir=str(PREENC_CACHE), log_fn=lg),
        CORR_DEVICE, must_launch=("fourstep_fwd", "fourstep_inv"),
        must_not_launch=("ntt_fwd", "ntt_inv"), hists=hists, graphed=True)
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
# the 24-block chain's refresh (bench_fully_enc BENCH_BOOTSTRAP=1 at N=16384)
BOOT_N, BOOT_L, BOOT_K, BOOT_DNUM, BOOT_H, BOOT_RADIX = 16384, 46, 8, 6, 64, 4
BOOT_CORR, BOOT_ERR = 0.99999, 1e-2
AC_DOCS, AC_DIM, AC_N, AC_TOKENS = 30, 32, 2048, 2   # the CLI's defaults


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


def phase_bootstrap(new_hists):
    """One refresh at N=16384 with the chain's parameters, then a 2-block
    chain with one refresh between the blocks, on the same context."""
    import numpy as np
    import torch

    from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams
    from fhe_spear_tpu_torch.ckks.bootstrap import Bootstrapper
    from fhe_spear_tpu_torch.models.fully_encrypted import (
        FullyEncryptedFfn, calibrate_magnitude, fe_level_schedule,
        pre_encode_blocks, run_fully_encrypted)

    log(f"bootstrap: N={BOOT_N}, L={BOOT_L}, K={BOOT_K}, dnum={BOOT_DNUM}, "
        f"h={BOOT_H}; width 2, radix {BOOT_RADIX}, exp_degree 31, margin 3")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    start = _shape_counts()
    t0 = time.perf_counter()
    ctx = CkksContext(CkksParams.bootstrap(n=BOOT_N, num_limbs=BOOT_L,
                                           num_special=BOOT_K, hamming=BOOT_H,
                                           dnum=BOOT_DNUM),
                      seed=0, device=DEVICE)
    bt = Bootstrapper(ctx, exp_degree=31, radix=BOOT_RADIX, evalmod_width=2,
                      margin_bits=3)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    stage_groups = len(bt._c2s_f) + len(bt._s2c_f)
    log(f"  context + bootstrapper: {t_setup:.2f}s ({len(ctx.galois_keys)} "
        f"Galois keys, {stage_groups} stage groups, EvalMod r={bt.r}, "
        f"K={bt.K}; {ctx.params.security_statement()})")
    m = np.random.default_rng(1).uniform(-0.8, 0.8, ctx.slots)
    ct = ctx.mod_switch_to(ctx.encrypt(m), 2)
    refresh = {}
    for call in ("first", "steady"):
        before = _shape_counts()
        t0 = time.perf_counter()
        out = bt.bootstrap(ct)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = ctx.decrypt_vec(out)
        err = float(np.abs(got - m).max())
        corr = float(np.corrcoef(got, m)[0, 1])
        refresh[call] = {"s": dt, "max_err": err, "corr": corr,
                         "level": out.level}
        log(f"  [refresh, {call} call] {dt:.3f}s -> level {out.level}, "
            f"max_err {err:.3e}, corr {corr:.9f}")
        if not (corr > BOOT_CORR and err < BOOT_ERR):
            raise AssertionError(f"bootstrap: refresh off its message (corr "
                                 f"> {BOOT_CORR}, max_err < {BOOT_ERR}): "
                                 f"{refresh}")
    hist = _hist_since(before)
    new_hists["refresh"] = hist
    log("  [refresh] one steady refresh's launches: " + " ".join(
        f"{k}={sum(hist[k].values())}" for k in NTT_KERNELS))
    _log_hist("refresh", hist)
    ident = [i for i, g in enumerate(bt._s2c_f)
             if any(ctx.galois_element(st) == 1
                    for st in g.eng.baby_steps + g.eng.giant_steps)]
    if not hasattr(ctx, "_identity_ksk") or not ident:
        raise AssertionError("bootstrap: no key stack used the identity key")
    log(f"  [refresh] identity key used by SlotToCoeff group(s) {ident} "
        f"(giant steps {[bt._s2c_f[i].eng.giant_steps for i in ident]}, "
        f"slots {ctx.slots}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # a 2-block chain, refreshed between the blocks
    landing = refresh["steady"]["level"]
    wk, wv, x0 = _fe_weights()
    wk, wv = calibrate_magnitude(wk[:2], wv[:2], x0)
    min_levels = BOOT_L - 3
    levels = fe_level_schedule(BOOT_L, 2, min_levels=min_levels,
                               boot_level=landing)
    t0 = time.perf_counter()
    eng = FullyEncryptedFfn(ctx, D, F, stage_mode="i32")
    nd = ctx.drop_galois_keys(drop=eng.eng.warm_stacks()
                              - bt.galois_elements())
    hosts = pre_encode_blocks(eng, wk, wv, levels=levels)
    torch.cuda.synchronize()
    log(f"  [chain] D={D} F={F}, 2 blocks at levels {levels} "
        f"(min_levels {min_levels}): keys + stack + pre-encode "
        f"{time.perf_counter() - t0:.2f}s, {nd} raw keys dropped")
    msgs = []
    boot_s = []

    def boot_fn(c):
        t1 = time.perf_counter()
        o = bt.bootstrap(c)
        torch.cuda.synchronize()
        boot_s.append(time.perf_counter() - t1)
        return o

    t0 = time.perf_counter()
    stats = run_fully_encrypted(ctx, wk, wv, x0, bootstrap_fn=boot_fn,
                                min_levels=min_levels, pre_encoded=hosts,
                                eng=eng, calibrated=True, verbose=False,
                                log_fn=msgs.append)
    t_chain = time.perf_counter() - t0
    for msg in msgs:
        log(f"  [chain] {msg.strip()}")
    if len(stats) != 2 or stats[-1]["bootstraps"] != 1:
        raise AssertionError(f"bootstrap chain: {stats}")
    for st in stats:
        if not (st["corr"] > BOOT_CORR and st["max_err"] < BOOT_ERR):
            raise AssertionError(f"bootstrap chain: block off the plaintext "
                                 f"oracle: {stats}")
    if any("re-encode" in msg for msg in msgs):
        raise AssertionError("bootstrap chain: the refresh landed off the "
                             "planned level")
    torch.cuda.synchronize()
    counts = _counts()
    new_hists["bootstrap"] = _hist_since(start)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  [bootstrap] chain {t_chain:.2f}s (refresh {boot_s[0]:.3f}s), "
        f"peak device memory {peak:.2f} GiB, launches {counts}")
    _must_launch_ntt("bootstrap", counts)
    del eng, hosts, bt, ctx, out, ct
    torch.cuda.empty_cache()
    return counts, {"refresh": refresh, "chain": stats, "chain_s": t_chain,
                    "chain_refresh_s": boot_s, "setup_s": t_setup,
                    "peak_gib": peak}


def phase_access_control(new_hists):
    """The access-control CLI's defaults through AccessControlledCorpus,
    then per-user generation on the retrieved passage at full width."""
    import numpy as np
    import torch

    from fhe_spear_tpu_torch.apps.access_control import (
        AccessControlledCorpus, classify_passage, generation_demo,
        security_sweep)
    from fhe_spear_tpu_torch.apps.demo import hashed_embed, svd_compress
    from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams
    from fhe_spear_tpu_torch.models.client_aided import FheRwkvClient, \
        FheRwkvServer
    from fhe_spear_tpu_torch.models.rwkv7 import make_random_model
    from fhe_spear_tpu_torch.ops.packing import euclidean_to_lorentz, \
        lorentz_inner

    log(f"access control: the CLI's defaults ({AC_DOCS} passages, dim "
        f"{AC_DIM}, N={AC_N}, noise scale 100, seed 0), then generation at "
        f"D={D} F={F} N={N}, 1 block, {AC_TOKENS} tokens")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    start = _shape_counts()
    passages = [f"Revenue was ${i}.5 million in 2020 for org {i}"
                if i % 2 else f"plain passage {i}" for i in range(AC_DOCS)]
    classes = [classify_passage(p) for p in passages]
    z, _ = svd_compress(hashed_embed(passages), AC_DIM)
    t0 = time.perf_counter()
    ctx = CkksContext(CkksParams(n=AC_N, num_limbs=3, num_special=1), seed=0,
                      device=DEVICE)
    corpus = AccessControlledCorpus(ctx, dim=z.shape[1], noise_scale=100.0,
                                    seed=0)
    corpus.build(z, classes)
    all_classes = set(corpus.classes)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    plain = lorentz_inner(euclidean_to_lorentz(z[0]), euclidean_to_lorentz(z))
    want = int(np.argmax(plain))
    out = {}
    for user, auth in (("authorized", all_classes), ("unauthorized", set())):
        t0 = time.perf_counter()
        scores = corpus.retrieve(z[0], corpus.apply_corrections(
            corpus.corrections_for(auth)))
        out[user] = {"top1": int(np.argmax(scores)),
                     "s": time.perf_counter() - t0,
                     "corr": float(np.corrcoef(scores, plain)[0, 1])}
    sweep = security_sweep(corpus, z, classes)
    seps = [r["separation"] for r in sweep]
    log(f"  [access control] classes {sorted(all_classes)}; corpus build "
        f"{t_build:.2f}s; plaintext top-1 #{want}; authorized top-1 "
        f"#{out['authorized']['top1']} (score corr "
        f"{out['authorized']['corr']:.6f}, {out['authorized']['s']:.3f}s); "
        f"unauthorized top-1 #{out['unauthorized']['top1']} (score corr "
        f"{out['unauthorized']['corr']:.4f}); separation by noise scale "
        + ", ".join(f"{r['scale']}: {r['separation']:.1f}x" for r in sweep))
    if out["authorized"]["top1"] != want or out["unauthorized"]["top1"] == want:
        raise AssertionError(f"access control: top-1s {out} vs plaintext "
                             f"#{want}")
    if any(b <= a for a, b in zip(seps, seps[1:])):
        raise AssertionError(f"access control: separation does not grow "
                             f"with the noise scale: {sweep}")

    t0 = time.perf_counter()
    model = make_random_model(d=D, f=F, n_blocks=1, head_size=HEAD_SIZE,
                              vocab=1000, seed=1)
    gen_ctx = CkksContext(CkksParams(n=N, num_limbs=3, num_special=1),
                          seed=2, device=DEVICE)
    client = FheRwkvClient(gen_ctx, model, FheRwkvServer(gen_ctx, model,
                                                         level=3))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = generation_demo(corpus, passages, z[0],
                          "Based on the text above, the key figure is",
                          {"alice": all_classes, "bob": set()}, client,
                          num_tokens=AC_TOKENS)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    log(f"  [access control] generation: model + keys + server "
        f"{t_init:.2f}s; two users {t_gen:.2f}s; alice retrieved "
        f"#{res['alice']['retrieved']} tokens {res['alice']['tokens']} "
        f"({res['alice']['token_matches']}/{AC_TOKENS} = plaintext); bob "
        f"retrieved #{res['bob']['retrieved']} tokens {res['bob']['tokens']} "
        f"({res['bob']['token_matches']}/{AC_TOKENS} = plaintext); outputs "
        f"differ: {res['outputs_differ']}")
    if res["alice"]["token_matches"] != AC_TOKENS or \
            res["alice"]["retrieved"] != want or not res["outputs_differ"]:
        raise AssertionError(f"access control: generation {res}")
    torch.cuda.synchronize()
    counts = _counts()
    new_hists["access_control"] = _hist_since(start)
    log(f"  [access control] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{counts}")
    _must_launch_ntt("access control", counts)
    del client, gen_ctx, corpus, ctx
    torch.cuda.empty_cache()
    return counts, {"retrieval": out, "sweep": sweep, "generation_s": t_gen,
                    "alice": res["alice"]["tokens"], "bob": res["bob"]["tokens"]}


FHESIM_N, FHESIM_DIMS, FHESIM_DOCS, FHESIM_DIM = N, (8, 16, 32, 64), 50000, 64
FHESIM_RINGS = (8192, 16384)
NAIVE_N, NAIVE_L, NAIVE_K = 16384, 3, 1
NAIVE_CORR = 0.99999
CHAIN_D, CHAIN_F, CHAIN_VOCAB, CHAIN_BLOCKS = 64, 256, 64, 2  # depth cut
CHAIN_N, CHAIN_L, CHAIN_TOKENS, CHAIN_CORR = 8192, 8, 2, 0.999
CKPT_BLOCKS, CKPT_HEAD = 24, 64      # the generation state's depth, head
TRACE_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_trace"


def phase_fhesim(new_hists):
    """fhesim on the retrieval ring: the noise constant over four dims,
    the 4-band `validate` (bands 2-3 must pass; band 1's verdict is
    recorded), and `benchmark_speed` at 50k docs on two rings."""
    import torch

    from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams
    from fhe_spear_tpu_torch.fhesim import calibrate
    from fhe_spear_tpu_torch.fhesim.benchmark_speed import run as speed_run

    log(f"fhesim: CkksParams.retrieval({FHESIM_N}) seed 0, the port's CT-CT "
        f"column engine; benchmark_speed over {FHESIM_DOCS} seeded unit "
        f"vectors at dim {FHESIM_DIM}, N={FHESIM_RINGS}")
    torch.cuda.synchronize()
    _reset_counts()
    start = _shape_counts()
    ctx = CkksContext(CkksParams.retrieval(FHESIM_N), seed=0, device=DEVICE)
    t0 = time.perf_counter()
    c, per_dim = calibrate.measure_noise_constant(ctx, dims=FHESIM_DIMS)
    log(f"  [fhesim] noise constant c = {c:.4e} ({time.perf_counter() - t0:.2f}"
        "s); sigma by dim: " + ", ".join(f"{d}: {s:.4e}"
                                         for d, s in per_dim.items()))
    t0 = time.perf_counter()
    res = calibrate.validate(ctx, seed=0, verbose=False)
    t_val = time.perf_counter() - t0
    for name, r in res.items():
        if isinstance(r, dict):
            nums = ", ".join(f"{k} {v:.6g}" if isinstance(v, float)
                             else f"{k} {v}" for k, v in r.items()
                             if k != "pass")
            log(f"  [fhesim] band {name}: {'PASS' if r['pass'] else 'FAIL'} "
                f"({nums})")
    log(f"  [fhesim] validate {t_val:.2f}s: {res['summary']}")
    if not (res["formula"]["pass"] and res["topk_overlap"]["pass"]):
        raise AssertionError(f"fhesim: band 2 or 3 failed: {res}")
    rows = speed_run(ns=FHESIM_RINGS, n_docs=FHESIM_DOCS, dim=FHESIM_DIM,
                     seed=0, verbose=False, device=DEVICE)
    for r in rows:
        log(f"  [fhesim speed] N={r['n']}, {FHESIM_DOCS} docs: simulator "
            f"{r['sim_s'] * 1e3:.3f} ms, real {r['real_s'] * 1e3:.3f} ms "
            f"(scores + decrypt + decode, synchronised), speed-up "
            f"{r['speedup']:.1f}x")
    torch.cuda.synchronize()
    counts = _counts()
    _log_hist("fhesim", _hist_since(start))
    log(f"  [fhesim] launches {counts}")
    _must_launch_ntt("fhesim", counts)
    del ctx
    torch.cuda.empty_cache()
    return counts, {"noise_constant": c, "per_dim_sigma": per_dim,
                    "validate": {k: v for k, v in res.items()
                                 if isinstance(v, dict)},
                    "band1_pass": res["noise_constant"]["pass"],
                    "speed": rows}


def _chain_weights():
    """Seeded chain weights at magnitudes that keep every hidden value and
    logit well inside q0's headroom at level 1."""
    import numpy as np

    rng = np.random.default_rng(2)
    d, f = CHAIN_D, CHAIN_F
    blocks = [(rng.normal(0, 1 / np.sqrt(d), (d, f)),
               rng.normal(0, 1 / np.sqrt(f), (f, d)))
              for _ in range(CHAIN_BLOCKS)]
    w_head = rng.normal(0, 1 / np.sqrt(d), (d, CHAIN_VOCAB))
    return (blocks, w_head, rng.normal(0, 0.5, d),
            rng.normal(0, 0.5, (CHAIN_VOCAB, d)))


def phase_naive(new_hists):
    """The naive per-column ablation: the FFN block at D=2048, F=8192 on
    CkksParams(16384, 3, 1) through `naive_ablation`, then the
    scalar-ciphertext chains (`naive_multilayer` both ways,
    `naive_autoregressive`) at a cut width."""
    import numpy as np
    import torch

    from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams
    from fhe_spear_tpu_torch.models import naive_inference as naive
    from fhe_spear_tpu_torch.ops.bsgs import bsgs_dims

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    start = _shape_counts()
    log(f"naive: FFN block D={D} F={F} on CkksParams({NAIVE_N}, {NAIVE_L}, "
        f"{NAIVE_K}) seed 0, bench_fully_enc's weight scale, the whole "
        "block")
    t0 = time.perf_counter()
    r = naive.naive_ablation(d=D, f=F, n=NAIVE_N, num_limbs=NAIVE_L,
                             num_special=NAIVE_K, seed=0, device=DEVICE)
    t_block = time.perf_counter() - t0
    block_hist = _hist_since(start)
    G, B = bsgs_dims(D)
    bsgs_rot = (G - 1) + (B - 1)
    log(f"  [naive block] key projection {r['key_s']:.2f}s ({F} columns, "
        f"{r['key_rotations']} rotations), value projection "
        f"{r['value_s']:.2f}s ({D} columns, {r['value_rotations']} "
        f"rotations), col_chunk {r['col_chunk']}; block {t_block:.2f}s "
        f"incl. keygen; corr {r['corr']:.9f}, max_err {r['max_err']:.3e}; "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  [naive block] rotations for one {D}x{D} matrix: naive "
        f"{naive.rotation_count_naive(D, D)} vs BSGS {bsgs_rot} "
        f"(G={G}, B={B}); for the block's projections: naive "
        f"{r['key_rotations'] + r['value_rotations']} vs BSGS at most "
        f"{2 * (F // D) * bsgs_rot} ({F // D} {D}x{D} matrices each)")
    _log_hist("naive block", block_hist)
    if not r["corr"] > NAIVE_CORR:
        raise AssertionError(f"naive block: corr {r['corr']} <= "
                             f"{NAIVE_CORR} against x + (x@Wk)^2 @ Wv")

    blocks, w_head, x, emb = _chain_weights()
    chain_start = _shape_counts()
    t0 = time.perf_counter()
    ctx = CkksContext(CkksParams(n=CHAIN_N, num_limbs=CHAIN_L,
                                 num_special=1), seed=0, device=DEVICE)
    torch.cuda.synchronize()
    log(f"  [naive chains] d={CHAIN_D} f={CHAIN_F} vocab {CHAIN_VOCAB}, "
        f"{CHAIN_BLOCKS} blocks (depth and width cut: full width is the "
        f"paper's 10,863 s case), CkksParams({CHAIN_N}, {CHAIN_L}, 1); "
        f"context {time.perf_counter() - t0:.2f}s")
    chains = {}
    for residual in (False, True):
        h = x.copy()
        for wk, wv in blocks:
            pre = (h @ wk) ** 2 @ wv
            h = pre + h if residual else pre
        want = h @ w_head
        t0 = time.perf_counter()
        tok, logits, lvl = naive.naive_multilayer(ctx, x, blocks, w_head,
                                                  residual=residual)
        dt = time.perf_counter() - t0
        corr = float(np.corrcoef(logits, want)[0, 1])
        tag = "residual" if residual else "plain"
        chains[tag] = {"s": dt, "token": tok, "corr": corr, "level": lvl}
        log(f"  [naive multilayer, {tag}] {dt:.3f}s a token, token {tok} "
            f"(plaintext {int(np.argmax(want))}), logit corr {corr:.9f}, "
            f"level {lvl}")
        if tok != int(np.argmax(want)) or not corr > CHAIN_CORR \
                or lvl != CHAIN_L - 7:
            raise AssertionError(f"naive multilayer ({tag}): {chains}")
    t0 = time.perf_counter()
    toks_f, toks_p = naive.naive_autoregressive(
        ctx, emb, blocks, w_head, start_token=3, num_tokens=CHAIN_TOKENS)
    dt = (time.perf_counter() - t0) / CHAIN_TOKENS
    chains["autoregressive"] = {"s_per_token": dt, "fhe": toks_f,
                                "plain": toks_p}
    log(f"  [naive autoregressive] {CHAIN_TOKENS} tokens, {dt:.3f}s a "
        f"token: fhe {toks_f}, plaintext {toks_p}")
    if toks_f != toks_p:
        raise AssertionError(f"naive autoregressive: {toks_f} != {toks_p}")
    torch.cuda.synchronize()
    counts = _counts()
    new_hists["naive"] = block_hist
    _log_hist("naive chains", _hist_since(chain_start))
    log(f"  [naive] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{counts}")
    _must_launch_ntt("naive", counts)
    del ctx
    torch.cuda.empty_cache()
    return counts, {"block": {k: v for k, v in r.items()
                              if k not in ("out", "want")},
                    "block_s": t_block, "bsgs_rotations_per_matrix": bsgs_rot,
                    "chains": chains}


def phase_checkpoints(new_hists):
    """Eval keys saved by an owner and loaded by a server whose engine was
    built (and its key stacks with it) before the load; secret key,
    ciphertext and generation state round trips."""
    import os

    import numpy as np
    import torch

    from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams
    from fhe_spear_tpu_torch.models.rwkv7 import RwkvState
    from fhe_spear_tpu_torch.ops.bsgs import BsgsMatvec
    from fhe_spear_tpu_torch.utils import serialization as ser

    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    out_dir.mkdir(parents=True, exist_ok=True)
    params = CkksParams(n=N, num_limbs=L, num_special=K)
    log(f"checkpoints: BsgsMatvec keys at D={D}, N={N}, L={L}, K={K}")
    torch.cuda.synchronize()
    _reset_counts()
    start = _shape_counts()
    owner = CkksContext(params, seed=0, device=DEVICE)
    eng_o = BsgsMatvec(owner, D)
    server = CkksContext(params, seed=1, device=DEVICE)
    eng_s = BsgsMatvec(server, D)
    eng_s.warm_stacks()                 # stacks of the server's own keys
    rng = np.random.default_rng(3)
    w = rng.uniform(-1, 1, (D, D)) / np.sqrt(D)
    x = rng.uniform(-1, 1, D)
    ct = owner.encrypt_replicated(x)
    pt = eng_o.load(eng_o.encode(w), ct.level)
    want = eng_o(ct, pt)
    kp = str(out_dir / "eval_keys.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ser.save_eval_keys(kp, owner)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    ser.load_eval_keys(kp, server)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    size = os.path.getsize(kp)
    got = eng_s(ct, pt)
    same = torch.equal(got.c, want.c) and got.scale == want.scale
    owner_err = float(np.abs(owner.decrypt_vec(got, D) - w @ x).max())
    server_err = float(np.abs(server.decrypt_vec(got, D) - w @ x).max())
    log(f"  [checkpoints] eval keys ({len(owner.galois_keys)} Galois + "
        f"relin): {size} bytes, save {t_save:.3f}s, load {t_load:.3f}s; "
        f"server engine built before the load (key epoch "
        f"{server.key_epoch}): output equals the owner's word for word: "
        f"{same}; owner decrypts to w @ x within {owner_err:.2e}, the "
        f"server's own key misses by {server_err:.2e}")
    if not same or not owner_err < 1e-3 or not server_err > 1.0:
        raise AssertionError("checkpoints: the server's matvec on loaded keys")
    sp, cp = str(out_dir / "sk.npz"), str(out_dir / "ct.npz")
    ser.save_secret_key(sp, owner)
    ctx2 = ser.load_secret_key(sp, params, device=DEVICE)
    ser.save_ciphertext(cp, got, owner)
    back = ser.load_ciphertext(cp, ctx2)
    sk_ok = torch.equal(ctx2.s_eval, owner.s_eval)
    ct_ok = torch.equal(back.c, got.c) and back.scale == got.scale
    rt_err = float(np.abs(ctx2.decrypt_vec(back, D) - w @ x).max())
    gen = np.random.default_rng(5)
    nh = D // CKPT_HEAD
    st = RwkvState(
        x_prev_att=[gen.normal(0, 1e-3, D) for _ in range(CKPT_BLOCKS)],
        x_prev_ffn=[gen.normal(0, 1e-3, D) for _ in range(CKPT_BLOCKS)],
        wkv=[gen.normal(0, 1e-3, (nh, CKPT_HEAD, CKPT_HEAD))
             for _ in range(CKPT_BLOCKS)])
    gp = str(out_dir / "state.npz")
    t0 = time.perf_counter()
    ser.save_generation_state(gp, st, [5, 11, 2])
    st2, toks = ser.load_generation_state(gp)
    t_state = time.perf_counter() - t0
    st_ok = toks == [5, 11, 2] and all(
        np.array_equal(a, b) for a, b in zip(
            st.x_prev_att + st.x_prev_ffn + st.wkv,
            st2.x_prev_att + st2.x_prev_ffn + st2.wkv))
    log(f"  [checkpoints] secret key round trip: {sk_ok}; ciphertext round "
        f"trip: {ct_ok} (restored context decrypts within {rt_err:.2e}); "
        f"generation state D={D}, {CKPT_BLOCKS} blocks, {nh} heads of "
        f"{CKPT_HEAD} ({os.path.getsize(gp)} bytes, {t_state:.2f}s): exact "
        f"{st_ok}")
    if not (sk_ok and ct_ok and rt_err < 1e-3 and st_ok):
        raise AssertionError("checkpoints: a round trip failed")
    torch.cuda.synchronize()
    counts = _counts()
    _log_hist("checkpoints", _hist_since(start))
    log(f"  [checkpoints] launches {counts}")
    _must_launch_ntt("checkpoints", counts)
    del owner, server, eng_o, eng_s, ctx2
    torch.cuda.empty_cache()
    return counts, {"bundle_bytes": size, "save_s": t_save,
                    "load_s": t_load, "state_s": t_state}


def phase_profiling(new_hists):
    """`utils.profiling.trace` around one D=2048 matvec: the trace file
    must hold K1 under its kernel's name."""
    import glob
    import os
    import shutil

    import numpy as np
    import torch

    from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams
    from fhe_spear_tpu_torch.ops.bsgs import BsgsMatvec
    from fhe_spear_tpu_torch.utils.profiling import Phases, trace

    log(f"profiling: trace() around one D={D} matvec at N={N}")
    torch.cuda.synchronize()
    _reset_counts()
    start = _shape_counts()
    ctx = CkksContext(CkksParams(n=N, num_limbs=L, num_special=K), seed=0,
                      device=DEVICE)
    eng = BsgsMatvec(ctx, D)
    rng = np.random.default_rng(4)
    ct = ctx.encrypt_replicated(rng.uniform(-1, 1, D))
    pt = eng.load(eng.encode(rng.uniform(-1, 1, (D, D)) / np.sqrt(D)),
                  ct.level)
    eng(ct, pt)                                      # warm-up
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    ph = Phases()
    with trace(str(TRACE_DIR)):
        with ph.span("matvec"):
            eng(ct, pt)
            torch.cuda.synchronize()
    files = glob.glob(os.path.join(str(TRACE_DIR), "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"profiling: {len(files)} trace files")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kern if "ntt_fwd_kernel" in e.get("name", "")]
    k1_us = sum(e.get("dur", 0) for e in k1)
    log(f"  [profiling] {os.path.getsize(files[0])} bytes, {len(kern)} "
        f"device kernels, {len(k1)} K1 events ({k1_us:.1f} us; e.g. "
        f"{k1[0]['name'] if k1 else None!r}); span {ph.report()}")
    if not k1:
        raise AssertionError("profiling: no K1 (ntt_fwd_kernel) event in "
                             "the trace")
    torch.cuda.synchronize()
    counts = _counts()
    _log_hist("profiling", _hist_since(start))
    log(f"  [profiling] launches {counts}")
    _must_launch_ntt("profiling", counts)
    del ctx, eng
    torch.cuda.empty_cache()
    return counts, {"trace_bytes": os.path.getsize(files[0]),
                    "device_kernels": len(kern), "k1_events": len(k1)}


# the multi-device phases: ranks of one spawn share the card (gloo through
# the host; NCCL refuses two ranks on one device), so their times are the
# cost of each rank, not scaling
PAR_TIMEOUT = {"giant": 480.0, "nccl": 180.0, "limb": 420.0}
PAR_GIANT_ERR, PAR_GIANT_ERR_MXU = 2e-3, 5e-3   # tests/test_parallel.py
PAR_LIMB_N, PAR_LIMB_L, PAR_LIMB_K = 16384, 46, 8


def _par_spawn(tag, world, backend, jobs):
    """One spawn of `world` ranks running `jobs` (parallel.dryrun.run_jobs)
    on the card; every rank must have run there."""
    import torch

    from fhe_spear_tpu_torch.parallel.collectives import run_ranks
    from fhe_spear_tpu_torch.parallel.dryrun import run_jobs

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = run_ranks(run_jobs, world, backend, DEVICE, PAR_TIMEOUT[tag], jobs)
    log(f"  [{tag}] {world} rank(s) over {backend}: "
        f"{time.perf_counter() - t0:.2f}s with start-up; ranks on "
        + ", ".join(f"{r['device']} ({r.get('device_name')})" for r in res))
    for rank, r in enumerate(res):
        if r["backend"] != backend or not r["device"].startswith("cuda"):
            raise AssertionError(f"{tag}: rank {rank} ran on {r['device']} "
                                 f"over {r['backend']}")
        log(f"  [{tag}] rank {rank} collectives: {r['comm']['calls']} calls, "
            f"{r['comm']['bytes']} bytes in, {r['comm']['host_bytes']} bytes "
            "staged through the host")
    return res


def _par_plain(x):
    """A rank's result without its by-shape histograms (for the JSON)."""
    if isinstance(x, dict):
        return {k: _par_plain(v) for k, v in x.items()
                if k not in ("ntt_by_shape", "words")}
    if isinstance(x, list):
        return [_par_plain(v) for v in x]
    return x


def _par_agree(tag, res, key, get=lambda r: r["digest"]):
    vals = {get(r[key]) for r in res}
    if len(vals) != 1:
        raise AssertionError(f"{tag}: ranks disagree on the words: {vals}")


def _par_span(tag, res, key, span=lambda r: r):
    """Log each rank's seconds, peak memory and collective bytes of one
    span; return rank 0's launches."""
    for rank, r in enumerate(res):
        s = span(r[key])
        log(f"  [{tag}] rank {rank}: {s['sec']:.3f}s, peak device memory "
            f"{s['peak_gib']:.2f} GiB, collectives {s['comm']['calls']} "
            f"calls / {s['comm']['bytes']} bytes ({s['comm']['host_bytes']} "
            "through the host); launches " + " ".join(
                f"{k}={v}" for k, v in s["launches"].items()))
    return span(res[0][key])["launches"]


def _par_launch(tag, launches, must, must_not=()):
    for k in must:
        if launches[k] == 0:
            raise AssertionError(f"{tag}: kernel {k} never launched")
    for k in must_not:
        if launches[k] != 0:
            raise AssertionError(f"{tag}: kernel {k} launched "
                                 f"{launches[k]} times on a path that must "
                                 "not run it")


def phase_parallel(new_hists):
    """The multi-device modules at full width: three spawns of ranks on
    the card (3 gloo ranks, 1 NCCL rank, 2 gloo ranks), launches counted
    inside the ranks and reported by rank 0."""
    import numpy as np

    counts, results = {}, {}
    ctx8k = {"n": N, "limbs": L, "special": K, "ctx_seed": 0}
    giant = {**ctx8k, "d": D}
    fe = {"n": N, "limbs": FE_L, "special": FE_K, "dnum": FE_DNUM,
          "ctx_seed": 0, "d": D, "f": F, "blocks": FE_BLOCKS,
          "weights": "bench"}
    model = {"d": D, "f": F, "blocks": BLOCKS, "head_size": HEAD_SIZE,
             "vocab": 1000, "model_seed": 42}
    from fhe_spear_tpu_torch.ops.bsgs import bsgs_dims

    log(f"parallel: giant matvec D={D} (B={bsgs_dims(D)[1]}), sharded "
        "server token and "
        f"sharded chain on 3 gloo ranks; giant matvec on 1 NCCL rank; limb "
        f"rotation at N={PAR_LIMB_N}, key-sharded chain, sharded four-step "
        "and block pipeline on 2 gloo ranks (ranks share cuda:0)")

    # -- spawn 1: 3 gloo ranks --------------------------------------------
    res = _par_spawn("giant", 3, "gloo", [
        ("giant", "giant_matvec", giant),
        ("giant_mxu", "giant_matvec", {**giant, "backend": "mxu"}),
        ("token", "sharded_token", {**ctx8k, **model, "tokens": 2}),
        ("chain", "sharded_chain", fe)])
    for key, bar, must, must_not in (
            ("giant", PAR_GIANT_ERR, NTT_KERNELS, ("fourstep_fwd",
                                                   "fourstep_inv")),
            ("giant_mxu", PAR_GIANT_ERR_MXU, ("fourstep_fwd", "fourstep_inv"),
             NTT_KERNELS)):
        tag = f"parallel {key}"
        _par_agree(tag, res, key)
        r = res[0][key]
        log(f"  [{tag}] groups by rank "
            f"{[x[key]['groups'] for x in res]}; max_err {r['err']:.3e} "
            f"(bar {bar}); first call {r['first']['sec']:.3f}s (stacks the "
            f"keys)")
        launches = _par_span(tag, res, key, lambda x: x["steady"])
        if not (r["err"] < bar and r["repeat_equal"] and r["level"] == L - 1):
            raise AssertionError(f"{tag}: {r}")
        _par_launch(tag, launches, must, must_not)
        counts[f"parallel_{key}"] = launches
        results[key] = {k: [x[key][k] for x in res] for k in
                        ("err", "first", "steady")}
    tag = "parallel token"
    toks = res[0]["token"]["tokens"]
    for i in range(len(toks)):
        _par_agree(tag, res, "token", lambda r: r["tokens"][i]["digest"])
        t = toks[i]
        log(f"  [{tag}] token {i}: ref={t['ref']} fhe={t['fhe']} corr="
            f"{t['corr']:.6f}")
        launches = _par_span(f"{tag} {i}", res, "token",
                             lambda x: x["tokens"][i])
        if t["ref"] != t["fhe"] or not t["corr"] >= CORR_CLASSIC:
            raise AssertionError(f"{tag}: token off its twin: {toks}")
    _par_launch(tag, launches, NTT_KERNELS)
    counts["parallel_token"] = launches
    results["token"] = [x["token"] for x in res]
    tag = "parallel chain"
    _par_agree(tag, res, "chain")
    stats = res[0]["chain"]["stats"]
    log(f"  [{tag}] s/block " + ", ".join(f"{s['sec']:.3f}" for s in stats)
        + " (host pre-encode " + ", ".join(f"{s['encode_s']:.3f}"
                                           for s in stats) + " s)"
        + "; corr " + ", ".join(f"{s['corr']:.9f}" for s in stats)
        + "; max_err " + ", ".join(f"{s['max_err']:.2e}" for s in stats)
        + f"; levels {[s['level'] for s in stats]}")
    launches = _par_span(tag, res, "chain")
    if len(stats) != FE_BLOCKS or not all(
            s["corr"] > FE_CORR and s["max_err"] < FE_ERR for s in stats):
        raise AssertionError(f"{tag}: block off the plaintext oracle: {stats}")
    _par_launch(tag, launches, NTT_KERNELS)
    counts["parallel_chain"] = launches
    results["chain"] = [x["chain"] for x in res]

    # -- spawn 2: one NCCL rank (int64 collectives on the device) ----------
    res = _par_spawn("nccl", 1, "nccl", [
        ("giant", "giant_matvec", giant),
        ("ops", "collective_ops", {})])
    tag = "parallel giant nccl"
    r = res[0]["giant"]
    ops = res[0]["ops"]
    if not (r["err"] < PAR_GIANT_ERR and r["repeat_equal"]):
        raise AssertionError(f"{tag}: {r}")
    p = 2**31 - 1
    if not (np.all(ops["psum"] == p - 1) and ops["rows"].shape == (1, 4)
            and np.array_equal(ops["a2a"], np.arange(2)[None])):
        raise AssertionError(f"parallel nccl collectives: {ops}")
    log(f"  [{tag}] max_err {r['err']:.3e}; psum_mod, all_gather_rows and "
        "all_to_all of int64 on NCCL equal their expected words")
    launches = _par_span(tag, res, "giant", lambda x: x["steady"])
    _par_launch(tag, launches, NTT_KERNELS)
    counts["parallel_giant_nccl"] = launches
    results["giant_nccl"] = {"err": r["err"], "steady": r["steady"]}

    # -- spawn 3: 2 gloo ranks ---------------------------------------------
    res = _par_spawn("limb", 2, "gloo", [
        ("limb", "limb_rotate", {"n": PAR_LIMB_N, "limbs": PAR_LIMB_L,
                                 "special": PAR_LIMB_K, "ctx_seed": 0}),
        ("keys", "key_sharded_chain", fe),
        ("ntt", "ntt_sharded", {"n": N, "rows": 3, "n1": 64}),
        ("pipe", "pipeline", {**ctx8k, **model, "ctx_seed": 0,
                              "streams": [5, 11], "tokens": 2,
                              "cache_dir": str(PREENC_CACHE)})])
    tag = "parallel limb rotation"
    _par_agree(tag, res, "limb")
    r = res[0]["limb"]
    if not all(x["limb"]["equal"] for x in res) or not r["err"] < 1e-3:
        raise AssertionError(f"{tag}: words differ from ctx.rotate: {r}")
    log(f"  [{tag}] N={PAR_LIMB_N} L={PAR_LIMB_L} K={PAR_LIMB_K}, rows by "
        f"rank {[(x['limb']['rows'][0], x['limb']['rows'][-1]) for x in res]}"
        f": words equal ctx.rotate on every rank; max_err {r['err']:.2e}; "
        f"ctx.rotate {r['single']['sec']:.3f}s, sharded + gather "
        f"{r['sharded']['sec']:.3f}s, sharded alone {r['local']['sec']:.3f}s")
    launches = _par_span(tag, res, "limb", lambda x: x["local"])
    _par_launch(tag, launches, NTT_KERNELS)
    counts["parallel_limb_rotation"] = launches
    new_hists["parallel limb rotation"] = r["local"]["ntt_by_shape"]
    _log_hist(tag, r["local"]["ntt_by_shape"])
    results["limb"] = [{k: x["limb"][k] for k in ("err", "single", "sharded",
                                                  "local")} for x in res]
    tag = "parallel key-sharded chain"
    _par_agree(tag, res, "keys")
    r = res[0]["keys"]
    if not all(x["keys"]["equal"] for x in res):
        raise AssertionError(f"{tag}: words differ from the unsharded chain")
    log(f"  [{tag}] words equal the unsharded chain's; corr {r['corr']:.9f}, "
        f"max_err {r['max_err']:.2e}, level {r['level']}; key rows a rank "
        f"{r['key_rows']} of {FE_L + FE_K}; unsharded "
        f"{r['single']['sec']:.3f}s, sharded {r['sharded']['sec']:.3f}s")
    launches = _par_span(tag, res, "keys", lambda x: x["sharded"])
    _par_launch(tag, launches, NTT_KERNELS)
    counts["parallel_key_sharded_chain"] = launches
    new_hists["parallel key-sharded chain"] = r["sharded"]["ntt_by_shape"]
    _log_hist(tag, r["sharded"]["ntt_by_shape"])
    results["keys"] = [{k: x["keys"][k] for k in ("corr", "max_err",
                                                  "single", "sharded")}
                       for x in res]
    tag = "parallel four-step"
    _par_agree(tag, res, "ntt")
    r = res[0]["ntt"]
    if not all(x["ntt"]["equal"] for x in res):
        raise AssertionError(f"{tag}: words differ from FourStepNtt.ntt")
    log(f"  [{tag}] N={N}, 3 rows, 64 x {N // 64}: words equal "
        "FourStepNtt.ntt; "
        f"single {r['single']['sec'] * 1e3:.3f} ms, sharded + gather "
        f"{r['sharded']['sec'] * 1e3:.3f} ms")
    counts["parallel_fourstep_sharded"] = _par_span(tag, res, "ntt",
                                                    lambda x: x["sharded"])
    results["ntt"] = [{k: x["ntt"][k] for k in ("single", "sharded")}
                      for x in res]
    tag = "parallel pipeline"
    for i, step in enumerate(res[0]["pipe"]["tokens"]):
        _par_agree(tag, res, "pipe", lambda r: r["tokens"][i]["digest"])
        log(f"  [{tag}] token {i}: " + ", ".join(
            f"stream {s}: ref={x['ref']} fhe={x['fhe']} corr={x['corr']:.6f}"
            f" wkv_err={x['wkv_err']:.2e}"
            for s, x in enumerate(step["streams"])))
        launches = _par_span(f"{tag} {i}", res, "pipe",
                             lambda x: x["tokens"][i])
        for x in step["streams"]:
            if x["ref"] != x["fhe"] or not x["corr"] >= CORR_DEVICE:
                raise AssertionError(f"{tag}: stream off its twin: {step}")
    _par_launch(tag, launches, NTT_KERNELS)
    counts["parallel_pipeline"] = launches
    results["pipe"] = [x["pipe"] for x in res]
    return counts, _par_plain(results)


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
            if tag == "refresh":
                # the three shapes carrying the most of one refresh's work,
                # and ModRaise's (K2 [2, 1, N], K1 [2, L, N])
                top = sorted(hist[name].items(), key=lambda kv: -kv[0][0]
                             * kv[0][1] * kv[0][2] * kv[1])[:3]
                raise_shape = (2, 1 if name == "ntt_inv" else BOOT_L, BOOT_N)
                if raise_shape in hist[name] and all(
                        sh != raise_shape for sh, _ in top):
                    top.append((raise_shape, hist[name][raise_shape]))
            elif tag == "naive":
                # the largest column batch, and the most frequent shape
                top = [max(hist[name].items(),
                           key=lambda kv: (kv[0][0] * kv[0][1], kv[1]))]
                freq = max(hist[name].items(), key=lambda kv: kv[1])
                if freq[0] != top[0][0]:
                    top.append(freq)
            else:
                top = [max(hist[name].items(),
                           key=lambda kv: (kv[0][0] * kv[0][1], kv[1]))]
            picks += [(tag, name, B, R, n, cnt) for (B, R, n), cnt in top]
    rows_by_n = {}
    for _, _, _, R, n, _ in picks:
        rows_by_n[n] = max(rows_by_n.get(n, 0), R)
    ctxs = {n: NttContext.build(n, find_ntt_primes(n, R), device="cuda")
            for n, R in rows_by_n.items()}
    log("new shapes: K1/K2 at the largest shape each new path launched "
        "(and at one refresh's three heaviest and ModRaise's, and the naive "
        "block's most frequent), held bitwise first")
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
    phases = {"retrieval": phase_retrieval, "rag": phase_rag,
              "fullenc": phase_fullenc, "bootstrap": phase_bootstrap,
              "access_control": phase_access_control,
              "fhesim": phase_fhesim, "naive": phase_naive,
              "checkpoints": phase_checkpoints,
              "profiling": phase_profiling, "parallel": phase_parallel}
    only = [a.split("=", 1)[1].split(",") for a in argv
            if a.startswith("--only=")]
    run = only[0] if only else ["paths"] + list(phases)
    for tag in run:
        if tag != "paths" and tag not in phases:
            raise SystemExit(f"chip_smoke: unknown phase {tag!r}")
    hists, new_hists, split = {}, {}, {}
    counts = {}
    if "paths" in run:
        t0 = time.perf_counter()
        counts = phase_paths(hists)
        split["generation paths"] = time.perf_counter() - t0
    results = {}
    for tag, phase in phases.items():
        if tag not in run:
            continue
        t0 = time.perf_counter()
        c, results[tag] = phase(new_hists)
        # the parallel phase reports one launch count per sharded path
        if tag == "parallel":
            counts.update(c)
        else:
            counts[tag] = c
        split[tag] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if "paths" in run:
        phase_shapes(kctx, kfsb, hists, timing)
    phase_new_shapes(new_hists, timing)
    split["shapes"] = time.perf_counter() - t0
    if only:
        log(json.dumps({"kernel_timing": timing, "results": results},
                       default=str))
        log("phase split: " + ", ".join(f"{k} {v:.1f}s"
                                        for k, v in split.items()))
        return
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
