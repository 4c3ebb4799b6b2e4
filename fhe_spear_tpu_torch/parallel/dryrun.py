"""The multi-device paths as rank functions, and the multi-rank dry run.

Counterpart of `__graft_entry__.dryrun_multichip`.  Every path is a job:
a module-level function `job(group, **params)` that one rank runs (every
rank runs the same job with the same seeds) and that returns plain
picklable results: error measures against the plaintext, digests of the
output words (equal digests on every rank show a replicated result), the
words themselves where `words=True`, seconds, and on the card the kernel
launches, the peak device memory and the bytes through collectives.
`run_jobs` runs a list of jobs in one spawn of the ranks (`run_ranks`),
so the tests and `chip_smoke.py` pay the start-up once.

    python -m fhe_spear_tpu_torch.parallel.dryrun --world-size 2 [--device cpu]

runs `dryrun_multichip`: the giant-sharded matvec, the sharded
client-aided token, the block pipeline and the limb-sharded
fully-encrypted chain at the reference's dry-run sizes (n=256), each held
to its plaintext bar.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import tempfile
import time

import numpy as np
import torch

from ..ops.bsgs import bsgs_dims
from .collectives import RankGroup, run_ranks

__all__ = ["JOBS", "run_jobs", "dryrun_multichip", "giant_matvec",
           "sharded_token", "sharded_chain", "limb_rotate",
           "key_sharded_chain", "ntt_sharded", "pipeline", "collective_ops"]


# -- measurement helpers ---------------------------------------------------


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.cpu().numpy().tobytes()).hexdigest()[:16]


def _counts() -> dict:
    from ..core import fourstep_cuda, ntt_cuda

    return {"ntt_fwd": ntt_cuda.NTT_FWD.launches,
            "ntt_inv": ntt_cuda.NTT_INV.launches,
            "fourstep_fwd": fourstep_cuda.FOURSTEP_FWD.launches,
            "fourstep_inv": fourstep_cuda.FOURSTEP_INV.launches}


class _Span:
    """Seconds (ending in a device synchronize), kernel launches, peak
    device memory and collective traffic of the work inside the block."""

    def __init__(self, group: RankGroup):
        self.group = group
        self.cuda = group.device.type == "cuda"
        self.out: dict = {}

    def __enter__(self):
        if self.cuda:
            from ..core import fourstep_cuda, ntt_cuda

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ntt_cuda.reset_counts()
            fourstep_cuda.reset_counts()
        self.comm0 = dict(self.group.stats)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        self.out["sec"] = time.perf_counter() - self.t0
        self.out["comm"] = {k: v - self.comm0[k]
                            for k, v in self.group.stats.items()}
        if self.cuda:
            from ..core import ntt_cuda

            self.out["launches"] = _counts()
            self.out["ntt_by_shape"] = {
                k.name: dict(k.by_shape)
                for k in (ntt_cuda.NTT_FWD, ntt_cuda.NTT_INV)}
            self.out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        return False


def _context(group, n, limbs, special, seed, dnum=None, backend="stockham"):
    from ..ckks.context import CkksContext, CkksParams

    return CkksContext(CkksParams(n=n, num_limbs=limbs, num_special=special,
                                  dnum=dnum, ntt_backend=backend),
                       seed=seed, device=group.device)


def _fe_weights(kind: str, d: int, f: int, blocks: int):
    """(w_keys, w_vals, x0), calibrated.  "chain": the reference test's
    sharded chain (default_rng(23), N(0, 0.02), x0 ~ N(0, 0.1));
    "keys": its key-sharded chain (default_rng(2), N(0, 0.1), x0 ~
    N(0, 0.3)); "bench": bench_fully_enc's (default_rng(42), W/sqrt(fan
    in), x0 = default_rng(4242).uniform(-1, 1))."""
    from ..models.fully_encrypted import calibrate_magnitude

    if kind == "bench":
        rng = np.random.default_rng(42)
        wk, wv = [], []
        for _ in range(blocks):
            wk.append(rng.standard_normal((d, f)) / np.sqrt(d))
            wv.append(rng.standard_normal((f, d)) / np.sqrt(f))
        x0 = np.random.default_rng(4242).uniform(-1, 1, d)
    else:
        rng = np.random.default_rng(23 if kind == "chain" else 2)
        sd = 0.02 if kind == "chain" else 0.1
        wk = [rng.normal(0, sd, (d, f)) for _ in range(blocks)]
        wv = [rng.normal(0, sd, (f, d)) for _ in range(blocks)]
        x0 = rng.normal(0, 0.1 if kind == "chain" else 0.3, d)
    wk, wv = calibrate_magnitude(wk, wv, x0)
    return wk, wv, x0


# -- jobs --------------------------------------------------------------------


def giant_matvec(group, n=256, limbs=3, special=1, d=64, ctx_seed=41,
                 w_seed=3, backend="stockham", words=False):
    """`ShardedBsgsMatvec` on one seeded W @ x at the top level, run twice
    (the first call stacks the keys): max_err against W @ x, the output
    digest (and words)."""
    from .sharded_bsgs import ShardedBsgsMatvec

    ctx = _context(group, n, limbs, special, ctx_seed, backend=backend)
    eng = ShardedBsgsMatvec(ctx, d, group)
    rng = np.random.default_rng(w_seed)
    w = rng.normal(0, 0.3, (d, d))
    x = rng.normal(0, 1, d)
    pt = eng.load(eng.encode(w), ctx.L)
    ct = ctx.encrypt_replicated(x)
    with _Span(group) as first:
        y = eng(ct, pt)
    with _Span(group) as steady:
        y2 = eng(ct, pt)
    got = ctx.decrypt_vec(y, d)
    return {"level": y.level, "err": float(np.abs(got - w @ x).max()),
            "digest": _digest(y.c), "repeat_equal": bool(torch.equal(y.c,
                                                                     y2.c)),
            "words": y.c.cpu().numpy() if words else None,
            "groups": (eng.lo, eng.hi), "first": first.out,
            "steady": steady.out}


def sharded_token(group, n=256, limbs=3, special=1, ctx_seed=41, d=64,
                  f=256, blocks=2, head_size=16, vocab=64, model_seed=3,
                  first_token=5, tokens=1):
    """`ShardedFheRwkvServer` driven by `FheRwkvClient(fused=False)`: each
    token against its plaintext twin (both fed the twin's tokens)."""
    from ..models.client_aided import FheRwkvClient
    from ..models.rwkv7 import generate_token_plaintext, make_random_model
    from .sharded_server import ShardedFheRwkvServer

    ctx = _context(group, n, limbs, special, ctx_seed)
    model = make_random_model(d=d, f=f, n_blocks=blocks, head_size=head_size,
                              vocab=vocab, seed=model_seed)
    with _Span(group) as init:
        server = ShardedFheRwkvServer(ctx, model, group, level=ctx.L)
        client = FheRwkvClient(ctx, model, server, fused=False)
    st_f, st_r = model.zero_state(), model.zero_state()
    tok, out = first_token, []
    for _ in range(tokens):
        lr, st_r = generate_token_plaintext(model, tok, st_r)
        with _Span(group) as sp:
            lf, st_f, _ = client.generate_token(tok, st_f)
        out.append({"ref": int(np.argmax(lr)), "fhe": int(np.argmax(lf)),
                    "corr": float(np.corrcoef(lf, lr)[0, 1]),
                    "digest": hashlib.sha1(np.asarray(lf).tobytes()
                                           ).hexdigest()[:16], **sp.out})
        tok = int(np.argmax(lr))
    return {"tokens": out, "init": init.out}


def sharded_chain(group, n=256, limbs=11, special=2, dnum=None, ctx_seed=47,
                  d=64, f=128, blocks=3, weights="chain"):
    """`ShardedFullyEncryptedFfn.run_chain`: per-block corr, max_err and
    level against the plaintext oracle, and the final words' digest."""
    from .sharded_fully_enc import ShardedFullyEncryptedFfn

    ctx = _context(group, n, limbs, special, ctx_seed, dnum=dnum)
    wk, wv, x0 = _fe_weights(weights, d, f, blocks)
    eng = ShardedFullyEncryptedFfn(ctx, d, f, group)
    with _Span(group) as sp:
        stats, ct = eng.run_chain(wk, wv, x0)
    return {"stats": stats, "digest": _digest(ct.c), **sp.out}


def limb_rotate(group, n=256, limbs=8, special=1, ctx_seed=None, steps=3,
                v_seed=5, words=False):
    """One rotation through `LimbShardedRotator` against `ctx.rotate` on
    the same rank (the reference test's seeds: ctx seed 43 + K), words
    compared; then the limb-sharded rotation alone, timed."""
    from .limb_sharded import LimbShardedRotator

    seed = 43 + special if ctx_seed is None else ctx_seed
    ctx = _context(group, n, limbs, special, seed)
    ctx.ensure_galois([steps])
    rot = LimbShardedRotator(ctx, group, level=limbs)
    v = np.random.default_rng(v_seed).uniform(-1, 1, ctx.slots)
    ct = ctx.encrypt(v)
    with _Span(group) as single:
        want = ctx.rotate(ct, steps)
    with _Span(group) as sharded:
        got = rot.rotate(ct, steps)
    c_loc = rot.shard(ct.c)
    with _Span(group) as local:
        rot.rotate_local(c_loc, steps)
    err = float(np.abs(ctx.decrypt_vec(got) - np.roll(v, -steps)).max())
    return {"equal": bool(torch.equal(got.c, want.c)), "err": err,
            "digest": _digest(got.c),
            "words": got.c.cpu().numpy() if words else None,
            "rows": rot.rows, "single": single.out, "sharded": sharded.out,
            "local": local.out}


def key_sharded_chain(group, n=256, limbs=14, special=3, dnum=5, ctx_seed=56,
                      d=16, f=32, blocks=3, weights="keys",
                      reload_keys=False):
    """The reference's limb-sharded chain check: one encryption, the chain
    on the unsharded keys, then `shard_eval_keys` and the chain again with
    `FullyEncryptedFfn(key_sharding=group)`; the words must be equal.  With
    reload_keys, the unsharded keys are saved first and loaded into the
    sharded context (`load_eval_keys` re-places them) for a third run."""
    from ..models.fully_encrypted import FullyEncryptedFfn, fe_level_schedule
    from ..utils.serialization import load_eval_keys, save_eval_keys

    ctx = _context(group, n, limbs, special, ctx_seed, dnum=dnum)
    wk, wv, x0 = _fe_weights(weights, d, f, blocks)
    levels = fe_level_schedule(ctx.L, blocks)
    ct0 = ctx.encrypt_replicated(x0)
    eng1 = FullyEncryptedFfn(ctx, d, f)
    # one host pre-encode serves every run (the diagonals are key-free)
    hosts = [eng1.encode_block(np.asarray(wk[b]), np.asarray(wv[b]),
                               level=levels[b]) for b in range(blocks)]

    def chain(eng):
        ct = ct0
        for b in range(blocks):
            ct = eng(ct, eng.load_block(hosts[b], ct.level))
        return ct

    with _Span(group) as single:
        out1 = chain(eng1)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "keys.npz")
        if reload_keys:
            save_eval_keys(path, ctx)
        ctx.shard_eval_keys(group)
        eng2 = FullyEncryptedFfn(ctx, d, f, key_sharding=group)
        with _Span(group) as sharded:
            out2 = chain(eng2)
        res = {}
        if reload_keys:
            load_eval_keys(path, ctx)
            out3 = chain(eng2)
            res["reload_equal"] = bool(torch.equal(out1.c, out3.c))
    dec = ctx.decrypt_vec(out2, d)
    ref = np.asarray(x0, dtype=np.float64)
    for b in range(blocks):
        ref = ref + (ref @ wk[b]) ** 2 @ wv[b]
    key_rows = ctx.relin_key.b.shape[-2]
    stack_rows = eng2.eng._stacks()[1].shape[-2]
    return {"equal": bool(torch.equal(out1.c, out2.c)),
            "scale_equal": out1.scale == out2.scale,
            "level": out2.level, "corr": float(np.corrcoef(dec, ref)[0, 1]),
            "max_err": float(np.abs(dec - ref).max()),
            "digest": _digest(out2.c), "key_rows": key_rows,
            "stack_rows": stack_rows, "single": single.out,
            "sharded": sharded.out, **res}


def ntt_sharded(group, n=256, rows=3, n1=16, seed=5, words=False):
    """`FourStepNtt.ntt_sharded` on seeded residues against the
    single-device `FourStepNtt.ntt` on the same rank, words compared."""
    from ..core.ntt import NttContext
    from ..core.primes import find_ntt_primes
    from .ntt_fourstep import FourStepNtt

    ntt = NttContext.build(n, find_ntt_primes(n, rows), device=group.device)
    fs = FourStepNtt(ntt, n1, n // n1)
    rng = np.random.default_rng(seed)
    q = np.array([p.p for p in ntt.primes], dtype=np.int64)[:, None]
    x = torch.as_tensor(rng.integers(0, q, (rows, n), dtype=np.int64),
                        device=group.device)
    with _Span(group) as single:
        want = fs.ntt(x)
    with _Span(group) as sharded:
        got = fs.gather_k1(fs.ntt_sharded(fs.shard_j2(x, group), group),
                           group)
    return {"equal": bool(torch.equal(got, want)), "digest": _digest(got),
            "words": got.cpu().numpy() if words else None,
            "single": single.out, "sharded": sharded.out}


def pipeline(group, n=256, limbs=3, special=1, ctx_seed=77, d=32, f=128,
             blocks=4, head_size=16, vocab=64, model_seed=13,
             streams=(3, 17, 42, 7), tokens=2, cache_dir=None):
    """`BlockPipeline` over `group`: `tokens` pipelined steps of every
    stream, each against its plaintext twin (tokens, logit correlation,
    WKV state); the next step feeds the twin's tokens."""
    from ..models.device_client import DeviceTokenRunner
    from ..models.rwkv7 import generate_token_plaintext, make_random_model
    from .block_pipeline import BlockPipeline

    ctx = _context(group, n, limbs, special, ctx_seed)
    model = make_random_model(d=d, f=f, n_blocks=blocks, head_size=head_size,
                              vocab=vocab, seed=model_seed)
    with _Span(group) as init:
        runner = DeviceTokenRunner(
            ctx, model, level=ctx.L, cache_dir=cache_dir,
            blocks=BlockPipeline.span_of(blocks, group))
        pipe = BlockPipeline(runner, group)
    toks = list(streams)
    states = [model.zero_state() for _ in toks]
    refs = [model.zero_state() for _ in toks]
    out = []
    for _ in range(tokens):
        with _Span(group) as sp:
            logits, states = pipe.generate_tokens(toks, states)
        step = []
        for s in range(len(toks)):
            lref, refs[s] = generate_token_plaintext(model, toks[s], refs[s])
            step.append({
                "ref": int(np.argmax(lref)), "fhe": int(np.argmax(logits[s])),
                "corr": float(np.corrcoef(logits[s], lref)[0, 1]),
                "wkv_err": float(np.abs(np.stack(states[s].wkv)
                                        - np.stack(refs[s].wkv)).max())})
        toks = [r["ref"] for r in step]
        out.append({"streams": step, "digest": hashlib.sha1(
            np.asarray(logits).tobytes()).hexdigest()[:16], **sp.out})
    return {"tokens": out, "blocks": tuple(pipe.blocks), "init": init.out}


def collective_ops(group, p=2**31 - 1, absent_rank=None, absent_s=0.0):
    """The collectives on small int64 tensors: psum_mod of p - 1 from every
    rank, a ragged all_gather_rows (rank r gives r + 1 rows), all_to_all
    and ring_shift; and whether this process loaded jax or the JAX
    package.  absent_rank: a rank that sleeps absent_s seconds instead of
    joining the collectives, so that the others wait on it (the launcher's
    deadline check)."""
    import sys

    from . import collectives as cl

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                    ("jax", "fhe_spear_tpu"))
    if group.rank == absent_rank:
        time.sleep(absent_s)
        return {"loaded": loaded}
    r, size, dev = group.rank, group.size, group.device
    i64 = lambda v: torch.as_tensor(v, dtype=torch.int64, device=dev)
    x = i64(np.full((2, 3, 4), p - 1))
    rows = i64(np.full((r + 1, 4), r))
    return {
        "loaded": loaded,
        "psum": cl.psum_mod(x, i64(np.full((3, 1), p)), group).cpu().numpy(),
        "rows": cl.all_gather_rows(rows, group, counts=[k + 1 for k in
                                                        range(size)]
                                   ).cpu().numpy(),
        "a2a": cl.all_to_all(i64(np.arange(size * 2).reshape(size, 2)
                                 + 100 * r), group).cpu().numpy(),
        "ring": cl.ring_shift(i64([r]), group).cpu().numpy(),
        "stats": dict(group.stats)}


JOBS = {f.__name__: f for f in (giant_matvec, sharded_token, sharded_chain,
                                limb_rotate, key_sharded_chain, ntt_sharded,
                                pipeline, collective_ops)}


def run_jobs(group: RankGroup, jobs):
    """Run [(key, job name, params), ...] in order on this rank; returns
    {key: result}, the group's collective totals under "comm", and the
    device (and card) and backend the rank ran on."""
    out = {}
    for key, name, params in jobs:
        out[key] = JOBS[name](group, **params)
    out["comm"] = dict(group.stats)
    out["device"] = str(group.device)
    out["backend"] = group.backend
    if group.device.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(group.device)
    return out


# -- the dry run -------------------------------------------------------------


def _dryrun_jobs(size: int):
    # the giant groups must divide over the ranks: d=64 has B=8, d=32 B=6
    d = next((d for d in (64, 32) if bsgs_dims(d)[1] % size == 0), None)
    if d is None:
        raise ValueError(f"no dry-run width splits over {size} ranks "
                         "(sizes 1, 2, 3, 4, 6 and 8 do)")
    return [
        ("matvec", "giant_matvec", {"ctx_seed": 1, "w_seed": 0, "d": d}),
        ("token", "sharded_token", {"ctx_seed": 1, "d": d, "f": 4 * d}),
        ("pipeline", "pipeline", {"ctx_seed": 1, "d": 64, "f": 128,
                                  "blocks": size, "model_seed": 4,
                                  "streams": [5, 11][: max(1, size // 2)],
                                  "tokens": 1}),
        ("limb_chain", "key_sharded_chain", {}),
    ]


def dryrun_multichip(world_size: int, backend: str = "gloo",
                     device="cuda", timeout_s: float = 900.0) -> dict:
    """The four multi-rank checks of the reference's dry run, at its sizes
    (n=256, d=64, or d=32 where 3 or 6 ranks split its 6 giant groups): the
    giant-sharded matvec (max_err < 5e-3), the sharded
    client-aided token (token-exact, corr > 0.999), the block pipeline
    over `world_size` blocks (token-exact, corr > 0.999) and the
    limb-sharded fully-encrypted chain (bitwise equal to the unsharded
    chain, corr > 0.999).  Raises on a miss; returns rank 0's results."""
    res = run_ranks(run_jobs, world_size, backend, device, timeout_s,
                    _dryrun_jobs(world_size))
    r0 = res[0]
    for key in ("matvec", "limb_chain"):
        if len({r[key]["digest"] for r in res}) != 1:
            raise AssertionError(f"{key}: ranks disagree on the words")
    m = r0["matvec"]
    assert m["err"] < 5e-3, m["err"]
    print(f"dryrun_multichip({world_size}): sharded BSGS matvec ok, "
          f"max_err={m['err']:.2e}")
    t = r0["token"]["tokens"][0]
    assert t["ref"] == t["fhe"] and t["corr"] > 0.999, t
    print(f"dryrun_multichip({world_size}): sharded client-aided token ok, "
          f"token={t['fhe']} corr={t['corr']:.6f}")
    p = r0["pipeline"]["tokens"][0]["streams"]
    for s in p:
        assert s["ref"] == s["fhe"] and s["corr"] > 0.999, p
    print(f"dryrun_multichip({world_size}): block-pipelined token ok over "
          f"{world_size} ranks, streams={len(p)}")
    c = r0["limb_chain"]
    assert c["equal"] and c["corr"] > 0.999, c
    print(f"dryrun_multichip({world_size}): limb-sharded fully-encrypted "
          f"chain ok, 3 blocks, corr={c['corr']:.6f} (keys partitioned on "
          f"the RNS-limb axis, {c['key_rows']} rows a rank; words equal the "
          "unsharded chain's)")
    return r0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world-size", type=int, default=2)
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=float, default=900.0)
    a = ap.parse_args(argv)
    dryrun_multichip(a.world_size, a.backend, a.device, a.timeout)


if __name__ == "__main__":
    main()
