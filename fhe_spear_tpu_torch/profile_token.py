"""Where one client-aided token's time goes on the card -- or one
retrieval query's, one fully-encrypted block's, one bootstrap refresh's,
or one column batch of the naive ablation's.

    python -m fhe_spear_tpu_torch.profile_token [--blocks 2] [--top 15]
        [--transport {classic,device}] [--ntt-backend {stockham,mxu}]
        [--path {token,retrieval,fullenc,bootstrap,naive}]

--path token (default): the chip_smoke configuration (D=2048, F=8192,
N=8192, L=3, K=1, level 3) on the chosen transport -- classic:
`FheRwkvClient` on the fused transport with i32 staging; device: the
device-resident client `DeviceTokenRunner` -- and NTT backend; one warm-up
token (two on the device transport: its second captures the projections'
CUDA graphs, `ops.graphed`), then one steady token is traced.  (An
encrypted-RAG token is the classic token at --blocks 1.)
--path retrieval: column-packed CT-CT scoring of one query against 50k
seeded unit vectors (dim 64, Lorentz, N=8192), after one warm-up query.
--path fullenc: one fully-encrypted FFN block (D=2048, F=8192, N=8192,
L=11, K=8, dnum=8, i32 staging, consumed at level 11), after one warm-up
block.
--path bootstrap: one refresh of the 24-block chain's bootstrap (N=16384,
L=46, K=8, dnum=6, h=64; width 2, radix 4, exp_degree 31, margin 3) of a
seeded message at level 2, after one warm-up refresh.
--path naive: one 1024-column batch of the naive FFN block's key
projection (`naive_matvec`, D=2048 -> 1024 columns of bench_fully_enc's
W_key, 11 rotation levels, N=16384, L=3, K=1: an eighth of the
projection), after one warm-up batch.

Each traces its window with torch.profiler and prints: the window's wall
time, the device's busy time and idle share over it, the count of device
events (kernels and copies) and their summed time, and the device time by
kernel name (largest first).  Needs a card.
"""

from __future__ import annotations

import argparse
import time


def _token_window(args):
    """(warm-up, traced) callables of one client-aided token."""
    from .ckks import CkksContext, CkksParams
    from .models.client_aided import FheRwkvClient, FheRwkvServer
    from .models.device_client import DeviceTokenRunner
    from .models.rwkv7 import generate_token_plaintext, make_random_model

    model = make_random_model(d=2048, f=8192, n_blocks=args.blocks,
                              head_size=64, vocab=1000, seed=42)
    ctx = CkksContext(CkksParams(n=8192, num_limbs=3, num_special=1,
                                 ntt_backend=args.ntt_backend), seed=0)
    if args.transport == "device":
        runner = DeviceTokenRunner(ctx, model, level=3)

        def token(tok, st):          # the device client has no host phases
            return runner.generate_token(tok, st) + ([],)
    else:
        server = FheRwkvServer(ctx, model, level=3, stage_mode="i32")
        token = FheRwkvClient(ctx, model, server).generate_token
    state = {"s": generate_token_plaintext(model, 5, model.zero_state())[1]}

    def step(tok):
        _, state["s"], timings = token(tok, state["s"])
        return timings

    def warm():
        step(11)
        if args.transport == "device":
            step(7)
    return warm, (lambda: step(2))


def _retrieval_window(args):
    import numpy as np

    from .ckks import CkksContext, CkksParams
    from .ops.retrieval import ColumnPackedRetrieval

    ctx = CkksContext(CkksParams.retrieval(n=8192), seed=0)
    eng = ColumnPackedRetrieval(ctx, dim=64)
    rng = np.random.RandomState(0)
    docs = rng.rand(50000, 64) * 2 - 1
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    corpus = eng.encrypt_corpus(docs)
    qct = eng.encrypt_query(docs[0])

    def query():
        eng.decode_scores(eng.scores(corpus, qct), len(docs))
        return []
    return query, query


def _fullenc_window(args):
    import numpy as np

    from .ckks import CkksContext, CkksParams
    from .models.fully_encrypted import FullyEncryptedFfn, calibrate_magnitude

    d, f = 2048, 8192
    rng = np.random.default_rng(42)
    wk, wv = calibrate_magnitude(
        [rng.standard_normal((d, f)) / np.sqrt(d)],
        [rng.standard_normal((f, d)) / np.sqrt(f)],
        np.random.default_rng(4242).uniform(-1, 1, d))
    ctx = CkksContext(CkksParams(n=8192, num_limbs=11, num_special=8,
                                 dnum=8), seed=0)
    eng = FullyEncryptedFfn(ctx, d, f, stage_mode="i32")
    staged = eng.load_block(eng.encode_block(wk[0], wv[0], level=11), 11)
    ct = ctx.encrypt_replicated(np.random.default_rng(4242).uniform(-1, 1, d))

    def block():
        eng(ct, staged)
        return []
    return block, block


def _bootstrap_window(args):
    import numpy as np

    from .ckks import CkksContext, CkksParams
    from .ckks.bootstrap import Bootstrapper

    ctx = CkksContext(CkksParams.bootstrap(n=16384, num_limbs=46,
                                           num_special=8, hamming=64, dnum=6),
                      seed=0)
    bt = Bootstrapper(ctx, exp_degree=31, radix=4, evalmod_width=2,
                      margin_bits=3)
    m = np.random.default_rng(1).uniform(-0.8, 0.8, ctx.slots)
    ct = ctx.mod_switch_to(ctx.encrypt(m), 2)

    def refresh():
        bt.bootstrap(ct)
        return []
    return refresh, refresh


def _naive_window(args):
    import numpy as np

    from .ckks import CkksContext, CkksParams
    from .models.naive_inference import naive_matvec

    d, cols = 2048, 1024
    w = np.random.default_rng(42).standard_normal((d, 8192))[:, :cols] \
        / np.sqrt(d)
    ctx = CkksContext(CkksParams(n=16384, num_limbs=3, num_special=1),
                      seed=0)
    ct = ctx.encrypt_replicated(np.random.default_rng(4242).uniform(-1, 1, d))

    def batch():
        naive_matvec(ctx, ct, w, d, cols, col_chunk=cols)
        return []
    return batch, batch


def main(argv=None):
    ap = argparse.ArgumentParser(prog="fhe_spear_tpu_torch.profile_token")
    ap.add_argument("--blocks", type=int, default=2)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--transport", choices=("classic", "device"),
                    default="classic")
    ap.add_argument("--ntt-backend", choices=("stockham", "mxu"),
                    default="stockham")
    ap.add_argument("--path", choices=("token", "retrieval", "fullenc",
                                       "bootstrap", "naive"),
                    default="token")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_token: needs a CUDA card")
    warm, traced = {"token": _token_window, "retrieval": _retrieval_window,
                    "fullenc": _fullenc_window,
                    "bootstrap": _bootstrap_window,
                    "naive": _naive_window}[args.path](args)
    warm()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        timings = traced()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = 0.0
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    cur_s = cur_e = None
    for s, e in spans:                 # union of kernel intervals
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    by_name: dict = {}
    for e in events:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    total_dev = sum(t for t, _ in by_name.values())
    print(f"card: {torch.cuda.get_device_name(0)}; path {args.path}"
          + (f", transport {args.transport}, ntt backend {args.ntt_backend}, "
             f"{args.blocks} blocks" if args.path == "token" else ""))
    print(f"window wall {wall * 1e3:.1f} ms; device busy {busy_us / 1e3:.1f} "
          f"ms, idle share {1 - busy_us / 1e3 / (wall * 1e3):.3f}")
    print(f"device events: {len(events)} kernels and copies, "
          f"{total_dev / 1e3:.1f} ms summed over them")
    agg = {}
    for bt in timings:
        for k, v in bt.items():
            agg[k] = agg.get(k, 0.0) + v
    if agg:
        print("host phases (s): " + " ".join(f"{k}={v:.4f}"
                                             for k, v in sorted(agg.items())))
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  kernel")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0]
                               )[: args.top]:
        print(f"{t / 1e3:10.3f} {t / total_dev:6.3f} {c:6d}  {name[:90]}")


if __name__ == "__main__":
    main()
