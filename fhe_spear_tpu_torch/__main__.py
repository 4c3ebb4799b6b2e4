"""Command-line entry point of the port:

  python -m fhe_spear_tpu_torch retrieval       # encrypted retrieval
  python -m fhe_spear_tpu_torch generate        # client-aided RWKV-7
  python -m fhe_spear_tpu_torch fullenc         # fully-encrypted FFN chain
  python -m fhe_spear_tpu_torch access-control  # per-user noise corrections
  python -m fhe_spear_tpu_torch noise-study     # per-passage vs per-class

The flags are those of the same subcommands of `python -m fhe_spear_tpu`,
plus --device (default cuda; cpu runs the plain torch path).  The
`fhesim` subcommand arrives with its slice.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def _ctx(n, limbs, specials, seed, device):
    from .ckks import CkksContext, CkksParams

    t0 = time.perf_counter()
    ctx = CkksContext(CkksParams(n=n, num_limbs=limbs, num_special=specials),
                      seed=seed, device=device)
    print(f"context: N={n} L={limbs} K={specials} on {ctx.device} "
          f"({time.perf_counter() - t0:.1f}s)")
    return ctx


def cmd_retrieval(args):
    from .apps.demo import recall_benchmark, run_demo

    if args.recall:
        out = recall_benchmark(n_docs=args.n_docs, mode=args.mode,
                               device=args.device)
        print(f"retrieval R@1/5/10: {out['recall@1']:.2f}/"
              f"{out['recall@5']:.2f}/{out['recall@10']:.2f}")
        return
    agree, n_q = run_demo(n_docs=args.n_docs, mode=args.mode,
                          device=args.device)
    print(f"retrieval: {agree}/{n_q} encrypted top-1 matches plaintext")


def cmd_generate(args):
    from .models.client_aided import run_generation
    from .models.rwkv7 import load_torch_model, make_random_model

    if args.weights:
        model = load_torch_model(args.weights, args.d, args.f, args.blocks)
    else:
        model = make_random_model(d=args.d, f=args.f, n_blocks=args.blocks,
                                  head_size=args.head_size, seed=args.seed)
    ctx = _ctx(args.n, args.level, args.specials, args.seed, args.device)
    results = run_generation(ctx, model, seed_tokens=[5, 11, 2],
                             num_tokens=args.tokens, level=args.level,
                             fused=not args.no_fused)
    match = sum(r["match"] for r in results)
    print(f"generation: {match}/{len(results)} tokens match plaintext; "
          f"mean {np.mean([r['sec'] for r in results]):.2f}s/token")


def cmd_fullenc(args):
    from .models.fully_encrypted import run_fully_encrypted

    rng = np.random.default_rng(args.seed)
    wk = [rng.normal(0, 0.02, (args.d, args.f)) for _ in range(args.blocks)]
    wv = [rng.normal(0, 0.02, (args.f, args.d)) for _ in range(args.blocks)]
    x0 = rng.normal(0, 0.1, args.d)
    ctx = _ctx(args.n, args.l0, args.specials, args.seed, args.device)
    stats = run_fully_encrypted(ctx, wk, wv, x0)
    if stats:
        print(f"fullenc: {len(stats)} blocks, final corr "
              f"{stats[-1]['corr']:.8f}, "
              f"{np.mean([s['sec'] for s in stats]):.2f}s/block")


def cmd_access_control(args):
    from .apps.access_control import (AccessControlledCorpus,
                                      classify_passage, security_sweep)
    from .apps.demo import hashed_embed, load_msmarco_sft, svd_compress

    passages, _ = load_msmarco_sft(n=args.n_docs)
    if not passages:
        passages = [f"Revenue was ${i}.5 million in 2020 for org {i}"
                    if i % 2 else f"plain passage {i}"
                    for i in range(args.n_docs)]
    classes = [classify_passage(p) for p in passages]
    z, _ = svd_compress(hashed_embed(passages), args.dim)
    # SVD rank (and therefore the packed dim) is capped by the corpus size
    dim = z.shape[1]
    ctx = _ctx(args.n, 3, 1, args.seed, args.device)
    corpus = AccessControlledCorpus(ctx, dim=dim,
                                    noise_scale=args.noise_scale,
                                    per_passage=args.per_passage,
                                    seed=args.seed)
    corpus.build(z, classes)
    all_classes = set(corpus.classes)
    alice = corpus.retrieve(z[0], corpus.apply_corrections(
        corpus.corrections_for(all_classes)))
    bob = corpus.retrieve(z[0], corpus.apply_corrections(
        corpus.corrections_for(set())))
    print(f"alice top: {int(np.argmax(alice))} (expect 0); "
          f"bob top: {int(np.argmax(bob))}")
    for row in security_sweep(corpus, z, classes):
        print(f"  scale={row['scale']}: separation {row['separation']:.1f}x")
    if args.generate:
        # FHE generation on each user's retrieved passage
        from .apps.access_control import generation_demo
        from .models.client_aided import FheRwkvClient, FheRwkvServer
        from .models.rwkv7 import make_random_model

        model = make_random_model(d=args.gen_d, f=4 * args.gen_d,
                                  n_blocks=args.gen_blocks,
                                  head_size=min(16, args.gen_d),
                                  seed=args.seed + 1)
        gen_ctx = _ctx(args.gen_n, 3, 1, args.seed + 2, args.device)
        server = FheRwkvServer(gen_ctx, model, level=3)
        client = FheRwkvClient(gen_ctx, model, server)
        res = generation_demo(
            corpus, passages, z[0],
            "Based on the text above, the key figure is",
            {"alice": all_classes, "bob": set()}, client,
            num_tokens=args.tokens, verbose=True)
        print(f"outputs differ: {res['outputs_differ']}; "
              f"alice token-exact: "
              f"{res['alice']['token_matches']}/{args.tokens}")


def cmd_noise_study(args):
    from .apps.noise_study import main as study_main

    study_main(device=args.device)


def _device_flag(parser):
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain "
                             "torch path)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="fhe_spear_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("retrieval")
    r.add_argument("--n_docs", type=int, default=64)
    r.add_argument("--mode", choices=["row", "column"], default="row")
    r.add_argument("--recall", action="store_true",
                   help="R@k benchmark (gold+distractor protocol)")
    _device_flag(r)
    r.set_defaults(fn=cmd_retrieval)

    g = sub.add_parser("generate")
    g.add_argument("--d", type=int, default=1024)
    g.add_argument("--f", type=int, default=4096)
    g.add_argument("--blocks", type=int, default=24)
    g.add_argument("--tokens", type=int, default=3)
    g.add_argument("--n", type=int, default=8192)
    g.add_argument("--level", type=int, default=3)
    g.add_argument("--specials", type=int, default=1)
    g.add_argument("--head_size", type=int, default=64)
    g.add_argument("--weights", type=str, default=None,
                   help="path to a real RWKV-7 .pth checkpoint")
    g.add_argument("--seed", type=int, default=42)
    g.add_argument("--no-fused", action="store_true",
                   help="explicit ciphertext transport (host randomness)")
    _device_flag(g)
    g.set_defaults(fn=cmd_generate)

    f = sub.add_parser("fullenc")
    f.add_argument("--d", type=int, default=2048)
    f.add_argument("--f", type=int, default=4096)
    f.add_argument("--blocks", type=int, default=8)
    f.add_argument("--l0", type=int, default=26)
    f.add_argument("--n", type=int, default=16384)
    f.add_argument("--specials", type=int, default=1)
    f.add_argument("--seed", type=int, default=42)
    _device_flag(f)
    f.set_defaults(fn=cmd_fullenc)

    a = sub.add_parser("access-control")
    a.add_argument("--n_docs", type=int, default=30)
    a.add_argument("--dim", type=int, default=32)
    a.add_argument("--n", type=int, default=2048)
    a.add_argument("--noise_scale", type=float, default=100.0)
    a.add_argument("--per_passage", action="store_true")
    a.add_argument("--seed", type=int, default=0)
    a.add_argument("--generate", action="store_true",
                   help="chain per-user retrieval into FHE generation on "
                        "the retrieved passage")
    a.add_argument("--tokens", type=int, default=3)
    a.add_argument("--gen_d", type=int, default=64)
    a.add_argument("--gen_blocks", type=int, default=2)
    a.add_argument("--gen_n", type=int, default=2048)
    _device_flag(a)
    a.set_defaults(fn=cmd_access_control)

    ns = sub.add_parser("noise-study",
                        help="per-passage vs per-class leak study")
    _device_flag(ns)
    ns.set_defaults(fn=cmd_noise_study)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
