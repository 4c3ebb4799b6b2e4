"""Command-line entry point of the port:

  python -m fhe_spear_tpu_torch generate   # client-aided RWKV-7 generation

The flags are those of `python -m fhe_spear_tpu generate`, plus --device
(default cuda).  The other subcommands of the reference arrive with their
slices.
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


def main(argv=None):
    p = argparse.ArgumentParser(prog="fhe_spear_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

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
    g.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "torch path)")
    g.set_defaults(fn=cmd_generate)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
