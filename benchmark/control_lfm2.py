"""Readings for the limits of an LFM2 decode cell's comparison: the
program's numbers over several seeds, and the controls' on the same
weights and ids.

    python3 benchmark/control_lfm2.py --workload <cell> --seconds <s> \\
        --seeds 11,12,13 [--controls tf32,bfloat16] [--control-seeds 11,12]
        [--program-tf32] [--steps 42]

For each seed: one run of the cell as `run.py` makes it (set-up, the
window, the comparison), then, for the seeds in --control-seeds (default
all), each control: the plain reference in a precision below the
program's (`benchmark/reference/lfm2.py`: "tf32" or "bfloat16"), routing
by its own scores, put in the program's place on the same weights and
ids for as many steps as the window ran, held against the float64
reference by the same comparison and the cell's limits.  With
--program-tf32 the program itself runs with torch's TF32 switch for
float32 products on.  With --steps the program does not run: each seed's
controls alone over that many steps of its ids (the weights and ids a
run of that seed uses).  One JSON line a seed on standard output.  The
benchmark's own runs never run a control.  Needs a CUDA card.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    import os
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def control_numbers(drv, steps: int, precision: str, device,
                    tie: float) -> dict:
    """The comparison's numbers with the reference in `precision` in the
    program's place, on drv's weights and ids for `steps` steps."""
    from benchmark.compare import precision_switches
    from benchmark.drivers.decode_lfm2 import compare_lfm2
    from benchmark.reference.lfm2 import reference_logits

    ids = drv.ids.window(steps)
    low, info = reference_logits(drv.weights, ids, device, precision)
    numbers = compare_lfm2(drv.weights, ids, low, info["routes"], device,
                           tie)
    numbers["tf32_switches_on"] = float(len(precision_switches()))
    return numbers


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from benchmark.compare import verdict
    from benchmark.harness import load_manifest, resolve, run_cell

    ap = argparse.ArgumentParser(prog="benchmark/control_lfm2.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="tf32,bfloat16")
    ap.add_argument("--control-seeds", default=None)
    ap.add_argument("--program-tf32", action="store_true",
                    help="the program's float32 products in TF32")
    ap.add_argument("--steps", type=int, default=None,
                    help="no program run: the controls over this many "
                         "steps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control_lfm2.py needs a CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    cseeds = (seeds if args.control_seeds is None
              else [int(s) for s in args.control_seeds.split(",")])
    spec = resolve(load_manifest(ROOT), args.workload)
    limits = spec["config"]["limits"]
    tie = float(limits.get("route_margin_max", 0.0))
    for seed in seeds:
        if args.steps:
            from benchmark.drivers.decode_lfm2 import Driver
            from benchmark.weights_lfm2 import make_weights

            drv = Driver(spec["config"], spec["traffic"], seed, "cuda")
            drv.weights = make_weights(spec["config"], seed, "cuda")
            line = {"workload": args.workload, "seed": seed,
                    "steps": args.steps}
            for prec in filter(None, args.controls.split(",")):
                numbers = control_numbers(drv, args.steps, prec, "cuda",
                                          tie)
                line[prec] = dict(numbers,
                                  correct=verdict(numbers, limits)[0])
            print(json.dumps(line), flush=True)
            continue
        torch.backends.cuda.matmul.allow_tf32 = args.program_tf32
        res = run_cell(spec, seed, args.seconds, False, "cuda",
                       time.perf_counter())
        torch.backends.cuda.matmul.allow_tf32 = False
        drv, rec = res.pop("driver"), res.pop("rec")
        line = {"workload": args.workload, "seed": seed,
                "program_tf32": args.program_tf32,
                "correct": res["correct"], "program": res["numbers"],
                "steps": rec["steps"], "metrics": res["metrics"],
                "memory_peak_bytes": res["memory_peak_bytes"],
                "spans": rec["spans"]}
        if seed in cseeds:
            for prec in filter(None, args.controls.split(",")):
                t0 = time.perf_counter()
                numbers = control_numbers(drv, rec["steps"], prec, "cuda",
                                          tie)
                line[prec] = dict(numbers,
                                  correct=verdict(numbers, limits)[0])
                line[prec + "_s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del drv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
