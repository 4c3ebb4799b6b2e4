"""Readings for the limits of a cell's comparison: the program's numbers
over several seeds, and the controls' on the same weights and ids.

    python3 benchmark/control.py --workload <cell> --seconds <s> \\
        --seeds 11,12,13 [--controls tf32,bfloat16] [--control-seeds 11,12]
        [--program-tf32] [--scale-bits 26] [--detail file]

For each seed: one run of the cell as `run.py` makes it (set-up, the
window, the comparison), then, for the seeds in --control-seeds (default
all), the control: the plain reference in a precision below the
program's (`benchmark/reference/rwkv7.py`: "tf32" or "bfloat16") put in
the program's place on the same weights and the same ids for as many
steps as the window ran, held against the float64 reference by the same
comparison.  With --program-tf32 the program itself runs with torch's
TF32 switch for float32 products on (its own path one step below the
precision that the configuration states); with --scale-bits at another
CKKS scale than the configuration's.  One JSON line a seed on standard
output.  The benchmark's own runs never run a control.  Needs a CUDA card.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0] = str(ROOT)


def control_numbers(drv, steps: int, precision: str, device,
                    per_step=None) -> dict:
    """The comparison's numbers with the reference in `precision` in the
    program's place, on drv's weights and ids for `steps` steps."""
    from benchmark.compare import compare_logits, precision_switches
    from benchmark.reference.rwkv7 import reference_logits

    ids = drv.ids.window(steps)
    logits = reference_logits(drv.weights, ids, device, precision)
    numbers = compare_logits(drv.weights, ids, logits, device, per_step)
    numbers["tf32_switches_on"] = float(len(precision_switches()))
    return numbers


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from benchmark.harness import load_manifest, resolve, run_cell

    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="tf32,bfloat16")
    ap.add_argument("--control-seeds", default=None)
    ap.add_argument("--detail", default=None,
                    help="file for each step's numbers, a JSON line a seed")
    ap.add_argument("--program-tf32", action="store_true",
                    help="the program's float32 products in TF32")
    ap.add_argument("--scale-bits", type=int, default=None,
                    help="the CKKS scale's bits in place of the config's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    cseeds = (seeds if args.control_seeds is None
              else [int(s) for s in args.control_seeds.split(",")])
    spec = resolve(load_manifest(ROOT), args.workload)
    if args.scale_bits is not None:
        spec["config"]["ckks"]["scale_bits"] = args.scale_bits
    for seed in seeds:
        torch.backends.cuda.matmul.allow_tf32 = args.program_tf32
        res = run_cell(spec, seed, args.seconds, False, "cuda",
                       time.perf_counter())
        torch.backends.cuda.matmul.allow_tf32 = False
        drv, rec = res.pop("driver"), res.pop("rec")
        line = {"workload": args.workload, "seed": seed,
                "program_tf32": args.program_tf32,
                "scale_bits": spec["config"]["ckks"]["scale_bits"],
                "correct": res["correct"], "program": res["numbers"],
                "steps": rec["steps"], "metrics": res["metrics"],
                "memory_peak_bytes": res["memory_peak_bytes"],
                "spans": rec["spans"]}
        detail = {"seed": seed}
        if args.detail:
            from benchmark.compare import compare_logits
            detail["program"] = []
            compare_logits(drv.weights, drv.ids.window(rec["steps"]),
                           drv.logits, "cuda", detail["program"])
        if seed in cseeds:
            for prec in filter(None, args.controls.split(",")):
                t0 = time.perf_counter()
                detail[prec] = [] if args.detail else None
                line[prec] = control_numbers(drv, rec["steps"], prec, "cuda",
                                             detail[prec])
                line[prec + "_s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        if args.detail:
            with open(args.detail, "a") as fh:
                fh.write(json.dumps(detail) + "\n")
        del drv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
