"""Readings for the limits of a fully-encrypted chain cell's comparison:
the program's numbers over several seeds, and the controls' on the same
weights and inputs.

    python3 benchmark/control_chain.py --workload <cell> --seconds <s> \\
        --seeds 11,12,13 [--controls float16,bfloat16] [--control-seeds 11]

For each seed: one run of the cell as `run.py` makes it (set-up, the
window, the comparison), then, for the seeds in --control-seeds (default
all), each control: the plain chain (`benchmark/reference/ffn_chain.py`)
in a precision below the program's, put in the program's place on the
same weights and the same inputs for as many steps as the window ran,
held against the float64 chain by the same comparison and the cell's
limits.  One JSON line a seed on standard output.  The benchmark's own
runs never run a control.  Needs a CUDA card.
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


def control_numbers(drv, steps: int, precision: str, device) -> dict:
    """The comparison's numbers with the chain in `precision` in the
    program's place, on drv's weights and inputs for `steps` steps."""
    from benchmark.compare import precision_switches
    from benchmark.drivers.fullenc import compare_outputs
    from benchmark.reference.ffn_chain import reference_outputs

    xs = drv.inputs.window(steps)
    low = reference_outputs(drv.weights, xs.reshape(-1, xs.shape[-1]),
                            device, precision)
    numbers = compare_outputs(drv.weights, xs, low, device)
    numbers["tf32_switches_on"] = float(len(precision_switches()))
    return numbers


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from benchmark.compare import verdict
    from benchmark.harness import load_manifest, resolve, run_cell

    ap = argparse.ArgumentParser(prog="benchmark/control_chain.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="float16,bfloat16")
    ap.add_argument("--control-seeds", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control_chain.py needs a CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    cseeds = (seeds if args.control_seeds is None
              else [int(s) for s in args.control_seeds.split(",")])
    spec = resolve(load_manifest(ROOT), args.workload)
    limits = spec["config"]["limits"]
    for seed in seeds:
        res = run_cell(spec, seed, args.seconds, False, "cuda",
                       time.perf_counter())
        drv, rec = res.pop("driver"), res.pop("rec")
        line = {"workload": args.workload, "seed": seed,
                "correct": res["correct"], "program": res["numbers"],
                "steps": rec["steps"], "metrics": res["metrics"],
                "memory_peak_bytes": res["memory_peak_bytes"],
                "spans": rec["spans"]}
        if seed in cseeds:
            for prec in filter(None, args.controls.split(",")):
                numbers = control_numbers(drv, rec["steps"], prec, "cuda")
                line[prec] = dict(numbers,
                                  correct=verdict(numbers, limits)[0])
        print(json.dumps(line), flush=True)
        del drv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
