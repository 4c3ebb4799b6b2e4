"""Run one cell of BENCHMARK.json once, on the card this process sees.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of the repository.  The run makes its weights and ids from
--seed, sets up and warms up the program (`fhe_spear_tpu_torch`), measures
for --seconds, frees the program's state, holds the window's outputs
against the plain reference and prints, as the last line of standard
output, one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1),
device, breakdown (--trace 1) and checks (each compared number with its
limit, last).  The same numbers are the last lines of standard error.

It exits non-zero and prints no result without a CUDA card (or with
fewer than the cell asks for), and when a module of `jax`, `jaxlib`,
`flax` or the JAX package `fhe_spear_tpu` is loaded once the window has
closed.  Build and kernel caches stay in `build/` of the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    # import the benchmark as a package of the checkout's root, and keep
    # every build cache inside the checkout
    sys.path[0] = str(ROOT)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _power_limit_w():
    """The card's power limit in W from nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def execute(args, spec, device, t_start):
    """Run the cell and build the result line; None (after naming them
    on standard error) when a forbidden module was loaded."""
    import torch

    from benchmark.harness import forbidden_modules, run_cell

    res = run_cell(spec, args.seed, args.seconds, bool(args.trace), device,
                   t_start)
    bad = forbidden_modules()
    if bad:
        print("forbidden modules loaded: " + ", ".join(bad),
              file=sys.stderr, flush=True)
        return None
    dev = torch.device(device)
    if dev.type == "cuda":
        info = {"platform": "gpu",
                "kind": torch.cuda.get_device_name(dev),
                "count": spec["cell"]["chips"],
                "memory_peak_bytes": res["memory_peak_bytes"],
                "power_limit_w": _power_limit_w()}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if args.trace and "busy_s" in res:
        info["busy_s"] = res["busy_s"]
        info["window_s"] = res["window_s"]
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": info}
    if args.trace and "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in res["checks"]}
    return line


def report(line) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark.harness import load_manifest, resolve

    spec = resolve(load_manifest(ROOT), args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec["cell"]["chips"]:
        print(f"{torch.cuda.device_count()} CUDA cards, the cell asks for "
              f"{spec['cell']['chips']}", file=sys.stderr)
        return 2
    import fhe_spear_tpu_torch  # noqa: F401  (the program must be here)

    line = execute(args, spec, "cuda", T_START)
    if line is None:
        return 3
    report(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
