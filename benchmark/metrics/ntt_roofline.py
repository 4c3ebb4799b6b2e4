"""ntt_roofline (%), layer "NTT kernels": the sum of each K1/K2 launch's
least time (`benchmark/roofline.ntt_bound_s` at its (B, R, N), from the
program's counters read across exactly the profiled steps) over the
device time of the K1/K2 kernels in those steps.  Moves step_ms."""

from benchmark.roofline import ntt_bound_s


def read(rec):
    tr, counts = rec["trace"], rec["counters_profiled"]
    if not tr or not counts or not tr["device_s"].get("ntt"):
        return None
    bound = sum(n * ntt_bound_s(*shape)[0]
                for k in ("ntt_fwd", "ntt_inv")
                for shape, n in counts.get(k, {}).items())
    return 100.0 * bound / tr["device_s"]["ntt"] if bound else None
