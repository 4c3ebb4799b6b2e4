"""The metric arithmetic on the CPU: K1/K2's least times reproduce the
bound column of the kernel table in PERF.md at the decode token's shapes,
the step's least time depends on the configuration's shapes alone, and
the readers return nothing where a run has nothing to read."""

import pytest

from benchmark.harness import load_reader
from benchmark.roofline import ntt_bound_s, step_bound
from benchmark.trace import kernel_class

from .conftest import tiny_spec


@pytest.mark.parametrize("shape,ms", [((368, 3), 0.0433), ((24, 4), 0.0038),
                                      ((90, 1), 0.0035), ((8, 3), 0.0010)])
def test_ntt_bound_reproduces_the_kernel_table(shape, ms):
    s, by = ntt_bound_s(*shape, 8192)
    assert by == "bytes"
    assert round(1e3 * s, 4) == ms


def _rec(cfg, streams, counts, mean=0.4):
    return {"unprofiled_mean_s": mean, "step_bound": step_bound(cfg, streams),
            "counters_window": {"ntt_fwd": counts}, "steps": 10}


def test_step_mfu_depends_on_shapes_only():
    from benchmark.harness import resolve, load_manifest

    cfg = resolve(load_manifest(), "rwkv7-1.5b.s1")["config"]
    b = step_bound(cfg, 1)
    # 2 blocks x 8 matrices x 2048 diagonals x 8192 32-bit coefficients,
    # plus 89 rotation keys of 2 x 3 digits x 4 rows x 8192 words
    assert b["bytes"] == 2 * 8 * 2048 * 8192 * 4 + 89 * 2 * 3 * 4 * 8192 * 4
    assert b["by"] == "bytes"
    read = load_reader("step_mfu")
    one = read(_rec(cfg, 1, {(368, 3, 8192): 80}))
    assert one == read(_rec(cfg, 1, {(368, 3, 8192): 800, (8, 3, 8192): 7}))
    assert one == pytest.approx(100 * b["s"] / 0.4)
    assert step_bound(cfg, 4)["s"] == b["s"]      # still bound by bytes
    assert step_bound(cfg, 4)["ops"] == 4 * b["ops"]


def test_ntt_roofline_and_trace_readers():
    rec = {"trace": {"device_s": {"ntt": 0.002, "glue": 0.3},
                     "busy_s": 0.5, "kernels": 40000},
           "counters_profiled": {"ntt_fwd": {(368, 3, 8192): 20},
                                 "ntt_inv": {(8, 3, 8192): 20}},
           "profiled_steps": 2, "profiled_wall_s": 1.0}
    want = 100 * 20 * (ntt_bound_s(368, 3, 8192)[0]
                       + ntt_bound_s(8, 3, 8192)[0]) / 0.002
    assert load_reader("ntt_roofline")(rec) == pytest.approx(want)
    assert load_reader("glue_ms_per_step")(rec) == pytest.approx(150.0)
    assert load_reader("device_idle")(rec) == pytest.approx(50.0)
    assert load_reader("kernels_per_step")(rec) == 20000
    empty = dict(rec, trace=None, counters_profiled=None)
    for name in ("ntt_roofline", "glue_ms_per_step", "device_idle",
                 "kernels_per_step"):
        assert load_reader(name)(empty) is None


def test_kernel_classes():
    assert kernel_class("void ntt_fwd_kernel<13>(Params)") == "ntt"
    assert kernel_class("void ntt_inv_kernel<13>(Params)") == "ntt"
    assert kernel_class("fourstep_fwd_kernel(Params)") == "fourstep"
    assert kernel_class("void regular_fft<256u, EPT<8u> >(...)") == "fft"
    assert kernel_class("void dpRadix0032B::kernel1Mem<...>") == "fft"
    assert kernel_class("Memcpy HtoD (Pageable -> Device)") == "copy"
    assert kernel_class("void at::native::vectorized_elementwise_kernel"
                        "<4, at::native::AddFunctor<long> >") == "glue"


def test_counts_of_a_cpu_run_read_nothing():
    """A tiny run on the CPU launches no K1/K2 and traces no device: the
    readers of those return nothing."""
    import time

    from benchmark.harness import run_cell

    res = run_cell(tiny_spec("rwkv7-1.5b.s1"), 9, 0.1, True, "cpu",
                   time.perf_counter(), log=lambda m: None)
    rec = res["rec"]
    assert rec["steps"] >= 6 and rec["profiled_steps"] == 4
    assert set(res["metrics"]) == {"keys_s", "stage_s", "step_mfu"}
