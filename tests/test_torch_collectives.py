"""The port's rank launcher and int64 collectives (`parallel.collectives`)
on gloo ranks on the CPU: `psum_mod` at its edge (p - 1 from every rank),
a ragged `all_gather_rows`, `all_to_all`, `ring_shift`; the launcher
returns results in rank order, its children load neither jax nor the JAX
package, a rank that raises fails the run with its traceback, and a rank
that never joins a collective makes `run_ranks` raise within its
deadline.  The same 3-rank spawn runs the key-sharded chain, where one
rank holds no target row at the chain's lower levels."""

import time

import numpy as np
import pytest
import torch

from fhe_spear_tpu_torch.parallel.collectives import rank_device, run_ranks
from fhe_spear_tpu_torch.parallel.dryrun import collective_ops, run_jobs

P = 2**31 - 1


@pytest.fixture(scope="module")
def spawn3():
    return run_ranks(run_jobs, 3, "gloo", "cpu", 120.0,
                     [("ops", "collective_ops", {"p": P}),
                      ("keys", "key_sharded_chain", {})], threads=1)


@pytest.fixture(scope="module")
def three(spawn3):
    return [r["ops"] for r in spawn3]


def test_psum_mod_edge(three):
    for r in three:
        np.testing.assert_array_equal(r["psum"], np.full((2, 3, 4),
                                                         3 * (P - 1) % P))


def test_all_gather_rows_ragged(three):
    want = np.concatenate([np.full((k + 1, 4), k) for k in range(3)])
    for r in three:
        np.testing.assert_array_equal(r["rows"], want)


def test_all_to_all(three):
    for rank, r in enumerate(three):
        want = np.array([[100 * src + 2 * rank, 100 * src + 2 * rank + 1]
                         for src in range(3)])
        np.testing.assert_array_equal(r["a2a"], want)


def test_ring_shift(three):
    assert [int(r["ring"][0]) for r in three] == [2, 0, 1]
    assert all(r["stats"]["calls"] == 4 for r in three)
    assert all(r["stats"]["host_bytes"] == 0 for r in three)


def test_children_load_no_jax(three):
    assert all(r["loaded"] == [] for r in three)


def test_failing_rank_raises_with_traceback():
    with pytest.raises(RuntimeError, match="unknown_job"):
        run_ranks(run_jobs, 2, "gloo", "cpu", 60.0,
                  [("x", "unknown_job", {})], threads=1)


def test_rank_that_never_joins_times_out():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        run_ranks(collective_ops, 2, "gloo", "cpu", 6.0, P, 0, 120.0,
                  threads=1)
    assert time.monotonic() - t0 < 6.0 + 10.0


def test_rank_devices():
    assert rank_device("gloo", "cpu", 1, 2) == torch.device("cpu")
    with pytest.raises(ValueError):
        rank_device("mpi", "cpu", 0, 1)
    with pytest.raises((RuntimeError, ValueError)):
        rank_device("nccl", "cpu", 0, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            rank_device("gloo", "cuda", 0, 2)
        with pytest.raises(RuntimeError):
            rank_device("nccl", "cuda", 0, 2)


def test_key_sharded_chain_with_a_rank_without_targets(spawn3):
    """L+K = 17 rows padded to 18, 6 a rank: at levels 5-8 rank 1's rows
    (6-11) are neither limbs below the level nor specials (14-16)."""
    for r in spawn3:
        k = r["keys"]
        assert k["equal"] and k["key_rows"] == 6, k
        assert k["corr"] > 0.999999, k
    assert len({r["keys"]["digest"] for r in spawn3}) == 1
