"""The port's copy of the factorized special-FFT stages (`ckks/dft.py`)
equals the reference's exactly: `bitrev`, the twiddles, the forward and
inverse stage tables at 16, 64 and 256 slots, their collapses at radix 2,
3 and 4, and the host evaluation of a stage list."""

import numpy as np
import pytest
import torch

from fhe_spear_tpu.ckks import dft as ref_dft
from fhe_spear_tpu_torch.ckks import dft


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small-ring torch ops gain nothing from intra-op threads, and under a
    parallel test run the threads of several workers oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SLOTS = (16, 64, 256)


def assert_tables_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)          # same offsets, same order
        for o in w:
            assert np.array_equal(g[o], w[o]), o


@pytest.mark.parametrize("m", [1, 4, 6, 8])
def test_bitrev_and_twiddles(m):
    np.testing.assert_array_equal(dft.bitrev(m), ref_dft.bitrev(m))
    h = 1 << (m - 1)
    np.testing.assert_array_equal(dft._twiddles(h), ref_dft._twiddles(h))


@pytest.mark.parametrize("slots", SLOTS)
def test_stage_tables(slots):
    assert_tables_equal(dft.special_fft_stages(slots),
                        ref_dft.special_fft_stages(slots))
    assert_tables_equal(dft.inverse_stages(slots),
                        ref_dft.inverse_stages(slots))


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("radix", [2, 3, 4])
def test_collapsed_tables(slots, radix):
    for fn in ("special_fft_stages", "inverse_stages"):
        got = dft.collapse_stages(getattr(dft, fn)(slots), radix, slots)
        want = ref_dft.collapse_stages(getattr(ref_dft, fn)(slots), radix,
                                       slots)
        assert_tables_equal(got, want)
    a = dft.special_fft_stages(slots)[0]
    b = dft.special_fft_stages(slots)[1]
    assert_tables_equal([dft._compose(b, a, slots)],
                        [ref_dft._compose(b, a, slots)])


@pytest.mark.parametrize("slots", SLOTS)
def test_apply_stages_host(slots):
    rng = np.random.default_rng(slots)
    x = rng.standard_normal(slots) + 1j * rng.standard_normal(slots)
    st = dft.collapse_stages(dft.inverse_stages(slots), 3, slots)
    np.testing.assert_array_equal(dft.apply_stages_host(st, x),
                                  ref_dft.apply_stages_host(st, x))
