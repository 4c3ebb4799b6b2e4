"""The port's int64 modular arithmetic against the JAX package's uint32 jnp
functions, word for word, on random canonical residues plus the edge
values 0, p-1 and primes close to 2^31."""

from dataclasses import astuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_spear_tpu.core import modops as ref
from fhe_spear_tpu.core.primes import find_ntt_primes as ref_primes
from fhe_spear_tpu_torch.core import modops as port
from fhe_spear_tpu_torch.core.primes import find_ntt_primes


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small-ring torch ops gain nothing from intra-op threads, and under a
    parallel test run the threads of several workers oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# q0 (just below 2^31), scale primes near 2^28, one special just below 2^31
PRIMES = find_ntt_primes(1024, 3, reserve_special=1)


def test_primes_copy_equal():
    want = ref_primes(1024, 3, reserve_special=1)
    assert [astuple(q) for q in PRIMES] == [astuple(q) for q in want]
    assert PRIMES[0].p > (1 << 30) and PRIMES[-1].p < (1 << 31)


def _operands(p, n=4096, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, p, n, dtype=np.int64)
    b = rng.integers(0, p, n, dtype=np.int64)
    edge = np.array([0, 1, p - 1, p - 2, p // 2], dtype=np.int64)
    a = np.concatenate([a, np.repeat(edge, len(edge))])
    b = np.concatenate([b, np.tile(edge, len(edge))])
    return a, b


def _both(fn_ref, fn_port, *args):
    want = np.asarray(fn_ref(*[jnp.asarray(np.asarray(x, dtype=np.uint32))
                               for x in args])).astype(np.int64)
    got = fn_port(*[torch.as_tensor(np.asarray(x, dtype=np.int64))
                    for x in args]).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("prime", PRIMES, ids=lambda q: str(q.p))
def test_modops_word_for_word(prime):
    p, pinv = prime.p, prime.mont_pinv
    a, b = _operands(p)
    P = np.full_like(a, p)
    PINV = np.full_like(a, pinv)
    _both(ref.add_mod, port.add_mod, a, b, P)
    _both(ref.sub_mod, port.sub_mod, a, b, P)
    _both(ref.neg_mod, port.neg_mod, a, P)
    _both(ref.mont_mul, port.mont_mul, a, b, P, PINV)
    # REDC of a wide value hi*2^32 + lo < p*2^32 (hi < p, any lo)
    rng = np.random.default_rng(1)
    lo = rng.integers(0, 1 << 32, a.shape, dtype=np.int64)
    lo[:3] = [0, 1, (1 << 32) - 1]
    _both(ref.mont_reduce_wide, port.mont_reduce_wide, a, lo, P, PINV)
    # Barrett of any 32-bit word
    mu = np.full_like(a, (1 << 32) // p)
    _both(ref.barrett_reduce, port.barrett_reduce, lo, P, mu)
    _both(ref.mul_hi_u32, port.mul_hi_u32, lo, b)


def test_mul_lo_u32_wraps():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 1 << 32, 1000, dtype=np.int64)
    b = rng.integers(0, 1 << 32, 1000, dtype=np.int64)
    want = (a.astype(np.uint64) * b.astype(np.uint64)).astype(np.int64) \
        & 0xFFFFFFFF
    got = port.mul_lo_u32(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_array_equal(got, want)
