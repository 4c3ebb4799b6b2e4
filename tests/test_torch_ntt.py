"""The port's NTT/iNTT against the JAX package's, bitwise: the plain torch
version (what a CPU tensor runs) against both `NttContext.ntt/intt` and
the Pallas kernels `ntt_pallas/intt_pallas` in interpret mode, at
n in {128, 256, 1024}, R=3, B=4, the rows=(0, 2) subset at l=4, the round
trip and `automorphism_perm`.  The CUDA kernels against the plain version
run in the `cuda`-marked test (and in chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_spear_tpu.core import ntt as ref_ntt
from fhe_spear_tpu.core.ntt_pallas import intt_pallas, ntt_pallas
from fhe_spear_tpu.core.primes import find_ntt_primes as ref_primes
from fhe_spear_tpu_torch.core import ntt as port_ntt
from fhe_spear_tpu_torch.core import ntt_cuda
from fhe_spear_tpu_torch.core.primes import find_ntt_primes


def _residues(primes, shape, seed=0):
    """Canonical residues [B, R, N] (limb r mod primes[r])."""
    rng = np.random.default_rng(seed)
    p = np.array([q.p for q in primes], dtype=np.int64)
    return rng.integers(0, p[:, None], size=shape, dtype=np.int64)


@pytest.mark.parametrize("n", [128, 256, 1024])
def test_ntt_bitwise_three_ways(n):
    l, b = 3, 4
    pctx = port_ntt.NttContext.build(n, find_ntt_primes(n, l), device="cpu")
    rctx = ref_ntt.NttContext.build(n, ref_primes(n, l))
    x = _residues(pctx.primes, (b, l, n))
    got = pctx.ntt(torch.as_tensor(x)).numpy()
    want = np.asarray(rctx.ntt(jnp.asarray(x.astype(np.uint32))))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    # the Pallas kernel takes [R, B, N]
    pallas = np.asarray(ntt_pallas(rctx, jnp.asarray(
        x.transpose(1, 0, 2).astype(np.uint32)), interpret=True))
    np.testing.assert_array_equal(got, pallas.transpose(1, 0, 2))

    back = pctx.intt(torch.as_tensor(got)).numpy()
    np.testing.assert_array_equal(back, x)
    want_i = np.asarray(rctx.intt(jnp.asarray(got.astype(np.uint32))))
    np.testing.assert_array_equal(back, want_i.astype(np.int64))
    pallas_i = np.asarray(intt_pallas(rctx, jnp.asarray(
        got.transpose(1, 0, 2).astype(np.uint32)), interpret=True))
    np.testing.assert_array_equal(back, pallas_i.transpose(1, 0, 2))


def test_ntt_row_subset():
    n, l = 256, 4
    rows = (0, 2)
    pctx = port_ntt.NttContext.build(n, find_ntt_primes(n, l), device="cpu")
    rctx = ref_ntt.NttContext.build(n, ref_primes(n, l))
    x = _residues(pctx.primes, (2, l, n))[:, list(rows)]
    got = pctx.ntt(torch.as_tensor(x), rows).numpy()
    want = np.asarray(rctx.ntt(jnp.asarray(x.astype(np.uint32)), rows))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    pallas = np.asarray(ntt_pallas(rctx, jnp.asarray(
        x.transpose(1, 0, 2).astype(np.uint32)), rows=rows, interpret=True))
    np.testing.assert_array_equal(got, pallas.transpose(1, 0, 2))
    np.testing.assert_array_equal(
        pctx.intt(torch.as_tensor(got), rows).numpy(), x)


def test_tables_mont_and_automorphism():
    n, l = 256, 3
    pctx = port_ntt.NttContext.build(n, find_ntt_primes(n, l), device="cpu")
    rctx = ref_ntt.NttContext.build(n, ref_primes(n, l))
    for name in ("psi", "psi_inv_n", "p", "pinv", "r2"):
        np.testing.assert_array_equal(
            getattr(pctx, name).numpy(),
            np.asarray(getattr(rctx, name)).astype(np.int64))
    for s in range(pctx.logn):
        np.testing.assert_array_equal(pctx.fwd_tw[s].numpy(),
                                      np.asarray(rctx.fwd_tw[s]))
        np.testing.assert_array_equal(pctx.inv_tw[s].numpy(),
                                      np.asarray(rctx.inv_tw[s]))
    x = _residues(pctx.primes, (l, n))
    for fn in ("to_mont", "from_mont"):
        got = getattr(pctx, fn)(torch.as_tensor(x)).numpy()
        want = np.asarray(getattr(rctx, fn)(jnp.asarray(x.astype(np.uint32))))
        np.testing.assert_array_equal(got, want.astype(np.int64))
    for g in (5, 25, 2 * n - 1):
        np.testing.assert_array_equal(port_ntt.automorphism_perm(n, g),
                                      ref_ntt.automorphism_perm(n, g))
    a = _residues(pctx.primes, (n,))
    np.testing.assert_array_equal(port_ntt.coeff_automorphism_np(a, 5),
                                  ref_ntt.coeff_automorphism_np(a, 5))
    np.testing.assert_array_equal(port_ntt.bitrev_indices(64),
                                  ref_ntt.bitrev_indices(64))


def test_wrapper_rejects_cpu_tensor():
    pctx = port_ntt.NttContext.build(128, find_ntt_primes(128, 2),
                                     device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ntt_cuda.ntt_fwd(pctx, torch.zeros(2, 128, dtype=torch.int64))


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    for n in (128, 1024, 8192):
        pctx = port_ntt.NttContext.build(n, find_ntt_primes(n, 4),
                                         device="cuda")
        x = torch.as_tensor(_residues(pctx.primes, (5, 4, n)), device="cuda")
        y = pctx.ntt(x)
        assert torch.equal(y, pctx.ntt_plain(x))
        assert torch.equal(pctx.intt(y), pctx.intt_plain(y))
        assert torch.equal(pctx.intt(y), x)
        xs = x[:, [0, 3]].contiguous()
        assert torch.equal(pctx.ntt(xs, (0, 3)), pctx.ntt_plain(xs, (0, 3)))
