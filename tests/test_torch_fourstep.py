"""The port's four-step NTT against the JAX package's, bitwise: the
mont_mul-tree `FourStepNtt.ntt` and its Stockham-order view, the limb
contractions `ntt_mxu_b` / `intt_mxu_b` (the plain versions of the CUDA
kernels fourstep_fwd / fourstep_inv), the Pallas four-step kernel in
interpret mode, the round trip and `FourStepBackend.autoperm`, at n=256
with splits (16, 16) and (8, 32) and at n=1024 with the backend's default
split, on rows (0, 1, 2) and (for the limb contractions) the (0, 2)
subset.  The plain versions repeat the kernels' arithmetic (8-bit limbs,
7 shift groups, one REDC); the worst-case test holds their shift-group
sums below 2^31 on inputs all p - 1, and the epilogue and the kernels'
limb-plane layout are checked on their own.  The CUDA kernels against the
plain versions run in the `cuda`-marked test (and in chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_spear_tpu.core import ntt as ref_ntt
from fhe_spear_tpu.core.fourstep_pallas import ntt_fourstep_pallas
from fhe_spear_tpu.core.primes import find_ntt_primes as ref_primes
from fhe_spear_tpu.parallel import ntt_fourstep as ref_fs
from fhe_spear_tpu_torch.core import fourstep_cuda
from fhe_spear_tpu_torch.core import ntt as port_ntt
from fhe_spear_tpu_torch.core.primes import find_ntt_primes
from fhe_spear_tpu_torch.parallel import ntt_fourstep as port_fs
from fhe_spear_tpu_torch.parallel.ntt_fourstep import FourStepBackend, \
    FourStepNtt


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small-ring torch ops gain nothing from intra-op threads, and under a
    parallel test run the threads of several workers oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


L = 3


def _contexts(n):
    return (port_ntt.NttContext.build(n, find_ntt_primes(n, L), device="cpu"),
            ref_ntt.NttContext.build(n, ref_primes(n, L)))


def _residues(primes, rows, shape, seed=0):
    """Canonical residues [R, *shape] (row r mod primes[rows[r]])."""
    rng = np.random.default_rng(seed)
    p = np.array([primes[r].p for r in rows], dtype=np.int64)
    return rng.integers(0, p.reshape((-1,) + (1,) * len(shape)),
                        size=(len(rows),) + shape, dtype=np.int64)


def _u32(x):
    return jnp.asarray(np.asarray(x).astype(np.uint32))


def _words(x):
    return np.asarray(x).astype(np.int64)


def _ref(fn, x, rows):
    """Words of the reference's fn(x, rows), traced under one jit (called
    eagerly, its first call compiles every primitive apart: ~10 s on the
    CPU for one transform)."""
    return _words(jax.jit(lambda v: fn(v, rows))(_u32(x)))


@pytest.mark.parametrize("n,n1", [(256, 16), (256, 8), (1024, None)])
@pytest.mark.parametrize("rows", [(0, 1, 2), (0, 2)])
def test_fourstep_bitwise_against_reference(n, n1, rows):
    pctx, rctx = _contexts(n)
    backend = FourStepBackend(pctx, n1)
    fs = backend.fs
    if n1 is None:             # the backend's default split rule
        assert (fs.n1, fs.n2) == (16, 64)
    rfs = ref_fs.FourStepNtt(rctx, fs.n1, fs.n2)
    x = _residues(pctx.primes, rows, (2, n), seed=n + len(rows))  # [R, B, N]

    got = fs.ntt_mxu_b(torch.as_tensor(x), rows).numpy()
    np.testing.assert_array_equal(got, _ref(rfs.ntt_mxu_b, x, rows))
    back = fs.intt_mxu_b(torch.as_tensor(got), rows).numpy()
    np.testing.assert_array_equal(back, _ref(rfs.intt_mxu_b, got, rows))
    np.testing.assert_array_equal(back, x)

    if len(rows) < L:
        return                  # the tree form is held on all rows below
    x0 = x[:, 0]                                                  # [R, N]
    tree = fs.ntt(torch.as_tensor(x0), rows).numpy()
    np.testing.assert_array_equal(tree, _ref(rfs.ntt, x0, rows))
    np.testing.assert_array_equal(tree, got[:, 0])
    stock = fs.ntt_stockham_order(torch.as_tensor(x0), rows).numpy()
    np.testing.assert_array_equal(
        stock, _ref(rfs.ntt_stockham_order, x0, rows))
    # the order contract: four-step bin bitrev(b) is Stockham bin b
    np.testing.assert_array_equal(
        stock, pctx.ntt(torch.as_tensor(x0), rows).numpy())


@pytest.mark.parametrize("n,n1", [(1024, None), (256, 8)])
def test_worst_case_shift_groups_stay_below_2_31(n, n1, monkeypatch):
    """Inputs all p - 1 (on every limb, the largest prime of
    find_ntt_primes(n, L) among them): every shift-group partial sum of
    both stages stays below 2^31 (and below the 2^25 the kernel's note
    claims), and the outputs equal the reference bit for bit."""
    pctx, rctx = _contexts(n)
    fs = FourStepBackend(pctx, n1).fs
    assert (fs.n1, fs.n2) == ((16, 64) if n1 is None else (8, 32))
    rfs = ref_fs.FourStepNtt(rctx, fs.n1, fs.n2)
    rows = tuple(range(L))
    assert max(pr.p for pr in pctx.primes) in [pctx.primes[r].p
                                                for r in rows]
    p = np.array([pctx.primes[r].p for r in rows], dtype=np.int64)
    x = np.broadcast_to((p - 1)[:, None, None], (L, 2, n)).copy()

    peak = []
    groups = port_fs.shift_groups

    def recording(a8, xx):
        T = groups(a8, xx)
        peak.append(int(T.max()))
        return T

    monkeypatch.setattr(port_fs, "shift_groups", recording)
    got = fs.ntt_mxu_b(torch.as_tensor(x), rows).numpy()
    back = fs.intt_mxu_b(torch.as_tensor(x), rows).numpy()
    assert len(peak) == 4                  # two stages in each direction
    assert max(peak) < 2 ** 25 < 2 ** 31, peak
    np.testing.assert_array_equal(got, _ref(rfs.ntt_mxu_b, x, rows))
    np.testing.assert_array_equal(back, _ref(rfs.intt_mxu_b, x, rows))
    # the analytic worst case at K = 128: every limb 255, 4 pairs a group
    a8 = torch.full((1, 4, 16, 128), 255, dtype=torch.uint8)
    T = groups(a8, torch.full((1, 128, 8), 2 ** 32 - 1, dtype=torch.int64))
    assert int(T.max()) == 4 * 128 * 255 ** 2 < 2 ** 25


def test_fold_reduce_is_exact_at_the_bounds():
    """The kernels' epilogue against Python integers: shift groups at
    their largest value (4 * 128 * 255^2) and at random values, on each
    prime: (sum_s T_s 2^(8s)) * 2^-32 mod p, canonical."""
    pctx, _ = _contexts(1024)
    fs = FourStepNtt(pctx, 16, 64)
    rng = np.random.default_rng(11)
    top = 4 * 128 * 255 ** 2
    T = rng.integers(0, top + 1, size=(L, 7, 3, 5), dtype=np.int64)
    T[:, :, 0, 0] = top
    T[:, :, 0, 1] = 0
    T[:, :, 1, 0] = np.arange(7) * 1000 + 1
    got = port_fs.fold_reduce(torch.as_tensor(T), pctx.p[:, :, None],
                              pctx.pinv[:, :, None],
                              fs.dsh[:, :, None, None]).numpy()
    for li, pr in enumerate(pctx.primes):
        rinv = pow(1 << 32, -1, pr.p)
        for m in range(3):
            for j in range(5):
                v = sum(int(T[li, s, m, j]) << (8 * s) for s in range(7))
                assert got[li, m, j] == v * rinv % pr.p


def test_limb_image_layout():
    """The kernels' shared-memory image of a DFT matrix: 4 byte planes,
    rows padded to 16, k to 32 plus 16 bytes, padding zero, and the limbs
    recombine to the Montgomery words."""
    pctx, _ = _contexts(256)
    for n1, n2 in ((16, 16), (8, 32)):
        fs = FourStepNtt(pctx, n1, n2)
        for w8, w in ((fs.w1_8, fs.w1), (fs.w2_8, fs.w2), (fs.w1i_8, fs.w1i)):
            m, k = w.shape[-2:]
            img = fourstep_cuda.limb_image(w8)
            assert img.dtype == torch.uint8
            assert img.shape == (L, 4, max(16, m), max(32, k) + 16)
            assert (img.shape[-1] // 16) % 2 == 1      # 16 x an odd stride
            words = sum(img[:, a, :m, :k].to(torch.int64) << (8 * a)
                        for a in range(4))
            assert torch.equal(words, w)
            pad = img.clone()
            pad[:, :, :m, :k] = 0
            assert int(pad.abs().sum()) == 0


def test_fourstep_matches_pallas_kernel():
    """The plain version equals the Pallas kernel (interpret mode, f32 limb
    dots) on its Mosaic-compatible "2dio" variant; tests/test_ntt_fourstep.py
    holds all three variants equal to the reference's ntt_mxu_b."""
    pctx, rctx = _contexts(256)
    fs = FourStepNtt(pctx, 16, 16)
    rfs = ref_fs.FourStepNtt(rctx, 16, 16)
    rows = (0, 1, 2)
    x = _residues(pctx.primes, rows, (2, 256), seed=42)
    pallas = ntt_fourstep_pallas(rfs, _u32(x), rows, dot_impl="f32",
                                 interpret=True, variant="2dio")
    np.testing.assert_array_equal(fs.ntt_mxu_b(torch.as_tensor(x),
                                               rows).numpy(), _words(pallas))


def test_backend_round_trip_and_autoperm():
    pctx, rctx = _contexts(256)
    backend = FourStepBackend(pctx)
    rback = ref_fs.FourStepBackend(rctx)
    assert backend.order == "natural"
    assert backend.p is pctx.p          # other attributes delegate
    rows = (0, 2)
    x = torch.as_tensor(_residues(pctx.primes, rows, (4, 256), seed=3)
                        ).transpose(0, 1).contiguous()            # [4, R, N]
    y = backend.ntt(x, rows)                         # [..., R, N] layout
    np.testing.assert_array_equal(
        y.numpy(), _ref(rback.ntt, x.numpy(), rows))
    assert torch.equal(backend.intt(y, rows), x)
    for g in (5, 25, 2 * 256 - 1):
        np.testing.assert_array_equal(backend.autoperm(g), rback.autoperm(g))


def test_wrapper_rejects_cpu_tensor():
    pctx, _ = _contexts(256)
    fs = FourStepNtt(pctx, 16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fourstep_cuda.fourstep_fwd(fs, torch.zeros(3, 256, dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA"):
        fourstep_cuda.fourstep_inv(fs, torch.zeros(3, 256, dtype=torch.int64))
    # a split the kernel cannot take (n1 < 8) raises before any build
    with pytest.raises(ValueError, match="split"):
        fourstep_cuda.plan(FourStepNtt(pctx, 4, 64), (3, 256))


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    for n in (256, 8192, 16384):
        pctx = port_ntt.NttContext.build(n, find_ntt_primes(n, 4),
                                         device="cuda")
        backend = FourStepBackend(pctx)
        rows = (0, 3)
        x = torch.as_tensor(
            np.moveaxis(_residues(pctx.primes, rows, (5, n)), 0, 1).copy(),
            device="cuda")                                    # [B, R, N]
        y = backend.ntt(x, rows)
        assert torch.equal(y, backend.ntt_plain(x, rows))
        assert torch.equal(backend.intt(y, rows), backend.intt_plain(y, rows))
        assert torch.equal(backend.intt(y, rows), x)
        assert torch.equal(y.index_select(-1, backend.fs.to_stockham),
                           pctx.ntt(x, rows))
