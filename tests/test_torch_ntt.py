"""The port's NTT/iNTT against the JAX package's, bitwise: the plain torch
version (what a CPU tensor runs) against both `NttContext.ntt/intt` and
the Pallas kernels `ntt_pallas/intt_pallas` in interpret mode, at
n in {128, 256, 1024}, R=3, B=4, the rows=(0, 2) subset at l=4, the round
trip and `automorphism_perm`; the fused `ntt_to_mont` / `intt_from_mont`
(both backends) against the reference's composed calls; the folded twist
tables; and a torch replay of the CUDA kernels' pass structure (the
schedule, twiddle indices and Shoup products of `core/ntt_cuda.py`, on
the kernels' own tables) against the plain version at n up to 8192.  The
CUDA kernels against the plain version run in the `cuda`-marked test (and
in chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_spear_tpu.core import ntt as ref_ntt
from fhe_spear_tpu.core.ntt_pallas import intt_pallas, ntt_pallas
from fhe_spear_tpu.core.primes import find_ntt_primes as ref_primes
from fhe_spear_tpu.parallel import ntt_fourstep as ref_fs
from fhe_spear_tpu_torch.core import ntt as port_ntt
from fhe_spear_tpu_torch.core import ntt_cuda
from fhe_spear_tpu_torch.core.modops import MASK32, cond_sub, mont_mul, \
    mul_hi_u32, sub_mod
from fhe_spear_tpu_torch.core.primes import find_ntt_primes
from fhe_spear_tpu_torch.parallel.ntt_fourstep import FourStepBackend


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small-ring torch ops gain nothing from intra-op threads, and under a
    parallel test run the threads of several workers oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    want = np.asarray(jax.jit(rctx.ntt)(jnp.asarray(x.astype(np.uint32))))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    # the Pallas kernel takes [R, B, N]
    pallas = np.asarray(ntt_pallas(rctx, jnp.asarray(
        x.transpose(1, 0, 2).astype(np.uint32)), interpret=True))
    np.testing.assert_array_equal(got, pallas.transpose(1, 0, 2))

    back = pctx.intt(torch.as_tensor(got)).numpy()
    np.testing.assert_array_equal(back, x)
    want_i = np.asarray(jax.jit(rctx.intt)(jnp.asarray(
        got.astype(np.uint32))))
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
    want = np.asarray(jax.jit(lambda v: rctx.ntt(v, rows))(
        jnp.asarray(x.astype(np.uint32))))
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
        want = np.asarray(jax.jit(getattr(rctx, fn))(
            jnp.asarray(x.astype(np.uint32))))
        np.testing.assert_array_equal(got, want.astype(np.int64))
    for g in (5, 25, 2 * n - 1):
        np.testing.assert_array_equal(port_ntt.automorphism_perm(n, g),
                                      ref_ntt.automorphism_perm(n, g))
    a = _residues(pctx.primes, (n,))
    np.testing.assert_array_equal(port_ntt.coeff_automorphism_np(a, 5),
                                  ref_ntt.coeff_automorphism_np(a, 5))
    np.testing.assert_array_equal(port_ntt.bitrev_indices(64),
                                  ref_ntt.bitrev_indices(64))


@pytest.mark.parametrize("n", [128, 1024])
def test_fused_conversions_against_reference(n):
    l, rows = 3, (0, 2)
    pctx = port_ntt.NttContext.build(n, find_ntt_primes(n, l), device="cpu")
    rctx = ref_ntt.NttContext.build(n, ref_primes(n, l))
    x = _residues(pctx.primes, (2, l, n), seed=n)[:, list(rows)]
    xr = jnp.asarray(x.astype(np.uint32))
    got = pctx.ntt_to_mont(torch.as_tensor(x), rows).numpy()
    want = np.asarray(jax.jit(
        lambda v: rctx.to_mont(rctx.ntt(v, rows), rows))(xr))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    got_i = pctx.intt_from_mont(torch.as_tensor(x), rows).numpy()
    want_i = np.asarray(jax.jit(
        lambda v: rctx.from_mont(rctx.intt(v, rows), rows))(xr))
    np.testing.assert_array_equal(got_i, want_i.astype(np.int64))


def test_fused_conversions_fourstep_against_reference():
    n, l, rows = 256, 3, (0, 2)
    pctx = port_ntt.NttContext.build(n, find_ntt_primes(n, l), device="cpu")
    rctx = ref_ntt.NttContext.build(n, ref_primes(n, l))
    backend, rback = FourStepBackend(pctx), ref_fs.FourStepBackend(rctx)
    x = _residues(pctx.primes, (3, l, n), seed=7)[:, list(rows)]
    xr = jnp.asarray(x.astype(np.uint32))
    got = backend.ntt_to_mont(torch.as_tensor(x), rows).numpy()
    want = np.asarray(jax.jit(
        lambda v: rctx.to_mont(rback.ntt(v, rows), rows))(xr))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    got_i = backend.intt_from_mont(torch.as_tensor(x), rows).numpy()
    want_i = np.asarray(jax.jit(
        lambda v: rctx.from_mont(rback.intt(v, rows), rows))(xr))
    np.testing.assert_array_equal(got_i, want_i.astype(np.int64))


def test_folded_tables():
    """The folded Montgomery-form tables carry the conversion, and the
    kernels' Shoup pairs of every twist table give mont_mul's words."""
    n, l = 256, 3
    pctx = port_ntt.NttContext.build(n, find_ntt_primes(n, l), device="cpu")
    folded = pctx.folded_tables()
    p, pinv = pctx.p, pctx.pinv
    x = torch.as_tensor(_residues(pctx.primes, (l, n), seed=5))
    assert torch.equal(mont_mul(x, folded["psi_to_mont"], p, pinv),
                       pctx.to_mont(mont_mul(x, pctx.psi, p, pinv)))
    assert torch.equal(
        mont_mul(x, folded["psi_inv_n_from_mont"], p, pinv),
        pctx.from_mont(mont_mul(x, pctx.psi_inv_n, p, pinv)))
    tb = ntt_cuda._tables(pctx, torch.device("cpu"))
    for name, table in (("twist", pctx.psi),
                        ("twist_mont", folded["psi_to_mont"]),
                        ("untwist", pctx.psi_inv_n),
                        ("untwist_plain", folded["psi_inv_n_from_mont"])):
        pairs = tb[name].to(torch.int64) & MASK32
        assert pairs.shape == (l, n, 2)
        assert torch.equal(_shoup(x, pairs, p), mont_mul(x, table, p, pinv))
        # the bound the kernels rely on: any a < 2^32 lands in [0, 2p)
        a = torch.full_like(x, MASK32)
        q = mul_hi_u32(a, pairs[..., 1])
        assert bool(((a * pairs[..., 0] - q * p) < 2 * p).all())


def _deposit(v, bits):
    """Spread bit k of v onto bit bits[k]."""
    out = 0
    for k, b in enumerate(bits):
        out = out | (((v >> k) & 1) << b)
    return out


def _shoup(a, pairs, p):
    """The kernels' product of a (< 2^32) by the constant with Shoup pair
    (c, c'): a*c - floor(a*c' / 2^32)*p, in [0, 2p), then one conditional
    subtraction."""
    c, cp = pairs[..., 0], pairs[..., 1]
    return cond_sub(a * c - mul_hi_u32(a, cp) * p, p)


def _replay(ctx, x, rows, forward, fold=False):
    """csrc/ntt.cu's K1 (forward) or K2 on x [B, R, N], pass by pass: the
    words of thread u's register r at index deposit(u, thr) |
    deposit(r, reg), the stages of each pass on them (forward top bit
    first), twiddles at `twiddle_index` of the kernels' tables."""
    n = ctx.n
    tb = ntt_cuda._tables(ctx, torch.device("cpu"))
    sel = torch.as_tensor(rows)
    p = ctx.p[sel][:, :, None]                          # [R, 1, 1]

    def pairs(name):
        return tb[name].to(torch.int64)[sel] & MASK32   # [R, N, 2]

    tw = pairs("fwd_tw" if forward else "inv_tw")
    twist = pairs(("twist_mont" if fold else "twist") if forward else
                  ("untwist_plain" if fold else "untwist"))
    sched = ntt_cuda.schedule(ctx.logn)
    passes = sched if forward else sched[::-1]
    s = x.clone()                                       # shared memory
    for j, ps in enumerate(passes):
        e, t = len(ps["reg"]), len(ps["thr"])
        idx = (_deposit(torch.arange(1 << t)[:, None], ps["thr"])
               | _deposit(torch.arange(1 << e)[None, :], ps["reg"]))
        v = s[..., idx]                                 # [B, R, T, E]
        if forward and j == 0:
            v = _shoup(v, twist[:, idx], p)
        bits = (range(ps["hi"], ps["lo"] - 1, -1) if forward
                else range(ps["lo"], ps["hi"] + 1))
        for h in bits:
            rho = ps["reg"].index(h)
            lo = [r for r in range(1 << e) if not r >> rho & 1]
            hi = [r | 1 << rho for r in lo]
            w = tw[:, ntt_cuda.twiddle_index(n, h, idx[:, lo])]
            a, b = v[..., lo], v[..., hi]
            if forward:
                v[..., lo], v[..., hi] = (cond_sub(a + b, p),
                                          _shoup(a - b + p, w, p))
            else:
                tt = _shoup(b, w, p)
                v[..., lo], v[..., hi] = cond_sub(a + tt, p), sub_mod(a, tt, p)
        if not forward and j == len(passes) - 1:
            v = _shoup(v, twist[:, idx], p)
        s[..., idx] = v
    return s


@pytest.mark.parametrize("n", [128, 1024, 8192])
def test_kernel_replay_equals_plain(n):
    l, rows = 4, (0, 3)
    ctx = port_ntt.NttContext.build(n, find_ntt_primes(n, l), device="cpu")
    x = torch.as_tensor(
        _residues(ctx.primes, (2, l, n), seed=n)[:, list(rows)])
    y = ctx.ntt_plain(x, rows)
    assert torch.equal(_replay(ctx, x, rows, True), y)
    assert torch.equal(_replay(ctx, y, rows, False), ctx.intt_plain(y, rows))
    assert torch.equal(_replay(ctx, x, rows, True, fold=True),
                       ctx.to_mont(y, rows))
    assert torch.equal(_replay(ctx, y, rows, False, fold=True),
                       ctx.from_mont(x, rows))


def test_schedule_layouts():
    """Every pass runs stages only on its register bits, the passes cover
    each index bit once, pass A holds bit 0 in register bit 0 (16-byte
    pairs), and from N = 1024 a warp's 32 lanes vary 5 consecutive index
    bits within 0..9: distinct banks under the i + i/32 padding."""
    for logn in range(1, 15):
        sched = ntt_cuda.schedule(logn)
        stages = []
        for ps in sched:
            assert sorted(ps["reg"] + ps["thr"]) == list(range(logn))
            assert len(ps["reg"]) == min(5, logn)
            assert set(range(ps["lo"], ps["hi"] + 1)) <= set(ps["reg"])
            stages += range(ps["lo"], ps["hi"] + 1)
            if logn >= 10:
                lanes = ps["thr"][:5]
                assert lanes == list(range(lanes[0], lanes[0] + 5))
                assert lanes[-1] <= 9
                banks = {(1 << b if b < 5 else 1 << (b - 5)) for b in lanes}
                assert len(banks) == 5
        assert sorted(stages) == list(range(logn))
        assert sched[0]["reg"][0] == 0
        assert sched[0]["hi"] == logn - 1


def test_wrapper_rejects_cpu_tensor():
    pctx = port_ntt.NttContext.build(128, find_ntt_primes(128, 2),
                                     device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ntt_cuda.ntt_fwd(pctx, torch.zeros(2, 128, dtype=torch.int64))


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    for n in (128, 1024, 8192, 16384):
        pctx = port_ntt.NttContext.build(n, find_ntt_primes(n, 4),
                                         device="cuda")
        x = torch.as_tensor(_residues(pctx.primes, (5, 4, n)), device="cuda")
        y = pctx.ntt(x)
        assert torch.equal(y, pctx.ntt_plain(x))
        assert torch.equal(pctx.intt(y), pctx.intt_plain(y))
        assert torch.equal(pctx.intt(y), x)
        xs = x[:, [0, 3]].contiguous()
        assert torch.equal(pctx.ntt(xs, (0, 3)), pctx.ntt_plain(xs, (0, 3)))
        assert torch.equal(pctx.ntt_to_mont(xs, (0, 3)),
                           pctx.to_mont(pctx.ntt_plain(xs, (0, 3)), (0, 3)))
        assert torch.equal(pctx.intt_from_mont(y),
                           pctx.from_mont(pctx.intt_plain(y)))
