"""The BSGS baby-step contraction kernel (`ops/bsgs_cuda.bsgs_contract`,
csrc/bsgs.cu) against its plain version, the torch tree
`ops/bsgs.contract_plain`.

On the CPU: `BsgsMatvec.contract` on CPU tensors gives the words of an
independent modular sum; a torch replay of the kernel's arithmetic (lazy
Montgomery terms in [0, 2p), exact 64-bit sums split over S warps, one
`%`) gives the plain tree's words; the wrapper raises on what the kernel
does not take before it builds or launches anything; the split of the b
loop at the main path's shapes.

On the card (marked `cuda`, skipped without one): the kernel's words
equal the plain tree's at G = 46 and 32, l = 3 and 11, C = 1 and 8, N =
8192, at one `DiagonalMatvec` shape at N = 16384 and across the launches
of a C > 8 call; a graph-captured `bsgs_kernel` projection replays the
eager words, which equal the plain tree's matvec, and `BSGS_CONTRACT`
counts the capture's and the replays' launches.

The file imports no jax, so the card tests run on the card machine
without the repository's conftest: `python -m pytest --noconftest -p
no:cacheprovider -m cuda tests/test_torch_bsgs_cuda.py`.
"""

import numpy as np
import pytest
import torch

from fhe_spear_tpu_torch.core.modops import MASK32, mul_lo_u32
from fhe_spear_tpu_torch.core.primes import find_ntt_primes
from fhe_spear_tpu_torch.ops import bsgs_cuda
from fhe_spear_tpu_torch.ops.bsgs import (BsgsMatvec, bsgs_kernel,
                                          contract_plain)
from fhe_spear_tpu_torch.ops.bsgs_cuda import (BSGS_CONTRACT, bsgs_contract,
                                               split)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _limbs(n, l):
    """p, pinv [l, 1] int64 of l NTT primes for ring size n."""
    primes = find_ntt_primes(n, l)
    col = lambda v: torch.tensor(v, dtype=torch.int64)[:, None]
    return col([q.p for q in primes]), col([q.mont_pinv for q in primes])


def _residues(shape, p, seed, device="cpu"):
    """Uniform residues below each limb's p, [..., l, N] int64."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 1 << 62, shape, generator=g, dtype=torch.int64)
    return (x % p).to(device)


# -- on the CPU ---------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_engine():
    from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams

    ctx = CkksContext(CkksParams(n=64, num_limbs=3, num_special=1), seed=5,
                      device="cpu")
    return BsgsMatvec(ctx, 16)


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
def test_contract_cpu_words(cpu_engine, lead):
    """contract on CPU tensors: sum_b a*b*2^-32 mod p, computed here with
    Python integers, for a single group, a chunk and two leading axes."""
    eng = cpu_engine
    ctx, G, l, n = eng.ctx, eng.G, 3, eng.ctx.n
    p, _ = ctx._p(l)
    babies = _residues((G, 2, l, n), p, 1)
    ptg = _residues(lead + (G, l, n), p, 2)
    got = eng.contract(babies, ptg, l)
    assert got.shape == lead + (2, l, n) and got.dtype == torch.int64

    a = babies.numpy().astype(object)
    w = ptg.numpy().astype(object)
    ps = [int(v) for v in p[:, 0]]
    rinv = np.array([pow(1 << 32, -1, q) for q in ps], dtype=object)
    prod = a * w[..., :, None, :, :] * rinv[:, None]      # [.., G, 2, l, N]
    want = prod.sum(axis=-4) % np.array(ps, dtype=object)[:, None]
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _replay(babies, pt, p, pinv, S):
    """The kernel's arithmetic in torch: each term the Montgomery product
    before its conditional subtraction (a 32-bit m = lo * pinv, the high
    word of m * p, the carry lo != 0), b split over S warps as b = s, s +
    S, ..., each warp's terms and then the S partial sums added exactly,
    one `%` at the end."""
    parts = []
    for s in range(S):
        acc = torch.zeros(pt.shape[:-3] + (2,) + pt.shape[-2:],
                          dtype=torch.int64)
        for b in range(s, babies.shape[0], S):
            t = babies[b] * pt[..., b, None, :, :]
            lo = t & MASK32
            m = mul_lo_u32(lo, pinv)
            term = (t >> 32) + ((m * p) >> 32) + (lo != 0).long()
            assert int(term.max()) < 2 * int(p.max())
            acc = acc + term
        parts.append(acc)
    return sum(parts) % p


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_kernel_arithmetic_replay(S):
    """The lazy terms and the split sums give the plain tree's words at
    G = 46, C = 8 (the main path's chunk), l = 3 (n = 32: the arithmetic,
    not the size, is under test)."""
    n, l, G = 32, 3, 46
    p, pinv = _limbs(n, l)
    babies = _residues((G, 2, l, n), p, 3)
    pt = _residues((8, G, l, n), p, 4)
    assert 2 * G * int(p.max()) < 1 << 63       # the 64-bit sums are exact
    want = contract_plain(babies, pt, p, pinv)
    assert torch.equal(_replay(babies, pt, p, pinv, S), want)


def test_wrapper_raises_without_card():
    """Wrong dtype, non-contiguous or mis-shaped input, and a CPU tensor,
    raise before the wrapper builds or launches anything."""
    n, l, G = 32, 3, 4
    p, pinv = _limbs(n, l)
    babies = _residues((G, 2, l, n), p, 5)
    pt = _residues((2, G, l, n), p, 6)
    built = bsgs_cuda.LIBRARY.lib
    before = BSGS_CONTRACT.launches
    with pytest.raises(TypeError, match="int64"):
        bsgs_contract(babies.to(torch.int32), pt, p, pinv)
    with pytest.raises(TypeError, match="int64"):
        bsgs_contract(babies, pt.to(torch.int32), p, pinv)
    with pytest.raises(ValueError, match="contiguous"):
        bsgs_contract(babies, pt.transpose(-1, -2).contiguous()
                      .transpose(-1, -2), p, pinv)
    with pytest.raises(ValueError, match="contiguous"):
        bsgs_contract(babies.transpose(2, 3), pt, p, pinv)
    with pytest.raises(ValueError, match=r"\[\.\.\., 4, 3, 32\]"):
        bsgs_contract(babies, pt[:, :3].contiguous(), p, pinv)
    with pytest.raises(ValueError, match="limbs"):
        bsgs_contract(babies, pt, p[:2], pinv[:2])
    with pytest.raises(ValueError, match="CUDA"):
        bsgs_contract(babies, pt, p, pinv)
    assert bsgs_cuda.LIBRARY.lib is built
    assert BSGS_CONTRACT.launches == before


def test_split_at_main_path_shapes():
    """S at the main path's shapes on 132 SMs (H100 SXM), and S a power of
    two no larger than 8 or G everywhere."""
    assert split(46, 3, 8192, 132) == 8          # D=2048, l=3: 384 warps
    assert split(32, 3, 8192, 132) == 8          # D=1024
    assert split(46, 11, 8192, 132) == 2         # the chain at 11 limbs
    assert split(6, 45, 16384, 132) == 1         # a bootstrap stage
    assert split(3, 3, 8192, 132) == 2           # S <= G
    for G in (1, 2, 3, 5, 8, 46):
        for l in (1, 3, 11):
            s = split(G, l, 8192, 132)
            assert s & (s - 1) == 0 and 1 <= s <= min(8, G)


# -- on the card --------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("G,l,lead,n", [
    (46, 3, (), 8192), (46, 3, (8,), 8192), (46, 11, (8,), 8192),
    (46, 11, (), 8192), (32, 3, (8,), 8192), (32, 3, (), 8192),
    (32, 11, (8,), 8192),
    (6, 45, (5,), 16384),            # a DiagonalMatvec stage at N=16384
    (46, 3, (13,), 8192),            # two launches: 8 + 5 groups
    (46, 3, (2, 3), 8192),           # leading axes
])
def test_kernel_words(card, G, l, lead, n):
    p, pinv = _limbs(n, l)
    babies = _residues((G, 2, l, n), p, G + l, card)
    pt = _residues(lead + (G, l, n), p, 7 * l + n, card)
    p, pinv = p.to(card), pinv.to(card)
    before = BSGS_CONTRACT.launches
    got = bsgs_contract(babies, pt, p, pinv)
    torch.cuda.synchronize()
    C = int(np.prod(lead)) if lead else 1
    assert BSGS_CONTRACT.launches - before == -(-C // bsgs_cuda.MAX_C)
    assert got.shape == lead + (2, l, n)
    assert torch.equal(got, contract_plain(babies, pt, p, pinv))


@pytest.mark.cuda
def test_graph_replays_eager_words_and_counts(card, monkeypatch):
    from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams
    from fhe_spear_tpu_torch.ops.graphed import ProjectionGraphs

    ctx = CkksContext(CkksParams(8192, 3, 1), seed=3, device="cuda")
    eng = BsgsMatvec(ctx, 256)                  # G = 16, B = 16
    rng = np.random.RandomState(4)
    w = rng.uniform(-1, 1, (256, 256)) / 16
    pt = torch.as_tensor(eng.encode(w).coeffs, device=card)
    kern_b = bsgs_kernel(eng, 3, "single")
    kern = lambda cs: kern_b(cs, pt)
    p = ctx.ntt.p[:3].cpu()
    # a matvec: C = 1 for group 0, then the 15 giant groups in chunks of 8
    per_matvec = {(1, 3, 8192): 1, (8, 3, 8192): 1, (7, 3, 8192): 1}
    S = 2
    graphs = ProjectionGraphs(ctx)
    assert graphs.engaged
    for call in range(4):                       # eager, capture, replay x 2
        c = _residues((S, 2, 3, 8192), p, 100 + call, card)
        want = torch.stack([kern(cs) for cs in c])
        before = dict(BSGS_CONTRACT.by_shape)
        got = graphs("proj", 0, kern, c)
        torch.cuda.synchronize()
        delta = {k: v - before.get(k, 0)
                 for k, v in BSGS_CONTRACT.by_shape.items()
                 if v - before.get(k, 0)}
        assert delta == {k: S * v for k, v in per_matvec.items()}, call
        assert torch.equal(got, want), call

    # the same matvec with the plain tree in place of the kernel
    with monkeypatch.context() as m:
        m.setattr(eng, "contract", lambda babies, ptg, l: contract_plain(
            babies, ptg, *ctx._p(l)))
        plain = torch.stack([kern(cs) for cs in c])
    assert torch.equal(plain, want)
