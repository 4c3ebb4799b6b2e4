"""The port's CkksContext on the four-step ("mxu") NTT backend against the
JAX package's mxu context, word for word.  Kept apart from
test_torch_ckks.py because the reference's eager four-step transforms take
most of a minute on the CPU."""

import numpy as np
import pytest
import torch

from fhe_spear_tpu.ckks import CkksContext as RefContext
from fhe_spear_tpu.ckks import CkksParams as RefParams
from fhe_spear_tpu.ops.bsgs import BsgsMatvec as RefBsgs
from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams
from fhe_spear_tpu_torch.ops.bsgs import BsgsMatvec


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small-ring torch ops gain nothing from intra-op threads, and under a
    parallel test run the threads of several workers oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def words(x):
    """int64 words of a reference uint32 array or a port int64 tensor."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x).astype(np.int64)


def assert_keys_equal(ref, port):
    np.testing.assert_array_equal(words(ref.s_eval), words(port.s_eval))
    for name in ("b", "a"):
        np.testing.assert_array_equal(words(getattr(ref.relin_key, name)),
                                      words(getattr(port.relin_key, name)))
    assert sorted(ref.galois_keys) == sorted(port.galois_keys)
    for g, k in ref.galois_keys.items():
        np.testing.assert_array_equal(words(k.b), words(port.galois_keys[g].b))
        np.testing.assert_array_equal(words(k.a), words(port.galois_keys[g].a))


def test_mxu_context_bitwise():
    """An mxu (four-step, natural order) context against the reference's
    mxu context at the reference's own test setting
    (tests/test_ntt_fourstep.py: n=256, L=4, K=1, seed 5): relin and
    Galois keys, encrypt, rotate, conjugate, multiply + relin, rescale and
    a BSGS matvec (d=16), word for word."""
    params = dict(n=256, num_limbs=4, num_special=1, ntt_backend="mxu")
    ref = RefContext(RefParams(**params), seed=5)
    port = CkksContext(CkksParams(**params), seed=5, device="cpu")
    for c in (ref, port):
        c.ensure_galois([5], conj=True)
    assert_keys_equal(ref, port)
    rng = np.random.default_rng(3)
    v, w = rng.normal(0, 0.5, (2, 128))
    (rv, rw), (pv, pw) = [(c.encrypt(v), c.encrypt(w)) for c in (ref, port)]
    np.testing.assert_array_equal(words(rv.c), words(pv.c))
    np.testing.assert_array_equal(words(ref.rotate(rv, 5).c),
                                  words(port.rotate(pv, 5).c))
    np.testing.assert_array_equal(words(ref.conjugate(rv).c),
                                  words(port.conjugate(pv).c))
    rm, pm = ref.multiply(rv, rw), port.multiply(pv, pw)
    np.testing.assert_array_equal(words(rm.c), words(pm.c))
    np.testing.assert_array_equal(words(ref.rescale(rm).c),
                                  words(port.rescale(pm).c))
    np.testing.assert_allclose(port.decrypt_vec(port.rescale(pm)), v * w,
                               atol=1e-3)

    d = 16
    reng, peng = RefBsgs(ref, d), BsgsMatvec(port, d)
    W = rng.normal(0, 0.4, (d, d))
    x = rng.normal(0, 0.7, d)
    rx, px = ref.encrypt_replicated(x), port.encrypt_replicated(x)
    ry = reng(rx, reng.load(reng.encode(W), ref.L))
    py = peng(px, peng.load(peng.encode(W), port.L))
    np.testing.assert_array_equal(words(ry.c), words(py.c))
    np.testing.assert_allclose(port.decrypt_vec(py, d), W @ x, atol=5e-3)
