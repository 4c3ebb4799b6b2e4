"""The port's CkksContext against the JAX package's, bitwise, at n=256:
keys (secret, relin, >16 Galois elements so the chunk-of-16 draw order is
exercised), explicit encryption with host randomness, rotate,
hoisted_rotations, multiply + relin and rescale.  The four-step ("mxu")
backend's words are held in tests/test_torch_ckks_mxu.py."""

import numpy as np
import pytest
import torch

from fhe_spear_tpu.ckks import CkksContext as RefContext
from fhe_spear_tpu.ckks import CkksParams as RefParams
from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams
from fhe_spear_tpu_torch.convert import context_from_secret


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small-ring torch ops gain nothing from intra-op threads, and under a
    parallel test run the threads of several workers oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 256
STEPS = tuple(range(1, 18))      # 17 rotation elements + conjugation = 18


def words(x):
    """int64 words of a reference uint32 array or a port int64 tensor."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x).astype(np.int64)


def assert_keys_equal(ref, port):
    np.testing.assert_array_equal(words(ref.s_eval), words(port.s_eval))
    np.testing.assert_array_equal(words(ref.relin_key.b),
                                  words(port.relin_key.b))
    np.testing.assert_array_equal(words(ref.relin_key.a),
                                  words(port.relin_key.a))
    assert sorted(ref.galois_keys) == sorted(port.galois_keys)
    for g, k in ref.galois_keys.items():
        np.testing.assert_array_equal(words(k.b), words(port.galois_keys[g].b))
        np.testing.assert_array_equal(words(k.a), words(port.galois_keys[g].a))


@pytest.fixture(scope="module")
def pair():
    """(reference, port) contexts replaying the same seed, with keys."""
    ref = RefContext(RefParams(n=N, num_limbs=3, num_special=1), seed=31)
    port = CkksContext(CkksParams(n=N, num_limbs=3, num_special=1), seed=31,
                       device="cpu")
    for c in (ref, port):
        c.ensure_galois(STEPS, conj=True)
    return ref, port


def test_keys_replayed_seed(pair):
    ref, port = pair
    assert len(ref.galois_keys) == 18
    np.testing.assert_array_equal(ref._sk_coeff, port._sk_coeff)
    assert_keys_equal(ref, port)


def test_keys_from_secret():
    sk = np.random.RandomState(5).randint(-1, 2, N).astype(np.int64)
    params = dict(n=N, num_limbs=3, num_special=2)
    ref = RefContext(RefParams(**params), seed=9, sk_coeff=sk)
    port = context_from_secret(CkksParams(**params), sk, seed=9, device="cpu")
    for c in (ref, port):
        c.ensure_galois((1, 2, 5))
    assert_keys_equal(ref, port)
    # K=2: the centered CRT mod-down of the keyswitch, word for word
    m = np.random.RandomState(6).uniform(-1, 1, N // 2)
    rct, pct = ref.encrypt(m), port.encrypt(m)
    np.testing.assert_array_equal(words(ref.rotate(rct, 2).c),
                                  words(port.rotate(pct, 2).c))
    np.testing.assert_array_equal(words(ref.multiply(rct, rct).c),
                                  words(port.multiply(pct, pct).c))


def test_encrypt_ops_bitwise(pair):
    ref, port = pair
    rng = np.random.RandomState(0)
    m1, m2 = rng.uniform(-1, 1, (2, ref.slots))
    cts = []
    for c in (ref, port):
        # interleave nothing: both draw encryption noise from their own rng,
        # which sit at the same position after identical keygen
        cts.append((c.encrypt(m1), c.encrypt(m2)))
    (r1, r2), (p1, p2) = cts
    np.testing.assert_array_equal(words(r1.c), words(p1.c))
    np.testing.assert_array_equal(words(r2.c), words(p2.c))

    np.testing.assert_array_equal(words(ref.rotate(r1, 3).c),
                                  words(port.rotate(p1, 3).c))
    np.testing.assert_array_equal(words(ref.conjugate(r1).c),
                                  words(port.conjugate(p1).c))
    steps = (0, 1, 5, 17)
    for a, b in zip(ref.hoisted_rotations(r1, steps),
                    port.hoisted_rotations(p1, steps)):
        np.testing.assert_array_equal(words(a.c), words(b.c))
    rm, pm = ref.multiply(r1, r2), port.multiply(p1, p2)
    np.testing.assert_array_equal(words(rm.c), words(pm.c))
    rr, pr = ref.rescale(rm), port.rescale(pm)
    assert rr.scale == pr.scale
    np.testing.assert_array_equal(words(rr.c), words(pr.c))
    np.testing.assert_allclose(port.decrypt_vec(pr), m1 * m2, atol=1e-4)
    np.testing.assert_array_equal(ref.decrypt_to_coeffs(rr),
                                  port.decrypt_to_coeffs(pr))


def test_plain_and_scalar_ops(pair):
    ref, port = pair
    rng = np.random.RandomState(1)
    m, w = rng.uniform(-1, 1, (2, ref.slots))
    ct = port.encrypt(m)
    pt = port.encode(w)
    np.testing.assert_allclose(
        port.decrypt_vec(port.rescale(port.mul_plain(ct, pt))), m * w,
        atol=1e-4)
    np.testing.assert_allclose(
        port.decrypt_vec(port.add_plain(ct, pt)), m + w, atol=1e-4)
    np.testing.assert_allclose(
        port.decrypt_vec(port.rescale(port.mul_scalar(ct, 0.5))), m * 0.5,
        atol=1e-4)
    np.testing.assert_allclose(
        port.decrypt_vec(port.sub(port.add(ct, ct), port.negate(ct))), 3 * m,
        atol=1e-4)
    assert port.mod_switch_to(ct, 2).level == 2
    # the same plaintext encodes to the same words in both packages
    np.testing.assert_array_equal(words(ref.encode(w).p), words(pt.p))


def test_params_and_backends():
    p = CkksParams.client_aided()
    assert p.log_qp == 31 + 2 * 28 + 31
    assert p.security_statement().startswith("standard-128")
    assert CkksParams.deep(8192, 58).security_statement().startswith(
        "research-grade")
    # the four-step backend: natural bin order, the same keys in the
    # coefficient domain (the secret key's coefficients)
    m = CkksContext(CkksParams(n=128, num_limbs=2, ntt_backend="mxu"),
                    seed=0, device="cpu")
    assert m.ntt.order == "natural"
    s = CkksContext(CkksParams(n=128, num_limbs=2), seed=0, device="cpu")
    np.testing.assert_array_equal(m._sk_coeff, s._sk_coeff)
    v = np.random.RandomState(2).uniform(-1, 1, 64)
    np.testing.assert_allclose(m.decrypt_vec(m.encrypt(v)), v, atol=1e-4)
    with pytest.raises(ValueError):
        CkksContext(CkksParams(n=128, num_limbs=2, ntt_backend="fft"),
                    seed=0, device="cpu")
    a = CkksContext(CkksParams(n=128, num_limbs=2, ntt_backend="pallas"),
                    seed=3, device="cpu")
    b = CkksContext(CkksParams(n=128, num_limbs=2), seed=3, device="cpu")
    np.testing.assert_array_equal(words(a.relin_key.b), words(b.relin_key.b))


def test_cuda_default_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        CkksContext(CkksParams(n=128, num_limbs=2), seed=0)
