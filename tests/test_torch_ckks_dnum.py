"""The port's dnum-grouped hybrid keyswitch against the JAX package's, word
for word, at n=256, L=11, K=3, dnum=4 (four digits of up to 3 limbs, the
last one ragged): digit grouping, relin and Galois keys (the batched
ensure_galois draw included), `_digit_tables`, `_fbc_digits`, and
multiply + relin + rescale and a rotation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_spear_tpu.ckks import CkksContext as RefContext
from fhe_spear_tpu.ckks import CkksParams as RefParams
from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small-ring torch ops gain nothing from intra-op threads, and under a
    parallel test run the threads of several workers oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PARAMS = dict(n=256, num_limbs=11, num_special=3, dnum=4)
STEPS = (1, 3, 7)


def words(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x).astype(np.int64)


@pytest.fixture(scope="module")
def pair():
    ref = RefContext(RefParams(**PARAMS), seed=53)
    port = CkksContext(CkksParams(**PARAMS), seed=53, device="cpu")
    for c in (ref, port):
        c.ensure_galois(STEPS, conj=True)
    return ref, port


def test_digit_grouping(pair):
    ref, port = pair
    assert (port.gsize, port.dnum) == (ref.gsize, ref.dnum) == (3, 4)
    np.testing.assert_array_equal(port.digit_of_limb, ref.digit_of_limb)
    assert [port.num_digits(l) for l in range(1, 12)] == \
        [ref.num_digits(l) for l in range(1, 12)]
    with pytest.raises(AssertionError, match="exceeds P"):
        CkksContext(CkksParams(n=256, num_limbs=11, num_special=1, dnum=2),
                    seed=0, device="cpu")


def test_keys_word_for_word(pair):
    ref, port = pair
    np.testing.assert_array_equal(words(ref.relin_key.b),
                                  words(port.relin_key.b))
    np.testing.assert_array_equal(words(ref.relin_key.a),
                                  words(port.relin_key.a))
    assert port.relin_key.b.shape == (4, 14, 256)
    assert sorted(ref.galois_keys) == sorted(port.galois_keys)
    for g, k in ref.galois_keys.items():
        np.testing.assert_array_equal(words(k.b), words(port.galois_keys[g].b))
        np.testing.assert_array_equal(words(k.a), words(port.galois_keys[g].a))


def test_digit_tables_and_fbc(pair):
    ref, port = pair
    for l in (11, 5, 1):
        rt, pt = ref._digit_tables(l), port._digit_tables(l)
        assert set(rt) == set(pt)
        for k in rt:
            want = np.asarray(rt[k]).astype(np.int64)
            np.testing.assert_array_equal(want.reshape(words(pt[k]).shape),
                                          words(pt[k]), err_msg=k)
    # level 11: the last group holds 2 limbs and a zero-padded member
    q = ref.q_np[:11].astype(np.int64)
    c = np.random.RandomState(11).randint(0, q[:, None], (2, 11, 256))
    want = jax.jit(lambda v: ref._fbc_digits(v, 11))(
        jnp.asarray(c.astype(np.uint32)))
    got = port._fbc_digits(torch.as_tensor(c), 11)
    np.testing.assert_array_equal(words(want), words(got))


def test_keyswitch_ops_word_for_word(pair):
    ref, port = pair
    rng = np.random.RandomState(4)
    m1, m2 = rng.uniform(-1, 1, (2, 128))
    (r1, r2), (p1, p2) = [(c.encrypt(m1), c.encrypt(m2)) for c in pair]
    np.testing.assert_array_equal(words(r1.c), words(p1.c))
    # level 11: four digits, the last of 2 limbs padded to 3
    rm, pm = ref.rescale(ref.multiply(r1, r2)), port.rescale(
        port.multiply(p1, p2))
    assert rm.scale == pm.scale
    np.testing.assert_array_equal(words(rm.c), words(pm.c))
    np.testing.assert_allclose(port.decrypt_vec(pm), m1 * m2, atol=1e-3)
    rr, pr = ref.rotate(r1, 3), port.rotate(p1, 3)
    np.testing.assert_array_equal(words(rr.c), words(pr.c))
    np.testing.assert_allclose(port.decrypt_vec(pr), np.roll(m1, -3),
                               atol=1e-3)
    x = port.mod_switch_to(p1, 5)          # two digits, the second ragged
    np.testing.assert_array_equal(words(port.square(x).c),
                                  words(port.multiply(x, x).c))
    np.testing.assert_allclose(port.decrypt_vec(port.square(x)), m1 * m1,
                               atol=1e-3)


def test_encode_const_scale_to_and_drop(pair):
    ref, port = pair
    for c, lv, sc in ((0.75 - 0.25j, 11, None), (1.5, 4, 2.0 ** 56)):
        np.testing.assert_array_equal(
            words(ref.encode_const(c, lv, sc).p),
            words(port.encode_const(c, lv, sc).p))
    # a context of its own: these draw randomness and drop keys
    small = CkksContext(CkksParams(n=128, num_limbs=4, num_special=2,
                                   dnum=2), seed=3, device="cpu")
    small.ensure_galois(STEPS, conj=True)
    m = np.random.RandomState(8).uniform(-1, 1, 64)
    ct = small.encrypt(m)
    odd = small.mul_scalar(ct, 1.0, scale=float(2 ** 20))
    out = small.scale_to(odd, exact=True)
    assert out.scale == small.scale and out.level == ct.level - 2
    np.testing.assert_allclose(small.decrypt_vec(out), m, atol=1e-3)
    assert small.set_scale(ct, 3.0).scale == 3.0
    g = sorted(small.galois_keys)
    assert small.drop_galois_keys(drop=g[:1]) == 1
    assert small.drop_galois_keys() == len(g) - 2      # conjugation stays
    assert list(small.galois_keys) == [2 * small.n - 1]
    small.ensure_galois(STEPS)                          # regenerated
    np.testing.assert_allclose(small.decrypt_vec(small.rotate(ct, 1)),
                               np.roll(m, -1), atol=1e-3)
