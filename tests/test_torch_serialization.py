"""The port's checkpoints against the JAX package's, in one on-disk format.

`set_secret_key` keys word for word; ciphertext, secret-key and state
round trips; files written by either package load in the other -- a BSGS
matvec on the other package's eval keys gives that package's output words;
the key epoch (an engine built before `load_eval_keys` evaluates with the
loaded keys); and the bin-order tag refusing a cross-backend load.  One
reference matvec runs (n=256, L=4, K=1, d=16), on a reference server that
loaded the port owner's keys; the bundle the reference writes back is the
one the port's server loads."""

import numpy as np
import pytest
import torch

from fhe_spear_tpu.ckks import CkksContext as RefContext
from fhe_spear_tpu.ckks import CkksParams as RefParams
from fhe_spear_tpu.models.rwkv7 import make_random_model as ref_model
from fhe_spear_tpu.ops.bsgs import BsgsMatvec as RefMatvec
from fhe_spear_tpu.utils import serialization as ref_ser
from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams
from fhe_spear_tpu_torch.models.rwkv7 import make_random_model
from fhe_spear_tpu_torch.ops.bsgs import BsgsMatvec, bsgs_kernel
from fhe_spear_tpu_torch.utils import serialization as ser

PARAMS = dict(n=256, num_limbs=4, num_special=1)
D = 16


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
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x).astype(np.int64)


def port_ctx(seed):
    return CkksContext(CkksParams(**PARAMS), seed=seed, device="cpu")


@pytest.fixture(scope="module")
def owner():
    """The port's key owner (seed 94), its engine, weights, one ciphertext
    and the matvec output."""
    ctx = port_ctx(94)
    eng = BsgsMatvec(ctx, D)
    rng = np.random.default_rng(6)
    w = rng.normal(0, 0.3, (D, D))
    x = rng.normal(0, 1, D)
    enc = eng.encode(w)
    ct = ctx.encrypt_replicated(x)
    return ctx, eng, w, x, enc, ct, eng(ct, eng.load(enc, ct.level))


@pytest.fixture(scope="module")
def ref_server():
    """A reference context (seed 5): the port's twin replays its
    `set_secret_key`, and it serves as the reference's evaluation server
    for the port owner's keys (loading keys draws nothing from its
    generator)."""
    return RefContext(RefParams(**PARAMS), seed=5)


def test_set_secret_key_word_for_word(ref_server):
    ref, port = ref_server, port_ctx(5)
    sk = np.random.RandomState(9).randint(-1, 2, PARAMS["n"])
    epoch = port.key_epoch
    ref.set_secret_key(sk)
    port.set_secret_key(sk)
    assert port.key_epoch == epoch + 1 and not port.galois_keys
    assert not hasattr(port, "_identity_ksk")
    np.testing.assert_array_equal(words(ref.s_eval), words(port.s_eval))
    for k in ("b", "a"):
        np.testing.assert_array_equal(words(getattr(ref.relin_key, k)),
                                      words(getattr(port.relin_key, k)))
    ref.ensure_galois([1, 3])
    port.ensure_galois([1, 3])
    assert sorted(ref.galois_keys) == sorted(port.galois_keys)
    for g in ref.galois_keys:
        np.testing.assert_array_equal(words(ref.galois_keys[g].a),
                                      words(port.galois_keys[g].a))
        np.testing.assert_array_equal(words(ref.galois_keys[g].b),
                                      words(port.galois_keys[g].b))
    with pytest.raises(ValueError):
        port.set_secret_key(sk[:-1])


def test_round_trips(owner, tmp_path):
    ctx, _, _, x, _, ct, _ = owner
    p = str(tmp_path / "ct.npz")
    ser.save_ciphertext(p, ct, ctx)
    back = ser.load_ciphertext(p, ctx)
    assert back.c.dtype == torch.int64 and back.scale == ct.scale
    assert torch.equal(back.c, ct.c)
    z = np.load(p)
    assert z["c"].dtype == np.uint32 and bytes(z["order"]) == b"stockham"

    sp = str(tmp_path / "sk.npz")
    ser.save_secret_key(sp, ctx)
    fresh = ser.load_secret_key(sp, CkksParams(**PARAMS), device="cpu")
    np.testing.assert_allclose(fresh.decrypt_vec(ct, D), x, atol=1e-4)
    other = port_ctx(7)
    ser.load_secret_key_into(sp, other)
    np.testing.assert_array_equal(words(other.s_eval), words(ctx.s_eval))
    np.testing.assert_allclose(other.decrypt_vec(back, D), x, atol=1e-4)

    m = make_random_model(d=16, f=32, n_blocks=2, head_size=8, seed=1)
    st = m.zero_state()
    st.wkv[0] += 1.5
    st.x_prev_ffn[1] -= 0.25
    gp = str(tmp_path / "state.npz")
    ser.save_generation_state(gp, st, [1, 2, 3])
    st2, toks = ser.load_generation_state(gp)
    assert toks == [1, 2, 3]
    for a, b in zip(st.wkv + st.x_prev_att + st.x_prev_ffn,
                    st2.wkv + st2.x_prev_att + st2.x_prev_ffn):
        np.testing.assert_array_equal(a, b)
    # the reference's state file loads in the port
    rst = ref_model(d=16, f=32, n_blocks=2, head_size=8, seed=1).zero_state()
    rst.wkv[1] += 0.5
    ref_ser.save_generation_state(gp, rst, [4])
    st3, toks3 = ser.load_generation_state(gp)
    assert toks3 == [4]
    np.testing.assert_array_equal(st3.wkv[1], rst.wkv[1])


def test_eval_keys_cross_package(owner, ref_server, tmp_path):
    ctx, eng, w, x, enc, ct, out = owner
    kp, cp = str(tmp_path / "port_keys.npz"), str(tmp_path / "port_ct.npz")
    ser.save_eval_keys(kp, ctx)
    ser.save_ciphertext(cp, ct, ctx)

    # the reference's server on the port's keys and ciphertext gives the
    # port owner's words; the port loads the reference's output file
    ref_ser.load_eval_keys(kp, ref_server)
    reng = RefMatvec(ref_server, D)
    rct = ref_ser.load_ciphertext(cp, ref_server)
    rout = reng(rct, reng.load(reng.encode(w), rct.level))
    np.testing.assert_array_equal(words(rout.c), words(out.c))
    assert rout.scale == out.scale
    rop = str(tmp_path / "ref_out.npz")
    ref_ser.save_ciphertext(rop, rout, ref_server)
    back = ser.load_ciphertext(rop, ctx)
    assert torch.equal(back.c, out.c) and back.scale == out.scale

    # the reference writes the bundle it loaded; a port server loads the
    # reference's file and gives the reference server's words
    rkp = str(tmp_path / "ref_keys.npz")
    ref_ser.save_eval_keys(rkp, ref_server)
    a, b = np.load(kp), np.load(rkp)
    assert sorted(a.files) == sorted(b.files)
    for f in a.files:
        assert a[f].dtype == b[f].dtype
        np.testing.assert_array_equal(a[f], b[f])
    server = port_ctx(4321)
    ser.load_eval_keys(rkp, server)
    peng = BsgsMatvec(server, D)                 # keys present, none made
    pout = peng(ct, peng.load(enc, ct.level))
    np.testing.assert_array_equal(words(pout.c), words(rout.c))
    # only the owner decrypts
    np.testing.assert_allclose(ctx.decrypt_vec(pout, D), w @ x, atol=1e-3)
    assert np.abs(server.decrypt_vec(pout, D) - w @ x).max() > 1.0


def test_key_epoch_rebuilds_stale_stacks(owner, tmp_path):
    ctx, _, w, x, enc, ct, out = owner
    kp = str(tmp_path / "keys.npz")
    ser.save_eval_keys(kp, ctx)
    server = port_ctx(555)
    eng = BsgsMatvec(server, D)                  # the server's own keys
    pt = eng.load(enc, ct.level)
    stale = eng(ct, pt)                          # stacks built now
    kern = bsgs_kernel(eng, ct.level, "single")  # keys selected now
    assert not torch.equal(stale.c, out.c)
    ser.load_eval_keys(kp, server)
    assert server.key_epoch == 1
    got = eng(ct, pt)
    assert torch.equal(got.c, out.c)
    # a kernel built before the load re-selects its level's keys
    assert torch.equal(kern(ct.c, pt), out.c)
    # below the top level the selected keys follow the epoch as well
    lower = server.mod_switch_to(ct, 3)
    want = BsgsMatvec(ctx, D)(ctx.mod_switch_to(ct, 3), eng.load(enc, 3))
    assert torch.equal(eng(lower, eng.load(enc, 3)).c, want.c)
    # a new secret clears the Galois keys; the engine regenerates them
    server.set_secret_key(ctx._sk_coeff)
    got2 = eng(ct, eng.load(enc, ct.level))
    np.testing.assert_allclose(server.decrypt_vec(got2, D), w @ x,
                               atol=1e-3)


def test_order_tag_refuses_cross_backend(owner, tmp_path):
    ctx, _, _, _, _, ct, _ = owner
    mxu = CkksContext(CkksParams(**PARAMS, ntt_backend="mxu"), seed=94,
                      device="cpu")
    cp, kp = str(tmp_path / "ct.npz"), str(tmp_path / "keys.npz")
    ser.save_ciphertext(cp, ct, ctx)
    ser.save_eval_keys(kp, mxu)
    with pytest.raises(ValueError, match="order"):
        ser.load_ciphertext(cp, mxu)
    with pytest.raises(ValueError, match="order"):
        ser.load_eval_keys(kp, ctx)
    with pytest.raises(ValueError, match="params"):
        ser.load_eval_keys(kp, CkksContext(CkksParams(n=256, num_limbs=3),
                                           seed=1, device="cpu"))
    ser.save_ciphertext(cp, mxu.encrypt(np.ones(4)), mxu)
    assert bytes(np.load(cp)["order"]) == b"natural"
