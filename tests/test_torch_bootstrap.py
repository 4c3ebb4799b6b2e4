"""The port's CKKS bootstrap against the JAX package's.

Word for word, on one module-scoped pair of contexts (n=256, L=20, K=2,
h=16, seed 81) after the same `Bootstrapper(radix=3)` construction: the
sparse secret and every key, the identity key that the last SlotToCoeff
group needs (at this ring its giant step is 0 mod slots, Galois element
1, as at N=16384 with radix 4), that group's `DiagonalMatvec` output,
`mod_raise`, and one width-1 `eval_chebyshev` at degree 7.

Held to the reference tests' bars, at their settings (n=128, L=20, K=2,
h=16, seed 81), on the port alone (a second reference run of a refresh
would cost minutes of XLA compiles): the dense and
factorized CoeffToSlot/SlotToCoeff, `_eval_exp`, the width-1 refresh
(dense and factorized), the width-2 refresh, the 9-block chain with a
refresh, and the exact-scale pre-encoded chain through a refresh (the
reference's own test of that path fails: its `run_fully_encrypted`
shadows `os`)."""

import numpy as np
import pytest
import torch

from fhe_spear_tpu.ckks import CkksContext as RefContext
from fhe_spear_tpu.ckks import CkksParams as RefParams
from fhe_spear_tpu.ckks.bootstrap import Bootstrapper as RefBootstrapper
from fhe_spear_tpu.ops import polyeval as ref_pe
from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams
from fhe_spear_tpu_torch.ckks.bootstrap import Bootstrapper
from fhe_spear_tpu_torch.ckks.dft import bitrev
from fhe_spear_tpu_torch.ops import polyeval as pe

PARAMS = dict(n=256, num_limbs=20, num_special=2, secret_hamming_weight=16)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small-ring torch ops gain nothing from intra-op threads, and under a
    parallel test run the threads of several workers oversubscribe the
    cores (one chain here took 179 s with 8 threads, 8.6 s with 1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def words(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x).astype(np.int64)


def assert_key_equal(rk, pk):
    np.testing.assert_array_equal(words(rk.b), words(pk.b))
    np.testing.assert_array_equal(words(rk.a), words(pk.a))


@pytest.fixture(scope="module")
def pair():
    """(reference, port) contexts replaying seed 81 and their factorized
    bootstrappers; every test draws the same encryptions from both."""
    ref = RefContext(RefParams(**PARAMS), seed=81)
    port = CkksContext(CkksParams(**PARAMS), seed=81, device="cpu")
    return (ref, port, RefBootstrapper(ref, exp_degree=23, radix=3),
            Bootstrapper(port, exp_degree=23, radix=3))


@pytest.fixture(scope="module")
def port_bt():
    """A port-only context at the reference tests' fixture (n=128) with its
    dense and factorized bootstrappers."""
    ctx = CkksContext(CkksParams(**dict(PARAMS, n=128)), seed=81,
                      device="cpu")
    return (ctx, Bootstrapper(ctx, exp_degree=23, radix=None),
            Bootstrapper(ctx, exp_degree=23, radix=3))


def rand_msg(ctx, seed, mag=0.8):
    return np.random.default_rng(seed).uniform(-mag, mag, ctx.slots)


def test_keys_and_identity_group_word_for_word(pair):
    ref, port, rb, pb = pair
    np.testing.assert_array_equal(ref._sk_coeff, port._sk_coeff)
    assert np.count_nonzero(port._sk_coeff) == 16
    assert_key_equal(ref.relin_key, port.relin_key)
    assert sorted(ref.galois_keys) == sorted(port.galois_keys)
    for g in ref.galois_keys:
        assert_key_equal(ref.galois_keys[g], port.galois_keys[g])
    grp, rgrp = pb._s2c_f[-1], rb._s2c_f[-1]
    assert grp.eng.giant_steps == rgrp.eng.giant_steps == (-port.slots,)
    assert 1 in grp.eng.galois_elements()
    m = rand_msg(port, 1)
    rct, pct = ref.encrypt(m), port.encrypt(m)
    np.testing.assert_array_equal(words(rct.c), words(pct.c))
    rout, pout = rgrp(rct), grp(pct)
    assert (pout.level, pout.scale) == (rout.level, rout.scale)
    np.testing.assert_array_equal(words(rout.c), words(pout.c))
    assert_key_equal(ref.identity_ksk(), port.identity_ksk())
    # the identity key is made once, from the draws at that moment
    assert port.identity_ksk() is port.identity_ksk()


def test_mod_raise_word_for_word(pair):
    ref, port, rb, pb = pair
    m = rand_msg(port, 2)
    rct = ref.mod_switch_to(ref.encrypt(m, scale=rb.delta_d), 1)
    pct = port.mod_switch_to(port.encrypt(m, scale=pb.delta_d), 1)
    raised = pb.mod_raise(pct)
    assert raised.level == port.L
    np.testing.assert_array_equal(words(rb.mod_raise(rct).c),
                                  words(raised.c))
    # decrypts to v + q0*I with a small integer I (the reference's bar)
    want = port.encoder.encode(np.asarray(m, complex), pb.delta_d)
    q0 = int(port.q_np[0])
    ints = (port.decrypt_to_coeffs(raised) - want) / q0
    np.testing.assert_allclose(ints, np.round(ints), atol=1e-3)
    assert np.abs(ints).max() <= pb.K
    assert port.decrypt_slot0(pct) == pytest.approx(m[0], abs=1e-3)


def test_eval_chebyshev_word_for_word(pair):
    ref, port, _, _ = pair
    m = rand_msg(port, 3)
    coeffs = pe.chebyshev_fit(np.cos, -1.0, 1.0, 7)
    np.testing.assert_array_equal(coeffs,
                                  ref_pe.chebyshev_fit(np.cos, -1.0, 1.0, 7))
    rout = ref_pe.eval_chebyshev(ref, ref.encrypt(m), coeffs, -1.0, 1.0)
    pout = pe.eval_chebyshev(port, port.encrypt(m), coeffs, -1.0, 1.0)
    assert (pout.level, pout.scale) == (rout.level, rout.scale)
    np.testing.assert_array_equal(words(rout.c), words(pout.c))
    np.testing.assert_allclose(port.decrypt_vec(pout), np.cos(m), atol=1e-4)
    # an odd series of degree 7 uses T_3 in the quotient; the reference
    # starts one level too high for it and fails, the port starts lower
    odd = pe.chebyshev_fit(np.sin, -1.0, 1.0, 7)
    with pytest.raises(AssertionError):
        ref_pe.eval_chebyshev(ref, ref.encrypt(m), odd, -1.0, 1.0)
    out = pe.eval_chebyshev(port, port.encrypt(m), odd, -1.0, 1.0)
    np.testing.assert_allclose(port.decrypt_vec(out), np.sin(m), atol=1e-4)


def test_c2s_extracts_coefficients(port_bt):
    ctx, bt, _ = port_bt
    m = rand_msg(ctx, 4)
    got = ctx.decrypt_vec_complex(bt._pair_matvec(bt._c2s, ctx.encrypt(m)))
    coeffs = ctx.encoder.encode(np.asarray(m, complex), ctx.scale) / ctx.scale
    s = ctx.slots
    np.testing.assert_allclose(got, coeffs[:s] + 1j * coeffs[s:], atol=1e-3)


def test_s2c_inverts_c2s(port_bt):
    ctx, bt, btf = port_bt
    m = rand_msg(ctx, 5)
    w = bt._pair_matvec(bt._c2s, ctx.encrypt(m))
    back = bt._pair_matvec(bt._s2c, w)
    np.testing.assert_allclose(ctx.decrypt_vec(back), m, atol=1e-2)
    back_f = btf._slot_to_coeff(btf._coeff_to_slot(ctx.encrypt(m)))
    np.testing.assert_allclose(ctx.decrypt_vec(back_f), m, atol=1e-2)


def test_c2s_factorized_matches_dense(port_bt):
    """Factorized CoeffToSlot = dense CoeffToSlot up to the dropped
    bit-reversal permutation."""
    ctx, bt, btf = port_bt
    m = rand_msg(ctx, 6)
    ct = ctx.encrypt(m)
    dense = ctx.decrypt_vec_complex(bt._pair_matvec(bt._c2s, ct))
    fact = ctx.decrypt_vec_complex(btf._coeff_to_slot(ct))
    br = bitrev(ctx.slots.bit_length() - 1)
    np.testing.assert_allclose(fact, dense[br], atol=2e-3)


def test_eval_exp(port_bt):
    ctx, bt, _ = port_bt
    lim = bt.exp_range[1]
    t = np.random.default_rng(7).uniform(-0.7 * lim, 0.7 * lim, ctx.slots)
    # slot magnitudes ~lim exceed the encoder's coefficient bound: encrypt
    # scaled down and multiply back up homomorphically
    up = 2048.0
    ct = ctx.rescale(ctx.mul_scalar(ctx.encrypt(t / up), up))
    got = ctx.decrypt_vec_complex(bt._eval_exp(ct))
    want = np.exp(2j * np.pi * t * bt.delta_d / bt.q0)
    np.testing.assert_allclose(got, want, atol=5e-3)


@pytest.mark.parametrize("mode", ["dense", "factorized"])
def test_full_bootstrap(port_bt, mode):
    ctx, bt, btf = port_bt
    m = rand_msg(ctx, 8)
    out = (bt if mode == "dense" else btf).bootstrap(
        ctx.mod_switch_to(ctx.encrypt(m), 2))
    assert out.level >= 3, out.level
    got = ctx.decrypt_vec(out)
    assert np.abs(got - m).max() < 0.05
    assert np.corrcoef(got, m)[0, 1] > 0.999


def test_full_bootstrap_wide():
    """Width-2 EvalMod + wide CoeffToSlot, the production-ring refresh."""
    ctx = CkksContext(CkksParams(n=128, num_limbs=34, num_special=4,
                                 secret_hamming_weight=16, dnum=12),
                      seed=82, device="cpu")
    bt = Bootstrapper(ctx, exp_degree=23, radix=3, evalmod_width=2)
    m = np.random.default_rng(9).uniform(-0.8, 0.8, ctx.slots)
    out = bt.bootstrap(ctx.mod_switch_to(ctx.encrypt(m), 2))
    assert out.level >= 3, out.level
    assert out.scale == ctx.scale
    got = ctx.decrypt_vec(out)
    assert np.abs(got - m).max() < 5e-4
    assert np.corrcoef(got, m)[0, 1] > 0.9999999


def _chain_setup(seed):
    ctx = CkksContext(CkksParams(n=128, num_limbs=26, num_special=2,
                                 secret_hamming_weight=16), seed=82,
                      device="cpu")
    bt = Bootstrapper(ctx, exp_degree=23)
    rng = np.random.default_rng(seed)
    d, f, nb = 16, 32, 9
    wk = [rng.normal(0, 0.1, (d, f)) for _ in range(nb)]
    wv = [rng.normal(0, 0.1, (f, d)) for _ in range(nb)]
    return ctx, bt, wk, wv, rng.normal(0, 0.3, d)


def test_fully_encrypted_chain_with_bootstrap():
    """26 limbs run 8 blocks (3 levels each), a refresh lands at ~8
    limbs, then the ninth block runs."""
    from fhe_spear_tpu_torch.models.fully_encrypted import run_fully_encrypted

    ctx, bt, wk, wv, x0 = _chain_setup(9)
    stats = run_fully_encrypted(ctx, wk, wv, x0, bootstrap_fn=bt.bootstrap,
                                min_levels=4, verbose=False)
    assert len(stats) == 9, [s["block"] for s in stats]
    assert stats[-1]["bootstraps"] >= 1
    for s in stats:
        assert s["corr"] > 0.98, stats


def test_bootstrapped_exact_scale_chain(tmp_path):
    """Exact scale management through a refresh: blocks pre-encoded at
    per-level prime scales, the refresh normalized exactly to ctx.scale;
    a wrong refresh-level guess is re-encoded and persisted, so a second
    pass loads every block from the cache."""
    from fhe_spear_tpu_torch.models.fully_encrypted import (
        FullyEncryptedFfn, calibrate_magnitude, fe_level_schedule,
        pre_encode_blocks, run_fully_encrypted)

    ctx, bt, wk, wv, x0 = _chain_setup(10)
    wk, wv = calibrate_magnitude(wk, wv, x0)
    eng = FullyEncryptedFfn(ctx, 16, 32)
    levels = fe_level_schedule(ctx.L, 9, boot_level=8)
    cache = str(tmp_path)
    hosts = pre_encode_blocks(eng, wk, wv, cache_dir=cache, levels=levels)
    msgs = []
    stats = run_fully_encrypted(
        ctx, wk, wv, x0, bootstrap_fn=bt.bootstrap, pre_encoded=hosts,
        eng=eng, calibrated=True, verbose=False, cache_dir=cache,
        log_fn=msgs.append)
    assert len(stats) == 9, [s["block"] for s in stats]
    assert stats[-1]["bootstraps"] >= 1
    assert any("re-encode" in m for m in msgs), msgs
    for s in stats:
        assert s["corr"] > (0.999999 if s["bootstraps"] == 0 else 0.98), stats
    msgs.clear()
    stats2 = run_fully_encrypted(
        ctx, wk, wv, x0, bootstrap_fn=bt.bootstrap, pre_encoded=hosts,
        eng=eng, calibrated=True, verbose=False, cache_dir=cache,
        log_fn=msgs.append)
    assert len(stats2) == 9
    assert not any("re-encode" in m for m in msgs), msgs
