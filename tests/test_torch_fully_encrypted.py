"""The port's fully-encrypted FFN against the JAX package's, on the
reference's deep-chain test context (n=256, L=11, K=3, dnum=4: grouped
keyswitch digits) at d=16, f=64, with one pair of contexts for the module:

  * calibrate_magnitude and fe_level_schedule equal the reference's;
  * one width-1 block equals the reference's `FullyEncryptedFfn.__call__`
    word for word on int32 staging, the port's only one: any other
    `stage_mode` raises;
  * `encode_wide`/`rns_expand_wide` and one width-2 block (`_call_wide`)
    equal the reference's word for word;
  * `FullyEncryptedTimeMix` equals the reference's word for word;
  * the port's pre-encoded `run_fully_encrypted` (the path the reference's
    shadowed `os` breaks) holds the plaintext oracle at the reference's
    bars, and a mis-levelled pre-encode corrects itself;
  * generate_fully_encrypted_token gives the reference's token.

Most of the module's time is the reference's XLA compiles, ~20-25 s for
each of its three blocks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_spear_tpu.ckks import CkksContext as RefContext
from fhe_spear_tpu.ckks import CkksParams as RefParams
from fhe_spear_tpu.models import fully_encrypted as ref_fe
from fhe_spear_tpu.ops.bsgs import BsgsMatvec as RefMatvec
from fhe_spear_tpu.ops.bsgs import rns_expand_wide as ref_expand_wide
from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams
from fhe_spear_tpu_torch.models import fully_encrypted as fe
from fhe_spear_tpu_torch.ops.bsgs import BsgsMatvec, rns_expand_wide


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
D, F, NB = 16, 64, 3


def words(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x).astype(np.int64)


@pytest.fixture(scope="module")
def chain():
    """(reference, port) contexts replaying seed 53, and the calibrated
    weights of the reference's deep-chain test.  Every test draws the same
    keys and encryptions from both contexts, in the same order."""
    ref = RefContext(RefParams(**PARAMS), seed=53)
    port = CkksContext(CkksParams(**PARAMS), seed=53, device="cpu")
    rng = np.random.default_rng(17)
    wk = [rng.normal(0, 0.02, (D, F)) for _ in range(NB)]
    wv = [rng.normal(0, 0.02, (F, D)) for _ in range(NB)]
    x0 = rng.normal(0, 0.1, D)
    wk_c, wv_c = fe.calibrate_magnitude(wk, wv, x0)
    return ref, port, wk, wv, wk_c, wv_c, x0


def test_calibration_and_schedule(chain):
    wk, wv, x0 = chain[2], chain[3], chain[6]
    for mag in (1.0, 4.0):
        got = fe.calibrate_magnitude(wk, wv, x0, target_mag=mag)
        want = ref_fe.calibrate_magnitude(wk, wv, x0, target_mag=mag)
        for g, w in zip(got[0] + got[1], want[0] + want[1]):
            np.testing.assert_array_equal(g, w)
    for args in ((11, 3, None, None, 1), (59, 19, None, None, 1),
                 (46, 24, None, 9, 1), (15, 2, None, None, 2),
                 (20, 5, 6, 14, 1)):
        assert fe.fe_level_schedule(*args) == ref_fe.fe_level_schedule(*args)
    assert fe.fe_level_schedule(11, 3) == [11, 8, 5]


def test_block_word_for_word(chain):
    ref, port, _, _, wk_c, wv_c, x0 = chain
    reng = ref_fe.FullyEncryptedFfn(ref, D, F, stage_mode="i32")
    eng = fe.FullyEncryptedFfn(port, D, F)
    rct, pct = ref.encrypt_replicated(x0), port.encrypt_replicated(x0)
    rhost = reng.encode_block(wk_c[0], wv_c[0], level=11)
    phost = eng.encode_block(wk_c[0], wv_c[0], level=11)
    for k in ("key", "val"):
        np.testing.assert_array_equal(rhost[k], phost[k])
    rout = reng(rct, reng.load_block(rhost, 11))
    pout = eng(pct, eng.load_block(phost, 11))
    assert (pout.level, pout.scale) == (rout.level, rout.scale) == (
        8, rout.scale)
    np.testing.assert_array_equal(words(rout.c), words(pout.c))
    want = ref_fe.plaintext_ffn_block(x0, wk_c[0], wv_c[0])
    np.testing.assert_allclose(port.decrypt_vec(pout, D), want, atol=1e-4)


def test_stage_mode_other_than_i32_raises(chain):
    with pytest.raises(ValueError, match="int32"):
        fe.FullyEncryptedFfn(chain[1], D, F, stage_mode="expanded")


def test_wide_staging_and_block(chain):
    ref, port, _, _, wk_c, wv_c, x0 = chain
    rb, pb = RefMatvec(ref, D), BsgsMatvec(port, D)
    w = np.random.default_rng(3).standard_normal((D, D))
    scale = float(ref.q_np[10]) * float(ref.q_np[9])      # composite ~2^56
    renc, penc = rb.encode_wide(w, scale), pb.encode_wide(w, scale)
    np.testing.assert_array_equal(renc.coeffs, penc.coeffs)
    np.testing.assert_array_equal(
        words(jax.jit(lambda v: ref_expand_wide(ref, v, 11))(
            jnp.asarray(renc.coeffs))),
        words(rns_expand_wide(port, torch.as_tensor(penc.coeffs), 11)))

    reng = ref_fe.FullyEncryptedFfn(ref, D, F, stage_mode="i32", width=2)
    peng = fe.FullyEncryptedFfn(port, D, F, width=2)
    rct = ref.encrypt_replicated(x0, scale=ref.scale ** 2)
    pct = port.encrypt_replicated(x0, scale=port.scale ** 2)
    rhost = reng.encode_block(wk_c[0], wv_c[0], level=11)
    phost = peng.encode_block(wk_c[0], wv_c[0], level=11)
    np.testing.assert_array_equal(rhost["key"], phost["key"])
    assert phost["key"].shape == (F // D, 4, 4, 2, 256)
    rout = reng(rct, reng.load_block(rhost, 11))
    pout = peng(pct, peng.load_block(phost, 11))
    assert (pout.level, pout.scale) == (rout.level, rout.scale)
    assert pout.level == 5
    np.testing.assert_array_equal(words(rout.c), words(pout.c))
    want = ref_fe.plaintext_ffn_block(x0, wk_c[0], wv_c[0])
    np.testing.assert_allclose(port.decrypt_vec(pout, D), want, atol=1e-6)
    with pytest.raises(NotImplementedError):
        fe.run_fully_encrypted(port, wk_c[:1], wv_c[:1], x0, eng=peng,
                               bootstrap_fn=lambda c: c, calibrated=True)


def test_timemix_word_for_word(chain):
    ref, port, x0 = chain[0], chain[1], chain[6]
    rng = np.random.default_rng(11)
    w = [rng.normal(0, 1 / np.sqrt(D), (D, D)) for _ in range(4)]
    x = 5 * x0
    reng = ref_fe.FullyEncryptedTimeMix(ref, D)
    peng = fe.FullyEncryptedTimeMix(port, D)
    rct, pct = ref.encrypt_replicated(x), port.encrypt_replicated(x)
    rhost = reng.encode_block(*w, level=11)
    phost = peng.encode_block(*w, level=11)
    rout, pout = reng(rct, rhost), peng(pct, phost)
    assert (pout.level, pout.scale) == (rout.level, rout.scale)
    np.testing.assert_array_equal(words(rout.c), words(pout.c))
    np.testing.assert_allclose(port.decrypt_vec(pout, D),
                               fe.FullyEncryptedTimeMix.oracle(x, *w),
                               atol=2e-4)


def test_pre_encoded_chain(chain, tmp_path):
    port, wk_c, wv_c, x0 = chain[1], chain[4], chain[5], chain[6]
    eng = fe.FullyEncryptedFfn(port, D, F)
    levels = fe.fe_level_schedule(port.L, NB)
    hosts = fe.pre_encode_blocks(eng, wk_c, wv_c, levels=levels)
    stats = fe.run_fully_encrypted(port, wk_c, wv_c, x0, pre_encoded=hosts,
                                   eng=eng, calibrated=True, verbose=False)
    assert [s["level"] for s in stats] == [8, 5, 2]
    for s in stats:
        assert s["corr"] > 0.99999, stats
        assert s["max_err"] < 1e-4, stats

    # mis-levelled pre-encodes correct themselves, and the re-encode is
    # persisted to the cache directory
    hosts_bad = fe.pre_encode_blocks(eng, wk_c, wv_c, levels=[11, 9, 5],
                                     cache_dir=str(tmp_path))
    stats2 = fe.run_fully_encrypted(port, wk_c, wv_c, x0,
                                    pre_encoded=hosts_bad, eng=eng,
                                    calibrated=True, verbose=False,
                                    cache_dir=str(tmp_path))
    assert hosts_bad[1]["level"] == 8
    assert (tmp_path / "block001_l8" / "key.npy").exists()
    for s in stats2:
        assert s["max_err"] < 1e-4, stats2


def test_full_vocab_token(chain):
    port, wk, wv, x0 = chain[1], chain[2], chain[3], chain[6]
    w_head = np.random.default_rng(13).normal(0, 1 / np.sqrt(D), (D, 1000))
    wk_c, wv_c = ref_fe.calibrate_magnitude(wk[:2], wv[:2], x0)
    x_ref = x0.copy()
    for k, v in zip(wk_c, wv_c):
        x_ref = ref_fe.plaintext_ffn_block(x_ref, k, v)
    want_tok, want_logits = ref_fe.full_vocab_head(x_ref, w_head)
    tok, logits, stats = fe.generate_fully_encrypted_token(
        port, wk[:2], wv[:2], w_head, x0)
    assert len(stats) == 2 and tok == want_tok
    assert np.corrcoef(logits, want_logits)[0, 1] > 0.999
