"""The port's client-aided generation against the JAX package's, on the
tests/test_client_aided.py model (d=32, f=128, 2 blocks, head 16, vocab 64)
at n=256.

  * explicit transport: the first projection of block 0 gives ciphertext
    words equal to the reference's; a whole token gives logits equal to
    the reference's to atol 1e-6 (the client's float64 arithmetic, summed
    in another order, may move one encoded coefficient by one unit, which
    shifts a slot by about 2^-28);
  * both transports on the server's int32 staging: tokens equal the
    plaintext twin with logit correlation > 0.9999 (the fused transport
    draws device-side randomness, so it is not bitwise);
  * model_from_reference round-trips every field.
"""

import numpy as np
import pytest
import torch

from fhe_spear_tpu.ckks import CkksContext as RefContext
from fhe_spear_tpu.ckks import CkksParams as RefParams
from fhe_spear_tpu.models import client_aided as ref_ca
from fhe_spear_tpu.models import rwkv7 as ref_rwkv
from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams
from fhe_spear_tpu_torch.convert import model_from_reference
from fhe_spear_tpu_torch.models import client_aided as port_ca
from fhe_spear_tpu_torch.models import rwkv7 as port_rwkv


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small-ring torch ops gain nothing from intra-op threads, and under a
    parallel test run the threads of several workers oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_model():
    return ref_rwkv.make_random_model(d=32, f=128, n_blocks=2, head_size=16,
                                      vocab=64, seed=42)


@pytest.fixture(scope="module")
def model(ref_model):
    return model_from_reference(ref_model)


def _port_ctx(seed=31):
    return CkksContext(CkksParams(n=256, num_limbs=3, num_special=1),
                       seed=seed, device="cpu")


def test_model_from_reference_round_trip(ref_model, model):
    for name in ("emb", "head_w", "ln_out_w", "ln_out_b", "ln0_w", "ln0_b"):
        np.testing.assert_array_equal(getattr(model, name),
                                      getattr(ref_model, name))
    for rb, pb in zip(ref_model.blocks, model.blocks):
        for name in ("block_idx", "d", "f", "n_head", "head_size"):
            assert getattr(rb, name) == getattr(pb, name)
        for name in port_rwkv._BLOCK_FIELDS:
            np.testing.assert_array_equal(getattr(pb, name),
                                          getattr(rb, name))
    # the port's own generator makes the same weights from the same seed
    own = port_rwkv.make_random_model(d=32, f=128, n_blocks=2, head_size=16,
                                      vocab=64, seed=42)
    np.testing.assert_array_equal(own.blocks[1].W_val_ffn,
                                  model.blocks[1].W_val_ffn)
    np.testing.assert_array_equal(own.emb, model.emb)


def test_save_load_shared_format(ref_model, tmp_path):
    ref_rwkv.save_model(str(tmp_path / "m"), ref_model)
    got = port_rwkv.load_model(str(tmp_path / "m"))
    np.testing.assert_array_equal(got.blocks[1].W_o, ref_model.blocks[1].W_o)
    np.testing.assert_array_equal(got.head_w, ref_model.head_w)


def test_explicit_transport_matches_reference(ref_model, model):
    ref = RefContext(RefParams(n=256, num_limbs=3, num_special=1), seed=31)
    port = _port_ctx(31)
    rsrv = ref_ca.FheRwkvServer(ref, ref_model, level=3)
    psrv = port_ca.FheRwkvServer(port, model, level=3)
    rcl = ref_ca.FheRwkvClient(ref, ref_model, rsrv, fused=False)
    pcl = port_ca.FheRwkvClient(port, model, psrv, fused=False)
    assert rcl._seed == pcl._seed

    # first projection of block 0: the r/k/v round trip, word for word
    blk = model.blocks[0]
    x = port_rwkv.layer_norm(model.emb[5].copy(), model.ln0_w, model.ln0_b)
    x_ln = port_rwkv.layer_norm(x, blk.ln1_w, blk.ln1_b)
    mixes = port_rwkv.token_mix(blk, x_ln, np.zeros(model.d))
    xs = np.stack([mixes["r"], mixes["k"], mixes["v"]])
    slots = pcl._tile(xs / np.abs(xs).max(axis=-1, keepdims=True))
    rct, pct = ref.encrypt(slots, level=3), port.encrypt(slots, level=3)
    np.testing.assert_array_equal(np.asarray(rct.c).astype(np.int64),
                                  pct.c.numpy())
    rout, pout = rsrv.project_rkv(0, rct), psrv.project_rkv(0, pct)
    assert rout.scale == pout.scale
    np.testing.assert_array_equal(np.asarray(rout.c).astype(np.int64),
                                  pout.c.numpy())

    # a whole token through both clients
    rl, _, _ = rcl.generate_token(5, ref_model.zero_state())
    pl, _, _ = pcl.generate_token(5, model.zero_state())
    np.testing.assert_allclose(pl, rl, atol=1e-6, rtol=0)


@pytest.mark.parametrize("fused", [True, False])
def test_tokens_match_plaintext(model, fused):
    results = port_ca.run_generation(
        _port_ctx(31), model, seed_tokens=[5, 11, 2], num_tokens=2, level=3,
        verbose=False, fused=fused)
    for r in results:
        assert r["match"], results
        assert r["corr"] > 0.9999, results


def test_chunk_pairs():
    assert port_ca._chunk_pairs(3) == [(0, 1), (2, None)]
    assert port_ca._chunk_pairs(4) == ref_ca._chunk_pairs(4)
