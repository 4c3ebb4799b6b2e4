"""The port's BsgsMatvec against the JAX package's at d=32, n=256: the
staged int32 encodings, the expanded residues and the output ciphertext
words are equal, for a matrix staged in each of the three formats."""

import jax
import numpy as np
import pytest
import torch

from fhe_spear_tpu.ckks import CkksContext as RefContext
from fhe_spear_tpu.ckks import CkksParams as RefParams
from fhe_spear_tpu.ops.bsgs import BsgsMatvec as RefMatvec
from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams
from fhe_spear_tpu_torch.ops.bsgs import (BsgsMatvec, bsgs_dims,
                                          bsgs_kernel, extract_diagonals,
                                          rns_expand)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small-ring torch ops gain nothing from intra-op threads, and under a
    parallel test run the threads of several workers oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


D = 32


@pytest.fixture(scope="module")
def setup():
    ref = RefContext(RefParams(n=256, num_limbs=3, num_special=1), seed=11)
    port = CkksContext(CkksParams(n=256, num_limbs=3, num_special=1),
                       seed=11, device="cpu")
    reng, peng = RefMatvec(ref, D), BsgsMatvec(port, D)
    rng = np.random.RandomState(2)
    w = rng.uniform(-1, 1, (D, D)) / np.sqrt(D)
    x = rng.uniform(-1, 1, D)
    rct, pct = ref.encrypt_replicated(x), port.encrypt_replicated(x)
    return ref, port, reng, peng, w, x, rct, pct


def test_dims_and_diagonals():
    assert bsgs_dims(2048) == (46, 45)
    assert bsgs_dims(32) == (6, 6)
    w = np.arange(36.0).reshape(6, 6)
    diags = extract_diagonals(w)
    G, B = bsgs_dims(6)
    assert diags.shape == (B, G, 6)
    np.testing.assert_array_equal(diags[0, 1], [w[j, (j + 1) % 6]
                                                for j in range(6)])


@pytest.mark.parametrize("fmt", ["residues", "int32", "planes"])
def test_matvec_formats_bitwise(setup, fmt):
    """One matrix staged in each format of `expand_groups` gives the
    reference's words through `__call__` and `bsgs_kernel`, neither told
    the format."""
    ref, port, reng, peng, w, x, rct, pct = setup
    np.testing.assert_array_equal(np.asarray(rct.c).astype(np.int64),
                                  pct.c.numpy())
    if fmt == "planes":                        # composite scale ~2^56
        scale = float(port.q_np[2]) * float(port.q_np[1])
        renc, penc = reng.encode_wide(w, scale), peng.encode_wide(w, scale)
    else:
        renc, penc = reng.encode(w), peng.encode(w)
    np.testing.assert_array_equal(renc.coeffs, penc.coeffs)
    if fmt == "residues":
        rpt, ppt = reng.load(renc, 3), peng.load(penc, 3)
        np.testing.assert_array_equal(np.asarray(rpt).astype(np.int64),
                                      ppt.numpy())
        want = reng(rct, rpt).c
    else:
        ppt = torch.as_tensor(penc.coeffs)
        want = jax.jit(reng._kernel_raw(3, i32=True, wide=fmt == "planes"))(
            rct.c, jax.numpy.asarray(renc.coeffs), *reng._xs(3))
    want = np.asarray(want).astype(np.int64)
    pout = peng(pct, ppt)
    np.testing.assert_array_equal(want, pout.c.numpy())
    np.testing.assert_array_equal(
        want, bsgs_kernel(peng, 3, "single")(pct.c, ppt).numpy())
    if fmt != "planes":
        got = port.decrypt_vec(pout)[:D]
        np.testing.assert_allclose(got, w @ x, atol=1e-3)


def test_rns_expand_negative_coeffs(setup):
    from fhe_spear_tpu.ops.bsgs import rns_expand as ref_expand

    ref, port = setup[:2]
    c = np.array([[-(2 ** 31), -1, 0, 1, 2 ** 31 - 1] * 51 + [7]],
                 dtype=np.int32)
    want = np.asarray(jax.jit(lambda v: ref_expand(ref, v, 3))(
        jax.numpy.asarray(c)))
    got = rns_expand(port, torch.as_tensor(c), 3)
    np.testing.assert_array_equal(want.astype(np.int64), got.numpy())


def test_baby_chunks_same_words(setup, monkeypatch):
    """Baby keyswitches split into pieces (the bounded transient of deep
    chains) give the words of one batched keyswitch."""
    from fhe_spear_tpu_torch.ops import bsgs

    port, peng, pct = setup[1], setup[3], setup[7]
    xs = peng._xs(3)
    whole = peng.babies(pct.c, 3, *xs[:3])
    digits = 3 * 4 * 256 * 8                 # one rotation's digits, bytes
    monkeypatch.setattr(bsgs, "BABY_DIGIT_BYTES", 2 * digits)
    np.testing.assert_array_equal(peng.babies(pct.c, 3, *xs[:3]).numpy(),
                                  whole.numpy())
