"""The port's naive per-column ablation against the JAX package's.

On one n=256/L=3/seed-91 pair of contexts: `naive_matvec` in column
chunks of 8 and 3 against the reference's decrypted output and against
x @ w; `ct_pt_dot`'s ciphertexts word for word; one `_ws_batch` step word
for word (the port accumulates over the input axis in chunks).  The
chains (`naive_multilayer` both ways, `naive_autoregressive`) run on the
port alone at the reference test's n=256/L=8/seed-77 context and bars."""

import numpy as np
import pytest
import torch

from fhe_spear_tpu.ckks import CkksContext as RefContext
from fhe_spear_tpu.ckks import CkksParams as RefParams
from fhe_spear_tpu.models import naive_inference as ref_naive
from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams
from fhe_spear_tpu_torch.models import naive_inference as naive

PARAMS = dict(n=256, num_limbs=3, num_special=1)


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
def pair():
    return (RefContext(RefParams(**PARAMS), seed=91),
            CkksContext(CkksParams(**PARAMS), seed=91, device="cpu"))


def words(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x).astype(np.int64)


def test_naive_matvec_chunks_match_reference(pair):
    ref, port = pair
    rng = np.random.default_rng(4)
    d_in, d_out = 16, 8
    w = rng.normal(0, 0.3, (d_in, d_out))
    x = rng.normal(0, 1, d_in)
    v = np.pad(x, (0, ref.slots - d_in))
    want = ref_naive.naive_matvec(ref, ref.encrypt_replicated(v), w, d_in,
                                  d_out)
    ct = port.encrypt_replicated(v)
    for chunk in (8, 3):
        got = naive.naive_matvec(port, ct, w, d_in, d_out, col_chunk=chunk)
        np.testing.assert_allclose(got, want, rtol=1e-9)
        np.testing.assert_allclose(got, x @ w, atol=1e-3)
    assert naive.rotation_count_naive(2048, 2048 * 11) \
        == ref_naive.rotation_count_naive(2048, 2048 * 11) > 22528 * 10
    assert naive.default_col_chunk(port, 3) >= d_out


def test_ct_pt_dot_word_for_word(pair):
    """Eight ciphertexts at once: the batch has the column batch's shape,
    so the reference reuses the rotation kernels it compiled for it."""
    ref, port = pair
    rng = np.random.default_rng(8)
    d = 16
    xs, w = rng.normal(0, 1, (8, d)), rng.normal(0, 0.3, d)
    v = np.pad(xs, ((0, 0), (0, ref.slots - d)))
    want = ref_naive.ct_pt_dot(ref, ref.encrypt(v), w, d)
    got = naive.ct_pt_dot(port, port.encrypt(v), w, d)
    np.testing.assert_array_equal(words(got.c), words(want.c))
    assert got.scale == want.scale
    np.testing.assert_allclose(port.decrypt_vec(got)[:, 0], xs @ w,
                               atol=1e-3)


def test_ws_batch_word_for_word(pair, monkeypatch):
    ref, port = pair
    rng = np.random.default_rng(9)
    d, f = 8, 16
    x = rng.normal(0, 0.5, d)
    w = rng.normal(0, 0.25, (d, f))
    tiled = np.tile(x[:, None], (1, ref.slots))
    want = ref_naive._ws_batch(ref, ref.encrypt(tiled).c, w)
    c = port.encrypt(tiled).c
    # one input at a time and all at once give the reference's words
    for budget in (1, naive.WS_PRODUCT_BYTES):
        monkeypatch.setattr(naive, "WS_PRODUCT_BYTES", budget)
        np.testing.assert_array_equal(words(naive._ws_batch(port, c, w)),
                                      words(want))


@pytest.fixture(scope="module")
def chain_setup():
    ctx = CkksContext(CkksParams(n=256, num_limbs=8, num_special=1),
                      seed=77, device="cpu")
    rng = np.random.default_rng(2)
    d, f, vocab = 8, 16, 12
    blocks = [(rng.normal(0, 0.25, (d, f)), rng.normal(0, 0.2, (f, d)))
              for _ in range(2)]
    w_head = rng.normal(0, 0.3, (d, vocab))
    x = rng.normal(0, 0.5, d)
    emb = rng.normal(0, 0.5, (vocab, d))
    return ctx, blocks, w_head, x, emb


@pytest.mark.parametrize("residual", [False, True])
def test_naive_multilayer_chain(chain_setup, residual):
    ctx, blocks, w_head, x, _ = chain_setup
    h = x.copy()
    for wk, wv in blocks:
        pre = (h @ wk) ** 2 @ wv
        h = pre + h if residual else pre
    want = h @ w_head
    tok, logits, lvl = naive.naive_multilayer(ctx, x, blocks, w_head,
                                              residual=residual)
    assert tok == int(np.argmax(want)), (logits, want)
    assert np.corrcoef(logits, want)[0, 1] > 0.999
    assert lvl == ctx.L - 7


def test_naive_autoregressive(chain_setup):
    ctx, blocks, w_head, _, emb = chain_setup
    toks_f, toks_p = naive.naive_autoregressive(ctx, emb, blocks, w_head,
                                                start_token=3, num_tokens=2)
    assert toks_f == toks_p and len(toks_f) == 3


def test_naive_ablation_entry_cpu():
    r = naive.naive_ablation(d=16, f=64, n=256, device="cpu")
    assert r["corr"] > 0.99999 and r["max_err"] < 1e-3
    assert (r["key_rotations"], r["value_rotations"]) == (64 * 4, 16 * 6)
    assert r["col_chunk"] == naive.default_col_chunk(
        CkksContext(CkksParams(**PARAMS), seed=0, device="cpu"), 3)
    assert r["key_s"] > 0 and r["value_s"] > 0
    with pytest.raises(ValueError, match="slots"):
        naive.naive_ablation(d=16, f=256, n=256, device="cpu")
