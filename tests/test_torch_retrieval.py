"""The port's encrypted retrieval against the JAX package's at n=256: the
packing helpers equal the reference's numpy exactly; the row-packed CT-PT
and CT-CT (three batches each) and the column-packed (Lorentz and
Euclidean, three chunks each) score ciphertexts are equal word for word, their decoded scores
agree within 1e-9 and rank the documents alike; `FheSpearRetriever`
gives the reference's top-k; one `EncryptedRag.answer` is token-exact
against its plaintext twin."""

import numpy as np
import pytest
import torch

from fhe_spear_tpu.apps.demo import FheSpearRetriever as RefRetriever
from fhe_spear_tpu.ckks import CkksContext as RefContext
from fhe_spear_tpu.ckks import CkksParams as RefParams
from fhe_spear_tpu.ops import packing as ref_packing
from fhe_spear_tpu.ops.retrieval import ColumnPackedRetrieval as RefColumn
from fhe_spear_tpu.ops.retrieval import RowPackedRetrieval as RefRow
from fhe_spear_tpu_torch.apps.demo import FheSpearRetriever, hashed_embed
from fhe_spear_tpu_torch.apps.rag import EncryptedRag
from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams
from fhe_spear_tpu_torch.ops import packing
from fhe_spear_tpu_torch.ops.retrieval import ColumnPackedRetrieval, \
    RowPackedRetrieval


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small-ring torch ops gain nothing from intra-op threads, and under a
    parallel test run the threads of several workers oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# dim 15 packs into 8 complex slots with and without the Lorentz lift, so
# every column-packed case has the same shapes (the reference compiles
# once per shape)
N, DIM = 256, 15


def words(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x).astype(np.int64)


@pytest.fixture(scope="module")
def pair():
    """(reference, port) contexts replaying seed 21; every test draws the
    same encryptions from both, in the same order."""
    return (RefContext(RefParams(n=N, num_limbs=3, num_special=1), seed=21),
            CkksContext(CkksParams(n=N, num_limbs=3, num_special=1), seed=21,
                        device="cpu"))


def make_corpus(n_docs, seed):
    rng = np.random.default_rng(seed)
    docs = rng.normal(0, 1, (n_docs, DIM))
    docs /= np.linalg.norm(docs, axis=-1, keepdims=True)
    q = rng.normal(0, 1, DIM)
    return docs, q / np.linalg.norm(q)


def lorentz_scores(q, docs):
    return packing.lorentz_inner(packing.euclidean_to_lorentz(q),
                                 packing.euclidean_to_lorentz(docs))


def check_scores(ref_eng, port_eng, rct, pct, n_docs, want):
    np.testing.assert_array_equal(words(rct.c), words(pct.c))
    assert rct.scale == pct.scale
    got_r = ref_eng.decode_scores(rct, n_docs)
    got_p = port_eng.decode_scores(pct, n_docs)
    np.testing.assert_allclose(got_p, got_r, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(np.argsort(got_p), np.argsort(got_r))
    np.testing.assert_allclose(got_p, want, atol=2e-3)
    assert np.argmax(got_p) == np.argmax(want)


def test_packing_equals_reference():
    rng = np.random.default_rng(1)
    for d in (7, 16):
        v, w = rng.normal(0, 1, (2, 5, d))
        for name in ("euclidean_to_lorentz", "pack_complex",
                     "pack_complex_conjugate"):
            np.testing.assert_array_equal(getattr(packing, name)(v),
                                          getattr(ref_packing, name)(v))
        np.testing.assert_array_equal(packing.lorentz_inner(v, w),
                                      ref_packing.lorentz_inner(v, w))
        z = packing.pack_complex(v)
        np.testing.assert_array_equal(packing.unpack_complex(z, d),
                                      ref_packing.unpack_complex(z, d))
        np.testing.assert_array_equal(packing.unpack_complex(z, d), v)


@pytest.mark.parametrize("mode", ["ctpt", "ctct"])
def test_row_packed(pair, mode):
    """40 docs at 16 docs a ciphertext: three batches."""
    ref, port = pair
    n_docs = 40
    docs, q = make_corpus(n_docs, seed=len(mode))
    reng, peng = RefRow(ref, dim=DIM), RowPackedRetrieval(port, dim=DIM)
    assert peng.docs_per_ct == reng.docs_per_ct == 16
    if mode == "ctpt":
        rpt, ppt = reng.encode_docs(docs), peng.encode_docs(docs)
        np.testing.assert_array_equal(words(rpt.p)[:, 0], words(ppt.p))
        rct = reng.scores_ctpt(reng.encrypt_query(q), rpt)
        pct = peng.scores_ctpt(peng.encrypt_query(q), ppt)
    else:
        rdocs, pdocs = reng.encrypt_docs(docs), peng.encrypt_docs(docs)
        assert pdocs.c.shape[0] == 3
        rct = reng.scores_ctct(reng.encrypt_query(q), rdocs)
        pct = peng.scores_ctct(peng.encrypt_query(q), pdocs)
    check_scores(reng, peng, rct, pct, n_docs, lorentz_scores(q, docs))


@pytest.mark.parametrize("lorentz", [True, False])
def test_column_packed(pair, lorentz):
    """300 docs at 128 a chunk: three chunks."""
    ref, port = pair
    n_docs = 300
    docs, q = make_corpus(n_docs, seed=4 + lorentz)
    reng = RefColumn(ref, dim=DIM, lorentz=lorentz)
    peng = ColumnPackedRetrieval(port, dim=DIM, lorentz=lorentz)
    rcorp, pcorp = reng.encrypt_corpus(docs), peng.encrypt_corpus(docs)
    np.testing.assert_array_equal(words(rcorp.c), words(pcorp.c))
    rct = reng.scores(rcorp, reng.encrypt_query(q))
    pct = peng.scores(pcorp, peng.encrypt_query(q))
    want = lorentz_scores(q, docs) if lorentz else docs @ q
    check_scores(reng, peng, rct, pct, n_docs, want)


PASSAGES = [f"synthetic passage number {i} about topic {i % 7}"
            for i in range(16)]


def test_retriever_top_k(pair):
    """Row packing, CT-PT scores (plaintext corpus)."""
    ref = RefRetriever(pair[0], dim=DIM).index(PASSAGES, encrypted=False)
    port = FheSpearRetriever(pair[1], dim=DIM).index(PASSAGES,
                                                     encrypted=False)
    np.testing.assert_array_equal(hashed_embed(PASSAGES),
                                  ref.embed_fn(PASSAGES))
    question = "synthetic passage about topic 3"
    got, want = port.query(question, k=3), ref.query(question, k=3)
    assert [g[0] for g in got] == [w[0] for w in want]
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want],
                               rtol=0, atol=1e-9)
    assert got[0][0] == int(np.argmax(port.plaintext_scores(question)))


def test_encrypted_rag_token_exact():
    rag = EncryptedRag(PASSAGES, d=32, f=128, n_blocks=1, gen_n=256,
                       device="cpu")
    question = "synthetic passage about topic 5"
    out = rag.answer(question, num_tokens=2, verbose=False)
    assert out["passage_idx"] == int(np.argmax(
        rag.retriever.plaintext_scores(question)))
    assert out["tokens"] == out["plaintext_tokens"]
    assert out["token_matches"] == 2


def test_msmarco_loader_and_recall(tmp_path):
    from fhe_spear_tpu_torch.apps.demo import load_msmarco_sft, \
        recall_benchmark

    f = tmp_path / "sft.jsonl"
    f.write_text('{"text": "Context: the sky is blue. Question: what colour '
                 'is the sky? Answer: blue"}\nnot json\n'
                 '{"text": "no markers"}\n')
    assert load_msmarco_sft(f) == (["the sky is blue."],
                                   ["what colour is the sky?"])
    assert load_msmarco_sft(tmp_path / "missing.jsonl") == ([], [])
    out = recall_benchmark(n_docs=30, n_queries=5, dim=DIM, n=N,
                           verbose=False, device="cpu")
    assert out["n_queries"] == 5 and out["plaintext_top1_agreement"] == 1.0
