"""The port's access-control apps against the JAX package's, at n=256 on
one pair of contexts replaying seed 71: the corrupted corpus, the
per-user correction ciphertexts, the corrected corpus and the CT-CT score
ciphertexts are equal word for word, per class and per passage (the noise
and the dummies come from the same `default_rng` stream); the PII
classification, the security sweep and the leak study equal the
reference's exactly.  Held to the reference tests' bars on the port alone:
the FHE restore study, one `generation_demo` at d=32, 1 block (token-exact
against the plaintext twin), and the `access-control` and `noise-study`
CLI subcommands at tiny size."""

import numpy as np
import pytest
import torch

from fhe_spear_tpu.apps import access_control as ref_ac
from fhe_spear_tpu.apps import noise_study as ref_ns
from fhe_spear_tpu.ckks import CkksContext as RefContext
from fhe_spear_tpu.ckks import CkksParams as RefParams
from fhe_spear_tpu_torch.apps import access_control as ac
from fhe_spear_tpu_torch.apps import noise_study as ns
from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams
from fhe_spear_tpu_torch.ops.packing import euclidean_to_lorentz, \
    lorentz_inner

PARAMS = dict(n=256, num_limbs=3, num_special=1)
TEXTS = [
    "Call 555-123-4567 or email a@b.com. Revenue was $4.2 million, up 12% "
    "since 2020. Dose: 50 mg.",
    "The trial found 30% of patients improved.",
    "Founded on March 3, 2001 by Acme Corp (ACME), SSN 123-45-6789.",
    "plain passage without anything sensitive",
]


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


@pytest.fixture(scope="module")
def pair():
    return (RefContext(RefParams(**PARAMS), seed=71),
            CkksContext(CkksParams(**PARAMS), seed=71, device="cpu"))


def make_corpus(n_docs=20, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    docs = rng.normal(0, 1, (n_docs, dim))
    docs /= np.linalg.norm(docs, axis=-1, keepdims=True)
    q = docs[3] + rng.normal(0, 0.05, dim)  # query close to doc 3
    classes = [set() for _ in range(n_docs)]
    for i in range(0, n_docs, 2):
        classes[i] = {"financial"}
    classes[3] = {"financial", "medical"}
    return docs, q / np.linalg.norm(q), classes


def test_pii_classification_equals_reference():
    for text in TEXTS:
        assert ac.detect_pii(text) == ref_ac.detect_pii(text)
        assert ac.classify_passage(text) == ref_ac.classify_passage(text)
    assert ac.classify_passage(TEXTS[0]) == {"personal", "financial",
                                             "temporal", "medical"}
    assert ac.SENSITIVITY_CLASSES == ref_ac.SENSITIVITY_CLASSES


@pytest.mark.parametrize("per_passage", [False, True],
                         ids=["per_class", "per_passage"])
def test_corrected_scores_word_for_word(pair, per_passage):
    ref, port = pair
    docs, q, classes = make_corpus(seed=2 if per_passage else 1)
    rc = ref_ac.AccessControlledCorpus(ref, dim=16, noise_scale=100.0,
                                       per_passage=per_passage, seed=1)
    pc = ac.AccessControlledCorpus(port, dim=16, noise_scale=100.0,
                                   per_passage=per_passage, seed=1)
    np.testing.assert_array_equal(words(rc.build(docs, classes).c),
                                  words(pc.build(docs, classes).c))
    assert pc._enc_scale == rc._enc_scale
    true = lorentz_inner(euclidean_to_lorentz(q), euclidean_to_lorentz(docs))
    for auth in ({"financial", "medical"}, set()):
        rcorr, pcorr = rc.corrections_for(auth), pc.corrections_for(auth)
        np.testing.assert_array_equal(words(rcorr.c), words(pcorr.c))
        rview, pview = rc.apply_corrections(rcorr), pc.apply_corrections(pcorr)
        assert pview.level == port.L
        np.testing.assert_array_equal(words(rview.c), words(pview.c))
        rs = rc.eng.scores_ctct(rc.eng.encrypt_query(q), rview)
        ps = pc.eng.scores_ctct(pc.eng.encrypt_query(q), pview)
        np.testing.assert_array_equal(words(rs.c), words(ps.c))
        assert ps.scale == rs.scale
        scores = pc.eng.decode_scores(ps, len(docs))
        np.testing.assert_allclose(scores, rc.eng.decode_scores(rs, len(docs)),
                                   rtol=0, atol=1e-9)
        if auth:
            # the reference test's bars: the authorized view is exact
            np.testing.assert_allclose(scores, true, atol=1e-2)
            assert np.argmax(scores) == np.argmax(true) == 3
        else:
            restricted = [i for i, cs in enumerate(classes) if cs]
            assert np.abs(scores[restricted]).max() > 10.0
    for got, want in zip(ac.security_sweep(pc, docs, classes),
                         ref_ac.security_sweep(rc, docs, classes)):
        assert got == want


def test_leak_study_equals_reference():
    got = ns.run_leak_study(n_docs=32, dim=17, n_queries=16, alpha=100.0)
    assert got == ref_ns.run_leak_study(n_docs=32, dim=17, n_queries=16,
                                        alpha=100.0)
    assert got["class_diff_corr"] > 0.999999
    assert abs(got["passage_diff_corr"]) < 0.1
    assert got["noise_to_signal"] > 100


def test_fhe_restore():
    ctx = CkksContext(CkksParams(**PARAMS), seed=71, device="cpu")
    res = ns.run_fhe_restore(ctx, n_docs=16, dim=16)
    assert res["auth_top1"] == res["true_top1"], res
    assert res["auth_score_corr"] > 0.999, res
    assert res["unauth_score_corr"] < 0.5, res


def test_generation_demo_token_exact():
    """Each user retrieves under their own corrections and generates on
    the retrieved passage (different passages, so different prompts); FHE
    generation is token-exact for both."""
    from fhe_spear_tpu_torch.models.client_aided import FheRwkvClient, \
        FheRwkvServer
    from fhe_spear_tpu_torch.models.rwkv7 import make_random_model

    ctx = CkksContext(CkksParams(**PARAMS), seed=71, device="cpu")
    docs, q, classes = make_corpus()
    passages = [f"Passage {i} reports figure {i * 7}. Extra sentence."
                for i in range(len(docs))]
    corpus = ac.AccessControlledCorpus(ctx, dim=16, noise_scale=100.0,
                                       seed=1)
    corpus.build(docs, classes)
    model = make_random_model(d=32, f=128, n_blocks=1, head_size=8,
                              vocab=64, seed=9)
    gen_ctx = CkksContext(CkksParams(**PARAMS), seed=72, device="cpu")
    client = FheRwkvClient(gen_ctx, model, FheRwkvServer(gen_ctx, model,
                                                         level=3))
    res = ac.generation_demo(
        corpus, passages, q, "Based on the text above, the figure is",
        {"alice": {"financial", "medical"}, "bob": set()}, client,
        num_tokens=2)
    assert res["alice"]["retrieved"] == 3, res["alice"]
    assert res["bob"]["retrieved"] != 3, res["bob"]
    assert res["alice"]["prompt"] != res["bob"]["prompt"]
    for user in ("alice", "bob"):
        assert res[user]["token_matches"] == 2, res[user]


def test_cli_access_control_and_noise_study(capsys):
    from fhe_spear_tpu_torch.__main__ import main

    main(["access-control", "--n_docs", "10", "--dim", "8", "--n", "256",
          "--device", "cpu"])
    out = capsys.readouterr().out
    assert "alice top: 0 (expect 0)" in out
    assert "scale=500: separation" in out
    main(["noise-study", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "leak study" in out and '"auth_top1": 0' in out
