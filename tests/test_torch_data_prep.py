"""The port's `apps.data_prep` against the JAX package's on a tiny
SQuAD-format JSON: the SFT JSONL, the parsed (passages, questions,
answers) and the gold query pairs are equal."""

import json

import pytest
import torch

from fhe_spear_tpu.apps import data_prep as ref_dp
from fhe_spear_tpu_torch.apps import data_prep as dp


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Under a parallel test run the threads of several workers
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SQUAD = {"version": "v2.0", "data": [
    {"title": "a", "paragraphs": [
        {"context": " The river runs north. ", "qas": [
            {"question": "Which way does the river run? ",
             "answers": [{"text": "north", "answer_start": 15}]},
            {"question": "Is it wide?", "is_impossible": True,
             "answers": []},
            {"question": "Unanswered?", "answers": []}]},
        {"context": "Bees make honey.", "qas": [
            {"question": "What do bees make?",
             "answers": [{"text": " honey ", "answer_start": 10}]}]}]},
    {"title": "b", "paragraphs": [
        {"context": "Snow is cold.", "qas": [
            {"question": "Is snow cold?", "answers": [{"text": "yes"}]},
            {"question": "What is cold?", "answers": [{"text": "Snow"}]}]}]},
]}


@pytest.mark.parametrize("max_samples", [5000, 2])
def test_data_prep_equal_to_reference(tmp_path, max_samples):
    src = tmp_path / "squad.json"
    src.write_text(json.dumps(SQUAD))
    ours, ref = tmp_path / "ours.jsonl", tmp_path / "ref.jsonl"
    n = dp.squad_to_sft(str(src), str(ours), max_samples=max_samples)
    assert n == ref_dp.squad_to_sft(str(src), str(ref),
                                    max_samples=max_samples)
    assert n == min(4, max_samples)
    assert ours.read_text() == ref.read_text()
    with open(ours, "a") as f:
        f.write("not json\n" + json.dumps({"text": "no fields"}) + "\n")
    for limit in (100, 1):
        got = dp.load_sft(str(ours), n=limit)
        assert got == ref_dp.load_sft(str(ours), n=limit)
        assert len(got[0]) == min(n, limit)
    passages, questions, answers = dp.load_sft(str(ours))
    assert passages[0] == "The river runs north."
    assert answers[0] == "north"
    assert dp.load_sft(str(tmp_path / "missing.jsonl")) == ([], [], [])
    assert dp.build_retrieval_corpus(passages, questions, n_queries=3,
                                     seed=4) == \
        ref_dp.build_retrieval_corpus(passages, questions, n_queries=3,
                                      seed=4)
