"""The port's block pipeline (`parallel.block_pipeline.BlockPipeline`) on 2
gloo ranks on the CPU (one spawn, each rank on one torch thread): 4
streams over d=32, f=128, 4 blocks (2 a rank), two pipelined tokens, held
to the reference tests' bars (`tests/test_block_pipeline.py`: token-exact
against the plaintext twin, logit correlation > 0.999, WKV state within
1e-3), with the second token from the returned states.  Each rank stages
only its own blocks, and every rank returns the same logits."""

import pytest
import torch

from fhe_spear_tpu_torch.parallel.collectives import RankGroup, run_ranks
from fhe_spear_tpu_torch.parallel.dryrun import run_jobs


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
def port():
    return run_ranks(run_jobs, 2, "gloo", "cpu", 240.0,
                     [("pipe", "pipeline", {})], threads=1)


@pytest.mark.parametrize("step", [0, 1])
def test_block_pipeline_token_exact(port, step):
    toks = port[0]["pipe"]["tokens"]
    assert len(toks) == 2
    for s, r in enumerate(toks[step]["streams"]):
        assert r["fhe"] == r["ref"], (step, s, r)
        assert r["corr"] > 0.999, (step, s, r)
        assert r["wkv_err"] < 1e-3, (step, s, r)


def test_block_pipeline_ranks_own_their_spans(port):
    assert [p["pipe"]["blocks"] for p in port] == [(0, 1), (2, 3)]
    for step in range(2):
        assert len({p["pipe"]["tokens"][step]["digest"] for p in port}) == 1
    # per step and rank: T = 4 + 2 - 1 ring shifts, then 4 result gathers
    assert port[0]["pipe"]["tokens"][0]["comm"]["calls"] == 5 + 4


def test_block_pipeline_needs_the_ranks_span():
    from fhe_spear_tpu_torch.ckks.context import CkksContext, CkksParams
    from fhe_spear_tpu_torch.models.device_client import DeviceTokenRunner
    from fhe_spear_tpu_torch.models.rwkv7 import make_random_model
    from fhe_spear_tpu_torch.parallel.block_pipeline import BlockPipeline

    ctx = CkksContext(CkksParams(n=256, num_limbs=3, num_special=1), seed=1,
                      device="cpu")
    model = make_random_model(d=32, f=64, n_blocks=2, head_size=16, vocab=16,
                              seed=1)
    runner = DeviceTokenRunner(ctx, model, level=3, blocks=range(0, 1))
    rank1 = RankGroup(None, 1, 2, "cpu", "gloo")
    assert BlockPipeline.span_of(2, rank1) == range(1, 2)
    with pytest.raises(ValueError):
        BlockPipeline(runner, rank1)
    with pytest.raises(AssertionError):
        runner.generate_token(3, model.zero_state())
