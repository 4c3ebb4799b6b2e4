"""The device client's projections as CUDA graphs (`ops.graphed`) on the
card: a 2-block runner at d=64, f=256 on `CkksParams(8192, 3, 1)`.

  * A graphed projection returns the eager loop's int64 words on its
    eager, capturing and replaying calls, for S = 1 and 3 and all four
    projections, on the stockham and the four-step ("mxu") contexts.
  * Tokens through a graphed runner give logits bitwise equal to an eager
    runner's from the same seeds, and the same K1/K2 launch counts by
    shape; `GRAPHS` reads 8 eager calls, then 8 captures, then 8 replays a
    token; a new `key_epoch` drops the graphs and captures them again.

Every test skips without a card.  The file imports no jax, so it runs on
the card machine without the repository's conftest:
`python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_device_graphs.py`.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams
from fhe_spear_tpu_torch.core.ntt_cuda import NTT_FWD, NTT_INV
from fhe_spear_tpu_torch.models.device_client import DeviceTokenRunner
from fhe_spear_tpu_torch.models.rwkv7 import make_random_model
from fhe_spear_tpu_torch.ops.graphed import ProjectionGraphs
from fhe_spear_tpu_torch.utils.profiling import GRAPHS

pytestmark = pytest.mark.cuda

NB = 2


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model():
    return make_random_model(d=64, f=256, n_blocks=NB, head_size=16,
                             vocab=64, seed=12)


def _runner(model, backend="stockham", eager=False):
    ctx = CkksContext(CkksParams(8192, 3, 1, ntt_backend=backend), seed=71,
                      device="cuda")
    runner = DeviceTokenRunner(ctx, model, level=3)
    if eager:
        runner._graphs = _Eager(ctx)
    return runner


class _Eager(ProjectionGraphs):
    engaged = False


def _stream_cts(ctx, S, b, level, seed):
    g = torch.Generator().manual_seed(seed)
    p = ctx.ntt.p[:level].cpu()
    x = torch.randint(0, 1 << 62, (S, b, 2, level, ctx.n), generator=g)
    return (x % p).to(ctx.device)


@pytest.mark.parametrize("backend", ["stockham", "mxu"])
def test_graphed_projection_words(card, model, backend):
    runner = _runner(model, backend)
    assert runner._graphs.engaged
    ctx = runner.ctx
    GRAPHS.update(dict.fromkeys(GRAPHS, 0))
    for S in (1, 3):
        for name, b in (("rkv", 3), ("o", 1), ("fk", 1),
                        ("fv", len(runner.key_pairs))):
            kern = runner._server_kern(name, 1)
            for call in range(4):            # eager, capture, replay x 2
                c = _stream_cts(ctx, S, b, runner.level, 10 * call + S)
                want = torch.stack([kern(cs) for cs in c])
                got = runner._graphs(name, 1, kern, c)
                assert got.dtype == torch.int64
                assert torch.equal(got, want), (backend, S, name, call)
    assert dict(GRAPHS) == {"eager": 8, "captures": 8, "replays": 16}


def _tokens(runner, n, ids=(5, 9)):
    """n steps of len(ids) streams from zero states and a fixed seed:
    [logits], with GRAPHS and the K1/K2 counts by shape after each."""
    runner._seed = 1234
    states = [runner.model.zero_state() for _ in ids]
    out = []
    for _ in range(n):
        NTT_FWD.reset()
        NTT_INV.reset()
        logits, states = runner.generate_tokens_streams(list(ids), states)
        torch.cuda.synchronize()
        out.append((np.asarray(logits), dict(GRAPHS),
                    Counter(NTT_FWD.by_shape), Counter(NTT_INV.by_shape)))
    return out


def test_graphed_tokens_equal_eager(card, model):
    eager = _runner(model, eager=True)
    GRAPHS.update(dict.fromkeys(GRAPHS, 0))
    want = _tokens(eager, 4)
    assert want[-1][1] == {"eager": 4 * 4 * NB, "captures": 0,
                           "replays": 0}
    graphed = _runner(model)
    GRAPHS.update(dict.fromkeys(GRAPHS, 0))
    got = _tokens(graphed, 4)
    m = 4 * NB                                  # projections a token
    assert [g[1] for g in got] == [
        {"eager": m, "captures": 0, "replays": 0},
        {"eager": m, "captures": m, "replays": 0},
        {"eager": m, "captures": m, "replays": m},
        {"eager": m, "captures": m, "replays": 2 * m}]
    for t, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g[0], w[0], err_msg=f"token {t}")
        assert g[2] == w[2] and g[3] == w[3], t

    # new keys drop the graphs: one eager token, one capture, then replays
    graphed.ctx.key_epoch += 1
    GRAPHS.update(dict.fromkeys(GRAPHS, 0))
    got = _tokens(graphed, 3)
    assert got[-1][1] == {"eager": m, "captures": m, "replays": m}
    for t, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g[0], w[0], err_msg=f"epoch, {t}")
        assert g[2] == w[2] and g[3] == w[3], t
