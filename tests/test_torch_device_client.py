"""The port's device-resident client against the JAX package's, at the
tests/test_device_client.py model (d=32, f=128, head 16, vocab 64, n=256).

  * The runner's server stacks (int32 diagonal encodings / PRESCALE) equal
    the reference runner's word for word, its client weight stacks in
    float32, and both draw the same base seed after the same rotation
    keys.  (The reference runner is only constructed: its jitted token
    scan is not compiled here.)
  * `_encode_dev` agrees with the reference's on the same slots to a few
    float32 ulps at the coefficients' magnitude, and so does each with the
    exact float64 encoder: coefficients reach 2^26 at the scale 2^28, where
    float32 values are 4 units apart, so the two complex64 FFTs (torch's,
    XLA's) cannot agree to the unit.
  * Tokens match the plaintext twin with logit correlation > 0.999 on the
    stockham and the four-step ("mxu") contexts, and every stream of
    `generate_tokens_streams` matches its own twin (the reference test's
    assertions).  The device randomness is a torch.Generator, not
    threefry, so tokens are compared, not ciphertext words.
  * The token step's spans (`utils.profiling.span`) under a CPU profiler:
    their counts a step, the keyswitch inside every server matvec, no
    client span inside a server one or the other way round, and logits
    bitwise equal with the profiler on and off.
  * The projections' CUDA graphs (`ops.graphed`) off the card: a CPU
    context runs every call eagerly, the counter replay helper, the graph
    key.  tests/test_torch_device_graphs.py holds the graphs on the card.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fhe_spear_tpu.ckks import CkksContext as RefContext
from fhe_spear_tpu.ckks import CkksParams as RefParams
from fhe_spear_tpu.models import device_client as ref_dc
from fhe_spear_tpu.models import rwkv7 as ref_rwkv
from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams
from fhe_spear_tpu_torch.convert import model_from_reference
from fhe_spear_tpu_torch.core.ntt_cuda import KernelStats
from fhe_spear_tpu_torch.models import device_client as port_dc
from fhe_spear_tpu_torch.models.rwkv7 import generate_token_plaintext, \
    make_random_model
from fhe_spear_tpu_torch.ops import graphed
from fhe_spear_tpu_torch.utils.profiling import GRAPHS


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small-ring torch ops gain nothing from intra-op threads, and under a
    parallel test run the threads of several workers oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_ctx(backend="stockham", seed=61):
    return CkksContext(CkksParams(n=256, num_limbs=3, num_special=1,
                                  ntt_backend=backend), seed=seed,
                       device="cpu")


def test_runner_stacks_and_encode_match_reference():
    ref_model = ref_rwkv.make_random_model(d=32, f=128, n_blocks=2,
                                           head_size=16, vocab=64, seed=9)
    ref = RefContext(RefParams(n=256, num_limbs=3, num_special=1), seed=61)
    rr = ref_dc.DeviceTokenRunner(ref, ref_model, level=3)
    pr = port_dc.DeviceTokenRunner(_port_ctx(), model_from_reference(
        ref_model), level=3)
    assert rr._seed == pr._seed
    for k in ("rkv", "o", "fk", "fv"):
        np.testing.assert_array_equal(np.asarray(rr.pt[k]),
                                      pr.pt[k].numpy())
    assert list(rr.cw) == list(pr.cw)
    for k in rr.cw:
        np.testing.assert_array_equal(np.asarray(rr.cw[k]), pr.cw[k].numpy())

    rng = np.random.default_rng(4)
    z = (rng.uniform(-1, 1, (3, 128))
         + 1j * rng.uniform(-1, 1, (3, 128))).astype(np.complex64)
    want = np.asarray(rr._encode_dev(jnp.asarray(z))).astype(np.int64)
    got = pr._encode_dev(torch.as_tensor(z)).numpy().astype(np.int64)
    exact = pr.ctx.encoder.encode(z.astype(np.complex128), pr.ctx.scale)
    # float32 values near the largest coefficient are `ulp` apart, so both
    # float32 FFT encodes sit a few ulps from the exact (float64) one
    ulp = 2.0 ** (np.floor(np.log2(np.abs(exact).max())) - 23)
    assert np.abs(got - exact).max() <= 4 * ulp
    assert np.abs(got - want).max() <= 4 * ulp
    np.testing.assert_allclose(
        pr._decode_dev(torch.as_tensor(got, dtype=torch.float32)
                       / np.float32(pr.ctx.scale)).numpy(), z, atol=1e-5)


@pytest.mark.parametrize("backend", ["stockham", "mxu"])
def test_device_client_token_exact(backend):
    model = make_random_model(d=32, f=128, n_blocks=3, head_size=16,
                              vocab=64, seed=9)
    results = port_dc.run_generation_device(
        _port_ctx(backend), model, seed_tokens=[5, 11, 2], num_tokens=3)
    assert len(results) == 3
    for r in results:
        assert r["match"], results
        assert r["corr"] > 0.999, results


def test_device_client_streams():
    """Multi-stream token step: each stream token-exact against its own
    plaintext twin, all streams advanced by one call."""
    model = make_random_model(d=32, f=128, n_blocks=2, head_size=16,
                              vocab=64, seed=10)
    ctx = _port_ctx()
    runner = port_dc.DeviceTokenRunner(ctx, model, level=ctx.L)
    toks = [3, 17, 42]
    states = [model.zero_state() for _ in toks]
    logits, news = runner.generate_tokens_streams(toks, states)
    for s, t in enumerate(toks):
        lref, sref = generate_token_plaintext(model, t, model.zero_state())
        assert int(np.argmax(logits[s])) == int(np.argmax(lref)), s
        corr = float(np.corrcoef(logits[s], lref)[0, 1])
        assert corr > 0.999, (s, corr)
        np.testing.assert_allclose(np.stack(news[s].wkv),
                                   np.stack(sref.wkv), atol=1e-3)


_SPANS = ("token", "token.state_in", "token.embed", "client.math",
          "client.encode", "client.encrypt", "server.bsgs", "client.decrypt",
          "ckks.decompose", "ckks.keyswitch", "token.readback", "token.head",
          "token.state_out")


def test_device_client_spans():
    """One profiled `generate_tokens_streams` step of 2 streams over 2
    blocks: each span's count, the nesting, and the same logits as the
    unprofiled step from the same seed."""
    nb, toks = 2, [3, 17]
    model = make_random_model(d=32, f=128, n_blocks=nb, head_size=16,
                              vocab=64, seed=10)
    ctx = _port_ctx()
    runner = port_dc.DeviceTokenRunner(ctx, model, level=ctx.L)
    states = [model.zero_state() for _ in toks]
    seed = runner._seed
    want, _ = runner.generate_tokens_streams(toks, states)
    runner._seed = seed
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got, _ = runner.generate_tokens_streams(toks, states)
    np.testing.assert_array_equal(got, want)

    ev = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
          for e in prof.profiler.kineto_results.events()
          if e.name() in _SPANS and e.activity_type() == "cpu_op"]
    count = {n: sum(1 for *_, m in ev if m == n) for n in _SPANS}
    S = len(toks)
    assert count == {"token": 1, "token.state_in": 1, "token.embed": 1,
                     "client.math": 5 * nb, "client.encode": 4 * nb,
                     "client.encrypt": 4 * nb, "server.bsgs": 4 * nb * S,
                     "client.decrypt": 4 * nb,
                     "ckks.decompose": count["ckks.decompose"],
                     "ckks.keyswitch": count["ckks.keyswitch"],
                     "token.readback": 1, "token.head": 1,
                     "token.state_out": 1}

    def inside(outer, prefix):
        return [m for s, e, m in ev
                if m.startswith(prefix) and outer[0] <= s and e <= outer[1]]

    (tok,) = [x for x in ev if x[2] == "token"]
    assert len(inside(tok, "")) == len(ev)
    for x in ev:
        if x[2] == "server.bsgs":
            assert "ckks.decompose" in inside(x, "ckks.")
            assert "ckks.keyswitch" in inside(x, "ckks.")
            assert inside(x, "client.") == []
        elif x[2].startswith("client."):
            assert inside(x, "server.") == [] and inside(x, "ckks.") == []
            assert inside(x, "client.") == [x[2]]


def _stream_cts(ctx, S, b, level, seed):
    """Random canonical residues standing for S streams' ciphertexts
    [S, b, 2, l, N] (the server kernels take any residues)."""
    g = torch.Generator().manual_seed(seed)
    p = ctx.ntt.p[:level].cpu()                               # [l, 1]
    x = torch.randint(0, 1 << 62, (S, b, 2, level, ctx.n), generator=g)
    return (x % p).to(ctx.device)


def test_cpu_projections_run_eager():
    """A CPU context never graphs: every projection call runs the
    per-stream loop (its words those of calling the kernel stream by
    stream) and moves only GRAPHS["eager"]."""
    model = make_random_model(d=32, f=128, n_blocks=2, head_size=16,
                              vocab=64, seed=10)
    ctx = _port_ctx()
    runner = port_dc.DeviceTokenRunner(ctx, model, level=ctx.L)
    assert not runner._graphs.engaged
    GRAPHS.update(dict.fromkeys(GRAPHS, 0))
    calls = 0
    for name, b in (("rkv", 3), ("o", 1), ("fk", 1),
                    ("fv", len(runner.key_pairs))):
        kern = runner._server_kern(name, 1)
        for S in (1, 2):
            c = _stream_cts(ctx, S, b, runner.level, seed=S + b)
            want = torch.stack([kern(cs) for cs in c])
            for _ in range(3):               # first, second, third call
                got = runner._graphs(name, 1, kern, c)
                calls += 1
                assert torch.equal(got, want), (name, S)
    assert dict(GRAPHS) == {"captures": 0, "replays": 0, "eager": calls}


def test_count_replays_adds_delta_times():
    """The counter replay helper adds a capture's by_shape delta k times
    to the launch counters, launches included."""
    fresh = KernelStats("k")
    fresh.add(Counter({(4, 3, 256): 2, (1, 1, 256): 1}), 3)
    assert fresh.by_shape == {(4, 3, 256): 6, (1, 1, 256): 3}
    assert fresh.launches == 9

    saved = [(s.launches, Counter(s.by_shape)) for s in graphed._STATS]
    try:
        before = graphed.launch_counts()
        n0 = [s.launches for s in graphed._STATS]
        delta = [Counter({(368, 3, 8192): 5, (24, 4, 8192): 2}),
                 Counter({(8, 3, 8192): 7}), Counter(),
                 Counter({(90, 1, 8192): 1})]
        graphed.count_replays(delta, 4)
        after = graphed.launch_counts()
        assert [a - b for a, b in zip(after, before)] == [
            Counter({k: 4 * v for k, v in d.items()}) for d in delta]
        assert [s.launches - n for s, n in zip(graphed._STATS, n0)] == [
            28, 28, 0, 4]
    finally:
        for s, (n, by) in zip(graphed._STATS, saved):
            s.launches, s.by_shape = n, by


def test_graph_key_changes_with_streams_row_and_epoch():
    ctx = _port_ctx()
    pg = graphed.ProjectionGraphs(ctx)
    c1 = _stream_cts(ctx, 1, 3, 3, seed=1)
    c3 = _stream_cts(ctx, 3, 3, 3, seed=2)
    k = pg.key("rkv", 0, c1)
    assert pg.key("rkv", 0, _stream_cts(ctx, 1, 3, 3, seed=5)) == k
    assert pg.key("rkv", 0, c3) != k
    assert pg.key("rkv", 1, c1) != k
    assert pg.key("fv", 0, c1) != k
    ctx.key_epoch += 1
    assert pg.key("rkv", 0, c1) != k
