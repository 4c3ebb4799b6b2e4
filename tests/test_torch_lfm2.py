"""The port's LFM2-MoE runner (`models/lfm2.py`) at tiny widths on the CPU
(D=64, 4 heads of 16, 2 KV heads, SwiGLU 112, experts of 48, top 2 of 8,
vocab 128, N=256), held against the benchmark's plain float64 reference
(`benchmark/reference/lfm2.py`) on the benchmark's seeded weights
(`benchmark/weights_lfm2.py`), 4 layers: conv + dense, conv + dense,
attention + MoE, conv + MoE.

  * Logits of every decoded token against the reference, and each token
    decoded through the conv state and the KV cache (grown past its
    capacity) against the reference's full forward over its prefix.
  * Expert shares: the MoE outputs of two runners holding experts 0-3 and
    4-7 add up to the reference's layer with all 8, routed alike.
  * The server's projections (names, rows, shapes) are the same for two
    tokens that route to different experts; an expert dropped by the
    client fails the benchmark's comparison.
  * The device encode of the diagonals against the host encoder, the
    staged matrices against the step bound's count, and the RWKV runner
    on the shared device client against its words before the split.
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.compare import verdict
from benchmark.drivers.decode_lfm2 import compare_lfm2
from benchmark.reference.lfm2 import reference_logits, reference_moe
from benchmark.roofline_lfm2 import lfm2_step_bound
from benchmark.weights_lfm2 import make_weights
from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams
from fhe_spear_tpu_torch.models.device_client import DeviceTokenRunner
from fhe_spear_tpu_torch.models.device_crypto import PRESCALE, \
    diagonal_slots
from fhe_spear_tpu_torch.models.lfm2 import AttentionWeights, Lfm2Model, \
    Lfm2TokenRunner, MoeWeights, ShortConvWeights, SwiGluWeights
from fhe_spear_tpu_torch.models.rwkv7 import make_random_model
from fhe_spear_tpu_torch.ops.bsgs import extract_diagonals
from fhe_spear_tpu_torch.utils.profiling import MOE

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**31 + 17
TINY = {"hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 112,
        "moe_intermediate_size": 48, "num_router_experts": 8,
        "num_experts_per_tok": 2, "vocab_size": 128, "num_hidden_layers": 4}
IDS = [5, 17, 99, 3]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(experts=range(4)) -> dict:
    cfg = json.loads((ROOT / "benchmark/configs/lfm2-8b-a1b.json"
                      ).read_text())
    cfg.update(TINY, experts_held=list(experts), num_experts=len(experts))
    cfg["ckks"] = dict(cfg["ckks"], n=256)
    return cfg


def _ctx(seed=61):
    return CkksContext(CkksParams(n=256, num_limbs=3, num_special=1),
                       seed=seed, device="cpu")


def _decode(runner, ids, capacity):
    """Decode ids [T, S] from an empty state: (logits [T, S, V], routes
    [T, S, n_moe, k], state)."""
    state = runner.zero_state(len(ids[0]), capacity)
    logits, routes = [], []
    for t in ids:
        out, state = runner.generate_tokens_streams(t, state)
        logits.append(out)
        routes.append(runner.last_routes)
    return np.stack(logits), np.stack(routes), state


@pytest.fixture(scope="module")
def decoded():
    cfg = _cfg()
    w = make_weights(cfg, SEED, "cpu")
    runner = Lfm2TokenRunner(_ctx(), Lfm2Model.from_weights(w))
    ids = np.asarray(IDS)[:, None]
    logits, routes, state = _decode(runner, ids, capacity=2)
    return {"cfg": cfg, "w": w, "runner": runner, "ids": ids,
            "logits": logits, "routes": routes, "state": state}


def test_runner_logits_match_reference(decoded):
    """4 tokens through every layer kind against the float64 reference, by
    the benchmark's numbers; the KV cache grew from 2 positions to 4."""
    model = decoded["runner"].model
    kinds = {type(layer.mixer) for layer in model.layers} | {
        type(layer.ffn) for layer in model.layers}
    assert kinds == {ShortConvWeights, AttentionWeights, SwiGluWeights,
                     MoeWeights}
    tie = decoded["cfg"]["limits"]["route_margin_max"]
    numbers = compare_lfm2(decoded["w"], decoded["ids"], decoded["logits"],
                           decoded["routes"], "cpu", tie)
    assert numbers["logit_err_max"] < 1e-3, numbers
    assert numbers["top_gap_max"] == 0.0, numbers
    assert numbers["route_margin_max"] <= tie, numbers
    state = decoded["state"]
    assert state.pos == 4 and state.k.shape[2] == 4
    assert 0 < decoded["runner"].headroom() < 0.5


def test_decoding_equals_prefix_forward(decoded):
    """Two streams advanced together through the conv state and the KV
    cache (capacity 1, doubled twice): each token's logits against the
    reference's full forward over that stream's prefix."""
    runner, w = decoded["runner"], decoded["w"]
    ids = np.array([[7, 40], [11, 2], [64, 64]])
    logits, routes, state = _decode(runner, ids, capacity=1)
    assert state.k.shape[2] == 4 and state.pos == 3
    tie = decoded["cfg"]["limits"]["route_margin_max"]
    for t in range(len(ids)):
        ref, info = reference_logits(w, ids[:t + 1], "cpu",
                                     routes=routes[:t + 1], tie=tie)
        assert info["route_margin_max"] <= tie
        got = torch.as_tensor(logits[t])
        err = (torch.linalg.vector_norm(got - ref[-1], dim=-1)
               / torch.linalg.vector_norm(ref[-1], dim=-1))
        assert float(err.max()) < 1e-3, (t, err)


def test_expert_shares_add_up():
    """Runners holding experts 0-3 and 4-7 of the same 8: their MoE parts
    on the same inputs add up to the reference layer holding all 8, and
    each routes like the reference."""
    cfg = _cfg(range(8))
    w = make_weights(cfg, SEED + 1, "cpu")
    model = Lfm2Model.from_weights(w)
    layer = 2                                   # the first MoE layer
    x = np.random.default_rng(3).normal(size=(2, 64))
    want, sel = reference_moe(w, layer, x, "cpu")
    ctx = _ctx(seed=62)
    total = 0
    for share in (range(0, 4), range(4, 8)):
        r = Lfm2TokenRunner(ctx, model, experts=share)
        gen = torch.Generator().manual_seed(5)
        out, got_sel = r._moe(r._rows[layer][1], r.cw[layer],
                              torch.as_tensor(x, dtype=torch.float32), gen)
        assert torch.equal(torch.sort(got_sel).values,
                           torch.sort(sel).values)
        total = total + out.double()
    err = torch.linalg.vector_norm(total - want) / torch.linalg.vector_norm(
        want)
    assert float(err) < 1e-3, err


class _Recorder:
    """Stands in for a runner's ProjectionGraphs and records each server
    call's (projection, row, input shape)."""

    def __init__(self, graphs):
        self.graphs, self.calls = graphs, []

    def __call__(self, name, row, kern, c):
        self.calls.append((name, row, tuple(c.shape)))
        return self.graphs(name, row, kern, c)


def test_server_sequence_independent_of_routing(decoded):
    """Two tokens that route to different experts: the same projections,
    rows and shapes reach the server in the same order, and every held
    expert runs (4 up and 2 down matvecs an MoE layer) on both."""
    runner = decoded["runner"]
    graphs = runner._graphs
    seqs, routes = [], []
    try:
        for tok in (1, 77):
            runner._graphs = rec = _Recorder(graphs)
            before = MOE["expert_matvecs"]
            runner.generate_tokens_streams([tok], runner.zero_state(1))
            assert MOE["expert_matvecs"] - before == 2 * (4 + 2)
            seqs.append(rec.calls)
            routes.append(runner.last_routes)
    finally:
        runner._graphs = graphs
    assert not np.array_equal(routes[0], routes[1])
    assert seqs[0] == seqs[1]
    assert len(seqs[0]) == 4 * 4


def test_dropped_expert_fails_comparison(decoded, monkeypatch):
    """The client leaving out the held expert it routes to most often (its
    routing weight zeroed before the down projections) reads not correct
    under the cell's limits, where the sound run reads correct."""
    runner, w, cfg = decoded["runner"], decoded["w"], decoded["cfg"]
    limits = cfg["limits"]
    ids = decoded["ids"][:3]
    sound = compare_lfm2(w, ids, decoded["logits"][:3],
                         decoded["routes"][:3], "cpu",
                         limits["route_margin_max"])
    sound["tf32_switches_on"] = 0.0
    assert verdict(sound, limits)[0], sound
    held = decoded["routes"][..., None] == np.arange(4)
    drop = int(held.sum(axis=(0, 1, 2, 3)).argmax())
    route = Lfm2TokenRunner._route

    def dropping(self, wl, h):
        sel, r = route(self, wl, h)
        r = r.clone()
        r[:, drop] = 0
        return sel, r

    monkeypatch.setattr(Lfm2TokenRunner, "_route", dropping)
    logits, routes, _ = _decode(runner, ids, capacity=4)
    bad = compare_lfm2(w, ids, logits, routes, "cpu",
                       limits["route_margin_max"])
    bad["tf32_switches_on"] = 0.0
    assert not verdict(bad, limits)[0], bad


def test_encode_stack_and_matrix_count(decoded):
    """The device encode of a complex matrix's diagonals against the host
    encoder (one unit at most, in rare coefficients); the slot table
    against `extract_diagonals`; the staged matrices against the count of
    the step bound."""
    runner = decoded["runner"]
    rng = np.random.default_rng(8)
    m = rng.normal(size=(64, 64)) + 1j * rng.normal(size=(64, 64))
    slots = runner.ctx.slots
    want = np.tile(extract_diagonals(m, 64), (1, 1, slots // 64))
    got = diagonal_slots(torch.as_tensor(m), slots).numpy()
    np.testing.assert_array_equal(got, want)
    host = runner.eng.encode(m / PRESCALE).coeffs.astype(np.int64)
    dev = runner.encode_stack([m])[0].numpy().astype(np.int64)
    assert np.abs(dev - host).max() <= 1
    assert (dev != host).mean() < 1e-3
    staged = sum(v.shape[0] * v.shape[1] for v in runner.pt.values())
    assert staged == lfm2_step_bound(decoded["cfg"], 1)["matrices"] == 29


def test_rwkv_runner_words_unchanged():
    """The RWKV-7 runner on the shared device client: two seeded steps of
    two streams give the logits and states, bit for bit, of the runner
    before its crypto moved to `models/device_crypto.py`."""
    model = make_random_model(d=32, f=128, n_blocks=2, head_size=16,
                              vocab=64, seed=10)
    runner = DeviceTokenRunner(_ctx(), model, level=3)
    assert runner._seed == 1014346725490251206
    h = hashlib.sha256()
    states = [model.zero_state() for _ in range(2)]
    for toks in ([3, 17], [42, 5]):
        logits, states = runner.generate_tokens_streams(toks, states)
        h.update(np.ascontiguousarray(logits).tobytes())
        for s in states:
            for part in (s.x_prev_att, s.x_prev_ffn, s.wkv):
                h.update(np.ascontiguousarray(np.stack(part)).tobytes())
    assert h.hexdigest() == ("bbdf15f60a3c0c13c67b7dcf7bab5c1c"
                             "1c230181a165fd2214fba5ff6f6e15ea")
