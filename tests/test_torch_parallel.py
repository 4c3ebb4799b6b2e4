"""The port's multi-device modules against the JAX package, on 2 gloo ranks
on the CPU (one spawn for the file, each rank on one torch thread; the
reference runs on the conftest's 8-device CPU mesh meanwhile):

  * giant-sharded BSGS matvec (n=256, L=3, K=1, d=64, B=8): word for word
    against the reference's `ShardedBsgsMatvec` (its group 0 runs the
    identity keyswitch, so the single-device `BsgsMatvec` differs); the
    mxu backend to the reference test's bar;
  * the sharded server's explicit-transport token, token-exact;
  * the sharded fully-encrypted chain (the reference's fails on its
    missing `width`): its test's bars;
  * the limb-sharded rotation, K = 1 and 3, word for word against the
    reference's `ctx.rotate`;
  * the key-sharded chain (L=14, K=3, dnum=5): bitwise equal to the port's
    unsharded chain, and to it again after `load_eval_keys` into the
    sharded context;
  * `FourStepNtt.ntt_sharded`, word for word against the reference's
    `FourStepNtt.ntt`.

Every replicated result must come out equal on both ranks."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from fhe_spear_tpu.ckks import CkksContext, CkksParams
from fhe_spear_tpu.core.ntt import NttContext as RefNtt
from fhe_spear_tpu.core.primes import find_ntt_primes as ref_primes
from fhe_spear_tpu.parallel.ntt_fourstep import FourStepNtt as RefFourStep
from fhe_spear_tpu.parallel.sharded_bsgs import ShardedBsgsMatvec
from fhe_spear_tpu_torch.parallel.collectives import run_ranks
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


RANKS = 2
JOBS = [
    ("matvec", "giant_matvec", {"words": True}),
    ("mxu", "giant_matvec", {"ctx_seed": 1, "w_seed": 0, "backend": "mxu"}),
    ("token", "sharded_token", {}),
    ("chain", "sharded_chain", {}),
    ("limb1", "limb_rotate", {"special": 1, "words": True}),
    ("limb3", "limb_rotate", {"special": 3, "words": True}),
    ("keys", "key_sharded_chain", {"reload_keys": True}),
    ("ntt", "ntt_sharded", {"words": True}),
]


def _ref_matvec():
    ctx = CkksContext(CkksParams(n=256, num_limbs=3, num_special=1), seed=41)
    mesh = Mesh(np.array(jax.devices()), ("giant",))
    eng = ShardedBsgsMatvec(ctx, 64, mesh)
    rng = np.random.default_rng(3)
    w = rng.normal(0, 0.3, (64, 64))
    x = rng.normal(0, 1, 64)
    pt = eng.load(eng.encode(w), ctx.L)
    return np.asarray(eng(ctx.encrypt_replicated(x), pt).c)


def _ref_rotate(num_special):
    ctx = CkksContext(CkksParams(n=256, num_limbs=8, num_special=num_special),
                      seed=43 + num_special)
    ctx.ensure_galois([3])
    v = np.random.default_rng(5).uniform(-1, 1, ctx.slots)
    return np.asarray(ctx.rotate(ctx.encrypt(v), 3).c)


def _ref_ntt():
    ntt = RefNtt.build(256, ref_primes(256, 3))
    fs = RefFourStep(ntt, 16, 16)
    q = np.array([p.p for p in ntt.primes], dtype=np.int64)[:, None]
    x = np.random.default_rng(5).integers(0, q, (3, 256), dtype=np.int64)
    return np.asarray(jax.jit(fs.ntt)(jnp.asarray(x.astype(np.uint32))))


@pytest.fixture(scope="module")
def runs():
    """(port results by rank, reference words): the ranks run in their own
    processes while this one computes the reference's words."""
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(run_ranks, run_jobs, RANKS, "gloo", "cpu", 240.0,
                          JOBS, threads=1)
        ref = {"matvec": _ref_matvec(), "limb1": _ref_rotate(1),
               "limb3": _ref_rotate(3), "ntt": _ref_ntt()}
        return fut.result(), ref


def _agree(port, key, field="digest"):
    vals = {r[key][field] for r in port}
    assert len(vals) == 1, (key, vals)


def test_giant_sharded_matvec_word_for_word(runs):
    port, ref = runs
    r = port[0]["matvec"]
    _agree(port, "matvec")
    assert r["level"] == 2 and r["repeat_equal"]
    assert [p["matvec"]["groups"] for p in port] == [(0, 4), (4, 8)]
    assert r["err"] < 2e-3, r["err"]
    np.testing.assert_array_equal(r["words"], ref["matvec"].astype(np.int64))


def test_giant_sharded_matvec_mxu_backend(runs):
    port, _ = runs
    _agree(port, "mxu")
    assert port[0]["mxu"]["err"] < 5e-3, port[0]["mxu"]["err"]


def test_sharded_production_token(runs):
    port, _ = runs
    (t,) = port[0]["token"]["tokens"]
    assert t["ref"] == t["fhe"], t
    assert t["corr"] > 0.999, t
    assert {p["token"]["tokens"][0]["digest"] for p in port} == {t["digest"]}
    # one psum_mod per sharded matvec: 2 blocks x (3 + 1 + 2 + 2) matrices
    assert t["comm"]["calls"] == 16, t["comm"]


def test_sharded_fully_encrypted_chain(runs):
    port, _ = runs
    _agree(port, "chain")
    stats = port[0]["chain"]["stats"]
    assert len(stats) == 3
    assert stats[-1]["level"] == 11 - 9
    for s in stats:
        assert s["corr"] > 0.99999, stats
        assert s["max_err"] < 2e-4, stats


@pytest.mark.parametrize("num_special", [1, 3])
def test_limb_sharded_rotate_word_for_word(runs, num_special):
    port, ref = runs
    key = f"limb{num_special}"
    _agree(port, key)
    r = port[0][key]
    assert [p[key]["rows"] for p in port] == [(0, 1, 2, 3), (4, 5, 6, 7)]
    assert r["equal"], "limb-sharded rotation differs from ctx.rotate"
    np.testing.assert_array_equal(r["words"], ref[key].astype(np.int64))
    assert r["err"] < 1e-4, r["err"]


def test_key_sharded_chain_bitwise(runs):
    port, _ = runs
    _agree(port, "keys")
    r = port[0]["keys"]
    assert r["equal"] and r["scale_equal"], r
    assert r["level"] == 14 - 9
    # L+K = 17 rows, padded to 18: 9 rows a rank, in the keys and stacks
    assert r["key_rows"] == r["stack_rows"] == 9
    assert r["corr"] > 0.999999, r["corr"]
    assert r["sharded"]["comm"]["calls"] > 0


def test_load_eval_keys_into_key_sharded_context(runs):
    port, _ = runs
    assert all(p["keys"]["reload_equal"] for p in port)


def test_ntt_sharded_word_for_word(runs):
    port, ref = runs
    _agree(port, "ntt")
    r = port[0]["ntt"]
    assert r["equal"]
    np.testing.assert_array_equal(r["words"], ref["ntt"].astype(np.int64))
    assert r["sharded"]["comm"]["calls"] == 2   # one all_to_all, one gather


def test_sharded_server_refuses_the_fused_transport():
    from fhe_spear_tpu_torch.parallel.sharded_server import \
        ShardedFheRwkvServer

    with pytest.raises(NotImplementedError):
        ShardedFheRwkvServer.fused_project(None, "o", 0, None, 0)


def test_sharded_bsgs_needs_divisible_groups():
    from fhe_spear_tpu_torch.ckks.context import CkksContext as PortCtx
    from fhe_spear_tpu_torch.ckks.context import CkksParams as PortParams
    from fhe_spear_tpu_torch.parallel.collectives import RankGroup
    from fhe_spear_tpu_torch.parallel.sharded_bsgs import \
        ShardedBsgsMatvec as PortSharded

    ctx = PortCtx(PortParams(n=256, num_limbs=3, num_special=1), seed=1,
                  device="cpu")
    with pytest.raises(ValueError):
        PortSharded(ctx, 64, RankGroup(None, 0, 3, "cpu", "gloo"))


def test_keys_made_after_sharding_are_placed(tmp_path):
    """Keys made after `shard_eval_keys` (the identity key, new Galois
    keys) get the rank's rows and padding, as the reference's hooks do;
    a sharded context refuses to save its partial keys."""
    from fhe_spear_tpu_torch.ckks.context import CkksContext as PortCtx
    from fhe_spear_tpu_torch.ckks.context import CkksParams as PortParams
    from fhe_spear_tpu_torch.parallel.collectives import RankGroup
    from fhe_spear_tpu_torch.utils.serialization import save_eval_keys

    full = PortCtx(PortParams(n=256, num_limbs=4, num_special=1), seed=9,
                   device="cpu")
    ctx = PortCtx(PortParams(n=256, num_limbs=4, num_special=1), seed=9,
                  device="cpu")
    ctx.ensure_galois([1])
    full.ensure_galois([1])
    ctx.shard_eval_keys(RankGroup(None, 1, 2, "cpu", "gloo"))
    # L+K = 5 rows padded to 6: rank 1 holds rows 3, 4 and the pad row
    assert ctx.relin_key.b.shape[-2] == 3
    assert torch.equal(ctx.relin_key.b[:, :2], full.relin_key.b[:, 3:])
    assert not ctx.relin_key.b[:, 2].any()
    assert ctx._ks_targets(4) == (3, 4) and ctx._key_rows(4) == (0, 1)
    assert ctx._ks_targets(2) == (4,) and ctx._key_rows(2) == (1,)
    for c in (ctx, full):
        c.ensure_galois([2])
        c.identity_ksk()
    g = ctx.galois_element(2)
    for k, kf in ((ctx.galois_keys[g], full.galois_keys[g]),
                  (ctx.identity_ksk(), full.identity_ksk())):
        assert k.b.shape[-2] == 3
        assert torch.equal(k.a[:, :2], kf.a[:, 3:])
    with pytest.raises(ValueError):
        save_eval_keys(str(tmp_path / "k.npz"), ctx)
    with pytest.raises(ValueError):
        ctx.shard_eval_keys(RankGroup(None, 1, 2, "cpu", "gloo"))
