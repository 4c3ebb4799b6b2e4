"""Checkpoint / resume: keys, ciphertexts and generation state, in the
on-disk format of `fhe_spear_tpu/utils/serialization.py`, so that files
written by either package load in the other.

Format: numpy .npz (no pickle for array payloads), one file per object.
Residues are stored as uint32 words, as the reference writes its uint32
arrays, and loaded into the port's int64 tensors on the context's device.
Evaluation-domain arrays carry the context's bin-order tag ("stockham" or
"natural"), checked on load.  Secret keys are stored apart from evaluation
keys, so a server-side checkpoint never contains decryption capability.

Loading evaluation keys or a secret key into a context bumps its
`key_epoch`; an engine whose key stacks are older (`ops.bsgs.BsgsMatvec`,
`DiagonalMatvec`) rebuilds them before it evaluates.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["save_ciphertext", "load_ciphertext", "save_secret_key",
           "load_secret_key", "load_secret_key_into",
           "save_eval_keys", "load_eval_keys",
           "save_generation_state", "load_generation_state"]


def _words(t: torch.Tensor) -> np.ndarray:
    """Canonical int64 residues -> the uint32 words of the file format."""
    return t.cpu().numpy().astype(np.uint32)


def _order(ctx) -> str:
    return getattr(getattr(ctx, "ntt", None), "order", "stockham")


def _check_order(saved: str, ctx, what: str) -> None:
    cur = _order(ctx)
    if saved != cur:
        raise ValueError(
            f"{what} serialized from a {saved!r}-order context; this "
            f"context's NTT backend is {cur!r} -- eval-domain bin orders "
            "differ, the payload is not portable")


def save_ciphertext(path: str, ct, ctx=None) -> None:
    """ct arrays are EVAL-domain: their bin order depends on the context's
    NTT backend (stockham bit-reversed vs mxu natural), so the order is
    tagged and checked on load."""
    np.savez_compressed(path, c=_words(ct.c), scale=ct.scale,
                        order=np.bytes_(_order(ctx).encode()))


def load_ciphertext(path: str, ctx=None, device="cuda"):
    """A ciphertext on ctx's device (on `device` without a context)."""
    from ..ckks.ciphertext import Ciphertext
    from ..core.ntt import require_device

    z = np.load(path)
    saved = bytes(z["order"]).decode() if "order" in z else "stockham"
    if ctx is not None:
        _check_order(saved, ctx, "ciphertext was")
    dev = ctx.device if ctx is not None else require_device(device)
    return Ciphertext(torch.as_tensor(z["c"].astype(np.int64), device=dev),
                      float(z["scale"]))


def save_secret_key(path: str, ctx) -> None:
    np.savez_compressed(path, sk=ctx._sk_coeff, n=ctx.n, seed_note=0)


def load_secret_key(path: str, params, device="cuda"):
    """Restore a secret key into a FRESH context on `device` (preferred
    API): the relinearization key is generated from the restored secret."""
    from ..ckks.context import CkksContext

    z = np.load(path)
    ctx = CkksContext(params, sk_coeff=z["sk"], device=device)
    if int(z["n"]) != ctx.n:
        raise ValueError(f"secret key for N={int(z['n'])}, context N={ctx.n}")
    return ctx


def load_secret_key_into(path: str, ctx) -> None:
    """Restore a secret key into an existing context built with the same
    params (CkksContext.set_secret_key: the relinearization key is
    regenerated, Galois and identity keys are cleared, the key epoch is
    bumped)."""
    z = np.load(path)
    if int(z["n"]) != ctx.n:
        raise ValueError(f"secret key for N={int(z['n'])}, context N={ctx.n}")
    ctx.set_secret_key(z["sk"])


def save_eval_keys(path: str, ctx) -> None:
    """Persist the server's evaluation-key material: the relinearization
    key, every generated Galois rotation key, and (if built) the identity
    keyswitch key.  Deliberately EXCLUDES the secret key -- this is the
    bundle a restarting evaluation server loads; it confers no decryption
    capability.

    Format: uncompressed .npz -- keyswitch keys are uniform-random residue
    tensors, incompressible.  A context whose keys are limb-sharded holds
    only its rank's rows and raises: save from an unsharded context."""
    if ctx._key_shard is not None:
        raise ValueError("this context holds one rank's rows of the eval "
                         "keys (shard_eval_keys): save from an unsharded "
                         "context")
    arrs = {
        "relin_b": _words(ctx.relin_key.b),
        "relin_a": _words(ctx.relin_key.a),
        "galois_elts": np.asarray(sorted(ctx.galois_keys), dtype=np.int64),
        "n": np.int64(ctx.n), "L": np.int64(ctx.L), "K": np.int64(ctx.K),
        "dnum": np.int64(ctx.dnum),
        "order": np.bytes_(_order(ctx).encode()),
    }
    for g in sorted(ctx.galois_keys):
        k = ctx.galois_keys[g]
        arrs[f"gk{g}_b"] = _words(k.b)
        arrs[f"gk{g}_a"] = _words(k.a)
    if hasattr(ctx, "_identity_ksk"):
        arrs["id_b"] = _words(ctx._identity_ksk.b)
        arrs["id_a"] = _words(ctx._identity_ksk.a)
    np.savez(path, **arrs)


def load_eval_keys(path: str, ctx) -> None:
    """Install a saved evaluation-key bundle on a context built with the
    SAME params: the context's own relinearization, Galois and identity
    keys are replaced (an sk-less server context then evaluates bitwise
    identically to the key owner's), and the key epoch is bumped, so that
    an engine built before the load rebuilds its key stacks.  On a context
    whose keys are limb-sharded (`shard_eval_keys`), each loaded key is
    re-padded and cut to this rank's rows, as the context's own keys are."""
    from ..ckks.context import KeySwitchKey

    z = np.load(path)
    if (int(z["n"]), int(z["L"]), int(z["K"]), int(z["dnum"])) != (
            ctx.n, ctx.L, ctx.K, ctx.dnum):
        raise ValueError("eval-key bundle was built for different CKKS "
                         "params")
    _check_order(bytes(z["order"]).decode(), ctx, "eval keys were")

    def key(prefix):
        return ctx._place_key(KeySwitchKey(*(torch.as_tensor(
            z[f"{prefix}_{x}"].astype(np.int64), device=ctx.device)
            for x in ("b", "a"))))

    ctx.relin_key = key("relin")
    ctx.galois_keys.clear()
    for g in z["galois_elts"].tolist():
        ctx.galois_keys[int(g)] = key(f"gk{g}")
    if "id_b" in z:
        ctx._identity_ksk = key("id")
    else:
        ctx.__dict__.pop("_identity_ksk", None)
    ctx.key_epoch += 1


def save_generation_state(path: str, state, tokens: list[int]) -> None:
    """RWKV recurrent state + token history (resume mid-generation)."""
    np.savez_compressed(
        path,
        tokens=np.asarray(tokens, dtype=np.int64),
        n_blocks=len(state.wkv),
        **{f"xa{i}": a for i, a in enumerate(state.x_prev_att)},
        **{f"xf{i}": a for i, a in enumerate(state.x_prev_ffn)},
        **{f"wkv{i}": a for i, a in enumerate(state.wkv)},
    )


def load_generation_state(path: str):
    from ..models.rwkv7 import RwkvState

    z = np.load(path)
    nb = int(z["n_blocks"])
    state = RwkvState(
        x_prev_att=[z[f"xa{i}"] for i in range(nb)],
        x_prev_ffn=[z[f"xf{i}"] for i in range(nb)],
        wkv=[z[f"wkv{i}"] for i in range(nb)],
    )
    return state, z["tokens"].tolist()
