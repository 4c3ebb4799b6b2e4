"""RWKV-7 block weights + plaintext forward (the correctness oracle).

The port's own copy of `fhe_spear_tpu/models/rwkv7.py`: the float64 numpy
RWKV-7 ("Goose") single-token recurrence -- per-head state
S <- S*diag(decay) + outer(sa, kk*a) + outer(v, k), wkv = S @ r, GroupNorm,
r.k bonus term, sigmoid gates, ReLU^2 FFN -- and the client-side
nonlinearities of the client-aided protocol.  Vectorized over heads.

Weight truncation follows the head-size-preserving rule: keep the full
model's head_size, n_head = D // head_size.  Weights come from a real
RWKV-7 .pth (torch mmap) or from the seeded random generator used for
FHE-correctness testing.  `make_random_model`, `save_model` and
`load_model` are format-compatible with the reference's, so both packages
read the same model directory.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "RwkvBlockWeights",
    "RwkvModel",
    "layer_norm",
    "group_norm",
    "sigmoid",
    "plaintext_block",
    "generate_token_plaintext",
    "make_random_model",
    "load_torch_model",
    "save_model",
    "load_model",
]


def layer_norm(x, w, b, eps=1e-5):
    m = np.mean(x, axis=-1, keepdims=True)
    v = np.var(x, axis=-1, keepdims=True)
    return (x - m) / np.sqrt(v + eps) * w + b


def group_norm(x, n_groups, w, b, eps=64e-5):
    s = x.shape
    g = x.reshape(s[:-1] + (n_groups, -1))
    g = (g - g.mean(axis=-1, keepdims=True)) / np.sqrt(
        g.var(axis=-1, keepdims=True) + eps)
    return g.reshape(s) * w + b


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.clip(x, -500, 500)))


@dataclass
class RwkvBlockWeights:
    """One RWKV-7 block's tensors, all float64, projections as [in, out]."""

    block_idx: int
    d: int
    f: int
    n_head: int
    head_size: int
    # layer norms
    ln1_w: np.ndarray
    ln1_b: np.ndarray
    ln2_w: np.ndarray
    ln2_b: np.ndarray
    ln_x_w: np.ndarray
    ln_x_b: np.ndarray
    # token-mix coefficients
    x_r: np.ndarray
    x_k: np.ndarray
    x_v: np.ndarray
    x_g: np.ndarray
    x_w: np.ndarray
    x_a: np.ndarray
    x_k_ffn: np.ndarray
    # low-rank adapters
    w0: np.ndarray
    w1: np.ndarray
    w2: np.ndarray
    a0: np.ndarray
    a1: np.ndarray
    a2: np.ndarray
    v0: np.ndarray
    v1: np.ndarray
    v2: np.ndarray
    g1: np.ndarray
    g2: np.ndarray
    # per-channel constants
    k_k: np.ndarray
    k_a: np.ndarray
    r_k: np.ndarray          # [n_head, head_size]
    # projections [in, out]
    W_r: np.ndarray
    W_k: np.ndarray
    W_v: np.ndarray
    W_o: np.ndarray
    W_key_ffn: np.ndarray    # [D, F]
    W_val_ffn: np.ndarray    # [F, D]


@dataclass
class RwkvModel:
    blocks: list
    emb: np.ndarray          # [vocab, D]
    head_w: np.ndarray       # [D, vocab]
    ln_out_w: np.ndarray
    ln_out_b: np.ndarray
    ln0_w: np.ndarray
    ln0_b: np.ndarray

    @property
    def d(self):
        return self.blocks[0].d

    @property
    def n_head(self):
        return self.blocks[0].n_head

    @property
    def head_size(self):
        return self.blocks[0].head_size

    def zero_state(self, streams: int | None = None):
        nb, h, hs = len(self.blocks), self.n_head, self.head_size
        lead = () if streams is None else (streams,)
        return RwkvState(
            x_prev_att=[np.zeros(lead + (self.d,)) for _ in range(nb)],
            x_prev_ffn=[np.zeros(lead + (self.d,)) for _ in range(nb)],
            wkv=[np.zeros(lead + (h, hs, hs)) for _ in range(nb)],
        )


@dataclass
class RwkvState:
    """Per-block recurrent state threaded through token steps."""

    x_prev_att: list
    x_prev_ffn: list
    wkv: list

    def copy(self):
        return RwkvState([a.copy() for a in self.x_prev_att],
                         [a.copy() for a in self.x_prev_ffn],
                         [a.copy() for a in self.wkv])


# ---------------------------------------------------------------------------
# plaintext forward (the oracle every FHE path is verified against)
# ---------------------------------------------------------------------------

def token_mix(blk: RwkvBlockWeights, x_ln, x_prev):
    """x_ln + (x_prev - x_ln) * mix_coeff for the six attention mixes."""
    xx = x_prev - x_ln
    return {name: x_ln + xx * getattr(blk, "x_" + name)
            for name in ("r", "k", "v", "g", "w", "a")}


def wkv7_client(blk: RwkvBlockWeights, r, k, v, mixes, state, v_first):
    """Everything between the r/k/v matvecs and the W_o matvec: the full
    WKV-7 recurrence, GroupNorm, bonus term and g-gate — plaintext math the
    client runs.

    Returns (gated_out, new_state, v, v_first_out).
    """
    h, hs = blk.n_head, blk.head_size
    lead = r.shape[:-1]                       # leading stream dims (if any)
    hsplit = lead + (h, hs)
    rh = r.reshape(hsplit)

    w_vec = sigmoid(blk.w0 + np.tanh(mixes["w"] @ blk.w1) @ blk.w2)
    decay = np.exp(-np.exp(-0.5) * w_vec.reshape(hsplit))
    a_h = sigmoid(blk.a0 + (mixes["a"] @ blk.a1) @ blk.a2).reshape(hsplit)

    kk = (k * blk.k_k).reshape(hsplit)
    kk = kk / (np.linalg.norm(kk, axis=-1, keepdims=True) + 1e-12)
    k_h = k.reshape(hsplit) * (1.0 + (a_h - 1.0) * blk.k_a.reshape(h, hs))

    if blk.block_idx == 0:
        v_first_out = v.copy()
    else:
        v_gate = sigmoid(blk.v0 + (mixes["v"] @ blk.v1) @ blk.v2)
        v = v + (v_first - v) * v_gate
        v_first_out = v_first
    v_h = v.reshape(hsplit)

    # S <- S*diag(decay) + outer(S @ -kk, kk*a) + outer(v, k); wkv = S @ r
    sa = np.einsum("...hij,...hj->...hi", state, -kk)
    new_state = (state * decay[..., None, :]
                 + sa[..., :, None] * (kk * a_h)[..., None, :]
                 + v_h[..., :, None] * k_h[..., None, :])
    wkv = np.einsum("...hij,...hj->...hi", new_state, rh
                    ).reshape(lead + (h * hs,))
    wkv = group_norm(wkv, h, blk.ln_x_w, blk.ln_x_b)

    bonus = (rh * k_h * blk.r_k).sum(axis=-1, keepdims=True) * v_h
    wkv = wkv + bonus.reshape(lead + (h * hs,))

    g = sigmoid(mixes["g"] @ blk.g1) @ blk.g2
    return wkv * g, new_state, v, v_first_out


def plaintext_block(blk: RwkvBlockWeights, x, x_prev_att, x_prev_ffn, state,
                    v_first):
    """Full plaintext block (the plaintext oracle)."""
    x_ln = layer_norm(x, blk.ln1_w, blk.ln1_b)
    mixes = token_mix(blk, x_ln, x_prev_att)

    r = mixes["r"] @ blk.W_r
    k = mixes["k"] @ blk.W_k
    v = mixes["v"] @ blk.W_v
    gated, new_state, v, v_first = wkv7_client(blk, r, k, v, mixes, state,
                                               v_first)
    x = x + gated @ blk.W_o

    x_ffn_ln = layer_norm(x, blk.ln2_w, blk.ln2_b)
    xk_ffn = x_ffn_ln + (x_prev_ffn - x_ffn_ln) * blk.x_k_ffn
    fk = np.maximum(xk_ffn @ blk.W_key_ffn, 0.0) ** 2
    x = x + fk @ blk.W_val_ffn
    return x, x_ln, x_ffn_ln, new_state, v_first


def generate_token_plaintext(model: RwkvModel, token_id,
                             state: RwkvState):
    """One plaintext token step; mutates a copy of state, returns logits.
    token_id may be an int or an int array [streams] (batched mode)."""
    x = layer_norm(np.array(model.emb[token_id]), model.ln0_w, model.ln0_b)
    new = state.copy()
    v_first = None
    for i, blk in enumerate(model.blocks):
        x, xpa, xpf, s, v_first = plaintext_block(
            blk, x, state.x_prev_att[i], state.x_prev_ffn[i], state.wkv[i],
            v_first)
        new.x_prev_att[i], new.x_prev_ffn[i], new.wkv[i] = xpa, xpf, s
    logits = layer_norm(x, model.ln_out_w, model.ln_out_b) @ model.head_w
    return logits, new


# ---------------------------------------------------------------------------
# weight construction
# ---------------------------------------------------------------------------

def make_random_model(d=64, f=256, n_blocks=2, head_size=16, vocab=64,
                      seed=42) -> RwkvModel:
    """Seeded random weights with realistic magnitudes -- decouples FHE
    correctness testing from model downloads."""
    # legacy RandomState + uniform weights: the PCG64 Generator's normal()
    # is ~50x slower in some numpy builds, and weight distribution shape is
    # irrelevant for FHE-correctness testing — match the std only.
    rs = np.random.RandomState(seed)
    n_head = d // head_size
    lora = min(96, d)

    def _unif(shape, s, loc=0.0):
        shape = (shape,) if np.isscalar(shape) else tuple(shape)
        return (rs.rand(*shape) * 2.0 - 1.0) * (s * np.sqrt(3.0)) + loc

    def mat(i, o, s=None):
        return _unif((i, o), 1.0 / np.sqrt(i) if s is None else s)

    class _R:
        @staticmethod
        def normal(loc, s, size=None):
            return _unif(size if size is not None else (), s, loc)

        @staticmethod
        def uniform(a, b, size=None):
            shape = (size,) if np.isscalar(size) else tuple(size or ())
            return rs.rand(*shape) * (b - a) + a

    rng = _R()

    blocks = []
    for bi in range(n_blocks):
        blocks.append(RwkvBlockWeights(
            block_idx=bi, d=d, f=f, n_head=n_head, head_size=head_size,
            ln1_w=rng.uniform(0.6, 1.4, d), ln1_b=rng.normal(0, 0.1, d),
            ln2_w=rng.uniform(0.6, 1.4, d), ln2_b=rng.normal(0, 0.1, d),
            ln_x_w=rng.uniform(0.6, 1.4, d), ln_x_b=rng.normal(0, 0.1, d),
            x_r=rng.uniform(0, 1, d), x_k=rng.uniform(0, 1, d),
            x_v=rng.uniform(0, 1, d), x_g=rng.uniform(0, 1, d),
            x_w=rng.uniform(0, 1, d), x_a=rng.uniform(0, 1, d),
            x_k_ffn=rng.uniform(0, 1, d),
            w0=rng.normal(0, 0.5, d), w1=mat(d, lora), w2=mat(lora, d),
            a0=rng.normal(0, 0.5, d), a1=mat(d, lora), a2=mat(lora, d),
            v0=rng.normal(0, 0.5, d), v1=mat(d, lora), v2=mat(lora, d),
            g1=mat(d, lora), g2=mat(lora, d),
            k_k=rng.normal(0, 0.5, d), k_a=rng.uniform(0, 1, d),
            r_k=rng.normal(0, 0.5, (n_head, head_size)),
            W_r=mat(d, d), W_k=mat(d, d), W_v=mat(d, d), W_o=mat(d, d),
            W_key_ffn=mat(d, f), W_val_ffn=mat(f, d),
        ))
    return RwkvModel(
        blocks=blocks,
        emb=rng.normal(0, 1, (vocab, d)),
        head_w=mat(d, vocab),
        ln_out_w=rng.uniform(0.6, 1.4, d), ln_out_b=rng.normal(0, 0.1, d),
        ln0_w=rng.uniform(0.6, 1.4, d), ln0_b=rng.normal(0, 0.1, d),
    )


def load_torch_model(path: str, d: int, f: int, n_blocks: int) -> RwkvModel:
    """Load a real RWKV-7 checkpoint (torch mmap) with head-size-preserving
    truncation."""
    import torch

    w = torch.load(path, map_location="cpu", mmap=True)
    full_d = w["emb.weight"].shape[1]
    full_n_head = w["blocks.0.att.r_k"].shape[0]
    full_hs = full_d // full_n_head
    n_head = min(full_n_head, max(1, d // full_hs))
    hs = d // n_head
    d = n_head * hs

    def np64(t):
        return t.float().numpy().astype(np.float64)

    blocks = []
    for bi in range(n_blocks):
        b = f"blocks.{bi}."
        has_v = b + "att.v0" in w
        lora_w = w[b + "att.w1"].shape[1]
        blocks.append(RwkvBlockWeights(
            block_idx=bi, d=d, f=f, n_head=n_head, head_size=hs,
            ln1_w=np64(w[b + "ln1.weight"][:d]), ln1_b=np64(w[b + "ln1.bias"][:d]),
            ln2_w=np64(w[b + "ln2.weight"][:d]), ln2_b=np64(w[b + "ln2.bias"][:d]),
            ln_x_w=np64(w[b + "att.ln_x.weight"][:d]),
            ln_x_b=np64(w[b + "att.ln_x.bias"][:d]),
            x_r=np64(w[b + "att.x_r"].squeeze()[:d]),
            x_k=np64(w[b + "att.x_k"].squeeze()[:d]),
            x_v=np64(w[b + "att.x_v"].squeeze()[:d]),
            x_g=np64(w[b + "att.x_g"].squeeze()[:d]),
            x_w=np64(w[b + "att.x_w"].squeeze()[:d]),
            x_a=np64(w[b + "att.x_a"].squeeze()[:d]),
            x_k_ffn=np64(w[b + "ffn.x_k"].squeeze()[:d]),
            # w0/a0/v0 are stored (1,1,C) in real RWKV-7 checkpoints;
            # squeeze before truncation
            w0=np64(w[b + "att.w0"].squeeze()[:d]),
            w1=np64(w[b + "att.w1"][:d, :]), w2=np64(w[b + "att.w2"][:, :d]),
            a0=np64(w[b + "att.a0"].squeeze()[:d]),
            a1=np64(w[b + "att.a1"][:d, :]), a2=np64(w[b + "att.a2"][:, :d]),
            v0=np64(w[b + "att.v0"].squeeze()[:d]) if has_v else np.zeros(d),
            v1=np64(w[b + "att.v1"][:d, :]) if has_v else np.zeros((d, 64)),
            v2=np64(w[b + "att.v2"][:, :d]) if has_v else np.zeros((64, d)),
            g1=np64(w[b + "att.g1"][:d, :]), g2=np64(w[b + "att.g2"][:, :d]),
            k_k=np64(w[b + "att.k_k"].squeeze()[:d]),
            k_a=np64(w[b + "att.k_a"].squeeze()[:d]),
            r_k=np64(w[b + "att.r_k"][:n_head, :hs]),
            # checkpoint stores [out, in]; transpose to [in, out]
            W_r=np64(w[b + "att.receptance.weight"]).T[:d, :d],
            W_k=np64(w[b + "att.key.weight"]).T[:d, :d],
            W_v=np64(w[b + "att.value.weight"]).T[:d, :d],
            W_o=np64(w[b + "att.output.weight"]).T[:d, :d],
            W_key_ffn=np64(w[b + "ffn.key.weight"]).T[:d, :f],
            W_val_ffn=np64(w[b + "ffn.value.weight"]).T[:f, :d],
        ))
    return RwkvModel(
        blocks=blocks,
        emb=np64(w["emb.weight"][:, :d]),
        head_w=np64(w["head.weight"]).T[:d, :],
        ln_out_w=np64(w["ln_out.weight"][:d]), ln_out_b=np64(w["ln_out.bias"][:d]),
        ln0_w=np64(w["blocks.0.ln0.weight"][:d]),
        ln0_b=np64(w["blocks.0.ln0.bias"][:d]),
    )


def save_model(path: str, model: RwkvModel) -> None:
    """Cache a model as a directory of raw .npy files — np.load of a
    multi-GB npz is CRC-bound (slower than regenerating on a weak host);
    bare .npy files load via mmap with no checksum pass."""
    import os

    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, "meta.npy"), np.array([len(model.blocks)]))
    for name in ("emb", "head_w", "ln_out_w", "ln_out_b", "ln0_w", "ln0_b"):
        np.save(os.path.join(path, name + ".npy"), getattr(model, name))
    for i, b in enumerate(model.blocks):
        np.save(os.path.join(path, f"b{i}_dims.npy"),
                np.array([b.d, b.f, b.n_head, b.head_size]))
        for f in _BLOCK_FIELDS:
            np.save(os.path.join(path, f"b{i}_{f}.npy"), getattr(b, f))


def load_model(path: str) -> RwkvModel:
    import os

    ld = lambda name: np.load(os.path.join(path, name + ".npy"),
                              mmap_mode="r")
    nb = int(np.load(os.path.join(path, "meta.npy"))[0])
    blocks = []
    for i in range(nb):
        d, f, nh, hs = (int(v) for v in np.load(
            os.path.join(path, f"b{i}_dims.npy")))
        blocks.append(RwkvBlockWeights(
            block_idx=i, d=d, f=f, n_head=nh, head_size=hs,
            **{fl: ld(f"b{i}_{fl}") for fl in _BLOCK_FIELDS}))
    return RwkvModel(blocks=blocks, emb=ld("emb"), head_w=ld("head_w"),
                     ln_out_w=ld("ln_out_w"), ln_out_b=ld("ln_out_b"),
                     ln0_w=ld("ln0_w"), ln0_b=ld("ln0_b"))


_BLOCK_FIELDS = [
    "ln1_w", "ln1_b", "ln2_w", "ln2_b", "ln_x_w", "ln_x_b",
    "x_r", "x_k", "x_v", "x_g", "x_w", "x_a", "x_k_ffn",
    "w0", "w1", "w2", "a0", "a1", "a2", "v0", "v1", "v2", "g1", "g2",
    "k_k", "k_a", "r_k",
    "W_r", "W_k", "W_v", "W_o", "W_key_ffn", "W_val_ffn",
]
