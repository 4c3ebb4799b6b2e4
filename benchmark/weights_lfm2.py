"""Seeded random LFM2-MoE weights at a configuration's widths, made on the
device in one uniform draw a layer and handed to both sides as one plain
dict (the layout `Lfm2Model.from_weights` and `benchmark/reference/
lfm2.py` read).

Magnitudes (the configuration's `assumed`): projections [out, in] at
standard deviation 1/sqrt(in); RMSNorm gains in [0.6, 1.4]; the
depthwise conv kernel [D, L_cache] uniform in +-1/sqrt(L_cache) (torch's
Conv1d default for a fan-in of L_cache); the router [E, D] at 1/sqrt(D)
over every published expert; `expert_bias` at standard deviation 0.05;
the embedding at standard deviation 1 (the head is tied to it).  Of the
experts, only those the configuration holds (`experts_held`) get
weights.  Every array is float64 on the host.
"""

from __future__ import annotations

import math

import torch

from .weights import _draw, derive_seed

__all__ = ["lfm2_dims", "layer_layout", "make_weights"]


def lfm2_dims(cfg: dict) -> dict:
    """The configuration's sizes under short names.  Heads are D / head_dim
    and KV heads keep the published ratio to them (the published counts
    at the published widths; at a tiny D, as many as fit)."""
    d = cfg["hidden_size"]
    pub = cfg["num_attention_heads"]
    hd = cfg.get("head_dim") or d // pub
    heads = d // hd                     # the published count at D = 2048
    layers = cfg["num_hidden_layers"]
    return {"d": d, "f": cfg["intermediate_size"],
            "fe": cfg["moe_intermediate_size"], "heads": heads,
            "kv_heads": max(1, cfg["num_key_value_heads"] * heads // pub),
            "head_dim": hd,
            "vocab": cfg["vocab_size"], "layers": layers,
            "kinds": list(cfg["layer_types"][:layers]),
            "dense": cfg["num_dense_layers"],
            "router_experts": cfg["num_router_experts"],
            "experts": list(cfg["experts_held"]),
            "top_k": cfg["num_experts_per_tok"],
            "conv_len": cfg["conv_L_cache"]}


def layer_layout(cfg: dict, i: int) -> list:
    """(name, shape, low, high) of layer i's tensors, drawn uniformly."""
    m = lfm2_dims(cfg)
    d, hd = m["d"], m["head_dim"]
    s3 = math.sqrt(3.0)

    def sd(shape, s):
        return (shape, -s * s3, s * s3)

    def mat(o, i_):
        return sd((o, i_), 1.0 / math.sqrt(i_))

    out = [("operator_norm", (d,), 0.6, 1.4), ("ffn_norm", (d,), 0.6, 1.4)]
    if m["kinds"][i] == "conv":
        b = 1.0 / math.sqrt(m["conv_len"])
        out += [("in_proj",) + mat(3 * d, d),
                ("conv", (d, m["conv_len"]), -b, b),
                ("out_proj",) + mat(d, d)]
    else:
        q, kv = m["heads"] * hd, m["kv_heads"] * hd
        out += [("q_proj",) + mat(q, d), ("k_proj",) + mat(kv, d),
                ("v_proj",) + mat(kv, d), ("q_norm", (hd,), 0.6, 1.4),
                ("k_norm", (hd,), 0.6, 1.4), ("out_proj",) + mat(d, q)]
    if i < m["dense"]:
        f = m["f"]
        out += [("w1",) + mat(f, d), ("w3",) + mat(f, d),
                ("w2",) + mat(d, f)]
    else:
        e, fe, n = m["router_experts"], m["fe"], len(m["experts"])
        out += [("router",) + mat(e, d), ("expert_bias",) + sd((e,), 0.05),
                ("w1", (n, fe, d)) + mat(fe, d)[1:],
                ("w3", (n, fe, d)) + mat(fe, d)[1:],
                ("w2", (n, d, fe)) + mat(d, fe)[1:]]
    return out


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The whole model from seed: {"layers": [dict a layer], "emb",
    "final_norm", "meta"}."""
    m = lfm2_dims(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, 5))
    layers = []
    for i in range(m["layers"]):
        lw = _draw(layer_layout(cfg, i), gen, device)
        lw["kind"] = m["kinds"][i]
        lw["ffn"] = "dense" if i < m["dense"] else "moe"
        if lw["ffn"] == "moe":
            lw["experts"] = tuple(m["experts"])
        layers.append(lw)
    s3 = math.sqrt(3.0)
    top = _draw([("emb", (m["vocab"], m["d"]), -s3, s3),
                 ("final_norm", (m["d"],), 0.6, 1.4)], gen, device)
    meta = {"n_heads": m["heads"], "n_kv_heads": m["kv_heads"],
            "head_dim": m["head_dim"], "top_k": m["top_k"],
            "rope_theta": float(cfg["rope_theta"]),
            "norm_eps": float(cfg["norm_eps"]),
            "routed_scaling": float(cfg["routed_scaling_factor"]),
            "norm_topk": bool(cfg["norm_topk_prob"])}
    return dict(top, layers=layers, meta=meta)
