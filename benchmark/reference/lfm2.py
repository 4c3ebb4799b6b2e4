"""Plain LFM2-MoE forward in PyTorch: the yardstick the benchmark holds the
encrypted program's LFM2 logits against.

A frozen copy of the layer equations of Hugging Face `transformers`'
`lfm2_moe` modelling (LiquidAI LFM2-8B-A1B), the full causal forward of
each stream's ids at once, with no cache and no batching of streams:

    RMSNorm(x) = x * rsqrt(mean(x^2) + eps) * w
    h = x + mixer(operator_norm(x));  x' = h + ffn(ffn_norm(h))
    conv:       B, C, x = chunk3(x W_in^T);  Bx = B * x
                y[t] = C[t] * sum_k conv[:, k] * Bx[t - L + 1 + k]  (zeros
                before the first token); out = y W_out^T
    attention:  q = x W_q^T, k = x W_k^T, v = x W_v^T per head of hd;
                RMSNorm per head on q and k (q_layernorm, k_layernorm);
                RoPE (rotate-half, theta, positions 0..T-1); causal GQA
                softmax(q k^T / sqrt(hd)) v;  out = o W_out^T
    SwiGLU:     (silu(x W1^T) * x W3^T) W2^T
    MoE:        s = sigmoid(x W_router^T) over every expert; top k of
                s + expert_bias; r_i = s_i / (sum_sel s + 1e-6) * scale;
                out = sum over the selected experts held here of r_i E_i(x)
then embedding_norm and logits = x emb^T (the head tied to the embedding).

Departures from the published model: (1) of the experts, only those the
weights hold (one card's share of expert parallelism) add to the MoE
output; the router still scores and selects over every expert, and the
others' part is left out (what a card of the deployment computes); (2)
routing ties: where `routes` (the program's selected experts) is given
and differs from this forward's own top k, the given selection is taken
when the best expert it leaves out scores, by s + expert_bias in this
forward, at most `tie` above the worst expert it takes -- a top k is
discontinuous, and scores that near are equal to the precision compared
-- and `route_margin_max` reports the largest such excess (infinite for
a selection of another size or with a repeat); otherwise this forward's
own top k is used.

It imports torch and numpy only: nothing of the program or of any other
package of this repository.  Weights come in as the plain dict that
`benchmark/weights_lfm2.py` makes (numpy float64, projections [out, in]).
TF32 is switched off while it runs (and the switches restored after).

`precision`:
  * "float64": the reference.
  * "tf32": float32 elementwise, every product's inputs rounded to TF32's
    10-bit mantissa before a float32 product with TF32 off: a float32
    program with TF32 turned on.
  * "float16", "bfloat16": every tensor and every operation in that
    type.
The last three are the controls.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["PRECISIONS", "reference_logits", "reference_moe"]

PRECISIONS = ("float64", "tf32", "float16", "bfloat16")

_DTYPE = {"float64": torch.float64, "tf32": torch.float32,
          "float16": torch.float16, "bfloat16": torch.bfloat16}


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest float32 with a 10-bit mantissa (ties to
    even), as the tensor cores read TF32 inputs."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


class _Forward:
    def __init__(self, weights: dict, device, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.meta = weights["meta"]
        self.device = torch.device(device)
        self.dtype = _DTYPE[precision]
        self.tf32 = precision == "tf32"
        t = lambda a: torch.as_tensor(np.asarray(a), device=self.device
                                      ).to(self.dtype)
        self.layers = [{k: (t(a) if isinstance(a, np.ndarray) else a)
                        for k, a in lw.items()} for lw in weights["layers"]]
        self.emb = t(weights["emb"])
        self.final_norm = t(weights["final_norm"])

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x W^T for a weight W [out, in]."""
        if self.tf32:
            return _round_tf32(x) @ _round_tf32(w).T
        return x @ w.T

    def rms(self, x, w):
        eps = self.meta["norm_eps"]
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w

    def conv(self, lw, u):
        T, d = u.shape
        z = self.mm(u, lw["in_proj"])
        b, c, x = z[:, :d], z[:, d:2 * d], z[:, 2 * d:]
        bx = b * x
        kern = lw["conv"]                                  # [D, L]
        L = kern.shape[1]
        pad = torch.cat([torch.zeros((L - 1, d), dtype=bx.dtype,
                                     device=bx.device), bx])
        y = sum(pad[k:k + T] * kern[:, k] for k in range(L))
        return self.mm(c * y, lw["out_proj"])

    def attention(self, lw, u):
        m = self.meta
        T = u.shape[0]
        hd, H, KV = m["head_dim"], m["n_heads"], m["n_kv_heads"]
        q = self.rms(self.mm(u, lw["q_proj"]).reshape(T, H, hd),
                     lw["q_norm"])
        k = self.rms(self.mm(u, lw["k_proj"]).reshape(T, KV, hd),
                     lw["k_norm"])
        v = self.mm(u, lw["v_proj"]).reshape(T, KV, hd)
        inv = 1.0 / (m["rope_theta"] ** (
            torch.arange(0, hd, 2, dtype=torch.float64) / hd))
        ang = torch.arange(T, dtype=torch.float64)[:, None] * inv
        ang = torch.cat([ang, ang], dim=-1).to(self.device)
        cos = ang.cos().to(self.dtype)[:, None]
        sin = ang.sin().to(self.dtype)[:, None]

        def rope(t):
            h = hd // 2
            return t * cos + torch.cat([-t[..., h:], t[..., :h]], -1) * sin

        q, k = rope(q), rope(k)
        qg = q.reshape(T, KV, H // KV, hd)
        if self.tf32:
            qg, k, v = _round_tf32(qg), _round_tf32(k), _round_tf32(v)
        sc = torch.einsum("skgd,tkd->kgst", qg, k) / math.sqrt(hd)
        mask = torch.ones((T, T), dtype=torch.bool,
                          device=self.device).tril()
        sc = sc.masked_fill(~mask, float("-inf")).softmax(-1)
        if self.tf32:
            sc = _round_tf32(sc)
        o = torch.einsum("kgst,tkd->skgd", sc, v).reshape(T, H * hd)
        return self.mm(o, lw["out_proj"])

    def swiglu(self, x, w1, w3, w2):
        g = torch.nn.functional.silu(self.mm(x, w1)) * self.mm(x, w3)
        return self.mm(g, w2)

    def moe(self, lw, x, hint, tie, info):
        m = self.meta
        k = m["top_k"]
        s = torch.sigmoid(self.mm(x, lw["router"]))            # [T, E]
        key = s + lw["expert_bias"]
        own = torch.topk(key, k, dim=-1).indices
        sel = own
        if hint is not None:
            hint = torch.as_tensor(np.asarray(hint), device=self.device,
                                   dtype=torch.long)
            key64 = key.to(torch.float64)
            inp = torch.zeros_like(key64, dtype=torch.bool)
            if hint.shape[-1] == k:
                inp.scatter_(1, hint, True)
            valid = inp.sum(-1) == k
            low = key64.masked_fill(~inp, float("inf")).amin(-1)
            high = key64.masked_fill(inp, float("-inf")).amax(-1)
            margin = torch.where(valid, high - low,
                                 torch.full_like(low, float("inf")))
            same = (torch.sort(own, -1).values
                    == torch.sort(hint, -1).values).all(-1) if \
                hint.shape[-1] == k else torch.zeros_like(valid)
            margin = torch.where(same, torch.zeros_like(margin),
                                 margin.clamp(min=0.0))
            take = ~same & (margin <= tie)
            if hint.shape[-1] == k:
                sel = torch.where(take[:, None], hint, own)
            info["route_margin_max"] = max(info["route_margin_max"],
                                           float(margin.max()))
            info["route_swaps"] += int(take.sum())
        r = s.gather(1, sel)
        if m["norm_topk"]:
            r = r / (r.sum(-1, keepdim=True) + 1e-6)
        r = r * m["routed_scaling"]
        full = torch.zeros_like(s).scatter_(1, sel, r)
        out = torch.zeros_like(x)
        for i, e in enumerate(lw["experts"]):
            out = out + full[:, e:e + 1] * self.swiglu(
                x, lw["w1"][i], lw["w3"][i], lw["w2"][i])
        info["routes"].append(sel)
        return out

    def stream(self, ids, hints, tie, info):
        """Logits [T, V] of one stream's ids [T] (hints [T, n_moe, k] or
        None)."""
        x = self.emb[torch.as_tensor(np.asarray(ids), device=self.device)]
        mi = 0
        for lw in self.layers:
            u = self.rms(x, lw["operator_norm"])
            x = x + (self.conv(lw, u) if lw["kind"] == "conv"
                     else self.attention(lw, u))
            h = self.rms(x, lw["ffn_norm"])
            if lw["ffn"] == "moe":
                x = x + self.moe(lw, h, None if hints is None
                                 else hints[:, mi], tie, info)
                mi += 1
            else:
                x = x + self.swiglu(h, lw["w1"], lw["w3"], lw["w2"])
        x = self.rms(x, self.final_norm)
        emb = self.emb
        if self.tf32:
            return (_round_tf32(x) @ _round_tf32(emb).T).to(torch.float64)
        return (x @ emb.T).to(torch.float64)


def reference_logits(weights: dict, ids, device, precision: str = "float64",
                     routes=None, tie: float = 0.0) -> tuple:
    """(logits [T, S, V] float64 on device, info) for ids [T, S] from an
    empty state; routes: the program's selected experts [T, S, n_moe, k]
    (see the ties above) or None.  info: {"route_margin_max",
    "route_swaps", "routes" [T, S, n_moe, k] (this forward's selection,
    numpy)}."""
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    try:
        fwd = _Forward(weights, device, precision)
        ids = np.asarray(ids)
        info = {"route_margin_max": 0.0, "route_swaps": 0}
        outs, sels = [], []
        with torch.no_grad():
            for s in range(ids.shape[1]):
                info["routes"] = []
                hints = (None if routes is None
                         else np.asarray(routes)[:, s])
                outs.append(fwd.stream(ids[:, s], hints, tie, info))
                sels.append(torch.stack(info["routes"], 1).cpu().numpy()
                            if info["routes"] else
                            np.zeros((ids.shape[0], 0, 0), dtype=np.int64))
        info["routes"] = np.stack(sels, axis=1)
        return torch.stack(outs, dim=1), info
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = saved


def reference_moe(weights: dict, layer: int, x, device,
                  precision: str = "float64") -> tuple:
    """(out [T, D], selected [T, k]) of layer `layer`'s MoE FFN on x
    [T, D] (after its ffn_norm): the part of the experts the weights
    hold, routed over every expert."""
    fwd = _Forward(weights, device, precision)
    info = {"route_margin_max": 0.0, "route_swaps": 0, "routes": []}
    x = torch.as_tensor(np.asarray(x), device=fwd.device).to(fwd.dtype)
    with torch.no_grad():
        out = fwd.moe(fwd.layers[layer], x, None, 0.0, info)
    return out, info["routes"][0]
