"""LFM2-MoE (LiquidAI LFM2-8B-A1B) decoding, client-aided on the device.

The layer equations are those of Hugging Face `transformers`' `lfm2_moe`
modelling:

    RMSNorm(x) = x * rsqrt(mean(x^2) + eps) * w
    h = x + mixer(operator_norm(x));  out = h + ffn(ffn_norm(h))
    conv mixer:  B, C, x = chunk3(in_proj u);  y = C * conv3(B * x)
                 (causal depthwise, kernel L_cache = 3, no bias); out_proj y
    attention:   q, k, v = q_proj u, k_proj u, v_proj u; RMSNorm per head
                 on q and k; RoPE (rotate-half); GQA softmax(q k^T / sqrt(hd))
                 v over the cache; out_proj
    SwiGLU:      w2(silu(w1 x) * w3 x)   (dense layers, and each expert)
    router:      s = sigmoid(W_router x) over every expert; the top k by
                 s + expert_bias; weights s_i / (sum s_sel + 1e-6) * scale
and after the last layer `embedding_norm`, then the head tied to the
embedding.

Protocol.  Every weight matrix is the server's: staged once as BSGS
diagonals (`DeviceClient.encode_stack`, int32 / PRESCALE) and evaluated
on ciphertexts.  Each layer makes four encrypted round trips -- mixer in,
mixer out, FFN in, FFN out -- and the client (here on the same card, in
float32 with TF32 off) does everything between them: norms, the short
convolution and its state, RoPE and attention over its KV cache, SwiGLU
gates, and the routing.  Matrices narrower than D are zero-padded to
D x D; two real matrices share one complex one:
  * conv in:    [W_B + i W_C, W_x], both on one ciphertext ("shared");
  * attention:  W_q + i [W_k; W_v];
  * SwiGLU up:  W1_c + i W3_c for each D-row chunk c of the width, all on
                one ciphertext ("shared");
  * SwiGLU down: W2_a - i W2_b on g_a + i g_b, whose real part is
                W2_a g_a + W2_b g_b (conjugate pairs of chunks).
The MoE layer is told which experts it holds (`experts`).  The router
and `expert_bias` are client weights: the client routes over every
expert, and the server evaluates every held expert on every token -- one
"shared" call of all their up matrices, then the down pairs, whose inputs
the client has scaled by its routing weights (zero for an expert it did
not route to) -- so the server's sequence of projections is a function of
the configuration alone, and it never learns the routing.  What the
experts held elsewhere would add is left out (one card's share of expert
parallelism).

The state (`Lfm2State`) stays on the device between tokens: each conv
layer's last L_cache - 1 values of B * x, and each attention layer's KV
cache, which grows by one position a token.  Embedding, final norm and
head run on the host in float64.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..ckks.context import CkksContext
from ..ckks.device_encrypt import _generator
from ..utils.profiling import MOE, MOE_TIMER, span
from .device_crypto import DeviceClient

__all__ = ["ShortConvWeights", "AttentionWeights", "SwiGluWeights",
           "MoeWeights", "Lfm2Layer", "Lfm2Model", "Lfm2State",
           "Lfm2TokenRunner"]


@dataclass
class ShortConvWeights:
    in_proj: np.ndarray           # [3D, D]: B, C, x rows
    conv: np.ndarray              # [D, L_cache] depthwise kernel
    out_proj: np.ndarray          # [D, D]


@dataclass
class AttentionWeights:
    q_proj: np.ndarray            # [H * hd, D]
    k_proj: np.ndarray            # [KV * hd, D]
    v_proj: np.ndarray            # [KV * hd, D]
    q_norm: np.ndarray            # [hd]
    k_norm: np.ndarray            # [hd]
    out_proj: np.ndarray          # [D, H * hd]


@dataclass
class SwiGluWeights:
    w1: np.ndarray                # [F, D] gate
    w3: np.ndarray                # [F, D] up
    w2: np.ndarray                # [D, F] down


@dataclass
class MoeWeights:
    router: np.ndarray            # [E, D], every expert
    expert_bias: np.ndarray       # [E]
    experts: tuple                # ids of the experts whose weights follow
    w1: np.ndarray                # [len(experts), Fe, D]
    w3: np.ndarray                # [len(experts), Fe, D]
    w2: np.ndarray                # [len(experts), D, Fe]


@dataclass
class Lfm2Layer:
    mixer: ShortConvWeights | AttentionWeights
    ffn: SwiGluWeights | MoeWeights
    operator_norm: np.ndarray     # [D]
    ffn_norm: np.ndarray          # [D]


@dataclass
class Lfm2Model:
    layers: list
    emb: np.ndarray               # [V, D]; the head is tied to it
    final_norm: np.ndarray        # [D] (`embedding_norm`)
    n_heads: int
    n_kv_heads: int
    head_dim: int
    top_k: int
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    routed_scaling: float = 1.0
    norm_topk: bool = True

    @property
    def d(self) -> int:
        return self.emb.shape[1]

    @classmethod
    def from_weights(cls, w: dict) -> "Lfm2Model":
        """From the plain dict of arrays {"emb", "final_norm", "meta",
        "layers": [{"kind": "conv" | "full_attention", "ffn": "dense" |
        "moe", "operator_norm", "ffn_norm", and the kind's arrays under
        the dataclasses' field names}]}; meta holds n_heads, n_kv_heads,
        head_dim, top_k, rope_theta, norm_eps, routed_scaling, norm_topk."""
        def pick(kls, lw):
            return kls(**{k: lw[k] for k in kls.__dataclass_fields__})

        layers = []
        for lw in w["layers"]:
            mixer = pick(ShortConvWeights if lw["kind"] == "conv"
                         else AttentionWeights, lw)
            ffn = pick(MoeWeights if lw["ffn"] == "moe" else SwiGluWeights,
                       lw)
            layers.append(Lfm2Layer(mixer, ffn, lw["operator_norm"],
                                    lw["ffn_norm"]))
        return cls(layers=layers, emb=w["emb"], final_norm=w["final_norm"],
                   **w["meta"])


@dataclass
class Lfm2State:
    """S streams' decoding state on the device: conv [S, n_conv, L-1, D]
    (the last B * x of each conv layer, oldest first), k and v
    [S, n_attn, capacity, KV, hd] (post-norm, post-RoPE keys), and the
    number of tokens decoded so far."""
    conv: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    pos: int = 0

    def _grow(self) -> None:
        cap = self.k.shape[2]
        pad = lambda t: torch.cat([t, torch.zeros_like(t)], dim=2)
        if self.pos >= cap:
            self.k, self.v = pad(self.k), pad(self.v)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rms_np(x: np.ndarray, w: np.ndarray, eps: float) -> np.ndarray:
    return x / np.sqrt((x * x).mean(-1, keepdims=True) + eps) * w


def _amax(v: torch.Tensor) -> torch.Tensor:
    """Per-stream sup norm [S, 1, ...] (at least 1e-9)."""
    S = v.shape[0]
    m = torch.clamp(v.abs().reshape(S, -1).amax(-1), min=1e-9)
    return m.reshape((S,) + (1,) * (v.dim() - 1))


class Lfm2TokenRunner(DeviceClient):
    """One FHE token of an LFM2-MoE model (every layer x 4 round trips,
    client math included) on the context's device for S streams at once.
    `experts`: the experts this runner's MoE layers hold (default every
    expert the model's weights hold)."""

    def __init__(self, ctx: CkksContext, model: Lfm2Model, level: int = 3,
                 experts=None):
        super().__init__(ctx, model.d, level, track_headroom=True)
        self.model = model
        d = self.d
        kinds = [type(layer.mixer) for layer in model.layers]
        self.n_conv = kinds.count(ShortConvWeights)
        self.n_attn = kinds.count(AttentionWeights)
        moes = [layer.ffn for layer in model.layers
                if isinstance(layer.ffn, MoeWeights)]
        held = tuple(moes[0].experts) if moes else ()
        self.experts = tuple(held if experts is None else experts)
        if any(e not in held for e in self.experts):
            raise ValueError(f"experts {self.experts} not all among the "
                             f"held {held}")
        if 2 * model.n_kv_heads * model.head_dim > d or \
                model.n_heads * model.head_dim != d:
            raise ValueError("q_proj must be D x D and [k; v] at most D rows")
        self.conv_len = (model.layers[kinds.index(ShortConvWeights)].mixer
                         .conv.shape[1] if self.n_conv else 1)
        # D-row chunks of an expert's width
        self.expert_chunks = -(-moes[0].w1.shape[1] // d) if moes else 0
        self._shared = {"conv_in", "dense_up", "moe_up"}
        self._rows: list = []             # (mixer row, ffn row) a layer
        self._build_server_stacks()
        self._build_client_weights()
        hd = model.head_dim
        self._inv_freq = 1.0 / (model.rope_theta ** (torch.arange(
            0, hd, 2, dtype=torch.float64, device=self.device) / hd))
        self.last_routes = None

    # -- server-side staging ----------------------------------------------

    def _mat(self, a) -> torch.Tensor:
        """A weight [r, c] (r, c <= D) as a float64 D x D device matrix,
        zero-padded."""
        a = torch.as_tensor(np.asarray(a), device=self.device,
                            dtype=torch.float64)
        m = torch.zeros((self.d, self.d), dtype=torch.float64,
                        device=self.device)
        m[:a.shape[0], :a.shape[1]] = a
        return m

    def _swiglu_mats(self, w1s, w3s, w2s):
        """Up matrices (W1_c + i W3_c over the D-row chunks of every
        expert's width, in order) and down pairs (W2_a - i W2_b over
        consecutive chunks) of SwiGLUs [E, F, D] / [E, D, F]."""
        d = self.d
        up, cols = [], []
        for w1, w3, w2 in zip(w1s, w3s, w2s):
            for c0 in range(0, w1.shape[0], d):
                up.append(torch.complex(self._mat(w1[c0:c0 + d]),
                                        self._mat(w3[c0:c0 + d])))
                cols.append(w2[:, c0:c0 + d])
        down = []
        for a in range(0, len(cols), 2):
            b = (self._mat(cols[a + 1]) if a + 1 < len(cols)
                 else torch.zeros_like(up[0].real))
            down.append(torch.complex(self._mat(cols[a]), -b))
        return up, down

    def _build_server_stacks(self):
        stacks: dict = {}

        def stage(name, mats):
            stacks.setdefault(name, []).append(self.encode_stack(mats))
            return len(stacks[name]) - 1

        m = self.model
        for layer in m.layers:
            mx, ff = layer.mixer, layer.ffn
            if isinstance(mx, ShortConvWeights):
                d = self.d
                bc = torch.complex(self._mat(mx.in_proj[:d]),
                                   self._mat(mx.in_proj[d:2 * d]))
                row = stage("conv_in", [bc, self._mat(mx.in_proj[2 * d:])])
                stage("conv_out", [self._mat(mx.out_proj)])
            else:
                kv = np.concatenate([mx.k_proj, mx.v_proj])
                row = stage("attn_qkv", [torch.complex(
                    self._mat(mx.q_proj), self._mat(kv))])
                stage("attn_out", [self._mat(mx.out_proj)])
            if isinstance(ff, MoeWeights):
                idx = [list(ff.experts).index(e) for e in self.experts]
                up, down = self._swiglu_mats(ff.w1[idx], ff.w3[idx],
                                             ff.w2[idx])
                frow = stage("moe_up", up)
                stage("moe_down", down)
            else:
                up, down = self._swiglu_mats([ff.w1], [ff.w3], [ff.w2])
                frow = stage("dense_up", up)
                stage("dense_down", down)
            self._rows.append((row, frow))
        # device-resident int32 stacks [rows, P, B, G, N]
        self.pt = {k: torch.stack(v) for k, v in stacks.items()}

    # -- client weights, float32 on the device -------------------------------

    def _build_client_weights(self):
        f32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32),
                                        device=self.device)
        self.cw = []
        for layer in self.model.layers:
            w = {"operator_norm": f32(layer.operator_norm),
                 "ffn_norm": f32(layer.ffn_norm)}
            mx, ff = layer.mixer, layer.ffn
            if isinstance(mx, ShortConvWeights):
                w["conv"] = f32(mx.conv)
            else:
                w["q_norm"], w["k_norm"] = f32(mx.q_norm), f32(mx.k_norm)
            if isinstance(ff, MoeWeights):
                w["router"] = f32(ff.router)
                w["expert_bias"] = f32(ff.expert_bias)
                w["held"] = torch.as_tensor(self.experts, dtype=torch.long,
                                            device=self.device)
            self.cw.append(w)

    # -- state ------------------------------------------------------------

    def zero_state(self, streams: int, capacity: int = 64) -> Lfm2State:
        """S streams at position 0, the KV cache sized for `capacity`
        tokens (it doubles when full)."""
        m, dev = self.model, self.device
        kv = (streams, self.n_attn, capacity, m.n_kv_heads, m.head_dim)
        return Lfm2State(
            conv=torch.zeros((streams, self.n_conv, self.conv_len - 1,
                              self.d), dtype=torch.float32, device=dev),
            k=torch.zeros(kv, dtype=torch.float32, device=dev),
            v=torch.zeros(kv, dtype=torch.float32, device=dev))

    # -- the round trips --------------------------------------------------

    def _send(self, name, j, x, gen):
        """Project real or complex rows x [S, b, <= D] (normalised by their
        per-stream sup norm, multiplied back) -> [S, b', D] complex."""
        d = self.d
        mag = _amax(x)
        rows = torch.zeros(x.shape[:-1] + (d,), dtype=torch.complex64,
                           device=self.device)
        rows[..., :x.shape[-1]] = x / mag
        out = self._project(name, j, self._tile(rows), gen)
        return out[..., :d] * mag

    def _conv(self, j, w, u, state, gen):
        """Conv mixer of conv row j (client weights w) on u [S, D]."""
        z = self._send("conv_in", j, u[:, None], gen)          # [S, 2, D]
        with span("client.conv"):
            b, c, xx = z[:, 0].real, z[:, 0].imag, z[:, 1].real
            win = torch.cat([state.conv[:, j], (b * xx)[:, None]], dim=1)
            state.conv[:, j] = win[:, 1:]
            y = c * (win * w["conv"].T[None]).sum(1)
        return self._send("conv_out", j, y[:, None], gen)[:, 0].real

    def _rope(self, t: torch.Tensor, pos: int) -> torch.Tensor:
        ang = torch.cat([pos * self._inv_freq] * 2)     # float64, on device
        cos, sin = ang.cos().float(), ang.sin().float()
        h = t.shape[-1] // 2
        rot = torch.cat([-t[..., h:], t[..., :h]], dim=-1)
        return t * cos + rot * sin

    def _attn(self, j, w, u, state, gen):
        """Attention mixer of attention row j (client weights w) on u
        [S, D] at state.pos."""
        m = self.model
        S, hd, kvh = u.shape[0], m.head_dim, m.n_kv_heads
        z = self._send("attn_qkv", j, u[:, None], gen)[:, 0]   # [S, D]
        with span("client.attn"):
            eps = m.norm_eps
            q = _rms(z.real.reshape(S, m.n_heads, hd), w["q_norm"], eps)
            kv = z.imag[:, :2 * kvh * hd]
            k = _rms(kv[:, :kvh * hd].reshape(S, kvh, hd), w["k_norm"], eps)
            v = kv[:, kvh * hd:].reshape(S, kvh, hd)
            pos = state.pos
            q, k = self._rope(q, pos), self._rope(k, pos)
            state.k[:, j, pos], state.v[:, j, pos] = k, v
            keys, vals = state.k[:, j, :pos + 1], state.v[:, j, :pos + 1]
            qg = q.reshape(S, kvh, m.n_heads // kvh, hd)
            sc = torch.einsum("skgd,stkd->skgt", qg, keys) / math.sqrt(hd)
            att = torch.einsum("skgt,stkd->skgd", sc.softmax(-1), vals)
        return self._send("attn_out", j, att.reshape(S, -1)[:, None],
                          gen)[:, 0].real

    def _swiglu(self, up, down, j, h, gen, scale=None):
        """SwiGLU round trips: up chunks on h [S, D], gates, optional
        per-chunk scale [S, C], down pairs -> [S, D]."""
        z = self._send(up, j, h[:, None], gen)                 # [S, C, D]
        with span("client.math"):
            g = torch.nn.functional.silu(z.real) * z.imag
            if scale is not None:
                g = g * scale[..., None]
            if g.shape[1] % 2:
                g = torch.cat([g, torch.zeros_like(g[:, :1])], dim=1)
            gp = torch.complex(g[:, 0::2], g[:, 1::2])
        return self._send(down, j, gp, gen).real.sum(1)

    def _route(self, w, h):
        """Routing over every expert: (selected ids [S, k], weights of the
        held experts [S, len(experts)])."""
        m = self.model
        with span("client.route"):
            s = torch.sigmoid(h @ w["router"].T)                 # [S, E]
            sel = torch.topk(s + w["expert_bias"], m.top_k, dim=-1).indices
            r = s.gather(1, sel)
            if m.norm_topk:
                r = r / (r.sum(-1, keepdim=True) + 1e-6)
            r = r * m.routed_scaling
            full = torch.zeros_like(s).scatter_(1, sel, r)
            return sel, full[:, w["held"]]

    def _moe(self, j, w, h, gen):
        """MoE FFN of MoE row j (client weights w) on h [S, D]: route on
        the client, every held expert on the server -> (out [S, D],
        selected [S, k])."""
        S = h.shape[0]
        sel, r = self._route(w, h)
        chunks = self.expert_chunks
        n_up = len(self.experts) * chunks
        MOE["expert_matvecs"] += S * (n_up + -(-n_up // 2))
        with span("moe.experts"), MOE_TIMER.region(self.device):
            out = self._swiglu("moe_up", "moe_down", j, h, gen,
                               r.repeat_interleave(chunks, dim=1))
        return out, sel

    def _count_routed(self, routes: np.ndarray) -> None:
        """MOE["routed_matvecs"]: the up chunks of held experts each
        stream routed to, and the down pairs holding one of them."""
        chunks = self.expert_chunks
        held = np.asarray(self.experts)
        for sel in routes.reshape(-1, routes.shape[-1]):
            on = np.repeat(np.isin(held, sel), chunks)
            if len(on) % 2:
                on = np.append(on, False)
            MOE["routed_matvecs"] += int(on.sum() + (on[0::2] | on[1::2])
                                         .sum())

    # -- the token ----------------------------------------------------------

    def _token(self, token_ids, state: Lfm2State, seed):
        m = self.model
        S = len(token_ids)
        with span("token.embed"):
            x = torch.as_tensor(m.emb[np.asarray(token_ids)].astype(
                np.float32), device=self.device)
        gen = _generator(self.device, seed)
        if self.n_attn:
            state._grow()
        routes = []
        for li, layer in enumerate(m.layers):
            w = self.cw[li]
            row, frow = self._rows[li]
            with span("client.math"):
                u = _rms(x, w["operator_norm"], m.norm_eps)
            if isinstance(layer.mixer, ShortConvWeights):
                x = x + self._conv(row, w, u, state, gen)
            else:
                x = x + self._attn(row, w, u, state, gen)
            with span("client.math"):
                h = _rms(x, w["ffn_norm"], m.norm_eps)
            if isinstance(layer.ffn, MoeWeights):
                out, sel = self._moe(frow, w, h, gen)
                routes.append(sel)
            else:
                out = self._swiglu("dense_up", "dense_down", frow, h, gen)
            x = x + out
        state.pos += 1
        with span("token.readback"):
            x_out = x.double().cpu().numpy()
            self.last_routes = (torch.stack(routes, dim=1).cpu().numpy()
                                if routes else np.zeros((S, 0, m.top_k),
                                                        dtype=np.int64))
        if routes:
            self._count_routed(self.last_routes)
        with span("token.head"):
            logits = _rms_np(x_out, m.final_norm, m.norm_eps) @ m.emb.T
        return logits, state

    # -- public API -----------------------------------------------------------

    def generate_tokens_streams(self, token_ids, states: Lfm2State):
        """One token step for the S streams of `states` (advanced in place
        on the device and returned).  Returns (logits [S, vocab], states);
        `last_routes` then holds the client's selected experts
        [S, n_moe, k]."""
        self._seed += 1
        with span("token"):
            return self._token(list(token_ids), states, self._seed)
