"""Block pipeline for client-aided generation: the blocks of the model
split over a rank group, S independent streams flowing through the ranks
GPipe-style.

Counterpart of `fhe_spear_tpu/parallel/block_pipeline.py`.  Rank h owns
the contiguous blocks [h*span, (h+1)*span): it stages only their
diagonals and client weights (`DeviceTokenRunner(..., blocks=)`), and
their per-stream token-mix and WKV state stay on the rank.  While a token
runs, the only traffic between ranks is the residual-stream handoff at
span boundaries: (x, v_first, block counter), two float32[D] vectors and
one counter per step, moved one rank along the ring (`ring_shift`).

Schedule: macro-step t, rank h works on stream s = t - h (fill and drain
steps idle), and after every step the ring advances one rank; T = S + H - 1
steps advance all S streams by one token.  The reference's
`runner._block_body(xs)` returns the body, traced once into one jitted
dispatch; the port's `DeviceTokenRunner._block_body(bi, ...)` is the body
itself, so the pipeline calls it block by block.

Randomness: one torch generator per (stream, rank), seeded from the
stream's seed and the rank as the reference folds its keys (`:83-85`);
the bits differ from the reference's threefry draws, so tokens and logit
correlation are compared, not words.  The logits and the new states are
all-gathered at the end, so that every rank returns them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ckks.device_encrypt import _generator
from ..models.device_client import DeviceTokenRunner
from ..models.rwkv7 import RwkvState, layer_norm
from .collectives import RankGroup, all_gather, ring_shift

__all__ = ["BlockPipeline"]


class BlockPipeline:
    """Pipelined multi-stream token steps over the blocks of `runner`'s
    model split across `group` (n_blocks % size == 0)."""

    def __init__(self, runner: DeviceTokenRunner, group: RankGroup):
        self.runner = runner
        self.group = group
        self.H = group.size
        self.nb = len(runner.model.blocks)
        if self.nb % self.H:
            raise ValueError(f"{self.nb} blocks do not split over {self.H} "
                             "ranks")
        self.span = self.nb // self.H
        self.blocks = self.span_of(self.nb, group)
        if not (runner.blocks.start <= self.blocks.start
                and self.blocks.stop <= runner.blocks.stop):
            raise ValueError(f"the runner stages blocks {runner.blocks}, "
                             f"rank {group.rank} needs {self.blocks}")

    @staticmethod
    def span_of(n_blocks: int, group: RankGroup) -> range:
        """The blocks rank `group.rank` owns (pass it to DeviceTokenRunner
        as `blocks=` so that the rank stages them alone)."""
        span = n_blocks // group.size
        return range(group.rank * span, (group.rank + 1) * span)

    def generate_tokens(self, token_ids, states):
        """Advance S = len(token_ids) independent streams by one token
        each, pipelined across the ranks.  Returns (logits [S, vocab],
        new_states), the same on every rank."""
        r, m, h, H = self.runner, self.runner.model, self.group.rank, self.H
        d, dev, S = r.d, r.device, len(token_ids)
        f32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32),
                                        device=dev)
        fresh = f32(np.stack([
            layer_norm(np.asarray(m.emb[t], dtype=np.float64), m.ln0_w,
                       m.ln0_b) for t in token_ids]))
        r._seed += 1
        seeds = (np.uint32(r._seed & 0xFFFFFFFF)
                 + np.arange(S, dtype=np.uint32) * np.uint32(0x9E3779B9))
        own = list(self.blocks)
        xpa = f32([[s.x_prev_att[b] for b in own] for s in states])
        xpf = f32([[s.x_prev_ffn[b] for b in own] for s in states])
        st = f32([[s.wkv[b] for b in own] for s in states])
        # the ring word: x [d], v_first [d], block counter [1]
        ring = torch.zeros(2 * d + 1, dtype=torch.float32, device=dev)
        ys = torch.zeros(S, d, dtype=torch.float32, device=dev)
        for t in range(S + H - 1):
            s = t - h
            if 0 <= s < S:
                if h == 0:                      # rank 0 starts stream t
                    ring = torch.cat([fresh[s], torch.zeros(d + 1,
                                                            device=dev)])
                x, vf = ring[None, :d], ring[None, d:2 * d]
                bi = int(ring[2 * d].item())
                if bi != self.blocks.start:
                    raise RuntimeError(f"rank {h} got block {bi}, owns "
                                       f"{self.blocks}")
                gen = _generator(dev, int(seeds[s]) * 4096 + h)
                for j, b in enumerate(own):
                    x, vf, x_ln, x_ffn_ln, new_st = r._block_body(
                        b, x, vf, xpa[s, j][None], xpf[s, j][None],
                        st[s, j][None], gen)
                    xpa[s, j], xpf[s, j], st[s, j] = (x_ln[0], x_ffn_ln[0],
                                                      new_st[0])
                ring = torch.cat([x[0], vf[0],
                                  torch.full((1,), float(self.blocks.stop),
                                             device=dev)])
                if h == H - 1:                  # stream s leaves the ring
                    ys[s] = x[0]
            ring = ring_shift(ring, self.group)
        # return the outputs on every rank
        x_out = all_gather(ys, self.group)[H - 1].double().cpu().numpy()
        full = [all_gather(a, self.group).transpose(0, 1).flatten(1, 2)
                .double().cpu().numpy() for a in (xpa, xpf, st)]
        news = [RwkvState(x_prev_att=list(full[0][s]),
                          x_prev_ffn=list(full[1][s]), wkv=list(full[2][s]))
                for s in range(S)]
        logits = layer_norm(x_out, m.ln_out_w, m.ln_out_b) @ m.head_w
        return logits, news
