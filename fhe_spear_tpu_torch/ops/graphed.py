"""CUDA-graph replay of the server's projections in the device client's
token step.

A projection of `models.device_client.DeviceTokenRunner` (the BSGS matvec
kernel of `ops.bsgs.bsgs_kernel` over the ciphertexts of S streams) is
~2,300 kernel launches at D=2048, N=8192, each made from Python: the host's
launch path, not the card, then sets the step.  `ProjectionGraphs`
captures each projection once as a CUDA graph and replays it, one
`cudaGraphLaunch` a projection for all S streams.

  * A graph's key is (projection, block row, input shape, `key_epoch`):
    the block row's plaintext view and the level's key stacks have fixed
    addresses, the shape holds S, and a new epoch (the context's keys
    replaced) drops every graph, as `bsgs_kernel` reselects its keys.
  * The first call of a key runs eagerly: it fills the caches (index,
    permutation and digit tables, the NTT kernels' tables) whose uploads
    a capture cannot hold.  The second is captured (`torch.cuda.graph`)
    and replayed; each later call copies the ciphertexts into the graph's
    static input, replays, and copies the output out.  The graphs share
    one memory pool: they replay one at a time, and each output is copied
    out before the next replay.  A replay does not wait for the card, so
    the host can queue a projection while the card runs the one before.
  * K1/K2, four-step and BSGS contraction launches count on the host at
    launch (`KernelStats`), and a replay launches nothing from Python: the
    counters' deltas over the capture are added back at every replay.
  * Graphs engage on a CUDA context with unsharded keys.  Otherwise (a
    CPU context; limb-sharded keys, whose keyswitch runs collectives)
    every call runs eagerly.

A replay runs the captured kernels on the same addresses, so its words
equal the eager call's.  `utils.profiling.GRAPHS` counts captures,
replays and eager calls.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass

import torch

from ..core.fourstep_cuda import FOURSTEP_FWD, FOURSTEP_INV
from ..core.ntt_cuda import NTT_FWD, NTT_INV
from ..utils.profiling import GRAPHS, span
from .bsgs_cuda import BSGS_CONTRACT

__all__ = ["ProjectionGraphs", "launch_counts", "count_replays"]

_STATS = (NTT_FWD, NTT_INV, FOURSTEP_FWD, FOURSTEP_INV, BSGS_CONTRACT)


def launch_counts() -> list:
    """Copies of the launch counters' `by_shape` (K1, K2, four-step
    forward and inverse, the BSGS contraction)."""
    return [collections.Counter(s.by_shape) for s in _STATS]


def count_replays(delta, times: int = 1) -> None:
    """Add the launches `delta` (a capture's `launch_counts()` after minus
    before) to the counters, `times` times over."""
    for stats, d in zip(_STATS, delta):
        stats.add(d, times)


@dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    inp: torch.Tensor          # static input the replay reads
    out: torch.Tensor          # static output the replay writes
    delta: list                # launch counts of one run


_WARM = object()               # a key's first (eager) call has run


class ProjectionGraphs:
    """The server projections of one runner, graphed by key.  Call with
    (name, row, kern, c): kern(cs) is the server kernel on one stream's
    ciphertexts cs; c holds the S streams' [S, ...].  Returns
    torch.stack([kern(cs) for cs in c]), each stream's eager call in a
    `server.bsgs` span, a replay in one."""

    def __init__(self, ctx):
        self.ctx = ctx
        self._graphs: dict = {}
        self._epoch = None
        self._pool = None              # the graphs' memory pool

    @property
    def engaged(self) -> bool:
        return self.ctx.device.type == "cuda" and self.ctx._key_shard is None

    def key(self, name: str, row: int, c: torch.Tensor) -> tuple:
        return (name, row, tuple(c.shape), self.ctx.key_epoch)

    def _eager(self, kern, c: torch.Tensor) -> torch.Tensor:
        outs = []
        for cs in c:
            with span("server.bsgs"):
                outs.append(kern(cs))
        return torch.stack(outs)

    def __call__(self, name: str, row: int, kern, c: torch.Tensor
                 ) -> torch.Tensor:
        if not self.engaged:
            GRAPHS["eager"] += 1
            return self._eager(kern, c)
        if self._epoch != self.ctx.key_epoch:
            self._graphs.clear()               # free the stale graphs first
            self._pool = None
            self._epoch = self.ctx.key_epoch
        key = self.key(name, row, c)
        g = self._graphs.get(key)
        if g is None:
            self._graphs[key] = _WARM
            GRAPHS["eager"] += 1
            return self._eager(kern, c)
        if g is _WARM:
            g = self._graphs[key] = self._capture(kern, c)
            GRAPHS["captures"] += 1
            return g.out.clone()
        GRAPHS["replays"] += 1
        with span("server.bsgs"), torch.cuda.device(c.device):
            g.inp.copy_(c)
            g.graph.replay()
            count_replays(g.delta)
            return g.out.clone()

    def _capture(self, kern, c: torch.Tensor) -> _Graph:
        """Capture kern over a static copy of c (on c's card, whichever is
        current) and run it once; the capture's launches count as this
        call's."""
        with torch.cuda.device(c.device):
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            inp = c.clone()
            graph = torch.cuda.CUDAGraph()
            before = launch_counts()
            with torch.cuda.graph(graph, pool=self._pool):
                out = self._eager(kern, inp)
            delta = [after - b for after, b in zip(launch_counts(), before)]
            graph.replay()
        return _Graph(graph, inp, out, delta)
