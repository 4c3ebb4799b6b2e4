"""The one generator of the benchmark's vector traffic: input vectors from
a seed.

A traffic file (`benchmark/traffic/<name>.json`) gives the parameters;
this module turns them, the configuration's width and --seed into the
vectors that every step feeds.  Keys read here:
  streams       S requests a step, each one vector.
  inputs        "uniform": every coordinate drawn uniformly on
                [low, high] (keys "low", "high").
The vectors of step t are the same for every run of a seed, whatever the
window's length, and none depends on what the program returns: both
sides see the same vectors.  Warm-up steps draw from a stream of their
own, so the window's vectors do not depend on how many warm-up steps ran.
"""

from __future__ import annotations

import numpy as np

from .weights import derive_seed

__all__ = ["InputVectors"]

_WINDOW, _WARMUP = 1, 2


class InputVectors:
    """step(t) -> float64 [S, dim] for step t of the window; warmup(t) the
    same for warm-up step t; window(steps) -> [steps, S, dim]."""

    def __init__(self, traffic: dict, dim: int, seed: int):
        if traffic.get("inputs", "uniform") != "uniform":
            raise ValueError(f"unknown inputs draw {traffic['inputs']!r}")
        self.streams = int(traffic["streams"])
        self.dim = int(dim)
        self.low = float(traffic.get("low", -1.0))
        self.high = float(traffic.get("high", 1.0))
        self._gens = {tag: np.random.Generator(np.random.PCG64(
            derive_seed(seed, tag))) for tag in (_WINDOW, _WARMUP)}
        self._drawn = {tag: [] for tag in (_WINDOW, _WARMUP)}

    def _get(self, tag, t):
        drawn = self._drawn[tag]
        while len(drawn) <= t:
            drawn.append(self._gens[tag].uniform(
                self.low, self.high, (self.streams, self.dim)))
        return drawn[t]

    def step(self, t: int) -> np.ndarray:
        return self._get(_WINDOW, t)

    def warmup(self, t: int) -> np.ndarray:
        return self._get(_WARMUP, t)

    def window(self, steps: int) -> np.ndarray:
        """The vectors of the window's first `steps` steps."""
        return np.asarray([self.step(t) for t in range(steps)]).reshape(
            steps, self.streams, self.dim)
