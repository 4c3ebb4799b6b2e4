"""The one generator of the benchmark's traffic: token ids from a seed.

A traffic file (`benchmark/traffic/<name>.json`) gives the parameters;
this module turns them and --seed into the ids that every step feeds.
Keys read here:
  streams       S sessions advanced together, one token each a step.
  ids           "uniform": every id drawn uniformly over the vocabulary.
The ids of step t are the same for every run of a seed, whatever the
window's length, and no id depends on what the program returns: both
sides see the same ids.  Warm-up steps draw from a stream of their own,
so the window's ids do not depend on how many warm-up steps ran.
"""

from __future__ import annotations

import numpy as np

from .weights import derive_seed

__all__ = ["TokenIds"]

_WINDOW, _WARMUP = 1, 2


class TokenIds:
    """ids(t) -> int64 [S] for step t of the window; warmup(t) the same
    for warm-up step t."""

    def __init__(self, traffic: dict, vocab: int, seed: int):
        if traffic.get("ids", "uniform") != "uniform":
            raise ValueError(f"unknown ids draw {traffic['ids']!r}")
        self.streams = int(traffic["streams"])
        self.vocab = int(vocab)
        self._gens = {tag: np.random.Generator(np.random.PCG64(
            derive_seed(seed, tag))) for tag in (_WINDOW, _WARMUP)}
        self._drawn = {tag: [] for tag in (_WINDOW, _WARMUP)}

    def _get(self, tag, t):
        drawn = self._drawn[tag]
        while len(drawn) <= t:
            drawn.append(self._gens[tag].integers(0, self.vocab,
                                                  self.streams))
        return drawn[t]

    def ids(self, t: int) -> np.ndarray:
        return self._get(_WINDOW, t)

    def warmup(self, t: int) -> np.ndarray:
        return self._get(_WARMUP, t)

    def window(self, steps: int) -> np.ndarray:
        """ids of the window's first `steps` steps, [steps, S]."""
        return np.stack([self.ids(t) for t in range(steps)]).reshape(
            steps, self.streams)
