"""The one generator of every traffic mix: sizes, arrivals and features
from a mix's parameters and the run's seed.

Every seed gets the same multiset of sizes and of gaps between arrivals,
in another order: sizes are the distribution's quantiles at (i + 0.5)/n,
rounded and clipped, and the seed only permutes them, so two seeds ask
for the same work and their runs differ by order alone.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Sequence

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy generator for one use (``stream``) of a seed."""
    return np.random.default_rng([int(seed) % (2 ** 64), stream])


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The n quantiles at (i + 0.5)/n of ``dist``, rounded and clipped to
    [min, max], sorted.  ``dist``: ``{"dist": "lognormal", "median": m,
    "sigma": s, "min": a, "max": b}`` or ``{"dist": "fixed", "value": v}``."""
    if dist["dist"] == "fixed":
        return np.full(n, int(dist["value"]), dtype=np.int64)
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    nd = NormalDist(math.log(dist["median"]), dist["sigma"])
    x = np.array([math.exp(nd.inv_cdf((i + 0.5) / n)) for i in range(n)])
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)


def sizes(dist: dict, n: int, seed: int, stream: int) -> np.ndarray:
    """``quantiles(dist, n)`` in the seed's order."""
    return rng(seed, stream).permutation(quantiles(dist, n))


def poisson_arrivals(rate: float, n: int, seed: int, stream: int) -> np.ndarray:
    """Due times (s from the window's start) of n arrivals whose gaps are the
    exponential's quantiles at mean 1/rate, in the seed's order."""
    u = (np.arange(n) + 0.5) / n
    gaps = rng(seed, stream).permutation(-np.log1p(-u) / rate)
    return np.cumsum(gaps) - gaps[0]


def bucket(t: int, buckets: Sequence[int]) -> int:
    """The smallest rung of the frame ladder that holds t frames (past the
    top: the next multiple of the top rung), as the program pads."""
    for b in buckets:
        if t <= b:
            return int(b)
    top = int(buckets[-1])
    return -(-int(t) // top) * top
