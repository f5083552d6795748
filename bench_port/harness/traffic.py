"""The one traffic generator: a traffic file's parameters and a seed give
the requests of a run.

Keys of a traffic file (``traffic/<name>.json``):

* ``arrival``: ``"closed"`` (a request is sent as soon as one of the
  ``in_flight`` pipeline slots is free) or ``"poisson"`` (open loop: each
  request is due at its time whether or not earlier ones have finished);
* ``in_flight``: requests the server keeps enqueued on the device at once;
* ``sizes`` and ``shares``: the frames of a request and the share of
  requests of each size;
* ``rate_per_s`` (``poisson``): arrivals a second while arrivals are on;
* ``burst`` (optional, ``poisson``): ``{"on_s": a, "off_s": b}``: arrivals
  come only in ``a``-second spells, ``b`` seconds apart;
* ``pool_frames``: frames in the seeded pool in pinned host memory that
  requests read; ``offset_step``: a request starts at a multiple of it.

The seed changes the order of the work, never its amount. An open loop
has ``round(rate * on-seconds)`` arrivals in the window, their gaps the
exponential distribution's quantiles and their sizes in the stated
shares, paired in one fixed random order (drawn once from ``BASE_ORDER``)
that the seed rotates: every seed sends the same sequence of gaps and
sizes from another starting point, so a queue's tail does not swing with
the arrival pattern a seed happens to draw. A closed loop cycles through
blocks of 100 requests in the stated shares, in a seeded order. Request
offsets into the pool are drawn from the seed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator

import numpy as np

BLOCK = 100
BASE_ORDER = 20261018


@dataclass
class Request:
    index: int
    due: float  # seconds after the window opens; a closed loop's are 0
    size: int
    offset: int
    issued: float = math.nan
    enq0: float = math.nan
    enq1: float = math.nan
    done: float = math.nan


def _counts(n: int, shares: list[float]) -> list[int]:
    total = float(sum(shares))
    counts = [int(round(n * s / total)) for s in shares]
    counts[-1] = n - sum(counts[:-1])
    if min(counts) < 0:
        raise ValueError(f"cannot split {n} requests in shares {shares}")
    return counts


def _sizes(traffic: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    sizes = np.repeat(np.asarray(traffic["sizes"], np.int64),
                      _counts(n, traffic.get("shares", [1.0] * len(traffic["sizes"]))))
    return rng.permutation(sizes)


def _offset(traffic: dict, size: int, rng: np.random.Generator) -> int:
    step = int(traffic.get("offset_step", 1))
    slots = (int(traffic["pool_frames"]) - size) // step + 1
    if slots < 1:
        raise ValueError(f"a request of {size} frames does not fit a pool of "
                         f"{traffic['pool_frames']}")
    return int(rng.integers(slots)) * step


def arrivals(traffic: dict, seed: int, seconds: float) -> np.ndarray:
    """Due times (seconds after the window opens) of an open loop."""
    rate = float(traffic["rate_per_s"])
    burst = traffic.get("burst")
    on = float(burst["on_s"]) if burst else seconds
    off = float(burst["off_s"]) if burst else 0.0
    spells = math.floor(seconds / (on + off)) if burst else 1
    on_total = spells * on + (min(on, seconds - spells * (on + off)) if burst else 0.0)
    n = int(round(rate * on_total))
    if n < 1:
        return np.zeros(0)
    q = (np.arange(n) + 0.5) / n
    gaps = np.roll(np.random.default_rng([BASE_ORDER, 1]).permutation(-np.log1p(-q) / rate),
                   _shift(seed, n))
    busy = np.concatenate([[0.0], np.cumsum(gaps)[:-1]]) * on_total / gaps.sum()
    return np.floor(busy / on) * (on + off) + np.mod(busy, on) if burst else busy


def _shift(seed: int, n: int) -> int:
    return int(np.random.default_rng([seed, 1]).integers(n)) if n else 0


def schedule(traffic: dict, seed: int, seconds: float) -> Iterator[Request]:
    """The requests of one window, in the order they are due."""
    rng_offsets = np.random.default_rng([seed, 2])
    if traffic["arrival"] == "closed":
        rng_sizes = np.random.default_rng([seed, 3])
        index = 0
        while True:
            for size in _sizes(traffic, BLOCK, rng_sizes):
                yield Request(index, 0.0, int(size), _offset(traffic, int(size), rng_offsets))
                index += 1
    if traffic["arrival"] != "poisson":
        raise ValueError(f"unknown arrival {traffic['arrival']!r}")
    due = arrivals(traffic, seed, seconds)
    sizes = np.roll(_sizes(traffic, len(due), np.random.default_rng([BASE_ORDER, 3])),
                    _shift(seed, len(due)))
    for i, (t, size) in enumerate(zip(due, sizes)):
        yield Request(i, float(t), int(size), _offset(traffic, int(size), rng_offsets))
