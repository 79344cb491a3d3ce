"""The one traffic generator: requests drawn from a cell's parameters and
the run's seed.

A cell file (``workloads/<cell>.json``) holds the parameters under
``traffic``:

- ``prompt_words`` [lo, hi]: words a prompt, drawn from ``WORDS`` (the
  tokenizers pad every prompt to the same rows, so the words change the
  values and not the work);
- ``height``, ``width``, ``steps``, ``cfg``: every request's shape;
- ``denoise`` (img2img): the share of the schedule that runs;
- ``sources`` (img2img): how many source images the requests cycle through;
- ``rate`` (open loop): arrivals a second, Poisson (``arrivals``);
- ``latency_percentiles`` (open loop): the percentiles of the requests'
  latencies that the run reports, as ``latency_p<q>_s``.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import numpy as np

WORDS = (
    "a an the photo painting portrait of with in on at by under over near "
    "red blue green golden silver dark bright quiet old new small large "
    "cat dog horse bird fish tree river mountain city street garden house "
    "castle forest ocean desert bridge tower lake field window door road "
    "morning evening night winter summer autumn spring rain snow fog light "
    "shadow detailed sharp soft warm cold misty sunny cozy ancient modern"
).split()


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2**63), *stream])


def request(params: Dict, seed: int, i: int) -> Dict:
    """Request ``i`` of the run of ``seed``: its prompt and its own seed."""
    rng = _rng(seed, 1, i)
    lo, hi = params["prompt_words"]
    words = rng.choice(len(WORDS), size=int(rng.integers(lo, hi + 1)))
    req = {"prompt": " ".join(WORDS[j] for j in words),
           "seed": int(rng.integers(0, 2**31 - 1)), "index": i}
    if "sources" in params:
        req["source"] = i % params["sources"]
    return req


def stream(params: Dict, seed: int) -> Iterator[Dict]:
    """The closed loop's requests, one after another, without end."""
    i = 0
    while True:
        yield request(params, seed, i)
        i += 1


def batches(params: Dict, seed: int, batch: int) -> Iterator[List[Dict]]:
    """The closed loop's batches of ``batch`` requests."""
    it = stream(params, seed)
    while True:
        yield [next(it) for _ in range(batch)]


def arrivals(params: Dict, seed: int, seconds: float) -> List[Tuple[float, Dict]]:
    """The open loop's schedule over ``seconds``: (due time, request).

    One Poisson trace a rate, replayed for every seed: the gaps are the
    exponential distribution's quantiles at (i + 0.5) / n in one order drawn
    once, from a fixed stream. The seed draws the requests (prompts and the
    images' seeds) and the weights, not the arrivals: with the gaps' order
    drawn from the seed, the order alone moved the median latency by a
    quarter between seeds (PERF.md)."""
    rate = float(params["rate"])
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = gaps[_rng(0, 2).permutation(n)]
    due = np.cumsum(gaps) - gaps[0]  # the first request at the window's start
    return [(float(t), request(params, seed, i)) for i, t in enumerate(due) if t < seconds]


def source_image(seed: int, index: int, height: int, width: int) -> np.ndarray:
    """An img2img source (H, W, 3) uint8: smooth colour fields and edges,
    drawn from the seed, so that the encoder sees structure at every scale."""
    rng = _rng(seed, 3, index)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    img = np.zeros((height, width, 3), np.float32)
    for _ in range(12):
        fy, fx = rng.uniform(0.5, 12, size=2) * 2 * math.pi / np.array([height, width])
        phase = rng.uniform(0, 2 * math.pi)
        img += rng.uniform(-1, 1, size=3) * np.sin(fy * yy + fx * xx + phase)[..., None]
    img += 0.3 * rng.standard_normal((height, width, 3)).astype(np.float32)
    img = (img - img.min()) / (img.max() - img.min())
    return (img * 255).astype(np.uint8)
