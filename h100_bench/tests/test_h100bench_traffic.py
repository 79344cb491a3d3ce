"""The one traffic generator is a function of the cell's parameters and the
seed alone."""

from __future__ import annotations

import numpy as np

import traffic

PARAMS = {"prompt_words": [3, 8], "rate": 1.7, "sources": 4}


def test_requests_repeat_from_the_seed():
    a = [traffic.request(PARAMS, 2**31 + 12345, i) for i in range(20)]
    b = [traffic.request(PARAMS, 2**31 + 12345, i) for i in range(20)]
    c = [traffic.request(PARAMS, 2**31 + 12346, i) for i in range(20)]
    assert a == b and a != c
    for r in a:
        assert all(w.isalpha() and w.islower() for w in r["prompt"].split())
        assert 3 <= len(r["prompt"].split()) <= 8 and 0 <= r["seed"] < 2**31


def test_batches_are_the_stream_in_order():
    it = traffic.batches(PARAMS, 7, 4)
    first, second = next(it), next(it)
    assert [r["index"] for r in first + second] == list(range(8))


def test_arrivals_one_trace_for_every_seed():
    """One Poisson trace a rate: the same due times for every seed, the
    requests drawn from the seed; the gaps the exponential quantiles."""
    a = traffic.arrivals(PARAMS, 1, 51.0)
    b = traffic.arrivals(PARAMS, 2, 51.0)
    assert traffic.arrivals(PARAMS, 1, 51.0) == a
    assert [t for t, _ in a] == [t for t, _ in b]
    assert [r for _, r in a] != [r for _, r in b]
    assert a[0][0] == 0.0 and all(t < 51.0 for t, _ in a)
    assert abs(len(a) - 1.7 * 51) <= 3
    gaps = np.diff([t for t, _ in a])
    assert abs(gaps.mean() - 1 / 1.7) < 0.05 and gaps.std() > 0.4 / 1.7


def test_source_images_repeat():
    x = traffic.source_image(5, 1, 64, 64)
    assert x.shape == (64, 64, 3) and x.dtype == np.uint8 and x.std() > 10
    assert np.array_equal(x, traffic.source_image(5, 1, 64, 64))
    assert not np.array_equal(x, traffic.source_image(5, 2, 64, 64))
