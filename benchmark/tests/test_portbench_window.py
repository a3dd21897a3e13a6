"""The window's arithmetic: a rate is all the work over all the time; a
percentile is over every request, never an average of chunks'."""

import numpy as np
import pytest

from benchmark.lib import window


def test_rate_is_all_work_over_all_time():
    # three uneven stretches: 10 steps in 1 s, 10 in 3 s, 20 in 1 s
    work, secs = [10, 10, 20], [1.0, 3.0, 1.0]
    assert window.rate(sum(work), sum(secs)) == pytest.approx(8.0)
    assert window.rate(sum(work), sum(secs)) != pytest.approx(
        np.mean([w / s for w, s in zip(work, secs)]))


def test_rate_refuses_an_empty_window():
    with pytest.raises(ValueError):
        window.rate(1, 0.0)


def test_p95_is_over_every_request():
    rng = np.random.default_rng(0)
    fast = list(rng.uniform(10, 20, 900))
    slow = list(rng.uniform(100, 200, 100))
    every = fast + slow
    p95 = window.percentile(every, 95)
    assert p95 == pytest.approx(np.percentile(every, 95))
    chunks = [every[i:i + 100] for i in range(0, 1000, 100)]
    assert p95 != pytest.approx(np.mean([np.percentile(c, 95) for c in chunks]))


@pytest.mark.parametrize("q", [0, 50, 95, 99, 100])
def test_percentile_matches_numpy(q):
    xs = list(np.random.default_rng(1).normal(size=37))
    assert window.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_completed_in_keeps_requests_resolved_in_the_window():
    events = [(0.0, 0.5), (0.2, 1.5), (1.0, 2.0), (1.9, 3.1)]
    assert window.completed_in(events, 1.0, 3.0) == pytest.approx([1.3, 1.0])
