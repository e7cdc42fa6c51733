"""The window's rate, the nearest-rank p95 and the seeded sample."""

import numpy as np

from benchmark import harness


def test_nearest_rank_percentile():
    v = list(range(1, 101))
    assert harness.percentile_nearest_rank(v, 95) == 95
    assert harness.percentile_nearest_rank([5.0], 95) == 5.0
    assert harness.percentile_nearest_rank([3, 1, 2, 4], 95) == 4
    assert harness.percentile_nearest_rank([3, 1, 2, 4], 50) == 2


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _Entry:
    """A request of 8 utterances taking 2**-7 s, three times that every
    fifth (binary fractions, so the fake clock adds exactly)."""

    def __init__(self, clock):
        self.clock, self.r = clock, 0

    def request(self, r):
        return np.arange(8), r

    def call(self, r):
        self.clock.t += 3 * 2**-7 if r % 5 == 4 else 2**-7
        return r


def test_window_counts_all_requests_over_all_the_time(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(harness.time, "perf_counter", clock)
    res = harness.Reservoir(3, 1)
    lat, window = harness.run_window(_Entry(clock), 1.0, res)
    # 5 requests take 7 * 2**-7 s: 18 blocks reach 0.984375 s, and two
    # short requests more end the window at 1 s exactly
    assert len(lat) == 92 and window == 1.0
    assert res.n == 92 and len(res.items) == 3
    win = {"latencies_s": lat, "window_s": window, "requests": 92, "setup_s": 4.5,
           "work": {"utterances": 92 * 8}}

    def read(name):
        return harness.load_module(harness.ROOT, "end_to_end", name).read(win)
    assert read("utterances_per_s") == 736.0
    assert read("request_p95_ms") == 1e3 * 3 * 2**-7
    assert read("setup_s") == 4.5


def test_reservoir_is_seeded_and_uniform():
    def sample(seed):
        r = harness.Reservoir(4, seed)
        for i in range(1000):
            r.offer(i)
        return sorted(r.items)

    assert sample(3) == sample(3) and sample(3) != sample(4)
    hits = np.zeros(10)
    for seed in range(500):
        for x in sample(seed):
            hits[x // 100] += 1
    assert hits.min() > 120 and hits.max() < 280
