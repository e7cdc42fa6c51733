"""The nearest-rank 95th percentile of the latencies of every request of
the window, each from its call to its answer on the host, in ms."""

from benchmark.harness import percentile_nearest_rank


def read(win):
    if not win["latencies_s"]:
        return None
    return 1e3 * percentile_nearest_rank(win["latencies_s"], 95)
