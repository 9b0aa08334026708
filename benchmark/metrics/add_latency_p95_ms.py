"""The 95th percentile of every addition's latency in the window, in ms (host clock)."""

from benchmark.benchlib.readers import percentile_ms


def read(run):
    return percentile_ms(run, 95)
