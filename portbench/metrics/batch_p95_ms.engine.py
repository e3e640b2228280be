"""95th percentile of a batch's time from its put on the stage's input
queue to its blurred frames taken from the output queue, over every batch
of the window (the benchmark's own clock)."""

import statistics


def read(obs):
    lat = obs.get("latencies_s", [])
    if len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=20)[18] * 1e3
