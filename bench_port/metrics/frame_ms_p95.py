"""The 95th percentile of every frame's latency in the window, from the call to its
maps on the host (host clock; nearest-rank)."""

import math


def read(run: dict) -> float | None:
    lat = sorted(run["latencies_s"])
    if not lat:
        return None
    return 1e3 * lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
