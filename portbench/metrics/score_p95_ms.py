"""score_p95_ms: the 95th percentile of every scoring batch's latency in
the window, from its submission to its sums on the host (nearest rank, so
a twentieth of the batches lie at or above it)."""

import math


def read(run):
    lat = sorted(run.window.latencies_s)
    if not lat:
        return None
    return lat[max(0, math.ceil(0.95 * len(lat)) - 1)] * 1e3
