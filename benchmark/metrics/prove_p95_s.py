"""95th percentile (nearest rank) of the seconds from a challenge's submit
to its proof, over every proof submitted in the window; a failed or
missing proof counts as infinitely late."""

import math

from benchmark.stats import nearest_rank


def read(run):
    lat = run.proof_latencies()
    if not lat:
        return None
    v = nearest_rank(lat, 95)
    return None if math.isinf(v) else v
