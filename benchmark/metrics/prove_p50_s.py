"""Median seconds from a challenge's submit to its proof, k2pow included,
over every proof submitted in the window (a failed or missing proof
counts as infinitely late; the window's proofs are awaited after it)."""

import math

from benchmark.stats import nearest_rank


def read(run):
    lat = run.proof_latencies()
    if not lat:
        return None
    v = nearest_rank(lat, 50)
    return None if math.isinf(v) else v
