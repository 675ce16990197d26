"""Mean lanes of the window's packed init dispatches (the scheduler's
``runtime_pack_occupancy_lanes`` histogram) over the pack width."""

from benchmark.stats import histogram_delta


def read(run):
    d = histogram_delta(run, "runtime_pack_occupancy_lanes")
    if d is None or d[1] <= 0 or run.pack_lanes <= 0:
        return None
    return 100.0 * d[0] / d[1] / run.pack_lanes
