"""Share of the traced window in which no kernel or copy ran on the card:
100 - the union of the profiler's device intervals over the window."""

from benchmark.devtrace import busy_us, clip
from benchmark.stats import window_us


def read(run):
    if run.dtrace is None or not run.dtrace.events:
        return None
    lo, hi = window_us(run)
    return 100.0 * (1.0 - busy_us(clip(run.dtrace.intervals(), lo, hi))
                    / (hi - lo))
