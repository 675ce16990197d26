"""Share of a prove spent in its k2pow search: ``prove.k2pow`` spans over
the ``prove.run`` spans that hold them, for the proves the window traced
from start to end."""

from benchmark.stats import span_seconds, window_us


def read(run):
    lo, hi = window_us(run)
    runs = {a.get("id") for n, s, e, a in run.spans
            if n == "prove.run" and s >= lo and e <= hi}
    if not runs:
        return None
    total = span_seconds(run, "prove.run", ids=runs)
    if total <= 0:
        return None
    return 100.0 * span_seconds(run, "prove.k2pow", parents=runs) / total
