"""Share of the window in Python's garbage collector, which stops every
thread of the process (``host.gc`` spans, one per collection)."""

from benchmark.hoststeps import window_pct


def read(run):
    return window_pct(run, "host.gc")
