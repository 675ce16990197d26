"""Share of the window the packer's retire spent waiting for a pack's
labels to reach the host (``runtime.pack.fetch`` spans): the packed cell's
twin of ``init_fetch_pct``."""

from benchmark.hoststeps import window_pct


def read(run):
    return window_pct(run, "runtime.pack.fetch")
