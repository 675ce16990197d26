"""Share of the window spent taking ROMix's lane chunk and allocating its V
scratch before a batch's launches (``romix.scratch`` spans: the autotuned
decision, ``lanes_that_fit`` and the ``torch.empty`` of V)."""

from benchmark.hoststeps import window_pct


def read(run):
    return window_pct(run, "romix.scratch")
