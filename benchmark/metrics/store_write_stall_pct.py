"""Share of the window the init's retire was held back by the writer pool
(``init.write_stall`` spans, ``PipelineStats.write_stall_s``)."""

from benchmark.stats import span_seconds


def read(run):
    if not any(s[0] == "init.fetch" for s in run.spans):
        return None
    return 100.0 * span_seconds(run, "init.write_stall") / run.window_s
