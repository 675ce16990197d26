"""Share of the window the init's retire spent waiting for a batch's labels
to reach the host: ``init.fetch`` spans less their ``init.write_stall``
children, which is ``PipelineStats.fetch_s`` (``post/initializer.py``)."""

from benchmark.stats import span_seconds


def read(run):
    if not any(s[0] == "init.fetch" for s in run.spans):
        return None
    fetch = (span_seconds(run, "init.fetch")
             - span_seconds(run, "init.write_stall"))
    return 100.0 * fetch / run.window_s
