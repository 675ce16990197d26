"""The program's spans that name each host step between two label
launches on the card, and the share of the window one of them takes.

A traced run whose program records none of these spans predates them: its
readers find nothing to read and return None, and the result line leaves
the metric out. A traced run of a program that records them, with no span
of the name asked for in the window (a window without a collection, say),
reads 0."""

from benchmark.stats import span_seconds

HOST_STEPS = frozenset({
    "romix.scratch", "scrypt.expand", "romix.launch", "scrypt.finish",
    "scrypt.minscan", "init.build", "init.to_bytes", "init.checkpoint",
    "device.host_copy", "device.host_wait", "runtime.pack.compose",
    "runtime.pack.build", "runtime.pack.fetch", "runtime.pack.to_bytes",
    "host.gc"})


def window_pct(run, name: str) -> float | None:
    """Seconds of the spans named ``name`` inside the window, clipped to
    it, as a share of the window; None where the program records none of
    :data:`HOST_STEPS`."""
    if not any(s[0] in HOST_STEPS for s in run.spans):
        return None
    return 100.0 * span_seconds(run, name) / run.window_s
