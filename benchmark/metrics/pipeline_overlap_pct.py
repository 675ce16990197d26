"""The share of the window's label batches dispatched while the other
stream of their pipeline's stream ring still ran the previous batch: the
growth of ``runtime_batches_overlapped_total`` over that of
``runtime_batches_dispatched_total``, both summed over the label
pipelines' kinds (``init``, ``init_pack``), between the registry's samples
at the window's edges. A program without the counter reads nothing."""

KINDS = ("init", "init_pack")


def _growth(run, name: str) -> float | None:
    try:
        before = run.registry["t0"][name][1]
        after = run.registry["t1"][name][1]
    except KeyError:
        return None

    def total(series) -> float:
        return sum(v for k, v in series.items() if dict(k).get("kind")
                   in KINDS)
    return total(after) - total(before)


def read(run):
    overlapped = _growth(run, "runtime_batches_overlapped_total")
    dispatched = _growth(run, "runtime_batches_dispatched_total")
    if overlapped is None or not dispatched:
        return None
    return 100.0 * overlapped / dispatched
