"""The readers of the host steps between two label launches: the span
shares clipped at the window's edges, 0 for a traced run without the span,
None for an untraced run and for a program that records none of the host
steps' spans, and the allocator gauge's growth across the window."""

import pytest

from benchmark import drive, harness

SPAN_READERS = (("pack_fetch_pct", "runtime.pack.fetch"),
                ("romix_scratch_pct", "romix.scratch"),
                ("host_gc_pct", "host.gc"))


def _run(spans=(), registry=None):
    run = drive.Run({"scrypt_n": 8192}, {}, [], t0=10.0, t1=20.0)
    run.spans = list(spans)
    run.registry = registry or {}
    return run


@pytest.mark.parametrize("metric,span", SPAN_READERS)
def test_span_share_is_clipped_at_the_window_edges(metric, span):
    run = _run([(span, 9.0e6, 10.5e6, {"id": 1}),     # 0.5 s inside
                (span, 12.0e6, 12.25e6, {"id": 2}),   # 0.25 s
                (span, 19.75e6, 21.0e6, {"id": 3}),   # 0.25 s inside
                (span, 21.0e6, 22.0e6, {"id": 4}),    # after the window
                ("romix.dispatch", 12.0e6, 13.0e6, {"id": 5})])
    assert harness.reader(metric)(run) == pytest.approx(100 * 1.0 / 10)


@pytest.mark.parametrize("metric,span", SPAN_READERS)
def test_traced_run_without_the_span_reads_zero(metric, span):
    other = "device.host_wait" if span != "device.host_wait" else "host.gc"
    run = _run([(other, 11e6, 12e6, {"id": 1}),
                ("init.fetch", 11e6, 12e6, {"id": 2})])
    assert harness.reader(metric)(run) == 0.0


@pytest.mark.parametrize("metric,span", SPAN_READERS)
def test_untraced_run_and_older_program_read_none(metric, span):
    assert harness.reader(metric)(_run()) is None
    # a traced program that records none of the host steps' spans
    older = _run([("init.fetch", 11e6, 12e6, {"id": 1}),
                  ("romix.dispatch", 11e6, 11.5e6, {"id": 2}),
                  ("runtime.pack.dispatch", 12e6, 13e6, {"id": 3})])
    assert harness.reader(metric)(older) is None


def _gauge(**calls):
    return ("gauge", {(("call", k),): v for k, v in calls.items()})


def test_allocator_calls_are_the_gauge_delta():
    read = harness.reader("allocator_device_calls")
    run = _run(registry={
        "t0": {"device_allocator_calls": _gauge(malloc=7, free=2, retry=1)},
        "t1": {"device_allocator_calls": _gauge(malloc=9, free=5, retry=4)}})
    assert read(run) == 5  # a retry is no cudaMalloc or cudaFree
    steady = _run(registry={
        "t0": {"device_allocator_calls": _gauge(malloc=7, free=2)},
        "t1": {"device_allocator_calls": _gauge(malloc=7, free=2)}})
    assert read(steady) == 0


def test_allocator_calls_absent_gauge_reads_none():
    read = harness.reader("allocator_device_calls")
    assert read(_run()) is None
    assert read(_run(registry={"t0": {}, "t1": {}})) is None
    empty = _run(registry={"t0": {"device_allocator_calls": ("gauge", {})},
                           "t1": {"device_allocator_calls": ("gauge", {})}})
    assert read(empty) is None
