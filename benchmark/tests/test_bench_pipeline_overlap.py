"""``pipeline_overlap_pct``: the label pipelines' overlapped batches over
their dispatched batches in the window, and nothing from a program
without the counter."""

import pytest

from benchmark import drive, harness

OVER = "runtime_batches_overlapped_total"
DISP = "runtime_batches_dispatched_total"


def _key(kind, tenant="-"):
    return (("kind", kind), ("tenant", tenant))


def _run(t0, t1):
    run = drive.Run({"scrypt_n": 8192}, {}, [], t0=10.0, t1=20.0)
    run.registry = {"t0": t0, "t1": t1}
    return run


def test_overlapped_over_dispatched_of_the_label_kinds():
    read = harness.reader("pipeline_overlap_pct")
    t0 = {OVER: ("counter", {_key("init", "a"): 3.0}),
          DISP: ("counter", {_key("init", "a"): 4.0,
                             _key("prove", "b"): 50.0})}
    t1 = {OVER: ("counter", {_key("init", "a"): 12.0,
                             _key("init_pack", "*"): 9.0}),
          DISP: ("counter", {_key("init", "a"): 14.0,
                             _key("init_pack", "*"): 10.0,
                             _key("prove", "b"): 90.0})}
    # (9 + 9) of (10 + 10): the prover's batches are not label batches
    assert read(_run(t0, t1)) == pytest.approx(90.0)


def test_one_stream_reads_zero():
    read = harness.reader("pipeline_overlap_pct")
    t0 = {OVER: ("counter", {}), DISP: ("counter", {_key("init"): 2.0})}
    t1 = {OVER: ("counter", {}), DISP: ("counter", {_key("init"): 9.0})}
    assert read(_run(t0, t1)) == 0.0


def test_a_program_without_the_counter_reads_nothing():
    read = harness.reader("pipeline_overlap_pct")
    t0 = {DISP: ("counter", {_key("init"): 2.0})}
    t1 = {DISP: ("counter", {_key("init"): 9.0})}
    assert read(_run(t0, t1)) is None
    # no label batch in the window: nothing to divide by
    same = {OVER: ("counter", {}), DISP: ("counter", {_key("init"): 2.0})}
    assert read(_run(same, same)) is None
