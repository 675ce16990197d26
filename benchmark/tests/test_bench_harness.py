"""The harness's arithmetic, and every file found by its name."""

import json
import math
import re

import pytest

from benchmark import drive, harness, peaks, stats
from benchmark.devtrace import busy_us, clip, merged

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _run(**kw):
    ids = [drive.Identity("init00", "init", b"n" * 32, b"c" * 32, 1, 100,
                          None),
           drive.Identity("init01", "init", b"m" * 32, b"d" * 32, 1, 100,
                          None)]
    run = drive.Run({"scrypt_n": 8192}, {}, ids, t0=10.0, t1=20.0)
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def test_rate_is_all_labels_over_the_whole_window():
    # batches before the window, inside it, and after it
    run = _run(frontiers={
        "init00": [(9.0, 100), (10.5, 200), (19.9, 300), (20.5, 400)],
        "init01": [(9.5, 50), (12.0, 150)]})
    assert run.window_labels() == (300 - 100) + (150 - 50)
    read = harness.reader("init_labels_per_s")
    assert read(run) == pytest.approx(300 / 10.0)


def test_rate_needs_an_initializing_identity():
    run = _run()
    run.identities = []
    assert harness.reader("init_labels_per_s")(run) is None


def test_nearest_rank():
    xs = list(range(1, 101))
    assert stats.nearest_rank(xs, 95) == 95
    assert stats.nearest_rank(xs, 50) == 50
    assert stats.nearest_rank([3.0], 95) == 3.0
    assert stats.nearest_rank([1, 2, math.inf], 50) == 2
    with pytest.raises(ValueError):
        stats.nearest_rank([], 50)


def _proofs(latencies, failed=0, late=0):
    recs = []
    for i, lat in enumerate(latencies):
        recs.append(drive.ProofRecord("p", i, b"", 11.0, 11.0 + lat,
                                      proof=object()))
    for i in range(failed):
        recs.append(drive.ProofRecord("p", 100 + i, b"", 12.0, 12.5,
                                      error="boom"))
    for i in range(late):  # submitted in the window, never returned
        recs.append(drive.ProofRecord("p", 200 + i, b"", 13.0))
    # submitted before the window: not due, whatever its latency
    recs.append(drive.ProofRecord("p", 300, b"", 9.0, 9.1, proof=object()))
    return recs


def test_p95_is_over_all_proofs_due_and_a_failed_one_counts_missing():
    run = _run(proofs=_proofs([1.0] * 19))
    assert harness.reader("prove_p95_s")(run) == pytest.approx(1.0)
    run = _run(proofs=_proofs([1.0] * 18, failed=1, late=1))
    # 20 due, 2 missing: the 19th value (rank 19) is missing
    assert run.proof_latencies().count(math.inf) == 2
    assert harness.reader("prove_p95_s")(run) is None
    run = _run(proofs=_proofs([float(i) for i in range(1, 40)], failed=1))
    assert harness.reader("prove_p95_s")(run) == 38.0
    assert harness.reader("prove_p50_s")(run) == 20.0


def test_a_proof_open_when_the_window_opens_is_due():
    """A proof submitted before the window and still out when it opens
    is in the tail, from its submit; one back before it is not."""
    run = _run(proofs=[
        drive.ProofRecord("p", 0, b"", 4.0, 15.0, proof=object()),
        drive.ProofRecord("p", 1, b"", 9.0, 9.5, proof=object()),
        drive.ProofRecord("p", 2, b"", 9.0),  # still out after the drain
        drive.ProofRecord("p", 3, b"", 19.0, 23.0, proof=object()),
        drive.ProofRecord("p", 4, b"", 20.5, 21.0, proof=object())])
    assert [r.seq for r in run.due_proofs()] == [0, 2, 3]
    assert sorted(run.proof_latencies()) == [4.0, 11.0, math.inf]


def test_completions_in_the_window_per_identity():
    ids = [drive.Identity(t, "prove", b"n" * 32, b"c" * 32, 1, 64, None)
           for t in ("a", "b", "c")]
    run = drive.Run({}, {}, ids, t0=10.0, t1=20.0, proofs=[
        drive.ProofRecord("a", 0, b"", 9.0, 11.0, proof=object()),
        drive.ProofRecord("b", 0, b"", 9.0, 9.5, proof=object()),
        drive.ProofRecord("b", 1, b"", 9.5, 21.0, proof=object()),
        drive.ProofRecord("c", 0, b"", 12.0, 13.0, error="boom")])
    assert run.window_completions() == {"a": 1, "b": 0, "c": 0}


def test_busy_union_and_gaps():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26)]
    assert busy_us(iv) == 25
    assert merged(iv) == [(0, 15), (20, 30)]
    assert clip(iv, 8, 22) == [(8, 10), (8, 15), (20, 22)]


def test_span_and_counter_readers():
    run = _run(spans=[
        ("init.fetch", 9.5e6, 10.5e6, {"id": 1}),
        ("init.write_stall", 10.2e6, 10.3e6, {"id": 2, "parent": 1}),
        ("init.fetch", 19.0e6, 21.0e6, {"id": 3}),
        ("prove.run", 11e6, 13e6, {"id": 7}),
        ("prove.k2pow", 11e6, 11.5e6, {"id": 8, "parent": 7}),
        ("prove.run", 19e6, 21e6, {"id": 9}),
        ("prove.k2pow", 19e6, 20e6, {"id": 10, "parent": 9})])
    assert harness.reader("init_fetch_pct")(run) == pytest.approx(
        100 * (0.5 + 1.0 - 0.1) / 10)
    assert harness.reader("store_write_stall_pct")(run) == pytest.approx(1.0)
    assert harness.reader("prove_k2pow_pct")(run) == pytest.approx(25.0)
    hist = "runtime_pack_occupancy_lanes"
    run.registry = {
        "t0": {hist: ("histogram", {"series": {(): ([], 100.0, 2)}}),
               "post_prove_windows_total": ("counter", {(): 5.0})},
        "t1": {hist: ("histogram", {"series": {(): ([], 356.0, 4)}}),
               "post_prove_windows_total": ("counter", {(): 14.0})}}
    run.pack_lanes = 256
    assert harness.reader("pack_occupancy_pct")(run) == pytest.approx(50.0)
    run.proofs = _proofs([1.0, 2.0, 3.0])
    assert harness.reader("prove_windows_per_proof")(run) == pytest.approx(3)


def test_roofline_against_the_frozen_peaks():
    assert peaks.int_ops_per_s("NVIDIA H100 80GB HBM3") == pytest.approx(
        132 * 128 * 1980e6)
    assert peaks.int_ops_per_s("some other card") is None
    assert peaks.romix_ops(8192) == 13_893_632

    class Trace:
        events = [("romix", "kernel", 10e6, 20e6)]

        def intervals(self, kind=None):
            return [(s, e) for _, k, s, e in self.events
                    if kind in (None, k)]
    run = _run(frontiers={"init00": [(10.0, 0), (20.0, 1_000_000)]},
               dtrace=Trace(), device_kind="NVIDIA H100 80GB HBM3")
    least = 1_000_000 * peaks.label_ops(8192) / (132 * 128 * 1980e6)
    got = harness.reader("label_kernels_roofline_pct")(run)
    assert got == pytest.approx(100 * least / 10.0)
    run.device_kind = "cpu"
    assert harness.reader("label_kernels_roofline_pct")(run) is None
    assert harness.reader("device_idle_pct")(run) == pytest.approx(0.0)


def test_every_file_is_found_by_name():
    for wl in SPEC["workloads"]:
        cfg = harness.config_of(SPEC, wl)
        assert cfg["scrypt_n"] == 8192 and cfg["label_bytes"] == 16
        traffic = harness.traffic_of(wl)
        assert traffic["entry"] in ("initializer", "scheduler")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        if m["name"] != "setup_s":
            assert callable(harness.reader(m["name"]))


def test_benchmark_json_keeps_the_contract():
    raw = (harness.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]]
    assert len(set(names)) == len(names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["why"]) <= 200
        assert c["file"].startswith("benchmark/")
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    cells = [w["name"] for w in SPEC["workloads"]]
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) \
        == len(cells)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in names
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for cell in m.get("workloads", cells):
            assert cell in cells
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        moved = next(x for x in SPEC["end_to_end"] if x["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", cells)
    for cell in cells:  # every cell: setup_s, one more, one per-layer
        assert sum(harness.applies(m, cell)
                   for m in SPEC["end_to_end"]) >= 2
        assert any(harness.applies(m, cell) for m in SPEC["per_layer"])
