"""The port's bench-trend gate against the JAX package's, on the CPU.

``spacemesh_tpu_torch/tools/benchtrend.py`` reads the same synthetic
``BENCH_r*.json`` rounds and metric lines as ``spacemesh_tpu/tools/
benchtrend.py``, all written under ``tmp_path``: the ``compare()``
result, the ``history()`` document, the rendered table, what ``main``
prints on both streams and its exit code must be equal. The cases: a
ratio field that drops more than 10%, an identity gate that failed, a
family on one side only, ``--require`` of an absent family,
``--absolute``, an unreadable baseline, no baseline at all, and a slow
leak across five rounds under ``--history``.
"""

import json
import re

import pytest

from spacemesh_tpu.tools import benchtrend as jtrend
from spacemesh_tpu_torch.tools import benchtrend as ttrend

INIT = "post_init_labels_per_sec"
PROVE = "post_prove_labels_per_sec"


def _line(metric, value, **fields):
    return json.dumps({"metric": metric, "value": value, **fields})


def _round(root, n, lines, parsed=None):
    """``BENCH_r<n>.json`` as the repo commits one: the run's metric lines
    in ``tail``; ``parsed`` the last of them unless given."""
    doc = {"n": n, "tail": "log line\n" + "\n".join(lines) + "\n",
           "parsed": json.loads(lines[-1]) if parsed is None else parsed}
    path = root / f"BENCH_r{n:02d}.json"
    path.write_text(json.dumps(doc))
    return path


def _main(mod, argv, capsys):
    """``mod.main(argv)``'s exit code and both streams."""
    try:
        rc = mod.main(argv)
    except SystemExit as e:
        rc = e.code
    out, err = capsys.readouterr()
    return rc, out, err


def _both(argv, capsys):
    got = _main(ttrend, argv, capsys)
    want = _main(jtrend, argv, capsys)
    assert got == want
    return got


BASE = [_line(f"{INIT}_n8192_b1024", 1000.0, vs_baseline=2.0, speedup=3.0,
              bit_identical=True),
        _line(f"{PROVE}_n4096", 500.0, vs_serial=1.5, verified=True)]

# name -> (current lines, extra argv, exit code, failing (family, field)s)
CASES = {
    "ratio-drop": (
        [_line(f"{INIT}_n1024_b512_cpufallback", 990.0, vs_baseline=1.7,
               speedup=2.95, bit_identical=True),
         _line(f"{PROVE}_n4096", 500.0, vs_serial=1.49, verified=True)],
        [], 1, [(INIT, "vs_baseline")]),
    "identity-gate": (
        [_line(f"{INIT}_n8192_b1024", 1000.0, vs_baseline=2.0, speedup=3.0,
               bit_identical=False),
         _line(f"{PROVE}_n4096", 500.0, vs_serial=1.5, verified=False)],
        [], 1, [(INIT, "bit_identical"), (PROVE, "verified")]),
    "one-side-only": (
        [_line(f"{INIT}_n8192_b1024", 1000.0, vs_baseline=2.05,
               speedup=3.1, bit_identical=True),
         _line("verify_batch_per_sec", 7.0, vs_single=4.0)],
        [], 0, []),
    "require-absent": (
        [_line(f"{INIT}_n8192_b1024", 1000.0, vs_baseline=2.0, speedup=3.0,
               bit_identical=True)],
        ["--require", f"{PROVE}_n4096", "--require", INIT], 1,
        [(PROVE, None)]),
    "absolute": (
        [_line(f"{INIT}_n8192_b1024", 800.0, vs_baseline=2.0, speedup=3.0,
               bit_identical=True),
         _line(f"{PROVE}_n4096", 460.0, vs_serial=1.5, verified=True)],
        ["--absolute"], 1, [(INIT, "value")]),
    "relative-ignores-value": (
        [_line(f"{INIT}_n8192_b1024", 800.0, vs_baseline=2.0, speedup=3.0,
               bit_identical=True),
         _line(f"{PROVE}_n4096", 460.0, vs_serial=1.5, verified=True)],
        [], 0, []),
    "looser-drop": (
        [_line(f"{INIT}_n8192_b1024", 1000.0, vs_baseline=1.7,
               speedup=3.0, bit_identical=True)],
        ["--drop", "0.2"], 0, []),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gate_equals_jax(tmp_path, capsys, case):
    lines, argv, code, failing = CASES[case]
    _round(tmp_path, 1, [_line(f"{INIT}_n8", 1.0, vs_baseline=9.0)])
    base = _round(tmp_path, 4, BASE)
    cur = tmp_path / "bench_out.txt"
    cur.write_text("stderr noise\n" + "\n".join(lines) + "\n{not json}\n")

    base_t = ttrend.baseline_lines(str(base))
    assert base_t == jtrend.baseline_lines(str(base))
    cur_t = ttrend.metric_lines(cur.read_text())
    assert cur_t == jtrend.metric_lines(cur.read_text())
    drop = float(argv[argv.index("--drop") + 1]) if "--drop" in argv \
        else 0.10
    result = ttrend.compare(base_t, cur_t, drop=drop,
                            absolute="--absolute" in argv)
    assert result == jtrend.compare(base_t, cur_t, drop=drop,
                                    absolute="--absolute" in argv)

    # the latest round is the default baseline
    assert ttrend.latest_baseline(str(tmp_path)) == str(base)
    rc, out, err = _both(["--current", str(cur), "--root", str(tmp_path)]
                         + argv, capsys)
    assert rc == code
    doc = json.loads(out)
    assert doc["baseline"] == str(base)
    assert [(f["family"], f["field"]) for f in doc["failures"]] == failing
    if case == "one-side-only":
        assert doc["only_baseline"] == [PROVE]
        assert doc["only_current"] == ["verify_batch_per_sec"]
        assert "new metric (no baseline; not gated)" in err
    # the same run against an explicit baseline
    assert _both(["--current", str(cur), "--baseline", str(base)] + argv,
                 capsys) == (rc, out, err)


def test_slow_leak_shows_only_in_history(tmp_path, capsys):
    """Five rounds, each 5% below the one before: the gate against the
    latest round passes, the history at the default drop marks nothing,
    and at a 4% drop it marks every round after the first."""
    value, ratio = 1000.0, 2.0
    for n in range(1, 6):
        _round(tmp_path, n, [_line(f"{INIT}_n{1024 * n}", value,
                                   vs_baseline=ratio, bit_identical=True)])
        value, ratio = value * 0.95, ratio * 0.95
    (tmp_path / "BENCH_bad.json").write_text("{torn")
    cur = tmp_path / "bench_out.txt"
    cur.write_text(_line(f"{INIT}_n8192", value, vs_baseline=ratio,
                         bit_identical=True) + "\n")
    assert _both(["--current", str(cur), "--root", str(tmp_path)],
                 capsys)[0] == 0

    for drop, marked in ((0.10, []), (0.04, [2, 3, 4, 5])):
        doc = ttrend.history(str(tmp_path), drop=drop)
        assert doc == jtrend.history(str(tmp_path), drop=drop)
        assert doc["rounds"] == [1, 2, 3, 4, 5]
        rows = doc["families"][INIT]
        assert [r["round"] for r in rows if r["regressed"]] == marked
        text = ttrend.render_history(doc)
        assert text == jtrend.render_history(doc)
        assert bool(re.search(r"\d v\b", text)) == bool(marked)
        rc, out, err = _both(["--history", "--root", str(tmp_path),
                              "--drop", str(drop)], capsys)
        assert rc == 0  # report-only
        assert json.loads(out) == doc and err.strip() == text


def test_missing_or_unreadable_baseline_exits_like_jax(tmp_path, capsys):
    cur = tmp_path / "bench_out.txt"
    cur.write_text(BASE[0] + "\n")
    rc, out, _ = _both(["--current", str(cur), "--root", str(tmp_path)],
                       capsys)
    assert rc == 0 and json.loads(out) == {"baseline": None, "failures": []}
    bad = tmp_path / "BENCH_r07.json"
    bad.write_text("{torn")
    assert _both(["--current", str(cur), "--baseline", str(bad)],
                 capsys)[0] == 2
    assert _both(["--root", str(tmp_path)], capsys)[0] == 2  # no --current
    assert ttrend.render_history(ttrend.history(str(tmp_path / "none"))) \
        == "(no BENCH_*.json rounds found)"


def test_family_strips_shape_and_platform_suffixes():
    for metric in (f"{INIT}_n8192_b1024_cpufallback", f"{INIT}_n8192",
                   f"{INIT}_b64", f"{INIT}_cpufallback", INIT,
                   "romix_n1024_blocks_per_sec"):
        assert ttrend.family(metric) == jtrend.family(metric)
    assert ttrend.family(f"{INIT}_n8192_b1024_cpufallback") == INIT
    assert ttrend.RATIO_FIELDS == jtrend.RATIO_FIELDS
    assert ttrend.GATE_FLAGS == jtrend.GATE_FLAGS
