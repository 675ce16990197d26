"""Bench-trend gate: fail when a headline bench line regresses >10%.

Port of ``spacemesh_tpu/tools/benchtrend.py``, pure Python: it imports
no torch and touches no card. It gates the JSON metric lines of one
benchmark run against a committed round, a ``BENCH_r<N>.json`` document
holding that round's metric lines in ``tail`` (the last of them also
parsed into ``parsed``), and exits non-zero on any >10% drop. The
port's own benchmark, which prints such lines, is what will feed it;
nothing in the repo calls it yet.

What is compared — RATIO fields, not absolute rates, by default:
``vs_sequential``, ``vs_single``, ``vs_serial``, ``vs_baseline``,
``vs_legacy``, ``vs_single_process`` and ``speedup``. Absolute rates are
a property of the machine, while the ratios are self-calibrated: both
sides of each ratio are measured in the same process on the same host,
so a drop means the relative win shrank. ``--absolute`` additionally
gates raw ``value`` fields for same-machine baselines. Lines whose
identity gate failed (``bit_identical`` / ``verified`` false) are
rejected outright.

Metric names carry shape suffixes (``post_init_labels_per_sec_n8192_
b1024_cpufallback``); lines are matched by FAMILY — the name with the
``_n<N>_b<B>``/platform suffix stripped — so a baseline recorded at one
shape still gates a run at another. Families present on one side only
are reported, never failed: a new metric lands without a baseline, and
a skipped sub-bench does not fail the gate.

Usage:
  python -m spacemesh_tpu_torch.tools.benchtrend --current <file> \
      --baseline <round.json>
Options: ``--baseline <file>`` (default: the highest-round
``BENCH_*.json`` under ``--root``), ``--drop 0.10``, ``--absolute``,
``--require <family>`` (fail if the family is absent from the current
run; repeatable). Exit codes: 0 pass, 1 a regression or a missing
required family, 2 an unreadable baseline.

``--history`` renders the full committed trajectory instead of gating:
every round in order, one table per metric family with the absolute
rate and each ratio column, a ``v`` marker on any round-over-round drop
beyond ``--drop``. The gate only compares against the latest round, so
a slow leak (-5% per round for five rounds) is invisible to it; the
history view is where that trend shows up. Report-only: always exits 0.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

RATIO_FIELDS = ("vs_sequential", "vs_single", "vs_serial", "vs_baseline",
                "vs_legacy", "vs_single_process", "speedup")
GATE_FLAGS = ("bit_identical", "verified")

_SUFFIX = re.compile(r"(_n\d+)?(_b\d+)?(_cpufallback)?$")


def _log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def family(metric: str) -> str:
    """The metric name with its shape/platform suffix stripped."""
    return _SUFFIX.sub("", metric)


def metric_lines(text: str) -> dict[str, dict]:
    """{family: line-doc} for every JSON metric line in ``text``; the
    LAST line of a family wins (bench prints one per family per run)."""
    out: dict[str, dict] = {}
    for line in text.splitlines():
        line = line.strip()
        if not (line.startswith("{") and line.endswith("}")):
            continue
        try:
            doc = json.loads(line)
        except ValueError:
            continue
        if isinstance(doc, dict) and isinstance(doc.get("metric"), str):
            out[family(doc["metric"])] = doc
    return out


def latest_baseline(root: str) -> str | None:
    """The committed BENCH_r<N>.json with the highest round number."""
    best, best_n = None, -1
    for path in glob.glob(os.path.join(root, "BENCH_*.json")):
        try:
            n = int(json.load(open(path, encoding="utf-8")).get("n", -1))
        except (OSError, ValueError):
            continue
        if n > best_n:
            best, best_n = path, n
    return best


def baseline_lines(path: str) -> dict[str, dict]:
    """Metric lines recorded in one committed BENCH_*.json (its ``tail``
    carries the run's stdout JSON lines; ``parsed`` the last of them)."""
    doc = json.load(open(path, encoding="utf-8"))
    lines = metric_lines(doc.get("tail") or "")
    parsed = doc.get("parsed")
    if isinstance(parsed, dict) and isinstance(parsed.get("metric"), str):
        lines.setdefault(family(parsed["metric"]), parsed)
    return lines


def all_baselines(root: str) -> list[tuple[int, str]]:
    """Every committed BENCH_*.json as (round, path), round order."""
    rounds = []
    for path in glob.glob(os.path.join(root, "BENCH_*.json")):
        try:
            n = int(json.load(open(path, encoding="utf-8")).get("n", -1))
        except (OSError, ValueError):
            continue
        if n >= 0:
            rounds.append((n, path))
    return sorted(rounds)


def history(root: str, *, drop: float = 0.10) -> dict:
    """Per-family trajectory across ALL committed rounds.

    -> {"rounds": [n, ...], "families": {family: [row, ...]}} where each
    row carries the round, the absolute ``value``, every ratio field the
    line had, and ``regressed``: the fields that fell more than ``drop``
    vs the PREVIOUS round the family appeared in."""
    fams: dict[str, list[dict]] = {}
    rounds = all_baselines(root)
    for n, path in rounds:
        try:
            lines = baseline_lines(path)
        except (OSError, ValueError):
            continue
        for fam, doc in lines.items():
            row: dict = {"round": n}
            for f in ("value",) + RATIO_FIELDS:
                if isinstance(doc.get(f), (int, float)):
                    row[f] = float(doc[f])
            fams.setdefault(fam, []).append(row)
    for rows in fams.values():
        prev: dict | None = None
        for row in rows:
            row["regressed"] = [
                f for f, v in row.items()
                if f != "round" and isinstance(v, float) and prev
                and isinstance(prev.get(f), float) and prev[f] > 0
                and v < prev[f] * (1.0 - drop)]
            prev = row
    return {"rounds": [n for n, _ in rounds],
            "families": dict(sorted(fams.items()))}


def render_history(doc: dict) -> str:
    """Text tables (stderr view) for ``history()``'s output."""
    out = []
    for fam, rows in doc["families"].items():
        fields = [f for f in ("value",) + RATIO_FIELDS
                  if any(f in r for r in rows)]
        out.append(f"{fam}:")
        out.append("  round" + "".join(f"{f:>20}" for f in fields))
        for r in rows:
            cells = []
            for f in fields:
                v = r.get(f)
                cell = "-" if v is None else f"{v:,.4g}"
                if f in r["regressed"]:
                    cell += " v"
                cells.append(f"{cell:>20}")
            out.append(f"  r{r['round']:<4}" + "".join(cells))
    return "\n".join(out) if out else "(no BENCH_*.json rounds found)"


def compare(base: dict[str, dict], cur: dict[str, dict], *,
            drop: float = 0.10, absolute: bool = False) -> dict:
    """-> {"failures": [...], "compared": [...], "only_*": [...]}."""
    failures, compared = [], []
    for fam in sorted(set(base) & set(cur)):
        b, c = base[fam], cur[fam]
        for flag in GATE_FLAGS:
            if c.get(flag) is False:
                failures.append({"family": fam, "field": flag,
                                 "baseline": True, "current": False,
                                 "reason": "identity gate failed"})
        fields = [f for f in RATIO_FIELDS
                  if isinstance(b.get(f), (int, float))
                  and isinstance(c.get(f), (int, float))]
        if absolute and isinstance(b.get("value"), (int, float)) \
                and isinstance(c.get("value"), (int, float)):
            fields.append("value")
        for f in fields:
            bv, cv = float(b[f]), float(c[f])
            ok = bv <= 0 or cv >= bv * (1.0 - drop)
            compared.append({"family": fam, "field": f,
                             "baseline": bv, "current": cv, "ok": ok})
            if not ok:
                failures.append({
                    "family": fam, "field": f, "baseline": bv,
                    "current": cv,
                    "reason": f"dropped {(1 - cv / bv) * 100:.0f}% "
                              f"(gate: {drop * 100:.0f}%)"})
    return {"failures": failures, "compared": compared,
            "only_baseline": sorted(set(base) - set(cur)),
            "only_current": sorted(set(cur) - set(base))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="benchtrend",
        description="fail on >10%% drops vs the last committed "
                    "BENCH_*.json (ratio fields; see module docstring)")
    ap.add_argument("--current", default=None,
                    help="file of bench.py stdout (JSON metric lines); "
                    "'-' reads stdin (required unless --history)")
    ap.add_argument("--history", action="store_true",
                    help="render the full BENCH_r01..rNN trajectory per "
                    "metric family (rate + ratio columns, 'v' regression "
                    "markers) instead of gating; always exits 0")
    ap.add_argument("--baseline", default=None,
                    help="baseline BENCH_*.json (default: highest-round "
                    "BENCH_*.json under --root)")
    ap.add_argument("--root", default=".",
                    help="repo root to search for BENCH_*.json")
    ap.add_argument("--drop", type=float, default=0.10,
                    help="max tolerated fractional drop (default 0.10)")
    ap.add_argument("--absolute", action="store_true",
                    help="also gate absolute 'value' fields "
                    "(same-machine baselines only)")
    ap.add_argument("--require", action="append", default=[],
                    help="metric family that must be present in the "
                    "current run (repeatable)")
    a = ap.parse_args(argv)

    if a.history:
        doc = history(a.root, drop=a.drop)
        _log(render_history(doc))
        print(json.dumps(doc, indent=1))
        return 0
    if not a.current:
        ap.error("--current is required unless --history")

    base_path = a.baseline or latest_baseline(a.root)
    if base_path is None:
        _log("benchtrend: no BENCH_*.json baseline found; nothing to gate")
        print(json.dumps({"baseline": None, "failures": []}))
        return 0
    try:
        base = baseline_lines(base_path)
    except (OSError, ValueError) as e:
        _log(f"benchtrend: unreadable baseline {base_path} ({e})")
        return 2
    cur_text = sys.stdin.read() if a.current == "-" else open(
        a.current, encoding="utf-8").read()
    cur = metric_lines(cur_text)

    result = compare(base, cur, drop=a.drop, absolute=a.absolute)
    result["baseline"] = base_path
    for fam in a.require:
        if family(fam) not in cur:
            result["failures"].append({
                "family": family(fam), "field": None,
                "reason": "required family missing from current run"})
    for row in result["compared"]:
        _log(f"benchtrend: {row['family']}.{row['field']}: "
             f"{row['baseline']} -> {row['current']} "
             f"{'ok' if row['ok'] else 'REGRESSED'}")
    for fam in result["only_baseline"]:
        _log(f"benchtrend: {fam}: baseline only (not in current run)")
    for fam in result["only_current"]:
        _log(f"benchtrend: {fam}: new metric (no baseline; not gated)")
    print(json.dumps(result, indent=1))
    if result["failures"]:
        _log(f"benchtrend: FAILED — {len(result['failures'])} "
             f"regression(s) vs {os.path.basename(base_path)}")
        return 1
    _log(f"benchtrend: ok vs {os.path.basename(base_path)} "
         f"({len(result['compared'])} comparisons)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
