"""spacecheck CLI: ``python -m spacemesh_tpu_torch.tools.spacecheck``.

Exit codes: 0 clean (or everything suppressed/baselined), 1 new
findings or analyzer errors, 2 baseline problems (stale or unjustified
entries — suppression rot is a failure in its own right).

Tier-1 runs it over the real tree with its baseline
(``tests/test_torch_spacecheck.py``); ``--format=github`` renders the
findings as workflow annotations, ``--format=json`` for tools, and the
default text format is for local use.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import baseline as baseline_mod
from .engine import RULE_IDS, run_paths

# the port's baseline lives in the port, beside this module: the root
# spacecheck_baseline.json belongs to the JAX package's checker
DEFAULT_BASELINE = "spacemesh_tpu_torch/tools/spacecheck/baseline.json"


def _default_paths(root: str) -> list[str]:
    """The port package and the port's own test files. The JAX package
    and its tests are the JAX checker's: SC005 reads metric names across
    every scanned file, and the port's registry repeats the JAX names by
    design, so the two packages are never scanned in one run."""
    out = []
    pkg = os.path.join(root, "spacemesh_tpu_torch")
    if os.path.isdir(pkg):
        out.append(pkg)
    tests = os.path.join(root, "tests")
    if os.path.isdir(tests):
        out.extend(os.path.join(tests, f) for f in sorted(os.listdir(tests))
                   if (f.startswith("test_torch_") and f.endswith(".py"))
                   or f == "torch_twin.py")
    return out


def _render_text(f) -> str:
    return (f"{f.path}:{f.line}:{f.col + 1}: {f.rule} {f.message}\n"
            f"    {f.snippet}\n    [fingerprint {f.fingerprint}]")


def _render_github(f) -> str:
    # '%0A' is the workflow-command newline escape
    msg = f"{f.rule} {f.message} [fingerprint {f.fingerprint}]"
    msg = msg.replace("%", "%25").replace("\r", "%0D").replace("\n", "%0A")
    return (f"::error file={f.path},line={f.line},"
            f"col={f.col + 1},title=spacecheck {f.rule}::{msg}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spacemesh_tpu_torch.tools.spacecheck",
        description="project-specific static analysis of the "
                    "PyTorch port (spacemesh_tpu_torch/tools/spacecheck)")
    ap.add_argument("paths", nargs="*",
                    help="files/directories (default: spacemesh_tpu_torch/, "
                         "tests/test_torch_*.py and tests/torch_twin.py "
                         "under --root)")
    ap.add_argument("--root", default=os.getcwd(),
                    help="project root paths are reported relative to")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: <root>/"
                         f"{DEFAULT_BASELINE} when it exists)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore any baseline file (report everything)")
    ap.add_argument("--write-baseline", metavar="FILE",
                    help="write the current findings as a baseline "
                         "(justifications start as TODO, which the "
                         "checker rejects until replaced)")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule ids (default: all)")
    ap.add_argument("--format", choices=("text", "github", "json"),
                    default="text")
    ap.add_argument("--jobs", type=int, default=1, metavar="N",
                    help="fork-parallel rule execution (default: 1)")
    ap.add_argument("--cache", default=None, metavar="FILE",
                    help="incremental findings cache (default: "
                         "~/.cache/spacemesh_tpu_torch/spacecheck_cache.json, "
                         "$SPACEMESH_SPACECHECK_CACHE overrides; full-rule "
                         "runs only)")
    ap.add_argument("--no-cache", action="store_true",
                    help="always recompute, never read/write the cache")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        from . import rules as rules_pkg

        for rule in rules_pkg.ALL_RULES:
            doc = (rule.__doc__ or "").strip().splitlines()[0]
            doc = doc.removeprefix(f"{rule.RULE} ")
            print(f"{rule.RULE}  {doc}")
        return 0

    select = None
    if args.select:
        select = {s.strip().upper() for s in args.select.split(",")}
        unknown = select - set(RULE_IDS)
        if unknown:
            ap.error(f"unknown rules: {', '.join(sorted(unknown))}")

    root = os.path.abspath(args.root)
    paths = args.paths or _default_paths(root)
    if not paths:
        ap.error("no paths given and none of spacemesh_tpu_torch/, "
                 f"tests/test_torch_*.py exist under {root}")
    # the default-path cache holds the FULL tree's findings; a run over
    # an explicit path subset must not overwrite it with a subset doc
    # (an explicit --cache FILE is the caller's own file and is honored)
    cache: str | bool = False
    if not args.no_cache:
        cache = args.cache or (not args.paths)
    findings, errors = run_paths(paths, project_root=root, select=select,
                                 cache=cache, jobs=args.jobs)

    if args.write_baseline:
        baseline_mod.write(args.write_baseline, findings)
        print(f"wrote {len(findings)} finding(s) to "
              f"{args.write_baseline}; replace every TODO justification "
              "before checking it in", file=sys.stderr)
        return 0

    bl_path = args.baseline or os.path.join(root, DEFAULT_BASELINE)
    baseline: dict[str, dict] = {}
    bl_error: str | None = None
    if not args.no_baseline:
        try:
            baseline = baseline_mod.load(bl_path)
        except baseline_mod.BaselineError as e:
            bl_error = str(e)
    new, suppressed, stale = baseline_mod.split(findings, baseline)
    if select is not None:
        # a narrowed run computes no findings for deselected rules, so
        # their baseline entries are not evidence of rot — staleness is
        # only decidable for the rules that actually ran
        stale = [e for e in stale if e.get("rule") in select]

    if args.format == "json":
        print(json.dumps({
            "new": [vars(f) for f in new],
            "suppressed": [vars(f) for f in suppressed],
            "stale_baseline": stale,
            "errors": errors,
            "baseline_error": bl_error,
        }, indent=1))
    else:
        render = _render_github if args.format == "github" else _render_text
        for f in new:
            print(render(f))
        for e in errors:
            print(f"spacecheck: analyzer error: {e}", file=sys.stderr)
        if stale:
            for ent in stale:
                print("spacecheck: STALE baseline entry "
                      f"{ent.get('fingerprint')} ({ent.get('rule')} "
                      f"{ent.get('path')}): no current finding matches "
                      "— delete it or re-justify against the new "
                      "fingerprint", file=sys.stderr)
        if bl_error:
            print(f"spacecheck: {bl_error}", file=sys.stderr)
        print(f"spacecheck: {len(new)} new, {len(suppressed)} "
              f"baselined, {len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'}, "
              f"{len(errors)} error(s)", file=sys.stderr)

    if bl_error or stale:
        return 2
    if new or errors:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
