"""Baseline: grandfathered findings, each carrying its justification.

The baseline exists so the analyzer can land with the tree still
imperfect and immediately block *new* findings, while every accepted
finding stays visible, justified, and rot-checked:

* a finding matched by a baseline entry is reported as suppressed, not
  failed;
* a baseline entry with an empty/placeholder justification fails CI —
  a suppression nobody can explain is a finding, not an exception;
* a baseline entry that no longer matches any current finding fails CI
  as **stale** — the defect was fixed (delete the entry) or the code
  changed in a way that changed the line (re-justify against the new
  fingerprint). Stale suppressions otherwise accumulate until the file
  silently suppresses real regressions.

Fingerprints hash (rule, path, normalized line) — no line number, no
occurrence index — and matching is a **multiset** per fingerprint:
N identical offending lines need N baseline entries. Adding one more
identical violation therefore surfaces exactly one new finding; it can
never steal an existing entry's suppression.

Format (``spacemesh_tpu_torch/tools/spacecheck/baseline.json``)::

    {"version": 1,
     "findings": [
        {"fingerprint": "...", "rule": "SC001",
         "path": "spacemesh_tpu_torch/...", "snippet": "...",
         "justification": "why this site is accepted"} ]}
"""

from __future__ import annotations

import json

from .engine import Finding

VERSION = 1
_PLACEHOLDERS = ("", "todo", "fixme", "tbd")


class BaselineError(ValueError):
    pass


def load(path: str) -> dict[str, list[dict]]:
    """{fingerprint: [entries]} (duplicates are the multiset count for
    identical offending lines). Raises BaselineError on malformed files
    or unjustified entries."""
    try:
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
    except FileNotFoundError:
        return {}
    except (OSError, ValueError) as e:
        raise BaselineError(f"unreadable baseline {path}: {e}") from e
    if not isinstance(doc, dict) or doc.get("version") != VERSION \
            or not isinstance(doc.get("findings"), list):
        raise BaselineError(
            f"baseline {path}: expected {{version: {VERSION}, "
            "findings: [...]}}")
    out: dict[str, list[dict]] = {}
    for i, ent in enumerate(doc["findings"]):
        if not isinstance(ent, dict) or not isinstance(
                ent.get("fingerprint"), str):
            raise BaselineError(f"baseline {path}: entry {i} malformed")
        just = ent.get("justification")
        if not isinstance(just, str) \
                or just.strip().lower() in _PLACEHOLDERS:
            raise BaselineError(
                f"baseline {path}: entry {i} "
                f"({ent.get('rule')} {ent.get('path')}) has no "
                "justification — every grandfathered finding must say "
                "why it is accepted")
        out.setdefault(ent["fingerprint"], []).append(ent)
    return out


def split(findings: list[Finding], baseline: dict[str, list[dict]]
          ) -> tuple[list[Finding], list[Finding], list[dict]]:
    """Multiset match -> (new findings, suppressed findings, stale
    baseline entries). Per fingerprint with n current findings and m
    baseline entries: min(n, m) suppress, extras past m are new,
    entries past n are stale."""
    budget = {fp: len(ents) for fp, ents in baseline.items()}
    new: list[Finding] = []
    suppressed: list[Finding] = []
    for f in findings:
        if budget.get(f.fingerprint, 0) > 0:
            budget[f.fingerprint] -= 1
            suppressed.append(f)
        else:
            new.append(f)
    stale = [ent for fp, ents in baseline.items()
             for ent in ents[:budget.get(fp, 0)]]
    return new, suppressed, stale


def write(path: str, findings: list[Finding],
          justification: str = "TODO") -> None:
    """Emit a baseline for the current findings. Justifications already
    present in the file at ``path`` are PRESERVED (matched per
    fingerprint, multiset order) — regenerating after fixing one
    finding must not reset the others to TODO. New entries default to a
    placeholder that load() REJECTS: the author must replace each one
    before the file passes CI (that is the point)."""
    try:
        existing = load(path)
    except BaselineError:
        existing = {}
    remaining = {fp: [e.get("justification") for e in ents]
                 for fp, ents in existing.items()}
    entries = []
    for f in findings:
        kept = remaining.get(f.fingerprint)
        just = kept.pop(0) if kept else justification
        entries.append(
            {"fingerprint": f.fingerprint, "rule": f.rule, "path": f.path,
             "snippet": f.snippet, "justification": just})
    doc = {"version": VERSION, "findings": entries}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=False)
        fh.write("\n")
