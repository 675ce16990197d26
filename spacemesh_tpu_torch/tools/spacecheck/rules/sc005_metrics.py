"""SC005 metrics-hygiene: registration and label discipline.

Originating bug: the silent wrong-bucket histogram —
``Registry.histogram`` re-registered under the same name with different
explicit buckets silently returned the original layout, so every
quantile computed from the deltas was wrong without a trace (the
registry now raises; this rule keeps the *callers* honest before
runtime). The SLI sampler (obs/sli.py) diffs whole-registry snapshots,
so instrument identity and label cardinality are correctness inputs,
not style.

Flags:

* **creation outside module scope** — ``<registry>.counter/gauge/
  histogram(...)`` inside a function/method: per-instance creation is
  where duplicate-name and bucket-mismatch registrations come from;
  create at import, record at runtime.
* **duplicate metric names** — the same name literal registered at
  module scope in two different places: both sites silently share one
  instrument, and the second's help text/buckets are discarded.
* **non-literal label names** — ``inc/set/observe(**labels)`` splat on
  a known instrument: the label *schema* becomes data-dependent, and
  one unexpected key forks a new series family.
* **f-string label values** — ``inc(reason=f"...")``: interpolated
  values are unbounded (peer ids, exception strings) and each distinct
  value mints a series — the classic cardinality bomb. Use a bounded
  enum (``type(e).__name__``-style) instead.

Suppress with ``# spacecheck: ok=SC005 <why>`` (e.g. a per-process
registry in a tool that never coexists with a second instance).
"""

from __future__ import annotations

import ast

from ..engine import FileContext, Finding, ProjectInfo, dotted_name

RULE = "SC005"

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
_RECORD_METHODS = ("inc", "set", "observe")


def check(ctx: FileContext, project: ProjectInfo) -> list[Finding]:
    findings: list[Finding] = []
    in_package = ctx.rel.startswith("spacemesh_tpu_torch/")

    # duplicate names: only report sites in THIS file (the runner visits
    # every file, so each duplicate site reports once); module-scope
    # creations only — runtime lookups of an existing instrument are the
    # registry's documented get-or-create behavior
    if in_package:
        for name, sites in project.metric_creations.items():
            module_sites = [s for s in sites if s[2]]
            if len(module_sites) > 1:
                for rel, lineno, _ in module_sites[1:]:
                    if rel == ctx.rel:
                        first = module_sites[0]
                        findings.append(Finding(
                            rule=RULE, path=ctx.rel, line=lineno, col=0,
                            message=(
                                f"metric {name!r} already registered at "
                                f"{first[0]}:{first[1]}; this site "
                                "silently shares that instrument and "
                                "its help/buckets win"),
                            snippet=(ctx.lines[lineno - 1].strip()
                                     if lineno <= len(ctx.lines) else "")))

    fn_depth = 0

    def visit(node: ast.AST) -> None:
        nonlocal fn_depth
        is_fn = isinstance(node, _FUNCS)
        if is_fn:
            fn_depth += 1
        if isinstance(node, ast.Call):
            check_call(node)
        for child in ast.iter_child_nodes(node):
            visit(child)
        if is_fn:
            fn_depth -= 1

    def check_call(node: ast.Call) -> None:
        func = node.func
        if not isinstance(func, ast.Attribute):
            return
        if in_package and fn_depth > 0 \
                and ProjectInfo._is_registry_create(node):
            findings.append(ctx.finding(
                RULE, node,
                f"instrument created inside a function "
                f"(.{func.attr}(...)): create at module scope so "
                "duplicate names and bucket mismatches fail at import, "
                "not mid-run"))
            return
        if func.attr not in _RECORD_METHODS:
            return
        recv = dotted_name(func.value)
        if recv is None \
                or recv.rsplit(".", 1)[-1] not in project.instrument_vars:
            return
        for kw in node.keywords:
            if kw.arg is None:
                findings.append(ctx.finding(
                    RULE, node,
                    f"**splat label names on instrument {recv}: the "
                    "label schema must be literal keywords so the "
                    "series family is fixed at the call site"))
            elif isinstance(kw.value, ast.JoinedStr):
                findings.append(ctx.finding(
                    RULE, kw.value,
                    f"f-string label value for {kw.arg!r} on {recv}: "
                    "interpolated values are unbounded and each "
                    "distinct one mints a series (cardinality bomb); "
                    "use a bounded enum"))

    visit(ctx.tree)
    return findings
