"""SC006 bare-except / swallowed-error in consensus-critical packages.

Originating bugs: the farm-vs-inline verification divergence hid for
a while behind broadly-caught handler paths, and the fuzz rider
(core/codec OverflowError crash) existed precisely because an untyped
stream-decode error escaped the intended except clause. In
``consensus/``, ``verify/`` and ``p2p/`` a silently swallowed error is
a consensus-split or a wedged sync in waiting — every broad catch must
either be justified in a comment or narrow its type and surface the
error (log, counter, re-raise).

Flags, in ``spacemesh_tpu_torch/consensus/``, ``spacemesh_tpu_torch/verify/``,
``spacemesh_tpu_torch/p2p/``:

* bare ``except:`` — always (it catches CancelledError/SystemExit on
  py3.7-; even on 3.10 it hides KeyboardInterrupt-adjacent teardown);
* ``except Exception``/``BaseException`` (alone or in a tuple) whose
  handler body only ``pass``/``continue``/``...`` — a swallow with no
  trace.

A handler is accepted when its ``except`` line (or the first body
line) carries a *justified* suppression: ``# spacecheck: ok=SC006
<why>`` or an existing ``# noqa: ... — <why>`` comment with a real
reason (the codebase's established convention); the flake8 code alone
does not count.
"""

from __future__ import annotations

import ast

from ..engine import FileContext, Finding, ProjectInfo

RULE = "SC006"

SCOPE_PREFIXES = (
    "spacemesh_tpu_torch/consensus/",
    "spacemesh_tpu_torch/verify/",
    "spacemesh_tpu_torch/p2p/",
)

_BROAD = {"Exception", "BaseException"}


def _broad_type(node: ast.expr | None) -> bool:
    if node is None:
        return True
    if isinstance(node, ast.Name):
        return node.id in _BROAD
    if isinstance(node, ast.Attribute):
        return node.attr in _BROAD
    if isinstance(node, ast.Tuple):
        return any(_broad_type(e) for e in node.elts)
    return False


def _swallows(body: list[ast.stmt]) -> bool:
    for stmt in body:
        if isinstance(stmt, (ast.Pass, ast.Continue)):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value,
                                                     ast.Constant):
            continue  # docstring / ellipsis
        return False
    return True


def check(ctx: FileContext, project: ProjectInfo) -> list[Finding]:
    if not ctx.rel.startswith(SCOPE_PREFIXES):
        return []
    findings: list[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        justified = any(
            ctx.noqa_comment(ln) is not None
            for ln in (node.lineno, node.body[0].lineno
                       if node.body else node.lineno))
        if node.type is None:
            if not justified:
                findings.append(ctx.finding(
                    RULE, node,
                    "bare except: in a consensus-critical package — "
                    "name the exception types (and surface the error) "
                    "or justify the suppression"))
            continue
        if _broad_type(node.type) and _swallows(node.body) \
                and not justified:
            findings.append(ctx.finding(
                RULE, node,
                "broad except swallowing the error with no log/counter/"
                "re-raise in a consensus-critical package: narrow the "
                "type or surface the failure, or justify with a "
                "comment"))
    return findings
