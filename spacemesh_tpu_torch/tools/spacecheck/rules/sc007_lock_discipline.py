"""SC007 lock-discipline: no mixed locked/bare access to shared state.

Originating bugs: the EventBus ``deepest_queue`` iteration race (a
collector thread iterated subscriber lists the loop thread was
resizing) and the registry thread-affinity bug fixed in the same
review; the runtime then added a packer + worker-pool where every new
attribute is one forgotten ``with self._lock`` away from the same
class. This is the static half of the Eraser-style lockset sanitizer
(``utils/sanitize.py``, ``SPACEMESH_SANITIZE=race``).

Detection (``spacemesh_tpu_torch/`` package code only):

* A class is **threaded** when one of its methods runs off the
  constructing thread anywhere in the project — a
  ``threading.Thread(target=self.m)``, ``executor.submit``,
  ``run_in_executor``, ``call_soon_threadsafe`` or ``asyncio.to_thread``
  call (the ProjectInfo cross-file pre-pass; ``rules/_locks.py``).
* Within a threaded class that owns locks (``threading.Lock`` /
  ``RLock`` / ``Condition`` — Conditions alias to their root lock, so
  ``with self._idle:`` over ``Condition(self._lock)`` counts as holding
  ``self._lock``): an instance attribute accessed under a held lock in
  one place but read/written **bare** elsewhere flags. Only attributes
  written outside ``__init__`` participate (read-only state is
  race-free); construction-time accesses are exempt (happens-before
  thread start); accesses inside nested ``def``/``lambda`` bodies are
  bare even when the def lexically sits inside a ``with`` (the closure
  runs later, without the lock).

Exemption vocabulary (each must carry a lock name / a why):

* ``# guarded by: <lock>`` on the access line (or alone on the line
  above) — the lock is held by the caller in a way the AST can't see;
  on the ``def`` line it declares the WHOLE function runs locked (the
  ``_pick_job``-style "caller holds ``self._lock``" idiom). Annotated
  functions are exempt, and deliberately do NOT establish guardedness
  for the attributes they touch.
* ``# spacecheck: loop-only <why>`` — the access happens only on the
  event-loop thread (single-threaded by construction).
* ``# spacecheck: ok=SC007 <why>`` — anything else deliberate (e.g. a
  monotonic flag read that tolerates staleness).
"""

from __future__ import annotations

import ast
import dataclasses

from ..engine import FileContext, Finding, ProjectInfo
from . import _locks

RULE = "SC007"

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)
_INIT_METHODS = {"__init__", "__del__", "__post_init__"}

# in-place container mutations count as writes to the attribute —
# ``self._tenants[tid] = t`` and ``self._subs[t].append(sub)`` are the
# shapes the deepest_queue race was made of
_MUTATORS = {"append", "appendleft", "extend", "insert", "pop", "popleft",
             "remove", "clear", "update", "setdefault", "add", "discard",
             "put", "put_nowait"}


def _mutated_self_attr(node: ast.AST) -> ast.Attribute | None:
    """The ``self.X`` whose CONTENTS this node mutates, if any:
    ``self.X[k] = v`` / ``del self.X[k]`` (Subscript store) and
    ``self.X.pop(...)``-style in-place mutator calls."""
    if isinstance(node, ast.Subscript) \
            and isinstance(node.ctx, (ast.Store, ast.Del)) \
            and isinstance(node.value, ast.Attribute) \
            and isinstance(node.value.value, ast.Name) \
            and node.value.value.id == "self":
        return node.value
    if isinstance(node, ast.Call) \
            and isinstance(node.func, ast.Attribute) \
            and node.func.attr in _MUTATORS \
            and isinstance(node.func.value, ast.Attribute) \
            and isinstance(node.func.value.value, ast.Name) \
            and node.func.value.value.id == "self":
        return node.func.value
    return None


@dataclasses.dataclass
class _Access:
    attr: str
    node: ast.Attribute
    method: str
    write: bool
    locked: bool          # under a held self-lock (lexically)
    exempt: bool          # init method / annotated function or line
    lock_root: str | None


def _class_accesses(ctx: FileContext, cls: ast.ClassDef,
                    locks: _locks.ClassLocks) -> list[_Access]:
    accesses: list[_Access] = []

    def method_scan(method: ast.AST) -> None:
        m_exempt = (method.name in _INIT_METHODS
                    or _locks.function_annotation(ctx, method) is not None)

        def visit(node: ast.AST, held: tuple[str, ...]) -> None:
            if isinstance(node, _FUNCS + (ast.Lambda,)) \
                    and node is not method:
                # the closure body runs later, without the with-block's
                # lock — but still on behalf of this method
                body = node.body if isinstance(node.body, list) \
                    else [node.body]
                for child in body:
                    visit(child, ())
                return
            if isinstance(node, ast.With):
                add = []
                for item in node.items:
                    expr = item.context_expr
                    if isinstance(expr, ast.Attribute) \
                            and isinstance(expr.value, ast.Name) \
                            and expr.value.id == "self":
                        root = locks.root(expr.attr)
                        if root is not None:
                            add.append(root)
                    visit(expr, held)
                inner = held + tuple(add)
                for child in node.body:
                    visit(child, inner)
                return
            target = _mutated_self_attr(node)
            if target is not None and locks.root(target.attr) is None:
                accesses.append(_Access(
                    attr=target.attr, node=target, method=method.name,
                    write=True, locked=bool(held),
                    exempt=(m_exempt or _locks.line_annotation(
                        ctx, target.lineno) is not None),
                    lock_root=held[-1] if held else None))
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "self" \
                    and locks.root(node.attr) is None:
                write = isinstance(node.ctx, (ast.Store, ast.Del))
                accesses.append(_Access(
                    attr=node.attr, node=node, method=method.name,
                    write=write, locked=bool(held),
                    exempt=(m_exempt or _locks.line_annotation(
                        ctx, node.lineno) is not None),
                    lock_root=held[-1] if held else None))
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for stmt in method.body:
            visit(stmt, ())

    for node in cls.body:
        if isinstance(node, _FUNCS):
            method_scan(node)
    return accesses


def check(ctx: FileContext, project: ProjectInfo) -> list[Finding]:
    if not ctx.rel.startswith("spacemesh_tpu_torch/"):
        return []
    facts = _locks.thread_facts(project)
    findings: list[Finding] = []

    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        if not facts.is_threaded(node):
            continue
        locks = _locks.collect_class_locks(node)
        if not locks.roots:
            continue
        accesses = _class_accesses(ctx, node, locks)
        by_attr: dict[str, list[_Access]] = {}
        for a in accesses:
            by_attr.setdefault(a.attr, []).append(a)
        for attr, accs in sorted(by_attr.items()):
            # annotated-function accesses are exempt AND do not
            # establish guardedness (the discipline is the caller's)
            locked = [a for a in accs if a.locked and not a.exempt]
            if not locked:
                continue
            written = any(a.write for a in accs if not a.exempt)
            if not written:
                continue  # read-only outside __init__: race-free
            guard = locked[0].lock_root
            reported: set[tuple[str, str]] = set()
            for a in accs:
                if a.locked or a.exempt:
                    continue
                key = (a.method, attr)
                if key in reported:
                    continue  # one finding per (method, attribute)
                reported.add(key)
                what = "written" if a.write else "read"
                findings.append(ctx.finding(
                    RULE, a.node,
                    f"self.{attr} is accessed under self.{guard} in "
                    f"{locked[0].method}() but {what} bare in "
                    f"{a.method}() — {node.name} runs on multiple "
                    "threads; hold the lock, or annotate the site "
                    "(`# guarded by: <lock>` / "
                    "`# spacecheck: loop-only <why>`)"))
    return findings
