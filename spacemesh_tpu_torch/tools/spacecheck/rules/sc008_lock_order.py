"""SC008 lock-order: no acquisition cycles, no ``await`` under a lock.

Originating bugs: the runtime scheduler grew three conditions over one
lock plus a worker pool, the farm and the runtime queue share admission
state across the loop and backend threads — one nested ``with`` in the
wrong order away from a deadlock no test ever hits (lock inversions
need the losing interleaving; the graph doesn't). And the event-loop
twin: a ``threading.Lock`` held across an ``await`` parks every other
acquirer for as long as the coroutine stays suspended — the whole loop,
when the other acquirer IS the loop (the flight-dump class, with a lock
attached).

Two checks (``spacemesh_tpu_torch/`` package code only):

* **lock-order cycles** — the pre-pass collects every lock attribute
  (``rules/_locks.py``: ``threading.Lock/RLock/Condition`` and the
  sanitize-tracked twins, Conditions aliased to their root lock) and
  module-level locks, then builds the project-wide acquisition graph:
  a ``with self.B:`` lexically inside ``with self.A:`` adds edge A→B,
  and a call to a same-class method that acquires B while A is held
  adds A→B too (one call level). Any edge on a cycle flags at its
  acquisition site. The runtime lock-order watcher
  (``utils/sanitize.py``) catches the orders the AST can't see.
* **await under a held threading lock** — inside ``async def``, an
  ``await`` lexically inside ``with <known threading lock>:`` flags
  (nested ``def``s excluded). Use ``asyncio.Lock`` + ``async with``
  for loop-side mutual exclusion, or move the locked section to
  ``asyncio.to_thread``.

Suppress a deliberate site with ``# spacecheck: ok=SC008 <why>``.
"""

from __future__ import annotations

import ast
import dataclasses

from ..engine import FileContext, Finding, ProjectInfo
from . import _locks

RULE = "SC008"

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


@dataclasses.dataclass
class _Edge:
    src: str
    dst: str
    rel: str
    node: ast.AST           # acquisition (or call) site of ``dst``
    via_call: str | None    # method name when the edge is call-through


class _Graph:
    def __init__(self) -> None:
        self.edges: list[_Edge] = []
        self.adj: dict[str, set[str]] = {}

    def add(self, edge: _Edge) -> None:
        self.edges.append(edge)
        self.adj.setdefault(edge.src, set()).add(edge.dst)

    def reaches(self, src: str, dst: str) -> bool:
        seen: set[str] = set()
        stack = [src]
        while stack:
            n = stack.pop()
            if n == dst:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(self.adj.get(n, ()))
        return False


def _lock_node(expr: ast.AST, cls: ast.ClassDef | None,
               locks: _locks.ClassLocks | None,
               mod_locks: set[str], rel: str) -> str | None:
    """The graph node id a ``with`` context expression acquires."""
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name) \
            and expr.value.id == "self" and locks is not None:
        root = locks.root(expr.attr)
        if root is not None and cls is not None:
            return f"{cls.name}.{root}"
    elif isinstance(expr, ast.Name) and expr.id in mod_locks:
        return f"{rel}:{expr.id}"
    return None


def _method_acquires(method: ast.AST, cls: ast.ClassDef,
                     locks: _locks.ClassLocks, mod_locks: set[str],
                     rel: str) -> set[str]:
    """Locks ``method`` acquires anywhere in its own body."""
    out: set[str] = set()

    def visit(node: ast.AST) -> None:
        if isinstance(node, _FUNCS + (ast.Lambda,)) and node is not method:
            return
        if isinstance(node, ast.With):
            for item in node.items:
                n = _lock_node(item.context_expr, cls, locks, mod_locks,
                               rel)
                if n is not None:
                    out.add(n)
        for child in ast.iter_child_nodes(node):
            visit(child)

    visit(method)
    return out


def _build_graph(project: ProjectInfo) -> _Graph:
    graph = project.cache.get("sc008_graph")
    if graph is not None:
        return graph
    graph = _Graph()
    for ctx in project.contexts:
        if not ctx.rel.startswith("spacemesh_tpu_torch/"):
            continue
        mod_locks = _locks.module_locks(ctx.tree)
        classes = [n for n in ast.walk(ctx.tree)
                   if isinstance(n, ast.ClassDef)]
        cls_locks = {id(c): _locks.collect_class_locks(c) for c in classes}
        cls_methods = {id(c): {m.name: m for m in c.body
                               if isinstance(m, _FUNCS)} for c in classes}

        def scan(fn: ast.AST, cls: ast.ClassDef | None) -> None:
            locks = cls_locks.get(id(cls)) if cls is not None else None
            methods = cls_methods.get(id(cls), {}) if cls is not None \
                else {}

            def visit(node: ast.AST, held: tuple[str, ...]) -> None:
                if isinstance(node, _FUNCS + (ast.Lambda,)) \
                        and node is not fn:
                    return  # its own scan() starts a fresh held stack
                if isinstance(node, ast.With):
                    inner = held
                    for item in node.items:
                        n = _lock_node(item.context_expr, cls, locks,
                                       mod_locks, ctx.rel)
                        if n is not None:
                            for h in inner:
                                if h != n:
                                    graph.add(_Edge(h, n, ctx.rel,
                                                    node, None))
                            inner = inner + (n,)
                    for child in node.body:
                        visit(child, inner)
                    return
                if held and isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and isinstance(node.func.value, ast.Name) \
                        and node.func.value.id == "self" \
                        and node.func.attr in methods \
                        and methods[node.func.attr] is not fn:
                    callee = methods[node.func.attr]
                    for n in _method_acquires(callee, cls, locks,
                                              mod_locks, ctx.rel):
                        for h in held:
                            if h != n:
                                graph.add(_Edge(h, n, ctx.rel, node,
                                                node.func.attr))
                for child in ast.iter_child_nodes(node):
                    visit(child, held)

            visit(fn, ())

        def walk(node: ast.AST, cls: ast.ClassDef | None) -> None:
            if isinstance(node, ast.ClassDef):
                cls = node
            elif isinstance(node, _FUNCS):
                scan(node, cls)
            for child in ast.iter_child_nodes(node):
                walk(child, cls)

        walk(ctx.tree, None)
    project.cache["sc008_graph"] = graph
    return graph


def _check_await_under_lock(ctx: FileContext,
                            findings: list[Finding]) -> None:
    mod_locks = _locks.module_locks(ctx.tree)
    classes = [n for n in ast.walk(ctx.tree) if isinstance(n, ast.ClassDef)]
    cls_locks = {id(c): _locks.collect_class_locks(c) for c in classes}

    def scan_async(fn: ast.AsyncFunctionDef,
                   cls: ast.ClassDef | None) -> None:
        locks = cls_locks.get(id(cls)) if cls is not None else None

        def visit(node: ast.AST, lock: str | None) -> None:
            if isinstance(node, _FUNCS + (ast.Lambda,)) and node is not fn:
                return
            if isinstance(node, ast.With):
                inner = lock
                for item in node.items:
                    n = _lock_node(item.context_expr, cls, locks,
                                   mod_locks, ctx.rel)
                    if n is not None:
                        inner = n
                for child in node.body:
                    visit(child, inner)
                return
            if isinstance(node, ast.Await) and lock is not None:
                findings.append(ctx.finding(
                    RULE, node,
                    f"await inside `with {lock.split('.')[-1]}` in async "
                    f"def {fn.name}(): a threading lock held across a "
                    "suspension parks every other acquirer (and wedges "
                    "the event loop when the loop is one of them) — use "
                    "asyncio.Lock/async with, or move the locked "
                    "section off the loop"))
            for child in ast.iter_child_nodes(node):
                visit(child, lock)

        for stmt in fn.body:
            visit(stmt, None)

    def walk(node: ast.AST, cls: ast.ClassDef | None) -> None:
        if isinstance(node, ast.ClassDef):
            cls = node
        if isinstance(node, ast.AsyncFunctionDef):
            scan_async(node, cls)
        for child in ast.iter_child_nodes(node):
            walk(child, cls)

    walk(ctx.tree, None)


def check(ctx: FileContext, project: ProjectInfo) -> list[Finding]:
    if not ctx.rel.startswith("spacemesh_tpu_torch/"):
        return []
    findings: list[Finding] = []
    graph = _build_graph(project)
    seen: set[int] = set()
    for edge in graph.edges:
        if edge.rel != ctx.rel or id(edge.node) in seen:
            continue
        if graph.reaches(edge.dst, edge.src):
            seen.add(id(edge.node))
            via = (f" (via self.{edge.via_call}())"
                   if edge.via_call else "")
            findings.append(ctx.finding(
                RULE, edge.node,
                f"lock-order cycle: {edge.dst} acquired while holding "
                f"{edge.src}{via}, but the project also acquires them "
                "in the opposite order — two threads taking the two "
                "paths deadlock; pick one global order"))
    _check_await_under_lock(ctx, findings)
    return findings
