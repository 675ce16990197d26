"""Shared lock/thread facts for the concurrency rules (SC007/SC008).

Both rules need the same two project-wide facts, collected once per run
through the ``ProjectInfo.cache`` handoff (the SC003 pattern):

* **lock attributes** — per class: ``self.X = threading.Lock()`` /
  ``RLock()`` / ``Condition(...)`` (and the sanitize-instrumented twins
  ``sanitize.lock(...)`` / ``sanitize.condition(...)``), with Condition
  aliasing resolved to the root lock (``self._idle =
  threading.Condition(self._lock)`` guards the SAME critical sections
  as ``self._lock``). Module-level ``X = threading.Lock()`` is tracked
  too (SC008's graph).
* **threaded classes** — classes whose methods run off the constructing
  thread: a ``threading.Thread(target=self.m)``, ``executor.submit``,
  ``loop.run_in_executor``, ``call_soon_threadsafe`` or
  ``asyncio.to_thread`` call targeting one of the class's methods (or a
  lambda/local closure over ``self``), anywhere in the project.
"""

from __future__ import annotations

import ast

from ..engine import FileContext, ProjectInfo, dotted_name

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)

# call attrs that hand their callable argument(s) to another thread
_SPAWNERS = {"submit", "run_in_executor", "call_soon_threadsafe",
             "to_thread", "start_soon", "run_coroutine_threadsafe"}

_LOCK_FACTORIES = {"Lock", "RLock"}
_COND_FACTORIES = {"Condition"}


def _is_sanitize_recv(recv: str | None) -> bool:
    return bool(recv) and recv.rsplit(".", 1)[-1] == "sanitize"


def _lock_factory_kind(call: ast.Call) -> str | None:
    """"lock" / "cond" when ``call`` constructs a (tracked) lock."""
    name = dotted_name(call.func)
    if name is None:
        return None
    last = name.rsplit(".", 1)[-1]
    recv = name.rsplit(".", 1)[0] if "." in name else None
    if last in _LOCK_FACTORIES:
        return "lock"
    if last in _COND_FACTORIES:
        return "cond"
    if _is_sanitize_recv(recv) and last in ("lock", "tracked_lock"):
        return "lock"
    if _is_sanitize_recv(recv) and last in ("condition",
                                            "tracked_condition"):
        return "cond"
    return None


class ClassLocks:
    """Lock attributes of one class, with Condition aliases resolved."""

    def __init__(self) -> None:
        self.roots: dict[str, str] = {}  # attr -> root lock attr

    def add(self, attr: str, kind: str, alias_of: str | None) -> None:
        if kind == "cond" and alias_of is not None:
            self.roots[attr] = self.roots.get(alias_of, alias_of)
        else:
            self.roots[attr] = attr

    def root(self, attr: str) -> str | None:
        return self.roots.get(attr)


def collect_class_locks(cls: ast.ClassDef) -> ClassLocks:
    locks = ClassLocks()
    for node in ast.walk(cls):
        if not (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)):
            continue
        kind = _lock_factory_kind(node.value)
        if kind is None:
            continue
        alias = None
        for arg in node.value.args:
            if isinstance(arg, ast.Attribute) \
                    and isinstance(arg.value, ast.Name) \
                    and arg.value.id == "self":
                alias = arg.attr
                break
        for tgt in node.targets:
            if isinstance(tgt, ast.Attribute) \
                    and isinstance(tgt.value, ast.Name) \
                    and tgt.value.id == "self":
                locks.add(tgt.attr, kind, alias)
    return locks


def module_locks(tree: ast.Module) -> set[str]:
    """Module-level names bound to a lock factory."""
    out: set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) \
                and isinstance(node.value, ast.Call) \
                and _lock_factory_kind(node.value) is not None:
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out.add(tgt.id)
    return out


def _spawn_targets(call: ast.Call) -> list[ast.AST] | None:
    """The callable-ish arguments of a thread-spawning call, or None
    when ``call`` is not a spawn site."""
    func = call.func
    name = dotted_name(func)
    last = name.rsplit(".", 1)[-1] if name else None
    if last == "Thread":
        for kw in call.keywords:
            if kw.arg == "target":
                return [kw.value]
        return list(call.args[:1])
    if isinstance(func, ast.Attribute) and func.attr in _SPAWNERS:
        return list(call.args) + [kw.value for kw in call.keywords]
    return None


class ThreadFacts:
    """Which classes have methods running on more than one thread."""

    def __init__(self) -> None:
        self.threaded_classes: set[str] = set()
        # method names spawned through a non-self receiver anywhere
        # (``threading.Thread(target=writer._worker)``): any class
        # defining one of these is conservatively treated as threaded
        self.spawned_method_names: set[str] = set()

    def is_threaded(self, cls: ast.ClassDef) -> bool:
        if cls.name in self.threaded_classes:
            return True
        return any(isinstance(n, _FUNCS)
                   and n.name in self.spawned_method_names
                   for n in cls.body)


def _collect_threads(ctx: FileContext, facts: ThreadFacts) -> None:
    def visit(node: ast.AST, cls: str | None) -> None:
        if isinstance(node, ast.ClassDef):
            cls = node.name
        elif isinstance(node, ast.Call):
            targets = _spawn_targets(node)
            if targets is not None:
                for t in targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name):
                        if t.value.id == "self" and cls is not None:
                            facts.threaded_classes.add(cls)
                        else:
                            facts.spawned_method_names.add(t.attr)
                    elif isinstance(t, (ast.Lambda, ast.Name)) \
                            and cls is not None:
                        # a lambda/local closure handed to a pool still
                        # drags self onto the worker thread
                        facts.threaded_classes.add(cls)
        for child in ast.iter_child_nodes(node):
            visit(child, cls)

    visit(ctx.tree, None)


def thread_facts(project: ProjectInfo) -> ThreadFacts:
    cached = project.cache.get("concurrency_threads")
    if cached is None:
        cached = ThreadFacts()
        for ctx in project.contexts:
            _collect_threads(ctx, cached)
        project.cache["concurrency_threads"] = cached
    return cached


# --- annotations ---------------------------------------------------------

GUARDED_BY = "guarded by:"
LOOP_ONLY = "loop-only"


def _comment_annotation(text: str | None) -> str | None:
    """"guarded" / "loop-only" when the comment carries one of the two
    exemption annotations (each must name a lock / carry a why)."""
    if not text:
        return None
    low = text.lower()
    i = low.find(GUARDED_BY)
    if i >= 0 and len(text[i + len(GUARDED_BY):].strip()) >= 4:
        return "guarded"
    i = low.find(LOOP_ONLY)
    if i >= 0 and "spacecheck" in low:
        return "loop-only"
    return None


def line_annotation(ctx: FileContext, lineno: int) -> str | None:
    """Annotation covering ``lineno``: on the line itself, or on a
    standalone comment line directly above it."""
    ann = _comment_annotation(ctx.comments.get(lineno))
    if ann:
        return ann
    above = ctx.comments.get(lineno - 1)
    if above and lineno - 2 < len(ctx.lines):
        own = ctx.lines[lineno - 2].lstrip()
        if own.startswith("#"):
            return _comment_annotation(above)
    return None


def function_annotation(ctx: FileContext, fn: ast.AST) -> str | None:
    """A ``# guarded by: <lock>`` on (or directly above) the ``def``
    line declares the whole function runs with that lock held — the
    caller-holds-the-lock idiom (``_pick_job``, ``_tick_locked``)."""
    return line_annotation(ctx, fn.lineno)
