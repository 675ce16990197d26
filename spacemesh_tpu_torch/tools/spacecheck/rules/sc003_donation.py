"""SC003 donation-safety: no reads of a donated buffer after the call.

Originating bug: the pre-pallas carry copy — ``scrypt_labels_with_min``
donated its device carry to a Pallas attempt; when the dispatch failed
*after* compile, the XLA fallback retried with the same (now invalid)
reference. The fix keeps an independent copy alive before any call that
may donate. ``donate_argnums`` invalidates the Python reference on the
caller's side: any later read of the same name in the same scope is a
use-after-free that JAX only sometimes reports (and on TPU can silently
alias).

Detection: the rule collects every callable built with
``donate_argnums=`` / ``donate_argnames=`` (``jax.jit(f, donate_...)``
assignments and ``@functools.partial(jax.jit, donate_...)`` decorators)
across the whole tree, then walks each function in source order: an
argument name passed in a donated position marks that name consumed;
any later load of the name before it is rebound flags. Rebinding
(``carry = step(carry, ...)`` — the standard rotate) clears the mark,
so the idiomatic donated-carry loop is clean.

In the port: torch has no ``donate_argnums``; an in-place op or an
``out=`` argument reuses a buffer visibly at the call site instead, so
the rule finds no donating callable in ``spacemesh_tpu_torch/`` and
flags nothing there. It is kept whole so that a ``jax.jit``-style
wrapper, were one ever added, is held to the same contract.

Suppress a deliberate post-donation read (e.g. a shape/dtype attribute
that never touches the buffer) with ``# spacecheck: ok=SC003 <why>``.
"""

from __future__ import annotations

import ast

from ..engine import FileContext, Finding, ProjectInfo, dotted_name

RULE = "SC003"

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _donation_keywords(call: ast.Call):
    """-> (positions, keyword names) declared by donate_argnums/names."""
    positions: set[int] = set()
    names: set[str] = set()
    for kw in call.keywords:
        if kw.arg == "donate_argnums":
            v = kw.value
            elts = v.elts if isinstance(v, (ast.Tuple, ast.List)) else [v]
            for e in elts:
                if isinstance(e, ast.Constant) and isinstance(e.value, int):
                    positions.add(e.value)
        elif kw.arg == "donate_argnames":
            v = kw.value
            elts = v.elts if isinstance(v, (ast.Tuple, ast.List)) else [v]
            for e in elts:
                if isinstance(e, ast.Constant) and isinstance(e.value, str):
                    names.add(e.value)
    return positions, names


def _collect_file(tree: ast.Module) -> dict[str, tuple[set[int], set[str]]]:
    """{callable name: (donated positions, donated kw names)}."""
    out: dict[str, tuple[set[int], set[str]]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            pos, names = _donation_keywords(node.value)
            if pos or names:
                for tgt in node.targets:
                    name = dotted_name(tgt)
                    if name:
                        out[name.rsplit(".", 1)[-1]] = (pos, names)
        elif isinstance(node, _FUNCS):
            for dec in node.decorator_list:
                if isinstance(dec, ast.Call):
                    pos, names = _donation_keywords(dec)
                    if pos or names:
                        out[node.name] = (pos, names)
    return out


def _donated_map(project: ProjectInfo) -> dict[str, tuple[set[int], set[str]]]:
    cached = project.cache.get("sc003_donated")
    if cached is None:
        cached = {}
        for ctx in project.contexts:
            cached.update(_collect_file(ctx.tree))
        project.cache["sc003_donated"] = cached
    return cached


def check(ctx: FileContext, project: ProjectInfo) -> list[Finding]:
    donated = _donated_map(project)
    if not donated:
        return []
    findings: list[Finding] = []

    def scan_scope(body: list[ast.stmt]) -> None:
        # dotted name -> (donating call lineno, callee name)
        consumed: dict[str, tuple[int, str]] = {}

        def mark_store(node: ast.AST) -> None:
            name = dotted_name(node)
            if name is not None:
                consumed.pop(name, None)
            for child in ast.iter_child_nodes(node):
                mark_store(child)

        def visit(node: ast.AST, in_load: bool = True) -> None:
            if isinstance(node, _FUNCS + (ast.Lambda,)):
                return  # nested scopes analyzed separately
            # evaluation order, not AST field order: an Assign's value
            # runs BEFORE its targets bind, so `carry = step(carry)` is
            # donate-then-rebind (clean), never read-after-donate
            if isinstance(node, ast.Assign):
                visit(node.value)
                for tgt in node.targets:
                    visit(tgt)
                return
            if isinstance(node, ast.AnnAssign):
                if node.value is not None:
                    visit(node.value)
                visit(node.target)
                return
            if isinstance(node, ast.AugAssign):
                visit(node.value)
                # aug-assign READS the target before rebinding it
                name = dotted_name(node.target)
                hit = consumed.get(name) if name else None
                if hit is not None:
                    findings.append(ctx.finding(
                        RULE, node,
                        f"{name} was donated to {hit[1]}() on line "
                        f"{hit[0]} and aug-assigned here: the read half "
                        "touches the invalidated buffer"))
                mark_store(node.target)
                return
            if isinstance(node, (ast.For, ast.AsyncFor)):
                visit(node.iter)
                visit(node.target)
                for stmt in node.body + node.orelse:
                    visit(stmt)
                return
            if isinstance(node, (ast.Name, ast.Attribute)) \
                    and isinstance(getattr(node, "ctx", None),
                                   (ast.Store, ast.Del)):
                mark_store(node)
                return
            if isinstance(node, (ast.Name, ast.Attribute)) and in_load:
                name = dotted_name(node)
                # reading carry.sum (or carry.shape[0]) reads carry:
                # check every dotted prefix against the consumed set
                hit, hit_name = None, name
                while name:
                    hit = consumed.get(name)
                    if hit is not None:
                        hit_name = name
                        break
                    name = name.rpartition(".")[0]
                name = hit_name
                if hit is not None:
                    line, callee = hit
                    findings.append(ctx.finding(
                        RULE, node,
                        f"{name} was donated to {callee}() on line "
                        f"{line} and read again here: the buffer may be "
                        "invalidated/aliased — copy before the donating "
                        "call or rebind the name from its result"))
                    consumed.pop(name, None)  # one finding per donation
                if isinstance(node, ast.Attribute):
                    # the receiver chain is covered by the dotted check
                    return
            if isinstance(node, ast.Call):
                callee = dotted_name(node.func)
                short = callee.rsplit(".", 1)[-1] if callee else None
                # evaluate args first (reads of already-donated refs at
                # the call site still flag), then mark this call's
                # donations
                for child in ast.iter_child_nodes(node):
                    visit(child)
                if short in donated:
                    pos, kwnames = donated[short]
                    for idx, arg in enumerate(node.args):
                        if idx in pos:
                            name = dotted_name(arg)
                            if name:
                                consumed[name] = (node.lineno, short)
                    for kw in node.keywords:
                        if kw.arg in kwnames:
                            name = dotted_name(kw.value)
                            if name:
                                consumed[name] = (node.lineno, short)
                return
            for child in ast.iter_child_nodes(node):
                visit(child)

        for stmt in body:
            visit(stmt)

    def walk_scopes(node: ast.AST) -> None:
        if isinstance(node, _FUNCS):
            scan_scope(node.body)
        for child in ast.iter_child_nodes(node):
            walk_scopes(child)

    scan_scope(ctx.tree.body)
    walk_scopes(ctx.tree)
    return findings
