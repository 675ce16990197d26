"""SC001 clock-discipline: no wall-clock reads in virtual-time modules.

Originating bugs: ``time.time()`` had to be chased out of p2p/fetch.py
and node/peersync.py so chaos timeskew and the sim scenario engine could
skew them ("loop-clock-based => virtual-aware"), and the audit that
followed left 45 wall-clock call sites across 17 files un-audited. A wall-clock read inside a virtual-time-aware module is
invisible to every deterministic scenario: penalty windows, cert
expiries, and heartbeats silently run on real time while the rest of
the node runs on the virtual clock.

Flags, inside the virtual-time-aware packages (``sim/``, ``obs/``,
``node/``, ``p2p/``, ``consensus/``):

* calls to ``time.time()`` / ``time.monotonic()`` (any import alias);
* calls to ``<something named *loop*>.time()`` — the event-loop clock
  is only virtual under a VirtualClockLoop, so using it as a time
  source is a per-site decision that must be justified with a pragma;
* ``asyncio.sleep(<nonzero literal>)`` — sleep-and-hope delays that a
  scenario cannot compress (``asyncio.sleep(0)`` yields are fine).

Compliant instead: take an injected time source. A call is exempt when
an enclosing function has a parameter named ``now`` / ``time_source`` /
``wall`` / ``clock`` / ``time_fn`` (the module "takes an injected
time_source" and the wall call is its declared default), when the line
carries ``# spacecheck: ok=SC001 <why>``, or when the module header
declares ``# spacecheck: wall-clock-ok <why>``.
"""

from __future__ import annotations

import ast

from ..engine import FileContext, Finding, ProjectInfo, dotted_name, \
    time_module_aliases

RULE = "SC001"

SCOPE_PREFIXES = (
    "spacemesh_tpu_torch/sim/",
    "spacemesh_tpu_torch/obs/",
    "spacemesh_tpu_torch/node/",
    "spacemesh_tpu_torch/p2p/",
    "spacemesh_tpu_torch/consensus/",
)

INJECTED_PARAMS = {"now", "time_source", "wall", "clock", "time_fn"}

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _param_names(fn) -> set[str]:
    a = fn.args
    params = list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)
    if a.vararg:
        params.append(a.vararg)
    if a.kwarg:
        params.append(a.kwarg)
    return {p.arg for p in params}


def in_scope(rel: str) -> bool:
    return rel.startswith(SCOPE_PREFIXES)


def check(ctx: FileContext, project: ProjectInfo) -> list[Finding]:
    if not in_scope(ctx.rel):
        return []
    if RULE in ctx.module_pragmas:
        return []
    time_aliases = time_module_aliases(ctx.tree)
    findings: list[Finding] = []
    fn_stack: list[set[str]] = []  # parameter-name sets of enclosing defs

    def injected() -> bool:
        return any(params & INJECTED_PARAMS for params in fn_stack)

    def check_call(node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute):
            recv = dotted_name(func.value)
            if func.attr in ("time", "monotonic") and recv in time_aliases:
                if not injected():
                    findings.append(ctx.finding(
                        RULE, node,
                        f"wall-clock read {recv}.{func.attr}() in a "
                        "virtual-time-aware module; inject a time_source "
                        "or pragma with a justification"))
                return
            if func.attr == "time" and recv is not None \
                    and "loop" in recv.rsplit(".", 1)[-1].lower():
                if not injected():
                    findings.append(ctx.finding(
                        RULE, node,
                        f"{recv}.time() is only virtual under a "
                        "VirtualClockLoop; justify the loop clock as this "
                        "site's time source with a pragma or inject one"))
                return
            name = dotted_name(func)
            if name in ("asyncio.sleep",):
                _check_sleep(node)
        elif isinstance(func, ast.Name) and func.id == "sleep":
            # `from asyncio import sleep` — rare, treat as asyncio.sleep
            _check_sleep(node)

    def _check_sleep(node: ast.Call) -> None:
        if not node.args:
            return
        arg = node.args[0]
        neg = (isinstance(arg, ast.UnaryOp)
               and isinstance(arg.op, ast.USub)
               and isinstance(arg.operand, ast.Constant))
        if isinstance(arg, ast.Constant) or neg:
            value = arg.operand.value if neg else arg.value
            if isinstance(value, (int, float)) and value > 0:
                findings.append(ctx.finding(
                    RULE, node,
                    f"literal asyncio.sleep({value}) in a virtual-time-"
                    "aware module: scenarios cannot compress fixed "
                    "delays; derive the delay from config/clock state or "
                    "pragma with a justification"))

    def visit(node: ast.AST) -> None:
        is_fn = isinstance(node, _FUNCS)
        if is_fn:
            fn_stack.append(_param_names(node))
        elif isinstance(node, ast.Lambda):
            fn_stack.append({a.arg for a in node.args.args})
            is_fn = True
        if isinstance(node, ast.Call):
            check_call(node)
        for child in ast.iter_child_nodes(node):
            visit(child)
        if is_fn:
            fn_stack.pop()

    visit(ctx.tree)
    return findings
