"""SC004 pairing: acquire/release lifecycles must pair on all paths.

Originating bugs: the name-only watchdog eviction (``App.close``
unregistered health probes by name and evicted a successor node's
probes — the fix unregisters by equality, and registration/cleanup now
pair explicitly), and the review fix closing the prover's cached
read fds per session. The shared shape: an acquire with a release that
is missing, or present but skipped on the exception path.

Checked pairings (package code only — ``tests/`` is exempt, test
teardown runs through fixtures):

* **health probes** — a function calling ``HEALTH.register(...)``
  (any receiver whose dotted name ends in ``HEALTH``/``health``) must
  either unregister in a ``finally`` in the same function, or belong
  to a class that unregisters in another method (the long-lived
  component split lifecycle). An unregister that exists in the same
  function but NOT under ``finally`` flags: the exception path leaks
  the probe.
* **manual span brackets** — ``x.__enter__()`` requires
  ``x.__exit__(...)`` under a ``finally`` in the same function (the
  autotune race uses exactly this shape; an unguarded exit loses the
  span AND the contextvar reset on error).
* **collectors** — ``<registry>.add_collector(...)`` has no remove;
  calling it anywhere a second construction can reach (i.e. inside a
  function) re-adds the hook forever. obs/sli.py keys idempotence on a
  registry attribute; such guarded sites carry a pragma.
* **executors/fds** — a ``ThreadPoolExecutor(...)``/``open(...)``/
  ``os.open(...)`` result bound to a *local* name must be closed in a
  ``finally`` or managed by ``with``; escaping the function (returned,
  stored on an attribute, passed to another call) hands the lifecycle
  elsewhere and is accepted.
* **runtime job handles** — a ``<scheduler>.submit_init/submit_prove/
  submit_verify/submit_pow/submit_call/submit_proof(...)`` JobHandle
  bound to a local must be CONSUMED (``.result()``/``.wait()``
  anywhere) or ``.cancel()``ed under ``finally``, or escape — the
  defect class the runtime deleted from four pipelines must not
  re-enter through its own submission API (an orphaned handle is a job
  whose failure nobody observes and whose tenant quota slot pins until
  resolution).
* **tenant registration** — ``<scheduler>.register_tenant(...)``
  pairs with ``unregister_tenant`` exactly like the HEALTH probes: in
  a ``finally`` in the same function, or in a sibling method of the
  same class (the long-lived component split); a gone identity must
  not pin its per-tenant gauge series and fair-share state forever.
* **verifyd client registration** — ``<service>.register_client(...)``
  pairs with ``unregister_client`` under the same rules as tenants: a
  disconnected client that is never unregistered pins its token
  bucket, scheduler tenant, and every per-client metric series (the
  cardinality bound the verifyd max_clients knob exists to keep).
* **verifyd server lifecycle** — a local bound to a
  ``VerifydServer(...)``/``VerifydService(...)`` construction that is
  ``start()``ed must ``close()``/``aclose()``/``stop()`` under a
  ``finally`` in the same function, or escape (returned/stored/passed
  — the lifecycle is handed elsewhere); a server leaked on the error
  path strands its scheduler worker threads, farm tasks, and bound
  sockets.
* **remediation lifecycles** — ``RemediationEngine(...)``
  and ``FailoverVerifier(...)`` locals that are ``start()``ed follow
  the same started-must-close rule (a leaked engine keeps consuming
  bus verdicts; a leaked failover verifier pins its breaker series);
  and breaker/hook registrations —
  ``<...>BREAKERS.register(...)`` / ``<...>ACTIONS.register(...)``
  (obs/remediate.py's global registries) — pair with ``unregister``
  exactly like HEALTH probes: in a ``finally`` in the same function,
  or in a sibling method (the long-lived component split).  An
  unpaired breaker pins its ``remediation_breaker_*`` series forever;
  an unpaired hook lets a dead component keep receiving recovery
  actions.
* **fleet lifecycles** — ``FleetRouter(...)`` and
  ``FleetVerifier(...)`` locals that are ``start()``ed follow the
  started-must-close rule too (a leaked router pins every replica's
  breaker and ``fleet_replica_*`` series); and
  ``<router>.register_replica(...)`` pairs with
  ``unregister_replica`` exactly like tenants/clients — a replica
  that left the fleet without unregistering keeps its breaker on the
  global registry, its per-replica series in the exposition, and its
  clients pinned to a ghost.

Suppress a deliberate unpaired site with ``# spacecheck: ok=SC004 <why>``.
"""

from __future__ import annotations

import ast

from ..engine import FileContext, Finding, ProjectInfo, dotted_name

RULE = "SC004"

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)
_ACQUIRE_FACTORIES = {"ThreadPoolExecutor", "ProcessPoolExecutor"}
_SUBMITS = {"submit_init", "submit_prove", "submit_verify", "submit_pow",
            "submit_call", "submit_proof"}
_HANDLE_CONSUME = {"result", "wait"}


def _is_health_recv(recv: str | None) -> bool:
    if not recv:
        return False
    last = recv.rsplit(".", 1)[-1]
    return last in ("HEALTH", "health") or last.endswith("HEALTH")


def _is_remediation_recv(recv: str | None) -> bool:
    """The obs/remediate.py global registries: breaker registrations
    (``BREAKERS``) and recovery-action hooks (``ACTIONS``)."""
    if not recv:
        return False
    last = recv.rsplit(".", 1)[-1]
    return last.endswith("BREAKERS") or last.endswith("ACTIONS")


def _finally_linenos(fn: ast.AST) -> list[tuple[int, int, int]]:
    """(try lineno, finally-body first lineno, finally-body last lineno)
    for every try/finally lexically inside ``fn`` (nested defs skipped)."""
    spans: list[tuple[int, int, int]] = []

    def visit(node: ast.AST) -> None:
        if isinstance(node, _FUNCS + (ast.Lambda,)) and node is not fn:
            return
        if isinstance(node, ast.Try) and node.finalbody:
            first = node.finalbody[0].lineno
            last = max(getattr(n, "end_lineno", first) or first
                       for n in node.finalbody)
            spans.append((node.lineno, first, last))
        for child in ast.iter_child_nodes(node):
            visit(child)

    visit(fn)
    return spans


def _in_finally(spans, lineno: int) -> bool:
    return any(first <= lineno <= last for _, first, last in spans)


def _scoped(fn: ast.AST) -> list[ast.AST]:
    """Every node lexically in ``fn``'s own scope (nested defs and
    lambdas excluded — they are analyzed as their own scopes)."""
    out: list[ast.AST] = []

    def visit(node: ast.AST) -> None:
        if isinstance(node, _FUNCS + (ast.Lambda,)) and node is not fn:
            return
        out.append(node)
        for child in ast.iter_child_nodes(node):
            visit(child)

    visit(fn)
    return out


def _calls_in(fn: ast.AST) -> list[ast.Call]:
    return [n for n in _scoped(fn) if isinstance(n, ast.Call)]


def _class_methods(tree: ast.Module) -> dict[int, list[ast.AST]]:
    """id(method node) -> sibling method list (same class)."""
    out: dict[int, list[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            methods = [n for n in node.body if isinstance(n, _FUNCS)]
            for m in methods:
                out[id(m)] = methods
    return out


def check(ctx: FileContext, project: ProjectInfo) -> list[Finding]:
    if not ctx.rel.startswith("spacemesh_tpu_torch/"):
        return []
    findings: list[Finding] = []
    siblings = _class_methods(ctx.tree)

    _CM_DUNDERS = ("__enter__", "__aenter__", "__exit__", "__aexit__")

    def check_function(fn) -> None:
        spans = _finally_linenos(fn)
        calls = _calls_in(fn)
        # a context manager's own dunders acquire/release across the
        # enter/exit METHOD pair (and __aenter__ delegates to
        # self.__enter__()): pairing there is the class's protocol
        # contract, not a per-function leak
        cm_method = fn.name in _CM_DUNDERS
        registers: list[ast.Call] = []
        unregisters: list[ast.Call] = []
        t_registers: list[ast.Call] = []
        t_unregisters: list[ast.Call] = []
        c_registers: list[ast.Call] = []
        c_unregisters: list[ast.Call] = []
        r_registers: list[ast.Call] = []
        r_unregisters: list[ast.Call] = []
        f_registers: list[ast.Call] = []
        f_unregisters: list[ast.Call] = []
        enters: dict[str, ast.Call] = {}
        exits: dict[str, list[int]] = {}
        for call in calls:
            func = call.func
            if not isinstance(func, ast.Attribute):
                continue
            recv = dotted_name(func.value)
            if func.attr == "register" and _is_health_recv(recv):
                registers.append(call)
            elif func.attr == "unregister" and _is_health_recv(recv):
                unregisters.append(call)
            elif func.attr == "register" and _is_remediation_recv(recv):
                r_registers.append(call)
            elif func.attr == "unregister" \
                    and _is_remediation_recv(recv):
                r_unregisters.append(call)
            elif func.attr == "register_tenant":
                t_registers.append(call)
            elif func.attr == "unregister_tenant":
                t_unregisters.append(call)
            elif func.attr == "register_client":
                c_registers.append(call)
            elif func.attr == "unregister_client":
                c_unregisters.append(call)
            elif func.attr == "register_replica":
                f_registers.append(call)
            elif func.attr == "unregister_replica":
                f_unregisters.append(call)
            elif func.attr == "__enter__" and recv and not cm_method:
                enters[recv] = call
            elif func.attr == "__exit__" and recv:
                exits.setdefault(recv, []).append(call.lineno)
            elif func.attr == "add_collector":
                findings.append(ctx.finding(
                    RULE, call,
                    "add_collector() inside a function: collectors have "
                    "no remove, so any re-reachable construction re-adds "
                    "the hook forever; attach at module scope or guard "
                    "idempotently and pragma"))
        for call in registers:
            if any(_in_finally(spans, u.lineno) for u in unregisters):
                continue
            if unregisters:
                findings.append(ctx.finding(
                    RULE, call,
                    "HEALTH.register here but the unregister in this "
                    "function is not under finally: the exception path "
                    "leaks the probe"))
                continue
            sib = siblings.get(id(fn), [])
            paired = any(
                isinstance(c.func, ast.Attribute)
                and c.func.attr == "unregister"
                and _is_health_recv(dotted_name(c.func.value))
                for m in sib for c in _calls_in(m) if m is not fn)
            if not paired:
                findings.append(ctx.finding(
                    RULE, call,
                    "HEALTH.register without any unregister in this "
                    "function or its class: a finished component pins "
                    "its probe (and its component_healthy series) "
                    "forever"))
        for call in r_registers:
            if any(_in_finally(spans, u.lineno) for u in r_unregisters):
                continue
            if r_unregisters:
                findings.append(ctx.finding(
                    RULE, call,
                    "BREAKERS/ACTIONS register here but the unregister "
                    "in this function is not under finally: the "
                    "exception path pins the breaker's per-component "
                    "series (or leaves a dead component's recovery "
                    "hook live)"))
                continue
            sib = siblings.get(id(fn), [])
            paired = any(
                isinstance(c.func, ast.Attribute)
                and c.func.attr == "unregister"
                and _is_remediation_recv(dotted_name(c.func.value))
                for m in sib for c in _calls_in(m) if m is not fn)
            if not paired:
                findings.append(ctx.finding(
                    RULE, call,
                    "BREAKERS/ACTIONS register without any unregister "
                    "in this function or its class: a finished "
                    "component pins its remediation_breaker_* series "
                    "(or keeps receiving recovery actions) forever"))
        for call in t_registers:
            if any(_in_finally(spans, u.lineno) for u in t_unregisters):
                continue
            if t_unregisters:
                findings.append(ctx.finding(
                    RULE, call,
                    "register_tenant here but the unregister_tenant in "
                    "this function is not under finally: the exception "
                    "path pins the tenant's fair-share state and gauge "
                    "series"))
                continue
            sib = siblings.get(id(fn), [])
            paired = any(
                isinstance(c.func, ast.Attribute)
                and c.func.attr == "unregister_tenant"
                for m in sib for c in _calls_in(m) if m is not fn)
            if not paired:
                findings.append(ctx.finding(
                    RULE, call,
                    "register_tenant without any unregister_tenant in "
                    "this function or its class: a gone identity pins "
                    "its per-tenant series and scheduler state forever"))
        for call in c_registers:
            if any(_in_finally(spans, u.lineno) for u in c_unregisters):
                continue
            if c_unregisters:
                findings.append(ctx.finding(
                    RULE, call,
                    "register_client here but the unregister_client in "
                    "this function is not under finally: the exception "
                    "path pins the client's token bucket, tenant, and "
                    "per-client metric series"))
                continue
            sib = siblings.get(id(fn), [])
            paired = any(
                isinstance(c.func, ast.Attribute)
                and c.func.attr == "unregister_client"
                for m in sib for c in _calls_in(m) if m is not fn)
            if not paired:
                findings.append(ctx.finding(
                    RULE, call,
                    "register_client without any unregister_client in "
                    "this function or its class: a disconnected client "
                    "pins its per-client series and admission state "
                    "forever"))
        for call in f_registers:
            if any(_in_finally(spans, u.lineno) for u in f_unregisters):
                continue
            if f_unregisters:
                findings.append(ctx.finding(
                    RULE, call,
                    "register_replica here but the unregister_replica "
                    "in this function is not under finally: the "
                    "exception path pins the replica's breaker and "
                    "per-replica fleet series"))
                continue
            sib = siblings.get(id(fn), [])
            paired = any(
                isinstance(c.func, ast.Attribute)
                and c.func.attr == "unregister_replica"
                for m in sib for c in _calls_in(m) if m is not fn)
            if not paired:
                findings.append(ctx.finding(
                    RULE, call,
                    "register_replica without any unregister_replica "
                    "in this function or its class: a replica that "
                    "left the fleet pins its breaker registration and "
                    "fleet_replica_* series, and its clients stay "
                    "routed to a ghost"))
        for recv, call in enters.items():
            ok = any(_in_finally(spans, ln) and ln > call.lineno
                     for ln in exits.get(recv, []))
            if not ok:
                findings.append(ctx.finding(
                    RULE, call,
                    f"{recv}.__enter__() without a matching "
                    f"{recv}.__exit__() under finally: the error path "
                    "leaks the span/context"))
        _check_job_handles(fn, spans)
        _check_local_resources(fn, spans)
        _check_verifyd_servers(fn, spans)

    def _check_verifyd_servers(fn, spans) -> None:
        """A locally-constructed VerifydServer/VerifydService/
        RemediationEngine/FailoverVerifier that is start()ed must
        close/aclose/stop under finally, or escape."""
        nodes = _scoped(fn)
        owners: dict[str, ast.Assign] = {}
        for node in nodes:
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call) \
                    and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                cname = dotted_name(node.value.func)
                if cname and cname.rsplit(".", 1)[-1] in (
                        "VerifydServer", "VerifydService",
                        "RemediationEngine", "FailoverVerifier",
                        "FleetRouter", "FleetVerifier"):
                    owners[node.targets[0].id] = node
        if not owners:
            return
        started: dict[str, ast.Call] = {}
        closed: set[str] = set()
        escapes: set[str] = set()
        for node in nodes:
            if isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) \
                        and isinstance(f.value, ast.Name) \
                        and f.value.id in owners:
                    if f.attr == "start":
                        started.setdefault(f.value.id, node)
                    elif f.attr in ("close", "aclose", "stop") \
                            and _in_finally(spans, node.lineno):
                        closed.add(f.value.id)
                    continue
                for arg in list(node.args) + [k.value
                                              for k in node.keywords]:
                    if isinstance(arg, ast.Name) and arg.id in owners:
                        escapes.add(arg.id)
            elif isinstance(node, ast.Return) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id in owners:
                escapes.add(node.value.id)
            elif isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id in owners:
                escapes.add(node.value.id)
        for name, call in started.items():
            if name in closed or name in escapes:
                continue
            findings.append(ctx.finding(
                RULE, call,
                f"started component {name!r} has no finally-paired "
                "close/aclose/stop and never escapes: the error path "
                "strands its workers/subscriptions and pins its "
                "breaker/metric series"))

    def _check_job_handles(fn, spans) -> None:
        """Runtime scheduler submits: a JobHandle bound to a local must
        be consumed (.result()/.wait() anywhere), cancelled under
        finally, or escape the function."""
        handles: dict[str, ast.Assign] = {}
        nodes = _scoped(fn)
        for node in nodes:
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call) \
                    and isinstance(node.value.func, ast.Attribute) \
                    and node.value.func.attr in _SUBMITS \
                    and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                handles[node.targets[0].id] = node
        if not handles:
            return
        resolved: set[str] = set()
        escapes: set[str] = set()
        callfuncs = {id(n.func) for n in nodes if isinstance(n, ast.Call)}
        for node in nodes:
            if isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) \
                        and isinstance(f.value, ast.Name) \
                        and f.value.id in handles:
                    if f.attr in _HANDLE_CONSUME:
                        resolved.add(f.value.id)
                    elif f.attr == "cancel" \
                            and _in_finally(spans, node.lineno):
                        resolved.add(f.value.id)
                    continue
                for arg in list(node.args) + [k.value
                                              for k in node.keywords]:
                    if isinstance(arg, ast.Name) and arg.id in handles:
                        escapes.add(arg.id)
            elif isinstance(node, ast.Return) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id in handles:
                escapes.add(node.value.id)
            elif isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id in handles:
                escapes.add(node.value.id)
            elif isinstance(node, ast.Attribute) \
                    and id(node) not in callfuncs \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id in handles \
                    and isinstance(node.ctx, ast.Load) \
                    and node.attr not in ("id", "tenant", "kind"):
                # reading .future hands the lifecycle elsewhere
                # (asyncio.wrap_future, job tables)
                escapes.add(node.value.id)
        for name, stmt in handles.items():
            if name in resolved or name in escapes:
                continue
            findings.append(ctx.finding(
                RULE, stmt,
                f"runtime job handle {name!r} is never consumed "
                "(.result()/.wait()), never cancelled under finally, "
                "and never escapes: an orphaned job's failure is "
                "unobserved and its tenant quota slot pins until it "
                "resolves"))

    def _check_local_resources(fn, spans) -> None:
        assigned: dict[str, ast.Assign] = {}  # local name -> acquire stmt

        def acquire_kind(call: ast.Call) -> str | None:
            func = call.func
            if isinstance(func, ast.Name) and func.id == "open":
                return "open()"
            name = dotted_name(func)
            if name is None:
                return None
            last = name.rsplit(".", 1)[-1]
            if last in _ACQUIRE_FACTORIES:
                return f"{last}()"
            if name == "os.open":
                return "os.open()"
            return None

        nodes = _scoped(fn)
        for node in nodes:
            if isinstance(node, ast.Assign) and isinstance(node.value,
                                                           ast.Call):
                kind = acquire_kind(node.value)
                if kind and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    assigned[node.targets[0].id] = (node, kind)
        if not assigned:
            return
        closed_in_finally: set[str] = set()
        escapes: set[str] = set()
        for node in nodes:
            if isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) \
                        and f.attr in ("close", "shutdown") \
                        and isinstance(f.value, ast.Name) \
                        and f.value.id in assigned \
                        and _in_finally(spans, node.lineno):
                    closed_in_finally.add(f.value.id)
                else:
                    for arg in list(node.args) + [k.value
                                                  for k in node.keywords]:
                        if isinstance(arg, ast.Name) and arg.id in assigned:
                            escapes.add(arg.id)
            elif isinstance(node, ast.Return) and isinstance(node.value,
                                                             ast.Name):
                if node.value.id in assigned:
                    escapes.add(node.value.id)
            elif isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id in assigned:
                escapes.add(node.value.id)  # handed to another binding
            elif isinstance(node, ast.withitem):
                name = dotted_name(node.context_expr)
                if name in assigned:
                    escapes.add(name)  # managed by with
        for name, (stmt, kind) in assigned.items():
            if name in closed_in_finally or name in escapes:
                continue
            findings.append(ctx.finding(
                RULE, stmt,
                f"{kind} bound to local {name!r} is never closed under "
                "finally and never escapes this function: the error "
                "path leaks the handle; use `with` or try/finally"))

    for node in ast.walk(ctx.tree):
        if isinstance(node, _FUNCS):
            check_function(node)
    return findings
