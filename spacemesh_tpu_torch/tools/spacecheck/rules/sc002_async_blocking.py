"""SC002 async-blocking: no blocking calls lexically inside ``async def``.

Originating bug: the flight-dump fix — serializing a 64k-span trace
ring directly from a ``/readyz`` handler blocked the event loop at
exactly the moment the node was unhealthy; the fix moved it behind
``asyncio.to_thread``. The same class (a blocking disk/subprocess/
device call on the loop) stalls gossip delivery, farm dispatch, and
every timeout on the node at once, and reviews keep re-finding it.

Flags, in every scanned file: calls that block the calling thread when
they appear in the *direct* body of an ``async def`` (nested ``def``s
are excluded — they typically run via ``to_thread``/executors):

* ``time.sleep(...)`` (any import alias of ``time``)
* ``subprocess.run/call/check_call/check_output/Popen``
* builtin ``open(...)`` / ``os.open`` / ``os.replace`` / ``os.unlink``
  (sync file IO — unlinking a large file can take hundreds of ms in
  the kernel)
* ``torch.cuda.synchronize(...)``, and ``<s>.synchronize()`` on a name
  bound in the same file to ``torch.cuda.Stream(...)``,
  ``torch.cuda.Event(...)``, ``torch.cuda.current_stream(...)`` or
  ``torch.cuda.default_stream(...)`` (or called straight on one of
  those constructions) — device syncs that stall the loop for a whole
  dispatch. A ``.synchronize()`` on any other receiver is not a device
  sync (the Syncer's own ``await self.synchronize()`` coroutine stays
  clean). The JAX spellings ``jax.device_get(...)`` and
  ``<x>.block_until_ready()`` are kept too: they cost nothing.
* ``<x>.result()`` / ``<x>.future.result()`` — ``concurrent.futures``
  waits, including the runtime scheduler's thread-based ``JobHandle``
  (the runtime made blocking on a device job from a handler an easy
  new way to wedge the loop); ``asyncio``-side results arrive via ``await``,
  never ``.result()``, so any lexical ``.result()`` in an ``async
  def`` is a blocking wait
* ``<q>.get(...)`` / ``<q>.put(...)`` on a ``queue.Queue`` — the
  blocking thread-handoff primitive (names bound to a
  ``queue.Queue(...)``-family constructor in the same file);
  ``get_nowait``/``put_nowait`` stay legal

Allowlist a deliberate site (tiny reads at startup, etc.) with
``# spacecheck: ok=SC002 <why>``.
"""

from __future__ import annotations

import ast

from ..engine import FileContext, Finding, ProjectInfo, dotted_name, \
    time_module_aliases

RULE = "SC002"

_SUBPROCESS = {"run", "call", "check_call", "check_output", "Popen"}
_OS_SYNC_IO = {"open", "replace", "rename", "fsync", "unlink", "remove"}
_QUEUE_FACTORIES = {"Queue", "SimpleQueue", "LifoQueue", "PriorityQueue"}
# torch.cuda constructors whose object's .synchronize() blocks the host
_CUDA_SYNC_FACTORIES = {"Stream", "Event", "current_stream",
                        "default_stream"}


def _factory_call(node: ast.AST, factories: set[str], module: str) -> bool:
    """``<...>.<module>.<factory>(...)``: a call of one of ``factories``
    on a receiver whose last component is ``module``."""
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func)
    if not name:
        return False
    head, _, last = name.rpartition(".")
    return last in factories and head.rsplit(".", 1)[-1] == module


def _is_queue_factory_call(node: ast.AST) -> bool:
    """A stdlib ``queue.Queue(...)``-family construction."""
    return _factory_call(node, _QUEUE_FACTORIES, "queue")


def _is_cuda_factory_call(node: ast.AST) -> bool:
    """``torch.cuda.Stream(...)``-family construction (any receiver
    ending in ``cuda``: ``torch.cuda``, an imported ``cuda``)."""
    return _factory_call(node, _CUDA_SYNC_FACTORIES, "cuda")


def _bound_names(tree: ast.Module, is_factory) -> set[str]:
    """Last-component names bound in THIS file to a call that
    ``is_factory`` accepts (``self._q = queue.Queue(...)``). Per-file on
    purpose: a project-wide name set would let one module's queue
    attribute flag a same-named dict in another (``storage/db.py``
    ``_readers`` vs ``p2p/fetch.py`` ``_readers``)."""
    out: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            value, targets = node.value, node.targets
        elif isinstance(node, ast.AnnAssign):
            # the codebase's own idiom: `self._q: queue.Queue = ...`
            value, targets = node.value, [node.target]
        else:
            continue
        if not is_factory(value):
            continue
        for tgt in targets:
            tname = dotted_name(tgt)
            if tname:
                out.add(tname.rsplit(".", 1)[-1])
    return out


def check(ctx: FileContext, project: ProjectInfo) -> list[Finding]:
    time_aliases = time_module_aliases(ctx.tree)
    queue_vars = _bound_names(ctx.tree, _is_queue_factory_call)
    sync_vars = _bound_names(ctx.tree, _is_cuda_factory_call)
    findings: list[Finding] = []

    def blocking(node: ast.Call) -> str | None:
        func = node.func
        if isinstance(func, ast.Name):
            if func.id == "open":
                return "sync file IO (open) on the event loop"
            return None
        if not isinstance(func, ast.Attribute):
            return None
        recv = dotted_name(func.value)
        attr = func.attr
        if attr == "sleep" and recv in time_aliases:
            return f"{recv}.sleep() blocks the event loop"
        if recv == "subprocess" and attr in _SUBPROCESS:
            return (f"subprocess.{attr}() blocks the event loop; use "
                    "asyncio.create_subprocess_* or to_thread")
        if recv == "os" and attr in _OS_SYNC_IO:
            return f"os.{attr}() is sync file IO on the event loop"
        if recv == "jax" and attr == "device_get":
            return ("jax.device_get() synchronously waits for the "
                    "device; fetch via to_thread or async dispatch")
        if attr == "block_until_ready":
            return (".block_until_ready() stalls the loop for a whole "
                    "device dispatch; wrap in to_thread")
        if attr == "synchronize" and recv is not None \
                and recv.rsplit(".", 1)[-1] == "cuda":
            return (f"{recv}.synchronize() waits for every kernel queued "
                    "on the device; wrap in to_thread")
        if attr == "synchronize" and (
                _is_cuda_factory_call(func.value)
                or (recv and recv.rsplit(".", 1)[-1] in sync_vars)):
            return (f"{recv or 'stream/event'}.synchronize() blocks until "
                    "the device drains that stream/event; wrap in "
                    "to_thread")
        if attr == "result" and not node.args:
            # zero positional args: the Future/JobHandle shape (an
            # argful .result(state, id) is a plain module function)
            return (f"{recv}.result() is a blocking concurrent-futures "
                    "wait (JobHandle/Future); await "
                    "asyncio.wrap_future(...) or move it to to_thread")
        if attr in ("get", "put") and recv \
                and recv.rsplit(".", 1)[-1] in queue_vars:
            return (f"{recv}.{attr}() blocks on a queue.Queue; use "
                    f"{attr}_nowait with loop-side signalling, or "
                    "to_thread")
        return None

    def scan_async_body(fn: ast.AsyncFunctionDef) -> None:
        def visit(node: ast.AST) -> None:
            if isinstance(node, (ast.FunctionDef, ast.Lambda)):
                return  # nested sync defs run elsewhere (to_thread etc.)
            if isinstance(node, ast.AsyncFunctionDef):
                scan_async_body(node)
                return
            if isinstance(node, ast.Call):
                why = blocking(node)
                if why is not None:
                    findings.append(ctx.finding(
                        RULE, node,
                        f"blocking call inside async def "
                        f"{fn.name}(): {why}"))
            for child in ast.iter_child_nodes(node):
                visit(child)

        for stmt in fn.body:
            visit(stmt)

    def walk(node: ast.AST) -> None:
        if isinstance(node, ast.AsyncFunctionDef):
            scan_async_body(node)
            return
        for child in ast.iter_child_nodes(node):
            walk(child)

    walk(ctx.tree)
    return findings
