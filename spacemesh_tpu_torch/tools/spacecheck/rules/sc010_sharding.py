"""SC010 sharding: no per-call device-mesh/sharding construction in hot paths.

Originating defect: the JAX package's data-plane audit — parallel/mesh.py
re-derived ``NamedSharding(mesh, P(...))`` on EVERY sharded dispatch
(and re-``device_put`` loop-invariant replicated carries per batch,
evicting donated buffers that were already resident).  Each sharding
object is cheap alone, but compiled-program caches key on them and
steady-state dispatch should allocate none; worse, a hand-built mesh
per call defeats reuse outright — two meshes over the same devices are
different cache keys, so every dispatch site that minted its own paid
its own compile.  parallel/topology.py owns the ONE process-wide mesh
and its persistent layout catalog; every entry point consumes it.

The port's ``parallel/`` is one process striping the lane axis over a
list of local devices, each stripe on a CUDA stream of its own; its
``topology.Mesh`` and the streams beside it are built once per device
list by ``parallel/topology.py``. A ``Mesh(...)`` built per dispatch would
mint new streams each call, and code keyed on the mesh object (the
layouts catalog) would never find its entry. The names
``DeviceMesh``/``init_device_mesh`` stay flagged as well: a
``torch.distributed`` mesh built per call sets up (and on first use
rendezvouses) a fresh set of process groups each time.

Flags, inside function bodies of the hot-path packages
(``spacemesh_tpu_torch/{ops,runtime,post,verify,parallel}/``): calls
whose callee's last dotted segment is ``DeviceMesh``,
``init_device_mesh``, ``Mesh`` or ``NamedSharding`` — the per-call
construction idiom this rule exists to keep deleted.  Module-level
constants are not flagged (construction at import time is
once-per-process by definition).  The topology module itself is the
exemption — its catalog constructors carry
``# spacecheck: ok=SC010 <why>`` pragmas, which keeps the exemption
visible at the construction site instead of buried in a config list.

Fix: take the mesh and its layouts from the process-wide topology
(``parallel/topology.py``) or go through the ``parallel/`` entry points,
which already do.
"""

from __future__ import annotations

import ast

from ..engine import FileContext, Finding, ProjectInfo, dotted_name

RULE = "SC010"

_HOT = tuple(f"spacemesh_tpu_torch/{p}/"
             for p in ("ops", "runtime", "post", "verify", "parallel"))
_CONSTRUCTORS = ("DeviceMesh", "init_device_mesh", "Mesh", "NamedSharding")


class _Visitor(ast.NodeVisitor):
    def __init__(self, ctx: FileContext) -> None:
        self.ctx = ctx
        self.findings: list[Finding] = []
        self._fn_depth = 0

    def _visit_fn(self, node) -> None:
        self._fn_depth += 1
        self.generic_visit(node)
        self._fn_depth -= 1

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn
    visit_Lambda = _visit_fn

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted_name(node.func)
        if (self._fn_depth > 0 and name is not None
                and name.rsplit(".", 1)[-1] in _CONSTRUCTORS):
            self.findings.append(self.ctx.finding(
                RULE, node,
                f"per-call {name.rsplit('.', 1)[-1]}(...) construction "
                "in a hot-path module: a mesh's streams (or a "
                "torch.distributed mesh's process groups) are made with "
                "it, and the layouts catalog keys on the mesh object, so "
                "a fresh one per dispatch defeats their reuse. Take the "
                "process-wide mesh from parallel/topology.py or go "
                "through the parallel/ entry points instead"))
        self.generic_visit(node)


def check(ctx: FileContext, project: ProjectInfo) -> list[Finding]:
    if not ctx.rel.startswith(_HOT):
        return []
    v = _Visitor(ctx)
    v.visit(ctx.tree)
    return v.findings
