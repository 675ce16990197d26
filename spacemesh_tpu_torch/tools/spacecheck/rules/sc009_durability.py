"""SC009 durability: rename-based persistence must be fsync-bracketed.

Originating bug: the power-cut audit — ``PostMetadata.save``
renamed a tmp file over the resume metadata without fsyncing the file
or its directory, so a power cut could publish a correctly-named file
full of zeros; every winners/rates/findings cache in the tree had the
same ``tmp + os.replace`` idiom, and every one of them treats an
unparseable file as "empty, silently re-derive" — corruption absorbed,
days of measurements gone, no log line.  utils/fsio.py owns the full
durable sequence (write tmp, fsync tmp, rename, fsync parent dir);
this rule keeps new persistence sites from re-growing the naked form.

Flags, in ``spacemesh_tpu_torch/`` (minus utils/fsio.py and post/faultfs.py,
which implement the discipline):

* ``os.replace(...)`` / ``os.rename(...)`` calls — the naked
  publish-by-rename idiom;
* single-argument ``.replace(x)`` / ``.rename(x)`` attribute calls —
  the ``pathlib.Path`` spelling of the same thing (``str.replace``
  takes two+ arguments, so string munging never matches).

Route the write through ``fsio.atomic_write_text``/``atomic_write_bytes``
(payloads built in memory) or ``fsio.persist`` (tmp produced by an
external writer: a compiler, a spooled directory).  A rename that is
genuinely not a persistence point (an archival move of an already-
durable file) suppresses with ``# spacecheck: ok=SC009 <why>``.
"""

from __future__ import annotations

import ast

from ..engine import FileContext, Finding, ProjectInfo, dotted_name

RULE = "SC009"

_EXEMPT = ("spacemesh_tpu_torch/utils/fsio.py", "spacemesh_tpu_torch/post/faultfs.py")
_RENAMERS = ("replace", "rename")


def check(ctx: FileContext, project: ProjectInfo) -> list[Finding]:
    if not ctx.rel.startswith("spacemesh_tpu_torch/") or ctx.rel in _EXEMPT:
        return []
    findings: list[Finding] = []

    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if not isinstance(func, ast.Attribute) \
                or func.attr not in _RENAMERS:
            continue
        recv = dotted_name(func.value)
        if recv is not None and recv.rsplit(".", 1)[-1] == "os":
            findings.append(ctx.finding(
                RULE, node,
                f"os.{func.attr}(...) publishes by rename without an "
                "fsync bracket: a power cut can land the name swap "
                "before the payload bytes. Route through utils/fsio "
                "(atomic_write_text/atomic_write_bytes, or persist() "
                "for externally-written tmps)"))
            continue
        # pathlib spelling: Path.rename/Path.replace take exactly one
        # positional argument; str.replace takes two or more, so plain
        # string munging never matches this shape (a string-constant
        # target is still a rename — `tmp.replace("cache.json")` is
        # exactly the naked publish the rule exists for)
        if len(node.args) == 1 and not node.keywords:
            findings.append(ctx.finding(
                RULE, node,
                f".{func.attr}(target) on a path publishes by rename "
                "without an fsync bracket; route the write through "
                "utils/fsio, or justify the move with a pragma if the "
                "payload is already durable"))
    return findings
