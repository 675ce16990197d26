"""spacecheck engine: file walking, pragmas, fingerprints, rule driving.

The engine parses every target file once, runs a project-wide pre-pass
(cross-file facts some rules need, e.g. which module-level names are
metrics instruments), then hands each file to every selected rule.
Findings carry a **fingerprint** that is stable across unrelated edits —
hash of (rule, path, normalized offending line, occurrence index), not
the line number — so the checked-in baseline survives code motion above
a grandfathered finding.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import io
import json
import os
import re
import tokenize

RULE_IDS = ("SC001", "SC002", "SC003", "SC004", "SC005", "SC006",
            "SC007", "SC008", "SC009", "SC010")

# paths (relative, forward-slash) matched against these prefixes are
# skipped entirely
_SKIP_PARTS = {"__pycache__", ".git"}

_PRAGMA_RE = re.compile(r"#\s*spacecheck:\s*(?P<body>.+)")
_OK_RE = re.compile(r"ok\s*=\s*(?P<rules>SC\d{3}(?:\s*,\s*SC\d{3})*)"
                    r"(?P<why>.*)", re.IGNORECASE)
_NOQA_RE = re.compile(r"#\s*noqa[:\s]", re.IGNORECASE)


@dataclasses.dataclass
class Finding:
    rule: str
    path: str          # repo-relative, forward slashes
    line: int          # 1-based
    col: int
    message: str
    snippet: str       # stripped source line
    fingerprint: str = ""

    def key(self) -> tuple:
        return (self.path, self.line, self.rule, self.col)


class FileContext:
    """One parsed file plus its pragma map, shared by every rule."""

    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        # lineno -> set of rule ids suppressed on that line
        self.line_pragmas: dict[int, set[str]] = {}
        # comment text per line (SC006 accepts justified noqa comments)
        self.comments: dict[int, str] = {}
        # module-wide suppressions (e.g. "# spacecheck: wall-clock-ok"
        # in the file header)
        self.module_pragmas: set[str] = set()
        self._scan_comments()

    # --- pragmas --------------------------------------------------------

    def _scan_comments(self) -> None:
        try:
            tokens = tokenize.generate_tokens(io.StringIO(self.source).readline)
            comments = [(t.start[0], t.start[1], t.string)
                        for t in tokens if t.type == tokenize.COMMENT]
        except (tokenize.TokenError, SyntaxError,
                ValueError):  # the ast parse succeeded; keep going
            comments = []
        for lineno, col, text in comments:
            self.comments[lineno] = text
            m = _PRAGMA_RE.search(text)
            if not m:
                continue
            body = m.group("body").strip()
            rules: set[str] = set()
            low = body.lower()
            if low.startswith("wall-clock-ok"):
                rules = {"SC001"}
                why = body[len("wall-clock-ok"):]
            else:
                ok = _OK_RE.match(body)
                if ok:
                    rules = {r.strip().upper()
                             for r in ok.group("rules").split(",")}
                    why = ok.group("why")
            if not rules:
                continue
            # a pragma without a reason is no pragma: suppression must
            # be justified (same contract the baseline enforces) — the
            # finding stays visible until the why is written
            if len(why.strip(" -—:\t")) < 8:
                continue
            own_line = self.lines[lineno - 1] if lineno <= len(self.lines) else ""
            standalone = own_line.lstrip().startswith("#")
            if standalone and col == 0 and lineno <= 25 \
                    and low.startswith("wall-clock-ok"):
                # header pragma: the whole module declares its time source
                self.module_pragmas |= rules
                continue
            self.line_pragmas.setdefault(lineno, set()).update(rules)
            if standalone:
                # a pragma on its own line covers the next line too
                self.line_pragmas.setdefault(lineno + 1, set()).update(rules)

    def suppressed(self, rule: str, lineno: int) -> bool:
        if rule in self.module_pragmas:
            return True
        return rule in self.line_pragmas.get(lineno, set())

    def noqa_comment(self, lineno: int) -> str | None:
        """The line's comment when it is a justified noqa suppression
        (``# noqa: XXX — why``): flake8-style suppressions that already
        carry a human reason double as SC006 pragmas, so the sweep does
        not demand a second comment saying the same thing."""
        text = self.comments.get(lineno)
        if not text or not _NOQA_RE.search(text):
            return None
        # justified = prose beyond the code list ("# noqa: BLE001" alone
        # is not a justification)
        tail = re.sub(r"#\s*noqa[:\s]*[A-Z0-9, ]*", "", text).strip(" -—:\t")
        return text if len(tail) >= 8 else None

    # --- findings -------------------------------------------------------

    def finding(self, rule: str, node, message: str) -> Finding:
        lineno = getattr(node, "lineno", 0) or 0
        col = getattr(node, "col_offset", 0) or 0
        snippet = (self.lines[lineno - 1].strip()
                   if 0 < lineno <= len(self.lines) else "")
        return Finding(rule=rule, path=self.rel, line=lineno, col=col,
                       message=message, snippet=snippet)


# --- shared AST helpers (imported by the rules) -------------------------


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def time_module_aliases(tree: ast.Module) -> set[str]:
    """Local names the stdlib ``time`` module is importable under
    (``import time``, ``import time as _time``)."""
    out: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "time":
                    out.add(alias.asname or "time")
    return out


class ProjectInfo:
    """Cross-file facts collected in one pre-pass over every context."""

    def __init__(self, contexts: list[FileContext]):
        self.contexts = contexts
        # rule-private cross-file caches hang off this dict (SC003's
        # donated-callable map, built lazily on first use)
        self.cache: dict[str, object] = {}
        # names (last dotted component) bound to a registry-created
        # instrument anywhere in the tree: `x = REGISTRY.counter(...)`,
        # `self._latency = _metrics.REGISTRY.histogram(...)`
        self.instrument_vars: set[str] = set()
        # metric name literal -> [(rel, lineno, module_scope)]
        self.metric_creations: dict[str, list[tuple[str, int, bool]]] = {}
        for ctx in contexts:
            self._collect(ctx)

    @staticmethod
    def _is_registry_create(call: ast.Call) -> bool:
        if not isinstance(call.func, ast.Attribute):
            return False
        if call.func.attr not in ("counter", "gauge", "histogram"):
            return False
        recv = dotted_name(call.func.value) or ""
        last = recv.rsplit(".", 1)[-1].lower()
        return last in ("registry", "_registry") or last.endswith("registry")

    def _collect(self, ctx: FileContext) -> None:
        func_depth = 0

        def visit(node: ast.AST) -> None:
            nonlocal func_depth
            is_func = isinstance(node, (ast.FunctionDef,
                                        ast.AsyncFunctionDef, ast.Lambda))
            if is_func:
                func_depth += 1
            if isinstance(node, ast.Call) and self._is_registry_create(node):
                if node.args and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    name = node.args[0].value
                    self.metric_creations.setdefault(name, []).append(
                        (ctx.rel, node.lineno, func_depth == 0))
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                    and self._is_registry_create(node.value):
                for tgt in node.targets:
                    name = dotted_name(tgt)
                    if name:
                        self.instrument_vars.add(name.rsplit(".", 1)[-1])
            for child in ast.iter_child_nodes(node):
                visit(child)
            if is_func:
                func_depth -= 1

        visit(ctx.tree)


# --- incremental findings cache -----------------------------------------
#
# A full run is (parse + pre-pass + N rules) x every file; rules keep
# multiplying, and a checker run should cost nothing on an unchanged
# tree.  The cache persists per-file findings keyed by ``(mtime,
# sha256)`` under ``~/.cache/spacemesh_tpu_torch/``, guarded by two
# whole-run digests that keep it SOUND for cross-file rules:
#
# * ``rules_digest`` — hash of engine.py + every rules/*.py source: any
#   analyzer change invalidates everything.  It is also what keeps this
#   checker and the JAX package's apart when both write one file (the
#   ``SPACEMESH_SPACECHECK_CACHE`` override): their sources differ, so a
#   doc the other checker wrote is always a miss, never a hit;
# * ``tree_digest`` — hash of every analyzed file's content hash: rules
#   consume project-wide facts (SC003's donation map, SC005's duplicate
#   names, SC007/SC008's thread/lock graphs), so one changed file can
#   change another file's findings.  A warm run over an identical tree
#   is therefore a pure cache hit (no parse, no rules); any change at
#   all recomputes the whole tree and refreshes the cache.
#
# ``--select`` runs bypass the cache (partial findings must never
# poison a full run's entries).

CACHE_ENV = "SPACEMESH_SPACECHECK_CACHE"
CACHE_VERSION = 1
DEFAULT_CACHE = "~/.cache/spacemesh_tpu_torch/spacecheck_cache.json"


def default_cache_path() -> str:
    """``$SPACEMESH_SPACECHECK_CACHE`` when set, else the port's own
    file under ``~/.cache/spacemesh_tpu_torch/`` (the port has no XLA
    compile cache to sit beside)."""
    explicit = os.environ.get(CACHE_ENV)
    return os.path.expanduser(explicit or DEFAULT_CACHE)


def _rules_digest() -> str:
    from . import rules as rules_pkg

    h = hashlib.sha256()
    rules_dir = os.path.dirname(rules_pkg.__file__)
    files = [__file__] + [os.path.join(rules_dir, f)
                          for f in sorted(os.listdir(rules_dir))
                          if f.endswith(".py")]
    for path in files:
        try:
            with open(path, "rb") as fh:
                h.update(fh.read())
        except OSError:
            h.update(path.encode())
    return h.hexdigest()


def _load_cache_doc(path: str) -> dict | None:
    try:
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("version") != CACHE_VERSION \
            or not isinstance(doc.get("files"), dict):
        return None
    return doc


def _file_sha(path: str, cached_entry: dict | None) -> tuple[str, dict]:
    """(sha256 hex, stat info) — reuses the cached hash when the file's
    (mtime, size) are unchanged, so a warm run hashes nothing."""
    st = os.stat(path)
    info = {"mtime": st.st_mtime, "size": st.st_size}
    if cached_entry is not None \
            and cached_entry.get("mtime") == info["mtime"] \
            and cached_entry.get("size") == info["size"] \
            and isinstance(cached_entry.get("sha"), str):
        return cached_entry["sha"], info
    with open(path, "rb") as fh:
        sha = hashlib.sha256(fh.read()).hexdigest()
    return sha, info


def _write_cache(path: str, rules_digest: str, tree_digest: str,
                 per_file: dict[str, dict]) -> None:
    doc = {"version": CACHE_VERSION, "rules_digest": rules_digest,
           "tree_digest": tree_digest, "files": per_file}
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # durable write (utils/fsio is stdlib-only, so the checker
        # still runs before torch is installed): a crash mid-save must
        # not leave a half-written cache the loader silently discards
        from ...utils import fsio

        fsio.atomic_write_text(path, json.dumps(doc))
    except OSError:
        pass  # persistence is an optimization (read-only HOME, CI)


# --- walking + running --------------------------------------------------


def iter_py_files(paths: list[str]) -> list[str]:
    out: list[str] = []
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                out.append(p)
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs if d not in _SKIP_PARTS)
            for f in sorted(files):
                if f.endswith(".py"):
                    out.append(os.path.join(root, f))
    return out


def _relpath(path: str, root: str) -> str:
    rel = os.path.relpath(os.path.abspath(path), root)
    return rel.replace(os.sep, "/")


def fingerprint(rule: str, rel: str, snippet: str) -> str:
    norm = " ".join(snippet.split())
    h = hashlib.sha1(f"{rule}|{rel}|{norm}".encode()).hexdigest()
    return h[:16]


def assign_fingerprints(findings: list[Finding]) -> None:
    """Stable ids: hash of (rule, path, normalized offending line) —
    deliberately NOT line numbers and NOT an occurrence index. Two
    textually identical offenses in one file share a fingerprint and
    the baseline matches them as a MULTISET (baseline.split): adding a
    second identical violation above a grandfathered one therefore
    surfaces one new finding, instead of an index shift silently
    suppressing the new line and re-flagging the old one."""
    for f in findings:
        f.fingerprint = fingerprint(f.rule, f.path, f.snippet)


def _check_context(ctx: FileContext, project: ProjectInfo,
                   active: list) -> tuple[list[Finding], list[str]]:
    findings: list[Finding] = []
    errors: list[str] = []
    for rule in active:
        try:
            raw = rule.check(ctx, project)
        except Exception as e:  # noqa: BLE001 — one rule crashing on
            # one file must surface as an analyzer error, not take
            # down the whole run silently
            errors.append(f"{ctx.rel}: rule {rule.RULE} crashed: "
                          f"{type(e).__name__}: {e}")
            continue
        findings.extend(f for f in raw
                        if not ctx.suppressed(f.rule, f.line))
    return findings, errors


# fork-inherited handoff for --jobs workers (contexts and the project
# pre-pass are built once in the parent; AST trees cross into children
# for free via fork, only the per-file findings lists come back pickled)
_FORK_STATE: tuple | None = None


def _fork_shard(indices: list[int]) -> list[tuple[list[Finding],
                                                  list[str]]]:
    contexts, project, active = _FORK_STATE
    return [_check_context(contexts[i], project, active)
            for i in indices]


def _run_rules(contexts: list[FileContext], project: ProjectInfo,
               active: list, jobs: int
               ) -> list[tuple[FileContext, list[Finding], list[str]]]:
    jobs = max(int(jobs), 1)
    if jobs > 1 and len(contexts) > 1:
        import multiprocessing

        try:
            mp = multiprocessing.get_context("fork")
        except ValueError:
            mp = None
        if mp is not None:
            import concurrent.futures

            # prime the rules' lazy cross-file caches (SC003's donation
            # map, SC007/SC008's thread/lock facts) in the PARENT by
            # checking one file first — forked children then inherit
            # the populated project.cache instead of each rebuilding it
            out: list = [None] * len(contexts)
            out[0] = (contexts[0],
                      *_check_context(contexts[0], project, active))
            global _FORK_STATE
            _FORK_STATE = (contexts, project, active)
            try:
                shards = [list(range(1 + k, len(contexts), jobs))
                          for k in range(jobs)]
                shards = [s for s in shards if s]
                with concurrent.futures.ProcessPoolExecutor(
                        max_workers=max(len(shards), 1),
                        mp_context=mp) as ex:
                    results = list(ex.map(_fork_shard, shards))
            finally:
                _FORK_STATE = None
            for shard, res in zip(shards, results):
                for i, (fs, errs) in zip(shard, res):
                    out[i] = (contexts[i], fs, errs)
            return out
    return [(ctx, *_check_context(ctx, project, active))
            for ctx in contexts]


def run_paths(paths: list[str], *, project_root: str | None = None,
              select: set[str] | None = None,
              cache: str | bool | None = None,
              jobs: int = 1) -> tuple[list[Finding], list[str]]:
    """Analyze ``paths`` (files or directories). Returns (findings,
    errors); errors are unparseable files — CI treats them as failures
    too (an unparseable file is unanalyzed, not clean).

    ``cache`` — True (default path) or a path: consult/refresh the
    incremental findings cache (full-rule runs only; ``--select`` runs
    always compute).  ``jobs`` — fork-parallel rule execution.
    """
    from . import rules as rules_pkg

    root = os.path.abspath(project_root or os.getcwd())
    files = [(path, _relpath(path, root)) for path in iter_py_files(paths)]

    cache_file = None
    if cache and select is None:
        cache_file = default_cache_path() if cache is True else str(cache)
    cached_doc = _load_cache_doc(cache_file) if cache_file else None
    rules_digest = _rules_digest() if cache_file else ""
    shas: dict[str, tuple[str, dict]] = {}
    tree_digest = ""
    if cache_file:
        cached_files = (cached_doc or {}).get("files", {})
        th = hashlib.sha256()
        try:
            for path, rel in files:
                shas[rel] = _file_sha(path, cached_files.get(rel))
                th.update(f"{rel}:{shas[rel][0]}\n".encode())
            tree_digest = th.hexdigest()
        except OSError:
            cache_file = None  # unreadable file: fall through, the
            # full run reports it as an analyzer error
    if cached_doc is not None and cache_file \
            and cached_doc.get("rules_digest") == rules_digest \
            and cached_doc.get("tree_digest") == tree_digest \
            and all(rel in cached_doc["files"] for _, rel in files):
        findings: list[Finding] = []
        errors: list[str] = []
        for _, rel in files:
            ent = cached_doc["files"][rel]
            findings.extend(Finding(**f) for f in ent.get("findings", []))
            errors.extend(ent.get("errors", []))
        findings.sort(key=Finding.key)
        return findings, errors

    contexts: list[FileContext] = []
    errors = []
    per_file: dict[str, dict] = {}
    for path, rel in files:
        ent: dict = {"findings": [], "errors": []}
        if rel in shas:
            ent.update(sha=shas[rel][0], **shas[rel][1])
        per_file[rel] = ent
        try:
            with open(path, encoding="utf-8") as fh:
                source = fh.read()
            contexts.append(FileContext(path, rel, source))
        except (OSError, SyntaxError, ValueError) as e:
            msg = f"{rel}: {type(e).__name__}: {e}"
            errors.append(msg)
            ent["errors"].append(msg)
    project = ProjectInfo(contexts)
    active = [r for r in rules_pkg.ALL_RULES
              if select is None or r.RULE in select]
    findings = []
    for ctx, ctx_findings, ctx_errors in _run_rules(contexts, project,
                                                    active, jobs):
        findings.extend(ctx_findings)
        errors.extend(ctx_errors)
        per_file[ctx.rel]["errors"].extend(ctx_errors)
    findings.sort(key=Finding.key)
    assign_fingerprints(findings)
    if cache_file:
        for f in findings:
            if f.path in per_file:
                per_file[f.path]["findings"].append(dataclasses.asdict(f))
        _write_cache(cache_file, rules_digest, tree_digest, per_file)
    return findings, errors
