"""The port's static checker, ``spacemesh_tpu_torch/tools/spacecheck``.

``tests/test_spacecheck.py``'s checker tests (all of it before its runtime
sanitizers, whose twins live in ``tests/test_torch_sanitize.py``) run on the
port through ``torch_twin``: the engine, rules, baseline and CLI are the
port's, every fixture lands under a ``spacemesh_tpu_torch/`` prefix, and
``test_real_tree_is_clean`` runs ``python -m spacemesh_tpu_torch.tools.spacecheck``
over this repository with the port's baseline. Then what the port adds:
SC002's torch device syncs, SC010's torch device meshes, the cache kept
apart from the JAX checker's, the default paths and baseline, and the two
checkers held to the same findings on the port's own code with its pragmas
and annotations stripped. Last, the fixes that cleared the port's findings
(the kernel build's durable publish, the probe's tenant pairing).
"""

from __future__ import annotations

import io
import json
import os
import tokenize
import types
from pathlib import Path

import pytest

import torch_twin
from spacemesh_tpu_torch.tools.spacecheck import baseline as baseline_mod
from spacemesh_tpu_torch.tools.spacecheck import engine
from spacemesh_tpu_torch.tools.spacecheck.__main__ import \
    _default_paths, main as cli_main

REPO = Path(__file__).resolve().parent.parent
_SANITIZERS = "# --- runtime sanitizers"


def _checker_tests() -> set[str]:
    """The JAX file's tests that come before its runtime sanitizers."""
    src = (REPO / "tests" / "test_spacecheck.py").read_text().splitlines()
    end = next(i for i, line in enumerate(src, 1)
               if line.startswith(_SANITIZERS))
    mod = torch_twin._twin("test_spacecheck")
    return {k for k, v in vars(mod).items()
            if k.startswith("test_") and callable(v)
            and v.__code__.co_firstlineno < end}


CHECKER_TESTS = _checker_tests()
_twin = torch_twin.export("test_spacecheck", globals(), only=CHECKER_TESTS)
run_fixture = _twin.run_fixture


def test_the_twin_is_the_port_checker():
    assert len(CHECKER_TESTS) >= 45
    assert "test_real_tree_is_clean" in CHECKER_TESTS
    assert not any("sanitizer" in name for name in CHECKER_TESTS)
    assert _twin.engine is engine
    assert _twin.cli_main is cli_main


# --- SC002: torch's device syncs ---------------------------------------


def test_sc002_flags_torch_device_syncs(tmp_path):
    fs = run_fixture(tmp_path, "spacemesh_tpu_torch/verifyd/busy.py", """
        import torch

        class Farm:
            def __init__(self, dev):
                self._stream = torch.cuda.Stream(dev)
                self._done: torch.cuda.Event = torch.cuda.Event()

            async def serve(self, x):
                torch.cuda.synchronize()
                torch.cuda.synchronize(x.device)
                self._stream.synchronize()
                self._done.synchronize()
                cur = torch.cuda.current_stream(x.device)
                cur.synchronize()
                torch.cuda.default_stream().synchronize()
    """, select="SC002")
    assert len(fs) == 6, [f.message for f in fs]
    assert all(f.rule == "SC002" and "serve()" in f.message for f in fs)
    assert "torch.cuda.synchronize()" in fs[0].message


def test_sc002_clean_on_own_synchronize_and_nested_sync_def(tmp_path):
    fs = run_fixture(tmp_path, "spacemesh_tpu_torch/p2p/syncer.py", """
        import asyncio

        import torch

        class Syncer:
            async def synchronize(self):
                return True

            async def run(self, peer):
                await self.synchronize()      # the Syncer's own coroutine
                peer.synchronize()            # not a stream or an event

        async def finish(stream):
            def wait():
                torch.cuda.synchronize()      # runs on a worker thread
                stream.synchronize()
            await asyncio.to_thread(wait)
            await asyncio.to_thread(torch.cuda.synchronize)

        def sync_side():
            torch.cuda.synchronize()          # not in an async def
    """, select="SC002")
    assert not fs, [f.message for f in fs]


def test_sc002_port_syncer_stays_clean():
    path = REPO / "spacemesh_tpu_torch" / "p2p" / "sync.py"
    assert "await self.synchronize()" in path.read_text()
    findings, errors = engine.run_paths([str(path)], project_root=str(REPO),
                                        select={"SC002"})
    assert not errors and not findings


def test_sc002_jax_syncs_still_flag(tmp_path):
    fs = run_fixture(tmp_path, "spacemesh_tpu_torch/api/old.py", """
        import jax

        async def handler(out):
            jax.device_get(out)
            out.block_until_ready()
    """, select="SC002")
    assert len(fs) == 2


# --- SC010: torch's device meshes -------------------------------------


def test_sc010_flags_per_call_mesh_in_hot_paths(tmp_path):
    fs = run_fixture(tmp_path, "spacemesh_tpu_torch/parallel/shard.py", """
        from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

        def dispatch(x, NamedSharding, P):
            mesh = init_device_mesh("cuda", (4,))
            again = DeviceMesh("cuda", [0, 1, 2, 3])
            layout = NamedSharding(again, P("lanes"))
            return mesh, layout
    """, select="SC010")
    assert len(fs) == 3
    assert {f.message.split("(")[0] for f in fs} == {
        "per-call init_device_mesh", "per-call DeviceMesh",
        "per-call NamedSharding"}
    for pkg in ("ops", "runtime", "post", "verify"):
        fs = run_fixture(tmp_path, f"spacemesh_tpu_torch/{pkg}/m.py", """
            import torch.distributed.device_mesh as dm

            def f():
                return dm.init_device_mesh("cuda", (2,))
        """, select="SC010")
        assert len(fs) == 1, pkg


def test_sc010_clean_at_module_scope_outside_hot_paths_and_pragma(tmp_path):
    src = """
        from torch.distributed.device_mesh import init_device_mesh

        MESH = init_device_mesh("cuda", (4,))   # once per process

        def dispatch(x):
            return init_device_mesh("cuda", (4,))
    """
    fs = run_fixture(tmp_path, "spacemesh_tpu_torch/sim/fabric.py", src,
                     select="SC010")
    assert not fs
    fs = run_fixture(tmp_path, "spacemesh_tpu_torch/parallel/topo.py", src,
                     select="SC010")
    assert len(fs) == 1 and fs[0].line == 7
    fs = run_fixture(tmp_path, "spacemesh_tpu_torch/parallel/topology.py", """
        from torch.distributed.device_mesh import init_device_mesh

        def build(shape):
            return init_device_mesh("cuda", shape)  # spacecheck: ok=SC010 the one process-wide catalog constructor
    """, select="SC010")
    assert not fs


def test_sc010_seeded_violation_fails_cli(tmp_path, capsys):
    p = tmp_path / "spacemesh_tpu_torch" / "parallel"
    p.mkdir(parents=True)
    (p / "seeded.py").write_text(
        "def f(DeviceMesh):\n    return DeviceMesh('cuda', [0])\n")
    rc = cli_main([str(p / "seeded.py"), "--root", str(tmp_path),
                   "--no-baseline", "--select", "SC010"])
    assert rc == 1
    assert "SC010" in capsys.readouterr().out


# --- cache, default paths, baseline ------------------------------------


def test_default_cache_path(monkeypatch, tmp_path):
    monkeypatch.delenv(engine.CACHE_ENV, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("SPACEMESH_JAX_CACHE", str(tmp_path / "jx" / "c"))
    assert engine.default_cache_path() == str(
        tmp_path / ".cache" / "spacemesh_tpu_torch" / "spacecheck_cache.json")
    monkeypatch.setenv(engine.CACHE_ENV, str(tmp_path / "mine.json"))
    assert engine.default_cache_path() == str(tmp_path / "mine.json")


def test_cache_written_by_the_jax_checker_is_a_miss(tmp_path, monkeypatch):
    """One cache file (the per-process override both checkers read), one
    tree whose findings differ between them: each checker must recompute
    over the other's doc, never return its findings."""
    from spacemesh_tpu.tools.spacecheck import engine as jengine

    for pkg in ("spacemesh_tpu", "spacemesh_tpu_torch"):
        d = tmp_path / pkg / "sim"
        d.mkdir(parents=True)
        (d / "a.py").write_text(
            "import time\n\ndef bad():\n    return time.time()\n")
    cache = tmp_path / "shared.json"
    monkeypatch.setenv(engine.CACHE_ENV, str(cache))
    paths = [str(tmp_path / "spacemesh_tpu"),
             str(tmp_path / "spacemesh_tpu_torch")]
    assert jengine.default_cache_path() == engine.default_cache_path()
    assert jengine._rules_digest() != engine._rules_digest()

    def run(eng):
        fs, errs = eng.run_paths(paths, project_root=str(tmp_path),
                                 cache=True)
        assert not errs
        return [f.path for f in fs]

    jax_paths = ["spacemesh_tpu/sim/a.py"]
    port_paths = ["spacemesh_tpu_torch/sim/a.py"]
    assert run(jengine) == jax_paths
    assert json.loads(cache.read_text())["rules_digest"] == \
        jengine._rules_digest()
    assert run(engine) == port_paths      # a hit would give jax_paths
    assert json.loads(cache.read_text())["rules_digest"] == \
        engine._rules_digest()
    assert run(jengine) == jax_paths      # and the other way round
    # a warm run of one checker over its own doc is still a pure hit
    assert run(jengine) == jax_paths
    monkeypatch.setattr(jengine, "_check_context",
                        lambda *a: (_ for _ in ()).throw(
                            AssertionError("rules ran on a warm tree")))
    assert run(jengine) == jax_paths


def test_default_paths_are_the_port_alone(tmp_path):
    paths = [os.path.relpath(p, REPO) for p in _default_paths(str(REPO))]
    assert paths[0] == "spacemesh_tpu_torch"
    assert "tests/torch_twin.py" in paths
    assert "tests/test_torch_spacecheck.py" in paths
    assert all(p == "spacemesh_tpu_torch" or p == "tests/torch_twin.py"
               or p.startswith("tests/test_torch_") for p in paths)
    assert not any(p.startswith(("spacemesh_tpu/", "tests/test_spacecheck"))
                   for p in paths)
    assert _default_paths(str(tmp_path)) == []


def test_shipped_baseline_loads_and_is_justified():
    path = REPO / "spacemesh_tpu_torch" / "tools" / "spacecheck" / \
        "baseline.json"
    # load() raises on an entry without a justification
    entries = baseline_mod.load(str(path))
    doc = json.loads(path.read_text())
    assert doc["version"] == baseline_mod.VERSION
    assert sum(len(v) for v in entries.values()) == len(doc["findings"])


# --- parity with the JAX checker on the port's own code ----------------

_MARKS = ("spacecheck:", "guarded by:")


def _strip_marks(source: str) -> str:
    """``source`` with every comment that carries a pragma or a lock
    annotation removed; line numbers stay."""
    lines = source.splitlines(keepends=True)
    for tok in tokenize.generate_tokens(io.StringIO(source).readline):
        if tok.type == tokenize.COMMENT \
                and any(m in tok.string.lower() for m in _MARKS):
            row, col = tok.start
            line = lines[row - 1]
            tail = "\n" if line.endswith("\n") else ""
            lines[row - 1] = line[:col].rstrip() + tail
    return "".join(lines)


def _findings(main, root: Path, pkg: str, capsys) -> list[tuple]:
    capsys.readouterr()
    rc = main([str(root / pkg), "--root", str(root), "--no-baseline",
               "--no-cache", "--format", "json", "--jobs", "2"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1 and not doc["errors"]
    out = []
    for f in doc["new"]:
        assert f["path"].startswith(pkg + "/")
        out.append((f["rule"], f["path"][len(pkg) + 1:], f["line"],
                    f["col"], f["message"]))
    return out


def test_jax_and_port_checkers_agree_on_the_stripped_port(tmp_path, capsys):
    from spacemesh_tpu.tools.spacecheck.__main__ import main as jax_main

    src = REPO / "spacemesh_tpu_torch"
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    stripped = 0
    for path in sorted(src.rglob("*.py")):
        rel = path.relative_to(src)
        if rel.parts[0] == "build" or "__pycache__" in rel.parts:
            continue
        text = path.read_text()
        out = _strip_marks(text)
        stripped += out != text
        for root, pkg in ((jax_root, "spacemesh_tpu"),
                          (port_root, "spacemesh_tpu_torch")):
            dst = root / pkg / rel
            dst.parent.mkdir(parents=True, exist_ok=True)
            dst.write_text(out)
    assert stripped >= 10
    jax_found = _findings(jax_main, jax_root, "spacemesh_tpu", capsys)
    port_found = _findings(cli_main, port_root, "spacemesh_tpu_torch",
                           capsys)
    # SC010's text is the port's own (a mesh of streams, not of XLA
    # shardings); its sites must still be the JAX checker's
    assert [f[:4] if f[0] == "SC010" else f for f in port_found] \
        == [f[:4] if f[0] == "SC010" else f for f in jax_found]
    assert any(f[0] == "SC010" and f[4].startswith("per-call Mesh(...)")
               for f in port_found)
    rules = {f[0] for f in port_found}
    assert {"SC001", "SC002", "SC004", "SC007"} <= rules


# --- the fixes that cleared the port's findings ------------------------


def test_kernel_build_publishes_through_fsio(tmp_path, monkeypatch):
    """``ops/_build.py`` stages nvcc's output and publishes it with
    ``fsio.persist`` (fsync, rename, fsync of the folder), and builds a
    library once."""
    from spacemesh_tpu_torch.ops import _build
    from spacemesh_tpu_torch.utils import fsio

    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    persisted = []
    real_persist = fsio.persist
    monkeypatch.setattr(fsio, "persist", lambda tmp, dst, fs=None: (
        persisted.append((Path(tmp), Path(dst))),
        real_persist(tmp, dst, fs))[-1])

    def fake_nvcc(cmd, **kw):
        out = Path(cmd[cmd.index("-o") + 1])
        out.write_bytes(b"\x7fELF library")
        return types.SimpleNamespace(returncode=0, stdout="ptxas ok",
                                     stderr="")

    monkeypatch.setattr(_build.subprocess, "run", fake_nvcc)
    lib = _build.library_path("romix")
    assert _build._build_one("romix") == "ptxas ok"
    assert persisted == [(fsio.tmp_path(lib), lib)]
    assert lib.read_bytes() == b"\x7fELF library"
    assert not fsio.stale_tmps(lib)
    assert _build._build_one("romix") == ""        # built: nothing to do
    assert len(persisted) == 1


def test_tenants_probe_unregisters_on_every_path():
    from spacemesh_tpu_torch.runtime import TenantScheduler
    from spacemesh_tpu_torch.tools import tenants_probe

    ids = tenants_probe._ids(b"t", 3)
    with TenantScheduler(device="cpu", autostart=False) as sched:
        with tenants_probe._registered(sched, ids):
            assert sorted(sched.tenants()) == sorted(t for t, _, _ in ids)
        assert sched.tenants() == []
        with pytest.raises(RuntimeError, match="boom"):
            with tenants_probe._registered(sched, ids):
                raise RuntimeError("boom")
        assert sched.tenants() == []

