"""The port's span tracer (``spacemesh_tpu_torch/utils/tracing.py``) and
its structured logging, held to the JAX package's.

Twins of ``tests/test_tracing.py`` (the no-op fast path, ring bounds,
contextvar causality, export validity, the boot knob, the end-to-end
capture of init + prove + farm), of the span-linkage half of
``tests/test_verifyd.py::test_service_parity_and_span_linkage`` and of
the JSON-log tests of ``tests/test_health_engine.py``; the
``torch.profiler`` bridge that replaces the JAX profiler bridge; and the
span multisets: one seeded init -> prove -> verify (and a farm run)
traced through both packages gives equal ``span_multiset_digest`` over
the span names both record.

Names left out of the multiset comparison, and why:

* ``pow.dispatch``: the port's k2pow search is one window launch per 2^24
  nonces (``csrc/k2pow.cu``), where the JAX search dispatches one batch
  per 2^16 nonces, so the counts differ by design;
* ``romix.race*``: the JAX ROMix autotuner's race, not ported (ROADMAP
  "Not ported, on purpose");
* the node's, p2p's and consensus's spans: not ported ([13]).

Names only the port records (:data:`PORT_ONLY`): the host steps between two
launches on the card (the label kernels' scratch, enqueues and min-scan,
the init's index build, byte conversion and checkpoint, ``HostCopy``'s copy
and wait) and the tracer's ``host.gc`` collections, which the JAX package
leaves inside its jitted program or does not trace.
"""

import asyncio
import hashlib
import io
import json
import logging
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from spacemesh_tpu_torch.utils import logging as slog
from spacemesh_tpu_torch.utils import tracing

REPO = Path(__file__).resolve().parent.parent

# span names both packages record whose counts differ by design (module
# docstring)
EXCLUDED = ("pow.dispatch", "romix.race", "romix.race_candidate")
# span names the port alone records (module docstring)
PORT_ONLY = ("romix.scratch", "scrypt.expand", "romix.launch",
             "scrypt.finish", "scrypt.minscan", "init.build",
             "init.to_bytes", "init.checkpoint", "device.host_copy",
             "device.host_wait", "host.gc")


@pytest.fixture(autouse=True)
def _tracer_off():
    """Every test starts and ends with both tracers disabled."""
    from spacemesh_tpu.utils import tracing as jtracing

    tracing.stop()
    jtracing.stop()
    yield
    tracing.stop()
    jtracing.stop()
    tracing.set_process_identity(f"pid-{os.getpid()}")
    jtracing.set_process_identity(f"pid-{os.getpid()}")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test process (tier-1 runs files in parallel
    workers; torch's default pool oversubscribes the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- disabled fast path -----------------------------------------------


def test_disabled_span_is_the_noop_singleton(monkeypatch):
    import gc

    import numpy as np

    from spacemesh_tpu_torch.device import HostCopy
    from spacemesh_tpu_torch.ops import scrypt, u32

    assert not tracing.is_enabled()
    assert tracing.span("anything") is tracing._NOP
    assert tracing.span("x", {"k": 1}, parent=7) is tracing._NOP
    tracing.instant("x")
    with tracing.span("x") as sp:
        sp.set(a=1)
    assert sp is tracing._NOP and sp.id is None
    assert tracing.current_id() is None
    assert tracing.link_token() is None
    assert tracing.span("q").begin() is tracing._NOP
    # no collection runs the tracer's hook
    assert tracing.TRACER._on_gc not in gc.callbacks
    # the host steps of a label batch: each call site gets the singleton
    # and builds no attribute dict
    calls = []
    real = tracing.span

    def spy(name, attrs=None, parent=None, cat="host"):
        calls.append((name, attrs, real(name, attrs, parent, cat)))
        return calls[-1][2]

    monkeypatch.setattr(tracing, "span", spy)
    lo, hi = scrypt.split_indices(np.arange(8, dtype=np.uint64))
    words, _, snap = scrypt.scrypt_labels_with_min(
        u32.from_numpy(scrypt.commitment_to_words(b"c" * 32), "cpu"),
        u32.from_numpy(lo, "cpu"), u32.from_numpy(hi, "cpu"),
        u32.from_numpy(scrypt.vrf_carry_init(), "cpu"), n=2)
    HostCopy(words).get()
    assert {"romix.dispatch", "romix.scratch", "scrypt.expand",
            "scrypt.finish", "scrypt.minscan", "device.host_copy",
            "device.host_wait"} == {name for name, _, _ in calls}
    assert all(sp is tracing._NOP and attrs is None
               for _, attrs, sp in calls)


def test_disabled_span_call_is_cheap():
    """The disabled path stays an attribute check + singleton return:
    200k calls in well under a second on a loaded host."""
    span = tracing.span
    t0 = time.perf_counter()
    for _ in range(200_000):
        with span("hot"):
            pass
    dt = time.perf_counter() - t0
    assert dt < 1.0, f"disabled span path too slow: {dt:.3f}s / 200k"


# --- recording + export -----------------------------------------------


def test_span_records_parenting_and_attrs():
    tracing.start(capacity=64)
    with tracing.span("outer", {"a": 1}) as outer:
        assert tracing.current_id() == outer.id
        with tracing.span("inner") as inner:
            inner.set(b=2)
        tracing.instant("mark", {"m": 3})
    assert tracing.current_id() is None
    doc = tracing.export()
    assert tracing.validate(doc) == []
    evs = {e["name"]: e for e in doc["traceEvents"] if e["ph"] != "M"}
    assert evs["outer"]["args"]["a"] == 1
    assert evs["inner"]["args"]["parent"] == evs["outer"]["args"]["id"]
    assert evs["inner"]["args"]["b"] == 2
    assert evs["mark"]["ph"] == "i"
    assert evs["mark"]["args"]["parent"] == evs["outer"]["args"]["id"]
    assert evs["outer"]["dur"] >= evs["inner"]["dur"] >= 0
    assert doc["otherData"]["tool"] == "spacemesh_tpu_torch.utils.tracing"


def test_async_context_propagation():
    tracing.start(capacity=64)

    async def child():
        with tracing.span("child"):
            await asyncio.sleep(0)

    async def main():
        async with tracing.span("root") as root:
            await asyncio.gather(child(), child())
            return root.id

    root_id = asyncio.run(main())
    doc = tracing.export()
    tracing.validate(doc)
    children = [e for e in doc["traceEvents"] if e["name"] == "child"]
    assert len(children) == 2
    assert all(e["args"]["parent"] == root_id for e in children)


def test_thread_parent_handoff():
    tracing.start(capacity=64)
    seen = {}

    def worker(parent):
        with tracing.span("pool.work", parent=parent) as sp:
            seen["id"] = sp.id

    with tracing.span("submitter") as sub:
        t = threading.Thread(target=worker, args=(tracing.current_id(),))
        t.start()
        t.join()
    doc = tracing.export()
    tracing.validate(doc)
    work = [e for e in doc["traceEvents"] if e["name"] == "pool.work"][0]
    assert work["args"]["parent"] == sub.id
    tids = {e["tid"] for e in doc["traceEvents"] if e["ph"] != "M"}
    assert len(tids) == 2


def test_detached_span_ends_on_another_thread():
    """begin()/end(): a span opened on one thread and ended on another
    leaves both threads' current span alone and parents what names it."""
    assert tracing.span("off").begin() is tracing._NOP
    tracing.start(capacity=64)
    with tracing.span("opener") as opener:
        sess = tracing.span("session").begin()
        assert tracing.current_id() == opener.id
    assert tracing.current_id() is None
    seen = {}

    def other():
        with tracing.span("window", parent=sess.id):
            pass
        sess.end()
        seen["after"] = tracing.current_id()

    t = threading.Thread(target=other)
    t.start()
    t.join()
    assert seen == {"after": None} and tracing.current_id() is None
    doc = tracing.export()
    tracing.validate(doc)
    ev = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert ev["session"]["args"]["parent"] == opener.id
    assert ev["window"]["args"]["parent"] == sess.id
    assert ev["session"]["tid"] != ev["opener"]["tid"]


def test_ring_is_bounded_and_counts_drops():
    tracing.start(capacity=16)
    for i in range(50):
        with tracing.span(f"s{i}"):
            pass
    doc = tracing.export()
    warnings = tracing.validate(doc)
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == 16
    assert doc["otherData"]["captured_spans"] == 16
    assert doc["otherData"]["dropped_spans"] == 34
    assert {e["name"] for e in xs} == {f"s{i}" for i in range(34, 50)}
    assert warnings and "dropped 34" in warnings[0]
    assert warnings == tracing.drop_warnings(doc)


def test_restart_resets_the_capture():
    tracing.start(capacity=16)
    with tracing.span("first"):
        pass
    tracing.start(capacity=16)
    with tracing.span("second"):
        pass
    names = {e["name"] for e in tracing.export()["traceEvents"]
             if e["ph"] == "X"}
    assert names == {"second"}


def test_export_json_roundtrip(tmp_path):
    tracing.start(capacity=16)
    with tracing.span("a"):
        pass
    path = tmp_path / "trace.json"
    tracing.export_json(str(path))
    doc = json.loads(path.read_text())
    tracing.validate(doc)
    assert any(e["name"] == "a" for e in doc["traceEvents"])


@pytest.mark.parametrize("doc", [
    [],
    {"traceEvents": [{"ph": "X"}]},
    {"traceEvents": [{"name": "x", "pid": 1, "tid": 1, "ph": "Z",
                      "ts": 0}]},
    {"traceEvents": [{"name": "x", "pid": 1, "tid": 1, "ph": "X",
                      "ts": 0}]},
    {"traceEvents": [{"name": "x", "pid": 1, "tid": 1, "ph": "X",
                      "ts": 10, "dur": 1},
                     {"name": "x", "pid": 1, "tid": 1, "ph": "X",
                      "ts": 5, "dur": 1}]},
    {"traceEvents": [{"name": "x", "pid": 1, "tid": 1, "ph": "E",
                      "ts": 0}]},
    {"traceEvents": [{"name": "x", "pid": 1, "tid": 1, "ph": "B",
                      "ts": 0}]},
], ids=["not-a-dict", "missing-keys", "phase", "x-without-dur",
        "ts-backwards", "e-without-b", "unclosed-b"])
def test_validate_rejects_malformed_docs_as_the_jax_one_does(doc):
    from spacemesh_tpu.utils import tracing as jtracing

    with pytest.raises(ValueError) as port_err:
        tracing.validate(doc)
    with pytest.raises(ValueError) as jax_err:
        jtracing.validate(doc)
    assert str(port_err.value) == str(jax_err.value)


def test_summarize_self_time_and_wait_split_equals_the_jax_one():
    from spacemesh_tpu.utils import tracing as jtracing

    tracing.start(capacity=64)
    with tracing.span("stage.work"):
        with tracing.span("stage.read_wait"):
            time.sleep(0.01)
    doc = tracing.export()
    summary = tracing.summarize(doc)
    by_name = {r["name"]: r for r in summary["top_self_time"]}
    assert by_name["stage.work"]["self_us"] <= (
        by_name["stage.work"]["total_us"]
        - by_name["stage.read_wait"]["total_us"] + 1000)
    st = summary["stages"]["stage"]
    assert st["wait_us"] > 0 and 0.0 <= st["wait_frac"] <= 1.0
    text = tracing.render_summary(summary)
    assert "stage.read_wait" in text and "wait %" in text
    # the same document digests identically through the JAX package
    assert jtracing.summarize(json.loads(json.dumps(doc))) == summary
    assert jtracing.render_summary(summary) == text


def _boot_probe(env_extra: dict) -> str:
    env = dict(os.environ)
    env.update(env_extra)
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; from spacemesh_tpu_torch.utils import tracing; "
         "print(tracing.is_enabled(), tracing.TRACER.capacity, "
         "tracing.TRACER.torch_bridge, 'jax' in sys.modules)"],
        env=env, capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_boot_env_knobs_start_capture_and_bridge():
    assert _boot_probe({"SPACEMESH_TRACE": "4096"}).startswith(
        "True 4096 False")
    assert _boot_probe({"SPACEMESH_TRACE": "1",
                        "SPACEMESH_TRACE_TORCH": "1"}).startswith(
        "True 65536 True")
    assert _boot_probe({"SPACEMESH_TRACE": "off"}).startswith("False")


# --- the torch.profiler bridge --------------------------------------------


def test_torch_bridge_opens_record_function_ranges():
    """With the bridge on, each span is a ``record_function`` range in a
    ``torch.profiler`` capture (on the card the kernels' launches fall
    inside them: ``chip_smoke.py`` ``[trace]`` joins them)."""
    from torch.profiler import ProfilerActivity, profile

    tracing.start(capacity=64, torch_bridge=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("bridge.outer"):
            with tracing.span("bridge.inner"):
                torch.ones(8).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"bridge.outer", "bridge.inner"} <= names
    # the ring records them too
    spans = {e["name"] for e in tracing.export()["traceEvents"]
             if e["ph"] == "X"}
    assert {"bridge.outer", "bridge.inner"} <= spans
    # bridge off (the default without the env var): no ranges
    tracing.start(capacity=64, torch_bridge=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("bridge.off"):
            pass
    assert "bridge.off" not in {e.key for e in prof.key_averages()}


def test_torch_bridge_env_default(monkeypatch):
    monkeypatch.setenv("SPACEMESH_TRACE_TORCH", "1")
    tracing.start(capacity=16)
    assert tracing.TRACER.torch_bridge
    monkeypatch.setenv("SPACEMESH_TRACE_TORCH", "off")
    tracing.start(capacity=16)
    assert not tracing.TRACER.torch_bridge
    tracing.start(capacity=16, torch_bridge=True)  # explicit wins
    assert tracing.TRACER.torch_bridge


# --- structured logging ---------------------------------------------------


def test_json_log_lines_carry_span_id():
    buf = io.StringIO()
    slog.configure(json_lines=True, stream=buf)
    root = logging.getLogger(slog.ROOT)
    handler = root.handlers[0]
    old_stream = handler.stream
    handler.stream = buf
    try:
        log = slog.get("health")
        tracing.start(capacity=64)
        with tracing.span("health.tick") as sp:
            log.warning("SLO breach: %s", "farm_queue_wait")
        log.warning("outside")
        lines = [json.loads(x) for x in buf.getvalue().splitlines()]
        assert lines[0]["span"] == sp.id
        assert lines[0]["msg"] == "SLO breach: farm_queue_wait"
        assert lines[0]["logger"] == f"{slog.ROOT}.health"
        assert lines[0]["level"] == "WARNING"
        assert "span" not in lines[1]
    finally:
        handler.stream = old_stream
        slog.configure(json_lines=False)


def test_log_json_env_knob(monkeypatch):
    monkeypatch.setenv("SPACEMESH_LOG_JSON", "1")
    assert slog.json_mode_enabled()
    monkeypatch.setenv("SPACEMESH_LOG_JSON", "off")
    assert not slog.json_mode_enabled()


# --- imports ---------------------------------------------------------------

_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|spacemesh_tpu)\b",
                     re.M)


def test_grep_no_port_module_imports_jax_or_the_jax_package():
    """Every line of the port and of chip_smoke.py, lazy imports inside
    functions included."""
    files = sorted((REPO / "spacemesh_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert any(f.name == "tracing.py" for f in files)
    bad = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
           for f in files for m in _IMPORT.finditer(f.read_text())]
    assert bad == []


# --- the seeded init -> prove -> verify (+ farm) capture, both packages ----

NODE = hashlib.sha256(b"trace-node").digest()
COMMIT = hashlib.sha256(b"trace-commit").digest()
CHALLENGE = hashlib.sha256(b"trace-ch").digest()
GEOMETRY = dict(num_units=1, labels_per_unit=512, scrypt_n=2,
                max_file_size=4096, batch_size=128, meta_interval_s=3600.0)
PARAMS = dict(k1=64, k2=8, k3=4, pow_difficulty=bytes([32]) + bytes([255]) * 31)


def _port_path(tmp_path):
    from spacemesh_tpu_torch.post import initializer, verifier
    from spacemesh_tpu_torch.post.prover import ProofParams, Prover
    from spacemesh_tpu_torch.verify.farm import (Lane, PostRequest,
                                                 VerificationFarm)

    initializer.initialize(str(tmp_path), node_id=NODE, commitment=COMMIT,
                           device="cpu", **GEOMETRY)
    params = ProofParams(**PARAMS)
    proof = Prover(str(tmp_path), params, batch_labels=256,
                   device="cpu").prove(CHALLENGE)
    item = verifier.VerifyItem(proof=proof, challenge=CHALLENGE,
                               node_id=NODE, commitment=COMMIT, scrypt_n=2,
                               total_labels=512)
    ok = verifier.verify_many([item], params, seed=b"s", device="cpu")

    async def farm_leg():
        farm = VerificationFarm(post_params=params, post_seed=b"s",
                                device="cpu")
        try:
            return await farm.submit(PostRequest(item), lane=Lane.GOSSIP)
        finally:
            await farm.aclose()

    return proof, ok + [asyncio.run(farm_leg())]


def _jax_path(tmp_path):
    from spacemesh_tpu.post import initializer, verifier
    from spacemesh_tpu.post.prover import ProofParams, Prover
    from spacemesh_tpu.verify.farm import Lane, PostRequest, VerificationFarm

    initializer.initialize(str(tmp_path), node_id=NODE, commitment=COMMIT,
                           **GEOMETRY)
    params = ProofParams(**PARAMS)
    proof = Prover(str(tmp_path), params, batch_labels=256).prove(CHALLENGE)
    item = verifier.VerifyItem(proof=proof, challenge=CHALLENGE,
                               node_id=NODE, commitment=COMMIT, scrypt_n=2,
                               total_labels=512)
    ok = verifier.verify_many([item], params, seed=b"s")

    async def farm_leg():
        farm = VerificationFarm(post_params=params, post_seed=b"s")
        try:
            return await farm.submit(PostRequest(item), lane=Lane.GOSSIP)
        finally:
            await farm.aclose()

    return proof, ok + [asyncio.run(farm_leg())]


def _names_only(doc, keep) -> dict:
    """The capture restricted to span names in ``keep``."""
    out = dict(doc)
    out["traceEvents"] = [e for e in doc["traceEvents"]
                          if e.get("ph") == "M" or e["name"] in keep]
    return out


def _span_names(doc) -> dict:
    counts: dict = {}
    for e in doc["traceEvents"]:
        if e.get("ph") in ("X", "i"):
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    return counts


@pytest.fixture(scope="module")
def both_captures(tmp_path_factory):
    from spacemesh_tpu.utils import tracing as jtracing

    tracing.set_process_identity("trace-path")
    tracing.start(capacity=16384, torch_bridge=False)
    try:
        port_out = _port_path(tmp_path_factory.mktemp("port"))
    finally:
        tracing.stop()
    port_doc = tracing.export()
    jtracing.set_process_identity("trace-path")
    jtracing.start(capacity=16384, jax_bridge=False)
    try:
        jax_out = _jax_path(tmp_path_factory.mktemp("jax"))
    finally:
        jtracing.stop()
    jax_doc = jtracing.export()
    return port_out, port_doc, jax_out, jax_doc


def test_capture_init_prove_farm_end_to_end(both_captures):
    """tests/test_tracing.py's acceptance capture on the port: it
    validates, every layer contributed spans, the farm request links to
    its batch both ways, a prove window's spans share its window id and
    parent into it, and the writer pool's spans crossed the thread
    boundary with their submit-side parent."""
    (proof, verdicts), doc, _, _ = both_captures
    assert proof.nonce >= 0 and verdicts == [True, True]
    assert tracing.validate(doc) == []
    evs = [e for e in doc["traceEvents"] if e["ph"] in ("X", "i")]
    names = {e["name"] for e in evs}
    assert {"init.run", "init.dispatch", "init.fetch", "init.write",
            "prove.run", "prove.window", "prove.read_io", "prove.dispatch",
            "prove.retire", "romix.dispatch", "farm.request",
            "farm.batch"} <= names

    batches = {e["args"]["id"]: e for e in evs if e["name"] == "farm.batch"}
    linked = 0
    for e in evs:
        if e["name"] == "farm.request" and "batch" in e["args"]:
            assert e["args"]["id"] in batches[e["args"]["batch"]]["args"][
                "members"]
            linked += 1
    assert linked >= 1
    # the batch's recompute nests under it across the backend thread
    romix_parents = {e["args"].get("parent") for e in evs
                     if e["name"] == "romix.dispatch"}
    assert set(batches) & romix_parents

    windows: dict = {}
    for e in evs:
        if e["name"] in ("prove.read_wait", "prove.dispatch",
                         "prove.retire"):
            windows.setdefault(e["args"]["window"], set()).add(e["name"])
    assert windows[min(windows)] == {"prove.read_wait", "prove.dispatch",
                                     "prove.retire"}
    wspans = {e["args"]["id"] for e in evs if e["name"] == "prove.window"}
    for e in evs:
        if e["name"] in ("prove.dispatch", "prove.read_io"):
            assert e["args"]["parent"] in wspans

    writes = [e for e in evs if e["name"] == "init.write"]
    submit_side = {e["args"]["id"] for e in evs
                   if e["name"] in ("init.fetch", "init.write_stall")}
    assert writes and all(e["args"].get("parent") in submit_side
                          for e in writes)


def test_span_multiset_digest_equals_the_jax_package(both_captures):
    """The same seeded path through both packages: the same proof and
    verdicts, and equal span multisets over the names both record (minus
    EXCLUDED)."""
    (proof, verdicts), doc, (jproof, jverdicts), jdoc = both_captures
    from spacemesh_tpu.utils import tracing as jtracing

    assert (proof.nonce, proof.indices, proof.pow_nonce) == (
        jproof.nonce, jproof.indices, jproof.pow_nonce)
    assert verdicts == jverdicts
    port_names, jax_names = _span_names(doc), _span_names(jdoc)
    shared = (set(port_names) & set(jax_names)) - set(EXCLUDED)
    assert {"init.run", "init.dispatch", "prove.window", "prove.retire",
            "romix.dispatch", "farm.batch"} <= shared
    assert {n: port_names[n] for n in shared} == \
        {n: jax_names[n] for n in shared}
    a = tracing.span_multiset_digest(
        tracing.merge_captures([_names_only(doc, shared)]))
    b = jtracing.span_multiset_digest(
        jtracing.merge_captures([_names_only(jdoc, shared)]))
    assert a == b
    # what only one package records is accounted for
    assert set(port_names) - set(jax_names) <= set(EXCLUDED + PORT_ONLY), \
        set(port_names) - set(jax_names)


# --- verifyd: parity and the request -> batch linkage -----------------------


def test_service_span_linkage_matches_the_jax_service():
    """tests/test_verifyd.py::test_service_parity_and_span_linkage's
    linkage half, on the port's service: verifyd.request ->
    verifyd.drain -> farm.request -> farm.batch, the request's link token
    recorded, verdicts equal to the JAX service's."""
    from spacemesh_tpu.core.signing import EdSigner as JSigner
    from spacemesh_tpu.verify.farm import SigRequest as JSig
    from spacemesh_tpu.verifyd.service import VerifydService as JService
    from spacemesh_tpu_torch.core.signing import EdSigner
    from spacemesh_tpu_torch.verify.farm import SigRequest
    from spacemesh_tpu_torch.verifyd.service import VerifydService

    seed = hashlib.sha256(b"linkage").digest()
    signer, jsigner = EdSigner(seed), JSigner(seed)
    msgs = [b"m-%d" % i for i in range(6)]
    sigs = [signer.sign(1, m) for m in msgs]
    sigs[2] = bytes(64)  # one bad signature
    reqs = [SigRequest(1, signer.public_key, m, s)
            for m, s in zip(msgs, sigs)]
    jreqs = [JSig(1, jsigner.public_key, m, s) for m, s in zip(msgs, sigs)]

    async def run(svc, rs, parent):
        await svc.start()
        try:
            svc.register_client("c")
            return await svc.verify("c", rs, trace_parent=parent)
        finally:
            await svc.aclose()

    tracing.start(capacity=4096)
    got = asyncio.run(run(VerifydService(device="cpu"), reqs, "peer/7"))
    tracing.stop()
    want = asyncio.run(run(JService(), jreqs, None))
    assert got == want == [True, True, False, True, True, True]
    evs = [e for e in tracing.export()["traceEvents"] if e["ph"] == "X"]
    by_id = {e["args"]["id"]: e for e in evs}
    req = [e for e in evs if e["name"] == "verifyd.request"]
    assert len(req) == 1 and req[0]["args"]["link"] == "peer/7"
    drain = [e for e in evs if e["name"] == "verifyd.drain"]
    assert drain and all(e["args"]["parent"] == req[0]["args"]["id"]
                         for e in drain)
    freqs = [e for e in evs if e["name"] == "farm.request"]
    assert len(freqs) == 6
    assert all(by_id[e["args"]["parent"]]["name"] == "verifyd.drain"
               for e in freqs)
    assert all(by_id[e["args"]["batch"]]["name"] == "farm.batch"
               for e in freqs)
