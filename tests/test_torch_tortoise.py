"""The port's tortoise (``spacemesh_tpu_torch/consensus/tortoise.py``)
against the JAX package's.

The cases of ``tests/test_tortoise.py``, ``tests/test_tortoise_model.py``
and ``tests/test_tortoise_scenarios.py`` run once on each package: every
tortoise the case makes records its JSON trace, each tally's (last,
verified, mode), each ``updates()`` and each ``encode_votes()``, and the
two records must be equal; each case's own assertions hold on the port.
``tests/test_tortoise_stress.py``'s quick shape runs through
``chip_smoke.py``'s stress harness on both packages (its invariants, an
equal ``updates()`` digest). A seeded stream with late blocks,
unknown-base ballots, bad beacons, malfeasance at the eviction edge and
a window slide goes through both tortoises step by step, and each
package's ``replay_trace`` rebuilds the other's tortoise from its trace.
Exact equality throughout.
"""

import hashlib
import importlib
import importlib.util
import inspect
import itertools
import pathlib
import re
import types as pytypes

import numpy as np
import pytest

TESTS = pathlib.Path(__file__).resolve().parent
PKGS = ("spacemesh_tpu", "spacemesh_tpu_torch")


def twin_module(name: str, pkg: str):
    """``tests/<name>.py`` loaded as a module whose imports name ``pkg``."""
    src = (TESTS / f"{name}.py").read_text()
    src = re.sub(r"\bspacemesh_tpu\b", pkg, src)
    mod = pytypes.ModuleType(f"_{pkg}_{name}")
    mod.__file__ = str(TESTS / f"{name}.py")
    exec(compile(src, f"{mod.__file__} [{pkg}]", "exec"), mod.__dict__)
    return mod


def cases(name: str) -> list:
    """(file, function, parameters) for every test case of the file, one
    per parametrized value."""
    mod = twin_module(name, PKGS[0])
    out = []
    for fn_name in sorted(n for n in dir(mod) if n.startswith("test_")):
        fn = getattr(mod, fn_name)
        marks = [m for m in getattr(fn, "pytestmark", [])
                 if m.name == "parametrize"]
        if not marks:
            out.append(pytest.param(name, fn_name, {},
                                    id=f"{name}::{fn_name}"))
            continue
        (argname, values), = [m.args for m in marks]
        for v in values:
            out.append(pytest.param(name, fn_name, {argname: v},
                                    id=f"{name}::{fn_name}[{v}]"))
    return out


def call_case(mod, case: str, params: dict, tmp_path) -> None:
    fn = getattr(mod, case)
    kwargs = dict(params)
    for name in inspect.signature(fn).parameters:
        if name == "tmp_path":
            kwargs[name] = tmp_path
        elif name not in kwargs and inspect.signature(fn).parameters[
                name].default is inspect.Parameter.empty:
            kwargs[name] = getattr(mod, name)._get_wrapped_function()()
    fn(**kwargs)


def record_tortoises(monkeypatch, pkg: str, log: list) -> None:
    """Every ``Tortoise`` of ``pkg`` records into ``log``: its trace lines
    (a tracer added beside the caller's), each tally's outcome, each
    ``updates()`` and ``encode_votes()``."""
    T = importlib.import_module(f"{pkg}.consensus.tortoise").Tortoise
    real_init, real_tally = T.__init__, T.tally_votes
    real_updates, real_encode = T.updates, T.encode_votes
    ids = itertools.count()

    def init(self, *a, tracer=None, **kw):
        k = next(ids)

        def trace(line, _k=k, _tracer=tracer):
            log.append(("trace", _k, line))
            if _tracer is not None:
                _tracer(line)

        real_init(self, *a, tracer=trace, **kw)
        self._twin_id = k

    def tally(self, last):
        real_tally(self, last)
        log.append(("tally", self._twin_id, last, self.verified, self.mode))

    def updates(self):
        out = real_updates(self)
        log.append(("updates", self._twin_id,
                    [(u.layer, u.block_id, u.valid) for u in out]))
        return out

    def encode(self, for_layer):
        op = real_encode(self, for_layer)
        log.append(("votes", self._twin_id, for_layer, op.base,
                    list(op.support), list(op.against), list(op.abstain)))
        return op

    monkeypatch.setattr(T, "__init__", init)
    monkeypatch.setattr(T, "tally_votes", tally)
    monkeypatch.setattr(T, "updates", updates)
    monkeypatch.setattr(T, "encode_votes", encode)


CASES = (cases("test_tortoise") + cases("test_tortoise_model")
         + cases("test_tortoise_scenarios"))


@pytest.mark.parametrize("name,case,params", CASES)
def test_tortoise_case_twin(name, case, params, monkeypatch, tmp_path):
    runs = {}
    for pkg in PKGS:
        log: list = []
        record_tortoises(monkeypatch, pkg, log)
        call_case(twin_module(name, pkg), case, params, tmp_path / pkg)
        monkeypatch.undo()
        runs[pkg] = log
    assert any(e[0] == "trace" for e in runs[PKGS[0]])
    assert runs[PKGS[1]] == runs[PKGS[0]]


# --- the stress harness's quick shape ------------------------------------


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", TESTS.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


QUICK = dict(layers=300, window=150, ballots=50, blocks=3, atxs=2000,
             lpe=100, hdist=10, zdist=8)


def test_stress_quick_shape_equal_digest():
    cs = chip_smoke()
    got = {}
    for pkg in PKGS:
        tortoise = importlib.import_module(f"{pkg}.consensus.tortoise")
        types = importlib.import_module(f"{pkg}.core.types")
        cache = importlib.import_module(f"{pkg}.storage.cache")
        s = cs.mesh_stress(tortoise.Tortoise, types.Opinion, cache.AtxCache,
                           cache.AtxInfo, QUICK)
        cs.mesh_stress_check(s, QUICK)
        got[pkg] = (s["digest"], s["updates"], s["verified"], s["ballots"],
                    s["cols"])
    assert got[PKGS[0]][1] > QUICK["layers"]
    assert got[PKGS[1]] == got[PKGS[0]]


# --- a seeded stream, step by step ----------------------------------------

LPE, HDIST, ZDIST, WINDOW, LAYERS = 10, 4, 2, 40, 110
NODES = [b"node-%02d" % i + bytes(25) for i in range(16)]
EMPTY = bytes(32)


def _id(tag: bytes, *nums) -> bytes:
    return hashlib.sha256(tag + b"-".join(b"%d" % n for n in nums)).digest()


def stream(seed: int) -> list:
    """The events: blocks (some delivered up to 5 layers late), hare
    outputs (a block, empty, or none), weak coins, ballots on random bases
    (some delivered late, so later ballots arrive before their base),
    with support, against and abstain lists, random weights and bad
    beacons; node 0 votes in every layer and is condemned when the window
    has slid past its first ballots; one tally per layer."""
    rng = np.random.default_rng(seed)
    ev, late, ballots = [], {}, []
    blocks: dict = {}
    for layer in range(1, LAYERS + 1):
        for e in late.pop(layer, []):
            ev.append(e)
        blocks[layer] = [_id(b"blk", seed, layer, j)
                         for j in range(int(rng.integers(1, 4)))]
        for b in blocks[layer]:
            e = ("block", layer, b)
            if rng.random() < 0.15:
                late.setdefault(layer + int(rng.integers(1, 6)), []).append(e)
            else:
                ev.append(e)
        r = rng.random()
        if r < 0.75:
            ev.append(("hare", layer, blocks[layer][0]))
        elif r < 0.85:
            ev.append(("hare", layer, EMPTY))
        ev.append(("coin", layer, bool(rng.integers(2))))
        for k in range(int(rng.integers(5, 12))):
            node = NODES[0] if k == 0 else NODES[int(rng.integers(1, 16))]
            base = EMPTY if not ballots or rng.random() < 0.05 else \
                ballots[-int(rng.integers(1, min(30, len(ballots)) + 1))]
            lo = max(1, layer - 8)
            support = [blocks[x][0] for x in range(lo, layer)
                       if rng.random() < 0.7]
            against = [blocks[x][-1] for x in range(lo, layer)
                       if rng.random() < 0.1]
            abstain = [layer - 1] if layer > 1 and rng.random() < 0.05 else []
            bid = _id(b"ballot", seed, layer, k)
            e = ("ballot", bid, layer, node, base, support, against, abstain,
                 int(rng.integers(1, 100)), bool(rng.random() < 0.08))
            if k and rng.random() < 0.05:
                late.setdefault(layer + int(rng.integers(1, 4)), []).append(e)
            else:
                ev.append(e)
            ballots.append(bid)
        if layer == WINDOW + 25:
            ev.append(("malfeasance", NODES[0]))
        ev.append(("tally", layer))
    return ev


def make_cache(pkg: str):
    cache_mod = importlib.import_module(f"{pkg}.storage.cache")
    cache = cache_mod.AtxCache()
    for epoch in range(LAYERS // LPE + 2):
        for i, node in enumerate(NODES):
            cache.add(epoch, _id(b"atx", epoch, i), cache_mod.AtxInfo(
                node_id=node, weight=50 * LPE, base_height=0, height=1,
                num_units=1, vrf_nonce=0, vrf_public_key=node))
    return cache


def drive(pkg: str, events: list) -> tuple:
    tortoise = importlib.import_module(f"{pkg}.consensus.tortoise")
    types = importlib.import_module(f"{pkg}.core.types")
    cache = make_cache(pkg)
    lines: list = []
    t = tortoise.Tortoise(cache, LPE, hdist=HDIST, zdist=ZDIST,
                          window=WINDOW, tracer=lines.append)
    steps, waits, pending = [], 0, 0
    for e in events:
        kind = e[0]
        if kind == "block":
            t.on_block(e[1], e[2])
        elif kind == "hare":
            t.on_hare_output(e[1], e[2])
        elif kind == "coin":
            t.on_weak_coin(e[1], e[2])
        elif kind == "malfeasance":
            t.on_malfeasance(e[1])
        elif kind == "ballot":
            _, bid, layer, node, base, sup, ag, ab, weight, bad = e
            waits += base != EMPTY and base not in t._ballots
            pending += any(b not in t._col_of for b in sup)
            t._ingest(bid, layer, node, types.Opinion(
                base=base, support=list(sup), against=list(ag),
                abstain=list(ab)), weight, bad_beacon=bad)
        else:
            t.tally_votes(e[1])
            op = t.encode_votes(e[1] + 1)
            steps.append((e[1], [(u.layer, u.block_id, u.valid)
                                 for u in t.updates()], t.verified, t.mode,
                          (op.base, op.support, op.against, op.abstain),
                          len(lines)))
    t.twin_counts = (waits, pending)
    return t, lines, steps


def summary(t) -> tuple:
    op = t.encode_votes(t.processed + 1)
    return (t.verified, t.processed, t.mode, sorted(t._validity.items()),
            [t.valid_blocks(x) for x in range(1, t.processed + 1)],
            (op.base, op.support, op.against, op.abstain))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_seeded_stream_step_by_step(seed):
    events = stream(seed)
    (tj, lj, sj), (tp, lp, sp) = (drive(pkg, events) for pkg in PKGS)
    for a, b in zip(sj, sp):
        assert b == a, f"after the tally of layer {a[0]}"
    assert len(sp) == len(sj) == LAYERS
    assert lp == lj
    # the stream reached what it is made for
    kinds = {json_ev for json_ev in (line.split('"ev": "')[1].split('"')[0]
                                     for line in lj)}
    assert {"block", "ballot", "hare", "coin", "malfeasance", "tally",
            "verified"} <= kinds
    waits, pending = tp.twin_counts
    assert waits and pending  # unknown bases and votes for late blocks
    assert tp.verified >= LAYERS - HDIST - 1 - ZDIST
    assert min(tp._ballots_by_layer) > 1  # the window slid
    assert summary(tp) == summary(tj)


@pytest.mark.parametrize("seed", [1, 2])
def test_replay_trace_across_packages(seed):
    """Each package replays the other's trace and agrees with that
    package's own replay of it: the same trace lines again, the same
    state. (A replay is not the original run when ballots waited behind an
    unknown base: the trace records them as they landed, so the replay
    ingests them directly and marks fewer layers dirty, in both
    packages alike.)"""
    events = stream(seed)
    (_, lj, _), (_, lp, _) = (drive(pkg, events) for pkg in PKGS)
    assert lj == lp
    mods = [importlib.import_module(f"{pkg}.consensus.tortoise")
            for pkg in PKGS]
    for lines in (lj, lp):
        got = []
        for mod, pkg in zip(mods, PKGS):
            relines: list = []
            r = mod.replay_trace(lines, cache=make_cache(pkg),
                                 tracer=relines.append)
            got.append((relines, summary(r)))
        assert got[1] == got[0]
        assert got[0][0][0] == lines[0]
        assert len(got[0][0]) >= len(lines) - 10
