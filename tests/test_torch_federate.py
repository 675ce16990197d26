"""The metric half of the port's federation plane
(``spacemesh_tpu_torch/obs/federate.py``), held to the JAX package's.

Twins of the five metric tests of ``tests/test_federate.py`` (the strict
escape-aware parser, sample/exposition agreement, the proc lifecycle and
its gauge) on the port, plus parity: the same exposition text and the
same samples federate to equal exposition in both packages, and either
package's parser reads the other's ``/metrics`` text alike.
"""

import random

import pytest

from spacemesh_tpu.obs import federate as jfederate
from spacemesh_tpu.utils import metrics as jmetrics
from spacemesh_tpu_torch.obs.federate import (FEDERATION, Federation,
                                              flatten_samples,
                                              parse_exposition)
from spacemesh_tpu_torch.utils import metrics


@pytest.fixture(autouse=True)
def _clean_slate():
    """Every test starts with no federated procs."""
    FEDERATION.clear()
    yield
    FEDERATION.clear()


# --- the strict exposition parser --------------------------------------


def test_parser_roundtrips_escaped_label_values():
    reg = metrics.Registry()
    g = reg.gauge("nasty_gauge", "hostile label values")
    hostile = 'quote " backslash \\ newline \n done'
    g.set(2.5, peer=hostile, plain="ok")
    series = parse_exposition(reg.expose())
    match = [(lb, v) for name, lb, v in series if name == "nasty_gauge"]
    assert match == [({"peer": hostile, "plain": "ok"}, 2.5)]


def test_parser_rejects_garbage_lines():
    for bad in ("not a metric", 'x{a="1} 2', 'x{a="1"} ',
                'x{=""} 1', "x 1 2 3"):
        with pytest.raises(ValueError):
            parse_exposition(bad)
    # comments and blanks are fine
    assert parse_exposition("# HELP x y\n\n") == []


def test_flatten_samples_matches_expose_histograms_included():
    """Pipe-shipped (sample) and HTTP-shipped (exposition) snapshots of
    the same registry must federate to the SAME triples — or a shard
    worker and a verifyd replica would disagree about one metric."""
    reg = metrics.Registry()
    reg.counter("c_total", "c").inc(3, kind="a")
    reg.gauge("g", "g").set(1.5)
    h = reg.histogram("h_seconds", "h", buckets=(0.1, 1.0))
    h.observe(0.05, lane="x")
    h.observe(5.0, lane="x")

    def key(triples):
        return sorted((n, tuple(sorted(lb.items())), v)
                      for n, lb, v in triples)

    assert key(flatten_samples(reg.sample())) == \
        key(parse_exposition(reg.expose()))


# --- the Federation container ------------------------------------------


def test_federation_proc_lifecycle_and_cardinality_hygiene():
    fed = Federation()
    fed.update("w1", [("up", {"x": "1"}, 1.0)], trace={"traceEvents": []})
    fed.update("w2", [("up", {}, 1.0)])
    text = fed.expose()
    series = parse_exposition(text)
    assert {lb.get("proc") for _, lb, _ in series} == {"w1", "w2"}
    # clean exit: drop removes EVERY series for that proc
    assert fed.drop("w1") is True
    assert all(lb.get("proc") != "w1"
               for _, lb, _ in parse_exposition(fed.expose()))
    assert fed.trace("w1") is None
    # crash: snapshot retained AND flagged for forensics
    fed.mark_crashed("w2")
    series = parse_exposition(fed.expose())
    assert ("federated_proc_crashed", {"proc": "w2"}, 1.0) in series
    assert any(n == "up" and lb.get("proc") == "w2"
               for n, lb, _ in series)
    # a re-update means the process is evidently alive again
    fed.update("w2", [("up", {}, 2.0)])
    assert not fed.procs()["w2"]["crashed"]
    fed.clear()
    assert fed.expose() == "" and fed.procs() == {}


def test_federation_gauges_track_live_and_crashed():
    fed = Federation()  # private instance still drives the global gauge
    fed.update("a", [])
    fed.update("b", [])
    fed.mark_crashed("b")
    sample = metrics.REGISTRY.sample()["federated_procs"][1]
    assert sample[(("state", "live"),)] == 1.0
    assert sample[(("state", "crashed"),)] == 1.0
    fed.clear()


# --- parity with the JAX package ------------------------------------------


def _fill(mod, seed: int):
    rng = random.Random(seed)
    reg = mod.Registry()
    c = reg.counter("c_total", "c")
    g = reg.gauge("g", "g")
    h = reg.histogram("h_seconds", "h", buckets=(0.01, 0.1, 1.0,
                                                 float("inf")))
    for _ in range(60):
        label = rng.choice(['plain', 'q"uote', 'back\\slash', 'new\nline'])
        c.inc(rng.randint(1, 5), peer=label, kind=rng.choice("ab"))
        g.set(rng.random(), peer=label)
        h.observe(rng.expovariate(5.0), lane=rng.choice(["x", "y"]))
    return reg


@pytest.mark.parametrize("seed", range(3))
def test_federated_exposition_equals_the_jax_package(seed):
    reg, jreg = _fill(metrics, seed), _fill(jmetrics, seed)
    assert parse_exposition(reg.expose()) == \
        jfederate.parse_exposition(jreg.expose())
    assert parse_exposition(jreg.expose()) == \
        jfederate.parse_exposition(reg.expose())
    assert flatten_samples(reg.sample()) == \
        jfederate.flatten_samples(jreg.sample())
    fed, jfed = Federation(), jfederate.Federation()
    for f, r, mod in ((fed, reg, None), (jfed, jreg, None)):
        f.parse_and_update("replica-r0", r.expose())
        f.update_from_samples("replica-r1", r.sample())
        f.update("w", [("up", {"x": "1"}, 1.0)])
        f.mark_crashed("w")
    assert fed.expose() == jfed.expose()
    assert fed.procs() == jfed.procs()
    assert fed.series("replica-r1") == jfed.series("replica-r1")
    fed.drop("replica-r0")
    jfed.drop("replica-r0")
    assert fed.expose() == jfed.expose()
