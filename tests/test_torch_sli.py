"""The port's windowed SLIs (``spacemesh_tpu_torch/obs/sli.py``) and its
registry's sample/collector hooks, held to the JAX package's.

Twins of ``tests/test_sli_quantiles.py`` on the port, plus parity: the
same seeded observations through both packages' registries and samplers
give equal quantiles and equal values for every spec of the verifyd,
failover and fleet SLI sets.
"""

import math
import random

import pytest

from spacemesh_tpu.obs import sli as jsli
from spacemesh_tpu.utils import metrics as jmetrics
from spacemesh_tpu_torch.obs import sli
from spacemesh_tpu_torch.utils import metrics as metrics_mod


def _hist_counts(bounds, samples):
    """Cumulative le-bucket counts the way utils.metrics.Histogram
    records them."""
    counts = [0] * len(bounds)
    for v in samples:
        for i, b in enumerate(bounds):
            if v <= b:
                counts[i] += 1
    return counts


def _exact_quantile(samples, q):
    s = sorted(samples)
    return s[min(int(q * len(s)), len(s) - 1)]


# --- quantile_from_buckets ---------------------------------------------


def test_quantile_uniform_distribution():
    """Uniform samples: interpolation error is bounded by one bucket
    width around the exact quantile."""
    bounds = (0.1, 0.2, 0.4, 0.6, 0.8, 1.0, float("inf"))
    samples = [i / 1000 for i in range(1, 1001)]  # uniform (0, 1]
    counts = _hist_counts(bounds, samples)
    for q in (0.5, 0.95, 0.99):
        est = sli.quantile_from_buckets(bounds, counts, q)
        exact = _exact_quantile(samples, q)
        # the estimate lives in the same bucket as the exact quantile
        lo = max([0.0] + [b for b in bounds if b < exact])
        hi = min(b for b in bounds if b >= exact)
        assert lo <= est <= hi, (q, est, exact)
        # uniform-in-bucket assumption holds exactly for uniform data
        assert est == pytest.approx(exact, abs=0.02), (q, est, exact)


def test_quantile_exponential_distribution():
    """A skewed (exponential-ish) distribution: the estimator must stay
    within the bucket that holds the exact quantile."""
    # deterministic exponential via inverse CDF over a lattice
    samples = [-math.log(1 - (i + 0.5) / 4096) / 3.0 for i in range(4096)]
    bounds = (0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, float("inf"))
    counts = _hist_counts(bounds, samples)
    for q in (0.5, 0.95, 0.99):
        est = sli.quantile_from_buckets(bounds, counts, q)
        exact = _exact_quantile(samples, q)
        lo = max([0.0] + [b for b in bounds if b < exact])
        hi = min(b for b in bounds if b >= exact)
        assert lo <= est <= hi, (q, est, exact)


def test_quantile_empty_and_degenerate():
    bounds = (1.0, 2.0, float("inf"))
    assert sli.quantile_from_buckets(bounds, [0, 0, 0], 0.99) is None
    assert sli.quantile_from_buckets(bounds, [], 0.5) is None
    # everything in the +Inf bucket clamps to the top finite bound
    assert sli.quantile_from_buckets(bounds, [0, 0, 7], 0.99) == 2.0
    # single observation interpolates inside its bucket
    est = sli.quantile_from_buckets(bounds, [1, 1, 1], 0.5)
    assert 0.0 <= est <= 1.0
    with pytest.raises(ValueError):
        sli.quantile_from_buckets(bounds, [1, 1, 1], 1.5)


# --- the sampler over a real registry ----------------------------------


def _mk():
    reg = metrics_mod.Registry()
    h = reg.histogram("lat", buckets=(0.01, 0.1, 1.0, float("inf")))
    c = reg.counter("work_total")
    g = reg.gauge("lag")
    return reg, h, c, g


def test_windowed_quantile_uses_deltas_not_cumulative():
    """Old observations outside the window must not pollute the
    quantile: the second window sees ONLY its own (slow) samples."""
    reg, h, c, g = _mk()
    s = sli.SliSampler(reg, window_s=10.0)
    for _ in range(100):
        h.observe(0.005)         # fast era
    s.sample(0.0)
    for _ in range(10):
        h.observe(0.5)           # slow era, inside the window
    s.sample(8.0)
    spec = sli.SliSpec("lat_p99", "lat", "quantile", q=0.99)
    est = s.compute(spec)
    # cumulative data would put p99 at ~0.005-0.1; the window delta
    # contains only the ten 0.5s observations
    assert 0.1 < est <= 1.0
    # and p50 of the window is in the same slow bucket
    assert s.compute(sli.SliSpec("p50", "lat", "quantile", q=0.5)) > 0.1


def test_empty_window_is_none_not_zero():
    reg, h, c, g = _mk()
    s = sli.SliSampler(reg, window_s=10.0)
    spec = sli.SliSpec("lat_p99", "lat", "quantile", q=0.99)
    assert s.compute(spec) is None          # no snapshots at all
    s.sample(0.0)
    assert s.compute(spec) is None          # single snapshot: no window
    s.sample(5.0)
    assert s.compute(spec) is None          # two snapshots, no samples
    rate = sli.SliSpec("work_rate", "work_total", "rate")
    assert s.compute(rate) == 0.0           # counter exists at zero
    missing = sli.SliSpec("nope", "does_not_exist", "rate")
    assert s.compute(missing) is None


def test_counter_reset_truncates_window():
    """A process restart re-registers counters from zero; the delta must
    become 'since the reset', never negative."""
    reg, h, c, g = _mk()
    s = sli.SliSampler(reg, window_s=60.0)
    c.inc(1000.0)
    s.sample(0.0)
    # simulate restart: fresh registry state under the same sampler
    reg2, h2, c2, g2 = _mk()
    s.registry = reg2
    c2.inc(30.0)
    s.sample(10.0)
    rate = s.compute(sli.SliSpec("work_rate", "work_total", "rate"))
    assert rate == pytest.approx(3.0)       # 30/10, not (30-1000)/10
    # histogram reset: bucket deltas go negative -> use the new counts
    h.observe(0.5)
    h2.observe(0.05)
    s.sample(20.0)
    est = s.compute(sli.SliSpec("p", "lat", "quantile", q=0.5))
    assert est is not None and est <= 0.1


def test_rate_and_gauge_kinds():
    reg, h, c, g = _mk()
    s = sli.SliSampler(reg, window_s=30.0)
    s.sample(0.0)
    c.inc(120.0)
    g.set(0.25)
    s.sample(10.0)
    assert s.compute(
        sli.SliSpec("r", "work_total", "rate")) == pytest.approx(12.0)
    assert s.compute(sli.SliSpec("g", "lag", "gauge")) == 0.25


def test_window_edge_prefers_full_window():
    """With snapshots straddling the window edge, the delta spans a full
    window (latest snapshot at/beyond the edge), not the whole history."""
    reg, h, c, g = _mk()
    s = sli.SliSampler(reg, window_s=10.0)
    c.inc(1000.0)
    s.sample(0.0)       # ancient
    c.inc(10.0)
    s.sample(90.0)      # exactly at the edge of the window ending at 100
    c.inc(10.0)
    s.sample(100.0)
    rate = s.compute(sli.SliSpec("r", "work_total", "rate"))
    assert rate == pytest.approx(1.0)       # 10/10s, not 1020/100s


def test_labelset_filter_and_aggregate():
    reg = metrics_mod.Registry()
    h = reg.histogram("d", buckets=(0.01, 1.0, float("inf")))
    s = sli.SliSampler(reg, window_s=30.0)
    s.sample(0.0)
    h.observe(0.005, kind="sig")
    h.observe(0.5, kind="post")
    s.sample(10.0)
    sig = s.compute(sli.SliSpec("sig", "d", "quantile", q=0.5,
                                labels=(("kind", "sig"),)))
    post = s.compute(sli.SliSpec("post", "d", "quantile", q=0.5,
                                 labels=(("kind", "post"),)))
    agg = s.compute(sli.SliSpec("agg", "d", "quantile", q=0.99))
    assert sig <= 0.01 < post
    assert agg > 0.01                        # aggregate sees both
    none = s.compute(sli.SliSpec("vrf", "d", "quantile", q=0.5,
                                 labels=(("kind", "vrf"),)))
    assert none is None


# --- registry plumbing (satellites) ------------------------------------


def test_histogram_bucket_mismatch_raises():
    reg = metrics_mod.Registry()
    reg.histogram("x", buckets=(1.0, float("inf")))
    with pytest.raises(ValueError, match="buckets"):
        reg.histogram("x", buckets=(2.0, float("inf")))
    # same buckets or unspecified buckets still return the instrument
    assert reg.histogram("x", buckets=(1.0, float("inf"))) is \
        reg.histogram("x")


def test_collector_hook_runs_at_scrape_and_sample():
    reg = metrics_mod.Registry()
    g = reg.gauge("depth")
    state = {"v": 0.0, "calls": 0}

    def collect():
        state["calls"] += 1
        g.set(state["v"])

    reg.add_collector(collect)
    state["v"] = 7.0
    assert "depth 7.0" in reg.expose()
    state["v"] = 3.0
    snap = reg.sample()
    assert snap["depth"] == ("gauge", {(): 3.0})
    assert state["calls"] == 2

    def broken():
        raise RuntimeError("bad hook")

    reg.add_collector(broken)
    reg.expose()                              # one bad hook != dead scrape


def test_runtime_collectors_populate_gauges():
    reg = metrics_mod.Registry()
    rss = reg.gauge("process_resident_memory_bytes")
    fds = reg.gauge("process_open_fds")
    # the module gauges live on the global registry; re-point the
    # collectors at private ones via monkey-free direct calls
    sli._collect_rss()
    sli._collect_fds()
    assert metrics_mod.process_rss_bytes.sample().get((), 0) > 1 << 20
    assert metrics_mod.process_open_fds.sample().get((), 0) > 0
    del rss, fds


# --- parity with the JAX package ------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_quantile_from_buckets_equals_the_jax_package(seed):
    rng = random.Random(seed)
    bounds = (0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0, float("inf"))
    for _ in range(200):
        samples = [rng.expovariate(rng.choice([1.0, 10.0, 100.0]))
                   for _ in range(rng.randint(0, 50))]
        counts = _hist_counts(bounds, samples)
        for q in (0.0, 0.5, 0.95, 0.99, 1.0):
            assert sli.quantile_from_buckets(bounds, counts, q) == \
                jsli.quantile_from_buckets(bounds, counts, q)


def _drive(mod_metrics, mod_sli, seed: int) -> list:
    """Seeded observations into a private registry of one package, the
    fleet/failover/verifyd instruments by their real names, sampled on
    an injected clock; every spec's value after each window."""
    rng = random.Random(seed)
    reg = mod_metrics.Registry()
    buckets = (0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0, float("inf"))
    hists = {n: reg.histogram(n, buckets=buckets) for n in (
        "fleet_verify_seconds", "fleet_replica_verify_seconds",
        "failover_verify_seconds", "verifyd_request_seconds")}
    ctrs = {n: reg.counter(n) for n in (
        "fleet_requests_total", "fleet_replica_sheds_total",
        "failover_requests_total", "verifyd_items_total",
        "verifyd_shed_total")}
    gauges = {n: reg.gauge(n) for n in (
        "fleet_desired_replicas", "verifyd_pending_items",
        "verifyd_client_pending_items")}
    replicas = ["r0", "r1", "r2"]
    specs = (mod_sli.fleet_slis(replicas) + mod_sli.failover_slis()
             + mod_sli.verifyd_slis()
             + mod_sli.verifyd_client_slis(["a", "b"]))
    sampler = mod_sli.SliSampler(reg, window_s=30.0)
    out = []
    t = 0.0
    for _ in range(12):
        for _ in range(40):
            lane = rng.choice(["block", "gossip", "sync"])
            path = rng.choice(["remote", "local", "local_fastfail"])
            rep = rng.choice(replicas)
            v = rng.expovariate(20.0)
            hists["fleet_verify_seconds"].observe(v, path=path, lane=lane)
            hists["fleet_replica_verify_seconds"].observe(
                v, replica=rep, lane=lane)
            hists["failover_verify_seconds"].observe(v, path=path,
                                                     lane=lane)
            hists["verifyd_request_seconds"].observe(v, lane=lane)
            ctrs["fleet_requests_total"].inc(path=path, lane=lane)
            ctrs["failover_requests_total"].inc(path=path, lane=lane)
            if rng.random() < 0.2:
                ctrs["fleet_replica_sheds_total"].inc(replica=rep,
                                                      reason="overload")
            cid = rng.choice(["a", "b"])
            ctrs["verifyd_items_total"].inc(rng.randint(1, 9), client=cid,
                                            kind="sig")
            if rng.random() < 0.1:
                ctrs["verifyd_shed_total"].inc(client=cid, reason="rate")
        gauges["fleet_desired_replicas"].set(rng.randint(1, 6))
        gauges["verifyd_pending_items"].set(rng.randint(0, 99))
        gauges["verifyd_client_pending_items"].set(rng.randint(0, 9),
                                                   client="a")
        t += rng.choice([2.0, 5.0, 11.0])
        sampler.sample(t)
        out.append(sampler.values(specs))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_sli_values_equal_the_jax_package(seed):
    got = _drive(metrics_mod, sli, seed)
    assert got == _drive(jmetrics, jsli, seed)
    assert any(v is not None for step in got for v in step.values())
