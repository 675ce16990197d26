"""The port's operational shell against the JAX package's, on the CPU.

``spacemesh_tpu_torch/node/bootstrap.py``'s ``BootstrapUpdater`` (epoch
fallback beacons and active sets from an operator's source) and
``Pruner`` (retention cleanup) take the same inputs as
``spacemesh_tpu/node/bootstrap.py``'s: the documents each applies, the
callbacks it makes, the cache it writes, the rows it deletes and the
rows it keeps must be equal.
"""

import json

import pytest

from spacemesh_tpu.core.types import Certificate as JCertificate
from spacemesh_tpu.node import bootstrap as jboot
from spacemesh_tpu.storage import db as jdb
from spacemesh_tpu.storage import misc as jmisc
from spacemesh_tpu_torch.core.types import Certificate
from spacemesh_tpu_torch.node import bootstrap as tboot
from spacemesh_tpu_torch.storage import db as tdb
from spacemesh_tpu_torch.storage import misc as tmisc

PKGS = {"jax": (jboot, jdb, jmisc, JCertificate),
        "port": (tboot, tdb, tmisc, Certificate)}


def _poll(boot, src, cache):
    """Two polls of one updater over ``src``: (applied counts, beacon
    callbacks, active-set callbacks, cache files with their documents)."""
    beacons, sets_ = [], []
    upd = boot.BootstrapUpdater(
        str(src), on_beacon=lambda e, b: beacons.append((e, b)),
        on_activeset=lambda e, ids: sets_.append((e, ids)),
        cache_dir=cache)
    counts = (upd.poll_once(), upd.poll_once())
    files = {p.name: json.loads(p.read_text())
             for p in sorted(cache.glob("*.json"))} if cache.exists() else {}
    return counts, beacons, sets_, files


def test_bootstrap_applies_beacon_and_activeset(tmp_path):
    src = tmp_path / "fallback.json"
    src.write_text(json.dumps([
        {"epoch": 5, "beacon": "aabbccdd", "activeset": ["11" * 32]},
        {"epoch": 6, "beacon": "deadbeef"},
    ]))
    out = {name: _poll(mods[0], src, tmp_path / f"cache-{name}")
           for name, mods in PKGS.items()}
    assert out["port"] == out["jax"]
    counts, beacons, sets_, files = out["port"]
    assert counts == (2, 0)  # idempotent: the same docs are not re-applied
    assert beacons == [(5, bytes.fromhex("aabbccdd")),
                       (6, bytes.fromhex("deadbeef"))]
    assert sets_ == [(5, [b"\x11" * 32])]
    assert sorted(files) == ["epoch-5.json", "epoch-6.json"]


@pytest.mark.parametrize("doc", [
    [{"epoch": 7, "beacon": "toolongbeacon00"},   # not hex
     {"no_epoch": True},
     {"epoch": 8, "activeset": ["ff"]}],          # a short id
    {"epoch": 9, "beacon": "aabbcc"},             # a 3-byte beacon
    "not json at all",
], ids=["malformed-list", "short-beacon", "unparseable"])
def test_bootstrap_rejects_malformed(tmp_path, doc):
    src = tmp_path / "bad.json"
    src.write_text(doc if isinstance(doc, str) else json.dumps(doc))
    out = {name: _poll(mods[0], src, tmp_path / f"cache-{name}")
           for name, mods in PKGS.items()}
    assert out["port"] == out["jax"] == ((0, 0), [], [], {})


def _rows(d):
    return {t: [tuple(r) for r in d.all(f"SELECT * FROM {t} ORDER BY 1")]
            for t in ("certificates", "active_sets", "poet_proofs")}


def test_prune_removes_stale_rows():
    out = {}
    for name, (boot, dbmod, misc, Cert) in PKGS.items():
        d = dbmod.open_state(":memory:")
        for layer in (1, 2, 29, 30, 50):
            misc.add_certificate(
                d, layer, Cert(block_id=bytes([layer]) * 32, signatures=[]))
        for i, epoch in enumerate((0, 8, 9)):
            misc.add_active_set(d, bytes([65 + i]) * 32, epoch,
                                [b"a" * 32])
        for ref, rnd in ((b"r", "0"), (b"s", "8"), (b"q", "9"),
                         (b"x", "label")):
            d.exec("INSERT INTO poet_proofs (ref, poet_id, round_id, ticks,"
                   " data) VALUES (?,?,?,?,?)",
                   (ref * 32, b"p" * 32, rnd, 1, b"x"))
        pruner = boot.Pruner(d, retention_layers=10,
                             current_layer=lambda: 40, layers_per_epoch=3,
                             interval=0.1)
        first = pruner.prune_once()
        out[name] = (first, pruner.prune_once(), _rows(d),
                     misc.certificate(d, 50) is not None,
                     misc.active_set(d, b"C" * 32))
        d.close()
    assert out["port"] == out["jax"]
    first, second, rows, kept_cert, kept_set = out["port"]
    # horizon layer 30, epoch horizon 30 // 3 - 1 = 9
    assert first == {"certificates": 3, "active_sets": 2, "poet_proofs": 2}
    assert second == {"certificates": 0, "active_sets": 0, "poet_proofs": 0}
    assert [r[0] for r in rows["certificates"]] == [30, 50]
    assert kept_cert and kept_set == [b"a" * 32]
    assert sorted(r[2] for r in rows["poet_proofs"]) == ["9", "label"]
