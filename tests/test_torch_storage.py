"""The port's storage layer (``spacemesh_tpu_torch/storage/``) against the
JAX package's.

The cases of ``tests/test_storage.py`` run against the port's modules;
then the two packages share files: a state database written by either
opens in the other with the same schema, ``user_version`` and rows, and a
pre-0004 database migrates to the same rows in both. The cases of
``tests/test_reward_migration.py`` (migrations 0004 and 0005: re-encoded
legacy blocks, the recomputed aggregated-hash chain, the boundary fence, a
no-op on a consistent chain, no boundary on a fresh database) build the
same old database with each package and migrate it: equal files, equal
rows read back. Exact equality.
"""

import io
import sqlite3
import threading
import time
import types as pytypes

import numpy as np
import pytest

from spacemesh_tpu.core import codec as jcodec
from spacemesh_tpu.core import types as jtypes
from spacemesh_tpu.core.hashing import sum256 as jsum256
from spacemesh_tpu.storage import atxs as jatxs
from spacemesh_tpu.storage import ballots as jballots
from spacemesh_tpu.storage import blocks as jblocks
from spacemesh_tpu.storage import db as jdb
from spacemesh_tpu.storage import layers as jlayers
from spacemesh_tpu.storage import misc as jmisc
from spacemesh_tpu.storage import transactions as jtxs
from spacemesh_tpu.utils import metrics as jmetrics
from spacemesh_tpu_torch.core import types
from spacemesh_tpu_torch.core.hashing import sum256
from spacemesh_tpu_torch.storage import (atxs, ballots, blocks, cache, db,
                                         layers, misc, transactions)
from spacemesh_tpu_torch.utils import metrics as tmetrics


@pytest.fixture
def state():
    return db.open_state()


def _atx(epoch=1, node=b"\x01" * 32, units=4, t=types):
    return t.ActivationTx(
        publish_epoch=epoch, prev_atx=bytes(32), pos_atx=bytes(32),
        commitment_atx=None, initial_post=None,
        nipost=t.NIPost(
            membership=t.MerkleProof(leaf_index=0, nodes=[]),
            post=t.Post(nonce=0, indices=[1], pow_nonce=0),
            post_metadata=t.PostMetadataWire(challenge=bytes(32),
                                             labels_per_unit=64)),
        num_units=units, vrf_nonce=7, vrf_public_key=bytes(32),
        coinbase=bytes(24), node_id=node,
        signature=bytes(64))


# --- the cases of tests/test_storage.py, on the port ----------------------


def test_atx_roundtrip(state):
    a = _atx()
    atxs.add(state, a, tick_height=100)
    assert atxs.has(state, a.id)
    assert atxs.get(state, a.id) == a
    assert atxs.tick_height(state, a.id) == 100
    view = atxs.by_node_in_epoch(state, a.node_id, 1)
    assert view.id == a.id and view.prev_atx == a.prev_atx
    assert view.num_units == a.num_units and view.version == 1
    assert atxs.ids_in_epoch(state, 1) == [a.id]
    assert atxs.count_in_epoch(state, 1) == 1
    assert atxs.count_in_epoch(state, 2) == 0
    b = _atx(epoch=2)
    atxs.add(state, b)
    assert atxs.latest_by_node(state, a.node_id).publish_epoch == 2


def test_migration_version_check(tmp_path):
    path = tmp_path / "s.db"
    db.open_state(path).close()
    conn = sqlite3.connect(path)
    conn.execute("PRAGMA user_version=99")
    conn.close()
    with pytest.raises(RuntimeError, match="newer"):
        db.open_state(path)


def test_tx_rollback(state):
    a = _atx()
    with pytest.raises(RuntimeError):
        with state.tx():
            atxs.add(state, a)
            raise RuntimeError("boom")
    assert not atxs.has(state, a.id)


def test_layers_and_blocks(state):
    blk = types.Block(layer=3, tick_height=0, rewards=[], tx_ids=[])
    blocks.add(state, blk)
    assert blocks.get(state, blk.id) == blk
    assert blocks.validity(state, blk.id) == blocks.UNDECIDED
    blocks.set_valid(state, blk.id)
    assert blocks.contextually_valid(state, 3) == [blk.id]
    blocks.set_invalid(state, blk.id)
    assert blocks.contextually_valid(state, 3) == []

    assert layers.processed(state) == -1
    layers.set_processed(state, 0)
    layers.set_processed(state, 1)
    assert layers.processed(state) == 1
    layers.set_applied(state, 1, blk.id, b"\x09" * 32)
    assert layers.applied_block(state, 1) == blk.id
    assert layers.state_hash(state, 1) == b"\x09" * 32
    assert layers.last_applied(state) == 1


def _opinion(t=types):
    return t.Opinion(base=bytes(32), support=[], against=[], abstain=[])


def test_ballots_refballot(state):
    ed = types.EpochData(beacon=b"\x01\x02\x03\x04",
                         active_set_root=bytes(32), eligibility_count=3)
    b1 = types.Ballot(layer=8, atx_id=bytes(32), epoch_data=ed,
                      ref_ballot=bytes(32), eligibilities=[],
                      opinion=_opinion(), node_id=b"\x05" * 32,
                      signature=bytes(64))
    b2 = types.Ballot(layer=9, atx_id=bytes(32), epoch_data=None,
                      ref_ballot=b1.id, eligibilities=[],
                      opinion=_opinion(), node_id=b"\x05" * 32,
                      signature=bytes(64))
    ballots.add(state, b1)
    ballots.add(state, b2)
    assert ballots.refballot(state, b"\x05" * 32, 8, 12) == b1
    assert {b.id for b in ballots.in_layer(state, 9)} == {b2.id}
    assert ballots.resolve_epoch_data(state, b2, 4) == ed
    assert ballots.refballot_by_atx(state, bytes(32), 8, 12) == b1


def test_misc_entities(state):
    misc.set_beacon(state, 2, b"\xaa\xbb\xcc\xdd")
    assert misc.get_beacon(state, 2) == b"\xaa\xbb\xcc\xdd"
    assert misc.get_beacon(state, 3) is None

    proof = types.MalfeasanceProof(domain=1, msg1=b"a", sig1=bytes(64),
                                   msg2=b"b", sig2=bytes(64),
                                   node_id=b"\x07" * 32)
    misc.set_malicious(state, b"\x07" * 32, proof)
    assert misc.is_malicious(state, b"\x07" * 32)
    assert misc.malfeasance_proof(state, b"\x07" * 32) == proof
    assert misc.all_malicious(state) == [b"\x07" * 32]

    pp = types.PoetProof(poet_id=bytes(32), round_id="5", root=b"\x01" * 32,
                         ticks=777)
    misc.add_poet_proof(state, pp)
    assert misc.poet_proof(state, pp.id) == pp
    assert misc.poet_proof_for_round(state, bytes(32), "5") == pp

    misc.add_active_set(state, b"\x0a" * 32, 2, [b"\x01" * 32, b"\x02" * 32])
    assert misc.active_set(state, b"\x0a" * 32) == [b"\x01" * 32, b"\x02" * 32]

    cert = types.Certificate(block_id=b"\x03" * 32, signatures=[])
    misc.add_certificate(state, 4, cert)
    assert misc.certificate(state, 4) == cert
    assert misc.certified_block(state, 4) == b"\x03" * 32


def test_transactions_accounts(state):
    tx = types.Transaction(raw=b"\x01\x02\x03")
    transactions.add_tx(state, tx, principal=b"\x0b" * 24, nonce=0)
    assert transactions.get_tx(state, tx.id) == tx
    assert transactions.has_tx(state, tx.id)
    assert len(transactions.pending_by_principal(state, b"\x0b" * 24)) == 1
    res = types.TransactionResult(status=0, message="", gas_consumed=100,
                                  fee=5, layer=3, block=bytes(32))
    transactions.set_result(state, tx.id, 3, bytes(32), res)
    assert transactions.result(state, tx.id) == res
    assert transactions.pending_by_principal(state, b"\x0b" * 24) == []

    transactions.update_account(state, b"\x0c" * 24, 1, 100, 0)
    transactions.update_account(state, b"\x0c" * 24, 5, 80, 1)
    assert transactions.account(state, b"\x0c" * 24)["balance"] == 80
    assert transactions.account(state, b"\x0c" * 24,
                                at_layer=3)["balance"] == 100
    transactions.revert_accounts_above(state, 3)
    assert transactions.account(state, b"\x0c" * 24)["balance"] == 100


def test_atx_cache():
    c = cache.AtxCache()
    c.add(2, b"\x01" * 32, cache.AtxInfo(node_id=b"\xaa" * 32, weight=40,
                                         base_height=0, height=10,
                                         num_units=4, vrf_nonce=1))
    c.add(2, b"\x02" * 32, cache.AtxInfo(node_id=b"\xbb" * 32, weight=60,
                                         base_height=0, height=12,
                                         num_units=6, vrf_nonce=2))
    assert c.epoch_weight(2) == 100
    assert c.epoch_count(2) == 2
    assert c.weight_for_set(2, [b"\x01" * 32]) == 40
    c.set_malicious(b"\xaa" * 32)
    assert c.epoch_weight(2) == 60
    assert c.is_malicious(b"\xaa" * 32)
    assert c.get(2, b"\x01" * 32).malicious
    c.evict(3)
    assert c.get(2, b"\x01" * 32) is None


def test_local_db():
    local = db.open_local()
    local.exec("INSERT INTO nipost_state (node_id, phase) VALUES (?,?)",
               (b"\x01" * 32, 1))
    assert local.one("SELECT phase FROM nipost_state WHERE node_id=?",
                     (b"\x01" * 32,))["phase"] == 1


def test_reader_pool_does_not_serialize_behind_writer(tmp_path):
    d = db.open_state(tmp_path / "pool.db", read_pool=2)
    d.exec("INSERT INTO layers (id, processed) VALUES (1, 1)")

    in_tx = threading.Event()
    release = threading.Event()

    def long_writer():
        with d.tx():
            d.exec("INSERT INTO layers (id, processed) VALUES (2, 1)")
            in_tx.set()
            release.wait(timeout=30)

    t = threading.Thread(target=long_writer)
    t.start()
    assert in_tx.wait(timeout=10)
    start = time.perf_counter()
    rows = d.all("SELECT id FROM layers ORDER BY id")
    elapsed = time.perf_counter() - start
    assert [r["id"] for r in rows] == [1]
    assert elapsed < 5.0, "read serialized behind the open write tx"
    release.set()
    t.join(timeout=30)
    assert not t.is_alive()
    assert [r["id"] for r in d.all("SELECT id FROM layers ORDER BY id")] \
        == [1, 2]
    d.close()
    with pytest.raises(sqlite3.ProgrammingError, match="closed"):
        d.all("SELECT id FROM layers")


def test_tx_reads_its_own_uncommitted_writes(tmp_path):
    d = db.open_state(tmp_path / "ryw.db", read_pool=2)
    with d.tx():
        d.exec("INSERT INTO layers (id, processed) VALUES (7, 1)")
        assert d.one("SELECT processed FROM layers WHERE id=7")[
            "processed"] == 1
        assert len(d.all("SELECT id FROM layers")) == 1
    d.close()


def test_maybe_vacuum_reclaims_after_bulk_delete(tmp_path):
    d = db.open_state(tmp_path / "vac.db")
    with d.tx():
        for i in range(2000):
            d.exec("INSERT INTO layers (id, processed) VALUES (?, 1)",
                   (i + 10,))
    before = d.one("PRAGMA page_count")[0]
    d.exec("DELETE FROM layers")
    assert d.maybe_vacuum(min_free_fraction=0.2) is True
    assert d.one("PRAGMA page_count")[0] < before
    assert d.maybe_vacuum(min_free_fraction=0.2) is False
    d.close()


def test_query_latency_metrics_recorded():
    d = db.open_state()
    d.all("SELECT id FROM layers")
    text = tmetrics.REGISTRY.expose()
    assert "sql_state_query_seconds" in text
    assert "sql_state_queries" in text
    d.close()


# --- the two packages on one file -----------------------------------------


def _dump(path) -> dict:
    """Every table's rows (sorted) plus the schema and pragmas."""
    conn = sqlite3.connect(path)
    try:
        out = {"user_version": conn.execute(
                   "PRAGMA user_version").fetchone()[0],
               "auto_vacuum": conn.execute(
                   "PRAGMA auto_vacuum").fetchone()[0],
               "journal_mode": conn.execute(
                   "PRAGMA journal_mode").fetchone()[0],
               "schema": sorted(conn.execute(
                   "SELECT type, name, sql FROM sqlite_master").fetchall(),
                   key=repr)}
        for (name,) in conn.execute(
                "SELECT name FROM sqlite_master WHERE type='table'"):
            out[name] = sorted(conn.execute(f"SELECT * FROM {name}")
                               .fetchall(), key=repr)
        return out
    finally:
        conn.close()


def _fill(pkg, d, rng, t):
    """Rows of every kind the packages' query modules write, from ``rng``."""
    am, bm, blm, lm, mm, xm = pkg
    for i in range(4):
        node = rng.bytes(32)
        a = _atx(epoch=i, node=node, units=int(rng.integers(1, 9)), t=t)
        am.add(d, a, tick_height=int(rng.integers(1 << 20)),
               received=int(rng.integers(1 << 30)))
    subposts = [t.SubPostV2(node_id=rng.bytes(32), prev_atx=bytes(32),
                            num_units=2, vrf_nonce=int(rng.integers(99)),
                            nipost=_atx(t=t).nipost) for _ in range(2)]
    atx2 = t.ActivationTxV2(publish_epoch=5, pos_atx=bytes(32),
                            coinbase=rng.bytes(24), marriages=[],
                            subposts=subposts, node_id=subposts[0].node_id,
                            signature=rng.bytes(64))
    am.add_v2(d, atx2, tick_heights={subposts[0].node_id: 77}, received=3)
    blk = t.Block(layer=int(rng.integers(100)), tick_height=5,
                  rewards=[t.Reward(atx_id=rng.bytes(32),
                                    coinbase=rng.bytes(24), weight=9)],
                  tx_ids=[rng.bytes(32)])
    blm.add(d, blk)
    blm.set_valid(d, blk.id)
    lm.set_processed(d, blk.layer)
    lm.set_applied(d, blk.layer, blk.id, rng.bytes(32))
    lm.set_aggregated_hash(d, blk.layer, rng.bytes(32))
    bm.add(d, t.Ballot(layer=blk.layer, atx_id=rng.bytes(32),
                       epoch_data=None, ref_ballot=bytes(32),
                       eligibilities=[], opinion=_opinion(t),
                       node_id=rng.bytes(32), signature=rng.bytes(64)))
    mm.set_beacon(d, 3, rng.bytes(4))
    node = rng.bytes(32)
    mm.set_malicious(d, node, t.MalfeasanceProof(
        domain=1, msg1=rng.bytes(9), sig1=rng.bytes(64), msg2=rng.bytes(7),
        sig2=rng.bytes(64), node_id=node), received=11)
    mm.set_marriage(d, node, rng.bytes(32))
    mm.add_poet_proof(d, t.PoetProof(poet_id=rng.bytes(32), round_id="4",
                                     root=rng.bytes(32), ticks=12))
    mm.add_active_set(d, rng.bytes(32), 2, [rng.bytes(32), rng.bytes(32)])
    mm.add_reward(d, rng.bytes(24), 4, 100, 90)
    xm.add_tx(d, t.Transaction(raw=rng.bytes(20)), principal=rng.bytes(24),
              nonce=1)
    xm.update_account(d, rng.bytes(24), 2, 500, 3)
    return atx2


JAX_PKG = (jatxs, jballots, jblocks, jlayers, jmisc, jtxs)
PORT_PKG = (atxs, ballots, blocks, layers, misc, transactions)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_state_db_crosses_between_packages(tmp_path, writer):
    """A file state database written by one package opens in the other:
    equal schema, user_version, pragmas and rows; the reader's queries
    give byte-identical objects; rows the reader adds read back in the
    writer's package."""
    path = tmp_path / "state.sql"
    pkgs = {"jax": (jdb, JAX_PKG, jtypes), "port": (db, PORT_PKG, types)}
    reader = "port" if writer == "jax" else "jax"
    wdb, wpkg, wt = pkgs[writer]
    rdb, rpkg, rt = pkgs[reader]

    d = wdb.open_state(path)
    atx2 = _fill(wpkg, d, np.random.default_rng(5), wt)
    d.close()
    before = _dump(path)

    d = rdb.open_state(path, read_pool=2)
    assert _dump(path) == before  # opening migrates nothing
    am = rpkg[0]
    for epoch in range(4):
        views = am.all_in_epoch(d, epoch)
        assert len(views) == 1
        assert am.get(d, views[0].id).to_bytes() == am.get_blob(
            d, views[0].id)
    view2 = am.by_node_in_epoch(d, atx2.subposts[0].node_id, 5)
    assert view2.version == 2 and view2.id == atx2.identity_atx_id(
        atx2.subposts[0].node_id)
    assert am.tick_height(d, view2.id) == 77
    assert rt.ActivationTxV2.from_bytes(am.get_blob(d, view2.id)) \
        .to_bytes() == atx2.to_bytes()
    mal = rpkg[4].all_malicious(d)
    assert len(mal) == 1
    assert rpkg[4].malfeasance_proof(d, mal[0]).to_bytes() == \
        d.one("SELECT proof FROM identities WHERE node_id=?", (mal[0],))[0]
    _fill(rpkg, d, np.random.default_rng(6), rt)
    d.close()

    after = _dump(path)
    d = wdb.open_state(path)
    assert _dump(path) == after
    assert wpkg[0].count(d) == 2 * 4 + 2 * 2
    d.close()


def test_fresh_databases_share_schema_and_version(tmp_path):
    for opener in ("open_state", "open_local"):
        getattr(jdb, opener)(tmp_path / f"j-{opener}.db").close()
        getattr(db, opener)(tmp_path / f"t-{opener}.db").close()
        assert _dump(tmp_path / f"t-{opener}.db") == \
            _dump(tmp_path / f"j-{opener}.db")
    assert len(db.STATE_MIGRATIONS) == len(jdb.STATE_MIGRATIONS) == 5
    assert db.STATE_MIGRATIONS[:3] == jdb.STATE_MIGRATIONS[:3]
    assert db.LOCAL_MIGRATIONS == jdb.LOCAL_MIGRATIONS


def _legacy_block_bytes(layer, tick, rewards, tx_ids):
    w = io.BytesIO()
    jtypes.u32.enc(w, layer)
    jtypes.u64.enc(w, tick)
    jcodec.vec(jcodec.Codec(
        enc=lambda w_, v: (jtypes.ADDRESS.enc(w_, v[0]),
                           jtypes.u64.enc(w_, v[1])),
        dec=None), 1 << 12).enc(w, rewards)
    jcodec.vec(jtypes.HASH32, 1 << 16).enc(w, tx_ids)
    return w.getvalue()


def test_legacy_database_migrates_to_the_same_rows(tmp_path):
    """A pre-0004 database (legacy block blobs, a chain over their ids, a
    certificate) migrated by each package: identical files' rows."""
    dumps = {}
    for name, mod in (("jax", jdb), ("port", db)):
        path = tmp_path / f"{name}.db"
        old = jdb.Database(path, jdb.STATE_MIGRATIONS[:3], name="state")
        agg = bytes(32)
        for layer in (1, 2, 3):
            data = _legacy_block_bytes(layer, layer, [(b"\x01" * 24, layer)],
                                       [jsum256(b"tx", bytes([layer]))])
            bid = jsum256(data)
            agg = jsum256(agg, bid)
            old.exec("INSERT INTO blocks (id, layer, data) VALUES (?,?,?)",
                     (bid, layer, data))
            old.exec("INSERT INTO layers (id, applied_block, aggregated_hash)"
                     " VALUES (?,?,?)", (layer, bid, agg))
            old.exec("INSERT INTO certificates (layer, block_id) VALUES"
                     " (?,?)", (layer, bid))
        old.close()
        mod.open_state(path).close()
        dumps[name] = _dump(path)
    assert dumps["port"] == dumps["jax"]
    assert dumps["port"]["user_version"] == 5
    assert dumps["port"]["migration_marks"] == [
        ("block_id_rewrite_boundary", 3)]


# --- twins of tests/test_reward_migration.py: migration 0005 ---------------

JAX_DB = pytypes.SimpleNamespace(db=jdb, types=jtypes, sum256=jsum256,
                                 blocks=jblocks, layers=jlayers, misc=jmisc)
PORT_DB = pytypes.SimpleNamespace(db=db, types=types, sum256=sum256,
                                  blocks=blocks, layers=layers, misc=misc)


def _legacy_layer(d, P, layer, data, agg=None, cert=True):
    """A pre-0004 layer: a legacy block blob applied, its aggregated hash
    chained on ``agg`` (genesis when None), and a certificate for it."""
    bid = P.sum256(data)
    agg = P.sum256(bytes(32) if agg is None else agg, bid)
    d.exec("INSERT INTO blocks (id, layer, data) VALUES (?,?,?)",
           (bid, layer, data))
    d.exec("INSERT INTO layers (id, applied_block, aggregated_hash)"
           " VALUES (?,?,?)", (layer, bid, agg))
    if cert:
        d.exec("INSERT INTO certificates (layer, block_id) VALUES (?,?)",
               (layer, bid))
    return bid, agg


def _view(d, P, layers_):
    """What the node reads back after the migration: each layer's blocks,
    applied block and aggregated hash, the certificates and the boundary."""
    return {"blocks": {ly: [b.to_bytes() for b in P.blocks.in_layer(d, ly)]
                       for ly in layers_},
            "applied": {ly: P.layers.applied_block(d, ly) for ly in layers_},
            "agg": {ly: P.layers.aggregated_hash(d, ly) for ly in layers_},
            "certs": [r["layer"] for r in d.all(
                "SELECT layer FROM certificates ORDER BY layer")],
            "boundary": P.misc.migration_boundary(d)}


def _migrate_both(tmp_path, build, layers_):
    """``build(path, P)`` writes an old database with package ``P``'s own
    schema; each package opens its own copy (running its migrations).
    Returns the port's view after the two dumps and views are held equal,
    and the view again after a reopen (the migration does not re-run)."""
    out = {}
    for name, P in (("jax", JAX_DB), ("port", PORT_DB)):
        path = tmp_path / f"{name}.db"
        ctx = build(path, P)
        state = P.db.open_state(path)
        view = _view(state, P, layers_)
        state.close()
        again = P.db.open_state(path)
        assert _view(again, P, layers_) == view
        again.close()
        out[name] = (_dump(path), view, ctx)
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    assert out["port"][0]["user_version"] == 5
    return out["port"][1], out["port"][2]


def test_reward_migration_reencodes_legacy_blocks(tmp_path):
    coinbase = b"\x07" * 24

    def build(path, P):
        old = P.db.Database(path, P.db.STATE_MIGRATIONS[:3], name="state")
        bid, _ = _legacy_layer(old, P, 5, _legacy_block_bytes(
            5, 9, [(coinbase, 3)], [b"\x21" * 32]))
        old.close()
        return bid

    view, old_id = _migrate_both(tmp_path, build, [5])
    (raw,) = view["blocks"][5]
    b = types.Block.from_bytes(raw)
    assert b.tick_height == 9 and b.tx_ids == [b"\x21" * 32]
    assert b.rewards == [types.Reward(atx_id=bytes(32), coinbase=coinbase,
                                      weight=3)]
    assert b.id != old_id and view["applied"][5] == b.id
    # certificates signed over the old id are dropped, not rewritten, and
    # the boundary fences pre-rewrite ballots off from recovery
    assert view["certs"] == [] and view["boundary"] == 5


def test_reward_migration_recomputes_aggregated_hash_chain(tmp_path):
    def build(path, P):
        old = P.db.Database(path, P.db.STATE_MIGRATIONS[:3], name="state")
        ids, agg = {}, None
        for layer in (1, 2, 3):
            ids[layer], agg = _legacy_layer(
                old, P, layer, _legacy_block_bytes(
                    layer, 0, [(b"\x01" * 24, layer)], []), agg, cert=False)
        old.close()
        return ids

    view, ids = _migrate_both(tmp_path, build, [1, 2, 3])
    expect = bytes(32)
    for layer in (1, 2, 3):
        new_id = view["applied"][layer]
        assert new_id != ids[layer]
        expect = sum256(expect, new_id)
        assert view["agg"][layer] == expect
    assert view["boundary"] == 3


def _version4(path, P, legacy):
    """A database the previous build migrated to version 4: the ids
    rewritten, the derived data (chain, certificates) left stale."""
    old = P.db.Database(path, P.db.STATE_MIGRATIONS[:3], name="state")
    for layer, data in legacy:
        _legacy_layer(old, P, layer, data)
    old.close()
    return P.db.Database(path, P.db.STATE_MIGRATIONS[:4], name="state")


def test_reward_migration_version4_database_gets_fixups_via_0005(tmp_path):
    data = _legacy_block_bytes(7, 1, [(b"\x09" * 24, 2)], [])

    def build(path, P):
        mid = _version4(path, P, [(7, data)])
        assert mid.one("SELECT COUNT(*) c FROM certificates")["c"] == 1
        new_id = P.layers.applied_block(mid, 7)
        assert new_id != P.sum256(data)
        assert P.layers.aggregated_hash(mid, 7) == \
            P.sum256(bytes(32), P.sum256(data))
        mid.close()
        return new_id

    view, new_id = _migrate_both(tmp_path, build, [7])
    assert view["agg"][7] == sum256(bytes(32), new_id)
    assert view["certs"] == [] and view["boundary"] == 7


def test_reward_migration_0005_fences_only_pre_rewrite_layers(tmp_path):
    data = _legacy_block_bytes(1, 0, [(b"\x01" * 24, 1)], [])

    def build(path, P):
        mid = _version4(path, P, [(1, data)])
        new1 = P.layers.applied_block(mid, 1)
        # the node kept running at version 4 and applied layer 2 with a
        # new-format block, chained on the stale stored value
        stale = P.layers.aggregated_hash(mid, 1)
        blk2 = P.types.Block(layer=2, tick_height=0, rewards=[], tx_ids=[])
        mid.exec("INSERT INTO blocks (id, layer, data) VALUES (?,?,?)",
                 (blk2.id, 2, blk2.to_bytes()))
        mid.exec("INSERT INTO layers (id, applied_block, aggregated_hash)"
                 " VALUES (?,?,?)", (2, blk2.id, P.sum256(stale, blk2.id)))
        mid.exec("INSERT INTO certificates (layer, block_id) VALUES (?,?)",
                 (2, blk2.id))
        mid.close()
        return new1, blk2.id

    view, (new1, id2) = _migrate_both(tmp_path, build, [1, 2])
    assert view["boundary"] == 1
    assert view["certs"] == [2]  # the valid post-rewrite certificate kept
    assert view["agg"][1] == sum256(bytes(32), new1)
    assert view["agg"][2] == sum256(sum256(bytes(32), new1), id2)


def test_reward_migration_0005_is_noop_on_consistent_chain(tmp_path):
    def build(path, P):
        mid = P.db.Database(path, P.db.STATE_MIGRATIONS[:4], name="state")
        blk = P.types.Block(layer=3, tick_height=0, rewards=[], tx_ids=[])
        mid.exec("INSERT INTO blocks (id, layer, data) VALUES (?,?,?)",
                 (blk.id, 3, blk.to_bytes()))
        mid.exec("INSERT INTO layers (id, applied_block, aggregated_hash)"
                 " VALUES (?,?,?)", (3, blk.id, P.sum256(bytes(32), blk.id)))
        mid.exec("INSERT INTO certificates (layer, block_id) VALUES (?,?)",
                 (3, blk.id))
        mid.close()
        return blk.id

    view, bid = _migrate_both(tmp_path, build, [3])
    assert view["certs"] == [3] and view["boundary"] == -1
    assert view["agg"][3] == sum256(bytes(32), bid)


def test_reward_migration_fresh_database_has_no_boundary(tmp_path):
    view, _ = _migrate_both(tmp_path, lambda path, P: None, [0])
    assert view == {"blocks": {0: []}, "applied": {0: None},
                    "agg": {0: None}, "certs": [], "boundary": -1}


def test_metric_families_match():
    """The families the slice records: the same kind, help and buckets."""
    db.open_state().close()
    jdb.open_state().close()
    for name in ("sql_state_query_seconds", "sql_state_queries",
                 "pubsub_handler_drops_total", "gossip_handler_seconds"):
        t = tmetrics.REGISTRY._instruments[name]
        j = jmetrics.REGISTRY._instruments[name]
        assert type(t).__name__ == type(j).__name__
        assert t.help == j.help
        assert getattr(t, "buckets", None) == getattr(j, "buckets", None)
