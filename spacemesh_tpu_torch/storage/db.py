"""SQLite wrapper: connections, transactions, versioned migrations.

Port of ``spacemesh_tpu/storage/db.py``, whole: the same migrations,
``user_version`` and pragmas, so a state database written by either
package opens in the other with the same rows.

Reference parity (reference sql/database.go:244 Open, :562 Database
interface; migrations sql/migrations.go with versioned .sql files; schema
drift check sql/schema.go): migrations are ordered Python-side DDL lists,
the applied version lives in ``PRAGMA user_version``, and opening verifies
the schema version matches the code. In-memory databases (``:memory:``)
give every test real persistence semantics — the reference's
statesql.InMemory pattern (SURVEY.md §4.2).

sqlite3 is used in autocommit mode with explicit BEGIN IMMEDIATE
transactions; WAL journaling for file databases.
"""

from __future__ import annotations

import contextlib
import queue
import sqlite3
import threading
import time
from pathlib import Path


class Database:
    """One writer sqlite handle plus an optional read-only pool.

    The control plane is asyncio/single-threaded per subsystem; the lock
    makes cross-thread use (post worker callbacks, API server) safe.

    ``read_pool`` (reference sql/database.go: a pooled connection set so
    API reads don't serialize behind the writer) opens that many extra
    read-only connections for file databases in WAL mode — WAL readers
    see a consistent snapshot and never block the writer or each other.
    ``one``/``all`` borrow from the pool except when the CALLING thread
    holds an open transaction (its uncommitted writes are only visible
    on the writer handle). In-memory databases cannot pool (each sqlite
    connection to ":memory:" is a distinct database) and keep the
    single-handle behavior.

    Every query records its latency in the global metrics registry
    (reference sql/metrics.go) under ``sql_<name>_query_seconds``.
    """

    def __init__(self, path: str | Path, migrations: list[str],
                 name: str = "db", read_pool: int = 0):
        self.path = str(path)
        self.name = name
        self._conn = sqlite3.connect(
            self.path, isolation_level=None, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._lock = threading.RLock()
        self._tx_owner: int | None = None
        if self.path != ":memory:":
            # incremental auto-vacuum: maybe_vacuum reclaims free pages
            # in bounded chunks instead of a full-database VACUUM that
            # would hold the writer lock for minutes on a mainnet-shape
            # db. MUST precede journal_mode=WAL — the
            # WAL switch initializes page 1, after which the pragma is a
            # silent no-op. Pre-existing dbs without it never reclaim
            # (retrofitting needs a full offline VACUUM).
            self._conn.execute("PRAGMA auto_vacuum=INCREMENTAL")
            self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA foreign_keys=ON")
        from ..utils import metrics as _metrics
        # per-role instrument names ("state"/"local"): a bounded set the
        # registry get-or-creates with IDENTICAL buckets on every
        # construction (bucket drift raises)
        # spacecheck: ok=SC005 bounded per-db-role names, identical buckets on re-create
        self._latency = _metrics.REGISTRY.histogram(
            f"sql_{name}_query_seconds",
            f"{name} db query latency",
            buckets=(0.0005, 0.005, 0.05, 0.5, 5.0, float("inf")))
        # spacecheck: ok=SC005 bounded per-db-role names, get-or-create by design
        self._queries = _metrics.REGISTRY.counter(
            f"sql_{name}_queries", f"{name} db queries executed")
        self._readers: queue.SimpleQueue | None = None
        self._pool_closed = False
        self._migrate(migrations)
        if read_pool > 0 and self.path != ":memory:":
            self._readers = queue.SimpleQueue()
            for _ in range(read_pool):
                rc = sqlite3.connect(self.path, isolation_level=None,
                                     check_same_thread=False)
                rc.row_factory = sqlite3.Row
                rc.execute("PRAGMA query_only=ON")
                self._readers.put(rc)

    def _migrate(self, migrations: list) -> None:
        # NOTE: executescript() implicitly commits any open transaction, so
        # migrations run outside tx(); each script is itself atomic enough
        # (DDL) and user_version advances only after a script completes.
        # A migration may also be a Python callable(conn) — data rewrites
        # (blob re-encoding) that SQL can't express (the reference's coded
        # migrations, sql/migrations.go).
        with self._lock:
            version = self._conn.execute("PRAGMA user_version").fetchone()[0]
            if version > len(migrations):
                raise RuntimeError(
                    f"{self.name}: database schema version {version} is newer "
                    f"than this build supports ({len(migrations)})")
            for i in range(version, len(migrations)):
                if callable(migrations[i]):
                    # data rewrites must be atomic WITH the version bump:
                    # autocommit would persist a half-rewritten state on
                    # a crash, and a rerun over partial output can
                    # mis-detect what it is repairing (0005's boundary
                    # scan)
                    self._conn.execute("BEGIN IMMEDIATE")
                    try:
                        migrations[i](self._conn)
                        self._conn.execute(f"PRAGMA user_version={i + 1}")
                    except BaseException:
                        self._conn.execute("ROLLBACK")
                        raise
                    self._conn.execute("COMMIT")
                else:
                    self._conn.executescript(migrations[i])
                    self._conn.execute(f"PRAGMA user_version={i + 1}")

    @contextlib.contextmanager
    def tx(self):
        """BEGIN IMMEDIATE transaction; commits on success, rolls back on
        error. Reentrant (nested use joins the outer transaction)."""
        with self._lock:
            if self._conn.in_transaction:
                yield self._conn
                return
            self._conn.execute("BEGIN IMMEDIATE")
            self._tx_owner = threading.get_ident()
            try:
                yield self._conn
            except BaseException:
                self._conn.execute("ROLLBACK")
                raise
            else:
                self._conn.execute("COMMIT")
            finally:
                self._tx_owner = None

    @contextlib.contextmanager
    def _timed(self):
        start = time.perf_counter()
        try:
            yield
        finally:
            self._latency.observe(time.perf_counter() - start)
            self._queries.inc()

    @contextlib.contextmanager
    def _read_conn(self):
        """A connection for a read: a pooled read-only handle when one
        exists and the calling thread is not inside tx() (uncommitted
        writes are only visible on the writer handle)."""
        if self._readers is None \
                or self._tx_owner == threading.get_ident():
            with self._lock:
                yield self._conn
            return
        if self._pool_closed:
            # close() drained the pool — blocking on get() here would
            # hang the caller forever; fail the way sqlite3 does
            raise sqlite3.ProgrammingError(
                f"{self.name}: cannot read from a closed database")
        rc = self._readers.get()
        try:
            yield rc
        finally:
            if self._pool_closed:
                rc.close()
            else:
                self._readers.put(rc)

    def exec(self, sql: str, params=()) -> sqlite3.Cursor:
        with self._timed(), self._lock:
            return self._conn.execute(sql, params)

    def one(self, sql: str, params=()):
        with self._timed(), self._read_conn() as conn:
            return conn.execute(sql, params).fetchone()

    def all(self, sql: str, params=()):
        with self._timed(), self._read_conn() as conn:
            return conn.execute(sql, params).fetchall()

    def close(self) -> None:
        # the queue object stays — a reader borrowed by another thread
        # returns through _read_conn's finally, which checks this flag
        # and closes it instead of re-pooling (nulling the queue would
        # race the in-flight return)
        self._pool_closed = True
        if self._readers is not None:
            while True:
                try:
                    self._readers.get_nowait().close()
                except queue.Empty:
                    break
        with self._lock:
            self._conn.close()

    def vacuum(self) -> None:
        with self._lock:
            self._conn.execute("VACUUM")

    def maybe_vacuum(self, min_free_fraction: float = 0.2,
                     max_pages: int = 512) -> bool:
        """Reclaim free pages when the freelist says it is worth it
        (reference sql/vacuum.go: scheduled maintenance, not per-write).
        Uses ``PRAGMA incremental_vacuum`` bounded to ``max_pages`` per
        call so the writer lock is held for a bounded slice, never a
        full-database rewrite; the pruner's next tick continues the
        reclaim. Returns True if pages were reclaimed. Falls back to a
        full VACUUM only where incremental mode is unavailable
        (pre-existing dbs created without auto_vacuum)."""
        with self._lock:
            pages = self._conn.execute("PRAGMA page_count").fetchone()[0]
            free = self._conn.execute("PRAGMA freelist_count").fetchone()[0]
            if pages == 0 or free / pages < min_free_fraction:
                return False
            mode = self._conn.execute("PRAGMA auto_vacuum").fetchone()[0]
            if mode != 2:
                # a full VACUUM here would hold the writer lock for the
                # whole database rewrite — exactly the stall this method
                # exists to avoid. Databases created before incremental
                # mode keep their freelist; the operator can run
                # vacuum() offline.
                return False
            # streaming pragma: each cursor step frees one page — the
            # cursor must be drained or only a single page is reclaimed
            self._conn.execute(
                f"PRAGMA incremental_vacuum({max_pages})").fetchall()
            return True


# --- state database (replicated consensus data) ---------------------------

STATE_MIGRATIONS = [
    # 0001: core mesh entities
    """
    CREATE TABLE atxs (
        id BLOB PRIMARY KEY,
        node_id BLOB NOT NULL,
        publish_epoch INT NOT NULL,
        num_units INT NOT NULL,
        tick_height INT NOT NULL DEFAULT 0,
        vrf_nonce INT NOT NULL DEFAULT 0,
        coinbase BLOB,
        received INT NOT NULL DEFAULT 0,
        data BLOB NOT NULL
    );
    CREATE INDEX atxs_by_epoch ON atxs (publish_epoch);
    CREATE INDEX atxs_by_node ON atxs (node_id, publish_epoch);

    CREATE TABLE ballots (
        id BLOB PRIMARY KEY,
        layer INT NOT NULL,
        atx_id BLOB NOT NULL,
        node_id BLOB NOT NULL,
        data BLOB NOT NULL
    );
    CREATE INDEX ballots_by_layer ON ballots (layer);
    CREATE INDEX ballots_by_node_layer ON ballots (node_id, layer);

    CREATE TABLE blocks (
        id BLOB PRIMARY KEY,
        layer INT NOT NULL,
        validity INT NOT NULL DEFAULT 0,  -- 0 undecided, 1 valid, -1 invalid
        data BLOB NOT NULL
    );
    CREATE INDEX blocks_by_layer ON blocks (layer);

    CREATE TABLE layers (
        id INT PRIMARY KEY,
        processed INT NOT NULL DEFAULT 0,
        applied_block BLOB,
        state_hash BLOB,
        aggregated_hash BLOB
    );

    CREATE TABLE certificates (
        layer INT NOT NULL,
        block_id BLOB NOT NULL,
        cert BLOB,
        valid INT NOT NULL DEFAULT 1,
        PRIMARY KEY (layer, block_id)
    );

    CREATE TABLE beacons (
        epoch INT PRIMARY KEY,
        beacon BLOB NOT NULL
    );

    CREATE TABLE identities (
        node_id BLOB PRIMARY KEY,
        proof BLOB,
        received INT NOT NULL DEFAULT 0,
        marriage_atx BLOB
    );

    CREATE TABLE transactions (
        id BLOB PRIMARY KEY,
        raw BLOB NOT NULL,
        principal BLOB,
        nonce INT,
        layer INT,
        block BLOB,
        result BLOB
    );
    CREATE INDEX txs_by_principal ON transactions (principal, nonce);

    CREATE TABLE accounts (
        address BLOB NOT NULL,
        layer INT NOT NULL,
        balance INT NOT NULL DEFAULT 0,
        next_nonce INT NOT NULL DEFAULT 0,
        template BLOB,
        state BLOB,
        PRIMARY KEY (address, layer)
    );

    CREATE TABLE rewards (
        coinbase BLOB NOT NULL,
        layer INT NOT NULL,
        total_reward INT NOT NULL,
        layer_reward INT NOT NULL,
        PRIMARY KEY (coinbase, layer)
    );

    CREATE TABLE poet_proofs (
        ref BLOB PRIMARY KEY,
        poet_id BLOB NOT NULL,
        round_id TEXT NOT NULL,
        ticks INT NOT NULL,
        data BLOB NOT NULL
    );

    CREATE TABLE active_sets (
        id BLOB PRIMARY KEY,
        epoch INT NOT NULL,
        data BLOB NOT NULL
    );
    """,
    # 0002: beacon provenance — protocol-decided beacons are final, fallback/
    # synced ones may be superseded by a later majority (a single
    # peer must not poison a late joiner's beacon permanently). Existing rows
    # default to FALLBACK(1): pre-migration rows may have been adopted from a
    # single peer; protocol-decided values are network-identical, so leaving
    # them supersedable is harmless.
    """
    ALTER TABLE beacons ADD COLUMN source INT NOT NULL DEFAULT 1;
    """,
    # 0003: ATX wire version — v2 (merged/multi-identity) rows store the
    # shared envelope blob once per covered identity under synthetic ids
    """
    ALTER TABLE atxs ADD COLUMN version INT NOT NULL DEFAULT 1;
    """,
]


def _migrate_0004_reward_atx(conn) -> None:
    """Reward gained a leading atx_id field (reference AnyReward carries
    the ATXID; needed for active-set-from-first-block recovery). Re-encode
    every stored block blob from the 2-field layout; unknown provenance
    gets the zero ATX id. Block ids are content hashes, so the id column
    is rewritten too and dependent tables (layers.applied_block,
    certificates.block_id) follow."""
    import io

    from ..core import codec as _codec
    from ..core import types as _types

    legacy_reward = _codec.Codec(
        enc=None,
        dec=lambda r: (_types.ADDRESS.dec(r), _types.u64.dec(r)))
    legacy_block = _codec.Codec(
        enc=None,
        dec=lambda r: {
            "layer": _types.u32.dec(r),
            "tick_height": _types.u64.dec(r),
            "rewards": _codec.vec(legacy_reward, 1 << 12).dec(r),
            "tx_ids": _codec.vec(_types.HASH32, 1 << 16).dec(r),
        })
    rows = conn.execute("SELECT id, data FROM blocks").fetchall()
    for row in rows:
        old_id, data = row[0], row[1]
        try:
            reader = io.BytesIO(data)
            raw = legacy_block.dec(reader)
            if reader.read(1):
                continue  # trailing bytes: not the legacy layout
        except Exception:
            continue  # already new-format (fresh db mid-transition)
        block = _types.Block(
            layer=raw["layer"], tick_height=raw["tick_height"],
            rewards=[_types.Reward(atx_id=bytes(32), coinbase=cb, weight=w)
                     for cb, w in raw["rewards"]],
            tx_ids=raw["tx_ids"])
        conn.execute("UPDATE blocks SET id=?, data=? WHERE id=?",
                     (block.id, block.to_bytes(), old_id))
        conn.execute("UPDATE layers SET applied_block=?"
                     " WHERE applied_block=?", (block.id, old_id))
        conn.execute("UPDATE certificates SET block_id=? WHERE block_id=?",
                     (block.id, old_id))


STATE_MIGRATIONS.append(_migrate_0004_reward_atx)


def _migrate_0005_rewrite_fixups(conn) -> None:
    """The 0004 block-id rewrite invalidated derived data it did not fix,
    and 0004 itself cannot be amended (databases already at
    user_version 4 would never re-run it), so the repair is a separate
    migration that DETECTS whether a rewrite ever happened: it recomputes
    the chained aggregated layer hashes agg(L) = H(agg(L-1) || applied)
    (mesh.py _aggregate) and compares with the stored chain. A mismatch
    can only mean the stored chain predates the id rewrite, in which
    case:
      - the chain is replaced with the recomputed one (fork-finder
        comparisons against freshly syncing peers must match);
      - hare certificates are dropped — their blobs embed the old block
        id under a signature that cannot be re-issued;
      - the top layer is recorded as a boundary mark; Tortoise.recover
        replays ballots strictly after it (their signed vote lists name
        pre-rewrite ids that would all resolve as against). Persisted
        per-block validity verdicts cover the fenced-off layers."""
    from ..core.hashing import sum256

    conn.execute("CREATE TABLE IF NOT EXISTS migration_marks ("
                 " key TEXT PRIMARY KEY, value INT NOT NULL)")
    rows = conn.execute(
        "SELECT id, applied_block, aggregated_hash FROM layers"
        " WHERE aggregated_hash IS NOT NULL ORDER BY id").fetchall()
    # The rewrite point is localizable with the STEP relation over stored
    # values: stored_agg(L) == H(stored_agg(L-1) || applied(L)) holds for
    # layers chained after the id rewrite and fails for layers whose
    # applied_block was rewritten under them (0004 changed the column but
    # not the hash). A node that kept running on the v4 build for weeks
    # has thousands of perfectly valid post-rewrite layers — fencing and
    # cert-dropping must stop at the true boundary, not the top.
    # Residual: trailing EMPTY pre-rewrite layers are
    # step-consistent (their input bytes(32) never changed), so a ballot
    # in one of those few layers may still be replayed; its unresolved
    # supports default to against within an already-fenced window.
    boundary = -1
    stored = {lr[0]: lr[2] for lr in rows}
    for lr in rows:
        layer, applied = lr[0], lr[1] or bytes(32)
        prev = stored.get(layer - 1, bytes(32))
        if sum256(prev, applied) != lr[2]:
            boundary = layer
    if boundary < 0:
        return
    # full-chain recompute from genesis: post-boundary layers are
    # step-consistent but chain over a pre-rewrite PREFIX, so their
    # absolute values still differ from what a freshly syncing peer
    # computes over the rewritten ids
    agg: dict[int, bytes] = {}
    for lr in rows:
        layer, applied = lr[0], lr[1] or bytes(32)
        agg[layer] = sum256(agg.get(layer - 1, bytes(32)), applied)
        conn.execute("UPDATE layers SET aggregated_hash=? WHERE id=?",
                     (agg[layer], layer))
    conn.execute("DELETE FROM certificates WHERE layer<=?", (boundary,))
    conn.execute("INSERT OR REPLACE INTO migration_marks VALUES"
                 " ('block_id_rewrite_boundary', ?)", (boundary,))


STATE_MIGRATIONS.append(_migrate_0005_rewrite_fixups)

# --- local database (node-private progress) -------------------------------

LOCAL_MIGRATIONS = [
    """
    CREATE TABLE nipost_state (
        node_id BLOB PRIMARY KEY,
        phase INT NOT NULL DEFAULT 0,
        challenge BLOB,
        poet_ref BLOB,
        nipost BLOB,
        updated INT NOT NULL DEFAULT 0
    );

    CREATE TABLE poet_registrations (
        node_id BLOB NOT NULL,
        poet_id BLOB NOT NULL,
        round_id TEXT NOT NULL,
        challenge BLOB NOT NULL,
        round_end INT NOT NULL,
        PRIMARY KEY (node_id, poet_id, round_id)
    );

    CREATE TABLE initial_post (
        node_id BLOB PRIMARY KEY,
        post BLOB NOT NULL,
        commitment_atx BLOB NOT NULL
    );

    CREATE TABLE atx_sync_state (
        epoch INT PRIMARY KEY,
        downloaded INT NOT NULL DEFAULT 0,
        total INT NOT NULL DEFAULT 0
    );

    CREATE TABLE prepared_activeset (
        kind INT NOT NULL,
        epoch INT NOT NULL,
        id BLOB NOT NULL,
        weight INT NOT NULL,
        data BLOB NOT NULL,
        PRIMARY KEY (kind, epoch)
    );
    """,
]


def open_state(path: str | Path = ":memory:",
               read_pool: int = 0) -> Database:
    """The replicated consensus database (reference sql/statesql)."""
    return Database(path, STATE_MIGRATIONS, name="state",
                    read_pool=read_pool)


def open_local(path: str | Path = ":memory:") -> Database:
    """The node-private database (reference sql/localsql)."""
    return Database(path, LOCAL_MIGRATIONS, name="local")
