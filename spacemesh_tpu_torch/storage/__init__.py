"""Persistence: SQLite state/local databases + in-RAM caches (port of
``spacemesh_tpu/storage/``, whole).

Mirrors the reference sql/ layer (reference sql/database.go, two databases:
``state.db`` for consensus data replicated across the network and
``local.db`` for node-private progress — sql/statesql, sql/localsql), with
per-entity query modules (reference sql/atxs, sql/ballots, ...) and the
lock-free in-RAM ATX cache used by hot paths (reference atxsdata/data.go).
"""

from .db import Database, open_local, open_state  # noqa: F401
