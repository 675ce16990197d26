"""Rule registry: one module per rule, each exporting RULE + check()."""

from . import (sc001_clock, sc002_async_blocking, sc003_donation,
               sc004_pairing, sc005_metrics, sc006_excepts,
               sc007_lock_discipline, sc008_lock_order, sc009_durability,
               sc010_sharding)

ALL_RULES = (sc001_clock, sc002_async_blocking, sc003_donation,
             sc004_pairing, sc005_metrics, sc006_excepts,
             sc007_lock_discipline, sc008_lock_order, sc009_durability,
             sc010_sharding)

__all__ = ["ALL_RULES"]
