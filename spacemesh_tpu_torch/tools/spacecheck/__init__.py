"""spacecheck: project-specific static analysis for recurring defects.

The JAX package's review history forms a near-periodic catalog of
the same defect families — event-loop-blocking calls in async code,
donated-buffer reuse after a failed dispatch, wall-clock reads in
virtual-time-aware modules, register/unregister pairing bugs, metrics
misregistration, and swallowed errors in consensus-critical paths.
Hand review re-finds them one at a time; this package encodes each as a
machine-checked AST rule. It is a copy of the JAX package's
``tools/spacecheck`` retargeted to the port: every rule's scope is a
``spacemesh_tpu_torch/`` prefix, SC002 knows torch's device syncs and
SC010 torch's device meshes, and tier-1 holds the port's tree to it
(``python -m spacemesh_tpu_torch.tools.spacecheck``, which scans
``spacemesh_tpu_torch/``, ``tests/test_torch_*.py`` and
``tests/torch_twin.py``; never both packages in one run, since SC005
reads metric names across every scanned file).

Rules (each docstring cites the defect it generalizes):

==========  ===========================================================
SC001       clock discipline: no wall-clock reads or literal sleeps in
            virtual-time-aware modules (rules/sc001_clock.py)
SC002       no blocking calls lexically inside ``async def``
            (rules/sc002_async_blocking.py)
SC003       no reads of a donated buffer after the donating jit call
            (rules/sc003_donation.py)
SC004       register/unregister, span enter/exit, collector and
            executor/fd lifecycles pair on all paths
            (rules/sc004_pairing.py)
SC005       metrics hygiene: module-scope creation, unique names,
            literal label names, bounded label values
            (rules/sc005_metrics.py)
SC006       no bare/swallowing excepts in consensus-critical packages
            (rules/sc006_excepts.py)
SC007       no mixed locked/bare access to shared state in threaded
            classes (rules/sc007_lock_discipline.py)
SC008       no lock-order cycles, no ``await`` under a threading lock
            (rules/sc008_lock_order.py)
SC009       rename-based persistence is fsync-bracketed
            (rules/sc009_durability.py)
SC010       no per-call device-mesh/sharding construction in hot paths
            (rules/sc010_sharding.py)
==========  ===========================================================

Suppression is explicit and justified, never silent: a line pragma
(``# spacecheck: ok=SC001 <why>``), a module pragma for SC001
(``# spacecheck: wall-clock-ok <why>``), or a checked-in baseline entry
carrying a per-finding justification
(``spacemesh_tpu_torch/tools/spacecheck/baseline.json``; stale entries
fail the run — see baseline.py).

The runtime-sanitizer complement — what AST cannot see — lives in
``spacemesh_tpu_torch/utils/sanitize.py`` (``SPACEMESH_SANITIZE=1``).
"""

from .engine import Finding, run_paths  # noqa: F401

__all__ = ["Finding", "run_paths"]
