"""The port twin of ``tests/test_racecheck.py``'s static tests.

SC007 (lock discipline), SC008 (lock order, ``await`` under a lock),
SC002's future and queue cases, the incremental cache, ``--jobs`` and the
CLI's path subset run on the port's checker through ``torch_twin``, their
fixtures under ``spacemesh_tpu_torch/`` prefixes. The JAX file's runtime
sanitizer tests are twinned in ``tests/test_torch_sanitize.py`` under the
same names; the last test here keeps the two files covering all of it.
"""

from pathlib import Path

import torch_twin
from spacemesh_tpu_torch.tools.spacecheck import engine

STATIC = {
    "test_sc007_flags_mixed_locked_bare_access",
    "test_sc007_consistently_locked_twin_is_clean",
    "test_sc007_condition_aliases_to_root_lock",
    "test_sc007_exemptions",
    "test_sc007_non_threaded_class_is_skipped",
    "test_sc007_container_mutation_counts_as_write",
    "test_sc007_nested_closure_is_bare_even_inside_with",
    "test_sc008_flags_cycle_at_both_edges",
    "test_sc008_consistent_order_is_clean",
    "test_sc008_call_through_edge",
    "test_sc008_await_under_threading_lock",
    "test_sc008_cross_function_cycle_in_one_module",
    "test_sc002_annotated_queue_binding_is_tracked",
    "test_sc002_future_result_and_queue_in_async",
    "test_cache_cold_and_warm_runs_are_identical",
    "test_warm_run_is_a_pure_cache_hit",
    "test_cache_invalidates_on_any_file_change",
    "test_select_runs_bypass_the_cache",
    "test_jobs_parallel_findings_match_serial",
    "test_cli_jobs_and_cache_flags",
    "test_lock_across_await_detected_statically",
    "test_cli_path_subset_does_not_clobber_full_cache",
}

_twin = torch_twin.export("test_racecheck", globals(), only=STATIC)


def test_every_racecheck_test_is_twinned():
    """Each test of the JAX file runs on the port: the static ones here,
    the runtime sanitizer ones in test_torch_sanitize.py by name."""
    assert _twin.engine is engine
    ours = {k for k in vars(_twin) if k.startswith("test_")}
    assert STATIC <= ours
    sanitize_src = (Path(__file__).parent
                    / "test_torch_sanitize.py").read_text()
    for name in sorted(ours - STATIC):
        assert f"def {name}(" in sanitize_src, name
