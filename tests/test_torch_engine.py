"""The port's bounded pipeline and admission lanes
(``spacemesh_tpu_torch/runtime/{engine,queue}.py``): the cases of
``tests/test_runtime_engine.py`` that no other port test holds run on the
port through ``torch_twin``: the window's FIFO order and its depth hook,
an early exit abandoning what is in flight, a stop discarding what is
pending, and the kind lanes' priority and promotion.

The rest of that file is held elsewhere: the fallback and breaker cases
in ``tests/test_torch_failover.py``, the idle sentinel and the tenant
label in ``tests/test_torch_scheduler.py``, the lane group in
``tests/test_torch_queue.py``, and the initializer, prover, prove session
and k2pow on the engine side by side with the JAX package in
``tests/test_torch_post.py``, ``tests/test_torch_scheduler.py`` and
``tests/test_torch_ops.py``.
"""

from torch_twin import export

export("test_runtime_engine", globals(), only=(
    "test_pipeline_window_bound_and_fifo",
    "test_pipeline_early_exit_abandons_inflight",
    "test_pipeline_stop_discards_pending",
    "test_kind_lanes_priority_and_promote"))
