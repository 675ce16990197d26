"""The pieces of ``spacemesh_tpu/obs/`` the verification farm, verifyd and
its fleet use: stall watchdogs and the health registry (``health.py``),
circuit breakers, backoff and the recovery-hook registry
(``remediate.py``), windowed SLIs (``sli.py``) and the metric half of the
cross-process federation (``federate.py``)."""
