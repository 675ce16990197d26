"""The pieces of ``spacemesh_tpu/obs/`` the verification farm and verifyd
use: stall watchdogs and the health registry (``health.py``), circuit
breakers, backoff and the recovery-hook registry (``remediate.py``)."""
