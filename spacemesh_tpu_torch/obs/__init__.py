"""Health, SLOs, self-healing and the fleet collection plane (port of
``spacemesh_tpu/obs/``):

* ``sli.py``       rolling-window service-level indicators computed from
                   registry snapshots, plus runtime collectors (RSS, fds);
* ``health.py``    stall watchdogs, the component health registry,
                   declarative SLOs with burn-rate accounting and the
                   ``HealthEngine`` tick loop behind verifyd's ``/readyz``;
* ``flight.py``    the flight recorder: on a breach or stall, a spooled
                   diagnostic bundle (trace export, metrics snapshot,
                   health report, breaker states);
* ``remediate.py`` circuit breakers, the shared backoff, the recovery-hook
                   registry and the policy-driven ``RemediationEngine``;
* ``federate.py``  per-process metric snapshots re-exposed under ``proc=``
                   labels, and trace captures merged into one timeline.
"""
