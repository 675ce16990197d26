"""The verifyd fleet's deterministic drills (port of the verifyd part of
``spacemesh_tpu/sim/``): ``verifyd_load.py`` (open-loop multi-client load
on one service), ``failover.py`` (the verifyd-outage drill), ``fleet.py``
(the fleet and byzantine-verifyd drills) and ``scenarios.py`` (their
scripts, ``builtin()`` and ``run()``). Each ``run_scenario`` takes
``device=`` and defaults to ``"cuda"``.
"""
