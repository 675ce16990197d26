"""The device-job runtime: the dispatch -> retire engine and the
multi-tenant scheduler on top of it (port of ``spacemesh_tpu/runtime/``).

* :mod:`engine`    — the bounded dispatch -> retire window every device
  pipeline runs on, with ``kind`` and ``tenant`` labels on its metrics.
* :mod:`workloads` — the registry of device workload kinds with their
  warm-up recipes, and the host helpers of packed init.
* :mod:`scheduler` — :class:`TenantScheduler`: per-tenant job queues
  drained by fair share and deadlines onto one device, cross-tenant lane
  packing for init, gang-scheduled prove windows, per-tenant quotas.
"""

from .engine import JobStopped, Pipeline, PipelineStats  # noqa: F401
from .scheduler import (  # noqa: F401
    JobHandle, SchedulerClosed, TenantScheduler,
)
