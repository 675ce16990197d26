"""Batched verification farm: micro-batching admission for crypto checks
(port of ``spacemesh_tpu/verify/``).

Callers submit one signature / VRF proof / POST proof / poet-membership /
k2pow check and await the verdict; a per-kind scheduler coalesces pending
requests into device-wide batches.
"""

from .farm import (  # noqa: F401
    FarmClosed,
    Lane,
    MembershipRequest,
    PostRequest,
    PowRequest,
    SigRequest,
    VerificationFarm,
    VrfRequest,
)
