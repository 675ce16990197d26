"""Device resolution for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``. A CUDA
request without a usable card raises: there is no silent CPU path. Only an
explicit ``device="cpu"`` (the tests) runs on the host.

A scrape-time collector sets ``device_allocator_calls{call}`` (``malloc``,
``free``, ``retry``) from the caching allocator's statistics of every card
resolved so far: none before the first CUDA use, so the gauge stays absent
on the host. It runs on a ``REGISTRY.sample()`` or a ``/metrics`` scrape
only, never on a launch path. :class:`HostCopy` records the spans
``device.host_copy`` (the pinned allocation and the copy's enqueue) and
``device.host_wait`` (the wait in :meth:`HostCopy.get`).
"""

from __future__ import annotations

import torch

from .utils import metrics, tracing

DEFAULT = "cuda"

# card indices resolved so far; the allocator collector reads each
_cards: set[int] = set()
# memory_stats key -> the gauge's ``call`` label
_ALLOCATOR_CALLS = (("num_device_alloc", "malloc"),
                    ("num_device_free", "free"),
                    ("num_alloc_retries", "retry"))


def _collect_allocator_calls() -> None:
    totals: dict[str, int] = {}
    for index in sorted(_cards):
        stats = torch.cuda.memory_stats_as_nested_dict(index)
        for key, call in _ALLOCATOR_CALLS:
            if key in stats:
                totals[call] = totals.get(call, 0) + int(stats[key])
    for call, value in totals.items():
        metrics.device_allocator_calls.set(value, call=call)


metrics.REGISTRY.add_collector(_collect_allocator_calls)


def resolve(device: str | torch.device | None = DEFAULT) -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    no card is visible."""
    dev = torch.device(DEFAULT if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is false; "
            "pass device='cpu' explicitly to run on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        _cards.add(torch.cuda.current_device() if dev.index is None
                   else dev.index)
    return dev


class HostCopy:
    """A device-to-host copy enqueued now and awaited at :meth:`get`.

    On one stream a plain ``.cpu()`` at retire time would queue behind
    every batch dispatched since, so the pipelines enqueue each batch's
    copy (into pinned memory) right behind its compute instead."""

    def __init__(self, t: torch.Tensor):
        with tracing.span("device.host_copy"):
            if t.device.type == "cuda":
                self.tensor = torch.empty(t.shape, dtype=t.dtype,
                                          pin_memory=True)
                self.tensor.copy_(t, non_blocking=True)
                self._event = torch.cuda.Event()
                self._event.record(torch.cuda.current_stream(t.device))
            else:
                self.tensor = t
                self._event = None

    def get(self) -> torch.Tensor:
        """The host tensor, once the copy has landed: the one place where
        init, the packer and the prover wait on the card."""
        with tracing.span("device.host_wait"):
            if self._event is not None:
                self._event.synchronize()
        return self.tensor
