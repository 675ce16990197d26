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

:class:`StreamRing` runs consecutive batches of a label pipeline on two
CUDA streams, so two batches' kernels share the card, and
:class:`Handoff` passes the one device tensor that crosses batches (the
VRF carry) from one ring stream to the other.
"""

from __future__ import annotations

import contextlib

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


class StreamRing:
    """Consecutive batches of one label pipeline on alternate CUDA streams.

    A ROMix launch of one batch leaves part of the card's block slots
    empty, and all its lanes are in the same phase at once: the fill's
    writes leave the mix's reads idle and the other way round. With two
    streams the next batch's launch takes the empty slots and runs in
    another phase. ``streams`` is 2 only where two batches' ROMix V fit
    the card (:func:`label_ring` decides); with 1 every batch runs on the
    caller's stream, as in a pipeline without a ring.

    Each ring stream waits once on the caller's stream before its first
    batch (for tensors made before the loop), and :meth:`close` makes the
    caller's stream wait on both. The two ring streams never wait on each
    other as a whole, which would put each batch behind the other stream's
    ROMix: a device tensor that one batch hands to the next goes through a
    :class:`Handoff`. PyTorch's pool streams are non-blocking, so nothing
    orders them behind the legacy default stream either."""

    def __init__(self, device: torch.device, streams: int = 1):
        self._streams = ([torch.cuda.Stream(device) for _ in range(2)]
                         if streams > 1 and device.type == "cuda" else [])
        if self._streams:
            self._caller = torch.cuda.current_stream(device)
        self._joined = [False] * len(self._streams)
        self._ends: list = [None] * len(self._streams)
        self._next = 0

    @property
    def size(self) -> int:
        """Streams the batches alternate over (1: the caller's alone)."""
        return len(self._streams) or 1

    @contextlib.contextmanager
    def batch(self):
        """Enqueue the next batch on its ring stream: the stream is current
        inside. Yields whether the other stream's previous batch was still
        on the card, read without blocking."""
        if not self._streams:
            yield False
            return
        i = self._next
        self._next ^= 1
        stream = self._streams[i]
        if not self._joined[i]:
            stream.wait_stream(self._caller)
            self._joined[i] = True
        other = self._ends[i ^ 1]
        with torch.cuda.stream(stream):
            yield other is not None and not other.query()
        end = torch.cuda.Event()
        end.record(stream)
        self._ends[i] = end

    def close(self) -> None:
        """Order the caller's stream after every batch of the ring, so what
        it frees or reuses after the loop (an abandoned batch's inputs
        among them) waits for the ring's work."""
        for stream in self._streams:
            self._caller.wait_stream(stream)


def label_ring(device: torch.device, lanes: int, n: int) -> StreamRing:
    """The ring for label batches of ``lanes`` at scrypt ``n``: two streams
    when the card's free memory holds two batches' ROMix V beside the
    headroom ``ops/romix_cuda.py:lanes_that_fit`` keeps, else one (and one
    on the CPU)."""
    if device.type != "cuda":
        return StreamRing(device)
    from .ops import romix_cuda

    fits = romix_cuda.lanes_that_fit(n, device) >= 2 * lanes
    return StreamRing(device, 2 if fits else 1)


class Handoff:
    """A device tensor passed from each batch to the next (the VRF carry).

    :meth:`put` records where the tensor was made; :meth:`take`, on another
    stream, makes that stream wait for it there and marks the tensor used
    by it, so the caching allocator does not hand its memory to the making
    stream's next batch while this one still reads it. Take it right
    before its first use: a wait queued earlier would hold the batch's
    other kernels behind the making stream."""

    def __init__(self, t: torch.Tensor):
        self.put(t)

    def put(self, t: torch.Tensor) -> None:
        self._tensor = t
        self._made_on = self._event = None
        if t.device.type == "cuda":
            self._made_on = torch.cuda.current_stream(t.device)
            self._event = torch.cuda.Event()
            self._event.record(self._made_on)

    def take(self) -> torch.Tensor:
        t = self._tensor
        if self._event is not None:
            stream = torch.cuda.current_stream(t.device)
            if stream != self._made_on:
                stream.wait_event(self._event)
                t.record_stream(stream)
        return t
