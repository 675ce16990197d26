"""Process-wide device topology: one mesh per device list, named axes,
persistent layouts.

Port of ``spacemesh_tpu/parallel/topology.py``. The JAX package builds one
``jax.sharding.Mesh`` over the process's devices and lets GSPMD place the
lane axis on it. The port has no SPMD compiler, and it needs none: the
JAX mesh is one controller process over its local devices, and the only
cross-lane work of the POST pipeline is a few scalar reductions and the
VRF min-scan's carry (``parallel/mesh.py``). So here a mesh is a list of
**stripes**, one per entry of a device list, in one process:

* the lane axis of a batch is split into one contiguous tensor per
  stripe (``torch.tensor_split``: stripes differ by at most one lane), in
  lane order, each copied to its stripe's device without blocking from
  pinned memory, on the stripe's own CUDA stream;
* each stripe runs the existing kernel wrappers on its device and stream;
* ``parallel/mesh.py`` combines the stripes' small results.

A device may appear more than once in a device list; each entry is then a
stripe of its own, with its own stream. That is the counterpart of the
JAX tests' eight virtual host devices: ``["cpu"] * 8`` holds 8-way
striping on the CPU, and ``["cuda:0", "cuda:0"]`` two streams on one card.

Axes: ``data`` (the lane axis every label, prove and verify batch stripes
over) and ``model`` (reserved, size 1), as in the JAX file.

:class:`MeshLayouts` is built once per device list and holds the mesh,
one stream per stripe and the placement helpers. :class:`DeviceTopology`
keys layouts by device count (a prefix of the visible devices) and by
device list, so each list maps to one mesh object per process. The
visible devices are every CUDA device (``torch.cuda.device_count()``), or
the CPU alone on a host without a card; ``reset(devices)`` rebuilds the
topology over an explicit list (tests simulating a fresh process). This
module is the one construction site of meshes and streams for the
stripes (spacecheck SC010 keeps per-call construction out of the hot
paths).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..utils import sanitize

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """An ordered list of stripes: one device per entry, repeats allowed.
    Built only by :class:`MeshLayouts`; compare meshes by identity."""

    def __init__(self, devices) -> None:
        self.devices = tuple(_norm(d) for d in devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: len(self.devices), MODEL_AXIS: 1}

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


class MeshLayouts:
    """The persistent catalog for one device list: the mesh, one CUDA
    stream per stripe (``None`` for a CPU stripe) and the placement
    helpers. One instance per device list per process."""

    def __init__(self, devices) -> None:
        # the one construction site for the process (SC010 polices the
        # hot-path modules; this module is the exemption)
        # spacecheck: ok=SC010 the topology IS the construction site
        self.mesh = Mesh(devices)
        if len({d.type for d in self.mesh.devices}) > 1:
            raise ValueError(f"a mesh's stripes share one device type: "
                             f"{self.mesh}")
        self.streams = tuple(
            torch.cuda.Stream(device=d) if d.type == "cuda" else None
            for d in self.mesh.devices)

    def stream(self, k: int):
        """Context that makes stripe ``k``'s stream current (nothing on a
        CPU stripe)."""
        s = self.streams[k]
        return torch.cuda.stream(s) if s is not None \
            else contextlib.nullcontext()

    def bounds(self, lanes: int, unit: int = 1) -> list[tuple[int, int]]:
        """(first lane, lanes) of each stripe for a batch of ``lanes``
        lanes split in whole units of ``unit`` lanes (``tensor_split``'s
        rule: the first stripes take one unit more)."""
        units, extra = divmod(lanes // unit, self.mesh.size)
        out, at = [], 0
        for k in range(self.mesh.size):
            m = (units + (k < extra)) * unit
            out.append((at, m))
            at += m
        # a ragged remainder below one unit rides on the last stripe
        first, m = out[-1]
        out[-1] = (first, m + lanes - at)
        return out

    # --- placement helpers (the per-dispatch hot path) -----------------

    def put_batch(self, value, unit: int = 1) -> list[torch.Tensor]:
        """Split the last (lane) axis of a host u32 array into one int32
        tensor per stripe, each on its stripe's device: a (B,) batch or a
        word-major (words, B) array alike. Each copy to a card goes
        through pinned memory on the stripe's stream."""
        from ..ops import u32

        host = np.asarray(value, dtype=np.uint32)
        out = []
        for k, (first, m) in enumerate(self.bounds(host.shape[-1], unit)):
            with self.stream(k):
                out.append(u32.from_numpy(host[..., first:first + m],
                                          self.mesh.devices[k]))
        return out

    put_lane = put_batch

    def replicate(self, value) -> list[torch.Tensor]:
        """A host u32 array on every stripe's device: one tensor per
        stripe. A
        no-op when ``value`` already is such a list (the VRF carry and
        the prover's hit state stay resident across a pass instead of
        being placed again per batch)."""
        if self.resident(value):
            return value
        from ..ops import u32

        out = []
        for k, dev in enumerate(self.mesh.devices):
            with self.stream(k):
                out.append(u32.from_numpy(value, dev))
        return out

    def resident(self, value) -> bool:
        """True when ``value`` is one tensor per stripe, each on its
        stripe's device."""
        return (isinstance(value, (list, tuple))
                and len(value) == self.mesh.size
                and all(isinstance(t, torch.Tensor) and _same(t.device, d)
                        for t, d in zip(value, self.mesh.devices)))


def _norm(d) -> torch.device:
    """A device with its index: ``cuda`` names the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _same(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    return (a.index or 0) == (b.index or 0)


def visible_devices() -> tuple[torch.device, ...]:
    """Every CUDA device, or the CPU alone without a card."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count:
        return tuple(torch.device("cuda", i) for i in range(count))
    return (torch.device("cpu"),)


class DeviceTopology:
    """One mesh family per process, built once, layouts cached forever.

    ``layouts(k)`` returns the catalog for the first ``k`` visible devices
    (``None`` = all of them); ``layouts_for_devices`` any other list."""

    def __init__(self, devices=None) -> None:
        self._devices = tuple(_norm(d) for d in devices) \
            if devices is not None else visible_devices()
        if not self._devices:
            raise ValueError("a topology needs at least one device")
        self._layouts: dict[int, MeshLayouts] = {}
        self._foreign: dict[tuple, MeshLayouts] = {}
        self._lock = sanitize.lock("parallel.topology")

    @property
    def device_count(self) -> int:
        return len(self._devices)

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return self._devices

    @property
    def platform(self) -> str:
        """``cuda`` or ``cpu``: the type of the visible devices."""
        return self._devices[0].type

    def layouts(self, devices: int | None = None) -> MeshLayouts:
        k = self.device_count if devices is None else int(devices)
        k = max(1, min(k, self.device_count))
        with self._lock:
            lay = self._layouts.get(k)
            if lay is None:
                lay = self._layouts[k] = MeshLayouts(self._devices[:k])
            return lay

    def layouts_for_devices(self, devices) -> MeshLayouts:
        """The catalog over exactly ``devices`` (a list of devices or
        device names). A prefix of the visible devices hits the per-count
        cache; any other list gets its own catalog, built once."""
        devs = tuple(_norm(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if devs == self._devices[:len(devs)]:
            return self.layouts(len(devs))
        key = tuple(str(d) for d in devs)
        with self._lock:
            lay = self._foreign.get(key)
            if lay is None:
                lay = self._foreign[key] = MeshLayouts(devs)
            return lay

    def layouts_for(self, mesh: Mesh) -> MeshLayouts:
        """The catalog that owns ``mesh``, or one over its devices for a
        mesh built elsewhere."""
        return self.layouts_for_devices(mesh.devices)


_TOPOLOGY: DeviceTopology | None = None
_TOPOLOGY_LOCK = sanitize.lock("parallel.topology.init")


def get() -> DeviceTopology:
    """The process-wide topology, built on first use."""
    global _TOPOLOGY
    t = _TOPOLOGY
    if t is None:
        with _TOPOLOGY_LOCK:
            if _TOPOLOGY is None:
                _TOPOLOGY = DeviceTopology()
            t = _TOPOLOGY
    return t


def reset(devices=None) -> None:
    """Drop the topology; the next :func:`get` builds it over ``devices``
    (default: the visible devices). For tests simulating a fresh process:
    a live process keeps its meshes."""
    global _TOPOLOGY
    with _TOPOLOGY_LOCK:
        _TOPOLOGY = None if devices is None else DeviceTopology(devices)
