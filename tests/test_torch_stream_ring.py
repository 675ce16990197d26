"""The label pipelines' stream ring (``device.StreamRing``, ``device.Handoff``,
``device.label_ring``) and the engine's use of it, on the CPU.

* the ring's logic against stand-in CUDA streams and events: batches
  alternate over two streams, each stream waits once on the caller's, the
  overlap flag reads the other stream's last batch, ``close`` joins the
  caller to both; the carry's hand-over waits only across streams;
* the fit decision: two streams when two batches' ROMix V fit the card,
  else one, and one on the CPU without asking the card;
* the engine: a ring built once from the first item, the overlap counter
  and the streams gauge; one stream on the CPU for the solo init and the
  packer, and in the prover's and k2pow's pipelines, which take no ring.

The ring on the card (labels equal with one stream and two, overlapping
ROMix launches in a profiler capture, one launch a batch) is held in
``tests/test_torch_cuda.py``.
"""

import contextlib
import hashlib

import pytest
import torch

from spacemesh_tpu_torch import device
from spacemesh_tpu_torch.ops import pow as k2pow
from spacemesh_tpu_torch.ops import romix_cuda
from spacemesh_tpu_torch.post import initializer
from spacemesh_tpu_torch.post.prover import ProofParams, Prover
from spacemesh_tpu_torch.runtime import TenantScheduler, engine
from spacemesh_tpu_torch.utils import metrics

T = 10.0  # seconds any single wait may take
CUDA = torch.device("cuda")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test process (tier-1 runs files in parallel
    workers; torch's default pool oversubscribes the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Cuda:
    """Stand-ins for the torch.cuda calls the ring makes, with a log."""

    def __init__(self, monkeypatch):
        self.log: list = []
        self.busy = True  # what an event's query() reads: still running
        self.caller = _Stream(self, "caller")
        self.current = self.caller
        self.made = 0
        cuda = self

        class Event:
            def record(self, stream):
                self.stream = stream
                cuda.log.append(("record", stream.name))

            def query(self):
                return not cuda.busy

        def make_stream(_device):
            cuda.made += 1
            return _Stream(cuda, "s%d" % (cuda.made - 1))

        @contextlib.contextmanager
        def stream(s):
            prev, cuda.current = cuda.current, s
            try:
                yield
            finally:
                cuda.current = prev

        monkeypatch.setattr(torch.cuda, "Stream", make_stream)
        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "stream", stream)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda _device=None: cuda.current)


class _Stream:
    def __init__(self, cuda, name):
        self.cuda, self.name = cuda, name

    def wait_stream(self, other):
        self.cuda.log.append(("wait_stream", self.name, other.name))

    def wait_event(self, event):
        self.cuda.log.append(("wait_event", self.name, event.stream.name))


class _Tensor:
    device = CUDA

    def __init__(self, cuda):
        self.cuda = cuda

    def record_stream(self, stream):
        self.cuda.log.append(("record_stream", stream.name))


def test_batches_alternate_and_each_stream_joins_the_caller_once(
        monkeypatch):
    cuda = _Cuda(monkeypatch)
    ring = device.StreamRing(CUDA, 2)
    assert ring.size == 2 and cuda.made == 2
    seen, flags = [], []
    for k in range(5):
        cuda.busy = k != 3  # the previous batch had finished at the 4th
        with ring.batch() as overlapped:
            seen.append(cuda.current.name)
            flags.append(overlapped)
    assert seen == ["s0", "s1", "s0", "s1", "s0"]
    # the first batch has no previous one; the 4th found it finished
    assert flags == [False, True, True, False, True]
    joins = [e for e in cuda.log if e[0] == "wait_stream"]
    assert joins == [("wait_stream", "s0", "caller"),
                     ("wait_stream", "s1", "caller")]
    assert [e for e in cuda.log if e[0] == "record"] == [
        ("record", s) for s in seen]
    assert cuda.current is cuda.caller
    cuda.log.clear()
    ring.close()
    assert cuda.log == [("wait_stream", "caller", "s0"),
                        ("wait_stream", "caller", "s1")]


def test_a_ring_of_one_keeps_the_callers_stream(monkeypatch):
    cuda = _Cuda(monkeypatch)
    for ring in (device.StreamRing(CUDA, 1),
                 device.StreamRing(torch.device("cpu"), 2)):
        assert ring.size == 1
        for _ in range(3):
            with ring.batch() as overlapped:
                assert cuda.current is cuda.caller and not overlapped
        ring.close()
    assert cuda.made == 0 and cuda.log == []


def test_the_carry_waits_only_across_streams(monkeypatch):
    cuda = _Cuda(monkeypatch)
    ring = device.StreamRing(CUDA, 2)
    carry = device.Handoff(_Tensor(cuda))  # made on the caller's stream
    taken = []
    for _ in range(3):
        with ring.batch():
            cuda.log.clear()
            assert isinstance(carry.take(), _Tensor)
            taken.append(list(cuda.log))
            carry.put(_Tensor(cuda))
    # the caller's first carry and each later one come from the other
    # stream: wait for it there, and keep its memory from reuse
    assert taken == [
        [("wait_event", s, made), ("record_stream", s)]
        for s, made in (("s0", "caller"), ("s1", "s0"), ("s0", "s1"))]
    # taken on the stream that made it: no wait, no record
    cuda.log.clear()
    with torch.cuda.stream(cuda.caller):
        same = device.Handoff(_Tensor(cuda))
        cuda.log.clear()
        same.take()
    assert cuda.log == []


def test_a_cpu_carry_needs_no_event():
    t = torch.zeros(6, dtype=torch.int32)
    h = device.Handoff(t)
    assert h.take() is t
    h.put(t + 1)
    assert torch.equal(h.take(), t + 1)


@pytest.mark.parametrize("spare,streams", [(0, 2), (1000, 2), (-1, 1)])
def test_two_streams_only_when_two_batches_v_fit(monkeypatch, spare,
                                                 streams):
    _Cuda(monkeypatch)
    lanes, n = 32768, 8192
    asked = []

    def fit(n_, dev):
        asked.append((n_, dev))
        return 2 * lanes + spare

    monkeypatch.setattr(romix_cuda, "lanes_that_fit", fit)
    assert device.label_ring(CUDA, lanes, n).size == streams
    assert asked == [(n, CUDA)]


def test_the_cpu_takes_one_stream_without_asking_the_card(monkeypatch):
    def fit(*_a):
        raise AssertionError("no card to ask")

    monkeypatch.setattr(romix_cuda, "lanes_that_fit", fit)
    assert device.label_ring(torch.device("cpu"), 4096, 16).size == 1


# --- the engine's counter and gauge --------------------------------------


def _streams(kind):
    return metrics.runtime_pipeline_streams.sample().get((("kind", kind),))


def _overlapped(kind, tenant):
    return metrics.runtime_overlapped.sample().get(
        (("kind", kind), ("tenant", tenant)), 0)


class _FakeRing:
    size = 2

    def __init__(self, flags):
        self.flags = list(flags)
        self.closed = 0
        self.inside = []

    @contextlib.contextmanager
    def batch(self):
        self.inside.append(True)
        yield self.flags.pop(0)
        self.inside[-1] = False

    def close(self):
        self.closed += 1


def test_engine_counts_overlapped_batches_and_sets_the_gauge():
    built, dispatched_inside = [], []
    ring = _FakeRing([False, True, True, False, True])

    def ring_for(item):
        built.append(item)
        return ring

    def dispatch(item):
        dispatched_inside.append(ring.inside[-1])
        return item

    before = _overlapped("t-ring", "alice")
    pipe = engine.Pipeline(kind="t-ring", tenant="alice", inflight=2,
                           ring=ring_for, span="t")
    pipe.run(range(5), dispatch, lambda t: None)
    assert built == [0] and pipe.ring is ring and ring.closed == 1
    assert dispatched_inside == [True] * 5
    assert _overlapped("t-ring", "alice") == before + 3
    assert _streams("t-ring") == 2
    metrics.runtime_pipeline_streams.set(7, kind="t-ring")
    engine.Pipeline(kind="t-ring").run(range(2), lambda i: i,
                                       lambda t: None)
    assert _streams("t-ring") == 1


def test_one_stream_on_the_cpu_for_init_and_the_packer(tmp_path):
    geom = dict(num_units=1, labels_per_unit=96, scrypt_n=2,
                max_file_size=1 << 12)
    for kind in ("init", "init_pack"):
        metrics.runtime_pipeline_streams.set(7, kind=kind)
    before = {k: _overlapped(*k) for k in (("init", "solo"),
                                           ("init_pack", "*"))}
    initializer.initialize(tmp_path / "solo", batch_size=32, device="cpu",
                           node_id=b"n" * 32, commitment=b"c" * 32,
                           tenant="solo", **geom)
    with TenantScheduler(pack_lanes=32, autostart=False,
                         device="cpu") as s:
        s.register_tenant("t0")
        h = s.submit_init("t0", tmp_path / "t0", node_id=b"m" * 32,
                          commitment=b"d" * 32, **geom)
        s.start()
        h.result(timeout=T)
    assert _streams("init") == 1 and _streams("init_pack") == 1
    assert {k: _overlapped(*k) for k in before} == before


def test_the_prover_and_k2pow_keep_one_stream(tmp_path):
    for kind in ("prove", "k2pow"):
        metrics.runtime_pipeline_streams.set(7, kind=kind)
    initializer.initialize(tmp_path, node_id=b"p" * 32,
                           commitment=b"q" * 32, num_units=1,
                           labels_per_unit=256, scrypt_n=2,
                           max_file_size=1 << 12, batch_size=128,
                           device="cpu")
    params = ProofParams(k1=64, k2=8, k3=4,
                         pow_difficulty=b"\x20" + b"\xff" * 31)
    Prover(tmp_path, params, batch_labels=128, device="cpu").prove(
        hashlib.sha256(b"ring-prove").digest())
    assert _streams("prove") == 1
    metrics.runtime_pipeline_streams.set(7, kind="k2pow")
    k2pow.search(b"a" * 32, b"b" * 32, b"\x40" + b"\xff" * 31,
                 batch=256, max_batches=4, device="cpu")
    assert _streams("k2pow") == 1
