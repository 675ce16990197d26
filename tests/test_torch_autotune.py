"""The port's ROMix autotuner (``spacemesh_tpu_torch/ops/autotune.py``)
held to the JAX package's.

The JAX tests whose bodies name no JAX symbol run on the port through
``torch_twin``'s ``export`` (``only=``), under this file's ``tuner``
fixture: a fresh cache root in ``tmp_path`` (``SPACEMESH_TORCH_CACHE``),
racing on, no overrides, eight ``cpu`` stripes visible. The rest are the
port's counterparts: the precedence env > winner > race > default, the
pure helpers against the JAX functions on the same inputs, and the
deliberate differences (a failing candidate raises and writes nothing;
the JAX implementation names raise; the plain twin never races on a CUDA
tensor). Races on the CPU run the plain twin at N=2/16.
"""

import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

import tests.torch_twin as torch_twin
from spacemesh_tpu.ops import autotune as jautotune
from spacemesh_tpu_torch.ops import autotune, romix_cuda, scrypt
from spacemesh_tpu_torch.parallel import topology

N = 16

torch_twin.export("test_romix_autotune", globals(), only={
    "test_race_on_miss_then_cache_hit", "test_corrupt_cache_ignored",
    "test_autotune_off_uses_default", "test_bad_env_values_rejected",
    "test_garbage_cache_entry_ignored"},
    drop=["from spacemesh_tpu.ops import romix_pallas as rp\n"])
torch_twin.export("test_mesh_autotune", globals(), only={
    "test_mesh_off_holds_through_the_race_path"})
torch_twin.export("test_topology", globals(), only={
    "test_shape_winner_rejects_unknown_shape"})


@pytest.fixture
def tuner(tmp_path, monkeypatch):
    """Fresh autotune world: a private cache root, racing on, no
    overrides, no memoized measurements, eight ``cpu`` stripes. Yields
    the winners file's path."""
    monkeypatch.setenv(autotune.ENV_CACHE, str(tmp_path))
    for var in (autotune.ENV_IMPL, autotune.ENV_CHUNK, autotune.ENV_MESH,
                autotune.ENV_AUTOTUNE):
        monkeypatch.delenv(var, raising=False)
    autotune.reset_memo()
    topology.reset(["cpu"] * 8)
    yield pathlib.Path(autotune.cache_path())
    autotune.reset_memo()
    topology.reset()


def _seed(path, key, impl="plain", chunk=None, devices=1, rate=123.0):
    doc = json.loads(path.read_text()) if path.exists() else {}
    entry = {"impl": impl, "chunk": chunk, "labels_per_sec": rate}
    if devices != 1:
        entry["devices"] = devices
    doc[key] = entry
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc))
    autotune.reset_memo()


# --- precedence: env > winner > race > default ----------------------------


def test_precedence_env_winner_race_default(tuner, monkeypatch):
    # no winner, racing off: the default
    monkeypatch.setenv(autotune.ENV_AUTOTUNE, "off")
    assert autotune.decide(N, 64, platform="cpu").source == "default"
    assert not tuner.exists(), "default decisions are not persisted"
    # racing on: a race, persisted
    monkeypatch.delenv(autotune.ENV_AUTOTUNE)
    autotune.reset_memo()
    d = autotune.decide(N, 64, platform="cpu")
    assert (d.impl, d.source) == ("plain", "race")
    key = autotune._key("cpu", N, 64)
    assert json.loads(tuner.read_text())[key]["impl"] == "plain"
    # a persisted winner beats a race
    _seed(tuner, key, chunk=16)
    d = autotune.decide(N, 64, platform="cpu")
    assert (d.chunk, d.source) == (16, "cache")
    # the environment beats the winner; an env impl equal to the cached
    # one takes the cached chunk
    monkeypatch.setenv(autotune.ENV_IMPL, "plain")
    d = autotune.decide(N, 64, platform="cpu")
    assert (d.impl, d.chunk, d.source) == ("plain", 16, "env")
    monkeypatch.setenv(autotune.ENV_CHUNK, "8")
    assert autotune.decide(N, 64, platform="cpu").chunk == 8
    monkeypatch.setenv(autotune.ENV_CHUNK, "off")
    assert autotune.decide(N, 64, platform="cpu").chunk is None
    monkeypatch.setenv(autotune.ENV_CHUNK, "64")  # as wide as the batch
    assert autotune.decide(N, 64, platform="cpu").chunk is None


def test_forced_mesh_device_count_beats_cached_winner(tuner, monkeypatch):
    monkeypatch.setenv(autotune.ENV_AUTOTUNE, "off")
    _seed(tuner, autotune._key("cpu", N, 256, autotune._device_cap(None)),
          devices=8)
    d = autotune.decide(N, 256, platform="cpu", max_devices=None)
    assert (d.devices, d.source) == (8, "cache")
    monkeypatch.setenv(autotune.ENV_MESH, "2")
    d = autotune.decide(N, 256, platform="cpu", max_devices=None)
    assert (d.devices, d.source) == (2, "env")
    monkeypatch.setenv(autotune.ENV_MESH, "off")
    assert autotune.decide(N, 256, platform="cpu",
                           max_devices=None).devices == 1
    # the per-batch dispatch's cap-1 lookup never stripes
    monkeypatch.delenv(autotune.ENV_MESH)
    assert autotune.decide(N, 256, platform="cpu").devices == 1
    devs, d = autotune.resolve_auto_mesh(N, 256, platform="cpu")
    assert [str(x) for x in devs] == ["cpu"] * 8 and d.devices == 8


def test_resolve_auto_mesh_on_cards_takes_every_card(tuner, monkeypatch):
    """On a card platform the JAX package's whole-mesh default: every
    visible card, so none with one card, whatever a winner says;
    SPACEMESH_MESH forces a count or turns it off. (Device lists only: no
    card is touched.)"""
    monkeypatch.setenv(autotune.ENV_AUTOTUNE, "off")
    topology.reset(["cuda:0"])
    _seed(tuner, autotune._key("cuda", N, 256), devices=4, impl="cuda")
    devs, d = autotune.resolve_auto_mesh(N, 256)
    assert devs is None and d.impl == "cuda"
    topology.reset(["cuda:0", "cuda:1", "cuda:2", "cuda:3"])
    devs, _ = autotune.resolve_auto_mesh(N, 256)
    assert [str(x) for x in devs] == [f"cuda:{i}" for i in range(4)]
    monkeypatch.setenv(autotune.ENV_MESH, "2")
    assert len(autotune.resolve_auto_mesh(N, 256)[0]) == 2
    monkeypatch.setenv(autotune.ENV_MESH, "off")
    assert autotune.resolve_auto_mesh(N, 256)[0] is None
    # a caller on the CPU beside cards stays on one device
    monkeypatch.delenv(autotune.ENV_MESH)
    assert autotune.resolve_auto_mesh(N, 256, platform="cpu")[0] is None


# --- the helpers against the JAX functions ----------------------------------


def _rows(*rates_devices):
    return [{"impl": "x", "chunk": None, "devices": d, "labels_per_sec": r}
            for r, d in rates_devices]


_HELPER_CASES = [
    ("mesh_candidates", (8,), None), ("mesh_candidates", (3,), None),
    ("mesh_candidates", (1,), None), ("mesh_candidates", (16, 4), None),
    ("chunk_candidates", (8192, 32768), None),
    ("chunk_candidates", (8192, 512), None),
    ("chunk_candidates", (2, 512), None),
    ("chunk_candidates", (1024, 4096), None),
    ("_select_winner", (_rows((69.0, 8), (67.0, 4), (59.0, 1)),), None),
    ("_select_winner", (_rows((69.0, 8), (67.0, 4), (66.0, 1)),), None),
    ("_select_winner", (_rows((69.0, 8), (30.0, 4), (30.0, 1)),), None),
    ("_select_winner", (_rows((50.0, 2), (51.0, 2)),), None),
] + [("read_mesh_env", (), env)
     for env in (None, "auto", "off", "0", "3", "on", "1", "lots", "-2")]


@pytest.mark.parametrize(
    "name,args,env", _HELPER_CASES,
    ids=[f"{name}-{i}" for i, (name, _, _) in enumerate(_HELPER_CASES)])
def test_helpers_equal_jax(monkeypatch, name, args, env):
    """The pure pieces of the decision give the JAX package's answers on
    the same inputs: the mesh and chunk grids, the noise-band winner, and
    ``read_mesh_env`` under every spelling of ``SPACEMESH_MESH`` (``on``
    counts the visible devices: eight on both sides here)."""
    if env is None:
        monkeypatch.delenv(autotune.ENV_MESH, raising=False)
    else:
        monkeypatch.setenv(autotune.ENV_MESH, env)
    topology.reset(["cpu"] * 8)
    try:
        outs = []
        for mod in (jautotune, autotune):
            try:
                outs.append(("ok", getattr(mod, name)(*args)))
            except ValueError as exc:
                outs.append(("raise", str(exc)))
    finally:
        topology.reset()
    assert outs[0] == outs[1]


def test_candidates_are_the_non_tpu_branch(tuner):
    """The grid: the unchunked kernel, each JAX chunk candidate below the
    calibration batch, and one unchunked row per mesh count."""
    assert autotune.candidates("cuda", 8192, autotune.CUDA_CAL_BATCH) == [
        ("cuda", None, 1), ("cuda", 256, 1)]
    assert autotune.candidates("cpu", N, autotune.CAL_BATCH, mesh_cap=8) \
        == [("plain", None, 1), ("plain", None, 2), ("plain", None, 4),
            ("plain", None, 8)]
    jgrid = jautotune.candidates("gpu", 8192, 32768)
    assert [(c, d) for _, c, d in jgrid] == [
        (c, d) for _, c, d in autotune.candidates("cuda", 8192, 32768)]


# --- the deliberate differences ---------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "xla-rows", "pallas"])
def test_jax_implementation_names_raise(tuner, monkeypatch, impl):
    monkeypatch.setenv(autotune.ENV_IMPL, impl)
    with pytest.raises(ValueError, match="cuda, plain"):
        autotune.read_env()
    with pytest.raises(ValueError, match="SPACEMESH_ROMIX"):
        autotune.decide(N, 64, platform="cpu")
    with pytest.raises(ValueError, match="SPACEMESH_ROMIX"):
        scrypt.scrypt_labels(bytes(32), np.arange(3, dtype=np.uint64), n=2,
                             device="cpu")


def test_plain_twin_never_races_or_runs_on_a_card(tuner, monkeypatch):
    """The card's grid has only the kernel; a plain row for a card (or a
    kernel row for the CPU) is refused before anything is placed; the
    plain twin named for the card raises."""
    assert all(impl == "cuda" for impl, _, _ in
               autotune.candidates("cuda", N, autotune.CUDA_CAL_BATCH, 8))
    with pytest.raises(ValueError, match="cannot run on cuda"):
        autotune._race_rows("cuda", N, [("plain", None, 1)], lanes=8)
    with pytest.raises(ValueError, match="cannot run on cpu"):
        autotune._race_rows("cpu", N, [("cuda", None, 1)], lanes=8)
    monkeypatch.setenv(autotune.ENV_IMPL, "plain")
    with pytest.raises(ValueError, match="cannot run on cuda"):
        autotune.decide(N, 64, platform="cuda")


def test_failing_candidate_raises_and_writes_nothing(tuner, monkeypatch):
    """The counterpart of the JAX ``test_failed_race_candidates_not_
    retried``: every candidate is the same kernel, so a failure raises
    out of ``decide`` and neither a measurement nor a winner is
    persisted; with the failure gone, the next decide races afresh."""
    from spacemesh_tpu_torch.utils import metrics

    real = romix_cuda.romix

    def boom(x, n, **kw):
        if kw.get("max_lanes") is None and x.shape[1] == 8:
            raise RuntimeError("romix_r1_launch: CUDA error 700 at launch")
        return real(x, n, **kw)

    monkeypatch.setattr(romix_cuda, "romix", boom)
    monkeypatch.setattr(autotune, "cal_batch", lambda platform, n: 8)
    races = sum(metrics.post_romix_autotune_races.sample().values())
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        autotune.decide(N, 64, platform="cpu", max_devices=None)
    assert not tuner.exists(), "a failed race persisted something"
    assert sum(metrics.post_romix_autotune_races.sample().values()) \
        == races + 1
    monkeypatch.setattr(romix_cuda, "romix", real)
    d = autotune.decide(N, 64, platform="cpu", max_devices=None)
    assert d.source == "race"
    rows = json.loads(tuner.read_text())[autotune._meas_key("cpu", N)]
    assert {(r["chunk"], r["devices"]) for r in rows["raced"]} \
        == {(None, 1), (None, 2), (None, 4), (None, 8)}
    assert rows["cal_batch"] == 8


def test_shape_winner_and_legacy_entries(tuner, monkeypatch):
    """A winner file entry with no ``shape`` takes its impl's shape; an
    unknown shape (the JAX grid's ``vshard``) is refused."""
    monkeypatch.setenv(autotune.ENV_AUTOTUNE, "off")
    cap = autotune._device_cap(None)
    _seed(tuner, autotune._key("cpu", N, 512, cap), devices=4)
    d = autotune.decide(N, 512, platform="cpu", max_devices=None)
    assert (d.devices, d.mesh_shape, d.source) == (4, "lane", "cache")
    assert autotune.shape_winner(N, 512, "lane", platform="cpu",
                                 max_devices=None) is None  # never raced
    with pytest.raises(ValueError, match="mesh shape"):
        autotune.shape_winner(N, 512, "vshard", platform="cpu")
    monkeypatch.delenv(autotune.ENV_AUTOTUNE)
    autotune.reset_memo()
    autotune.race("cpu", N, 256, cap)
    lane = autotune.shape_winner(N, 256, "lane", platform="cpu",
                                 max_devices=None)
    assert lane is not None and lane.source == "cache"


# --- a real race, and labels under the decision -------------------------------


def test_real_race_of_the_plain_twin_labels_equal_hashlib(tuner):
    """One real race at N=2 (the plain twin over the calibration block,
    spans and counter), then the label entry point under its persisted
    winner, against hashlib."""
    from spacemesh_tpu_torch.utils import metrics, tracing

    races = sum(metrics.post_romix_autotune_races.sample().values())
    tracing.start()
    try:
        d = autotune.decide(2, 64, platform="cpu")
    finally:
        doc = tracing.export()
        tracing.stop()
    names = [e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert names.count("romix.race") == 1
    assert names.count("romix.race_candidate") == 1
    assert sum(metrics.post_romix_autotune_races.sample().values()) \
        == races + 1
    assert (d.impl, d.chunk, d.source) == ("plain", None, "race")
    commitment = hashlib.sha256(b"autotune-race").digest()
    got = scrypt.scrypt_labels(commitment, np.arange(64, dtype=np.uint64),
                               n=2, device="cpu")
    for i in (0, 31, 63):
        assert bytes(got[i]) == hashlib.scrypt(
            commitment, salt=int(i).to_bytes(8, "little"), n=2, r=1, p=1,
            dklen=16)


def test_chunked_labels_equal_hashlib(tuner, monkeypatch):
    """A forced lane chunk runs ROMix's plain twin over chunks, and the
    labels stay hashlib's."""
    monkeypatch.setenv(autotune.ENV_IMPL, "plain")
    monkeypatch.setenv(autotune.ENV_CHUNK, "4")
    calls = []
    real = romix_cuda.romix_r1
    monkeypatch.setattr(romix_cuda, "romix_r1",
                        lambda x, n, **kw: calls.append(x.shape[1])
                        or real(x, n, **kw))
    commitment = hashlib.sha256(b"autotune-e2e").digest()
    got = scrypt.scrypt_labels(commitment, np.arange(7, dtype=np.uint64),
                               n=N, device="cpu")
    assert calls == [4, 3]
    for i in (0, 3, 6):
        assert bytes(got[i]) == hashlib.scrypt(
            commitment, salt=int(i).to_bytes(8, "little"), n=N, r=1, p=1,
            dklen=16)

