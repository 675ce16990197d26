"""``spacemesh_tpu_torch.tools.warmcache`` and the profiler's ``--warm``
view, on the CPU.

Cold then warm in one cache root (``SPACEMESH_TORCH_CACHE``), racing on:
the cold run races once for its N and persists a winner per batch; the
warm run, a new process on the same root, races nothing and reads the
same winners. The contract is asserted on counts, not on a wall-clock
ratio (the JAX ``test_warmcache_cold_then_warm``'s timing bound is this
repo's one known intermittent tier-1 test). Without a card nothing is
built (the kernel libraries build only for the card).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from spacemesh_tpu_torch.ops import autotune
from spacemesh_tpu_torch.parallel import topology

ARGS = ["--device", "cpu", "--n", "2", "--batches", "64,32",
        "--pack-lanes", "64", "--no-probe"]


def _run(root, *extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               SPACEMESH_TORCH_CACHE=str(root),
               SPACEMESH_ROMIX_AUTOTUNE="on")
    env.pop("SPACEMESH_MESH", None)
    r = subprocess.run(
        [sys.executable, "-m", "spacemesh_tpu_torch.tools.warmcache",
         *ARGS, *extra], env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout)


def test_warmcache_cold_then_warm(tmp_path):
    cold = _run(tmp_path)
    assert cold["platform"] == "cpu" and cold["races"] == 1
    assert cold["built"] == [] and cold["compile_s"] == {}
    assert cold["autotune_cache"] == str(tmp_path / "romix_autotune.json")
    assert [(s["n"], s["batch"]) for s in cold["shapes"]] == [(2, 32),
                                                              (2, 64)]
    assert all(set(s["programs"]) == {"labels_fused", "labels_min_fused"}
               and s["impl"] == "plain" for s in cold["shapes"])
    assert set(cold["runtime_kinds"]) == {
        "init", "init_pack", "prove_scan", "verify", "k2pow",
        "k2pow_verify"}
    doc = json.loads((tmp_path / "romix_autotune.json").read_text())
    for b in (32, 64):
        assert doc[autotune._key("cpu", 2, b)]["impl"] == "plain"

    warm = _run(tmp_path, "--prove", "--cached-shapes", "--no-runtime")
    assert warm["races"] == 0 and warm["built"] == []
    assert [(s["impl"], s["chunk"]) for s in warm["shapes"]] \
        == [(s["impl"], s["chunk"]) for s in cold["shapes"]]
    assert warm["prove"]["batch"] == 1 << 14
    assert "runtime_kinds" not in warm


def test_warmcache_without_a_card_exits_2(tmp_path):
    env = dict(os.environ, SPACEMESH_TORCH_CACHE=str(tmp_path),
               CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "-m", "spacemesh_tpu_torch.tools.warmcache"],
        env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 2 and r.stdout == ""
    assert "device='cuda'" in r.stderr


@pytest.fixture
def tuner(tmp_path, monkeypatch):
    monkeypatch.setenv(autotune.ENV_CACHE, str(tmp_path))
    for var in (autotune.ENV_IMPL, autotune.ENV_CHUNK, autotune.ENV_MESH,
                autotune.ENV_AUTOTUNE):
        monkeypatch.delenv(var, raising=False)
    autotune.reset_memo()
    topology.reset()
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tmp_path
    torch.set_num_threads(old)
    autotune.reset_memo()


def test_profiler_warm_and_romix_views(tuner, capsys):
    """The profiler's ``--warm`` is warmcache's document; ``--romix``
    lists the stage-timed row, then the raced rows with the winner."""
    from spacemesh_tpu_torch.tools import profiler

    assert profiler.main(["--device", "cpu", "--warm", "--n", "2",
                          "--warm-batches", "16", "--warm-prove"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["races"] == 1 and doc["prove"]["batch"] == 1 << 14
    assert [s["batch"] for s in doc["shapes"]] == [16]
    assert profiler.main(["--device", "cpu", "--romix", "--n", "2",
                          "--romix-batch", "16", "--reps", "1"]) == 0
    doc = json.loads(capsys.readouterr().out)
    staged, *raced = doc["impls"]
    assert staged["impl"] == "plain" and "stages" in staged
    assert [(r["chunk"], r["devices"], r["winner"]) for r in raced] \
        == [(None, 1, True)]
    assert raced[0]["labels_per_sec"] > 0
    assert doc["decision"]["tuned"]["source"] == "race"
