"""The port's node infrastructure (``spacemesh_tpu_torch/node/{events,
clock,config,checkpoint}.py``), its sixteen-identity node, and the event
bus through health and remediation, against the JAX package's.

The cases of ``tests/test_node_infra.py``, the checkpoint cases of
``tests/test_malfeasance_checkpoint.py`` and ``tests/test_sixteen_identities.py``
run on the port through ``torch_twin`` (their imports name the port,
every component that defaults to the card is built with
``device="cpu"``).
"""

from torch_twin import export

export("test_node_infra", globals())
export("test_malfeasance_checkpoint", globals(),
       only=("test_checkpoint_roundtrip", "test_checkpoint_version_check"))
export("test_sixteen_identities", globals())


# --- the entry points: the card by default, the stubs, the CLI ----------

import asyncio  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import pytest  # noqa: E402
import torch  # noqa: E402

from spacemesh_tpu_torch.node import __main__ as node_cli  # noqa: E402
from spacemesh_tpu_torch.node.app import App  # noqa: E402
from spacemesh_tpu_torch.node.config import load  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"layer_duration": 0.7, "layers_per_epoch": 3, "slots_per_layer": 2,
        "post": {"labels_per_unit": 256, "scrypt_n": 2, "k1": 64, "k2": 8,
                 "k3": 4, "min_num_units": 1,
                 "pow_difficulty": "20" + "ff" * 31},
        "smeshing": {"start": True, "num_units": 1, "init_batch": 128},
        "hare": {"committee_size": 20, "round_duration": 0.06,
                 "preround_delay": 0.06, "iteration_limit": 2},
        "beacon": {"proposal_duration": 0.05},
        "tortoise": {"hdist": 4, "window_size": 50}}


def _cfg(tmp_path, **extra):
    return load("standalone", overrides={
        **TINY, "data_dir": str(tmp_path / "node"), **extra})


def test_app_defaults_to_the_card_and_raises_without_one(monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        App(_cfg(tmp_path))
    # nothing was opened: the device resolves before any store
    assert not (tmp_path / "node").exists()


def test_waiting_entry_points_raise_not_implemented(tmp_path):
    app = App(_cfg(tmp_path), device="cpu")
    try:
        for call, item in ((app.start_network, "item 6"),
                           (app.start_api, "item 5"),
                           (app.start_grpc_api, "item 5"),
                           (app.start_public_grpc_api, "item 5")):
            with pytest.raises(NotImplementedError, match=item):
                asyncio.run(call())
    finally:
        app.close()
    grpc = App(_cfg(tmp_path / "g", smeshing={
        "start": True, "num_units": 1, "init_batch": 128,
        "external_worker": True, "worker_grpc": True}), device="cpu")
    try:
        with pytest.raises(NotImplementedError, match="item 5"):
            asyncio.run(grpc.start_smeshing())
        assert grpc.post_supervisor is None
    finally:
        grpc.close()


@pytest.mark.parametrize("flags", [["--api"], ["--grpc"],
                                   ["--listen", "127.0.0.1:0"]])
def test_cli_waiting_flags_exit_nonzero(tmp_path, capsys, flags):
    rc = node_cli.main(["--preset", "standalone", "--device", "cpu",
                        "--data-dir", str(tmp_path / "n"), *flags])
    assert rc == 2
    assert "ROADMAP item" in capsys.readouterr().err


def test_cli_without_a_card_exits_with_the_device_error(monkeypatch,
                                                        tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = node_cli.main(["--preset", "standalone",
                        "--data-dir", str(tmp_path / "n")])
    assert rc == 2
    assert "cuda" in capsys.readouterr().err


def test_cli_runs_a_standalone_node_on_the_cpu(tmp_path):
    """``python -m spacemesh_tpu_torch.node`` on the real clock: POST
    init, an ATX per epoch, layers applied past epoch 0."""
    conf = tmp_path / "node.json"
    conf.write_text(json.dumps(TINY))
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "OMP_NUM_THREADS": "1"}
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "spacemesh_tpu_torch.node", "--preset",
         "standalone", "--config", str(conf), "--data-dir",
         str(tmp_path / "n"), "--genesis-now", "--until-layer", "8",
         "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    events = [json.loads(line) for line in out.stdout.splitlines()
              if line.startswith("{")]
    kinds = [e["event"] for e in events]
    assert kinds[:2] == ["PostEvent", "PostEvent"]
    assert "AtxPublished" in kinds
    assert any(e["event"] == "LayerUpdate" and e["status"] == "applied"
               and e["layer"] >= TINY["layers_per_epoch"]
               for e in events), kinds
    assert time.monotonic() - t0 < 240
