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


# --- the entry points: the card by default, the seams served, the CLI ----

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


# every listener on an ephemeral port: the preset's API ports are fixed
# (9092/9093), and other test files bind them under xdist
EPHEMERAL = {"api": {"private_listener": "127.0.0.1:0",
                     "public_listener": "127.0.0.1:0"}}


def _cfg(tmp_path, **extra):
    return load("standalone", overrides={
        **TINY, **EPHEMERAL, "data_dir": str(tmp_path / "node"), **extra})


def test_app_defaults_to_the_card_and_raises_without_one(monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        App(_cfg(tmp_path))
    # nothing was opened: the device resolves before any store
    assert not (tmp_path / "node").exists()


async def _serves_api(app):
    import aiohttp

    port = await app.start_api()
    try:
        async with aiohttp.ClientSession() as http:
            async with http.get(
                    f"http://127.0.0.1:{port}/v1/node/status") as resp:
                assert resp.status == 200
                body = await resp.json()
        assert body["status"]["is_synced"] is True
        assert body["status"]["connected_peers"] == 0
    finally:
        await app.api.stop()


async def _grpc_call(port, service, method, req, resp_cls):
    import grpc

    async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
        call = ch.unary_unary(f"/spacemesh.v1.{service}/{method}",
                              request_serializer=type(req).SerializeToString,
                              response_deserializer=resp_cls.FromString)
        return await call(req)


async def _serves_grpc(app):
    from spacemesh_tpu_torch.api.gen import core_pb2 as cpb

    port = await app.start_grpc_api()
    try:
        st = await _grpc_call(port, "NodeService", "Status",
                              cpb.StatusRequest(), cpb.StatusResponse)
        assert st.status.is_synced
        # the private listener serves the Admin and PostService seams too
        assert app.grpc_api.post_service is not None
    finally:
        await app.stop_grpc_api()


async def _serves_public_grpc(app):
    import grpc

    from spacemesh_tpu_torch.api.gen import core_pb2 as cpb

    port = await app.start_public_grpc_api()
    try:
        echo = await _grpc_call(port, "NodeService", "Echo",
                                cpb.EchoRequest(msg="hi"), cpb.EchoResponse)
        assert echo.msg == "hi"
        with pytest.raises(grpc.aio.AioRpcError) as e:
            await _grpc_call(port, "AdminService", "Recover",
                             cpb.RecoverRequest(uri="x"),
                             cpb.RecoverResponse)
        assert e.value.code() == grpc.StatusCode.UNIMPLEMENTED
        assert app.grpc_public_api.post_service is None
    finally:
        await app.stop_grpc_api()


async def _serves_network(app, tmp_path):
    host, port = await app.start_network()
    assert port > 0
    # one network: the genesis id hashes the genesis time
    peer = App(_cfg(tmp_path / "peer", smeshing={"start": False},
                    genesis={"time": app.cfg.genesis.time},
                    p2p={"listen": "127.0.0.1:0",
                         "bootnodes": [f"{host}:{port}"]}), device="cpu")
    try:
        await peer.start_network()
        for _ in range(200):
            if (app.signer.node_id in peer.server.peers()
                    and peer.signer.node_id in app.server.peers()):
                break
            await asyncio.sleep(0.05)
        assert peer.signer.node_id in app.server.peers()
        assert app.signer.node_id in peer.server.peers()
    finally:
        await peer.stop_network()
        peer.close()
        await app.stop_network()
    assert app.host is None


async def _serves_worker_grpc(app):
    from spacemesh_tpu_torch.api.rpc import GrpcPostClient

    try:
        await app.start_smeshing()
        assert app.grpc_api.post_service.registered() == \
            [s.node_id for s in app.signers]
        assert app.post_supervisor.device == "cpu"
        for b in app.atx_builders:
            assert isinstance(b.post_client, GrpcPostClient)
        info = await asyncio.to_thread(app.atx_builders[0].post_client.info)
        assert info.node_id == app.signer.node_id
    finally:
        app.post_supervisor.stop()
        await app.stop_grpc_api()


@pytest.mark.parametrize("entry", ["start_api", "start_grpc_api",
                                   "start_public_grpc_api", "start_network",
                                   "worker_grpc"])
def test_entry_points_serve(tmp_path, entry):
    """Each outward entry point of ``App`` serves: the JSON API answers
    ``/v1/node/status``, the private gRPC listener ``NodeService.Status``,
    the public one refuses ``AdminService``, ``start_network`` binds and a
    second ``App`` connects, and ``start_smeshing`` with
    ``smeshing.worker_grpc`` registers every identity over the worker's
    Register stream."""
    smeshing = {"start": False}
    if entry == "worker_grpc":
        smeshing = {"start": True, "num_units": 1, "init_batch": 128,
                    "external_worker": True, "worker_grpc": True}
    # genesis a minute ahead: a syncer never walks layers since 1970
    app = App(_cfg(tmp_path, smeshing=smeshing,
                   genesis={"time": float(int(time.time()) + 60)},
                   p2p={"listen": "127.0.0.1:0"}),
              device="cpu")
    run = {"start_api": lambda: _serves_api(app),
           "start_grpc_api": lambda: _serves_grpc(app),
           "start_public_grpc_api": lambda: _serves_public_grpc(app),
           "start_network": lambda: _serves_network(app, tmp_path),
           "worker_grpc": lambda: _serves_worker_grpc(app)}[entry]
    try:
        asyncio.run(run())
    finally:
        app.close()


@pytest.mark.parametrize("flags", [["--api"], ["--grpc"],
                                   ["--listen", "127.0.0.1:0"],
                                   ["--api", "--grpc", "--listen",
                                    "127.0.0.1:0"]])
def test_cli_serving_flags(tmp_path, capsys, flags):
    """``--api``, ``--grpc`` and ``--listen`` each print the bound port as
    a JSON line before the node prepares, and the node exits 0 at
    ``--until-layer``."""
    conf = tmp_path / "node.json"
    conf.write_text(json.dumps({**TINY, **EPHEMERAL,
                                "smeshing": {"start": False}}))
    rc = node_cli.main(["--preset", "standalone", "--device", "cpu",
                        "--config", str(conf), "--data-dir",
                        str(tmp_path / "n"), "--genesis-now",
                        "--until-layer", "1", *flags])
    assert rc == 0
    events = {}
    for line in capsys.readouterr().out.splitlines():
        if line.startswith("{"):
            ev = json.loads(line)
            events.setdefault(ev["event"], ev)
    want = {"--api": "ApiStarted", "--grpc": "GrpcStarted",
            "--listen": "P2PStarted"}
    for flag, name in want.items():
        if flag in flags:
            assert events[name]["port"] > 0, events
        else:
            assert name not in events


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
