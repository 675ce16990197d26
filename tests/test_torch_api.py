"""The port's JSON API (``spacemesh_tpu_torch/api/http.py``) against the
JAX package's.

The cases of ``tests/test_api.py`` and ``tests/test_http_debug.py`` run on
the port through ``torch_twin`` (their imports name the port, every
component that defaults to the card is built with ``device="cpu"``).
"""

import pytest

from torch_twin import export

export("test_api", globals())
export("test_http_debug", globals())


@pytest.fixture(scope="module", autouse=True)
def _ephemeral_api_listener():
    """The standalone preset's JSON API listens on the fixed 9093, which
    ``tests/test_api.py`` binds too, side by side under xdist: this file's
    twin of it serves on an ephemeral port (it reads the port back from
    ``start_api``)."""
    from spacemesh_tpu_torch.node import config

    real = config.PRESETS["standalone"]

    def standalone():
        c = real()
        c.api.private_listener = "127.0.0.1:0"
        return c

    config.PRESETS["standalone"] = standalone
    yield
    config.PRESETS["standalone"] = real


# --- one seeded node per package: every route's body equal --------------

import asyncio  # noqa: E402
import hashlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402


LPE = 3
LAYER_SEC = 2.0  # virtual seconds
UNTIL = 3 * LPE  # epochs 1 and 2 carry an ATX each

PKGS = ("spacemesh_tpu", "spacemesh_tpu_torch")

# Fields that differ by nature between the two nodes: the windowed SLI
# values in /readyz (each SLO's "value" and "burn", and the "slis" map)
# are quantiles and rates of host wall-clock timings (layer apply, farm
# queue wait, farm dispatch), which no two runs share; _timeless() blanks
# them and the rest of /readyz (readiness, components, each SLO's target,
# window, budget and verdict) is compared. Every other body holds no
# uptime, port or build string (NodeService.Build answers the same build
# name in both packages, both serve API_VERSION "v0.1.0") and is compared
# whole. Left out of the comparison on purpose: /debug/stacks and
# /debug/profile (thread dumps and profiles of two processes' code),
# /debug/trace/* (the capture's bridge key is "torch_bridge" on the port,
# "jax_bridge" on the JAX package) and /metrics (each package's registry
# holds its own instruments); tests/test_torch_api.py's twins of
# test_http_debug.py cover those routes.


def _timeless(status_body):
    status, body = status_body
    doc = json.loads(body)
    for slo in doc.get("slos", {}).values():
        slo["value"] = slo["burn"] = None
    doc["slis"] = {k: None for k in doc.get("slis", {})}
    return status, doc


def _cfg(pkg, tmp):
    load = importlib.import_module(f"{pkg}.node.config").load
    return load("standalone", overrides={
        "data_dir": str(tmp / pkg),
        "layer_duration": LAYER_SEC,
        "layers_per_epoch": LPE,
        "slots_per_layer": 2,
        "genesis": {"time": 0.0},
        "post": {"labels_per_unit": 256, "scrypt_n": 2, "k1": 64, "k2": 8,
                 "k3": 4, "min_num_units": 1,
                 "pow_difficulty": "20" + "ff" * 31},
        "smeshing": {"start": True, "num_units": 1, "init_batch": 128},
        "hare": {"committee_size": 20, "round_duration": 0.2,
                 "preround_delay": 0.5, "iteration_limit": 2},
        "beacon": {"proposal_duration": 0.2},
        "tortoise": {"hdist": 4, "window_size": 50},
    })


def _run_node(pkg, tmp):
    """A smeshing standalone node on ``pkg``'s virtual clock, run to
    layer UNTIL; returns the App with its clock frozen at that time."""
    mod = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    vclock = mod("utils.vclock")
    cfg = _cfg(pkg, tmp)
    loop = vclock.VirtualClockLoop()
    signer = mod("core.signing").EdSigner(
        seed=hashlib.sha256(b"api-parity").digest(),
        prefix=cfg.genesis.genesis_id)
    kw = {"device": "cpu"} if pkg == "spacemesh_tpu_torch" else {}
    app = mod("node.app").App(cfg, signer=signer, time_source=loop.time,
                              **kw)

    async def go():
        await app.prepare()
        app.clock = mod("node.clock").LayerClock(
            loop.time() + 1.0, LAYER_SEC, time_source=loop.time)
        await app.run(until_layer=UNTIL)

    try:
        loop.run_until_complete(asyncio.wait_for(go(), 10_000))
    finally:
        loop.run_until_complete(vclock.cancel_all_tasks())
        loop.close()
    return app


async def _json_bodies(pkg, app, tmp) -> dict:
    """Every JSON route of the node's ApiServer over HTTP."""
    from aiohttp import ClientSession

    atxs = importlib.import_module(f"{pkg}.storage.atxs")
    Address = importlib.import_module(f"{pkg}.core.types").Address
    api = importlib.import_module(f"{pkg}.api.http").ApiServer(app)
    port = await api.start()
    base = f"http://127.0.0.1:{port}"
    coinbase = app.atx_builders[0].coinbase
    atx_ids = [i for e in range(LPE) for i in atxs.ids_in_epoch(app.state, e)]
    gets = ["/v1/node/status", "/v1/node/version", "/v1/node/peers",
            "/v1/mesh/genesis", "/v1/globalstate/root",
            "/v1/smesher/status", "/v1/debug/state", "/v1/events?timeout=0",
            "/healthz", "/readyz", "/debug/remediation",
            f"/v1/account/{Address(coinbase).encode()}",
            f"/v1/account/{Address(coinbase).encode()}/rewards",
            f"/v1/account/0x{coinbase.hex()}", "/v1/account/nonsense",
            f"/v1/tx/{'00' * 32}", "/v1/tx/zz", f"/v1/atx/{'00' * 32}",
            "/v1/mesh/layer/x", "/v1/mesh/epoch/x/atxs"]
    gets += [f"/v1/mesh/layer/{lyr}" for lyr in range(UNTIL + 1)]
    gets += [f"/v1/mesh/epoch/{e}/atxs" for e in range(LPE)]
    gets += [f"/v1/atx/{i.hex()}" for i in atx_ids]
    posts = [("/v1/tx/submit", {"raw": "zz"}), ("/v1/tx/submit", {}),
             ("/v1/admin/checkpoint", {"path": str(tmp / f"{pkg}.ckpt")}),
             ("/v1/admin/checkpoint", {}),
             ("/v1/admin/chaos/block", {"addrs": []}),
             ("/v1/admin/chaos/clear", {}),
             ("/v1/admin/chaos/link", {}),
             ("/v1/admin/chaos/timeskew", {"offset": "x"})]
    out = {}
    try:
        async with ClientSession() as s:
            for path in gets:
                async with s.get(base + path) as r:
                    out["GET " + path] = (r.status, await r.text())
            for path, body in posts:
                async with s.post(base + path, json=body) as r:
                    out[f"POST {path} {json.dumps(body)}"] = (
                        r.status, await r.text())
    finally:
        await api.stop()
    out["GET /readyz"] = _timeless(out["GET /readyz"])
    # the checkpoint's path names the package; its body does not
    return {k.replace(pkg, "<pkg>"): v for k, v in out.items()}, atx_ids


async def _grpc_bodies(pkg, app, atx_ids) -> dict:
    """The serialized responses of the Node, Mesh, GlobalState,
    Transaction and Smesher services and the v2alpha1 queries."""
    import grpc

    cpb = importlib.import_module(f"{pkg}.api.gen.core_pb2")
    v2 = importlib.import_module(f"{pkg}.api.gen.v2alpha1_pb2")
    Address = importlib.import_module(f"{pkg}.core.types").Address
    server = importlib.import_module(f"{pkg}.api.rpc").GrpcApiServer(app)
    port = await server.start()
    coinbase = app.atx_builders[0].coinbase
    addr = Address(coinbase).encode()
    unary = [
        ("spacemesh.v1.NodeService/Echo", cpb.EchoRequest(msg="hi"),
         cpb.EchoResponse),
        ("spacemesh.v1.NodeService/Version", cpb.EchoRequest(),
         cpb.VersionResponse),
        ("spacemesh.v1.NodeService/Build", cpb.EchoRequest(),
         cpb.BuildResponse),
        ("spacemesh.v1.NodeService/Status", cpb.StatusRequest(),
         cpb.StatusResponse),
        ("spacemesh.v1.MeshService/GenesisTime", cpb.GenesisTimeRequest(),
         cpb.GenesisTimeResponse),
        ("spacemesh.v1.MeshService/GenesisID", cpb.GenesisIDRequest(),
         cpb.GenesisIDResponse),
        ("spacemesh.v1.MeshService/CurrentLayer",
         cpb.CurrentLayerRequest(), cpb.CurrentLayerResponse),
        ("spacemesh.v1.MeshService/CurrentEpoch",
         cpb.CurrentEpochRequest(), cpb.CurrentEpochResponse),
        ("spacemesh.v1.MeshService/EpochNumLayers",
         cpb.EpochNumLayersRequest(), cpb.EpochNumLayersResponse),
        ("spacemesh.v1.MeshService/LayerDuration",
         cpb.LayerDurationRequest(), cpb.LayerDurationResponse),
        ("spacemesh.v1.MeshService/LayersQuery",
         cpb.LayersQueryRequest(start_layer=0), cpb.LayersQueryResponse),
        ("spacemesh.v1.MeshService/MalfeasanceQuery",
         cpb.MalfeasanceQueryRequest(smesher_id=app.signer.node_id),
         cpb.MalfeasanceQueryResponse),
        ("spacemesh.v1.GlobalStateService/GlobalStateHash",
         cpb.GlobalStateHashRequest(), cpb.GlobalStateHashResponse),
        ("spacemesh.v1.GlobalStateService/Account",
         cpb.AccountRequest(address=addr), cpb.AccountResponse),
        ("spacemesh.v1.GlobalStateService/Account",
         cpb.AccountRequest(address="nonsense"), cpb.AccountResponse),
        ("spacemesh.v1.GlobalStateService/AccountDataQuery",
         cpb.AccountDataQueryRequest(address=addr, max_results=3),
         cpb.AccountDataQueryResponse),
        ("spacemesh.v1.TransactionService/TransactionsState",
         cpb.TransactionsStateRequest(transaction_id=[bytes(32)]),
         cpb.TransactionsStateResponse),
        ("spacemesh.v1.TransactionService/SubmitTransaction",
         cpb.SubmitTransactionRequest(transaction=b"\x00"),
         cpb.SubmitTransactionResponse),
        ("spacemesh.v1.SmesherService/IsSmeshing", cpb.IsSmeshingRequest(),
         cpb.IsSmeshingResponse),
        ("spacemesh.v1.SmesherService/SmesherIDs", cpb.SmesherIDsRequest(),
         cpb.SmesherIDsResponse),
        ("spacemesh.v1.SmesherService/PostSetupStatus",
         cpb.PostSetupStatusRequest(), cpb.PostSetupStatusResponse),
        ("spacemesh.v2alpha1.ActivationService/List",
         v2.ActivationRequest(limit=100), v2.ActivationList),
        ("spacemesh.v2alpha1.ActivationService/List",
         v2.ActivationRequest(limit=101), v2.ActivationList),
        ("spacemesh.v2alpha1.ActivationService/ActivationsCount",
         v2.ActivationsCountRequest(epoch=1), v2.ActivationsCountResponse),
        ("spacemesh.v2alpha1.RewardService/List",
         v2.RewardRequest(limit=100), v2.RewardList),
        ("spacemesh.v2alpha1.LayerService/List",
         v2.LayerRequest(limit=100), v2.LayerList),
        ("spacemesh.v2alpha1.MalfeasanceService/List",
         v2.MalfeasanceRequest(limit=100), v2.MalfeasanceList),
        ("spacemesh.v2alpha1.NetworkService/Info", v2.NetworkInfoRequest(),
         v2.NetworkInfoResponse),
        ("spacemesh.v2alpha1.NodeService/Status", v2.NodeStatusRequest(),
         v2.NodeStatusResponse),
        ("spacemesh.v2alpha1.AccountService/List",
         v2.AccountRequest(limit=100), v2.AccountList),
        ("spacemesh.v2alpha1.TransactionService/List",
         v2.TransactionRequest(limit=100), v2.TransactionList),
    ]
    out = {}
    try:
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
            for i, (method, req, resp_cls) in enumerate(unary):
                call = ch.unary_unary(
                    "/" + method, request_serializer=type(req).SerializeToString,
                    response_deserializer=resp_cls.FromString)
                try:
                    got = (await call(req)).SerializeToString()
                except grpc.aio.AioRpcError as e:
                    got = (e.code().name, e.details())
                out[f"{i} {method}"] = got
            for e in range(LPE + 1):
                call = ch.unary_stream(
                    "/spacemesh.v1.MeshService/EpochStream",
                    request_serializer=cpb.EpochStreamRequest.SerializeToString,
                    response_deserializer=cpb.EpochStreamResponse.FromString)
                out[f"EpochStream {e}"] = [
                    m.SerializeToString()
                    async for m in call(cpb.EpochStreamRequest(epoch=e))]
    finally:
        await server.stop()
    return out


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("api_parity")
    out = {}
    for pkg in PKGS:
        app = _run_node(pkg, tmp)
        try:
            async def query():
                bodies, atx_ids = await _json_bodies(pkg, app, tmp)
                return bodies, atx_ids, await _grpc_bodies(pkg, app, atx_ids)

            out[pkg] = asyncio.run(query())
        finally:
            app.close()
    return out


def test_json_route_bodies_equal_the_jax_packages(parity):
    ref, ref_ids, _ = parity["spacemesh_tpu"]
    port, port_ids, _ = parity["spacemesh_tpu_torch"]
    # the node did real work: ATXs in epochs 1 and 2, layers applied
    assert len(port_ids) >= 2 and port_ids == ref_ids
    status = json.loads(port["GET /v1/debug/state"][1])
    assert status["last_applied"] >= 2 * LPE
    assert port["GET /readyz"][0] == 200
    assert port["GET /v1/mesh/layer/x"][0] == 400
    assert port["POST /v1/admin/chaos/clear {}"][0] == 409
    assert sorted(port) == sorted(ref)
    for key in ref:
        assert port[key] == ref[key], key


def test_grpc_responses_equal_the_jax_packages(parity):
    ref = parity["spacemesh_tpu"][2]
    port = parity["spacemesh_tpu_torch"][2]
    assert sorted(port) == sorted(ref)
    for key in ref:
        assert port[key] == ref[key], key
    assert any(port[f"EpochStream {e}"] for e in range(LPE + 1))


# --- the PoST metrics an operator scrapes from /metrics ------------------

PIPELINE = ("post_pipeline_batches_dispatched_total",
            "post_pipeline_labels_total", "post_pipeline_meta_saves_total",
            "post_prove_windows_total", "post_prove_batches_total",
            "post_prove_early_exits_total", "post_proofs_generated")
STAGES = {"post_pipeline_stage_seconds_total": {"dispatch", "fetch",
                                                "write", "stall"},
          "post_prove_stage_seconds_total": {"read", "dispatch", "retire"}}


def _scrape(pkg) -> dict:
    from spacemesh_tpu_torch.obs.federate import parse_exposition

    text = importlib.import_module(f"{pkg}.utils.metrics").REGISTRY.expose()
    out: dict = {}
    for name, labels, value in parse_exposition(text):
        key = (name, tuple(sorted(labels.items())))
        out[key] = out.get(key, 0.0) + value
    return out


def test_post_pipeline_and_prove_metrics_equal_the_jax_packages(tmp_path):
    """One init (3 batches) and two proofs through each package: the
    ``post_pipeline_*``, ``post_prove_*`` and ``post_proofs_generated``
    counts move alike, each stage label appears, and the gauges read the
    last session."""
    node_id = hashlib.sha256(b"metrics-node").digest()
    commitment = hashlib.sha256(b"metrics-commitment").digest()
    moved = {}
    for pkg in PKGS:
        kw = {"device": "cpu"} if pkg == "spacemesh_tpu_torch" else {}
        init = importlib.import_module(f"{pkg}.post.initializer")
        prover = importlib.import_module(f"{pkg}.post.prover")
        before = _scrape(pkg)
        d = tmp_path / pkg
        init.initialize(d, node_id=node_id, commitment=commitment,
                        num_units=1, labels_per_unit=320, scrypt_n=2,
                        batch_size=128, **kw)
        params = prover.ProofParams(k1=64, k2=8, k3=4,
                                    pow_difficulty=b"\x20" + b"\xff" * 31)
        pv = prover.Prover(d, params, batch_labels=128, **kw)
        for i in range(2):
            pv.prove(hashlib.sha256(b"metrics-%d" % i).digest())
        after = _scrape(pkg)
        moved[pkg] = {k: after[k] - before.get(k, 0.0) for k in after
                      if k[0] in PIPELINE or k[0] in STAGES}
        for name, stages in STAGES.items():
            assert {dict(k[1]).get("stage") for k in after
                    if k[0] == name} >= stages, (pkg, name)
        assert after[("post_pipeline_labels_per_sec", ())] > 0, pkg
        assert after[("post_prove_labels_per_sec", ())] > 0, pkg
        assert after[("post_pipeline_inflight_batches", ())] == 0, pkg
        assert after[("post_prove_d2h_bytes_total", ())] > \
            before.get(("post_prove_d2h_bytes_total", ()), 0.0), pkg
    counts = {pkg: {k: v for k, v in m.items() if k[0] in PIPELINE}
              for pkg, m in moved.items()}
    assert counts["spacemesh_tpu_torch"] == counts["spacemesh_tpu"]
    assert counts["spacemesh_tpu_torch"][
        ("post_pipeline_labels_total", ())] == 320
    assert counts["spacemesh_tpu_torch"][
        ("post_pipeline_batches_dispatched_total", ())] == 3
    assert counts["spacemesh_tpu_torch"][("post_proofs_generated", ())] == 2
