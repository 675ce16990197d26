"""The port's mesh slice (``spacemesh_tpu_torch/consensus/{mesh,blocks,
miner,activeset}.py``) against the JAX package's.

- The cases of ``tests/test_activeset.py`` and ``tests/test_ballot_ingest.py``
  run once on each package, every generated active set, declared-set
  weight, grade, slot count and ballot verdict recorded: the records are
  equal and each case's own assertions hold on the port.
- ``Mesh`` applies blocks on the hare's word, then a late, heavy set of
  ballots flips a verdict below the frontier: the mesh reverts and
  reapplies, with the same blocks, state roots and VM calls in both
  packages.
- ``Generator`` and ``Certifier``: the same block from the same hare
  output; certificates assembled from real committee shares validate, a
  forged share, a short committee and a wrong layer are refused, alike.
- A network of nodes of both packages on one ``LoopbackHub`` builds,
  validates and certifies proposals for several layers with wallets
  spending: every node holds the same blocks, state roots and balances.
- ``ProposalHandler`` over each package's ``VerificationFarm(device=
  "cpu")`` gives the inline verdicts.
- After a port ``Mesh`` applies a layer, ``layer_apply_seconds`` feeds the
  ``layer_apply`` SLIs and the ``layer_apply_latency`` SLO.

Exact equality throughout.
"""

import asyncio
import dataclasses
import hashlib
import importlib
import inspect
import pathlib
import re
import types as pytypes

import pytest

TESTS = pathlib.Path(__file__).resolve().parent
PKGS = ("spacemesh_tpu", "spacemesh_tpu_torch")


def twin_module(name: str, pkg: str):
    """``tests/<name>.py`` loaded as a module whose imports name ``pkg``."""
    src = (TESTS / f"{name}.py").read_text()
    src = re.sub(r"\bspacemesh_tpu\b", pkg, src)
    mod = pytypes.ModuleType(f"_{pkg}_{name}")
    mod.__file__ = str(TESTS / f"{name}.py")
    exec(compile(src, f"{mod.__file__} [{pkg}]", "exec"), mod.__dict__)
    return mod


def imp(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _plain(v):
    """A comparable form of a recorded value (tuples of bytes and ints)."""
    if isinstance(v, (list, tuple)):
        return tuple(_plain(x) for x in v)
    if isinstance(v, str):
        return str(v)
    return v


def record_calls(monkeypatch, pkg: str, log: list) -> None:
    """Record what the mesh-slice functions return while a case runs."""
    aset = imp(pkg, "consensus.activeset")
    miner = imp(pkg, "consensus.miner")
    elig = imp(pkg, "consensus.eligibility")

    def wrap(owner, name, key):
        real = getattr(owner, name)

        def fn(*a, **kw):
            out = real(*a, **kw)
            log.append((key, _plain(out)))
            return out

        def afn_factory():
            async def afn(*a, **kw):
                out = await real(*a, **kw)
                log.append((key, _plain(out)))
                return out
            return afn

        monkeypatch.setattr(owner, name, afn_factory()
                            if inspect.iscoroutinefunction(real) else fn)

    wrap(aset.ActiveSetGenerator, "generate", "generate")
    for name in ("declared_set_weight", "grade_atx", "active_set_hash",
                 "num_eligible_slots", "select_min_weight"):
        wrap(aset, name, name)
    wrap(elig.Oracle, "num_slots", "num_slots")
    wrap(miner.ProposalHandler, "ingest_ballot", "ingest_ballot")
    wrap(miner.ProposalHandler, "_declared_set_weight", "declared")


def cases(name: str) -> list:
    mod = twin_module(name, PKGS[0])
    return [pytest.param(name, n, id=f"{name}::{n}")
            for n in sorted(dir(mod)) if n.startswith("test_")]


@pytest.mark.parametrize("name,case", cases("test_activeset")
                         + cases("test_ballot_ingest"))
def test_mesh_case_twin(name, case, monkeypatch):
    runs = {}
    for pkg in PKGS:
        log: list = []
        record_calls(monkeypatch, pkg, log)
        getattr(twin_module(name, pkg), case)()
        monkeypatch.undo()
        runs[pkg] = log
    assert runs[PKGS[0]], "the case called nothing recorded"
    assert runs[PKGS[1]] == runs[PKGS[0]]


# --- Mesh: apply, then a verdict flipped below the frontier ---------------

LPE = 8
GEN = b"mesh-twin-genesis"


def _info(pkg, node, weight):
    cache = imp(pkg, "storage.cache")
    return cache.AtxInfo(node_id=node, weight=weight, base_height=0,
                         height=1, num_units=1, vrf_nonce=0,
                         vrf_public_key=node)


def _flip_run(pkg: str) -> tuple:
    """Blocks A and B in each layer with different coinbases; hare and 10
    honest ballots a layer pick A. Then heavy ballots that arrive late,
    in layers below the frontier, vote B over A in layer 1: the tortoise
    flips it and the mesh reverts and reapplies from there."""
    tortoise = imp(pkg, "consensus.tortoise")
    mesh = imp(pkg, "consensus.mesh")
    types = imp(pkg, "core.types")
    signing = imp(pkg, "core.signing")
    db = imp(pkg, "storage.db")
    layers = imp(pkg, "storage.layers")
    cache_mod = imp(pkg, "storage.cache")
    vm_mod = imp(pkg, "vm")
    txs = imp(pkg, "txs")

    state = db.open_state()
    cache = cache_mod.AtxCache()
    nodes = [b"honest-%02d" % i + bytes(23) for i in range(10)]
    heavy = [b"heavy-%02d" % i + bytes(24) for i in range(4)]
    for epoch in range(3):
        for i, n in enumerate(nodes):
            cache.add(epoch, hashlib.sha256(b"a%d%d" % (epoch, i)).digest(),
                      _info(pkg, n, 100 * LPE))
    vm = vm_mod.VM(state, signing.EdVerifier(prefix=GEN))
    calls = []
    real_revert = vm.revert

    def revert(to_layer):
        calls.append(("revert", to_layer))
        return real_revert(to_layer)

    vm.revert = revert
    vm.apply_genesis({})
    cstate = txs.ConservativeState(state, vm)
    t = tortoise.Tortoise(cache, LPE, hdist=2, zdist=1, window=50)
    store = mesh.ProposalStore()
    m = mesh.Mesh(db=state, tortoise=t,
                  executor=mesh.Executor(state, vm, cstate),
                  proposals=store, cache=cache)

    def block(layer, tag):
        return types.Block(layer=layer, tick_height=1, rewards=[
            types.Reward(atx_id=bytes(32), coinbase=tag * 24, weight=1)],
            tx_ids=[])

    blocks = {x: (block(x, b"a"), block(x, b"b")) for x in range(1, 9)}
    trail = []

    def ballot(bid, layer, support, against=()):
        return types.Ballot(
            layer=layer, atx_id=bytes(32), node_id=bid[:32], epoch_data=None,
            ref_ballot=bytes(32), opinion=types.Opinion(
                base=bytes(32), support=list(support), against=list(against),
                abstain=[]), eligibilities=[], signature=bid.ljust(64, b"\0"))

    for layer in range(1, 8):
        a, b = blocks[layer]
        m.add_block(b)
        m.process_hare_output(a, layer)
        for k, n in enumerate(nodes):
            t.on_ballot(ballot(n[:30] + bytes([layer, k]), layer + 1,
                               [blocks[x][0].id for x in range(1, layer + 1)]),
                        weight=100)
        m.process_layer(layer + 1)
        trail.append((layer, t.verified, layers.applied_block(state, layer),
                      layers.state_hash(state, layer)))
    before = [layers.applied_block(state, x) for x in range(1, 8)]
    for k, n in enumerate(heavy):
        for x in range(2, 5):
            t.on_ballot(ballot(n[:30] + bytes([x, k]), x, [blocks[1][1].id]
                               + [blocks[y][0].id for y in range(2, x)],
                               against=[blocks[1][0].id]), weight=5000)
    m.process_layer(8)
    after = [layers.applied_block(state, x) for x in range(1, 8)]
    roots = [layers.state_hash(state, x) for x in range(1, 8)]
    aggs = [layers.aggregated_hash(state, x) for x in range(1, 8)]
    return (trail, before, after, roots, aggs, calls, t.verified,
            [blocks[x][0].id for x in range(1, 8)], blocks[1][1].id)


def test_mesh_revert_and_reapply_on_a_late_flip():
    j, p = (_flip_run(pkg) for pkg in PKGS)
    assert p == j
    trail, before, after, roots, aggs, calls, verified, a_ids, b1 = p
    assert before == a_ids                 # the hare's blocks applied
    assert after == [b1] + a_ids[1:]       # layer 1 flipped to B
    assert calls == [("revert", 0)]        # reverted below it, reapplied
    assert roots[0] != trail[0][3] and verified >= 6


# --- Generator and Certifier ----------------------------------------------


class _Bus:
    """A PubSub stand-in delivering to its own handlers at once."""

    def __init__(self):
        self.handlers = {}
        self.sent = []

    def register(self, topic, fn):
        self.handlers.setdefault(topic, []).append(fn)

    async def publish(self, topic, data):
        self.sent.append((topic, data))
        for fn in self.handlers.get(topic, ()):
            await fn(b"self", data)


def _cert_world(pkg: str, committee: int, threshold: int):
    blocks = imp(pkg, "consensus.blocks")
    elig = imp(pkg, "consensus.eligibility")
    signing = imp(pkg, "core.signing")
    db = imp(pkg, "storage.db")
    cache_mod = imp(pkg, "storage.cache")
    signers = [signing.EdSigner(seed=hashlib.sha256(b"cert-%d" % i).digest(),
                                prefix=GEN) for i in range(12)]
    cache = cache_mod.AtxCache()
    atx_of = {}
    for i, s in enumerate(signers):
        atx_of[s.node_id] = hashlib.sha256(b"catx-%d" % i).digest()
        cache.add(2, atx_of[s.node_id], _info(pkg, s.node_id, 1000 + i))
    state = db.open_state()
    bus = _Bus()

    async def beacon(epoch):
        return b"\x07" * 4

    c = blocks.Certifier(
        db=state, signer=signers[0], verifier=signing.EdVerifier(prefix=GEN),
        pubsub=bus, oracle=elig.Oracle(cache, LPE), committee_size=committee,
        threshold=threshold, layers_per_epoch=LPE, beacon_getter=beacon)
    return pytypes.SimpleNamespace(c=c, signers=signers, atx_of=atx_of,
                                   state=state, bus=bus, cache=cache)


def _cert_run(pkg: str) -> tuple:
    misc = imp(pkg, "storage.misc")
    w = _cert_world(pkg, committee=20, threshold=11)
    layer, block_id = 2 * LPE + 3, hashlib.sha256(b"the block").digest()
    adopted = []
    w.c.on_certificate = lambda lyr, bid: adopted.append((lyr, bid))

    async def go():
        for s in w.signers:
            await w.c.certify_if_eligible(layer, block_id,
                                          w.atx_of[s.node_id], signer=s)
        cert = misc.certificate(w.state, layer)
        ok = await w.c.validate_certificate(layer, cert)
        share = cert.signatures[0]
        forged = dataclasses.replace(cert, signatures=[dataclasses.replace(
            share, signature=bytes([share.signature[0] ^ 1])
            + share.signature[1:])] + cert.signatures[1:])
        short = dataclasses.replace(cert, signatures=cert.signatures[:1])
        dup = dataclasses.replace(cert, signatures=cert.signatures
                                  + cert.signatures[:1])
        # the threshold's edge: the certificate's own seat total passes,
        # one seat more is refused
        total = sum(m.eligibility_count for m in cert.signatures)
        edge = []
        for threshold in (total, total + 1):
            w.c.threshold = threshold
            edge.append(await w.c.validate_certificate(layer, cert))
        w.c.threshold = 11
        return (cert.to_bytes(), ok, edge,
                await w.c.validate_certificate(layer, forged),
                await w.c.validate_certificate(layer, short),
                await w.c.validate_certificate(layer, dup),
                await w.c.validate_certificate(layer + 1, cert),
                [m.eligibility_count for m in cert.signatures],
                len(w.bus.sent))

    out = asyncio.run(go())
    return out + (adopted,)


def test_certifier_threshold_forged_and_short_committee():
    j, p = (_cert_run(pkg) for pkg in PKGS)
    assert p == j
    raw, ok, edge, forged, short, dup, wrong_layer, seats, sent, adopted = p
    assert ok is True and sum(seats) >= 11 and edge == [True, False]
    assert (forged, short, dup, wrong_layer) == (False, False, False, False)
    assert sent > len(seats) and len(adopted) == 1


def _generator_run(pkg: str) -> tuple:
    blocks = imp(pkg, "consensus.blocks")
    mesh = imp(pkg, "consensus.mesh")
    hare = imp(pkg, "consensus.hare")
    types = imp(pkg, "core.types")
    atxs = imp(pkg, "storage.atxs")
    db = imp(pkg, "storage.db")
    cache_mod = imp(pkg, "storage.cache")
    state = db.open_state()
    cache = cache_mod.AtxCache()
    store = mesh.ProposalStore()
    props = []
    for i in range(5):
        atx = types.ActivationTx(
            publish_epoch=1, prev_atx=bytes(32), pos_atx=bytes(32),
            commitment_atx=None, initial_post=None,
            nipost=types.NIPost(
                membership=types.MerkleProof(leaf_index=0, nodes=[]),
                post=types.Post(nonce=0, indices=[1], pow_nonce=0),
                post_metadata=types.PostMetadataWire(challenge=bytes(32),
                                                     labels_per_unit=64)),
            num_units=1, vrf_nonce=i, vrf_public_key=bytes([i]) * 32,
            coinbase=bytes([i % 3]) * 24, node_id=bytes([i]) * 32,
            signature=bytes(64))
        atxs.add(state, atx)
        cache.add(2, atx.id, dataclasses.replace(
            _info(pkg, atx.node_id, 100), height=10 + i))
        for k in range(1 + i % 2):
            ballot = types.Ballot(
                layer=2 * LPE + 1, atx_id=atx.id, node_id=atx.node_id,
                epoch_data=None, ref_ballot=bytes(32),
                opinion=types.Opinion(base=bytes(32), support=[], against=[],
                                      abstain=[]),
                eligibilities=[types.VotingEligibility(j=j, sig=bytes(80))
                               for j in range(1 + k)],
                signature=bytes([i, k]) * 32)
            p = types.Proposal(ballot=ballot, tx_ids=[
                hashlib.sha256(b"tx%d" % ((i + t) % 4)).digest()
                for t in range(2)], mesh_hash=bytes(32),
                signature=bytes([k, i]) * 32)
            store.add(p)
            props.append(p.id)
    g = blocks.Generator(mesh=pytypes.SimpleNamespace(db=state),
                         proposals=store, cache=cache, layers_per_epoch=LPE)
    out = hare.ConsensusOutput(layer=2 * LPE + 1,
                               proposals=sorted(props)[:-1])
    block = g.generate(out)
    none = g.generate(hare.ConsensusOutput(layer=2 * LPE + 1, proposals=[]))
    return (block.to_bytes(), block.id, block.tick_height,
            [(r.atx_id, r.coinbase, r.weight) for r in block.rewards],
            block.tx_ids, none)


def test_generator_builds_the_same_block():
    j, p = (_generator_run(pkg) for pkg in PKGS)
    assert p == j
    raw, bid, height, rewards, tx_ids, none = p
    assert none is None and height == 14 and len(tx_ids) == 4
    assert len({c for _, c, _ in rewards}) == 3


# --- a mixed network on one LoopbackHub -----------------------------------

EPOCH = 2
FIRST = EPOCH * LPE


def _net_node(pkg: str, k: int, group: list, env: dict):
    """The mesh slice of one node (the JAX node/app.py wiring): state and
    local DBs restored at the layer before the epoch, inline verification,
    its identities' ATXs in its state and cache."""
    aset = imp(pkg, "consensus.activeset")
    blocks = imp(pkg, "consensus.blocks")
    elig = imp(pkg, "consensus.eligibility")
    mesh = imp(pkg, "consensus.mesh")
    miner = imp(pkg, "consensus.miner")
    tortoise = imp(pkg, "consensus.tortoise")
    signing = imp(pkg, "core.signing")
    types = imp(pkg, "core.types")
    ps = imp(pkg, "p2p.pubsub")
    atxs = imp(pkg, "storage.atxs")
    cache_mod = imp(pkg, "storage.cache")
    db = imp(pkg, "storage.db")
    layers = imp(pkg, "storage.layers")
    misc = imp(pkg, "storage.misc")
    txs = imp(pkg, "txs")
    vm_mod = imp(pkg, "vm")
    sdk = imp(pkg, "vm.sdk")

    n = pytypes.SimpleNamespace(pkg=pkg, k=k, group=group)
    n.state, n.local = db.open_state(), db.open_local()
    n.cache = cache_mod.AtxCache()
    verifier = signing.EdVerifier(prefix=GEN)
    for i, seed in enumerate(env["seeds"]):
        s = signing.EdSigner(seed=seed, prefix=GEN)
        atx = types.ActivationTx(
            publish_epoch=EPOCH - 1, prev_atx=bytes(32), pos_atx=bytes(32),
            commitment_atx=None, initial_post=None,
            nipost=types.NIPost(
                membership=types.MerkleProof(leaf_index=0, nodes=[]),
                post=types.Post(nonce=0, indices=[1], pow_nonce=0),
                post_metadata=types.PostMetadataWire(challenge=bytes(32),
                                                     labels_per_unit=64)),
            num_units=1, vrf_nonce=0, vrf_public_key=s.node_id,
            coinbase=sdk.wallet_address(s.public_key).raw, node_id=s.node_id,
            signature=bytes(64))
        atxs.add(n.state, atx, tick_height=1000, received=0)
        n.cache.add(EPOCH, atx.id, cache_mod.AtxInfo(
            node_id=s.node_id, weight=1000 + 10 * i, base_height=0,
            height=1000, num_units=1, vrf_nonce=0, vrf_public_key=s.node_id))
        env["atx_of"][s.node_id] = atx.id
    n.oracle = elig.Oracle(n.cache, LPE, slots_per_layer=6,
                           min_weight_table=[(0, 1)])
    n.vm = vm_mod.VM(n.state, verifier)
    n.cstate = txs.ConservativeState(n.state, n.vm)
    root = n.vm.apply_genesis({})
    layers.set_applied(n.state, FIRST - 1, bytes(32), root)
    layers.set_processed(n.state, FIRST - 1)
    n.tortoise = tortoise.Tortoise.recover(
        n.state, n.cache, n.oracle, layers_per_epoch=LPE, hdist=2, zdist=1,
        window=100)
    n.store = mesh.ProposalStore()
    n.mesh = mesh.Mesh(db=n.state, tortoise=n.tortoise,
                       executor=mesh.Executor(n.state, n.vm, n.cstate),
                       proposals=n.store, cache=n.cache)
    n.generator = blocks.Generator(mesh=n.mesh, proposals=n.store,
                                   cache=n.cache, layers_per_epoch=LPE)
    n.pubsub = ps.PubSub(node_name=b"%s-%d" % (pkg.encode(), k))

    async def beacon(epoch):
        return b"\x05" * 4

    n.certifier = blocks.Certifier(
        db=n.state, signer=group[0], verifier=verifier, pubsub=n.pubsub,
        oracle=n.oracle, committee_size=10, threshold=6,
        layers_per_epoch=LPE, beacon_getter=beacon)
    n.certifier.on_certificate = n.mesh.adopt_certified
    gen = aset.ActiveSetGenerator(
        n.state, n.local, n.cache, layers_per_epoch=LPE, layer_duration=1.0,
        genesis_time=100.0, network_delay=1.0)
    n.builders = [miner.ProposalBuilder(
        signer=s, db=n.state, cache=n.cache, oracle=n.oracle,
        tortoise=n.tortoise, cstate=n.cstate, pubsub=n.pubsub,
        layers_per_epoch=LPE, beacon_getter=beacon, activeset_gen=gen)
        for s in group]
    n.handler = miner.ProposalHandler(
        db=n.state, cache=n.cache, oracle=n.oracle, tortoise=n.tortoise,
        store=n.store, verifier=verifier, pubsub=n.pubsub,
        layers_per_epoch=LPE, beacon_getter=beacon)

    async def fetch(root):
        for peer in env["nodes"]:
            ids = misc.active_set(peer.state, root)
            if ids is not None:
                misc.add_active_set(n.state, root, EPOCH, ids)
                return True
        return False

    n.handler.fetch_active_set = fetch

    async def on_tx(peer, data):
        vm_pkg = imp(pkg, "vm")
        return n.cstate.add(types.Transaction(raw=data)) \
            == vm_pkg.TxValidity.VALID

    n.pubsub.register(ps.TOPIC_TX, on_tx)
    return n


def _network(kinds: tuple, layers_n: int = 6) -> list:
    """Nodes of the given packages (two identities each) on one hub; per
    layer: build, validate, the proposals every node holds as the hare's
    output, generate and apply, certify, tally; wallet spends between the
    rewarded coinbases from the second layer on."""
    hub_pkg = kinds[0]
    hub = imp(hub_pkg, "p2p.pubsub").LoopbackHub()
    seeds = [hashlib.sha256(b"net-%d" % i).digest()
             for i in range(2 * len(kinds))]
    env = dict(seeds=seeds, atx_of={}, nodes=[])
    for k, pkg in enumerate(kinds):
        signing = imp(pkg, "core.signing")
        group = [signing.EdSigner(seed=s, prefix=GEN)
                 for s in seeds[2 * k:2 * k + 2]]
        env["nodes"].append(_net_node(pkg, k, group, env))
    for n in env["nodes"]:
        hub.join(n.pubsub)
    wallet = imp(hub_pkg, "p2p.pubsub").PubSub(node_name=b"wallet",
                                               deliver_self=False)
    hub.join(wallet)
    nodes = env["nodes"]
    sdk = imp(kinds[0], "vm.sdk")
    jsign = imp(kinds[0], "core.signing")
    keys = [jsign.EdSigner(seed=s, prefix=GEN) for s in seeds]
    addr = [sdk.wallet_address(s.public_key) for s in keys]
    topic_tx = imp(hub_pkg, "p2p.pubsub").TOPIC_TX
    out = []

    async def go():
        spawned = set()
        for i in range(layers_n):
            layer = FIRST + i
            for n in nodes:
                for b in n.builders:
                    await b.build(layer)
            await hub.drain()
            held = sorted(set.intersection(*(set(n.store.ids_in_layer(layer))
                                             for n in nodes)))
            assert held, f"layer {layer}: no proposal held by every node"
            blocks = []
            for n in nodes:
                h = imp(n.pkg, "consensus.hare")
                blocks.append(n.generator.process_hare_output(
                    h.ConsensusOutput(layer=layer, proposals=held)))
            for n, blk in zip(nodes, blocks):
                for s in n.group:
                    await n.certifier.certify_if_eligible(
                        layer, blk.id, env["atx_of"][s.node_id], signer=s)
            await hub.drain()
            for n in nodes:
                n.mesh.process_layer(layer)
            out.append([(blk.id, n.mesh.latest_applied, n.tortoise.verified,
                         imp(n.pkg, "storage.layers").state_hash(n.state,
                                                                 layer),
                         imp(n.pkg, "storage.misc").certified_block(n.state,
                                                                    layer))
                        for n, blk in zip(nodes, blocks)])
            # the next layer's transactions, from node 0's projections
            for s, a in zip(keys, addr):
                nonce, balance = nodes[0].cstate.projected(a.raw)
                if s.node_id not in spawned and balance > 10_000:
                    await wallet.publish(topic_tx, sdk.spawn_wallet(s).raw)
                    spawned.add(s.node_id)
                elif s.node_id in spawned and balance > 10_000 and nonce:
                    await wallet.publish(topic_tx, sdk.spend(
                        a, [s], addr[(keys.index(s) + 1) % len(keys)],
                        1000 + i, nonce=nonce).raw)
            await hub.drain()
        for n in nodes:
            n.state.close()

    asyncio.run(go())
    return out


@pytest.mark.parametrize("kinds", [PKGS, PKGS[::-1] + PKGS])
def test_mixed_network_equal_blocks_and_state(kinds):
    rows = _network(kinds)
    for per_layer in rows:
        assert len(set(per_layer)) == 1, per_layer
    blocks = [r[0][0] for r in rows]
    assert len(set(blocks)) == len(blocks)
    assert all(r[0][4] == r[0][0] for r in rows)  # certified everywhere
    assert rows[-1][0][2] >= FIRST + len(rows) - 3  # votes decide layers
    assert len({r[0][3] for r in rows}) == len(rows)  # the state moves


def test_port_network_equals_jax_network():
    assert _network((PKGS[1],) * 2) == _network((PKGS[0],) * 2)


# --- ProposalHandler over each package's farm ----------------------------


def _handler_run(pkg: str, farmed: bool) -> list:
    env = dict(seeds=[hashlib.sha256(b"h-%d" % i).digest() for i in range(4)],
               atx_of={}, nodes=[])
    signing = imp(pkg, "core.signing")
    group = [signing.EdSigner(seed=s, prefix=GEN) for s in env["seeds"]]
    builder_node = _net_node(pkg, 0, group, env)
    checker = _net_node(pkg, 1, group[:1], env)
    env["nodes"] = [builder_node, checker]
    farm_mod = imp(pkg, "verify.farm")
    built = []

    async def go():
        on_cpu = {"device": "cpu"} if pkg == PKGS[1] else {}
        farm = farm_mod.VerificationFarm(
            ed_verifier=signing.EdVerifier(prefix=GEN), **on_cpu) \
            if farmed else None
        checker.handler.farm = farm
        try:
            for layer in range(FIRST, FIRST + 3):
                for b in builder_node.builders:
                    p = await b.build(layer)
                    if p is not None:
                        built.append(p)
            verdicts = []
            for p in built:
                bad_sig = dataclasses.replace(p, signature=bytes(
                    [p.signature[0] ^ 1]) + p.signature[1:])
                bad_ballot = dataclasses.replace(p, ballot=dataclasses.replace(
                    p.ballot, signature=bytes(64)))
                for q in (p, bad_sig, bad_ballot):
                    verdicts.append((q.id, await checker.handler.process(q)))
            return verdicts
        finally:
            if farm is not None:
                await farm.aclose()

    return asyncio.run(go())


def test_proposal_handler_farm_equals_inline():
    got = {(pkg, farmed): _handler_run(pkg, farmed)
           for pkg in PKGS for farmed in (False, True)}
    base = got[(PKGS[0], False)]
    assert all(v == base for v in got.values())
    verdicts = [v for _, v in base]
    assert verdicts.count(True) == len(verdicts) // 3 > 0
    assert not any(verdicts[1::3]) and not any(verdicts[2::3])


# --- layer_apply_seconds feeds the SLI and the SLO -----------------------


def test_layer_apply_seconds_feeds_sli_and_slo():
    from spacemesh_tpu_torch.consensus import mesh, tortoise
    from spacemesh_tpu_torch.core import signing
    from spacemesh_tpu_torch.obs import health, sli
    from spacemesh_tpu_torch.storage import cache as cache_mod
    from spacemesh_tpu_torch.storage import db
    from spacemesh_tpu_torch.txs import ConservativeState
    from spacemesh_tpu_torch.utils import metrics
    from spacemesh_tpu_torch.vm import VM

    from spacemesh_tpu.utils import metrics as jmetrics

    # the JAX family: the same kind, help and buckets
    t = metrics.REGISTRY._instruments["layer_apply_seconds"]
    j = jmetrics.REGISTRY._instruments["layer_apply_seconds"]
    assert t is metrics.layer_apply_seconds
    assert type(t).__name__ == type(j).__name__ == "Histogram"
    assert t.help == j.help and t.buckets == j.buckets
    engine = health.HealthEngine(health=health.HealthRegistry(),
                                 window_s=60.0)
    before = engine.tick(now=1000.0)
    assert "layer_apply_p99" not in before["slis"]
    assert before["slos"]["layer_apply_latency"]["value"] is None
    state = db.open_state()
    cache = cache_mod.AtxCache()
    vm = VM(state, signing.EdVerifier(prefix=GEN))
    vm.apply_genesis({})
    m = mesh.Mesh(db=state, tortoise=tortoise.Tortoise(cache, LPE),
                  executor=mesh.Executor(state, vm,
                                         ConservativeState(state, vm)),
                  proposals=mesh.ProposalStore(), cache=cache)
    count0 = sum(v[2] for v in metrics.layer_apply_seconds.sample().values())
    m.process_hare_output(None, 1)
    m.process_layer(1)
    count = sum(v[2] for v in metrics.layer_apply_seconds.sample().values())
    assert count == count0 + 1
    after = engine.tick(now=1001.0)
    for q in ("p50", "p95", "p99"):
        assert after["slis"].get(f"layer_apply_{q}") is not None
    slo = after["slos"]["layer_apply_latency"]
    assert slo["value"] is not None and slo["value"] <= 2.0
    sampler = sli.SliSampler(window_s=60.0)
    sampler.sample(now=0.0)
    m.process_layer(2)
    sampler.sample(now=1.0)
    spec = next(s for s in sli.default_slis() if s.name == "layer_apply_p99")
    assert sampler.compute(spec) is not None
