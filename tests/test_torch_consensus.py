"""The port's eligibility, hare and beacon (``spacemesh_tpu_torch/core/
fixedpoint.py``, ``consensus/{activeset,eligibility,hare3,hare,beacon}.py``)
against the JAX package's.

Twins of ``tests/test_{eligibility_binomial,hare3_protocol,hare_adversarial,
beacon}.py``, with exact equality (integers, bytes, verdicts):

- the fixed-point binomial and the oracle's counts and verdicts on seeded
  identities;
- a seeded message schedule through both packages' ``hare3.Protocol``,
  the ``OutMessage``s and ``Output``s equal step by step;
- every hare and beacon wire message built from the same seeded values:
  equal bytes, each package decoding the other's;
- ``Hare`` under attack (equivocator, forged count, notify without a
  certificate, a late commit), networks of port nodes and mixed networks
  of both packages' nodes on one ``LoopbackHub``;
- ``Hare``'s compact path and its committee and compact-layer upgrades,
  driven directly (the JAX ``tests/test_hare_{compact,upgrade}.py`` go
  through the node);
- the beacon: convergence (port and mixed), a forged proposal, a late
  node, fallback only on timeout, a protocol beacon never superseded.

Timed sessions run on the JAX package's virtual clock loop
(``utils/vclock.py``) with ``wall=loop.time``, so load cannot skip a
round. No torch, no card.
"""

import asyncio
import dataclasses
import hashlib
import random

import pytest

from spacemesh_tpu.consensus import beacon as jbeacon
from spacemesh_tpu.consensus import eligibility as jelig
from spacemesh_tpu.consensus import hare as jhare
from spacemesh_tpu.consensus import hare3 as jhare3
from spacemesh_tpu.core import fixedpoint as jfp
from spacemesh_tpu.core import signing as jsig
from spacemesh_tpu.p2p import pubsub as jps
from spacemesh_tpu.p2p.server import LoopbackNet, Server
from spacemesh_tpu.storage import cache as jcache
from spacemesh_tpu.storage import db as jdb
from spacemesh_tpu.storage import misc as jmisc
from spacemesh_tpu.utils.vclock import run_virtual
from spacemesh_tpu_torch.consensus import activeset as tactiveset
from spacemesh_tpu_torch.consensus import beacon as tbeacon
from spacemesh_tpu_torch.consensus import eligibility as telig
from spacemesh_tpu_torch.consensus import hare as thare
from spacemesh_tpu_torch.consensus import hare3 as thare3
from spacemesh_tpu_torch.core import fixedpoint as tfp
from spacemesh_tpu_torch.core import signing as tsig
from spacemesh_tpu_torch.core.hashing import sum256
from spacemesh_tpu_torch.p2p import pubsub as tps
from spacemesh_tpu_torch.storage import cache as tcache
from spacemesh_tpu_torch.storage import db as tdb
from spacemesh_tpu_torch.storage import misc as tmisc

ONE = tfp.ONE
GEN = b"hare-compact-gen!!!!"
LPE = 4
LAYER = 5
EPOCH = LAYER // LPE
BEACON = b"\x07\x07\x07\x07"

J = dict(hare=jhare, hare3=jhare3, elig=jelig, beacon=jbeacon, sig=jsig,
         ps=jps, cache=jcache, db=jdb, misc=jmisc)
T = dict(hare=thare, hare3=thare3, elig=telig, beacon=tbeacon, sig=tsig,
         ps=tps, cache=tcache, db=tdb, misc=tmisc)
PKGS = {"jax": J, "port": T}


def _seeds(salt: bytes, n: int) -> list[bytes]:
    return [hashlib.sha256(salt + b"-%d" % i).digest() for i in range(n)]


def _signers(pkg: dict, seeds: list[bytes]) -> list:
    return [pkg["sig"].EdSigner(seed=s, prefix=GEN) for s in seeds]


def _cache(pkg: dict, signers, weights, epoch=EPOCH, tag=b"CATX"):
    cache = pkg["cache"].AtxCache()
    atx_ids = {}
    for i, (s, w) in enumerate(zip(signers, weights)):
        atx_id = tag + b"%04d" % i + bytes(24)
        atx_ids[s.node_id] = atx_id
        cache.add(epoch, atx_id, pkg["cache"].AtxInfo(
            node_id=s.node_id, weight=w, base_height=0, height=1,
            num_units=1, vrf_nonce=0, vrf_public_key=s.node_id))
    return cache, atx_ids


# --- fixed point ------------------------------------------------------


@pytest.mark.parametrize("n,num,den", [(10, 1, 4), (40, 3, 10),
                                       (100, 1, 100), (7, 6, 7),
                                       (64, 1, 8), (400, 1, 2),
                                       (10 ** 6, 1, 2), (5000, 50, 3000)])
def test_fixedpoint_equals_jax(n, num, den):
    rng = random.Random(n * 31 + num)
    fracs = [0, ONE - 1, ONE // 2] + [rng.randrange(ONE) for _ in range(24)]
    for frac in fracs:
        assert tfp.binomial_count(n, num, den, frac) == \
            jfp.binomial_count(n, num, den, frac)
    for x in sorted({0, 1, 2, n // 3, n // 2} | {rng.randrange(min(n, 300))
                                                 for _ in range(4)}):
        if x <= 400:
            assert tfp.bin_cdf(n, num, den, x) == jfp.bin_cdf(n, num, den, x)
    b = rng.randbytes(64)
    assert tfp.frac_from_bytes(b) == jfp.frac_from_bytes(b)
    assert tfp.fixed_pow(ONE // 3, n % 97) == jfp.fixed_pow(ONE // 3, n % 97)


def test_activeset_gating_equals_jax():
    from spacemesh_tpu.consensus import activeset as jactiveset

    table = [(0, 10), (3, 1000), (7, 10 ** 6)]
    for epoch in range(10):
        assert tactiveset.select_min_weight(epoch, table) == \
            jactiveset.select_min_weight(epoch, table)
    for args in ((5, 0, 100, 50, 4), (5, 1000, 100, 50, 4), (0, 0, 0, 1, 1),
                 (1, 10 ** 6, 3, 50, 4032)):
        assert tactiveset.num_eligible_slots(*args) == \
            jactiveset.num_eligible_slots(*args)
    with pytest.raises(ValueError):
        tactiveset.select_min_weight(1, [(3, 1), (1, 2)])


# --- hare3: a seeded schedule through both machines --------------------


def _input(mod, kw):
    return mod.Input(sender=kw["sender"], ir=mod.IterRound(*kw["ir"]),
                     eligibility_count=kw["count"], vrf=kw["vrf"],
                     msg_hash=kw["hash"], values=kw.get("values"),
                     reference=kw.get("reference"),
                     atxgrade=kw.get("atxgrade", mod.GRADE5))


def _out(o) -> tuple:
    m = o.message
    msg = None if m is None else (m.ir.iter, m.ir.round, m.values,
                                  m.reference)
    return (o.coin, o.result, o.terminated, msg)


def _eq(equivocation):
    return None if equivocation is None else \
        dataclasses.astuple(equivocation)


@pytest.mark.parametrize("seed", range(8))
def test_hare3_seeded_schedule_step_for_step(seed):
    """Honest senders echo the machine's messages with seeded delays of 0-4
    rounds; two adversaries inject conflicting and late messages at
    seeded rounds. Both packages' machines take the same inputs and must
    give the same relay verdicts, equivocations and outputs each round."""
    rng = random.Random(seed)
    threshold = rng.choice([3, 4, 5])
    props = [hashlib.sha256(b"prop-%d-%d" % (seed, i)).digest()
             for i in range(4)]
    honest = _seeds(b"honest-%d" % seed, 4)
    evil = _seeds(b"evil-%d" % seed, 2)
    jp, tp = jhare3.Protocol(threshold), thare3.Protocol(threshold)
    initial = sorted(rng.sample(props, 3))
    jp.on_initial(initial)
    tp.on_initial(initial)
    queue: list = []
    outs = []
    rounds = (thare3.PREROUND, thare3.PROPOSE, thare3.COMMIT, thare3.NOTIFY)
    for step in range(56):
        due = [kw for at, kw in queue if at <= step]
        queue = [(at, kw) for at, kw in queue if at > step]
        if rng.random() < 0.5:
            cur = tp.current
            rnd = rng.choice(rounds)
            it = max(0, cur.iter + rng.choice([-1, 0, 0, 1]))
            if rnd == thare3.PREROUND:
                it = 0
            sender = rng.choice(evil)
            kw = dict(sender=sender, ir=(it, rnd), count=rng.randint(1, 3),
                      vrf=rng.randbytes(32), hash=rng.randbytes(32),
                      atxgrade=rng.choice([5, 5, 5, 4, 3]))
            if rnd in (thare3.PREROUND, thare3.PROPOSE):
                kw["values"] = sorted(rng.sample(props, rng.randint(0, 4)))
            else:
                kw["reference"] = thare3.values_ref(
                    sorted(rng.sample(props, rng.randint(1, 4))))
            due.append(kw)
        for kw in due:
            rj = jp.on_input(_input(jhare3, kw))
            rt = tp.on_input(_input(thare3, kw))
            assert (rt[0], _eq(rt[1])) == (rj[0], _eq(rj[1])), (step, kw)
        oj, ot = jp.next(), tp.next()
        assert _out(ot) == _out(oj), step
        assert (tp.current.iter, tp.current.round) == \
            (jp.current.iter, jp.current.round)
        outs.append(_out(ot))
        m = ot.message
        if m is None:
            continue
        for sender in honest:
            payload = (b"".join(m.values) if m.values is not None
                       else m.reference)
            kw = dict(sender=sender, ir=(m.ir.iter, m.ir.round),
                      count=rng.randint(1, 2),
                      vrf=hashlib.sha256(sender + b"vrf").digest(),
                      hash=hashlib.sha256(sender + bytes(
                          [m.ir.iter, m.ir.round]) + payload).digest(),
                      values=m.values, reference=m.reference)
            queue.append((step + rng.choice([0, 0, 0, 1, 1, 2, 4]), kw))
    assert tp.result == jp.result and tp.locked == jp.locked
    assert tp.valid_proposals == jp.valid_proposals
    assert any(o[3] is not None for o in outs)
    assert any(o[1] is not None for o in outs)  # a decision was reached


# --- eligibility -------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_oracle_equals_jax(seed):
    """Hare seat counts, proofs and verdicts (real, forged +1, zero, another
    round's proof), proposal slots and their validation: the port's oracle
    == the JAX package's on the same seeded identities and weights."""
    rng = random.Random(seed)
    seeds = _seeds(b"oracle-%d" % seed, 6)
    weights = [rng.randint(1, 400) for _ in seeds]
    table = [(0, rng.choice([0, 500]))]
    oracles, signers = {}, {}
    for name, pkg in PKGS.items():
        sg = _signers(pkg, seeds)
        cache, atx_ids = _cache(pkg, sg, weights, epoch=1)
        oracles[name] = (pkg["elig"].Oracle(cache, LPE,
                                            min_weight_table=table), atx_ids)
        signers[name] = sg
    (jo, jids), (to, tids) = oracles["jax"], oracles["port"]
    assert jids == tids
    committee = rng.choice([20, 40, 3000])
    beacon = rng.randbytes(4)
    seen = 0
    for layer in range(4, 6):
        for rnd in range(4):
            for js, ts in zip(signers["jax"], signers["port"]):
                atx = tids[ts.node_id]
                el = to.hare_eligibility(ts.vrf_signer(), beacon, layer, rnd,
                                         1, atx, committee)
                assert el == jo.hare_eligibility(
                    js.vrf_signer(), beacon, layer, rnd, 1, atx, committee)
                if el is None:
                    continue
                seen += 1
                proof, count = el
                for claim, r in ((count, rnd), (count + 1, rnd), (0, rnd),
                                 (count, rnd + 1)):
                    got = to.validate_hare(beacon, layer, r, 1, atx,
                                           committee, proof, claim)
                    assert got == jo.validate_hare(beacon, layer, r, 1, atx,
                                                   committee, proof, claim)
                    assert got == (claim == count and r == rnd)
    assert seen
    for js, ts in zip(signers["jax"], signers["port"]):
        atx = tids[ts.node_id]
        total = rng.choice([None, sum(weights) // 2])
        assert to.num_slots(1, atx, total) == jo.num_slots(1, atx, total)
        assert to.trusts_declared(1) == jo.trusts_declared(1)
        for layer in range(4, 8):
            slots = to.eligible_slots_for_layer(ts.vrf_signer(), beacon, 1,
                                                atx, layer, total)
            assert slots == jo.eligible_slots_for_layer(
                js.vrf_signer(), beacon, 1, atx, layer, total)
            for j, proof in slots:
                for lay, jj in ((layer, j), (layer + 1, j), (layer, j + 99)):
                    assert to.validate_slot(beacon, 1, atx, lay, jj, proof,
                                            total) == \
                        jo.validate_slot(beacon, 1, atx, lay, jj, proof,
                                         total)


def test_oracle_committee_rescale_and_malicious_equal_jax():
    seeds = _seeds(b"rescale", 2)
    for name, pkg in PKGS.items():
        sg = _signers(pkg, seeds)
        cache, ids = _cache(pkg, sg, [2, 3], epoch=1)
        o = pkg["elig"].Oracle(cache, LPE)
        assert o._binomial_params(1, ids[sg[0].node_id], 40) == \
            (2 * 40, 40, 5 * 40)
        cache.set_malicious(sg[1].node_id)
        assert o._binomial_params(1, ids[sg[1].node_id], 40) == (0, 0, 1)
        assert o.num_slots(1, ids[sg[1].node_id]) == 0
    # at the rescale's edge (committee == total weight) the two agree
    params = {}
    for name, pkg in PKGS.items():
        sg = _signers(pkg, seeds)
        cache, ids = _cache(pkg, sg, [15, 25], epoch=1)
        o = pkg["elig"].Oracle(cache, LPE)
        params[name] = [o._binomial_params(1, ids[sg[0].node_id], c)
                        for c in (39, 40, 41)]
    assert params["port"] == params["jax"]
    assert params["port"][1] == (15, 40, 40)


# --- wire messages -----------------------------------------------------


def _wire_values(rng) -> dict:
    ids = sorted(rng.randbytes(32) for _ in range(rng.randint(0, 5)))
    return dict(
        HareMessage=dict(layer=rng.randrange(1 << 32),
                         iteration=rng.randrange(256), round=rng.randrange(4),
                         values=ids, eligibility_proof=rng.randbytes(80),
                         eligibility_count=rng.randrange(1 << 16),
                         atx_id=rng.randbytes(32), node_id=rng.randbytes(32),
                         cert_msgs=[rng.randbytes(rng.randint(0, 300))
                                    for _ in range(rng.randint(0, 3))],
                         signature=rng.randbytes(64)),
        CompactHareMessage=dict(
            layer=rng.randrange(1 << 32), iteration=rng.randrange(256),
            round=rng.randrange(4), compact_ids=[i[:4] for i in ids],
            root=rng.randbytes(32), eligibility_proof=rng.randbytes(80),
            eligibility_count=rng.randrange(1 << 16),
            atx_id=rng.randbytes(32), node_id=rng.randbytes(32),
            cert_msgs=[rng.randbytes(40)], signature=rng.randbytes(64)),
        BeaconProposal=dict(epoch=rng.randrange(1 << 32),
                            atx_id=rng.randbytes(32),
                            node_id=rng.randbytes(32),
                            vrf_proof=rng.randbytes(80)),
        FirstVotes=dict(epoch=rng.randrange(1 << 32), valid=ids,
                        late=ids[:1], atx_id=rng.randbytes(32),
                        node_id=rng.randbytes(32),
                        signature=rng.randbytes(64)),
        FollowVotes=dict(epoch=rng.randrange(1 << 32),
                         round=rng.randrange(256), votes_for=ids,
                         atx_id=rng.randbytes(32), node_id=rng.randbytes(32),
                         signature=rng.randbytes(64)),
        WeakCoinMsg=dict(epoch=rng.randrange(1 << 32),
                         round=rng.randrange(256), atx_id=rng.randbytes(32),
                         node_id=rng.randbytes(32),
                         vrf_proof=rng.randbytes(80)))


WIRE = ("HareMessage", "CompactHareMessage", "BeaconProposal", "FirstVotes",
        "FollowVotes", "WeakCoinMsg")


@pytest.mark.parametrize("cls", WIRE)
def test_wire_messages_equal_bytes_and_cross_decode(cls):
    home = "hare" if "Hare" in cls else "beacon"
    for seed in range(6):
        fields = _wire_values(random.Random(seed))[cls]
        jm = getattr(J[home], cls)(**fields)
        tm = getattr(T[home], cls)(**fields)
        raw = tm.to_bytes()
        assert raw == jm.to_bytes()
        assert getattr(J[home], cls).from_bytes(raw).to_bytes() == raw
        assert getattr(T[home], cls).from_bytes(raw) == tm
        if hasattr(tm, "signed_bytes"):
            assert tm.signed_bytes() == jm.signed_bytes()
        with pytest.raises(Exception):
            getattr(T[home], cls).from_bytes(raw + b"\x00")
        with pytest.raises(Exception):
            getattr(J[home], cls).from_bytes(raw + b"\x00")
    vals = sorted(_seeds(b"root", 3))
    assert thare.values_root(vals) == jhare.values_root(vals)
    assert thare3.values_ref(vals) == jhare3.values_ref(vals)
    assert thare.compact_id(vals[0]) == jhare.compact_id(vals[0])
    assert tbeacon.proposal_alpha(7) == jbeacon.proposal_alpha(7)
    assert tbeacon.weak_coin_alpha(7, 3) == jbeacon.weak_coin_alpha(7, 3)
    assert telig.hare_alpha(BEACON, 9, 6) == jelig.hare_alpha(BEACON, 9, 6)
    assert telig.proposal_alpha(BEACON, 2, 5) == \
        jelig.proposal_alpha(BEACON, 2, 5)


# --- Hare sessions -----------------------------------------------------

# identities whose draws carry margin at a 30-seat committee (the seeds of
# the JAX package's tests/test_hare_compact.py: every draw replays)
COMPACT_SEEDS = [hashlib.sha256(b"hare-compact-6-%d" % i).digest()
                 for i in range(4)]
COMMITTEE = 30


async def _abeacon(epoch):
    return BEACON


class _Net:
    """One LoopbackHub and one LoopbackNet for nodes of either package;
    each package's oracle reads its own AtxCache of the same identities."""

    def __init__(self, seeds=COMPACT_SEEDS, weight=100, hub=tps):
        self.hub = hub.LoopbackHub()
        self.net = LoopbackNet()
        self.seeds = seeds
        self.caches = {}
        for name, pkg in PKGS.items():
            self.caches[name] = _cache(pkg, _signers(pkg, seeds),
                                       [weight] * len(seeds))

    def hare(self, name, i, outs, *, proposals=(), store=None, equivs=None,
             wall=None, server=True, **kw):
        pkg = PKGS[name]
        signer = pkg["sig"].EdSigner(seed=self.seeds[i], prefix=GEN)
        cache, atx_ids = self.caches[name]
        ps = pkg["ps"].PubSub(node_name=signer.node_id)
        self.hub.join(ps)
        srv = None
        if server:
            srv = Server(signer.node_id)
            self.net.join(srv)

        async def on_output(out):
            outs.append((name, signer.node_id, out.layer,
                         tuple(out.proposals), out.completed))

        store = store if store is not None else {LAYER: list(proposals)}
        return pkg["hare"].Hare(
            signers=[signer], verifier=pkg["sig"].EdVerifier(prefix=GEN),
            oracle=pkg["elig"].Oracle(cache, LPE), pubsub=ps,
            committee_size=kw.pop("committee_size", COMMITTEE),
            round_duration=0.15, iteration_limit=2, preround_delay=0.15,
            layers_per_epoch=LPE, beacon_of=_abeacon,
            atx_for=lambda epoch, node_id: atx_ids.get(node_id),
            proposals_for=lambda layer: list(store.get(layer, [])),
            on_output=on_output,
            on_equivocation=(equivs.append if equivs is not None else None),
            wall=wall, server=srv, **kw)

    def sign(self, name, i, *, round_, values, iteration=0, count=None,
             cert=(), layer=LAYER, committee=COMMITTEE):
        """A valid message from identity ``i`` (or one with a forged
        ``count``), built by package ``name``."""
        pkg = PKGS[name]
        signer = pkg["sig"].EdSigner(seed=self.seeds[i], prefix=GEN)
        cache, atx_ids = self.caches[name]
        oracle = pkg["elig"].Oracle(cache, LPE)
        atx_id = atx_ids[signer.node_id]
        el = oracle.hare_eligibility(signer.vrf_signer(), BEACON, layer,
                                     iteration * 4 + round_, EPOCH, atx_id,
                                     committee)
        proof, real = el if el else (bytes(80), 0)
        msg = pkg["hare"].HareMessage(
            layer=layer, iteration=iteration, round=round_,
            values=sorted(values), eligibility_proof=proof,
            eligibility_count=real if count is None else count,
            atx_id=atx_id, node_id=signer.node_id, cert_msgs=list(cert),
            signature=bytes(64))
        msg.signature = signer.sign(pkg["sig"].Domain.HARE,
                                    msg.signed_bytes())
        return msg


@pytest.mark.parametrize("mix", ["port", "mixed"])
def test_agreement_despite_equivocator(mix):
    """Identity 3 sends two conflicting PREROUNDs and two conflicting
    COMMITs; the three honest nodes (all port, or port, JAX, port) output
    ONE non-empty set and each reports the equivocator exactly once."""
    names = ["port", "port", "port"] if mix == "port" else \
        ["port", "jax", "port"]
    net = _Net()
    val = sum256(b"the proposal")
    outs = []
    equivs = [[] for _ in names]

    async def go():
        loop = asyncio.get_running_loop()
        hares = [net.hare(n, i, outs, proposals=[val], equivs=equivs[i],
                          wall=loop.time, server=False)
                 for i, n in enumerate(names)]
        evil_ps = tps.PubSub(node_name=b"evil")
        net.hub.join(evil_ps)

        async def adversary():
            for vals in ([val], [sum256(b"other")]):
                m = net.sign("port", 3, round_=thare.PREROUND, values=vals)
                await evil_ps.publish(tps.TOPIC_HARE, m.to_bytes())
            await asyncio.sleep(0.35)
            for vals in ([val], [sum256(b"sneaky")]):
                m = net.sign("port", 3, round_=thare.COMMIT, values=vals)
                await evil_ps.publish(tps.TOPIC_HARE, m.to_bytes())

        await asyncio.gather(*(h.run_layer(LAYER) for h in hares),
                             adversary())

    run_virtual(go(), timeout=300)
    results = {(layer, props, done) for _, _, layer, props, done in outs}
    assert len(outs) == 3 and len(results) == 1, outs
    assert results.pop() == (LAYER, (val,), True)
    evil_id = tsig.EdSigner(seed=COMPACT_SEEDS[3], prefix=GEN).node_id
    for per_node in equivs:
        assert [e.node_id for e in per_node] == [evil_id]


def test_forged_eligibility_count_rejected_by_both():
    net = _Net()
    outs = []
    hares = {n: net.hare(n, 0, outs, server=False) for n in PKGS}

    async def go():
        for built in PKGS:
            forged = net.sign(built, 1, round_=thare.PREROUND,
                              values=[sum256(b"x")], count=COMMITTEE)
            honest = net.sign(built, 1, round_=thare.PREROUND,
                              values=[sum256(b"x")])
            assert forged.to_bytes() != honest.to_bytes()
            for h in hares.values():
                assert not await h._gossip(b"peer", forged.to_bytes())
                assert await h._gossip(b"peer", honest.to_bytes())

    asyncio.run(go())


def test_notify_needs_a_certificate_in_both():
    """A NOTIFY without a commit certificate is refused by both packages'
    nodes; with commits from enough weight (built by the other package)
    it is accepted by both."""
    net = _Net()
    outs = []
    hares = {n: net.hare(n, 0, outs, server=False) for n in PKGS}
    real = sum256(b"real")

    async def go():
        for built, other in (("port", "jax"), ("jax", "port")):
            bare = net.sign(built, 1, round_=thare.NOTIFY,
                            values=[sum256(b"fake-agreement")])
            commits = [net.sign(other, i, round_=thare.COMMIT,
                                values=[real]).to_bytes() for i in range(3)]
            certified = net.sign(built, 1, round_=thare.NOTIFY,
                                 values=[real], cert=commits)
            short = net.sign(built, 1, round_=thare.NOTIFY, values=[real],
                             cert=commits[:1])
            for h in hares.values():
                assert not await h._gossip(b"peer", bare.to_bytes())
                assert not await h._gossip(b"peer", short.to_bytes())
                assert await h._gossip(b"peer", certified.to_bytes())

    asyncio.run(go())


def test_late_commit_gets_no_grade():
    net = _Net()
    hare = net.hare("port", 0, [], server=False)
    msg = net.sign("port", 1, round_=thare.COMMIT, values=[sum256(b"v")])
    target = thare3.IterRound(0, thare3.COMMIT)
    session = thare.HareSession(hare, LAYER, [])
    for _ in range(11):  # preround..(1, wait1): 5 past commit
        session.protocol.next()
    session.on_message(msg)
    gi = session.protocol.gossip.state[(target, msg.node_id)]
    assert gi.received.grade(target) < thare3.GRADE3
    assert session.commit_weight(tuple(sorted(msg.values))) > 0
    fresh = thare.HareSession(hare, LAYER, [])
    fresh.on_message(msg)
    gi = fresh.protocol.gossip.state[(target, msg.node_id)]
    assert gi.received.grade(target) >= thare3.GRADE5


@pytest.mark.parametrize("names", [("port",) * 3, ("port", "jax", "port")],
                         ids=["port", "mixed"])
def test_compact_agreement_with_shared_store(names):
    net = _Net()
    props = sorted([sum256(b"p1"), sum256(b"p2")])
    outs = []

    async def go():
        loop = asyncio.get_running_loop()
        hares = [net.hare(n, i, outs, proposals=props, wall=loop.time,
                          compact=True) for i, n in enumerate(names)]
        await asyncio.gather(*(h.run_layer(LAYER) for h in hares))

    run_virtual(go(), timeout=300)
    assert {o[3] for o in outs} == {tuple(props)} and len(outs) == 3


def test_compact_full_exchange_recovers_missing_proposals():
    """The third node's proposal store is empty: it rebuilds every compact
    message's ids over hf/1 from the delivering peer."""
    net = _Net()
    props = sorted([sum256(b"q1"), sum256(b"q2"), sum256(b"q3")])
    outs = []

    async def go():
        loop = asyncio.get_running_loop()
        hares = [net.hare("port", 0, outs, proposals=props, wall=loop.time,
                          compact=True),
                 net.hare("jax", 1, outs, proposals=props, wall=loop.time,
                          compact=True),
                 net.hare("port", 2, outs, store={}, wall=loop.time,
                          compact=True)]
        await asyncio.gather(*(h.run_layer(LAYER) for h in hares))

    run_virtual(go(), timeout=300)
    by_node = {o[1]: o[3] for o in outs}
    assert len(by_node) == 3 and set(by_node.values()) == {tuple(props)}


def test_compact_root_mismatch_and_serve_full():
    net = _Net()
    props = [sum256(b"z1")]
    hare = net.hare("port", 0, [], proposals=props, compact=True)
    signer = tsig.EdSigner(seed=COMPACT_SEEDS[1], prefix=GEN)
    cache, atx_ids = net.caches["port"]
    el = telig.Oracle(cache, LPE).hare_eligibility(
        signer.vrf_signer(), BEACON, LAYER, thare.COMMIT, EPOCH,
        atx_ids[signer.node_id], COMMITTEE)
    assert el is not None
    proof, count = el

    def compact(root):
        cm = thare.CompactHareMessage(
            layer=LAYER, iteration=0, round=thare.COMMIT,
            compact_ids=[thare.compact_id(p) for p in props], root=root,
            eligibility_proof=proof, eligibility_count=count,
            atx_id=atx_ids[signer.node_id], node_id=signer.node_id,
            cert_msgs=[], signature=bytes(64))
        cm.signature = signer.sign(tsig.Domain.HARE, cm.signed_bytes())
        return cm.to_bytes()

    async def go():
        assert not await hare._gossip_compact(b"peer", compact(bytes(32)))
        assert await hare._gossip_compact(b"peer", compact(
            thare.values_root(props)))
        key = (LAYER, 0, thare.COMMIT, signer.node_id)
        assert await hare._serve_full(b"p", b"\0" * 5) == b""
        import struct

        req = struct.pack("<IBB", *key[:3]) + key[3]
        assert await hare._serve_full(b"p", req) == b"".join(props)

    asyncio.run(go())


def test_committee_and_compact_upgrade_across_the_flip():
    """committee_upgrade [flip, 20] and compact_enable_layer flip: the
    layer before the flip runs plain hare at 30 seats, the flip layer
    compact hare at 20; both packages' nodes agree on each and send on
    the right topic."""
    flip = LAYER + 1
    net = _Net()
    props = {LAYER: [sum256(b"before")], flip: [sum256(b"after")]}
    outs, topics = [], []

    async def go():
        loop = asyncio.get_running_loop()
        hares = [net.hare(n, i, outs, store=props, wall=loop.time,
                          committee_upgrade=(flip, 20),
                          compact_enable_layer=flip)
                 for i, n in enumerate(("port", "jax", "port"))]
        tap = tps.PubSub(node_name=b"tap")
        net.hub.join(tap)
        for topic in (tps.TOPIC_HARE, thare.TOPIC_HARE_COMPACT):
            async def record(peer, data, topic=topic):
                topics.append((topic, data))
                return True
            tap.register(topic, record)
        h = hares[0]
        assert (h.committee_for(LAYER), h.compact_for(LAYER)) == (30, False)
        assert (h.committee_for(flip), h.compact_for(flip)) == (20, True)
        for layer in (LAYER, flip):
            await asyncio.gather(*(h.run_layer(layer) for h in hares))

    run_virtual(go(), timeout=600)
    for layer in (LAYER, flip):
        got = {o[3] for o in outs if o[2] == layer}
        assert got == {tuple(props[layer])}, (layer, outs)
    layers_on = {}
    for topic, data in topics:
        cls = thare.HareMessage if topic == tps.TOPIC_HARE \
            else thare.CompactHareMessage
        layers_on.setdefault(topic, set()).add(cls.from_bytes(data).layer)
    assert layers_on == {tps.TOPIC_HARE: {LAYER},
                         thare.TOPIC_HARE_COMPACT: {flip}}


# --- beacon ------------------------------------------------------------

B_EPOCH = 2


def _driver(name, hub, cache, signer, wall, **kw):
    pkg = PKGS[name]
    ps = pkg["ps"].PubSub(node_name=signer.node_id)
    hub.join(ps)
    db = pkg["db"].open_state(":memory:")
    drv = pkg["beacon"].ProtocolDriver(
        db=db, oracle=pkg["elig"].Oracle(cache, LPE), pubsub=ps,
        genesis_id=GEN, verifier=pkg["sig"].EdVerifier(prefix=GEN),
        proposal_duration=kw.pop("proposal_duration", 0.4),
        first_voting_round_duration=0.8, voting_round_duration=0.8,
        rounds_number=2, grace_period=0.3, theta=0.25, wall=wall, **kw)
    return drv, db


@pytest.mark.parametrize("names", [("port",) * 3, ("port", "jax", "port")],
                         ids=["port", "mixed"])
def test_beacon_nodes_converge_on_one_protocol_beacon(names):
    seeds = _seeds(b"beacon", 3)
    caches = {n: _cache(PKGS[n], _signers(PKGS[n], seeds), [100] * 3,
                        epoch=B_EPOCH, tag=b"BATX") for n in PKGS}
    hub = tps.LoopbackHub()

    async def go():
        loop = asyncio.get_running_loop()
        runs, dbs = [], []
        for i, n in enumerate(names):
            signer = PKGS[n]["sig"].EdSigner(seed=seeds[i], prefix=GEN)
            cache, ids = caches[n]
            drv, db = _driver(n, hub, cache, signer, loop.time)
            dbs.append((n, db))
            runs.append(drv.run_epoch(B_EPOCH, signer, signer.vrf_signer(),
                                      ids[signer.node_id]))
        return await asyncio.gather(*runs), dbs

    beacons, dbs = run_virtual(go(), timeout=300)
    assert len(set(beacons)) == 1 and len(beacons[0]) == tbeacon.BEACON_SIZE
    for n, db in dbs:
        assert PKGS[n]["misc"].beacon_source(db, B_EPOCH) == \
            tmisc.BEACON_PROTOCOL


def test_beacon_forged_proposal_and_late_node():
    """Identity 0 gossips a proposal under identity 1's ATX with its own
    VRF proof and withholds its votes; identity 3 starts after the
    proposal phase. The honest and late nodes decide one beacon, and
    node 1's slot holds its own proposal."""
    seeds = _seeds(b"beacon-adv", 4)
    signers = _signers(T, seeds)
    cache, ids = _cache(T, signers, [100] * 4, epoch=B_EPOCH, tag=b"BATX")
    jcache_, _ = _cache(J, _signers(J, seeds), [100] * 4, epoch=B_EPOCH,
                        tag=b"BATX")
    hub = tps.LoopbackHub()
    forged = tbeacon.BeaconProposal(
        epoch=B_EPOCH, atx_id=ids[signers[1].node_id],
        node_id=signers[1].node_id,
        vrf_proof=signers[0].vrf_signer().prove(
            tbeacon.proposal_alpha(B_EPOCH)))

    async def go():
        loop = asyncio.get_running_loop()
        honest = [_driver("port", hub, cache, s, loop.time)[0]
                  for s in signers[1:3]]
        late, _ = _driver("jax", hub, jcache_, J["sig"].EdSigner(
            seed=seeds[3], prefix=GEN), loop.time)
        adv = tps.PubSub(node_name=b"adv")
        hub.join(adv)
        for drv in (honest[0], late):
            assert not await drv._on_proposal(b"adv", forged.to_bytes())

        async def adversary():
            for _ in range(3):
                await adv.publish(tps.TOPIC_BEACON_PROPOSAL,
                                  forged.to_bytes())
                await asyncio.sleep(0.05)

        async def late_runner():
            await asyncio.sleep(0.5)
            js = J["sig"].EdSigner(seed=seeds[3], prefix=GEN)
            return await late.run_epoch(B_EPOCH, js, js.vrf_signer(),
                                        ids[signers[3].node_id])

        res = await asyncio.gather(
            *(d.run_epoch(B_EPOCH, s, s.vrf_signer(), ids[s.node_id])
              for d, s in zip(honest, signers[1:3])),
            late_runner(), adversary())
        return res[:3], honest

    beacons, honest = run_virtual(go(), timeout=300)
    assert len(set(beacons)) == 1, beacons
    legit = tbeacon.proposal_id(signers[1].vrf_signer().prove(
        tbeacon.proposal_alpha(B_EPOCH)))
    for d in honest:
        st = d._states.get(B_EPOCH)
        if st and signers[1].node_id in st.proposals:
            assert st.proposals[signers[1].node_id][0] == legit


def test_beacon_fallback_only_on_timeout_and_protocol_is_final():
    signer = tsig.EdSigner(seed=_seeds(b"beacon-fb", 1)[0], prefix=GEN)
    reasons = []

    async def go():
        loop = asyncio.get_running_loop()
        empty = tcache.AtxCache()
        drv, db = _driver("port", tps.LoopbackHub(), empty, signer,
                          loop.time,
                          on_fallback_used=lambda e, r: reasons.append(r))
        beacon = await drv.run_epoch(B_EPOCH, signer, signer.vrf_signer(),
                                     None)
        assert beacon == drv._bootstrap(B_EPOCH)
        assert tmisc.beacon_source(db, B_EPOCH) == tmisc.BEACON_GUESS
        cache, ids = _cache(T, [signer], [100], epoch=B_EPOCH, tag=b"BATX")
        drv2, db2 = _driver("port", tps.LoopbackHub(), cache, signer,
                            loop.time)
        b1 = await drv2.run_epoch(B_EPOCH, signer, signer.vrf_signer(),
                                  ids[signer.node_id])
        drv2.on_fallback(B_EPOCH, b"\xde\xad\xbe\xef")
        assert tmisc.get_beacon(db2, B_EPOCH) == b1
        drv2.on_fallback(5, b"\x01\x02\x03\x04")
        drv2.on_fallback(5, b"\x05\x06\x07\x08")
        assert tmisc.get_beacon(db2, 5) == b"\x05\x06\x07\x08"
        jdrv = jbeacon.ProtocolDriver(
            db=jdb.open_state(":memory:"), oracle=jelig.Oracle(
                jcache.AtxCache(), LPE), pubsub=jps.PubSub(node_name=b"j"),
            genesis_id=GEN)
        for epoch in (0, 1, 2, 9):
            assert drv._bootstrap(epoch) == jdrv._bootstrap(epoch)
        assert drv.get_now(0) == jdrv.get_now(0)

    run_virtual(go(), timeout=300)
    assert reasons and "no proposals" in reasons[0]
