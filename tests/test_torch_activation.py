"""ATX validation in the port (``spacemesh_tpu_torch/consensus/
{activation,activation_v2,malfeasance,certifier,poet}.py`` over
``p2p/pubsub.py`` and ``storage/``) against the JAX package's.

At the sizes of ``tests/test_atx_v2.py`` (scrypt N=2, 256 labels per
unit, k1=64, k2=8, k3=4) on ``device="cpu"``: the JAX test file's cases
(all but the checkpoint round trip, which waits for ``node/checkpoint.py``)
on the port; wire ATXs built by each package's ``Builder`` cross a
``LoopbackHub`` to validating nodes of both packages with equal verdicts,
stored rows and cache entries; inline ``process`` against the farm's
``process_async``; an InvalidPostIndex proof over an index shown against
``hashlib.scrypt`` not to qualify (seeded signers throughout, so no case
depends on a random key); the certifier against ``verify``. Exact
equality is the tolerance.
"""

import asyncio
import dataclasses
import hashlib
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from spacemesh_tpu.consensus import activation as jact
from spacemesh_tpu.consensus import activation_v2 as jact2
from spacemesh_tpu.consensus import certifier as jcert
from spacemesh_tpu.consensus import malfeasance as jmal
from spacemesh_tpu.consensus import poet as jpoet
from spacemesh_tpu.core import signing as jsig
from spacemesh_tpu.core import types as jtypes
from spacemesh_tpu.p2p import pubsub as jps
from spacemesh_tpu.post import initializer as jinit
from spacemesh_tpu.post import prover as jprover
from spacemesh_tpu.post import service as jservice
from spacemesh_tpu.storage import cache as jcache
from spacemesh_tpu.storage import db as jdb
from spacemesh_tpu_torch.consensus import activation as act
from spacemesh_tpu_torch.consensus import activation_v2 as act2
from spacemesh_tpu_torch.consensus import certifier as cert
from spacemesh_tpu_torch.consensus import hare
from spacemesh_tpu_torch.consensus import malfeasance as mal
from spacemesh_tpu_torch.consensus import poet
from spacemesh_tpu_torch.core import signing as sig
from spacemesh_tpu_torch.core import types
from spacemesh_tpu_torch.core.hashing import sum256
from spacemesh_tpu_torch.ops import proving
from spacemesh_tpu_torch.p2p import pubsub as ps
from spacemesh_tpu_torch.post import initializer
from spacemesh_tpu_torch.post import prover
from spacemesh_tpu_torch.post import service
from spacemesh_tpu_torch.post import verifier as pv
from spacemesh_tpu_torch.storage import atxs as atxstore
from spacemesh_tpu_torch.storage import cache as tcache
from spacemesh_tpu_torch.storage import db as dbmod
from spacemesh_tpu_torch.storage import misc as miscstore
from spacemesh_tpu_torch.utils import metrics, tracing
from spacemesh_tpu_torch.verify.farm import VerificationFarm

GEN = b"atxv2-test-genesis!!"
GOLDEN = sum256(b"golden", GEN)
PARAMS = prover.ProofParams(k1=64, k2=8, k3=4,
                            pow_difficulty=b"\x20" + b"\xff" * 31)
JPARAMS = jprover.ProofParams(k1=64, k2=8, k3=4,
                              pow_difficulty=b"\x20" + b"\xff" * 31)
LPU = 256  # labels per unit
N = 2
NOW = 1234.5  # receipt time, so stored rows compare across packages


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def signer(seed: int, pkg=sig):
    """A seeded identity (the same key in both packages)."""
    return pkg.EdSigner(seed=hashlib.sha256(b"atx-signer-%d" % seed)
                        .digest(), prefix=GEN)


def init_post(d, s, pkg="port"):
    """Tiny POST data for ``s``; a PostClient over it."""
    if pkg == "port":
        initializer.initialize(
            d, node_id=s.node_id, commitment=act.commitment_of(s.node_id,
                                                               GOLDEN),
            num_units=1, labels_per_unit=LPU, scrypt_n=N, batch_size=128,
            device="cpu")
        return service.PostClient(d, PARAMS, device="cpu")
    jinit.initialize(
        d, node_id=s.node_id, commitment=jact.commitment_of(s.node_id,
                                                            GOLDEN),
        num_units=1, labels_per_unit=LPU, scrypt_n=N, batch_size=128)
    return jservice.PostClient(d, JPARAMS)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Two identities with port-initialized POST data and a merged ATX
    built by the port (the JAX test file's ``world``)."""
    tmp = tmp_path_factory.mktemp("tatxv2")
    primary, partner = signer(1), signer(2)
    clients = {s.node_id: init_post(tmp / s.node_id.hex()[:12], s)
               for s in (primary, partner)}
    db = dbmod.open_state(":memory:")
    p = poet.PoetService(poet_id=sum256(b"poet", GEN), ticks=64)
    atx2 = asyncio.run(act2.build_merged_atx(
        primary=primary, partners=[partner], db=db, poet=p,
        post_clients=clients, golden_atx=GOLDEN, coinbase=bytes(24),
        publish_epoch=1, execute_round=True))
    return primary, partner, db, atx2


def _handler(db, farm=None):
    cache = tcache.AtxCache()
    return act2.HandlerV2(
        db=db, cache=cache, verifier=sig.EdVerifier(prefix=GEN),
        golden_atx=GOLDEN, post_params=PARAMS, labels_per_unit=LPU,
        scrypt_n=N, farm=farm, device="cpu", now=lambda: NOW), cache


# --- the cases of tests/test_atx_v2.py, on the port -----------------------


def test_merged_atx_validates_and_stores_per_identity(world):
    primary, partner, db, atx2 = world
    handler, cache = _handler(db)
    assert handler.process(atx2)
    for s in (primary, partner):
        view = atxstore.by_node_in_epoch(db, s.node_id, 1)
        assert view is not None
        assert view.id == atx2.identity_atx_id(s.node_id)
        assert view.version == 2
        info = cache.get(2, view.id)
        assert info is not None and info.node_id == s.node_id
        assert info.weight > 0
    m1 = miscstore.marriage_of(db, primary.node_id)
    m2 = miscstore.marriage_of(db, partner.node_id)
    assert m1 == m2 == atx2.id


def test_unmarried_identity_rejected(world):
    primary, partner, db, atx2 = world
    stranger = signer(3)
    bad = dataclasses.replace(
        atx2,
        subposts=[dataclasses.replace(atx2.subposts[0]),
                  dataclasses.replace(atx2.subposts[1],
                                      node_id=stranger.node_id)],
        signature=bytes(64))
    bad = dataclasses.replace(
        bad, signature=primary.sign(sig.Domain.ATX, bad.signed_bytes()))
    handler, _ = _handler(db)
    assert not handler.process(bad)


def test_forged_marriage_cert_rejected(world):
    primary, partner, db, atx2 = world
    stranger = signer(4)
    forged = types.MarriageCert(
        partner_id=partner.node_id,
        signature=stranger.sign(sig.Domain.ATX,
                                types.MarriageCert.message(primary.node_id)))
    bad = dataclasses.replace(atx2, marriages=[forged], signature=bytes(64))
    bad = dataclasses.replace(
        bad, signature=primary.sign(sig.Domain.ATX, bad.signed_bytes()))
    handler, _ = _handler(db)
    assert not handler.process(bad)


def _out_of_range(sp):
    return dataclasses.replace(sp, nipost=dataclasses.replace(
        sp.nipost, post=dataclasses.replace(
            sp.nipost.post,
            indices=[LPU + 1 + i for i in sp.nipost.post.indices])))


def test_process_async_parity_with_inline(world):
    """HandlerV2.process (inline) and process_async (the farm) return the
    same verdicts: valid, bad signature, tampered POST."""
    primary, partner, db, atx2 = world
    bad_sig = dataclasses.replace(atx2, signature=bytes(64))
    tampered = dataclasses.replace(
        atx2, subposts=[_out_of_range(atx2.subposts[0]), atx2.subposts[1]],
        signature=bytes(64))
    tampered = dataclasses.replace(
        tampered, signature=primary.sign(sig.Domain.ATX,
                                         tampered.signed_bytes()))
    envelopes = [atx2, bad_sig, tampered]

    async def farm_verdicts():
        farm = VerificationFarm(ed_verifier=sig.EdVerifier(prefix=GEN),
                                post_params=PARAMS, device="cpu")
        h, _ = _handler(db, farm)
        out = [await h.process_async(e) for e in envelopes]
        await farm.aclose()
        return out

    got = asyncio.run(farm_verdicts())
    h2, _ = _handler(db)
    expected = [h2.process(e) for e in envelopes]
    assert got == expected == [True, False, False]


def test_marriage_condemns_whole_set(world):
    primary, partner, db, atx2 = world
    handler, cache = _handler(db)
    assert handler.process(atx2)
    m = mal.Handler(db=db, cache=cache, verifier=sig.EdVerifier(prefix=GEN),
                    pubsub=ps.PubSub(node_name=b"test"), device="cpu")

    def hare_msg(values):
        msg = hare.HareMessage(layer=3, iteration=0, round=0, values=values,
                               eligibility_proof=bytes(80),
                               eligibility_count=1, atx_id=bytes(32),
                               node_id=partner.node_id, cert_msgs=[],
                               signature=bytes(64))
        msg.signature = partner.sign(sig.Domain.HARE, msg.signed_bytes())
        return msg

    m1, m2 = hare_msg([sum256(b"x")]), hare_msg([sum256(b"y")])
    proof = types.MalfeasanceProof(
        domain=int(sig.Domain.HARE), msg1=m1.signed_bytes(),
        sig1=m1.signature, msg2=m2.signed_bytes(), sig2=m2.signature,
        node_id=partner.node_id)
    assert m.validate(proof)
    assert jmal.Handler(db=jdb.open_state(), cache=jcache.AtxCache(),
                        verifier=jsig.EdVerifier(prefix=GEN),
                        pubsub=jps.PubSub()).validate(
        jtypes.MalfeasanceProof.from_bytes(proof.to_bytes()))
    assert m.process(proof)
    assert miscstore.is_malicious(db, partner.node_id)
    assert miscstore.is_malicious(db, primary.node_id), \
        "married primary must fall with the equivocating partner"
    assert cache.is_malicious(primary.node_id)


@pytest.fixture(scope="module")
def v1_world(tmp_path_factory):
    """One identity with a real v1 ATX (own poet round + POST proof)."""
    tmp = tmp_path_factory.mktemp("tatxv1")
    s = signer(5)
    client = init_post(tmp / "post", s)
    db = dbmod.open_state(":memory:")
    p = poet.PoetService(poet_id=sum256(b"poet-v1", GEN), ticks=64)
    challenge = act.nipost_challenge(types.EMPTY32, 1)

    async def run_round():
        await p.register("1", challenge)
        return await p.execute_round("1")

    result = asyncio.run(run_round())
    act.store_poet_blob(db, poet.PoetBlob(proof=result.proof,
                                          member_count=len(result.members)))
    proof, _meta = client.proof(act.post_challenge(result.proof.root,
                                                   challenge))
    info = client.info()
    atx = types.ActivationTx(
        publish_epoch=1, prev_atx=types.EMPTY32, pos_atx=GOLDEN,
        commitment_atx=act.commitment_of(s.node_id, GOLDEN),
        initial_post=None,
        nipost=types.NIPost(
            membership=result.membership(challenge),
            post=types.Post(nonce=proof.nonce, indices=proof.indices,
                            pow_nonce=proof.pow_nonce),
            post_metadata=types.PostMetadataWire(
                challenge=result.proof.id,
                labels_per_unit=info.labels_per_unit)),
        num_units=info.num_units, vrf_nonce=info.vrf_nonce,
        vrf_public_key=s.vrf_signer().public_key, coinbase=bytes(24),
        node_id=s.node_id, signature=bytes(64))
    atx = dataclasses.replace(
        atx, signature=s.sign(sig.Domain.ATX, atx.signed_bytes()))
    return s, db, atx, result


def _v1_handler(db, farm=None, device="cpu"):
    return act.Handler(
        db=db, cache=tcache.AtxCache(), verifier=sig.EdVerifier(prefix=GEN),
        golden_atx=GOLDEN, post_params=PARAMS, labels_per_unit=LPU,
        scrypt_n=N, pubsub=ps.PubSub(), farm=farm, device=device,
        now=lambda: NOW)


def _v1_tampered(s, atx):
    """valid, bad signature, wrong VRF key, tampered POST (out of range:
    a deterministic reject on both paths)."""
    bad_sig = dataclasses.replace(atx, signature=bytes(64))
    bad_vrf = dataclasses.replace(atx, vrf_public_key=bytes(32),
                                  signature=bytes(64))
    bad_vrf = dataclasses.replace(
        bad_vrf, signature=s.sign(sig.Domain.ATX, bad_vrf.signed_bytes()))
    tampered = dataclasses.replace(
        atx, nipost=dataclasses.replace(
            atx.nipost, post=dataclasses.replace(
                atx.nipost.post,
                indices=[LPU + 1 + i for i in atx.nipost.post.indices])),
        signature=bytes(64))
    tampered = dataclasses.replace(
        tampered, signature=s.sign(sig.Domain.ATX, tampered.signed_bytes()))
    return [atx, bad_sig, bad_vrf, tampered]


def test_v1_process_async_parity_with_inline(v1_world):
    s, db, atx, _ = v1_world
    envelopes = _v1_tampered(s, atx)

    async def farm_verdicts():
        farm = VerificationFarm(ed_verifier=sig.EdVerifier(prefix=GEN),
                                post_params=PARAMS, device="cpu")
        h = _v1_handler(db, farm)
        out = [await h.process_async(e) for e in envelopes]
        await farm.aclose()
        return out

    got = asyncio.run(farm_verdicts())
    expected = [_v1_handler(db).process(e) for e in envelopes]
    assert got == expected == [True, False, False, False]


def test_invalid_prev_atx_proof():
    """Two v1 ATXs claiming the same prev -> malfeasance."""
    db = dbmod.open_state(":memory:")
    cache = tcache.AtxCache()
    evil = signer(6)
    prev = sum256(b"some prev atx")

    def make_atx(epoch):
        atx = types.ActivationTx(
            publish_epoch=epoch, prev_atx=prev, pos_atx=GOLDEN,
            commitment_atx=None, initial_post=None,
            nipost=types.NIPost(
                membership=types.MerkleProof(leaf_index=0, nodes=[]),
                post=types.Post(nonce=0, indices=[1], pow_nonce=0),
                post_metadata=types.PostMetadataWire(
                    challenge=bytes(32), labels_per_unit=LPU)),
            num_units=1, vrf_nonce=0, vrf_public_key=evil.node_id,
            coinbase=bytes(24), node_id=evil.node_id, signature=bytes(64))
        return dataclasses.replace(
            atx, signature=evil.sign(sig.Domain.ATX, atx.signed_bytes()))

    a1, a2 = make_atx(3), make_atx(4)
    proof = mal.proof_from_atxs(a1, a2)
    assert proof.to_bytes() == jmal.proof_from_atxs(
        jtypes.ActivationTx.from_bytes(a1.to_bytes()),
        jtypes.ActivationTx.from_bytes(a2.to_bytes())).to_bytes()
    m = mal.Handler(db=db, cache=cache, verifier=sig.EdVerifier(prefix=GEN),
                    pubsub=ps.PubSub(node_name=b"t"), device="cpu")
    assert m.process(proof)
    assert miscstore.is_malicious(db, evil.node_id)
    # a second proof against the same identity is already known
    assert m.process(mal.proof_from_atxs(a2, a1))


def _label_value(commitment, index, challenge, nonce) -> int:
    """The proving hash of ``index``'s label, the label from hashlib."""
    label = np.frombuffer(hashlib.scrypt(
        commitment, salt=index.to_bytes(8, "little"), n=N, r=1, p=1,
        dklen=16), dtype=np.uint8)[None]
    return int(proving.proving_hashes(challenge, nonce, [index], label,
                                      device="cpu")[0])


def post_checker_for(poet_proof, params=PARAMS):
    """The node's InvalidPostIndex checker (JAX ``node/app.py:266-290``)
    over one poet proof: True when the index at ``index_pos`` fails its
    recompute on ``device``."""
    def check(atx, index_pos, device):
        challenge = act.nipost_challenge(atx.prev_atx, atx.publish_epoch)
        one = dataclasses.replace(params, k2=1, k3=1)
        item = pv.VerifyItem(
            proof=prover.Proof(nonce=atx.nipost.post.nonce,
                               indices=[atx.nipost.post.indices[index_pos]],
                               pow_nonce=atx.nipost.post.pow_nonce, k2=1),
            challenge=act.post_challenge(poet_proof.root, challenge),
            node_id=atx.node_id,
            commitment=act.commitment_of(atx.node_id, GOLDEN),
            scrypt_n=N, total_labels=atx.num_units * LPU)
        return not pv.verify(item, one, device=device)
    return check


@pytest.mark.parametrize("index_pos,condemned", [(0, True), (1, False)])
def test_invalid_post_index_proof(world, index_pos, condemned):
    """An ATX carrying a non-qualifying POST index is provably bad; the
    same proof over a qualifying index is not. Seeded signer; each index's
    verdict is shown first against hashlib.scrypt."""
    primary, partner, db, atx2 = world
    poet_proof = miscstore.poet_proof(
        db, atx2.subposts[0].nipost.post_metadata.challenge)
    assert poet_proof is not None
    cheat = signer(7)
    commitment = act.commitment_of(cheat.node_id, GOLDEN)
    challenge = act.post_challenge(poet_proof.root,
                                   act.nipost_challenge(bytes(32), 1))
    thr = proving.threshold_u32(PARAMS.k1, LPU)
    values = [_label_value(commitment, i, challenge, 0) for i in range(16)]
    miss = next(i for i, v in enumerate(values) if v >= thr)
    meet = next(i for i, v in enumerate(values) if v < thr)
    # a valid pow nonce, so that the one-index recompute reaches the label
    from spacemesh_tpu_torch.ops import pow as k2pow

    pow_nonce = k2pow.search(challenge, cheat.node_id,
                             PARAMS.pow_difficulty, device="cpu")
    atx = types.ActivationTx(
        publish_epoch=1, prev_atx=bytes(32), pos_atx=GOLDEN,
        commitment_atx=None, initial_post=None,
        nipost=types.NIPost(
            membership=atx2.subposts[0].nipost.membership,
            post=types.Post(nonce=0, indices=[miss, meet],
                            pow_nonce=pow_nonce),
            post_metadata=types.PostMetadataWire(challenge=poet_proof.id,
                                                 labels_per_unit=LPU)),
        num_units=1, vrf_nonce=0, vrf_public_key=cheat.node_id,
        coinbase=bytes(24), node_id=cheat.node_id, signature=bytes(64))
    atx = dataclasses.replace(
        atx, signature=cheat.sign(sig.Domain.ATX, atx.signed_bytes()))
    state = dbmod.open_state(":memory:")
    m = mal.Handler(db=state, cache=tcache.AtxCache(),
                    verifier=sig.EdVerifier(prefix=GEN),
                    pubsub=ps.PubSub(node_name=b"t"),
                    post_checker=post_checker_for(poet_proof), device="cpu")
    proof = mal.proof_invalid_post(atx, index_pos)
    assert m.process(proof) is condemned
    assert miscstore.is_malicious(state, cheat.node_id) is condemned


# --- wire ATXs across the packages ----------------------------------------


PKGS = {
    "jax": dict(act=jact, act2=jact2, poet=jpoet, ps=jps, sig=jsig,
                types=jtypes, db=jdb, cache=jcache, params=JPARAMS),
    "port": dict(act=act, act2=act2, poet=poet, ps=ps, sig=sig,
                 types=types, db=dbmod, cache=tcache, params=PARAMS),
}


class Validator:
    """A validating node of one package: state DB, cache, the v1 and v2
    handlers and a poet-blob handler on a PubSub."""

    def __init__(self, pkg: str):
        m = PKGS[pkg]
        self.pkg = pkg
        self.db = m["db"].open_state(":memory:")
        self.cache = m["cache"].AtxCache()
        self.pubsub = m["ps"].PubSub(node_name=pkg.encode())
        extra = dict(device="cpu") if pkg == "port" else {}
        common = dict(db=self.db, cache=self.cache,
                      verifier=m["sig"].EdVerifier(prefix=GEN),
                      golden_atx=GOLDEN, post_params=m["params"],
                      labels_per_unit=LPU, scrypt_n=N, now=lambda: NOW,
                      **extra)
        self.v1 = m["act"].Handler(pubsub=self.pubsub, **common)
        self.v2 = m["act2"].HandlerV2(pubsub=self.pubsub, **common)

        async def poet_blob(peer, data):
            m["act"].store_poet_blob(self.db,
                                     m["poet"].PoetBlob.from_bytes(data))
            return True

        self.pubsub.register(m["ps"].TOPIC_POET, poet_blob)

    def rows(self):
        return [tuple(r) for r in self.db.all(
            "SELECT id, node_id, publish_epoch, num_units, tick_height,"
            " vrf_nonce, coinbase, received, data, version FROM atxs"
            " ORDER BY id")]

    def cache_rows(self, epoch):
        return sorted((k, dataclasses.astuple(v))
                      for k, v in self.cache.iter_epoch(epoch))


async def build_v1(pkg: str, tmp, hub, seeds, epochs):
    """A smeshing node of ``pkg`` with one Builder per seeded identity,
    publishing on ``hub``; one poet round per epoch."""
    m = PKGS[pkg]
    node_db = m["db"].open_state(":memory:")
    node_ps = m["ps"].PubSub(node_name=b"smesher-" + pkg.encode())
    hub.join(node_ps)
    p = m["poet"].PoetService(poet_id=sum256(b"poet-x", GEN), ticks=16)
    extra = dict(device="cpu") if pkg == "port" else {}
    handler = m["act"].Handler(
        db=node_db, cache=m["cache"].AtxCache(),
        verifier=m["sig"].EdVerifier(prefix=GEN), golden_atx=GOLDEN,
        post_params=m["params"], labels_per_unit=LPU, scrypt_n=N,
        pubsub=node_ps, **extra)
    smeshers = []
    for seed in seeds:
        s = signer(seed, m["sig"])
        smeshers.append(m["act"].Builder(
            signer=s, db=node_db, pubsub=node_ps, poet=p,
            post_client=init_post(tmp / f"{pkg}-{seed}", s, pkg),
            golden_atx=GOLDEN, coinbase=bytes([seed]) * 24, handler=handler,
            num_units=1))
    out = []
    for epoch in epochs:
        for b in smeshers:
            await b.register_challenge(epoch)
        await p.execute_round(str(epoch))
        for b in smeshers:
            out.append(await b.finish(epoch))
        await hub.drain()
    return out


@pytest.mark.parametrize("origin", ["jax", "port"])
def test_wire_atxs_cross_packages_both_ways(tmp_path, origin):
    """ATXs built by one package's Builders cross a LoopbackHub to a JAX
    and a port validating node: equal stored rows and cache entries;
    tampered copies delivered to both give equal verdicts."""
    async def go():
        hub = ps.LoopbackHub()
        nodes = {k: Validator(k) for k in PKGS}
        for v in nodes.values():
            hub.join(v.pubsub)
        built = await build_v1(origin, tmp_path, hub, seeds=(11, 12),
                               epochs=(1, 2))
        await hub.drain()
        assert len(built) == 4
        verdicts = {}
        s = signer(11, PKGS[origin]["sig"])
        extra = _v1_tampered(s, dataclasses.replace(built[-2],
                                                    publish_epoch=3))
        for k, v in nodes.items():
            verdicts[k] = [await v.pubsub.deliver(ps.TOPIC_ATX, b"peer",
                                                  e.to_bytes())
                           for e in extra[1:]]
            verdicts[k].append(await v.pubsub.deliver(
                ps.TOPIC_ATX, b"peer", b"\x00garbage"))
        return nodes, built, verdicts

    nodes, built, verdicts = asyncio.run(go())
    assert verdicts["port"] == verdicts["jax"] == [False] * 4
    assert nodes["port"].rows() == nodes["jax"].rows()
    rows = nodes["port"].rows()
    assert sorted(r[0] for r in rows) == sorted(a.id for a in built)
    heights = {r[0]: r[4] for r in rows}
    for a in built:  # epoch 2 chains on epoch 1: ticks 16 + 16
        assert heights[a.id] == (32 if a.publish_epoch == 2 else 16)
    for epoch in (2, 3):
        assert nodes["port"].cache_rows(epoch) == \
            nodes["jax"].cache_rows(epoch)
        assert nodes["port"].cache.epoch_weight(epoch) == 2 * 16


def test_merged_atx_crosses_packages(world):
    """The port-built merged ATX: the JAX HandlerV2 and the port's, each
    over its own DB holding the poet blob, store the same rows."""
    primary, partner, db, atx2 = world
    blob_row = db.one("SELECT data FROM poet_proofs")
    count = db.one("SELECT data FROM active_sets")
    results = {}
    for k in PKGS:
        v = Validator(k)
        m = PKGS[k]
        m["act"].store_poet_blob(v.db, m["poet"].PoetBlob(
            proof=m["types"].PoetProof.from_bytes(blob_row["data"]),
            member_count=int.from_bytes(count["data"], "little")))
        env = m["types"].ActivationTxV2.from_bytes(atx2.to_bytes())
        results[k] = (v.v2.process(env), v.rows(), v.cache_rows(2))
    assert results["port"] == results["jax"]
    assert results["port"][0] is True and len(results["port"][1]) == 2


# --- gossip, poet, certifier ----------------------------------------------


def test_pubsub_tri_state_and_drops_match():
    """deliver's aggregate (False > None > True), a raising handler
    counted as a reject, and the gossip spans, as in the JAX package."""
    async def run(mod, metrics_mod):
        bus = mod.PubSub(node_name=b"n")
        calls = []

        async def ok(peer, data):
            calls.append("ok")
            return True

        async def quiet(peer, data):
            return None

        async def boom(peer, data):
            raise ValueError("bad message")

        bus.register("t1", ok)
        bus.register("t2", ok)
        bus.register("t2", quiet)
        bus.register("t3", boom)
        bus.register("t3", ok)
        out = [await bus.deliver(t, b"p", b"x") for t in ("t1", "t2", "t3",
                                                          "t4")]
        return out, calls

    got = asyncio.run(run(ps, metrics))
    from spacemesh_tpu.utils import metrics as jmetrics

    want = asyncio.run(run(jps, jmetrics))
    assert got == want
    assert got[0] == [True, None, False, True]
    assert got[1] == ["ok", "ok", "ok"]  # the raising handler did not stop t3
    text = metrics.REGISTRY.expose()
    assert 'pubsub_handler_drops_total{topic="t3"}' in text
    assert 'gossip_handler_seconds_bucket{topic="t1"' in text


def test_gossip_spans_recorded():
    tracing.stop()
    tracing.start(capacity=1024)
    try:
        async def go():
            bus = ps.PubSub()

            async def h(peer, data):
                return False

            bus.register(ps.TOPIC_ATX, h)
            return await bus.deliver(ps.TOPIC_ATX, b"\x01" * 8, b"abc")

        assert asyncio.run(go()) is False
        doc = tracing.export()
    finally:
        tracing.stop()
    spans = {e["name"]: e for e in doc["traceEvents"]
             if e.get("ph") == "X"}
    assert {"gossip.deliver", "gossip.handler"} <= set(spans)
    assert spans["gossip.deliver"]["args"]["result"] == "reject"
    assert spans["gossip.handler"]["args"]["topic"] == ps.TOPIC_ATX


def test_loopback_hub_orders_and_drains():
    async def go():
        hub = ps.LoopbackHub()
        a, b = ps.PubSub(b"a", deliver_self=False), ps.PubSub(b"b")
        hub.join(a)
        hub.join(b)
        seen = []

        async def h(peer, data):
            await asyncio.sleep(0)
            seen.append((peer, data))
            return True

        b.register("x", h)
        for i in range(5):
            await a.publish("x", bytes([i]))
        await hub.drain()
        hub.leave(b)
        await a.publish("x", b"gone")
        await hub.drain()
        return seen

    assert asyncio.run(go()) == [(b"a", bytes([i])) for i in range(5)]


@pytest.mark.parametrize("members", [1, 2, 5, 8, 13])
def test_poet_round_matches_jax(members):
    async def run(mod):
        p = mod.PoetService(poet_id=sum256(b"p"), ticks=8)
        chals = [sum256(b"c", bytes([i])) for i in range(members)]
        for c in reversed(chals):
            await p.register("7", c)
            await p.register("7", c)  # duplicates count once
        r = await p.execute_round("7")
        with pytest.raises(ValueError, match="closed"):
            await p.register("7", chals[0])
        return r, chals

    (tr, chals), (jr, _) = asyncio.run(run(poet)), asyncio.run(run(jpoet))
    assert tr.proof.to_bytes() == jr.proof.to_bytes()
    assert tr.members == jr.members
    blob = poet.PoetBlob(proof=tr.proof, member_count=len(tr.members))
    assert blob.to_bytes() == jpoet.PoetBlob(
        proof=jr.proof, member_count=len(jr.members)).to_bytes()
    for c in chals:
        mp = tr.membership(c)
        assert mp.to_bytes() == jr.membership(c).to_bytes()
        assert poet.verify_membership(c, mp, tr.proof.root, members)
    assert tr.membership(b"nope") is None
    assert poet.sequential_work(b"s", 5) == jpoet.sequential_work(b"s", 5)


@pytest.fixture(scope="module")
def cert_world(v1_world):
    s, db, atx, result = v1_world
    challenge = act.post_challenge(
        result.proof.root, act.nipost_challenge(types.EMPTY32, 1))
    p = atx.nipost.post
    proof = prover.Proof(nonce=p.nonce, indices=list(p.indices),
                         pow_nonce=p.pow_nonce, k2=PARAMS.k2)
    kw = dict(challenge=challenge, node_id=s.node_id,
              commitment=act.commitment_of(s.node_id, GOLDEN), num_units=1,
              labels_per_unit=LPU)
    return proof, kw


def _tampered_proof(proof):
    return dataclasses.replace(
        proof, indices=[LPU + 1 + i for i in proof.indices])


def test_certifier_against_verify(cert_world):
    """certify() signs exactly when verify() accepts, in both packages;
    the certificate checks and binds a poet registration."""
    proof, kw = cert_world
    key = signer(20)
    svc = cert.CertifierService(key, PARAMS, scrypt_n=N, device="cpu")
    jsvc = jcert.CertifierService(signer(20, jsig), JPARAMS, scrypt_n=N)
    item = pv.VerifyItem(proof=proof, challenge=kw["challenge"],
                         node_id=kw["node_id"], commitment=kw["commitment"],
                         scrypt_n=N, total_labels=LPU)
    assert pv.verify(item, PARAMS, device="cpu")
    c = svc.certify(proof=proof, **kw)
    jc = jsvc.certify(proof=jprover.Proof(**proof.to_dict()), **kw)
    assert c.to_dict() == jc.to_dict()
    v = sig.EdVerifier(prefix=GEN)
    assert cert.verify_cert(c, svc.pubkey, v)
    assert jcert.verify_cert(jcert.PoetCert.from_dict(c.to_dict()),
                             svc.pubkey, jsig.EdVerifier(prefix=GEN))
    bad = _tampered_proof(proof)
    assert not pv.verify(dataclasses.replace(item, proof=bad), PARAMS,
                         device="cpu")
    with pytest.raises(ValueError, match="failed verification"):
        svc.certify(proof=bad, **kw)
    with pytest.raises(ValueError, match="failed verification"):
        jsvc.certify(proof=jprover.Proof(**bad.to_dict()), **kw)
    expiring = cert.CertifierService(key, PARAMS, scrypt_n=N, validity=10.0,
                                     time_source=lambda: 100.0, device="cpu")
    ec = expiring.certify(proof=proof, **kw)
    assert ec.expiry == 110.0
    assert cert.verify_cert(ec, svc.pubkey, v, now=109.0)
    assert not cert.verify_cert(ec, svc.pubkey, v, now=111.0)

    # a cert-gated poet takes the certified identity's registration only
    node = signer(5)  # v1_world's identity, the proof's owner
    gated = poet.PoetService(poet_id=sum256(b"gated"),
                             certifier_pubkey=svc.pubkey, verifier=v)

    async def register():
        ch = sum256(b"challenge")
        await gated.register("1", ch, node_id=node.node_id, cert=c,
                             signature=node.sign(sig.Domain.POET,
                                                 b"1" + ch))
        with pytest.raises(PermissionError, match="signature"):
            await gated.register("1", ch, node_id=node.node_id, cert=c,
                                 signature=bytes(64))
        with pytest.raises(PermissionError, match="requires"):
            await gated.register("1", ch)
        return await gated.execute_round("1")

    assert len(asyncio.run(register()).members) == 1


def test_certifier_daemon_and_client_cross_packages(cert_world):
    """The port's daemon serves the JAX client and the port's client; a
    tampered proof comes back as the service's error."""
    proof, kw = cert_world
    svc = cert.CertifierService(signer(21), PARAMS, scrypt_n=N,
                                device="cpu")

    async def go():
        daemon = cert.CertifierDaemon(svc)
        addr = await daemon.start()
        try:
            out = {}
            for name, client_cls, pr in (
                    ("port", cert.CertifierClient, proof),
                    ("jax", jcert.CertifierClient,
                     jprover.Proof(**proof.to_dict()))):
                client = client_cls(addr, timeout=60)
                pub = await asyncio.to_thread(client.pubkey)
                c1 = await asyncio.to_thread(
                    lambda: client.certificate(proof=pr, **kw))
                c2 = await asyncio.to_thread(
                    lambda: client.certificate(proof=pr, **kw))
                assert c1 is c2  # cached per identity
                bad = dataclasses.replace(
                    pr, indices=[LPU + 1 + i for i in pr.indices])
                with pytest.raises(RuntimeError, match="failed verification"):
                    await asyncio.to_thread(
                        lambda: client_cls(addr, timeout=60).certificate(
                            proof=bad, **kw))
                out[name] = (pub, c1.to_dict())
            return out
        finally:
            await daemon.stop()

    out = asyncio.run(go())
    assert out["port"] == out["jax"]
    assert out["port"][0] == svc.pubkey


def test_certifier_server_cli_serves(cert_world):
    """``python -m spacemesh_tpu_torch.tools.certifier_server`` on the CPU
    prints its address and certifies over it."""
    proof, kw = cert_world
    seed = "07" * 32
    proc = subprocess.Popen(
        [sys.executable, "-m", "spacemesh_tpu_torch.tools.certifier_server",
         "--listen", "127.0.0.1:0", "--scrypt-n", str(N), "--k1", "64",
         "--k2", "8", "--k3", "4", "--pow-difficulty",
         (b"\x20" + b"\xff" * 31).hex(), "--key-seed", seed,
         "--device", "cpu"], stdout=subprocess.PIPE, text=True)
    try:
        line = json.loads(proc.stdout.readline())
        assert line["event"] == "Serving"
        assert line["pubkey"] == sig.EdSigner(
            seed=bytes.fromhex(seed)).public_key.hex()
        client = cert.CertifierClient((line["host"], line["port"]),
                                      timeout=120)
        c = client.certificate(proof=proof, **kw)
        assert cert.verify_cert(c, bytes.fromhex(line["pubkey"]),
                                sig.EdVerifier())
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_entry_points_default_to_the_card():
    """Without a card, every entry point of the slice refuses the default
    device instead of running on the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device resolves")
    db = dbmod.open_state()
    common = dict(db=db, cache=tcache.AtxCache(),
                  verifier=sig.EdVerifier(), golden_atx=GOLDEN,
                  post_params=PARAMS, labels_per_unit=LPU, scrypt_n=N)
    for make in (
            lambda: act.Handler(pubsub=ps.PubSub(), **common),
            lambda: act2.HandlerV2(**common),
            lambda: mal.Handler(db=db, cache=tcache.AtxCache(),
                                verifier=sig.EdVerifier(),
                                pubsub=ps.PubSub()),
            lambda: cert.CertifierService(signer(1), PARAMS, scrypt_n=N)):
        with pytest.raises(RuntimeError, match="device='cuda'"):
            make()
