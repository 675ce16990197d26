"""The port's TCP transport (``spacemesh_tpu_torch/p2p/{noise,gossipmesh,
transport}.py``) against the JAX package's, and port and JAX hosts on one
network over TCP and QUIC.

The cases of ``tests/test_transport.py`` and ``tests/test_gossipmesh.py``
run on the port through ``torch_twin`` (``tests/test_torch_quic.py`` holds
``test_quic.py``'s, whose autouse fixture swaps the host class).
"""

from torch_twin import export

export("test_transport", globals())
export("test_gossipmesh", globals())


# --- a port Host and a JAX Host on one network --------------------------

import asyncio  # noqa: E402
import importlib  # noqa: E402

import pytest  # noqa: E402

PKGS = ("spacemesh_tpu", "spacemesh_tpu_torch")
GEN = b"i" * 20


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _atx(pkg, n: int):
    """One wire ATX of ``pkg``'s types, from seeded values."""
    t = _mod(pkg, "core.types")
    return t.ActivationTx(
        publish_epoch=2, prev_atx=bytes([n]) * 32, pos_atx=bytes(32),
        commitment_atx=None, initial_post=None,
        nipost=t.NIPost(
            membership=t.MerkleProof(leaf_index=n, nodes=[bytes(32)]),
            post=t.Post(nonce=n, indices=[1, 2, 3], pow_nonce=7),
            post_metadata=t.PostMetadataWire(challenge=bytes([n]) * 32,
                                             labels_per_unit=64)),
        num_units=2, vrf_nonce=9, vrf_public_key=bytes([n]) * 32,
        coinbase=bytes([n]) * 24, node_id=bytes([n]) * 32,
        signature=bytes(64))


class _Node:
    """One package's host with gossip, a req/resp server and fetch; its
    ATX store holds one ATX of its own and records what it receives."""

    def __init__(self, pkg, transport, seed: bytes, genesis=GEN, n=1):
        self.pkg = pkg
        signer = _mod(pkg, "core.signing").EdSigner(seed=seed * 32,
                                                    prefix=genesis)
        self.node_id = signer.node_id
        Host = (_mod(pkg, "p2p.quic").QuicHost if transport == "quic"
                else _mod(pkg, "p2p.transport").Host)
        self.host = Host(signer=signer, genesis_id=genesis,
                         listen="127.0.0.1:0")
        self.ps = _mod(pkg, "p2p.pubsub").PubSub(node_name=signer.node_id)
        self.srv = _mod(pkg, "p2p.server").Server(signer.node_id)
        self.host.join_pubsub(self.ps)
        self.host.join(self.srv)
        fetch_mod = _mod(pkg, "p2p.fetch")
        self.fetch = fetch_mod.Fetch(self.srv)
        self.atx = _atx(pkg, n)
        self.store = {self.atx.id: self.atx.to_bytes()}
        self.gossiped, self.fetched = [], []
        ActivationTx = _mod(pkg, "core.types").ActivationTx
        topic = _mod(pkg, "p2p.pubsub").TOPIC_ATX

        async def on_atx(peer, data):
            if peer != self.node_id:  # a publish is delivered locally too
                self.gossiped.append((peer,
                                      ActivationTx.from_bytes(data).id))
            return True

        async def on_fetched(atx_id, blob):
            got = ActivationTx.from_bytes(blob)
            self.fetched.append(got.id)
            return got.id == atx_id

        self.ps.register(topic, on_atx)
        self.fetch.set_reader(fetch_mod.HINT_ATX, self.store.get)
        self.fetch.set_validator(fetch_mod.HINT_ATX, on_fetched)
        self.topic = topic
        self.hint = fetch_mod.HINT_ATX


async def _wait(pred, timeout=10.0):
    async def loop():
        while not pred():
            await asyncio.sleep(0.02)
    await asyncio.wait_for(loop(), timeout)


@pytest.mark.parametrize("transport", ["tcp", "quic"])
@pytest.mark.parametrize("dialer", PKGS)
def test_port_and_jax_hosts_interoperate(transport, dialer):
    """A port Host and a JAX Host on 127.0.0.1 (OpenSSL Noise suite, as
    both packages use with ``cryptography`` present): the handshake from
    either side proves both identities, an ATX gossips each way and
    decodes to the same id, and a fetch of the other's ATX is answered
    each way."""
    for pkg in PKGS:
        if not _mod(pkg, "p2p.noise")._HAVE_CRYPTOGRAPHY:
            pytest.skip("interop runs on the OpenSSL Noise suite; the "
                        "pure-Python shim is wire-incompatible by design")

    async def go():
        jax = _Node("spacemesh_tpu", transport, b"j", n=1)
        port = _Node("spacemesh_tpu_torch", transport, b"t", n=2)
        nodes = {"spacemesh_tpu": jax, "spacemesh_tpu_torch": port}
        await jax.host.start()
        await port.host.start()
        try:
            other = port if dialer == "spacemesh_tpu" else jax
            await nodes[dialer].host._dial(other.host.address)
            await _wait(lambda: port.node_id in jax.srv.peers()
                        and jax.node_id in port.srv.peers())
            for src, dst in ((jax, port), (port, jax)):
                await src.ps.publish(src.topic, src.atx.to_bytes())
                await _wait(lambda: dst.gossiped)
                assert dst.gossiped == [(src.node_id, src.atx.id)]
                got = await dst.fetch.get_hashes(dst.hint, [src.atx.id])
                assert got == {src.atx.id: True}
                assert dst.fetched == [src.atx.id]
            assert jax.atx.to_bytes() != port.atx.to_bytes()
        finally:
            await jax.host.stop()
            await port.host.stop()

    asyncio.run(asyncio.wait_for(go(), 60))


@pytest.mark.parametrize("transport", ["tcp", "quic"])
@pytest.mark.parametrize("dialer", PKGS)
def test_hosts_of_both_packages_refuse_another_genesis(transport, dialer):
    """A peer on another genesis id is refused whichever package dials
    and whichever listens."""

    async def go():
        jax = _Node("spacemesh_tpu", transport, b"j")
        port = _Node("spacemesh_tpu_torch", transport, b"t",
                     genesis=b"x" * 20)
        nodes = {"spacemesh_tpu": jax, "spacemesh_tpu_torch": port}
        await jax.host.start()
        await port.host.start()
        try:
            other = port if dialer == "spacemesh_tpu" else jax
            await nodes[dialer].host._dial(other.host.address)
            await asyncio.sleep(0.5)
            assert not jax.host.nodes and not port.host.nodes
            assert not jax.srv.peers() and not port.srv.peers()
        finally:
            await jax.host.stop()
            await port.host.stop()

    asyncio.run(asyncio.wait_for(go(), 60))
