"""The port twin of ``tests/test_fuzz_surfaces.py``.

Its four tests run on the port through ``torch_twin``: raw garbage at the
port's TCP host and QUIC endpoint (the hosts are ``test_transport.py``'s
twin's, through the loader's ``from tests.<name> import``), and every
gossip topic handler and req/resp protocol handler of a port
``App(device="cpu")`` fed noise, truncations and bit flips of valid wire
messages. Malformed bytes from the network may be rejected; they must never
take the node or its event loop down.

The valid messages are the JAX test's ``_wire_samples`` from
``tests/test_tools_fuzz.py`` (that file's twin cannot load: the port has no
``tools.bootstrapper``), each decoded by the port's type of the same name
and encoded again, byte for byte.
"""

import importlib

from torch_twin import export

_twin = export("test_fuzz_surfaces", globals())


def _port_wire_samples() -> list:
    """The JAX package's wire samples as the port encodes them: each one's
    bytes decoded by the port's type of the same name and encoded again,
    held equal to the JAX encoding."""
    from tests.test_tools_fuzz import _wire_samples

    out = []
    for sample in _wire_samples():
        cls = type(sample)
        mod = importlib.import_module(
            cls.__module__.replace("spacemesh_tpu", "spacemesh_tpu_torch", 1))
        data = sample.to_bytes()
        port = getattr(mod, cls.__name__).from_bytes(data)
        assert port.to_bytes() == data, cls.__name__
        out.append(port.to_bytes())
    return out


# the twin's handler tests read their valid corpus through this name
_twin._valid_gossip_samples = _port_wire_samples


def test_port_wire_samples_cover_every_sample_type():
    from tests.test_tools_fuzz import _wire_samples

    samples = _port_wire_samples()
    assert len(samples) == len(_wire_samples()) >= 7
    assert all(samples)


def test_the_twin_drives_the_port():
    assert _twin.App.__module__ == "spacemesh_tpu_torch.node.app"
    assert _twin.PubSub.__module__ == "spacemesh_tpu_torch.p2p.pubsub"
    # the hosts come from test_transport.py's twin, so they are the port's
    host_cls = _twin._mk.__globals__["Host"]
    assert host_cls.__module__ == "spacemesh_tpu_torch.p2p.transport"
