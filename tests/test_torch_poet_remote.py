"""The port's external poet (``spacemesh_tpu_torch/consensus/poet_remote.py``
and ``python -m spacemesh_tpu_torch.tools.poet_server``) against the JAX
package's.

Twin of ``tests/test_poet_remote.py``: the daemons are real subprocesses
of the port's ``poet_server``; the port's ``RemotePoetClient`` and
``MultiPoet`` register, run rounds and fetch memberships from them, and
every membership verifies under both packages' ``verify_membership``.
Besides, each package's client talks to the other's daemon with equal
results, and the wire dicts of a round result are equal. No torch, no card.
"""

import asyncio
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from spacemesh_tpu.consensus import poet as jpoet
from spacemesh_tpu.consensus import poet_remote as jremote
from spacemesh_tpu_torch.consensus import poet as tpoet
from spacemesh_tpu_torch.consensus import poet_remote as tremote

REPO = Path(__file__).resolve().parent.parent


def _spawn_poet(module, ticks, seed):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", module, "--listen", "127.0.0.1:0",
         "--ticks", str(ticks), "--id-seed", seed],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env,
        text=True, cwd=str(REPO))
    ev = json.loads(proc.stdout.readline())
    assert ev["event"] == "Serving"
    return proc, (ev["host"], ev["port"]), ev["poet_id"]


@pytest.fixture(scope="module")
def poets():
    """Two port daemons (32 and 128 ticks) and one JAX daemon (64)."""
    procs, addrs, ids = [], [], []
    for module, ticks, seed in (
            ("spacemesh_tpu_torch.tools.poet_server", 32, "poet-slow"),
            ("spacemesh_tpu_torch.tools.poet_server", 128, "poet-strong"),
            ("spacemesh_tpu.tools.poet_server", 64, "poet-jax")):
        proc, addr, poet_id = _spawn_poet(module, ticks, seed)
        procs.append(proc)
        addrs.append(addr)
        ids.append(poet_id)
    yield addrs, ids
    for proc in procs:
        proc.terminate()
        proc.wait(timeout=10)


def _verified(result, challenge) -> bool:
    proof = result.membership(challenge)
    assert proof is not None
    n = len(result.members)
    return (tpoet.verify_membership(challenge, proof, result.proof.root,
                                    leaf_count=n)
            and jpoet.verify_membership(challenge, proof, result.proof.root,
                                        leaf_count=n))


def test_register_execute_and_membership(poets):
    addrs, ids = poets
    client = tremote.RemotePoetClient(addrs[0])
    challenges = [bytes([i]) * 32 for i in range(5)]

    async def go():
        for ch in challenges:
            await client.register("7", ch)
        result = await client.execute_round("7")
        assert all(_verified(result, ch) for ch in challenges)
        again = client.result("7")
        assert again is not None and again.proof.root == result.proof.root
        assert client.result("no-such-round") is None
        return result

    result = asyncio.run(asyncio.wait_for(go(), 30))
    assert client.poet_id.hex() == ids[0] and client.ticks == 32
    assert result.proof.ticks == 32


def test_multi_poet_picks_best_by_ticks(poets):
    addrs, _ = poets
    mp = tremote.MultiPoet([tremote.RemotePoetClient(a) for a in addrs])
    challenge = b"ch-bbbbbbbbbbbbbbbbbbbbbbbbbbbbbb"[:32]

    async def go():
        await mp.register("9", challenge)
        result = await mp.execute_round("9")
        assert result.proof.ticks == 128
        assert _verified(result, challenge)
        assert mp.result("9").proof.root == result.proof.root

    asyncio.run(asyncio.wait_for(go(), 30))


def test_multi_poet_survives_dead_poet(poets):
    addrs, _ = poets

    class Dead:
        poet_id = b"\0" * 32

        async def register(self, r, c, node_id=None, signature=None,
                           cert=None):
            raise ConnectionRefusedError

        async def execute_round(self, r):
            raise ConnectionRefusedError

        def result(self, r):
            return None

    mp = tremote.MultiPoet([Dead()] + [tremote.RemotePoetClient(a)
                                       for a in addrs[:2]])
    challenge = b"ch-cccccccccccccccccccccccccccccc"[:32]

    async def go():
        await mp.register("11", challenge)
        result = await mp.execute_round("11")
        assert result.proof.ticks == 128
        with pytest.raises(RuntimeError, match="all poets failed"):
            await tremote.MultiPoet([Dead()]).register("11", challenge)

    asyncio.run(asyncio.wait_for(go(), 30))
    with pytest.raises(ValueError):
        tremote.MultiPoet([])


def test_clients_and_daemons_of_both_packages_agree(poets):
    """The JAX client against a port daemon and the port client against
    the JAX daemon: equal rounds, and the same result dicts on the wire."""
    addrs, ids = poets
    challenges = [bytes([0x40 + i]) * 32 for i in range(3)]

    async def go():
        out = {}
        for name, client in (
                ("jax->port", jremote.RemotePoetClient(addrs[1])),
                ("port->jax", tremote.RemotePoetClient(addrs[2]))):
            for ch in challenges:
                await client.register("21", ch)
            out[name] = await client.execute_round("21")
        return out

    out = asyncio.run(asyncio.wait_for(go(), 30))
    for name, result in out.items():
        assert all(_verified(result, ch) for ch in challenges), name
        assert tremote._result_to_dict(result) == \
            jremote._result_to_dict(result)
        back = tremote._result_from_dict(jremote._result_to_dict(result))
        assert back.proof.to_bytes() == result.proof.to_bytes()
    assert out["jax->port"].proof.ticks == 128
    assert out["port->jax"].proof.ticks == 64
    assert out["port->jax"].proof.poet_id.hex() == ids[2]
    # the same poet seed and challenges give the same round in either daemon
    svc = tpoet.PoetService(poet_id=bytes.fromhex(ids[1]), ticks=128)

    async def local():
        for ch in challenges:
            await svc.register("21", ch)
        return await svc.execute_round("21")

    mine = asyncio.run(local())
    assert mine.proof.root == out["jax->port"].proof.root
