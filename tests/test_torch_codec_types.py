"""The port's canonical codec and wire types (``spacemesh_tpu_torch/core/
codec.py``, ``core/types.py``, ``consensus/poet.py:PoetBlob``,
``consensus/hare.py``) against the JAX package's.

Every registered type is built from the same numpy-seeded values in both
packages: the encodings must be byte-identical, each package must decode
the other's bytes to a value that re-encodes to them, and the ids hashed
from the bytes (``ActivationTx.id``, ``ActivationTxV2.identity_atx_id``,
...) must be equal. Malformed bytes (non-minimal varints, trailing bytes,
bad tags, truncations, random mutations of valid encodings) must be
rejected, or accepted, alike. Exact equality throughout.
"""

import dataclasses

import numpy as np
import pytest

from spacemesh_tpu.consensus import hare as jhare
from spacemesh_tpu.consensus import poet as jpoet
from spacemesh_tpu.core import codec as jcodec
from spacemesh_tpu.core import types as jtypes
from spacemesh_tpu_torch.consensus import hare as thare
from spacemesh_tpu_torch.consensus import poet as tpoet
from spacemesh_tpu_torch.core import codec as tcodec
from spacemesh_tpu_torch.core import types as ttypes

SEEDS = range(6)


def _registered(*mods) -> dict:
    return {name: obj for mod in mods for name, obj in vars(mod).items()
            if isinstance(obj, type) and hasattr(obj, "CODEC")
            and obj.__module__ == mod.__name__}


JAX = _registered(jtypes, jpoet, jhare)
PORT = _registered(ttypes, tpoet, thare)

# field generators: ("u", bits) | ("c",) compact | ("b", n) fixed bytes |
# ("vb",) var bytes | ("s",) str | ("l", gen, max) | ("o", gen) |
# ("t", name) struct
U8, U16, U32, U64, C = ("u", 8), ("u", 16), ("u", 32), ("u", 64), ("c",)
H32, SIG, VRF, ADDR, B4 = ("b", 32), ("b", 64), ("b", 80), ("b", 24), ("b", 4)
VB, STR = ("vb",), ("s",)


def L(gen, most=5):
    return ("l", gen, most)


def O(gen):
    return ("o", gen)


def T(name):
    return ("t", name)


SCHEMA = {
    "Post": {"nonce": U32, "indices": L(C, 40), "pow_nonce": U64},
    "PostMetadataWire": {"challenge": H32, "labels_per_unit": U64},
    "MerkleProof": {"leaf_index": U64, "nodes": L(H32, 8)},
    "NIPost": {"membership": T("MerkleProof"), "post": T("Post"),
               "post_metadata": T("PostMetadataWire")},
    "PoetProof": {"poet_id": H32, "round_id": STR, "root": H32,
                  "ticks": U64},
    "ActivationTx": {
        "publish_epoch": U32, "prev_atx": H32, "pos_atx": H32,
        "commitment_atx": O(H32), "initial_post": O(T("Post")),
        "nipost": T("NIPost"), "num_units": U32, "vrf_nonce": U64,
        "vrf_public_key": H32, "coinbase": ADDR, "node_id": H32,
        "signature": SIG},
    "MarriageCert": {"partner_id": H32, "signature": SIG},
    "SubPostV2": {"node_id": H32, "prev_atx": H32, "num_units": U32,
                  "vrf_nonce": U64, "nipost": T("NIPost")},
    "ActivationTxV2": {
        "publish_epoch": U32, "pos_atx": H32, "coinbase": ADDR,
        "marriages": L(T("MarriageCert"), 3),
        "subposts": L(T("SubPostV2"), 3), "node_id": H32,
        "signature": SIG},
    "EpochData": {"beacon": B4, "active_set_root": H32,
                  "eligibility_count": U16},
    "VotingEligibility": {"j": U32, "sig": VRF},
    "Opinion": {"base": H32, "support": L(H32), "against": L(H32),
                "abstain": L(U32)},
    "Ballot": {"layer": U32, "atx_id": H32, "epoch_data": O(T("EpochData")),
               "ref_ballot": H32, "eligibilities": L(T("VotingEligibility")),
               "opinion": T("Opinion"), "node_id": H32, "signature": SIG},
    "Proposal": {"ballot": T("Ballot"), "tx_ids": L(H32), "mesh_hash": H32,
                 "signature": SIG},
    "Reward": {"atx_id": H32, "coinbase": ADDR, "weight": U64},
    "Block": {"layer": U32, "tick_height": U64, "rewards": L(T("Reward")),
              "tx_ids": L(H32)},
    "CertifyMessage": {"layer": U32, "block_id": H32,
                       "eligibility_count": U16, "proof": VRF,
                       "atx_id": H32, "node_id": H32, "signature": SIG},
    "Certificate": {"block_id": H32, "signatures": L(T("CertifyMessage"), 3)},
    "Transaction": {"raw": VB},
    "TransactionResult": {"status": U8, "message": STR, "gas_consumed": U64,
                          "fee": U64, "layer": U32, "block": H32},
    "MalfeasanceProof": {"domain": U8, "msg1": VB, "sig1": SIG, "msg2": VB,
                         "sig2": SIG, "node_id": H32},
    "PoetBlob": {"proof": T("PoetProof"), "member_count": U64},
    "HareMessage": {"layer": U32, "iteration": U8, "round": U8,
                    "values": L(H32), "eligibility_proof": VRF,
                    "eligibility_count": U16, "atx_id": H32, "node_id": H32,
                    "cert_msgs": L(VB, 3), "signature": SIG},
    "CompactHareMessage": {"layer": U32, "iteration": U8, "round": U8,
                           "compact_ids": L(B4), "root": H32,
                           "eligibility_proof": VRF,
                           "eligibility_count": U16, "atx_id": H32,
                           "node_id": H32, "cert_msgs": L(VB, 3),
                           "signature": SIG},
}


def draw(rng, gen):
    """A plain value (dicts for structs) drawn from ``gen``; edge values
    (0, the width's top) one time in four."""
    kind = gen[0]
    if kind == "u":
        top = (1 << gen[1]) - 1
        r = int(rng.integers(4))
        return (0, top)[r] if r < 2 else int(rng.integers(0, top,
                                                          dtype=np.uint64))
    if kind == "c":
        bits = int(rng.integers(0, 64))
        return int(rng.integers(0, 1 << bits, dtype=np.uint64)) if bits \
            else int(rng.integers(2))
    if kind == "b":
        return rng.bytes(gen[1])
    if kind == "vb":
        return rng.bytes(int(rng.integers(0, 200)))
    if kind == "s":
        return "".join(chr(int(c)) for c in
                       rng.integers(0x20, 0x3000, size=int(rng.integers(8))))
    if kind == "l":
        return [draw(rng, gen[1]) for _ in range(int(rng.integers(0,
                                                                  gen[2])))]
    if kind == "o":
        return None if rng.integers(2) else draw(rng, gen[1])
    return {f: draw(rng, g) for f, g in SCHEMA[gen[1]].items()}


def build(classes: dict, name: str, plain: dict):
    """``plain`` (from :func:`draw`) as an instance of ``classes[name]``."""
    def make(gen, v):
        if v is None:
            return None
        if gen[0] == "t":
            return build(classes, gen[1], v)
        if gen[0] == "l":
            return [make(gen[1], x) for x in v]
        if gen[0] == "o":
            return make(gen[1], v)
        return v
    return classes[name](**{f: make(g, plain[f])
                            for f, g in SCHEMA[name].items()})


def test_every_registered_type_is_ported_with_its_fields():
    assert set(JAX) == set(PORT) == set(SCHEMA)
    for name, cls in JAX.items():
        assert [f for f, _ in cls.FIELDS] == [f for f, _ in PORT[name].FIELDS]
        assert list(SCHEMA[name]) == [f for f, _ in cls.FIELDS]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(SCHEMA))
def test_encodings_and_ids_are_byte_identical(name, seed):
    rng = np.random.default_rng([seed, sorted(SCHEMA).index(name)])
    plain = draw(rng, T(name))
    j, t = build(JAX, name, plain), build(PORT, name, plain)
    jb, tb = j.to_bytes(), t.to_bytes()
    assert tb == jb
    assert tcodec.encode(t) == jb  # the struct codec built on the fly
    back_t = PORT[name].from_bytes(jb)
    back_j = JAX[name].from_bytes(tb)
    assert back_t == t and back_t.to_bytes() == jb
    assert back_j.to_bytes() == jb
    for attr in ("id", "signed_bytes", "target_epoch"):
        if hasattr(j, attr):
            a, b = getattr(j, attr), getattr(t, attr)
            assert (b() if callable(b) else b) == (a() if callable(a) else a)
    if name == "ActivationTxV2":
        for sp in plain["subposts"]:
            assert t.identity_atx_id(sp["node_id"]) == \
                j.identity_atx_id(sp["node_id"])


def _decode(codec_mod, cls, data):
    try:
        return cls.from_bytes(data).to_bytes()
    except codec_mod.DecodeError as exc:
        return ("DecodeError", str(exc))
    except (ValueError, UnicodeDecodeError) as exc:
        return (type(exc).__name__, str(exc))


@pytest.mark.parametrize("name", sorted(SCHEMA))
def test_malformed_bytes_rejected_alike(name):
    """Trailing bytes, truncations and seeded byte mutations of valid
    encodings: both packages decode to the same bytes or raise the same
    error."""
    rng = np.random.default_rng([99, sorted(SCHEMA).index(name)])
    rejected = 0
    for _ in range(4):
        good = build(JAX, name, draw(rng, T(name))).to_bytes()
        cases = [good + b"\x00", good + rng.bytes(3), good[:-1],
                 good[:len(good) // 2]]
        for _ in range(12):
            bad = bytearray(good)
            for pos in rng.integers(0, len(bad), size=int(rng.integers(1, 4))):
                bad[pos] = int(rng.integers(256))
            cases.append(bytes(bad))
        for data in cases:
            want = _decode(jcodec, JAX[name], data)
            assert _decode(tcodec, PORT[name], data) == want
            rejected += isinstance(want, tuple)
    assert rejected >= 16  # every trailing/truncated case at least


@pytest.mark.parametrize("data", [
    b"\x80\x00",                      # non-minimal: 0 in two bytes
    b"\xff\x00",                      # non-minimal: 127 in two bytes
    b"\x80\x80\x00",
    b"\xff" * 9 + b"\x02",            # 2^64 + ...: overflows u64
    b"\xff" * 10 + b"\x01",           # shift past 63
    b"\x80",                          # EOF mid-varint
    b"",
])
def test_compact_rejections_match(data):
    def run(codec_mod):
        try:
            return codec_mod.decode(data, codec_mod.compact)
        except codec_mod.DecodeError as exc:
            return ("DecodeError", str(exc))
    got = run(tcodec)
    assert got == run(jcodec)
    assert isinstance(got, tuple)


@pytest.mark.parametrize("value", [0, 1, 127, 128, 16383, 16384, 2**32 - 1,
                                   2**32, 2**63, 2**64 - 1])
def test_compact_minimal_and_round_trips(value):
    enc = tcodec.encode(value, tcodec.compact)
    assert enc == jcodec.encode(value, jcodec.compact)
    assert tcodec.decode(enc, tcodec.compact) == value
    with pytest.raises(tcodec.DecodeError, match="trailing"):
        tcodec.decode(enc + b"\x00", tcodec.compact)


@pytest.mark.parametrize("codec_name,data", [
    ("boolean", b"\x02"), ("boolean", b""),
    ("string", b"\x02\xff\xfe"),
    ("var_bytes", b"\x05ab"),
    ("u32", b"\x01\x02\x03"),
])
def test_primitive_rejections_match(codec_name, data):
    def run(codec_mod):
        try:
            return codec_mod.decode(data, getattr(codec_mod, codec_name))
        except (codec_mod.DecodeError, UnicodeDecodeError) as exc:
            return (type(exc).__name__, str(exc))
    got = run(tcodec)
    assert got == run(jcodec) and isinstance(got, tuple)


def test_option_vec_and_width_rules_match():
    for mod in (tcodec, jcodec):
        opt = mod.option(mod.u8)
        assert mod.encode(None, opt) == b"\x00"
        assert mod.encode(7, opt) == b"\x01\x07"
        with pytest.raises(mod.DecodeError, match="option tag"):
            mod.decode(b"\x02\x07", opt)
        v = mod.vec(mod.u16, max_len=2)
        with pytest.raises(ValueError, match="vec too long"):
            mod.encode([1, 2, 3], v)
        with pytest.raises(mod.DecodeError, match="vec too long"):
            mod.decode(b"\x03" + b"\x00" * 6, v)
        with pytest.raises(ValueError, match="out of range"):
            mod.encode(256, mod.u8)
        with pytest.raises(ValueError, match="expected 32 bytes"):
            mod.encode(b"x", mod.fixed(32))


def test_lying_length_prefix_rejected_not_crashed():
    data = b"\xff" * 9 + b"\x01" + b"abc"  # a length of 2^63 + ...
    for mod in (tcodec, jcodec):
        with pytest.raises(mod.DecodeError):
            mod.decode(data, mod.var_bytes)


@pytest.mark.parametrize("seed", SEEDS)
def test_addresses_match(seed):
    rng = np.random.default_rng(seed)
    template, arg = rng.bytes(32), rng.bytes(int(rng.integers(0, 64)))
    j = jtypes.Address.from_public_key(template, arg)
    t = ttypes.Address.from_public_key(template, arg)
    assert t.raw == j.raw
    for hrp in (None, "stest"):
        s = t.encode(hrp)
        assert s == j.encode(hrp)
        assert ttypes.Address.decode(s) == t
    broken = s[:-1] + ("q" if s[-1] != "q" else "p")
    for mod in (ttypes, jtypes):
        with pytest.raises(ValueError, match="checksum"):
            mod.Address.decode(broken)
    assert tcodec.encode(t, ttypes.addr_codec) == jcodec.encode(
        j, jtypes.addr_codec)


def test_layer_epoch_math_matches():
    for layer in (0, 1, 3, 4, 7, 4095, 4096):
        for lpe in (1, 4, 4032):
            t, j = ttypes.LayerID(layer), jtypes.LayerID(layer)
            assert t.epoch(lpe) == j.epoch(lpe)
            assert t.first_in_epoch(lpe) == j.first_in_epoch(lpe)
            assert ttypes.epoch_first_layer(layer, lpe) == \
                jtypes.epoch_first_layer(layer, lpe)


def test_atx_replace_keeps_ids_in_step():
    """dataclasses.replace on a port ATX (how handlers and the Builder sign)
    gives the JAX package's signed bytes and id."""
    rng = np.random.default_rng(7)
    plain = draw(rng, T("ActivationTx"))
    j, t = build(JAX, "ActivationTx", plain), build(PORT, "ActivationTx",
                                                   plain)
    sig = rng.bytes(64)
    j2, t2 = (dataclasses.replace(x, signature=sig) for x in (j, t))
    assert t2.signed_bytes() == j2.signed_bytes() == t.signed_bytes()
    assert t2.id == j2.id != t.id
