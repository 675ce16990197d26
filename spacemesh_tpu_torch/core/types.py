"""Domain types — the vocabulary every layer above speaks (port of
``spacemesh_tpu/core/types.py``, whole: the same fields and codecs, so
encodings and the ids hashed from them are byte-identical).

Mirrors the reference's common/types (reference common/types/activation.go,
ballot.go, block.go, transaction.go, poet.go, address.go, layer.go,
epoch.go, nodeid.go): 32-byte content ids computed as blake3 of the
canonical encoding, u32 layer/epoch ordinals, 24-byte bech32 addresses.
All wire structs declare codec FIELDS (core/codec.py) and get canonical
bytes + ids from them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from . import codec
from .codec import compact, fixed, option, string, u8, u16, u32, u64, var_bytes, vec
from .hashing import sum160, sum256

HASH32 = fixed(32)
HASH20 = fixed(20)
SIG = fixed(64)
VRF_SIG = fixed(80)

EMPTY32 = bytes(32)

ADDRESS_SIZE = 24
ADDRESS = fixed(ADDRESS_SIZE)


# --- layers and epochs -----------------------------------------------------


class LayerID(int):
    """Layer ordinal (u32). Plain int subclass: arithmetic stays natural."""

    def epoch(self, layers_per_epoch: int) -> int:
        return self // layers_per_epoch

    def first_in_epoch(self, layers_per_epoch: int) -> bool:
        return self % layers_per_epoch == 0


def epoch_first_layer(epoch: int, layers_per_epoch: int) -> LayerID:
    return LayerID(epoch * layers_per_epoch)


# --- bech32 addresses ------------------------------------------------------

_B32 = "qpzry9x8gf2tvdw0s3jn54khce6mua7l"


def _bech32_polymod(values):
    gen = (0x3B6A57B2, 0x26508E6D, 0x1EA119FA, 0x3D4233DD, 0x2A1462B3)
    chk = 1
    for v in values:
        top = chk >> 25
        chk = ((chk & 0x1FFFFFF) << 5) ^ v
        for i in range(5):
            chk ^= gen[i] if ((top >> i) & 1) else 0
    return chk


def _hrp_expand(hrp):
    return [ord(c) >> 5 for c in hrp] + [0] + [ord(c) & 31 for c in hrp]


def _to5(data: bytes):
    acc = bits = 0
    out = []
    for b in data:
        acc = (acc << 8) | b
        bits += 8
        while bits >= 5:
            bits -= 5
            out.append((acc >> bits) & 31)
    if bits:
        out.append((acc << (5 - bits)) & 31)
    return out


def _from5(data):
    acc = bits = 0
    out = bytearray()
    for v in data:
        acc = (acc << 5) | v
        bits += 5
        while bits >= 8:
            bits -= 8
            out.append((acc >> bits) & 0xFF)
    return bytes(out)


class Address:
    """24-byte account address, rendered bech32 with a network HRP
    (reference common/types/address.go)."""

    __slots__ = ("raw",)
    HRP = "sm"

    def __init__(self, raw: bytes):
        if len(raw) != ADDRESS_SIZE:
            raise ValueError(f"address must be {ADDRESS_SIZE} bytes")
        self.raw = bytes(raw)

    @classmethod
    def from_public_key(cls, template: bytes, *args: bytes) -> "Address":
        # principal address = 4 zero bytes || last 20 bytes of
        # blake3(template || spawn args) — stable across networks
        return cls(bytes(4) + sum160(template, *args))

    def encode(self, hrp: str | None = None) -> str:
        hrp = hrp or self.HRP
        data = _to5(self.raw)
        values = _hrp_expand(hrp) + data
        poly = _bech32_polymod(values + [0] * 6) ^ 1
        checksum = [(poly >> 5 * (5 - i)) & 31 for i in range(6)]
        return hrp + "1" + "".join(_B32[d] for d in data + checksum)

    @classmethod
    def decode(cls, s: str) -> "Address":
        pos = s.rfind("1")
        if pos < 1:
            raise ValueError("invalid bech32 address")
        hrp, rest = s[:pos], s[pos + 1:]
        try:
            data = [_B32.index(c) for c in rest.lower()]
        except ValueError as e:
            raise ValueError("invalid bech32 character") from e
        if _bech32_polymod(_hrp_expand(hrp) + data) != 1:
            raise ValueError("bad bech32 checksum")
        raw = _from5(data[:-6])
        if len(raw) != ADDRESS_SIZE:
            raise ValueError("bad address payload length")
        return cls(raw)

    def __eq__(self, other):
        return isinstance(other, Address) and self.raw == other.raw

    def __hash__(self):
        return hash(self.raw)

    def __repr__(self):
        return f"Address({self.encode()})"


addr_codec = codec.Codec(
    lambda w, v: w.write(v.raw),
    lambda r: Address(codec._read(r, ADDRESS_SIZE)))


# --- POST / NIPoST wire types ---------------------------------------------


@codec.register
class Post:
    """The space proof (reference common/types/poet.go Post)."""

    nonce: int
    indices: list[int]
    pow_nonce: int

    FIELDS = [("nonce", u32), ("indices", vec(compact, 1 << 12)),
              ("pow_nonce", u64)]


@codec.register
class PostMetadataWire:
    challenge: bytes
    labels_per_unit: int

    FIELDS = [("challenge", HASH32), ("labels_per_unit", u64)]


@codec.register
class MerkleProof:
    leaf_index: int
    nodes: list[bytes]

    FIELDS = [("leaf_index", u64), ("nodes", vec(HASH32, 64))]


@codec.register
class NIPost:
    """Non-interactive PoST: membership in a poet round + space proof
    (reference common/types/activation.go NIPost)."""

    membership: MerkleProof
    post: Post
    post_metadata: PostMetadataWire

    FIELDS = [("membership", codec.struct(MerkleProof)),
              ("post", codec.struct(Post)),
              ("post_metadata", codec.struct(PostMetadataWire))]


@codec.register
class PoetProof:
    """Poet round proof: merkle root over members + tick count
    (reference common/types/poet.go PoetProofMessage, simplified: the poet
    statement is the root; members prove inclusion via MerkleProof)."""

    poet_id: bytes
    round_id: str
    root: bytes
    ticks: int

    FIELDS = [("poet_id", HASH32), ("round_id", string),
              ("root", HASH32), ("ticks", u64)]

    @property
    def id(self) -> bytes:
        return sum256(self.to_bytes())


# --- activation (ATX) ------------------------------------------------------


@codec.register
class ActivationTx:
    """ATX: one identity's per-epoch commitment of space
    (reference common/types/activation.go, wire activation/wire/wire_v1.go).
    """

    publish_epoch: int
    prev_atx: bytes              # EMPTY32 for initial
    pos_atx: bytes               # positioning ATX
    commitment_atx: Optional[bytes]   # set on initial ATX only
    initial_post: Optional[Post]      # set on initial ATX only
    nipost: NIPost
    num_units: int
    vrf_nonce: int
    vrf_public_key: bytes        # ECVRF key for eligibility proofs
    coinbase: bytes              # Address.raw
    node_id: bytes               # smesher public key
    signature: bytes

    FIELDS = [
        ("publish_epoch", u32),
        ("prev_atx", HASH32),
        ("pos_atx", HASH32),
        ("commitment_atx", option(HASH32)),
        ("initial_post", option(codec.struct(Post))),
        ("nipost", codec.struct(NIPost)),
        ("num_units", u32),
        ("vrf_nonce", u64),
        ("vrf_public_key", HASH32),
        ("coinbase", ADDRESS),
        ("node_id", HASH32),
        ("signature", SIG),
    ]

    def signed_bytes(self) -> bytes:
        clone = dataclasses.replace(self, signature=bytes(64))
        return clone.to_bytes()

    @property
    def id(self) -> bytes:
        return sum256(self.to_bytes())

    def target_epoch(self) -> int:
        return self.publish_epoch + 1


@codec.register
class MarriageCert:
    """Partner's consent to join the signer's equivocation set
    (reference activation/wire/wire_v2.go:198 MarriageCertificate):
    ``signature`` is the partner's ed25519 over
    Domain.ATX || "marry" || primary node id."""

    partner_id: bytes
    signature: bytes

    FIELDS = [("partner_id", HASH32), ("signature", SIG)]

    @staticmethod
    def message(primary_id: bytes) -> bytes:
        return b"marry" + primary_id


@codec.register
class SubPostV2:
    """One married identity's contribution inside a merged ATX
    (reference activation/wire/wire_v2.go:227 SubPostV2)."""

    node_id: bytes
    prev_atx: bytes              # EMPTY32 for initial
    num_units: int
    vrf_nonce: int
    nipost: NIPost

    FIELDS = [("node_id", HASH32), ("prev_atx", HASH32),
              ("num_units", u32), ("vrf_nonce", u64),
              ("nipost", codec.struct(NIPost))]


@codec.register
class ActivationTxV2:
    """Merged / multi-identity ATX (reference activation/wire/wire_v2.go:17
    ActivationTxV2): one envelope signed by the primary identity carries a
    SubPost per married identity plus the marriage certificates binding
    them into one equivocation set."""

    publish_epoch: int
    pos_atx: bytes
    coinbase: bytes
    marriages: list[MarriageCert]
    subposts: list[SubPostV2]
    node_id: bytes               # primary (envelope signer)
    signature: bytes

    FIELDS = [
        ("publish_epoch", u32),
        ("pos_atx", HASH32),
        ("coinbase", ADDRESS),
        ("marriages", vec(codec.struct(MarriageCert), 256)),
        ("subposts", vec(codec.struct(SubPostV2), 256)),
        ("node_id", HASH32),
        ("signature", SIG),
    ]

    def signed_bytes(self) -> bytes:
        clone = dataclasses.replace(self, signature=bytes(64))
        return clone.to_bytes()

    @property
    def id(self) -> bytes:
        return sum256(self.to_bytes())

    def target_epoch(self) -> int:
        return self.publish_epoch + 1

    def identity_atx_id(self, node_id: bytes) -> bytes:
        """Per-identity synthetic ATX id: merged ATXs still give each
        identity its own id for eligibility/cache keying."""
        return sum256(self.id, node_id)


# --- ballots / proposals / blocks -----------------------------------------


@codec.register
class EpochData:
    """First-ballot-of-epoch payload: beacon + active set root
    (reference common/types/ballot.go EpochData)."""

    beacon: bytes
    active_set_root: bytes
    eligibility_count: int

    FIELDS = [("beacon", fixed(4)), ("active_set_root", HASH32),
              ("eligibility_count", u16)]


@codec.register
class VotingEligibility:
    """VRF eligibility proof for one proposal slot
    (reference common/types/ballot.go VotingEligibility)."""

    j: int
    sig: bytes

    FIELDS = [("j", u32), ("sig", VRF_SIG)]


@codec.register
class Opinion:
    """Votes relative to a base ballot (reference common/types/ballot.go
    Votes): support/against lists of block ids, abstained layers."""

    base: bytes
    support: list[bytes]
    against: list[bytes]
    abstain: list[int]

    FIELDS = [("base", HASH32), ("support", vec(HASH32)),
              ("against", vec(HASH32)), ("abstain", vec(u32))]


@codec.register
class Ballot:
    layer: int
    atx_id: bytes
    epoch_data: Optional[EpochData]
    ref_ballot: bytes            # EMPTY32 when epoch_data present
    eligibilities: list[VotingEligibility]
    opinion: Opinion
    node_id: bytes
    signature: bytes

    FIELDS = [
        ("layer", u32),
        ("atx_id", HASH32),
        ("epoch_data", option(codec.struct(EpochData))),
        ("ref_ballot", HASH32),
        ("eligibilities", vec(codec.struct(VotingEligibility), 1 << 10)),
        ("opinion", codec.struct(Opinion)),
        ("node_id", HASH32),
        ("signature", SIG),
    ]

    def signed_bytes(self) -> bytes:
        return dataclasses.replace(self, signature=bytes(64)).to_bytes()

    @property
    def id(self) -> bytes:
        return sum256(self.to_bytes())


@codec.register
class Proposal:
    """Per-layer proposal: a ballot plus the proposed tx ids
    (reference common/types/block.go Proposal = Ballot + TxIDs + mesh hash,
    carrying its own signature over the whole thing so a relayer cannot
    re-attach different tx_ids to an honest ballot)."""

    ballot: Ballot
    tx_ids: list[bytes]
    mesh_hash: bytes
    signature: bytes

    FIELDS = [("ballot", codec.struct(Ballot)), ("tx_ids", vec(HASH32)),
              ("mesh_hash", HASH32), ("signature", SIG)]

    def signed_bytes(self) -> bytes:
        return dataclasses.replace(self, signature=bytes(64)).to_bytes()

    @property
    def id(self) -> bytes:
        return sum256(self.to_bytes())


@codec.register
class Reward:
    """Block reward entry (reference common/types/block.go AnyReward:
    {ATXID, Weight}; coinbase carried too since our apply path pays it
    directly rather than re-resolving the ATX)."""

    atx_id: bytes
    coinbase: bytes
    weight: int

    FIELDS = [("atx_id", HASH32), ("coinbase", ADDRESS), ("weight", u64)]


@codec.register
class Block:
    """The per-layer agreed block (reference common/types/block.go)."""

    layer: int
    tick_height: int
    rewards: list[Reward]
    tx_ids: list[bytes]

    FIELDS = [("layer", u32), ("tick_height", u64),
              ("rewards", vec(codec.struct(Reward), 1 << 12)),
              ("tx_ids", vec(HASH32, 1 << 16))]

    @property
    def id(self) -> bytes:
        return sum256(self.to_bytes())


@codec.register
class CertifyMessage:
    layer: int
    block_id: bytes
    eligibility_count: int
    proof: bytes                 # VRF proof of certifier eligibility
    atx_id: bytes                # the ATX backing the eligibility claim
    node_id: bytes
    signature: bytes

    FIELDS = [("layer", u32), ("block_id", HASH32),
              ("eligibility_count", u16), ("proof", VRF_SIG),
              ("atx_id", HASH32), ("node_id", HASH32), ("signature", SIG)]

    def signed_bytes(self) -> bytes:
        return dataclasses.replace(self, signature=bytes(64)).to_bytes()


@codec.register
class Certificate:
    """Post-hare block certificate (reference blocks/certifier.go):
    aggregated eligibility-weighted signatures over the hare output."""

    block_id: bytes
    signatures: list[CertifyMessage]

    FIELDS = [("block_id", HASH32),
              ("signatures", vec(codec.struct(CertifyMessage), 1 << 11))]


# --- transactions ----------------------------------------------------------


@codec.register
class Transaction:
    """Raw signed transaction; parsing/validation is the VM's job
    (reference common/types/transaction.go keeps raw + parsed cache)."""

    raw: bytes

    FIELDS = [("raw", var_bytes)]

    @property
    def id(self) -> bytes:
        return sum256(self.raw)


@codec.register
class TransactionResult:
    status: int            # 0 success, 1 failure (invalid nonce/balance...)
    message: str
    gas_consumed: int
    fee: int
    layer: int
    block: bytes

    FIELDS = [("status", u8), ("message", string), ("gas_consumed", u64),
              ("fee", u64), ("layer", u32), ("block", HASH32)]


# --- malfeasance -----------------------------------------------------------


@codec.register
class MalfeasanceProof:
    """Two conflicting signed messages from one identity
    (reference malfeasance/wire: MultipleATXs / MultipleBallots /
    HareEquivocation; domain says which)."""

    domain: int
    msg1: bytes
    sig1: bytes
    msg2: bytes
    sig2: bytes
    node_id: bytes

    FIELDS = [("domain", u8), ("msg1", var_bytes), ("sig1", SIG),
              ("msg2", var_bytes), ("sig2", SIG), ("node_id", HASH32)]

    @property
    def id(self) -> bytes:
        return sum256(self.to_bytes())
