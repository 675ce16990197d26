"""Mixed verification workloads (port of ``spacemesh_tpu/verify/workload.py``).

A workload is a list of farm requests (signatures, VRF proofs, POST
proofs, poet memberships, k2pow witnesses) with a controlled
invalid/malformed fraction, plus the inline oracle that verifies each
request one call at a time: the parity target the farm must match
bit for bit. The same seeds give the JAX package's requests exactly
(the tests hold the two through ``verifyd/protocol.py``'s docs). The
POST unit is made by the port's ``post.initializer`` and proved by its
``Prover`` on ``device``.

Left out against the JAX package: ``compare_serial_vs_farm`` (the
JAX bench's harness; nothing in the port calls it).
"""

from __future__ import annotations

import dataclasses
import hashlib
import random

from ..core.signing import Domain, EdSigner, EdVerifier, VrfVerifier
from ..post import verifier as post_verifier
from ..post.prover import Proof as PostProof, ProofParams, Prover
from .farm import (
    MembershipRequest,
    PostRequest,
    PowRequest,
    SigRequest,
    VrfRequest,
)

# tiny-but-real POST geometry (profiler.verify_benchmark uses the same):
# scrypt N=2 keeps the label recompute sub-second on CPU while running
# the full batched verify path
POST_PARAMS = ProofParams(k1=64, k2=16, k3=8,
                          pow_difficulty=bytes([32]) + bytes([255]) * 31)
POST_SCRYPT_N = 2
POST_LABELS = 512
POST_UNITS = 2


@dataclasses.dataclass
class Workload:
    requests: list
    ed: EdVerifier
    vrf: VrfVerifier
    post_params: ProofParams
    post_seed: bytes  # fixed K3 seed: serial and farm must sample alike
    device: str = "cuda"  # where the inline POST verify runs

    def inline_verify(self, req) -> bool:
        """The pre-farm serial path: one inline verifier call per item."""
        if isinstance(req, SigRequest):
            return self.ed.verify(req.domain, req.public_key, req.msg,
                                  req.signature)
        if isinstance(req, VrfRequest):
            return self.vrf.verify(req.public_key, req.alpha, req.proof)
        if isinstance(req, MembershipRequest):
            from ..consensus.poet import verify_membership

            return verify_membership(req.member, req.proof, req.root,
                                     req.leaf_count)
        if isinstance(req, PostRequest):
            return post_verifier.verify(req.item, self.post_params,
                                        seed=self.post_seed,
                                        device=self.device)
        if isinstance(req, PowRequest):
            from ..ops import pow as k2pow

            return k2pow.verify(req.challenge, req.node_id,
                                req.difficulty, req.nonce)
        raise TypeError(f"unknown request {type(req).__name__}")

    def inline_all(self) -> list[bool]:
        return [self.inline_verify(r) for r in self.requests]


def _corrupt(data: bytes, pos: int) -> bytes:
    return data[:pos] + bytes([data[pos] ^ 0x5A]) + data[pos + 1:]


def build(post_dir: str, *, sigs: int = 64, vrfs: int = 8, posts: int = 16,
          memberships: int = 8, pows: int = 0, post_challenges: int = 4,
          invalid_frac: float = 0.125, rng_seed: int = 7,
          device="cuda") -> Workload:
    """Build a deterministic mixed workload.

    ``post_dir`` must be an empty (or reusable) directory: a tiny real
    POST unit is initialized there once and proofs are generated against
    ``post_challenges`` distinct challenges; ``posts`` requests replicate
    them (replicated proofs are farm dedup fodder — exactly the gossip
    re-delivery pattern). Roughly ``invalid_frac`` of every kind is made
    invalid, including structurally malformed items (wrong-length keys,
    out-of-range POST indices), which must reject on both paths.
    """
    from ..post import initializer

    rng = random.Random(rng_seed)
    every = max(int(round(1 / invalid_frac)), 2) if invalid_frac > 0 else 0

    def bad(i: int) -> bool:
        return bool(every) and i % every == 0

    ed = EdVerifier()
    vrf = VrfVerifier()
    requests: list = []

    # --- ed25519 signatures ------------------------------------------
    signers = [EdSigner(seed=hashlib.sha256(
        b"wl-signer" + k.to_bytes(4, "little")).digest()) for k in range(4)]
    for i in range(sigs):
        s = signers[i % len(signers)]
        msg = b"workload-msg-" + i.to_bytes(4, "little")
        sig = s.sign(Domain.BALLOT, msg)
        if bad(i):
            mode = i % 3
            if mode == 0:
                sig = _corrupt(sig, rng.randrange(len(sig)))
            elif mode == 1:
                sig = sig[:17]  # malformed: wrong length
            else:
                msg = msg + b"!"  # signature over different bytes
        requests.append(SigRequest(int(Domain.BALLOT), s.public_key, msg,
                                   sig))

    # --- VRF proofs ---------------------------------------------------
    vrf_signers = [s.vrf_signer() for s in signers[:2]]
    for i in range(vrfs):
        vs = vrf_signers[i % len(vrf_signers)]
        alpha = b"workload-alpha-" + i.to_bytes(4, "little")
        proof = vs.prove(alpha)
        key = vs.public_key
        if bad(i):
            mode = i % 3
            if mode == 0:
                proof = _corrupt(proof, rng.randrange(len(proof)))
            elif mode == 1:
                proof = proof[:31]  # malformed: wrong length
            else:
                key = bytes(32)  # not a curve point's honest owner
        requests.append(VrfRequest(key, alpha, proof))

    # --- poet membership ---------------------------------------------
    from ..consensus.poet import merkle_path, merkle_root

    members = [b"member-" + k.to_bytes(4, "little") for k in range(16)]
    root = merkle_root(members)
    for i in range(memberships):
        idx = i % len(members)
        member = members[idx]
        proof = merkle_path(members, idx)
        if bad(i):
            if i % 2:
                member = b"not-a-member-" + i.to_bytes(4, "little")
            else:
                proof = dataclasses.replace(
                    proof, nodes=[_corrupt(n, 0) for n in proof.nodes])
        requests.append(MembershipRequest(member, proof, root,
                                          len(members)))

    # --- k2pow witnesses ---------------------------------------------
    if pows > 0:
        from ..ops import pow as k2pow

        pow_challenge = hashlib.sha256(b"wl-pow-challenge").digest()
        pow_node = hashlib.sha256(b"wl-pow-node").digest()
        # easy difficulty so honest witnesses are found in a few hashes
        difficulty = bytes([0x20]) + bytes([0xFF]) * 31
        nonce, found = 0, []
        while len(found) < max(pows // 2, 2):
            if k2pow.verify(pow_challenge, pow_node, difficulty, nonce):
                found.append(nonce)
            nonce += 1
        for i in range(pows):
            chall, node, diff = pow_challenge, pow_node, difficulty
            witness = found[i % len(found)]
            if bad(i):
                mode = i % 3
                if mode == 0:
                    witness = witness + 1  # walk to a guaranteed miss
                    while k2pow.verify(chall, node, diff, witness):
                        witness += 1
                elif mode == 1:
                    chall = _corrupt(chall, 0)  # wrong prefix
                else:
                    diff = bytes(32)  # impossible difficulty
            requests.append(PowRequest(chall, node, diff, witness))

    # --- POST proofs --------------------------------------------------
    if posts > 0:
        node = hashlib.sha256(b"wl-post-node").digest()
        commit = hashlib.sha256(b"wl-post-commit").digest()
        meta, _ = initializer.initialize(
            post_dir, node_id=node, commitment=commit,
            num_units=POST_UNITS, labels_per_unit=POST_LABELS,
            scrypt_n=POST_SCRYPT_N, max_file_size=4096, batch_size=256,
            device=device)
        prover = Prover(post_dir, POST_PARAMS, batch_labels=512,
                        device=device)
        proofs = []
        for c in range(max(post_challenges, 1)):
            challenge = hashlib.sha256(
                b"wl-challenge" + c.to_bytes(4, "little")).digest()
            proofs.append((challenge, prover.prove(challenge)))
        for i in range(posts):
            challenge, proof = proofs[i % len(proofs)]
            indices = list(proof.indices)
            if bad(i):
                mode = i % 3
                if mode == 0:
                    # in-range but wrong label: fails the device recompute
                    indices[i % len(indices)] = \
                        (indices[i % len(indices)] + 1) \
                        % meta.total_labels
                elif mode == 1:
                    indices[0] = meta.total_labels + 17  # out of range
                else:
                    indices = indices[:1]  # too few indices (< k2)
            requests.append(PostRequest(post_verifier.VerifyItem(
                proof=PostProof(nonce=proof.nonce, indices=indices,
                                pow_nonce=proof.pow_nonce,
                                k2=POST_PARAMS.k2),
                challenge=challenge, node_id=node, commitment=commit,
                scrypt_n=POST_SCRYPT_N,
                total_labels=meta.total_labels)))

    rng.shuffle(requests)
    return Workload(requests=requests, ed=ed, vrf=vrf,
                    post_params=POST_PARAMS,
                    post_seed=hashlib.sha256(b"wl-k3-seed").digest(),
                    device=str(device))
