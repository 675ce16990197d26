"""VRF eligibility oracle: proposal slots and hare committees (port of
``spacemesh_tpu/consensus/eligibility.py``, whole).

Mirrors the reference's two oracles:

- miner slots (reference miner/proposal_builder.go:482 initSignerData +
  proposals/eligibility_validator.go): an ATX of weight w gets
  ceil(w * slots_per_epoch / W_total) proposal eligibilities per epoch;
  slot j's VRF output places it in a layer of the epoch.
- hare committee (reference hare3/eligibility/oracle.go:344
  CalcEligibility): per (layer, round), an identity's seat count is a
  binomial sample — ``weight`` Bernoulli trials at p = committee/W_total,
  drawn by inverse CDF at the VRF output's uniform fraction
  (core/fixedpoint.py); the eligibility proof is the VRF signature,
  verifiable by anyone (oracle.go:297 Validate).

VRF message shapes (domain-separated through the VRF alpha):
  proposal slot:  "PROP" || beacon || epoch u32 || j u32
  hare round:     "HARE" || beacon || layer u32 || round u8
"""

from __future__ import annotations

import struct

from ..core import fixedpoint
from ..core.signing import VrfVerifier, vrf_output
from ..storage.cache import AtxCache


def proposal_alpha(beacon: bytes, epoch: int, j: int) -> bytes:
    return b"PROP" + beacon + struct.pack("<II", epoch, j)


def hare_alpha(beacon: bytes, layer: int, round_: int) -> bytes:
    return b"HARE" + beacon + struct.pack("<IB", layer, round_)


class Oracle:
    def __init__(self, cache: AtxCache, layers_per_epoch: int,
                 slots_per_layer: int = 50,
                 min_weight_table: list[tuple[int, int]] | None = None):
        self.cache = cache
        self.layers_per_epoch = layers_per_epoch
        self.slots_per_layer = slots_per_layer
        # (epoch, weight) ascending — reference miner/minweight table,
        # wired from config (mainnet.go MinimalActiveSetWeight)
        self.min_weight_table = min_weight_table or []
        self._vrf = VrfVerifier()

    # --- proposal eligibility -----------------------------------------

    def trusts_declared(self, epoch: int) -> bool:
        """Whether declared-active-set denominators are honored for this
        epoch. Only on networks with a NONZERO consensus min-weight
        floor: the floor is what stops an attacker from declaring a
        dust set (e.g. only their own ATX) and collecting the whole
        epoch's slot allotment — num_eligible_slots divides by
        max(floor, declared). With floor == 0 that defense is absent,
        so the declared total is ignored and eligibility falls back to
        the validator's local epoch weight (reference config/mainnet.go
        MinimalActiveSetWeight is nonzero from genesis for the same
        reason)."""
        from .activeset import select_min_weight

        return select_min_weight(epoch, self.min_weight_table) > 0

    def num_slots(self, epoch: int, atx_id: bytes,
                  total_override: int | None = None) -> int:
        """Proposal slots for this ATX in the epoch: weight-proportional
        with the epoch min-weight floor in the denominator
        (proposals/util/util.go:29-39 + miner/minweight Select) — the
        gating that stops dust identities from harvesting outsized slot
        counts on young or shrunken networks.

        ``total_override`` carries the weight of the active set DECLARED
        by the ballot under validation (reference validates against the
        ref ballot's declared set, not the local view: nodes
        with divergent ATX views must not disagree on ballot validity
        when the declared set is resolvable). The min-weight table is a
        CONSENSUS parameter: it enters this denominator, so it must
        match network-wide (like genesis config)."""
        from .activeset import num_eligible_slots, select_min_weight

        info = self.cache.get(epoch, atx_id)
        if info is None or info.malicious:
            return 0
        if total_override is not None and self.trusts_declared(epoch):
            total = total_override
        else:
            total = self.cache.epoch_weight(epoch)
        if total == 0:
            return 0
        return num_eligible_slots(
            info.weight, select_min_weight(epoch, self.min_weight_table),
            total, self.slots_per_layer, self.layers_per_epoch)

    def slot_layer(self, epoch: int, vrf_proof: bytes) -> int:
        """The layer (within the epoch) where a proposal slot lands."""
        out = vrf_output(vrf_proof)
        first = epoch * self.layers_per_epoch
        return first + int.from_bytes(out[8:16], "little") % self.layers_per_epoch

    def eligible_slots_for_layer(self, vrf_signer, beacon: bytes, epoch: int,
                                 atx_id: bytes, layer: int,
                                 total_override: int | None = None,
                                 ) -> list[tuple[int, bytes]]:
        """All (j, proof) proposal slots of this signer landing in ``layer``."""
        out = []
        for j in range(self.num_slots(epoch, atx_id, total_override)):
            proof = vrf_signer.prove(proposal_alpha(beacon, epoch, j))
            if self.slot_layer(epoch, proof) == layer:
                out.append((j, proof))
        return out

    def vrf_key(self, epoch: int, atx_id: bytes) -> bytes | None:
        info = self.cache.get(epoch, atx_id)
        return info.vrf_public_key if info else None

    def validate_slot(self, beacon: bytes, epoch: int, atx_id: bytes,
                      layer: int, j: int, proof: bytes,
                      total_override: int | None = None,
                      num_slots_override: int | None = None) -> bool:
        """``num_slots_override`` is the eligibility count already
        validated on the smesher's ref ballot — secondary ballots are
        bounded by THAT count, not a recomputation (reference
        eligibility_validator.go validateSecondary returns the ref
        ballot's stored EligibilityCount)."""
        info = self.cache.get(epoch, atx_id)
        if info is None or info.malicious:
            # the override must NOT bypass the malfeasance gate a
            # num_slots recomputation would apply — a detected
            # equivocator's later ballots lose eligibility immediately
            return False
        key = self.vrf_key(epoch, atx_id)
        bound = num_slots_override if num_slots_override is not None \
            else self.num_slots(epoch, atx_id, total_override)
        if key is None or j >= bound:
            return False
        if not self._vrf.verify(key, proposal_alpha(beacon, epoch, j), proof):
            return False
        return self.slot_layer(epoch, proof) == layer

    # --- hare committee ------------------------------------------------

    def _binomial_params(self, epoch: int, atx_id: bytes,
                         committee_size: int) -> tuple[int, int, int]:
        """(n_trials, p_num, p_den) of this identity's seat-count binomial:
        ``weight`` Bernoulli trials at p = committee / total_weight
        (reference oracle.go:271-292 prepareEligibilityCheck, including the
        committee>total rescale that keeps p <= 1)."""
        info = self.cache.get(epoch, atx_id)
        if info is None or info.malicious:
            return 0, 0, 1
        total = self.cache.epoch_weight(epoch)
        if total == 0:
            return 0, 0, 1
        n = info.weight
        if committee_size > total:
            n *= committee_size
            total *= committee_size
        return n, committee_size, total

    def _count_from_proof(self, proof: bytes, n: int, p_num: int,
                          p_den: int) -> int:
        """Seat count = inverse binomial CDF at the VRF output's uniform
        fraction (reference oracle.go:344-375 CalcEligibility via
        fixed.BinCDF) — both prover and validator compute the same count."""
        frac = fixedpoint.frac_from_bytes(vrf_output(proof))
        return fixedpoint.binomial_count(n, p_num, p_den, frac)

    def hare_eligibility(self, vrf_signer, beacon: bytes, layer: int,
                         round_: int, epoch: int, atx_id: bytes,
                         committee_size: int) -> tuple[bytes, int] | None:
        """(VRF proof, seat count) if on the committee, else None."""
        n, p_num, p_den = self._binomial_params(epoch, atx_id, committee_size)
        if n == 0 or p_num == 0:
            return None
        proof = vrf_signer.prove(hare_alpha(beacon, layer, round_))
        count = self._count_from_proof(proof, n, p_num, p_den)
        return (proof, count) if count > 0 else None

    def validate_hare(self, beacon: bytes, layer: int, round_: int,
                      epoch: int, atx_id: bytes, committee_size: int,
                      proof: bytes, claimed_count: int) -> bool:
        """Membership AND the claimed seat count must match the proof —
        the count is derived, never trusted (a forged count would multiply
        an attacker's vote weight). Equivalent to the reference's interval
        check BinCDF(n,p,x-1) <= vrfFrac < BinCDF(n,p,x) (oracle.go:324)."""
        key = self.vrf_key(epoch, atx_id)
        if key is None:
            return False
        if not self._vrf.verify(key, hare_alpha(beacon, layer, round_), proof):
            return False
        n, p_num, p_den = self._binomial_params(epoch, atx_id, committee_size)
        return (claimed_count > 0
                and claimed_count == self._count_from_proof(
                    proof, n, p_num, p_den))
