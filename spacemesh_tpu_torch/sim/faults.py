"""Scripted fault vocabulary + adversarial payload builders (port of
``spacemesh_tpu/sim/faults.py``, whole: the blobs and the torsion message
are byte-equal to the JAX package's for the same seed).

Each fault is a dict ``{"kind": ..., ...}`` in a scenario phase; the
engine calls :func:`apply_fault` at phase entry. Kinds:

  partition   {"islands": [[full idx, ...], ...]} — listed islands get
              their own partition groups; light nodes split round-robin
              across the islands by index. The in-proc analogue of
              systest/chaos/partition.go.
  heal        {} — clear partitions, eclipses, blocked links.
  eclipse     {"victim": ("full"|"light", i),
               "attackers": [("light", j), ...]} — the victim may only
              talk to its attackers.
  clear_eclipse {"victim": (...)}
  churn       {"light": [i, ...]} — suspend light nodes (frames lost).
  resume      {"light": [i, ...]}
  kill        {"full": i} — SIGKILL analogue for one full node.
  timeskew    {"full": i, "offset": seconds} — skew one node's clock
              (systest/chaos/timeskew.go); 0 resets.
  link_policy {"loss": p, "delay": s, "jitter": s, "dup": p,
               "reorder": p} — network default link degradation.
  adversary   {"what": "malformed_atx"|"torsion_sig"|"dup_flood",
               "count": n, "via": light idx} — hostile payload
              injection from a light node.

Adversarial payloads:

* ``malformed_atx`` — garbage and truncated blobs on the ATX topic:
  every full node must reject without crashing its handler loop.
* ``torsion_sig`` — a wire-valid hare message whose ed25519 signature
  carries a small-order torsion component in R (a consensus
  divergence class): cofactored verification must treat it IDENTICALLY
  on every node — farm batch or inline — so no divergence results.
* ``dup_flood`` — the same frame republished over and over (sub-flood
  duplication): the hubs' seen-caches must absorb it.
"""

from __future__ import annotations

import dataclasses
import hashlib

from ..core.signing import Domain


def torsion_point():
    """A nonzero small-order (torsion) point on edwards25519."""
    from ..core import signing

    i = 0
    while True:
        pt = signing._pt_decode(
            hashlib.sha256(b"sim-torsion%d" % i).digest())
        i += 1
        if pt is None:
            continue
        cand = signing._pt_mul(signing._Q, pt)
        if not signing._pt_eq(cand, signing._ID):
            return cand


def torsion_hare_message(layer: int, seed: int) -> bytes:
    """A well-formed PREROUND hare message whose signature is the
    honest (r, s) with ``R' = R + T`` for a small-order T: the ZIP-215
    cofactored check accepts the signature on every path, and the
    message then dies deterministically on eligibility (the identity
    holds no ATX). A split verifier — inline reject, batch accept
    ~7/8 of the time — would make nodes diverge on exactly this input.
    """
    from ..consensus.hare import PREROUND, HareMessage
    from ..core import signing

    t8 = torsion_point()
    kseed = hashlib.sha256(b"sim-torsion-key-%d" % seed).digest()
    scalar, nonce_prefix = signing._expand_key(kseed)
    pub = signing._pt_encode(signing._pt_mul_base(scalar))
    msg = HareMessage(
        layer=layer, iteration=0, round=PREROUND,
        values=[hashlib.sha256(b"sim-torsion-val-%d" % seed).digest()],
        eligibility_proof=bytes(80), eligibility_count=1,
        atx_id=hashlib.sha256(b"sim-torsion-atx-%d" % seed).digest(),
        node_id=pub, cert_msgs=[], signature=bytes(64))
    data = bytes([int(Domain.HARE)]) + msg.signed_bytes()
    r = int.from_bytes(hashlib.sha512(nonce_prefix + data).digest(),
                       "little") % signing._Q
    r_enc = signing._pt_encode(
        signing._pt_add(signing._pt_mul_base(r), t8))
    k = int.from_bytes(hashlib.sha512(r_enc + pub + data).digest(),
                       "little") % signing._Q
    s = (r + k * scalar) % signing._Q
    forged = dataclasses.replace(msg, signature=r_enc
                                 + s.to_bytes(32, "little"))
    return forged.to_bytes()


def malformed_atx_blobs(seed: int, count: int) -> list[bytes]:
    """Garbage + truncated blobs for the ATX topic."""
    out = []
    for i in range(count):
        body = hashlib.sha256(b"sim-bad-atx-%d-%d"
                              % (seed, i)).digest() * 8
        out.append(body if i % 2 == 0 else body[: 16 + i % 48])
    return out


class FaultError(ValueError):
    pass


def _resolve(engine, sel):
    kind, idx = sel
    if kind == "full":
        return engine.fulls[idx].name
    if kind == "light":
        return engine.lights[idx].name
    raise FaultError(f"unknown node selector {sel!r}")


def apply_fault(engine, spec: dict) -> str:
    """Apply one fault spec; returns the canonical line the event
    digest records (no timestamps — content only, replay-stable)."""
    net = engine.network
    kind = spec["kind"]
    if kind == "partition":
        islands = spec["islands"]
        groups = [[engine.fulls[i].name for i in isl] for isl in islands]
        for j, ln in enumerate(engine.lights):
            groups[j % len(groups)].append(ln.name)
        net.partition(groups)
        return "partition islands=%s lights=round-robin" % (
            ",".join("|".join(str(i) for i in isl) for isl in islands))
    if kind == "heal":
        net.heal()
        return "heal"
    if kind == "eclipse":
        victim = _resolve(engine, tuple(spec["victim"]))
        attackers = [_resolve(engine, tuple(a))
                     for a in spec["attackers"]]
        net.eclipse(victim, attackers)
        return "eclipse victim=%s attackers=%d" % (
            victim.hex()[:8], len(attackers))
    if kind == "clear_eclipse":
        net.clear_eclipse(_resolve(engine, tuple(spec["victim"])))
        return "clear_eclipse"
    if kind == "churn":
        for i in spec["light"]:
            engine.hub.suspend(engine.lights[i].name)
        return "churn light=%s" % ",".join(str(i) for i in spec["light"])
    if kind == "resume":
        for i in spec["light"]:
            engine.hub.resume(engine.lights[i].name)
        return "resume light=%s" % ",".join(str(i) for i in spec["light"])
    if kind == "kill":
        node = engine.fulls[spec["full"]]
        node.kill()
        return "kill full=%d" % spec["full"]
    if kind == "timeskew":
        node = engine.fulls[spec["full"]]
        node.skew = float(spec["offset"])
        return "timeskew full=%d offset=%s" % (spec["full"],
                                               spec["offset"])
    if kind == "link_policy":
        from .net import LinkPolicy

        fields = {k: float(spec[k]) for k in
                  ("loss", "delay", "jitter", "dup", "reorder",
                   "reorder_delay") if k in spec}
        net.set_link_policy(LinkPolicy(**fields))
        return "link_policy " + ",".join(
            f"{k}={v}" for k, v in sorted(fields.items()))
    raise FaultError(f"unknown fault kind {kind!r}")
