"""The check fails what it must: a run with the timed path broken
underneath comes out not correct, once for each fault a cell can have;
so does the control. Runs skip the harness's look for a card and drive
the rest at tiny sizes on the CPU; ``test_cells_on_the_card`` runs the
real cells where a card is."""

import copy
import json
import subprocess
import sys

import pytest

from benchmark import control, harness

from .conftest import (ROOT, TINY_CONFIG, TINY_SECONDS, TINY_TRAFFIC,
                       spec_with_prove, tiny_seconds)

SPEC = spec_with_prove()
CELLS = [w["name"] for w in SPEC["workloads"]]
CARD_CELLS = [w["name"] for w in harness.load_spec()["workloads"]]
INIT_FAULTS = ("unchanged", "half", "altered")
PROVE_FAULTS = ("proof_unchanged", "proof_altered", "pow_altered")


def _tiny(cell, seed=2**31 + 7, **traffic):
    return harness.run_cell(SPEC, cell, seed, tiny_seconds(cell), False,
                            "cpu",
                            config_overrides=TINY_CONFIG,
                            traffic_overrides=dict(TINY_TRAFFIC[cell],
                                                   **traffic))


def _break_labels(monkeypatch, fault):
    """Break both label entries where the words are produced: the solo
    init's and the scheduler's packs."""
    from spacemesh_tpu_torch.ops import scrypt

    def wrap(fn, words_at):
        first = {}

        def broken(*a, **k):
            out = fn(*a, **k)
            parts = list(out) if isinstance(out, tuple) else [out]
            w = parts[words_at]
            if fault == "unchanged":  # the first batch, over and over
                w = first.setdefault("w", w)
            elif fault == "half":  # half of each batch left out
                w = w.clone()
                w[:, w.shape[1] // 2:] = 0
            else:  # one bit of every label altered
                w = w ^ 1
            parts[words_at] = w
            return tuple(parts) if isinstance(out, tuple) else w
        return broken

    monkeypatch.setattr(scrypt, "scrypt_labels_with_min",
                        wrap(scrypt.scrypt_labels_with_min, 0))
    monkeypatch.setattr(scrypt, "scrypt_labels_packed",
                        wrap(scrypt.scrypt_labels_packed, 0))


def _break_proofs(monkeypatch, fault):
    from spacemesh_tpu_torch.post import prover

    step = prover.ProveSession.step
    seen = {}

    def broken(self):
        p = step(self)
        if p is None:
            return None
        p = copy.deepcopy(p)
        if fault == "proof_unchanged":  # the first proof, over and over
            return seen.setdefault("p", p)
        if fault == "proof_altered":
            p.indices[0] += 1
        else:
            p.pow_nonce += 1
        return p
    monkeypatch.setattr(prover.ProveSession, "step", broken)


def _break_vrf(monkeypatch, fault):
    """Break the VRF nonce where the solo init decodes the card's carry:
    the index moved by one, or the scan's result lost."""
    from spacemesh_tpu_torch.ops import scrypt

    decode = scrypt.vrf_carry_decode

    def broken(snap):
        out = decode(snap)
        if fault == "scan_dropped" or out is None:
            return None
        idx, value = out
        return idx + 1, value
    monkeypatch.setattr(scrypt, "vrf_carry_decode", broken)


def _starve(monkeypatch, tid):
    """One identity's proofs after its first never return: each of its
    later sessions takes its quanta and never moves on."""
    from spacemesh_tpu_torch.post import prover

    step = prover.ProveSession.step
    first = {}

    def starved(self):
        if self.tenant == tid and first.setdefault("s", self) is not self:
            return None
        return step(self)
    monkeypatch.setattr(prover.ProveSession, "step", starved)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_tiny_run_is_correct(cell):
    line = _tiny(cell)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert all(c["limit"] == 0 for c in line["checks"].values())


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in INIT_FAULTS])
def test_broken_labels_fail(monkeypatch, cell, fault):
    _break_labels(monkeypatch, fault)
    line = _tiny(cell)
    assert not line["correct"]
    assert line["checks"]["label_mismatch"]["value"] > 0


@pytest.mark.parametrize("fault", PROVE_FAULTS)
def test_broken_proofs_fail(monkeypatch, fault):
    _break_proofs(monkeypatch, fault)
    line = _tiny("prove-under-init-16id")
    assert not line["correct"]
    name = "pow_mismatch" if fault == "pow_altered" else "proof_mismatch"
    assert line["checks"][name]["value"] > 0


@pytest.mark.parametrize("fault", ("nonce_altered", "scan_dropped"))
def test_a_broken_vrf_nonce_fails(monkeypatch, fault):
    _break_vrf(monkeypatch, fault)
    line = _tiny("init-4su")
    assert not line["correct"]
    assert line["checks"]["vrf_mismatch"]["value"] == 1
    assert line["checks"]["label_mismatch"]["value"] == 0


def test_a_starved_identity_fails(monkeypatch):
    """An identity whose proofs stop returning is neither left out of the
    tail nor passed: its open proof is missing, and it has no proof in
    the window."""
    _starve(monkeypatch, "prove00")
    line = _tiny("prove-under-init-16id", drain_s=1.0)
    assert not line["correct"]
    checks = line["checks"]
    assert checks["proof_missing"]["value"] >= 1
    assert checks["identity_without_proofs"]["value"] == 1


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(monkeypatch, cell):
    """The program at half the stated N: every sampled label reads wrong."""
    monkeypatch.setattr(harness, "load_spec", lambda root=None: SPEC)
    line = control.control(cell, 2**31 + 3, tiny_seconds(cell), "cpu",
                           TINY_CONFIG, TINY_TRAFFIC[cell])
    assert not line["correct"]
    checks = line["checks"]
    assert checks["label_mismatch"]["value"] > 0
    assert all(v["value"] == 0 for k, v in checks.items()
               if k != "label_mismatch")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CARD_CELLS)
def test_cells_on_the_card(cuda, cell):
    """The command itself, briefly, on the card: correct, every end-to-end
    metric the cell names, the card's name."""
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2**31 + 11), "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    spec = harness.load_spec()
    want = {m["name"] for m in spec["end_to_end"]
            if harness.applies(m, cell)}
    assert set(line["metrics"]) == want


def test_a_traced_tiny_run_reads_spans_and_breaks_down():
    line = harness.run_cell(SPEC, "init-4su", 2**31 + 5, TINY_SECONDS, True,
                            "cpu", config_overrides=TINY_CONFIG,
                            traffic_overrides=TINY_TRAFFIC["init-4su"])
    assert line["correct"]
    # the span readers find their spans; the card's readers find nothing
    # on the CPU and leave their metrics out
    assert {"init_fetch_pct", "store_write_stall_pct"} <= set(
        line["metrics"])
    assert "label_kernels_roofline_pct" not in line["metrics"]
    assert line["device"]["window_s"] >= TINY_SECONDS
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
