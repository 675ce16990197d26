"""The benchmark's own tests: ``python -m pytest benchmark/tests``.

They run on the CPU at tiny sizes; a test marked ``cuda`` needs the card
and decides inside a fixture, so every worker collects the same tests."""

import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture(autouse=True)
def _port_caches(tmp_path_factory, monkeypatch):
    """The port's caches and the benchmark's stores in a temporary root,
    and no ROMix race: the CPU tests take the static decision."""
    from benchmark import harness

    root = tmp_path_factory.getbasetemp()
    monkeypatch.setenv("SPACEMESH_TORCH_CACHE", str(root / "port-cache"))
    monkeypatch.setenv("SPACEMESH_ROMIX_AUTOTUNE", "off")
    monkeypatch.setattr(harness, "CACHE", root / "bench-cache")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on "
                    "the card)")
    return "cuda"


# the prove cell, held back from BENCHMARK.json while the scheduler leaves
# an identity without proofs (PERF.md, Open questions): its mix, readers
# and checks are held here, so that it returns as entries alone
PROVE_CELL = {"name": "prove-under-init-16id", "config": "mainnet-16x4su",
              "traffic": "prove_under_init", "chips": 1,
              "why": "4 identities pack-init while 12 prove in a closed loop"}


def spec_with_prove() -> dict:
    from benchmark import harness

    spec = harness.load_spec()
    spec["workloads"].append(dict(PROVE_CELL))
    return spec


# the cells cut to what the CPU's plain twins finish in seconds: the same
# entry points and mixes, tiny N and stores, fewer identities, and a k2
# that a 64-label store wins within a window or two
TINY_CONFIG = {"scrypt_n": 16, "labels_per_unit": 1 << 20, "init_batch": 64,
               "prove_labels_per_unit": 16, "k2": 28}
TINY_TRAFFIC = {
    "init-4su": {"sample_labels": 64},
    "packed-init-16id": {"init_identities": 2, "sample_labels": 32},
    "prove-under-init-16id": {"init_identities": 1, "prove_identities": 2,
                              "warm_proofs": 2, "sample_labels": 16,
                              "sample_prove_store_labels": 16},
}
TINY_SECONDS = 5.0


def tiny_seconds(cell: str) -> float:
    """The window of a tiny run: the prove cell's CPU proofs take a second
    or more each, and every proving identity must return one inside it."""
    return 15.0 if cell == PROVE_CELL["name"] else TINY_SECONDS
os.environ.setdefault("SPACEMESH_ROMIX_AUTOTUNE", "off")
