"""No run loads JAX or the JAX package, compared by whole top-level names,
and the reference loads nothing of the program."""

import ast
import json
import subprocess
import sys

import pytest

from benchmark import harness

from .conftest import (PROVE_CELL, ROOT, TINY_CONFIG, TINY_TRAFFIC,
                       spec_with_prove, tiny_seconds)

CELLS = [w["name"] for w in spec_with_prove()["workloads"]]

RUN_CELL = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import harness
spec = harness.load_spec()
spec["workloads"].append({prove!r})
line = harness.run_cell(spec, {cell!r}, 2**31 + 99,
                        {secs!r}, False, "cpu",
                        config_overrides={config!r},
                        traffic_overrides={traffic!r}, cache={cache!r})
print(json.dumps({{"correct": line["correct"],
                  "forbidden": harness.forbidden_modules(),
                  "port": "spacemesh_tpu_torch" in sys.modules}}))
"""


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "spacemesh_tpu_torch_x", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_loads_no_jax(cell, tmp_path):
    code = RUN_CELL.format(root=str(ROOT), cell=cell, prove=PROVE_CELL,
                           secs=tiny_seconds(cell),
                           config=TINY_CONFIG, traffic=TINY_TRAFFIC[cell],
                           cache=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "forbidden": [], "port": True}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((ROOT / "benchmark" / "reference").glob("*.py"))
    assert files
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in (
                "spacemesh_tpu_torch", "spacemesh_tpu", "jax", "jaxlib"), \
                (f.name, name)
    # and it runs with the program made unimportable
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            "for m in ('spacemesh_tpu_torch', 'spacemesh_tpu', 'jax'):\n"
            "    sys.modules[m] = None\n"
            "from benchmark.reference import k2pow, labels, proving, store, "
            "vrf\n"
            "import numpy as np\n"
            "labs = np.zeros((64, 16), np.uint8)\n"
            "print(proving.prove(b'x' * 32, labs, 26, 3) is not None,\n"
            "      labels.label(b'c' * 32, 1, 16).hex())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[0] == "True"
