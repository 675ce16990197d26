"""Port twins of the JAX package's tests.

``load(name)`` reads ``tests/<name>.py``, names ``spacemesh_tpu_torch``
wherever it named ``spacemesh_tpu``, and builds the port components these
tests construct that default to the card (``App``, malfeasance's
``Handler``, ``PostClient``, ``PostSupervisor``, ``initializer.initialize``
and ``verifier.verify``) with ``device="cpu"``, and the node CLI they
spawn (``-m spacemesh_tpu_torch.node``) with ``--device cpu``; a
``tests.<other>`` module it imports (``import tests.<other> as x`` or
``from tests.<other> import a, b``) is that module's twin.
``export(name, ns)`` puts the loaded module's tests and fixtures into a
test file's namespace, with a module fixture that pins torch to one thread
(xdist workers otherwise spin one OpenMP thread per core each).
"""

import functools
import pathlib
import re
import types as pytypes

import pytest
import torch

TESTS = pathlib.Path(__file__).resolve().parent

# port constructors and functions, called by the twinned tests, whose
# ``device`` defaults to "cuda" (the last two qualified by their module, so
# that no other ``initialize``/``verify`` method is touched)
_ON_CARD = ("App", "Handler", "PostClient", "PostSupervisor",
            r"initializer\.initialize", r"verifier\.verify")
_CALL = re.compile(r"(?<![\w.])((?:[A-Za-z_]\w*\.)*(?:%s))\("
                   % "|".join(_ON_CARD))


def _on_cpu(cls):
    return functools.partial(cls, device="cpu")


# ``import tests.<name> as <alias>``: a test file that drives another's
# tests (``test_quic.py`` re-runs ``test_transport.py``'s over QUIC)
_TESTS_IMPORT = re.compile(r"^(\s*)import tests\.(\w+) as (\w+)$", re.M)
# ``from tests.<name> import a, b as c`` on one line: a test file that
# borrows another's helpers (``test_fuzz_surfaces.py`` takes
# ``test_transport.py``'s hosts); each name is read off that file's twin
# when the statement runs, so one inside a function loads the twin only
# if the function is called
_TESTS_FROM = re.compile(
    r"^(\s*)from tests\.(\w+) import \(?([\w, ]+?)\)?[ \t]*$", re.M)


def _from_twin(m: re.Match) -> str:
    indent, name, names = m.group(1), m.group(2), m.group(3)
    pairs = [part.split(" as ") for part in
             (n.strip() for n in names.split(",")) if part]
    targets = ", ".join(p[-1].strip() for p in pairs)
    values = ", ".join(f"_twin({name!r}).{p[0].strip()}" for p in pairs)
    return f"{indent}{targets} = {values}"


@functools.lru_cache(maxsize=None)
def _twin(name: str):
    return load(name)


def load(name: str, pkg: str = "spacemesh_tpu_torch"):
    """``tests/<name>.py`` as a module over ``pkg``; a ``tests.<other>``
    module it imports is that module's port twin too."""
    src = (TESTS / f"{name}.py").read_text()
    src = re.sub(r"\bspacemesh_tpu\b", pkg, src)
    if pkg == "spacemesh_tpu_torch":
        src = _CALL.sub(r"_on_cpu(\1)(", src)
        src = _TESTS_IMPORT.sub(r"\1\3 = _twin('\2')", src)
        src = _TESTS_FROM.sub(_from_twin, src)
        # the port's node CLI defaults to the card too
        src = src.replace('"-m", "spacemesh_tpu_torch.node",',
                          '"-m", "spacemesh_tpu_torch.node", "--device", "cpu",')
    mod = pytypes.ModuleType(f"_{pkg}_{name}")
    mod.__file__ = str(TESTS / f"{name}.py")
    mod._on_cpu = _on_cpu
    mod._twin = _twin
    exec(compile(src, f"{mod.__file__} [{pkg}]", "exec"), mod.__dict__)
    return mod


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def export(name: str, ns: dict, only=None) -> pytypes.ModuleType:
    """Put ``tests/<name>.py``'s port twin's tests (or the ``only`` ones)
    and its fixtures into ``ns``; the twin is the one ``tests.<name>``
    imports resolve to (``_twin``), so a file may patch it first."""
    mod = _twin(name)
    for key, val in vars(mod).items():
        is_test = key.startswith("test_") and callable(val)
        if is_test and only is not None and key not in only:
            continue
        if is_test or hasattr(val, "_pytestfixturefunction") \
                or type(val).__name__ == "FixtureFunctionDefinition":
            ns[key] = val
    ns["_one_torch_thread"] = _one_torch_thread
    return mod
