"""Port twins of the JAX package's node tests.

``load(name)`` reads ``tests/<name>.py``, names ``spacemesh_tpu_torch``
wherever it named ``spacemesh_tpu``, and builds the port components these
tests construct that default to the card (``App``, malfeasance's
``Handler``) with ``device="cpu"``. ``export(name, ns)`` puts the
loaded module's tests and fixtures into a test file's namespace, with a
module fixture that pins torch to one thread (xdist workers otherwise
spin one OpenMP thread per core each).
"""

import functools
import pathlib
import re
import types as pytypes

import pytest
import torch

TESTS = pathlib.Path(__file__).resolve().parent

# port constructors, built by the twinned tests, whose ``device``
# defaults to "cuda"
_ON_CARD = ("App", "Handler")
_CALL = re.compile(r"(?<![\w.])((?:[A-Za-z_]\w*\.)*(?:%s))\("
                   % "|".join(_ON_CARD))


def _on_cpu(cls):
    return functools.partial(cls, device="cpu")


def load(name: str, pkg: str = "spacemesh_tpu_torch"):
    """``tests/<name>.py`` as a module over ``pkg``."""
    src = (TESTS / f"{name}.py").read_text()
    src = re.sub(r"\bspacemesh_tpu\b", pkg, src)
    if pkg == "spacemesh_tpu_torch":
        src = _CALL.sub(r"_on_cpu(\1)(", src)
    mod = pytypes.ModuleType(f"_{pkg}_{name}")
    mod.__file__ = str(TESTS / f"{name}.py")
    mod._on_cpu = _on_cpu
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
    and its fixtures into ``ns``."""
    mod = load(name)
    for key, val in vars(mod).items():
        is_test = key.startswith("test_") and callable(val)
        if is_test and only is not None and key not in only:
            continue
        if is_test or hasattr(val, "_pytestfixturefunction") \
                or type(val).__name__ == "FixtureFunctionDefinition":
            ns[key] = val
    ns["_one_torch_thread"] = _one_torch_thread
    return mod
