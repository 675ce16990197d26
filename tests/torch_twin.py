"""Port twins of the JAX package's tests.

``load(name)`` reads ``tests/<name>.py``, names ``spacemesh_tpu_torch``
wherever it named ``spacemesh_tpu``, and builds the port components these
tests construct that default to the card (``App``, malfeasance's
``Handler``, ``PostClient``, ``PostSupervisor``, ``Prover``,
``CertifierService``, the cluster harness's ``Cluster``, the sim's
``run_scenario``, ``initializer.initialize`` and ``verifier.verify``) with
``device="cpu"``, and the node CLI they
spawn (``-m spacemesh_tpu_torch.node``) and the profiler's ``main`` with
``--device cpu``; a
``tests.<other>`` module it imports (``import tests.<other> as x`` or
``from tests.<other> import a, b``) is that module's twin.
``export(name, ns)`` puts the loaded module's tests and fixtures into a
test file's namespace, with a module fixture that pins torch to one thread
(xdist workers otherwise spin one OpenMP thread per core each).
"""

import contextlib
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
_ON_CARD = ("App", "Handler", "PostClient", "PostSupervisor", "Prover",
            "CertifierService", "Cluster", "run_scenario",
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


def load(name: str, pkg: str = "spacemesh_tpu_torch", drop=()):
    """``tests/<name>.py`` as a module over ``pkg``; a ``tests.<other>``
    module it imports is that module's port twin too. Each line of
    ``drop`` is taken out of the source first (an import of a module the
    port does not have, used only by tests a twin leaves out)."""
    src = (TESTS / f"{name}.py").read_text()
    for line in drop:
        if line not in src:
            raise ValueError(f"tests/{name}.py has no line {line!r}")
        src = src.replace(line, "")
    src = re.sub(r"\bspacemesh_tpu\b", pkg, src)
    if pkg == "spacemesh_tpu_torch":
        src = _CALL.sub(r"_on_cpu(\1)(", src)
        src = _TESTS_IMPORT.sub(r"\1\3 = _twin('\2')", src)
        src = _TESTS_FROM.sub(_from_twin, src)
        # the port's node CLI defaults to the card too
        src = src.replace('"-m", "spacemesh_tpu_torch.node",',
                          '"-m", "spacemesh_tpu_torch.node", "--device", "cpu",')
        src = src.replace("profiler.main([",
                          'profiler.main(["--device", "cpu", ')
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


def export(name: str, ns: dict, only=None, drop=()) -> pytypes.ModuleType:
    """Put ``tests/<name>.py``'s port twin's tests (or the ``only`` ones)
    and its fixtures into ``ns``; the twin is the one ``tests.<name>``
    imports resolve to (``_twin``), so a file may patch it first. With
    ``drop`` (see :func:`load`) the twin is a copy of its own."""
    mod = load(name, drop=drop) if drop else _twin(name)
    for key, val in vars(mod).items():
        is_test = key.startswith("test_") and callable(val)
        if is_test and only is not None and key not in only:
            continue
        if is_test or hasattr(val, "_pytestfixturefunction") \
                or type(val).__name__ == "FixtureFunctionDefinition":
            ns[key] = val
    ns["_one_torch_thread"] = _one_torch_thread
    return mod


@contextlib.contextmanager
def hashlib_post():
    """The port's POST hashing on CPU tensors answered from ``hashlib``,
    the ground truth: the label recomputes (``ops/scrypt.py``'s
    ``scrypt_labels_words`` and ``scrypt_labels_hash``, with the proving
    hash of the port's plain twin) from ``hashlib.scrypt``, and k2pow's
    search windows (``ops/pow_cuda.py:search_window``) from
    ``hashlib.sha256``; each is first held to the function it stands in
    for on seeded inputs. The sim's network scenarios run a few full
    nodes whose POST inits, ATX checks and k2pow searches on the CPU are
    mostly the plain SHA-256 twin's thousands of tiny torch calls; the
    plain twins are held to hashlib in their own tests."""
    import hashlib

    import numpy as np

    from spacemesh_tpu_torch.ops import pow_cuda, proving_cuda, scrypt, u32

    def labels(cw, lo, hi, n):
        cw = u32.to_numpy(cw)
        idx = (u32.to_numpy(lo).astype(np.uint64)
               | u32.to_numpy(hi).astype(np.uint64) << np.uint64(32))
        if cw.ndim == 1:
            cw = np.repeat(cw[:, None], idx.size, axis=1)
        return np.frombuffer(b"".join(
            hashlib.scrypt(cw[:, b].astype(">u4").tobytes(),
                           salt=int(i).to_bytes(8, "little"), n=n, r=1,
                           p=1, dklen=16) for b, i in enumerate(idx)),
            dtype=np.uint8).reshape(-1, 16)

    def be_words(lab):
        return u32.from_numpy(np.frombuffer(lab.tobytes(), dtype=">u4")
                              .reshape(-1, 4).T.astype(np.uint32))

    def words(cw, lo, hi, *, n, chunk=None):
        return be_words(labels(cw, lo, hi, n))

    def hashed(cw, lo, hi, ch, nonce, *, n, words_out=False, chunk=None):
        lab = labels(cw, lo, hi, n)
        vals = proving_cuda.proving_hash(
            ch, nonce, lo, hi, u32.from_numpy(scrypt.labels_to_words(lab)))
        return vals, be_words(lab) if words_out else None

    real_window = pow_cuda.search_window

    def window(block1_words, target, start, count, found, device, **kw):
        if found.device.type != "cpu":
            return real_window(block1_words, target, start, count, found,
                               device, **kw)
        best = pow_cuda.cell_value(found)
        block1 = np.asarray(block1_words, dtype=np.uint32).astype(
            ">u4").tobytes()
        tgt = np.asarray(target, dtype=np.uint32).astype(">u4").tobytes()
        for nonce in range(start, min(start + count, best)):
            if hashlib.sha256(block1 + nonce.to_bytes(8, "little")
                              ).digest() < tgt:
                best = nonce
                break
        found.fill_(best - (1 << 64) if best >= 1 << 63 else best)

    rng = np.random.default_rng(5)
    cw = u32.from_numpy(rng.integers(0, 2**32, (8, 6), dtype=np.uint32))
    lo, ch = (u32.from_numpy(rng.integers(0, 2**32, s, dtype=np.uint32))
              for s in (6, (8, 6)))
    hi = u32.from_numpy(rng.integers(0, 3, 6, dtype=np.uint32))
    nonce = u32.from_numpy(rng.integers(0, 2**32, 6, dtype=np.uint32))
    assert torch.equal(words(cw[:, 0], lo, hi, n=2),
                       scrypt.scrypt_labels_words(cw[:, 0], lo, hi, n=2))
    got = hashed(cw, lo, hi, ch, nonce, n=4, words_out=True)
    want = scrypt.scrypt_labels_hash(cw, lo, hi, ch, nonce, n=4,
                                     words_out=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    block1 = rng.integers(0, 2**32, 16, dtype=np.uint32)
    for lead, start, count in ((0x20, 5, 600), (0x01, 0, 300)):
        target = np.array([lead << 24] + [0xFFFFFFFF] * 7, dtype=np.uint32)
        cells = [pow_cuda.new_cell("cpu") for _ in range(2)]
        for fn, cell in zip((window, real_window), cells):
            fn(block1, target, start, count, cell, "cpu")
        assert pow_cuda.cell_value(cells[0]) == pow_cuda.cell_value(cells[1])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scrypt, "scrypt_labels_words", words)
        mp.setattr(scrypt, "scrypt_labels_hash", hashed)
        mp.setattr(pow_cuda, "search_window", window)
        yield
