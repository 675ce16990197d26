"""The port's VM and conservative state (``spacemesh_tpu_torch/vm/``,
``spacemesh_tpu_torch/txs/``) against the JAX package's.

The cases of ``tests/test_vm.py`` run once on each package, with the same
seeded keys in both: every ``VM.apply`` must return the same receipts
and state root in both runs, and each case's own assertions hold on the
port. Then a seeded stream of spawns, spends, vault drains, overdrafts,
replays and bad nonces goes through both packages' ``ConservativeState``
and ``VM`` layer by layer, with a revert and a reapply: admission
verdicts, receipts, balances and state roots equal at every step. Exact
equality throughout.
"""

import hashlib
import importlib
import inspect
import itertools
import pathlib
import re
import types as pytypes

import numpy as np
import pytest

TESTS = pathlib.Path(__file__).resolve().parent
PKGS = ("spacemesh_tpu", "spacemesh_tpu_torch")


def twin_module(name: str, pkg: str):
    """``tests/<name>.py`` loaded as a module whose imports name ``pkg``."""
    src = (TESTS / f"{name}.py").read_text()
    src = re.sub(r"\bspacemesh_tpu\b", pkg, src)
    mod = pytypes.ModuleType(f"_{pkg}_{name}")
    mod.__file__ = str(TESTS / f"{name}.py")
    exec(compile(src, f"{mod.__file__} [{pkg}]", "exec"), mod.__dict__)
    return mod


def call_case(mod, case: str) -> None:
    """Run ``mod.case`` with its module's fixtures."""
    fn = getattr(mod, case)
    fn(**{name: getattr(mod, name)._get_wrapped_function()()
          for name in inspect.signature(fn).parameters})


def seeded_signers(monkeypatch, pkg: str) -> None:
    """Unseeded ``EdSigner``s draw their seeds from one counter, so both
    packages' runs of a case hold the same keys."""
    signing = importlib.import_module(f"{pkg}.core.signing")
    real = signing.EdSigner.__init__
    seeds = itertools.count()

    def init(self, seed=None, prefix=b""):
        if seed is None:
            seed = hashlib.sha256(b"twin-%d" % next(seeds)).digest()
        real(self, seed=seed, prefix=prefix)

    monkeypatch.setattr(signing.EdSigner, "__init__", init)


def _results(results) -> list:
    return [(r.status, r.message, r.gas_consumed, r.fee, r.layer,
             bytes(r.block)) for r in results]


VM_CASES = sorted(n for n in dir(twin_module("test_vm", PKGS[0]))
                  if n.startswith("test_"))


@pytest.mark.parametrize("case", VM_CASES)
def test_vm_case_twin(case, monkeypatch):
    runs = {}
    for pkg in PKGS:
        vm_mod = importlib.import_module(f"{pkg}.vm.vm")
        log = []
        real_apply, real_revert = vm_mod.VM.apply, vm_mod.VM.revert

        def apply(self, layer, block_id, txs, rewards, _real=real_apply,
                  _log=log):
            results, root = _real(self, layer, block_id, txs, rewards)
            _log.append(("apply", layer, bytes(block_id),
                         [t.id for t in txs], _results(results), root))
            return results, root

        def revert(self, to_layer, _real=real_revert, _log=log):
            _log.append(("revert", to_layer))
            return _real(self, to_layer)

        seeded_signers(monkeypatch, pkg)
        monkeypatch.setattr(vm_mod.VM, "apply", apply)
        monkeypatch.setattr(vm_mod.VM, "revert", revert)
        call_case(twin_module("test_vm", pkg), case)
        monkeypatch.undo()
        runs[pkg] = log
    assert runs[PKGS[0]], "the case applied no block"
    assert runs[PKGS[1]] == runs[PKGS[0]]


# --- a seeded transaction stream through both packages --------------------


def _world(pkg: str, keys: list, seed: int):
    """One package's node state: a state DB, VM, mempool, seeded signers
    and their wallet addresses, and one vault owned by the first wallet."""
    db = importlib.import_module(f"{pkg}.storage.db")
    signing = importlib.import_module(f"{pkg}.core.signing")
    vm_pkg = importlib.import_module(f"{pkg}.vm")
    sdk = importlib.import_module(f"{pkg}.vm.sdk")
    T = importlib.import_module(f"{pkg}.vm.templates")
    txs = importlib.import_module(f"{pkg}.txs")
    w = pytypes.SimpleNamespace(pkg=pkg, sdk=sdk, T=T)
    w.txstore = importlib.import_module(f"{pkg}.storage.transactions")
    w.layers = importlib.import_module(f"{pkg}.storage.layers")
    w.types = importlib.import_module(f"{pkg}.core.types")
    w.state = db.open_state()
    w.vm = vm_pkg.VM(w.state, signing.EdVerifier(prefix=b"twin"))
    w.cstate = txs.ConservativeState(w.state, w.vm)
    w.signers = [signing.EdSigner(seed=k, prefix=b"twin") for k in keys]
    w.addr = [sdk.wallet_address(s.public_key) for s in w.signers]
    w.vault_args = T.VaultSpawnArgs(owner=w.addr[0].raw, total_amount=10**8,
                                    initial_unlock=10**6, vesting_start=2,
                                    vesting_end=12)
    w.vault = sdk.vault_address(w.vault_args)
    alloc = {a.raw: 10**10 * (1 + i) for i, a in enumerate(w.addr)}
    alloc[w.vault.raw] = 10**8
    w.genesis = w.vm.apply_genesis(alloc)
    return w


def _stream_ops(seed: int, n_keys: int, layers: int) -> list:
    """Per layer a list of seeded operations: (kind, sender, receiver,
    amount, nonce offset). Kinds: spend, overdraft, replay, gap, drain,
    drain_over, bad_sig."""
    rng = np.random.default_rng(seed)
    kinds = ["spend"] * 10 + ["overdraft", "replay", "gap", "drain",
                              "drain_over", "bad_sig"]
    out = []
    for _ in range(layers):
        ops = []
        for _ in range(int(rng.integers(4, 12))):
            ops.append((kinds[int(rng.integers(len(kinds)))],
                        int(rng.integers(n_keys)), int(rng.integers(n_keys)),
                        int(rng.integers(1, 10**6))))
        out.append(ops)
    return out


def _make_tx(w, op, nonces: dict):
    kind, src, dst, amount = op
    sdk = w.sdk
    nonce = nonces[src]
    if kind == "spend":
        nonces[src] += 1
        return sdk.spend(w.addr[src], [w.signers[src]], w.addr[dst], amount,
                         nonce=nonce)
    if kind == "overdraft":
        return sdk.spend(w.addr[src], [w.signers[src]], w.addr[dst],
                         10**15, nonce=nonce)
    if kind == "replay":
        return sdk.spend(w.addr[src], [w.signers[src]], w.addr[dst], amount,
                         nonce=max(nonce - 1, 0))
    if kind == "gap":
        return sdk.spend(w.addr[src], [w.signers[src]], w.addr[dst], amount,
                         nonce=nonce + 3)
    if kind == "bad_sig":
        return sdk.spend(w.addr[src], [w.signers[(src + 1) % len(w.signers)]],
                         w.addr[dst], amount, nonce=nonce)
    # vault drains by the owner (wallet 0)
    nonce = nonces[0]
    nonces[0] += 1
    return sdk.drain_vault(w.addr[0], [w.signers[0]], w.vault, w.addr[dst],
                           amount if kind == "drain" else 10**9, nonce=nonce)


def _snapshot(w) -> tuple:
    accounts = sorted((bytes(r["address"]), r["balance"], r["next_nonce"],
                       r["template"], r["state"])
                      for r in w.txstore.all_current_accounts(w.state))
    return accounts, w.cstate.pending_count()


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_seeded_stream_equal_in_both_packages(seed):
    keys = [hashlib.sha256(b"stream-%d-%d" % (seed, i)).digest()
            for i in range(6)]
    worlds = [_world(pkg, keys, seed) for pkg in PKGS]
    assert worlds[0].genesis == worlds[1].genesis
    ops = _stream_ops(seed, len(keys), 10)
    roots, blocks, seen = [], [{} for _ in worlds], set()
    for layer in range(1, len(ops) + 2):
        per = []
        for w, blk in zip(worlds, blocks):
            if layer == 1:  # every wallet and the vault spawn
                txs = [w.sdk.spawn_wallet(s) for s in w.signers]
                txs.append(w.sdk.spawn_vault(w.vault_args))
            else:
                nonces = {i: w.cstate.projected(a.raw)[0]
                          for i, a in enumerate(w.addr)}
                txs = [_make_tx(w, op, nonces) for op in ops[layer - 2]]
            verdicts = [int(w.cstate.add(tx)) for tx in txs]
            chosen = w.cstate.select_proposal_txs(700)
            # the block also carries the refused ones: execution must
            # fail them alike
            blk[layer] = [w.cstate.get(t) for t in chosen] + [
                tx for tx, v in zip(txs, verdicts) if v]
            results, root = w.vm.apply(layer, bytes([layer]) * 32,
                                       blk[layer], [])
            w.layers.set_applied(w.state, layer, bytes([layer]) * 32, root)
            w.cstate.on_applied()
            per.append((verdicts, chosen, _results(results), root,
                        _snapshot(w)))
        assert per[1] == per[0], f"layer {layer}"
        assert 0 in per[0][0], f"layer {layer}: nothing admitted"
        seen.update(per[0][0])
        roots.append(per[0][3])
    assert len(set(roots)) == len(roots)
    assert len(seen) >= 3, seen  # admitted and refused for two reasons
    # revert to layer 4, then reapply layer 5's block: its root again
    for w in worlds:
        w.vm.revert(4)
    assert _snapshot(worlds[0]) == _snapshot(worlds[1])
    assert worlds[0].vm.state_root(4) == worlds[1].vm.state_root(4) \
        == roots[3]
    again = [w.vm.apply(5, bytes([5]) * 32, blk[5], [])
             for w, blk in zip(worlds, blocks)]
    assert _results(again[0][0]) == _results(again[1][0])
    assert again[0][1] == again[1][1] == roots[4]
