"""PoST worker CLI: init / prove / verify / benchmark / serve.

Port of ``spacemesh_tpu/post/__main__.py`` with the same subcommands,
flags, defaults and JSON output keys, plus ``--device`` (default
``cuda``). Without a card and without ``--device cpu`` every subcommand
exits non-zero with the device error; nothing falls back to the CPU.

Usage:
  python -m spacemesh_tpu_torch.post init --data-dir D --node-id-hex .. \\
      --commitment-hex .. --num-units 1 --labels-per-unit 1024 [--scrypt-n N]
  python -m spacemesh_tpu_torch.post prove --data-dir D --challenge-hex ..
  python -m spacemesh_tpu_torch.post verify --data-dir D --proof-file P.json \\
      --challenge-hex ..
  python -m spacemesh_tpu_torch.post benchmark [--batch B] [--scrypt-n N]
  python -m spacemesh_tpu_torch.post serve --data-dir BASE \\
      [--listen H:P | --node-address H:P]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def _hex32(s: str) -> bytes:
    b = bytes.fromhex(s)
    if len(b) != 32:
        raise argparse.ArgumentTypeError("expected 32 bytes of hex")
    return b


def _rounded(stats: dict) -> dict:
    return {k: round(v, 3) if isinstance(v, float) else v
            for k, v in stats.items()}


def cmd_init(a) -> int:
    from . import initializer

    def progress(done, total):
        print(f"\r{done}/{total} labels ({100 * done / total:.1f}%)",
              end="", file=sys.stderr, flush=True)

    meta, res = initializer.initialize(
        a.data_dir, node_id=a.node_id_hex, commitment=a.commitment_hex,
        num_units=a.num_units, labels_per_unit=a.labels_per_unit,
        scrypt_n=a.scrypt_n, max_file_size=a.max_file_size,
        batch_size=a.batch, progress=progress,
        inflight=a.inflight, writers=a.writers, device=a.dev)
    print("", file=sys.stderr)
    out = {
        "labels_written": res.labels_written,
        "vrf_nonce": res.vrf_nonce,
        "labels_per_s": round(res.labels_per_s, 1),
        "elapsed_s": round(res.elapsed_s, 2),
    }
    if a.stage_timings and res.stats is not None:
        out["stages"] = _rounded(res.stats.as_dict())
    print(json.dumps(out))
    return 0


def cmd_prove(a) -> int:
    from .prover import ProofParams, Prover

    params = ProofParams(k1=a.k1, k2=a.k2, k3=a.k3)
    t0 = time.monotonic()
    prover = Prover(a.data_dir, params, batch_labels=a.batch,
                    pipelined=None if not a.serial else False,
                    window_groups=a.window_groups, inflight=a.inflight,
                    readers=a.readers, device=a.dev)
    proof = prover.prove(a.challenge_hex)
    out = proof.to_dict() | {"elapsed_s": round(time.monotonic() - t0, 2)}
    if a.stage_timings and prover.last_stats is not None:
        out["stages"] = _rounded(prover.last_stats.as_dict())
    if a.out:
        Path(a.out).write_text(json.dumps(proof.to_dict()))
    print(json.dumps(out))
    return 0


def cmd_verify(a) -> int:
    from . import verifier
    from .data import PostMetadata
    from .prover import Proof, ProofParams

    meta = PostMetadata.load(a.data_dir)
    proof = Proof.from_dict(json.loads(Path(a.proof_file).read_text()))
    params = ProofParams(k1=a.k1, k2=a.k2, k3=a.k3)
    ok = verifier.verify(verifier.VerifyItem(
        proof=proof, challenge=a.challenge_hex,
        node_id=bytes.fromhex(meta.node_id),
        commitment=bytes.fromhex(meta.commitment),
        scrypt_n=meta.scrypt_n, total_labels=meta.total_labels), params,
        device=a.dev)
    print(json.dumps({"valid": ok}))
    return 0 if ok else 1


def cmd_benchmark(a) -> int:
    import numpy as np
    import torch

    from ..ops import scrypt, u32

    dev = a.dev
    cw = u32.from_numpy(scrypt.commitment_to_words(bytes(32)), dev)
    lo_, hi_ = scrypt.split_indices(np.arange(a.batch, dtype=np.uint64))
    lo, hi = u32.from_numpy(lo_, dev), u32.from_numpy(hi_, dev)

    def labels() -> None:
        scrypt.scrypt_labels_words(cw, lo, hi, n=a.scrypt_n)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    labels()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    labels()
    dt = time.perf_counter() - t0
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({
        "device": name, "batch": a.batch, "scrypt_n": a.scrypt_n,
        "labels_per_s": round(a.batch / dt, 1),
        "compile_s": round(compile_s, 2),
    }))
    return 0


def cmd_serve(a) -> int:
    """Serve every identity under --data-dir to the node.

    Two transports behind the same PostService registry:
    * default: listen on --listen, the node dials in (JSON-RPC framing,
      ``post/remote.py``);
    * --node-address: dial the node's gRPC PostService and Register each
      identity over a bidirectional stream (``post/grpc_worker.py``).
    """
    import asyncio

    from .prover import ProofParams
    from .remote import WorkerServer, discover_identities

    params = ProofParams(k1=a.k1, k2=a.k2, k3=a.k3,
                         pow_difficulty=bytes.fromhex(a.pow_difficulty))
    service = discover_identities(a.data_dir, params=params, device=a.dev)

    async def go_grpc():
        from .grpc_worker import GrpcWorker

        worker = GrpcWorker(service, a.node_address)
        await worker.start()
        print(json.dumps({"event": "Registering",
                          "node_address": a.node_address,
                          "identities": [n.hex() for n in
                                         service.registered()]}),
              flush=True)
        try:
            await asyncio.Event().wait()  # until killed
        finally:
            await worker.stop()

    async def go_listen():
        server = WorkerServer(service, listen=a.listen)
        host, port = await server.start()
        print(json.dumps({"event": "Serving", "host": host, "port": port,
                          "identities": [n.hex() for n in
                                         service.registered()]}),
              flush=True)
        try:
            await asyncio.Event().wait()  # until killed
        finally:
            await server.stop()

    try:
        asyncio.run(go_grpc() if a.node_address else go_listen())
    except KeyboardInterrupt:
        pass
    return 0


def _device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="device to run on: cuda (default; exits non-zero "
                   "without a card) or cpu")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="spacemesh_tpu_torch.post")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("init", help="fill a PoST data directory with labels")
    pi.add_argument("--data-dir", required=True)
    pi.add_argument("--node-id-hex", type=_hex32, required=True)
    pi.add_argument("--commitment-hex", type=_hex32, required=True)
    pi.add_argument("--num-units", type=int, required=True)
    pi.add_argument("--labels-per-unit", type=int, required=True)
    pi.add_argument("--scrypt-n", type=int, default=8192)
    pi.add_argument("--max-file-size", type=int, default=64 * 1024 * 1024)
    pi.add_argument("--batch", type=int, default=1 << 13)
    pi.add_argument("--inflight", type=int, default=None,
                    help="device batches in flight (default: "
                    "SPACEMESH_INFLIGHT or 3)")
    pi.add_argument("--writers", type=int, default=None,
                    help="background disk-writer threads (default: "
                    "SPACEMESH_WRITERS or 2)")
    pi.add_argument("--stage-timings", action="store_true",
                    help="include per-stage pipeline timings in the output")
    _device_arg(pi)
    pi.set_defaults(fn=cmd_init)

    pp = sub.add_parser("prove", help="generate a proof over the challenge")
    pp.add_argument("--data-dir", required=True)
    pp.add_argument("--challenge-hex", type=_hex32, required=True)
    pp.add_argument("--k1", type=int, default=26)
    pp.add_argument("--k2", type=int, default=37)
    pp.add_argument("--k3", type=int, default=37)
    pp.add_argument("--batch", type=int, default=1 << 14)
    pp.add_argument("--serial", action="store_true",
                    help="use the synchronous scan instead of the "
                    "streaming pipeline")
    pp.add_argument("--window-groups", type=int, default=None,
                    help="nonce groups of 16 scanned per disk pass, in one "
                    "scan launch per batch (default: "
                    "SPACEMESH_PROVE_WINDOW_GROUPS or 1)")
    pp.add_argument("--inflight", type=int, default=None,
                    help="device batches in flight (default: "
                    "SPACEMESH_PROVE_INFLIGHT or 3)")
    pp.add_argument("--readers", type=int, default=None,
                    help="background label-reader threads (default: "
                    "SPACEMESH_PROVE_READERS or 2)")
    pp.add_argument("--stage-timings", action="store_true",
                    help="include per-stage prove pipeline timings")
    pp.add_argument("--out", help="write proof JSON here as well")
    _device_arg(pp)
    pp.set_defaults(fn=cmd_prove)

    pv = sub.add_parser("verify", help="verify a proof file")
    pv.add_argument("--data-dir", required=True)
    pv.add_argument("--proof-file", required=True)
    pv.add_argument("--challenge-hex", type=_hex32, required=True)
    pv.add_argument("--k1", type=int, default=26)
    pv.add_argument("--k2", type=int, default=37)
    pv.add_argument("--k3", type=int, default=37)
    _device_arg(pv)
    pv.set_defaults(fn=cmd_verify)

    pb = sub.add_parser(
        "benchmark", help="time the labeler on this device",
        description="Times one batch of scrypt labels through the three "
        "kernels (PBKDF2 expand -> ROMix -> PBKDF2 finish) and prints "
        "labels_per_s from the second call. compile_s is the first call's "
        "time: the kernel libraries' load (and their nvcc build, if not "
        "built yet) and CUDA's lazy initialization.")
    pb.add_argument("--batch", type=int, default=2048)
    pb.add_argument("--scrypt-n", type=int, default=8192)
    _device_arg(pb)
    pb.set_defaults(fn=cmd_benchmark)

    ps = sub.add_parser("serve", help="serve identities to the node "
                        "(out-of-process worker)")
    ps.add_argument("--data-dir", required=True,
                    help="base dir holding per-identity PoST data dirs")
    ps.add_argument("--listen", default="127.0.0.1:0")
    ps.add_argument("--node-address", default=None,
                    help="dial the node's gRPC PostService at host:port "
                    "instead of listening")
    ps.add_argument("--k1", type=int, default=26)
    ps.add_argument("--k2", type=int, default=37)
    ps.add_argument("--k3", type=int, default=37)
    ps.add_argument("--pow-difficulty", default="00ff" + "ff" * 30,
                    help="32-byte hex PoW difficulty")
    _device_arg(ps)
    ps.set_defaults(fn=cmd_serve)

    a = p.parse_args(argv)
    from ..device import resolve

    try:
        a.dev = resolve(a.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return a.fn(a)


if __name__ == "__main__":
    sys.exit(main())
