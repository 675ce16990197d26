"""PostSupervisor: spawn and babysit the out-of-process PoST worker.

Port of ``spacemesh_tpu/post/supervisor.py``. The worker is the port's
own CLI (``python -u -m spacemesh_tpu_torch.post serve ... --device D``);
the supervisor restarts it when it exits until stopped, and keeps its
listen port stable across restarts so clients reconnect.

One difference from the JAX package: a worker that exits with the CLI's
usage code 2 before it ever reported ready (its device does not resolve,
e.g. no card for ``--device cuda``, or its flags are wrong) is not
restarted, since no retry can succeed; :meth:`PostSupervisor.start`
raises with the end of its error output instead of timing out. Any other
early exit (the card briefly out of memory, the port still held) is
restarted after the backoff, as the JAX supervisor does.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

# the CLI's exit code when the device does not resolve or a flag is wrong
# (post/__main__.py, argparse): a permanent failure, not a crash
EXIT_USAGE = 2


class PostSupervisor:
    def __init__(self, base_dir: str | Path, listen: str = "127.0.0.1:0",
                 restart_backoff: float = 1.0, env: dict | None = None,
                 params=None, node_address: str | None = None,
                 device: str = "cuda"):
        self.base_dir = str(base_dir)
        self.listen = listen
        # gRPC mode: the worker dials the node's PostService instead of
        # listening
        self.node_address = node_address
        self.restart_backoff = restart_backoff
        self.env = env  # read at every (re)spawn
        self.params = params  # ProofParams for the worker's provers
        self.device = str(device)
        self.address: tuple[str, int] | None = None
        self._proc: subprocess.Popen | None = None
        self._stopped = threading.Event()
        self._ready = threading.Event()
        self._thread: threading.Thread | None = None
        self._error: str | None = None
        self.restarts = -1  # the first start is not a restart

    def start(self, timeout: float = 60.0) -> tuple[str, int] | None:
        """Spawn the worker and wait until it reports its listen port (or,
        in gRPC mode, that it is registering). Raises RuntimeError when
        the worker exits with :data:`EXIT_USAGE` before that."""
        self._thread = threading.Thread(target=self._babysit, daemon=True)
        self._thread.start()
        if not self._ready.wait(timeout):
            self.stop()
            raise TimeoutError("post worker did not come up")
        if self._error is not None:
            self.stop()
            raise RuntimeError(self._error)
        return self.address  # None in gRPC mode (the worker has no port)

    def _spawn(self) -> subprocess.Popen:
        env = dict(os.environ if self.env is None else self.env)
        repo_root = str(Path(__file__).resolve().parent.parent.parent)
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        listen = self.listen
        if self.address is not None:
            listen = f"{self.address[0]}:{self.address[1]}"
        cmd = [sys.executable, "-u", "-m", "spacemesh_tpu_torch.post",
               "serve", "--data-dir", self.base_dir, "--listen", listen,
               "--device", self.device]
        if self.node_address is not None:
            cmd += ["--node-address", self.node_address]
        if self.params is not None:
            cmd += ["--k1", str(self.params.k1), "--k2", str(self.params.k2),
                    "--k3", str(self.params.k3),
                    "--pow-difficulty", self.params.pow_difficulty.hex()]
        return subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=env, text=True)

    @staticmethod
    def _drain(stream, tail: collections.deque) -> None:
        for line in stream:
            tail.append(line)

    def _babysit(self) -> None:
        while not self._stopped.is_set():
            proc = self._proc = self._spawn()
            self.restarts += 1
            if self._stopped.is_set():
                # stop() raced the spawn and may have terminated only the
                # previous process: reap this one here
                proc.terminate()
                proc.wait(timeout=10)
                return
            tail: collections.deque = collections.deque(maxlen=20)
            errs = threading.Thread(target=self._drain,
                                    args=(proc.stderr, tail), daemon=True)
            errs.start()
            for line in proc.stdout:  # type: ignore[union-attr]
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if ev.get("event") == "Serving":
                    self.address = (ev["host"], ev["port"])
                    self._ready.set()
                elif ev.get("event") == "Registering":
                    self._ready.set()
            rc = proc.wait()
            errs.join(timeout=5)
            proc.stdout.close()  # type: ignore[union-attr]
            proc.stderr.close()  # type: ignore[union-attr]
            if self._stopped.is_set():
                return
            if rc == EXIT_USAGE and not self._ready.is_set():
                self._error = (f"post worker exited with code {rc} before "
                               f"serving: {''.join(tail).strip()}")
                self._ready.set()
                return
            time.sleep(self.restart_backoff)  # a crash: restart

    def stop(self) -> None:
        self._stopped.set()
        # _babysit may be mid-restart: keep terminating whatever process is
        # current until the babysitter thread exits
        for _ in range(5):
            proc = self._proc
            if proc is not None and proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=5)
            if self._thread is None or not self._thread.is_alive():
                return
            self._thread.join(timeout=3)
            if not self._thread.is_alive():
                return

    def alive(self) -> bool:
        return self._proc is not None and self._proc.poll() is None
