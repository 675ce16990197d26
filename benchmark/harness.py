"""Runs one cell of ``BENCHMARK.json`` and prints its result line.

Everything is found by name: the cell's configuration file (its ``file``),
its traffic mix (``traffic/<traffic>.json``) and each metric's reader
(``metrics/<metric>.py``, a ``read(run)`` that returns a number or None
when it finds nothing to read). A later cell, mix, configuration or metric
is new files and entries, and no edit here.

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones, the device's busy and window seconds and
a breakdown of the traced window. ``correct`` comes from ``check.py``;
each number compared is printed beside its limit as the last lines on
standard error and under ``checks``, the line's last key.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / ".bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "spacemesh_tpu")
TOP = 10  # entries per breakdown list
NAME_CHARS = 120  # a device op's name in the breakdown, at most


def set_cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    so only a cell's first run in a checkout builds."""
    os.environ["SPACEMESH_TORCH_CACHE"] = str(CACHE / "spacemesh_tpu_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the run must not load,
    compared whole (the port's name begins with the JAX package's)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json", encoding="utf-8") as f:
        return json.load(f)


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config_of(spec: dict, wl: dict, root: Path = ROOT) -> dict:
    for c in spec["configs"]:
        if c["name"] == wl["config"]:
            with open(root / c["file"], encoding="utf-8") as f:
                return json.load(f)
    raise KeyError(f"no config named {wl['config']!r}")


def traffic_of(wl: dict) -> dict:
    with open(BENCH / "traffic" / f"{wl['traffic']}.json",
              encoding="utf-8") as f:
        return json.load(f)


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, wl_name: str) -> bool:
    return "workloads" not in metric or wl_name in metric["workloads"]


def _host_span_at(run, t_us: float) -> str:
    """The innermost program span open at ``t_us``, or a note that none
    was."""
    best = None
    for name, s, e, _ in run.spans:
        if s <= t_us <= e and (best is None or e - s < best[1]):
            best = (name, e - s)
    return best[0] if best else "no program span open"


def breakdown(run) -> dict:
    """The device operations that took most of the traced window, and its
    longest idle gaps named by the host span open across each."""
    from .devtrace import clip, merged

    lo, hi = run.t0 * 1e6, run.t1 * 1e6
    by_name: dict[str, float] = {}
    for name, _, s, e in run.dtrace.events:
        for cs, ce in clip([(s, e)], lo, hi):
            by_name[name] = by_name.get(name, 0.0) + (ce - cs) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    # a templated kernel's name runs to kilobytes: its head names it
    ops = [(k if len(k) <= NAME_CHARS else k[:NAME_CHARS] + "...", v)
           for k, v in ops]
    busy = merged(clip(run.dtrace.intervals(), lo, hi))
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[_host_span_at(run, (s + e) / 2), (e - s) / 1e6]
            for s, e in gaps[:TOP]]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}


def run_cell(spec: dict, wl_name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float | None = None,
             config_overrides: dict | None = None,
             traffic_overrides: dict | None = None,
             program_overrides: dict | None = None,
             cache: Path | None = None) -> dict:
    """One run of a cell; -> the result line as a dict.

    ``config_overrides`` and ``traffic_overrides`` resize the cell for
    both the program and the reference (the CPU tests' tiny sizes);
    ``program_overrides`` reach the program alone (the control). The
    proving identities' stores are kept under ``cache`` (the checkout's
    ``.bench_cache`` by default)."""
    import torch

    from . import check, drive

    t_start = time.perf_counter() if t_start is None else t_start
    wl = workload(spec, wl_name)
    cfg = dict(config_of(spec, wl), **(config_overrides or {}))
    traffic = dict(traffic_of(wl), **(traffic_overrides or {}))
    program_cfg = dict(cfg, **(program_overrides or {}))
    cuda = torch.device(device).type == "cuda"
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    state = {}

    def after(run):
        # the program is wound down: read its peak, free what it held,
        # then run the reference
        state["peak"] = torch.cuda.max_memory_allocated() if cuda else 0
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t = time.perf_counter()
        checks = check.check(run, cfg, seed, device)
        state["reference_s"] = time.perf_counter() - t
        return checks

    stores = (CACHE if cache is None else Path(cache)) / "stores"
    run, checks = drive.run_and_check(seed, seconds, trace, program_cfg,
                                      traffic, device, stores, after)
    run.device_kind = kind
    metrics = {}
    group = spec["per_layer"] if trace else spec["end_to_end"]
    for m in group:
        if not applies(m, wl_name):
            continue
        if m["name"] == "setup_s":
            value = run.t0 - t_start
        else:
            value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": 1 if cuda else 0, "memory_peak_bytes": state["peak"]}
    line = {"correct": all(v <= lim for v, lim in checks.values()),
            "attempted": run.batches + len(run.due_proofs()),
            "failed": (len(run.init_errors)
                       + sum(1 for r in run.due_proofs() if r.proof is None)),
            "metrics": metrics, "device": dev}
    if trace and run.dtrace is not None:
        from .devtrace import busy_us, clip

        lo, hi = run.t0 * 1e6, run.t1 * 1e6
        dev["busy_s"] = busy_us(clip(run.dtrace.intervals(), lo, hi)) / 1e6
        dev["window_s"] = run.window_s
        line["breakdown"] = breakdown(run)
    line["reference_s"] = state["reference_s"]
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return line


def main(argv=None, t_start: float | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = load_spec()
    wl = workload(spec, args.workload)

    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    line = run_cell(spec, args.workload, args.seed, args.seconds,
                    bool(args.trace), "cuda", t_start)
    found = forbidden_modules()
    if found:
        print("the run loaded modules it must not: " + ", ".join(found),
              file=sys.stderr)
        return 1
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
