"""Run one cell of ``BENCHMARK.json`` once and print its result line.

A cell is a workload entry: a configuration (``configs/<config>.json``)
under a traffic mix (``traffic/<traffic>.json``, which names its runner
module ``runners/<runner>.py``), with the limits of its correctness check in
``limits/<workload>.json``. Per-layer metrics are readers in
``metrics/<name>.py``. Everything is found by the names in
``BENCHMARK.json``, so a new cell, mix, configuration or metric is new
files and a new entry, with no edit to a file that is here.

The run: set-up (imports, the card, the program's kernels and star table,
the cell's warm-up) is ``setup_s``, from the process's start to the first
timed call. Then either the timed window (``--trace 0``: the cell's
end-to-end metrics) or the traced sub-window (``--trace 1``: its per-layer
metrics, the device's busy seconds and the breakdown). Then the peak device
memory is read, the program's state is freed, and the reference checks
what the timed path produced. The result is one JSON line, last on
standard output; the numbers compared, each beside its limit, are the last
lines on standard error and the last key of the line.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from typing import List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "blackstar_tpu")


class Refused(RuntimeError):
    """The run cannot give a result (no card, a bad cell, JAX loaded)."""


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: str

    def runner(self):
        return importlib.import_module(f"benchmark.runners.{self.traffic['runner']}")


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: str = ROOT) -> Cell:
    """The cell named ``workload``, with every file it names loaded."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    try:
        w = next(x for x in spec["workloads"] if x["name"] == workload)
    except StopIteration:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json") from None
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    with open(os.path.join(bench, "limits", workload + ".json")) as f:
        limits = json.load(f)
    return Cell(name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
                limits=limits,
                end_to_end=[m for m in spec["end_to_end"] if _applies(m, workload)],
                per_layer=[m for m in spec["per_layer"] if _applies(m, workload)], root=root)


def load_metric(name: str, root: str = ROOT):
    """The reader module ``benchmark/metrics/<name>.py`` (its ``read(trace)``)."""
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics._{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def process_start() -> float:
    """The process's start on the ``time.time()`` clock (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def require_cards(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise Refused("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} CUDA devices, {torch.cuda.device_count()} present")


def device_info(device, chips: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def card_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device=None,
             root: str = ROOT, t_start: Optional[float] = None,
             overrides: Optional[dict] = None) -> dict:
    """One run of one cell; returns the result line as a dict.

    ``device`` None means the card, which must be there. Tests pass
    ``device="cpu"`` and ``overrides`` for the runner's session (a smaller
    ``size``, another ``stars`` catalogue, fewer animation ``frames`` or
    fit ``steps``) to drive the rest of a run here."""
    import torch

    t_start = process_start() if t_start is None else t_start
    cell = load_cell(workload, root)
    if device is None:
        require_cards(cell.chips)
        device = torch.device("cuda:0")
        torch.cuda.set_device(device)
    device = torch.device(device)
    session = cell.runner().Session(cell, seed, device, **(overrides or {}))
    setup_s = time.time() - t_start
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    tr = None
    if trace:
        tr = session.trace()
    else:
        values = session.window(seconds)
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                result["metrics"]["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            elif m["name"] in values:
                result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = device_info(device, cell.chips)
    session.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = session.check()
    result["attempted"], result["failed"] = session.attempted, session.failed
    if tr is not None:
        tr.extra.update(session.counted())
        for m in cell.per_layer:
            value = load_metric(m["name"], root).read(tr)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_op_table(),
                               "idle_gaps": tr.idle_gap_table()}
    result["device"] = dev
    result["correct"] = bool(checks) and all(c["value"] <= c["limit"] for c in checks) \
        and all(math.isfinite(c["value"]) for c in checks)
    result["card"] = card_limit() if device.type == "cuda" else "cpu"
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return result


def main(argv=None) -> int:
    import argparse

    t_start = process_start()
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=t_start)
    except Refused as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
