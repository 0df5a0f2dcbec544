"""Every cell, configuration, traffic mix and metric of BENCHMARK.json
resolves to its files, the file keeps the shape the check reads, and a new cell
is new files and a new entry, with no edit to a file that is there."""

import json
import os
import re
import shutil

import pytest

from benchmark import harness
from benchmark.tests.helpers import overrides, write_catalogue

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_limits():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert s["paths"] == ["benchmark"] and all(PATH.match(p) for p in s["paths"])
    assert 1 <= len(s["command"]) <= 32 and not any(w.startswith("/") for w in s["command"])
    assert isinstance(s["run_seconds"], int) and 1 <= s["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    cells = len(s["workloads"])
    # A full check: 2 + 14 runs a cell, run_seconds + 60 each, 180 s a cell to
    # compile and 1200 spare, within 43200 s even at 24 cells.
    assert (2 + 14 * 24) * (s["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24


def test_entries_have_their_keys():
    s = spec()
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["source"]) <= 200
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["reduced"] == []
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    pairs = [(w["config"], w["traffic"]) for w in s["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in s["end_to_end"])
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert any(e["name"] == m["moves"] for e in s["end_to_end"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in s[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)


@pytest.mark.parametrize("workload", [w["name"] for w in spec()["workloads"]])
def test_cell_resolves(workload):
    """The cell's configuration, traffic, runner, limits and metrics load;
    the cell reports setup_s, another end-to-end metric and a per-layer
    metric, and each per-layer metric's end-to-end metric too."""
    cell = harness.load_cell(workload)
    assert hasattr(cell.runner(), "Session")
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(harness.load_metric(m["name"]).read)
    assert cell.config["reduced"] == [] and len(cell.config["source"]) <= 200


def test_layers_named_in_perf_md():
    with open(os.path.join(ROOT, "PERF.md")) as f:
        perf = f.read()
    for m in spec()["per_layer"]:
        assert m["layer"] in perf, m["layer"]


def test_a_cell_added_as_files(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    metric and a cell as new files and entries; nothing there is edited,
    and the new cell runs (on the CPU, tiny)."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    s = spec()
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    conf = json.loads((root / "benchmark/configs/default-1080p.json").read_text())
    conf["name"] = "wide-1080p"
    conf["contents"]["camera"]["fov"] = 2.0
    (root / "benchmark/configs/wide-1080p.json").write_text(json.dumps(conf))
    (root / "benchmark/traffic/frame-few.json").write_text(json.dumps(
        {"runner": "still", "check_frames": 1, "trace_frames": 2}))
    (root / "benchmark/limits/wide-1080p.frame-few.json").write_text(json.dumps(
        {"bad_px_share": 0.5, "mean_gap": 50.0}))
    (root / "benchmark/metrics/frames_traced.frame.py").write_text(
        "def read(trace):\n    return float(trace.units)\n")
    s["configs"].append({"name": "wide-1080p", "source": "https://example.org/wide",
                         "file": "benchmark/configs/wide-1080p.json", "reduced": [],
                         "why": "a wider view"})
    s["workloads"].append({"name": "wide-1080p.frame-few", "config": "wide-1080p",
                           "traffic": "frame-few", "chips": 1, "why": "a test cell"})
    for m in s["end_to_end"]:
        if "workloads" in m and "default-1080p.frame" in m["workloads"]:
            m["workloads"].append("wide-1080p.frame-few")
    s["per_layer"].append({"name": "frames_traced.frame", "unit": "count", "better": "higher",
                           "source": "program_counter", "layer": "Device", "moves": "frame_ms",
                           "workloads": ["wide-1080p.frame-few"]})
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    stars = write_catalogue(str(tmp_path / "stars.ppm"))
    ov = overrides("wide-1080p.frame-few", stars)
    r = harness.run_cell("wide-1080p.frame-few", 5, 0.2, False, device="cpu", root=str(root),
                         overrides=ov)
    assert r["correct"] and set(r["metrics"]) == {"frame_ms", "setup_s"}
    t = harness.run_cell("wide-1080p.frame-few", 6, 0.2, True, device="cpu", root=str(root),
                         overrides=ov)
    assert t["correct"] and t["metrics"]["frames_traced.frame"]["value"] == 2.0
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
