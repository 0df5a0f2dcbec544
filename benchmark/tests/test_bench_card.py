"""One run of a cell on the card, as the check runs it (marked ``card``:
skips without one). Run on the card with ``python -m pytest
benchmark/tests -q -m card``."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.card
def test_a_cell_runs_on_the_card(card):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "default-1080p.frame", "--seed", "2147483659", "--seconds", "2",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
    assert {"frame_ms", "setup_s"} <= set(line["metrics"])
