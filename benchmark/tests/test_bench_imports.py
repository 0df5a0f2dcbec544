"""Nothing on the run path or in the reference loads JAX or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference loads nothing of the program."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROBE = """
import json, sys
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(imports: str):
    out = subprocess.run([sys.executable, "-c", PROBE.format(imports=imports)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_path_loads_no_jax():
    names = _top_level("import benchmark.run, benchmark.harness, benchmark.control\n"
                       "import benchmark.runners.still, benchmark.runners.fit, "
                       "benchmark.runners.animation\n"
                       "import blackstar_tpu_torch.render, blackstar_tpu_torch.fit, "
                       "blackstar_tpu_torch.video\n"
                       "from benchmark import harness\n"
                       "[harness.load_metric(m) for m in ('b1_roofline.frame', 'host_sync_ms.step')]")
    assert not names & {"jax", "jaxlib", "flax", "blackstar_tpu"}
    assert "blackstar_tpu_torch" in names


def test_reference_loads_nothing_of_the_program():
    names = _top_level("import benchmark.reference.render, benchmark.reference.stars, "
                       "benchmark.reference.fit, benchmark.reference.scene, benchmark.workcount, "
                       "benchmark.pngread")
    assert not names & {"jax", "jaxlib", "flax", "blackstar_tpu", "blackstar_tpu_torch"}


def test_no_card_no_result():
    """Without a card the command fails and prints no result line."""
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "default-1080p.frame", "--seed", "3", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
