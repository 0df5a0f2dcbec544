"""The gradient gate of ``blackstar_tpu_torch/scripts/fit_partials.py``
(``chip_smoke.py`` phase 19) on the CPU: its verdict, and the float32
parameters it computes its float32 gradients at. The gate itself needs the
card (B2 and B1's checkpoints)."""

import dataclasses

import numpy as np
import pytest
import torch

from blackstar_tpu_torch.config import param_leaves
from blackstar_tpu_torch.scripts import fit_partials as fp


@pytest.mark.parametrize("b2,plain,fails", [
    (1.0e-2, 1.0e-2, False),                      # equal errors
    (1.05e-2, 1.0e-2, False),                     # at the margin
    (1.06e-2, 1.0e-2, True),                      # past it
    (fp.GATE_ATOL, 0.0, False),                   # plain exact: the absolute floor
    (2 * fp.GATE_ATOL, 0.0, True),
    (float("nan"), 1.0e-2, True),                 # a NaN never passes
])
def test_gate_failures(b2, plain, fails):
    err_b2 = {".mass": b2, ".disk.outer": 0.0}
    err_plain = {".mass": plain, ".disk.outer": 0.0}
    assert fp.gate_failures(err_b2, err_plain) == ([".mass"] if fails else [])


def test_relative_errors_per_leaf():
    ref = {"a": np.array([3.0, 4.0]), "b": np.array(2.0)}
    got = {"a": np.array([3.0, 4.5]), "b": np.array(2.0), "extra": np.array(1.0)}
    assert fp.relative_errors(got, ref) == {"a": 0.1, "b": 0.0}


def test_start_cast_to_f32_is_the_f32_scene():
    """The gate takes every point as float64 leaves cast to the run's dtype;
    at the start that cast gives the float32 scene's own parameters, so the
    start's float32 gradients are those of a float32 fit's first step."""
    c64, c32 = fp.scene_config("float64"), fp.scene_config("float32")
    assert c64.scene.resolution == (1920, 1080)
    assert dataclasses.replace(c64.scene, dtype="float32") == c32.scene
    for (name, a), (_, b) in zip(param_leaves(c64.params("cpu")), param_leaves(c32.params("cpu"))):
        assert torch.equal(torch.tensor(a.double().numpy(), dtype=torch.float32), b), name


def test_gate_points_and_margin():
    """Three targets, iterates 5 and 10 of the first, a margin of at most 1.25."""
    assert [sorted(t) for t in fp.GATE_TARGETS] == [["disk_outer"], ["mass"],
                                                   ["disk_inner", "disk_opacity"]]
    assert fp.GATE_ITERATES == (5, 10) and fp.GATE_LR == 1e-3
    assert 1.0 < fp.GATE_MARGIN <= 1.25 and fp.GATE_ATOL == 1e-7
