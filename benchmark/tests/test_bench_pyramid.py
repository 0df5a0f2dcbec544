"""The pyramid fit cell on the CPU at a tiny size: a sound run is
``correct``; a traced run reports the pyramid's span and counts its blurs,
and the blur roofline reads them; a program that drops the pyramid, the
control (the reference in bfloat16 in the program's place) and the planted
faults fail the cell's limits; and the readers return nothing for a
program that has neither the span nor the counters."""

import copy
import importlib

import pytest
import torch

from benchmark import control_pyramid, harness
from benchmark.runners import common, fit_pyramid
from benchmark.tests.helpers import TINY, write_catalogue

CELL = "default-1080p.fit-pyramid3"


@pytest.fixture(scope="module")
def stars(tmp_path_factory):
    return write_catalogue(str(tmp_path_factory.mktemp("sky") / "stars.ppm"))


def overrides(stars):
    return {"size": TINY, "stars": stars, "trace_units": 2, "steps": 4}


def run(stars, seed=11, trace=False):
    return harness.run_cell(CELL, seed, 0.05, trace, device="cpu", overrides=overrides(stars))


def test_configuration_states_the_traffics_pyramid():
    """The configuration's fit is the scene of ``default-1080p`` under the
    loss the traffic runs: as many levels, radii 4 << k, one pass."""
    cell = harness.load_cell(CELL)
    base = harness.load_cell("default-1080p.fit").config
    k = cell.traffic["pyramid"]
    assert cell.config["fit"] == {"pyramid": k, "radii": [4 << i for i in range(k)], "passes": 1}
    assert all(cell.config[key] == base[key]
               for key in ("contents", "dtype", "stars", "max_steps", "reduced"))


def test_sound_run_is_correct(stars):
    r = run(stars)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == set(harness.load_cell(CELL).limits)
    assert set(r["metrics"]) == {"step_ms", "setup_s"}


def test_traced_run_reports_the_span(stars):
    r = run(stars, seed=12, trace=True)
    assert r["correct"] and r["metrics"]["pyramid_host_ms.step"]["value"] > 0
    # The CPU's trace holds no device kernel: the roofline reads nothing.
    assert "blur_roofline.pyramid" not in r["metrics"]


@pytest.fixture(scope="module")
def traced(stars):
    """A traced job of the cell's session, with what it counted."""
    cell = harness.load_cell(CELL)
    session = cell.runner().Session(cell, 13, torch.device("cpu"), **overrides(stars))
    tr = session.trace()
    tr.extra.update(session.counted())
    return tr


def test_blur_roofline_reads_the_counted_blurs(traced):
    """Two traced steps of a 3-level pyramid: 6 blurs of the image, 3 of the
    target; the share is their bytes over the card's rate over the time of
    the kernels of the map, and no other kernel's."""
    tr = copy.copy(traced)
    w, h = TINY
    assert (tr.extra["pyramid_blurs"], tr.extra["target_blurs"]) == (6, 3)
    assert tr.extra["image_bytes"] == w * h * 3 * 4
    tr.device_ops = [("void at::native::tensor_kernel_scan_innermost_dim<float>", 0.0, 60.0),
                     ("void indexFuncLargeIndex<float>", 100.0, 140.0),
                     ("void march_adjoint_kernel<float>", 200.0, 9000.0)]
    want = 100.0 * (2 * 6 + 3) * 4 * w * h * 3 * 4 / 3.35e12 / 100e-6
    assert harness.load_metric("blur_roofline.pyramid").read(tr) == pytest.approx(want)


def test_readers_without_the_programs_span_and_counters(traced, monkeypatch):
    """A program with neither the counters nor the span (a version older
    than them): nothing is counted, and the readers return None."""
    F = importlib.import_module("blackstar_tpu_torch.fit")
    monkeypatch.setattr(F, "image_loss", lambda *a, **k: None)
    monkeypatch.setattr(F, "target_pyramid", lambda *a, **k: None)
    assert fit_pyramid._counters() == {}
    tr = copy.copy(traced)
    tr.extra = {k: v for k, v in traced.extra.items() if k not in ("pyramid_blurs", "target_blurs")}
    tr.device_ops = [("void indexFuncLargeIndex<float>", 0.0, 40.0)]
    tr.host_ops = [e for e in traced.host_ops if e[0] != "fit.pyramid"]
    for name in ("blur_roofline.pyramid", "pyramid_host_ms.step"):
        assert harness.load_metric(name).read(tr) is None


def test_pyramid_dropped_is_not_correct(stars, monkeypatch):
    """The program fits with no blurred level: the loss and its gradient
    are another function's."""
    F = importlib.import_module("blackstar_tpu_torch.fit")
    real = F.fit_scene
    monkeypatch.setattr(F, "fit_scene", lambda *a, **k: real(*a, **dict(k, pyramid=0)))
    r = run(stars, seed=23)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("kind", ["control", "half", "altered", "dropped"])
def test_control_and_faults_fail(kind, stars, monkeypatch):
    cell = harness.load_cell(CELL)
    real = common.contents
    monkeypatch.setattr(common, "contents", lambda c, size=None: real(c, size or TINY))
    monkeypatch.setattr(common, "stars_path", lambda c, s=None: stars)
    numbers = control_pyramid.control_fit(cell, 5, torch.device("cpu"), kind)
    assert any(numbers[k] > v for k, v in cell.limits.items()), numbers


def _adjoint_gap(device, h, w):
    """The reference blur's gradient against its adjoint (the transposed
    passes, vertical then horizontal, which for a zero-padded box filter
    are the same window means in reverse order), at each level's radius."""
    from benchmark.reference.pyramid import blur, window_mean

    g = torch.Generator().manual_seed(7)
    x = torch.rand(h, w, 3, dtype=torch.float64, generator=g).to(device).requires_grad_(True)
    u = torch.randn(h, w, 3, dtype=torch.float64, generator=g).to(device)
    worst = 0.0
    for r in (4, 8, 16):
        (got,) = torch.autograd.grad(blur(x, r), x, u)
        want = window_mean(window_mean(u, r, 0), r, 1)
        worst = max(worst, float((got - want).abs().max()))
    return worst


def test_reference_blur_gradient_is_its_adjoint():
    assert _adjoint_gap("cpu", 54, 96) < 1e-12


@pytest.mark.card
def test_reference_blur_gradient_is_its_adjoint_on_the_card(card):
    assert _adjoint_gap(card, 1080, 1920) < 1e-12
